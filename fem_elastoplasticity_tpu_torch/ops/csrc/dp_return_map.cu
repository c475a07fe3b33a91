// K2: the fused Drucker-Prager return map on Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package
// (fem_elastoplasticity_tpu/ops/return_map_pallas.py: dp_return_map_pallas,
// kernel _kernel).  Per integration point it computes the trial state, the
// elastic / smooth-cone / apex branch, the returned stress s (4), the
// consistent tangent, the multiplier lam and, with APPLY_EP, the updated
// plastic strain (4); without it, ep passes through unchanged.  One launch
// writes what the Newton loop reads: the tangent as the full symmetric
// D (3, 3), each of its six unique values computed once and stored in one or
// two places (the JAX package's unpack_tangent), and the plastic mask
// ind_p = lam > 0 from the register that holds lam.
//
// What bounds it: memory.  A point reads 7 values (e3: 3, ep: 4) and writes
// 15 (s: 4, D's six unique values, lam: 1, ep: 4) and a byte of mask, 89
// bytes in f32 and 177 in f64, for about 150 flops: far below the card's
// flop/byte balance.  The kernel stores D's three mirrored values too (18
// values, 101 and 201 bytes), since the Newton loop reads the full D.
// The design keeps the JAX kernel's component-major (SoA) layout, (k, n)
// contiguous, so in every row neighbouring threads touch neighbouring
// addresses and each warp's loads and stores coalesce into full lines.  One
// thread owns one point, a grid-stride loop covers any n, and every
// intermediate stays in registers: each byte crosses the memory bus once.
// At the Newton path's 896 points the launch, not the bytes, sets the time.
// Blocks of 128 threads spread such a grid over 7 SMs; 64, 128 and 256
// threads time alike there and at 227,072 points (PERF.md, K2's row).
//
// Rounding: the expressions and their order follow _kernel line by line and
// the plain PyTorch version (ops/return_map.py dp_return_map_plain), and the
// file is built with -fmad=false, so no a*b+c is contracted into an FMA that
// the plain version, which rounds after every operation, does not do.  The
// material constants, eta and c arrive as doubles computed in Python by the
// same expressions as the plain version's and are rounded to the working
// type here, as the Pallas kernel's weakly typed Python floats are.  The
// initial strain is e0 = zeta e0_dir, one rounding as the caller's
// `e0_dir * zeta` in the working type: e0_dir is a device pointer (or null,
// e0 = 0) and zeta a host scalar, so the caller's host loop needs no sync.
//
// The member-batched instance (dp_return_map_batched_kernel) runs one launch
// over B ensemble members x n points: flat index j is point j - b n of
// member b = j / n.  The shear and bulk constants are shared; each member
// brings its own eta, c and zeta, read from a (B, 3) device array of doubles
// and rounded to T as the single launch rounds its host doubles.  Both
// kernels run the one per-point body below, so member b's s, D, ind_p, lam
// and ep are bitwise a single launch's with that member's eta, c and zeta.

#include <cuda_runtime.h>

namespace {

// Host-computed constants, rounded to T (ops/return_map.py
// _kernel_constants gives them in this order).
template <typename T>
struct Consts {
  T two_g;        // 2 G
  T bulk;         // K
  T shear;        // G
  T sqrt2;        // sqrt(2)
  T shear_sqrt2;  // G sqrt(2)
  T ca;           // 2 sqrt(2) G G
  T e_diag;       // 4 G / 3 + K
  T e_off;        // -2 G / 3 + K
  T three_bulk;   // 3 K
  T eta;          // the Drucker-Prager slope
  T c;            // the Drucker-Prager cohesion term
};
constexpr int kNumConsts = 11;

// Output rows, each n long, of the one (18, n) block the wrapper allocates.
constexpr int kRowS = 0, kRowD = 4, kRowLam = 13, kRowEp = 14;
constexpr int kThreads = 128;  // the block size

// The scalar terms of one material, formed from eta and c as the kernel
// forms them.
template <typename T>
struct Material {
  T eta, c, denom_a, denom_s, ke, apex, eta_third, shift;
};

template <typename T>
__device__ __forceinline__ Material<T> material(const Consts<T>& k, T eta, T c) {
  const T three = T(3);
  Material<T> m;
  m.eta = eta;
  m.c = c;
  m.denom_a = k.bulk * eta * eta;
  m.denom_s = k.shear + m.denom_a;
  m.ke = k.bulk * eta;
  m.apex = c / eta;
  m.eta_third = eta / three;
  m.shift = c / (k.three_bulk * eta);
  return m;
}

// One integration point i of one material: reads e3 (3 rows) and ep (4 rows)
// of row length n, writes s (4 rows), d (9 rows), lam, ind and ep_out (4
// rows); e0_k is the initial strain zeta e0_dir.
template <typename T, bool APPLY_EP, bool APEX_TRIAL>
__device__ __forceinline__ void return_map_point(
    long long i, long long n, const Consts<T>& k, const Material<T>& m, T e0_0, T e0_1,
    T e0_2, T e0_3, const T* __restrict__ e3, const T* __restrict__ ep, T* __restrict__ s,
    T* __restrict__ d, T* __restrict__ lam_out, T* __restrict__ ep_out,
    bool* __restrict__ ind_out) {
  const T zero = T(0);
  const T one = T(1);
  const T three = T(3);
  const T eta = m.eta;
  const T c = m.c;
  const T ep0 = ep[i];
  const T ep1 = ep[n + i];
  const T ep2 = ep[2 * n + i];
  const T ep3 = ep[3 * n + i];
  const T e4_0 = e3[i] + e0_0;
  const T e4_1 = e3[n + i] + e0_1;
  const T e4_2 = e3[2 * n + i] + e0_2;
  const T e4_3 = e0_3 + zero;

  const T et0 = e4_0 - ep0;
  const T et1 = e4_1 - ep1;
  const T et2 = e4_2 - ep2;
  const T et3 = e4_3 - ep3;

  const T tr = et0 + et1 + et3;
  const T dev0 = et0 - tr / three;
  const T dev1 = et1 - tr / three;
  const T dev2 = et2 / T(2);
  const T dev3 = et3 - tr / three;

  const T ktr = k.bulk * tr;
  const T st0 = k.two_g * dev0 + ktr;
  const T st1 = k.two_g * dev1 + ktr;
  const T st2 = k.two_g * dev2;
  const T st3 = k.two_g * dev3 + ktr;

  T norm_sq = et0 * dev0 + et1 * dev1 + et2 * dev2 + et3 * dev3;
  norm_sq = norm_sq < zero ? zero : norm_sq;  // jnp.maximum keeps a NaN
  const T norm_e = sqrt(norm_sq);
  const T rho_tr = k.two_g * norm_e;
  const T p_tr = k.bulk * tr;

  const T crit1 = rho_tr / k.sqrt2 + eta * p_tr - c;
  const T crit2 = eta * p_tr - m.denom_a * rho_tr / k.shear_sqrt2 - c;

  const bool ind_p = crit1 > zero;
  const bool ind_s = ind_p && (crit2 <= zero);
  const bool ind_a = ind_p && (crit2 > zero);

  const T lam_s = crit1 / m.denom_s;
  const T lam_a = (eta * p_tr - c) / m.denom_a;
  const T lam = ind_s ? lam_s : (ind_a ? lam_a : zero);
  lam_out[i] = lam;
  ind_out[i] = lam > zero;  // the Newton loop's mask: lam > 0, not crit1 > 0

  const T inv_norm = norm_e > zero ? one / norm_e : zero;
  const T n0 = dev0 * inv_norm;
  const T n1 = dev1 * inv_norm;
  const T n2 = dev2 * inv_norm;
  const T n3 = dev3 * inv_norm;

  const T m0 = k.shear_sqrt2 * n0 + m.ke;
  const T m1 = k.shear_sqrt2 * n1 + m.ke;
  const T m2 = k.shear_sqrt2 * n2;
  const T m3 = k.shear_sqrt2 * n3 + m.ke;

  const T apex_v = m.apex + zero;
  s[i] = ind_s ? st0 - lam_s * m0 : (ind_a ? apex_v : st0);
  s[n + i] = ind_s ? st1 - lam_s * m1 : (ind_a ? apex_v : st1);
  s[2 * n + i] = ind_s ? st2 - lam_s * m2 : (ind_a ? zero : st2);
  s[3 * n + i] = ind_s ? st3 - lam_s * m3 : (ind_a ? apex_v : st3);

  const T safe_rho = rho_tr > zero ? rho_tr : one;
  const T ca = ind_s ? k.ca * lam_s / safe_rho : zero;
  const T ms = ind_s ? one / m.denom_s : zero;
  const T not_a = ind_a ? zero : one;
  const T two_thirds = T(2.0 / 3.0);
  const T minus_third = T(-1.0 / 3.0);
  const T d00 = (k.e_diag - ca * (two_thirds - n0 * n0) - m0 * m0 * ms) * not_a;
  const T d11 = (k.e_diag - ca * (two_thirds - n1 * n1) - m1 * m1 * ms) * not_a;
  const T d22 = (k.shear - ca * (T(0.5) - n2 * n2) - m2 * m2 * ms) * not_a;
  const T d01 = (k.e_off - ca * (minus_third - n0 * n1) - m0 * m1 * ms) * not_a;
  const T d02 = (ca * n0 * n2 - m0 * m2 * ms) * not_a;
  const T d12 = (ca * n1 * n2 - m1 * m2 * ms) * not_a;
  // D[a][b] at row 3 a + b
  d[i] = d00;
  d[n + i] = d01;
  d[2 * n + i] = d02;
  d[3 * n + i] = d01;
  d[4 * n + i] = d11;
  d[5 * n + i] = d12;
  d[6 * n + i] = d02;
  d[7 * n + i] = d12;
  d[8 * n + i] = d22;

  if (APPLY_EP) {
    const T f0 = n0 / k.sqrt2 + m.eta_third;
    const T f1 = n1 / k.sqrt2 + m.eta_third;
    const T f2 = T(2) * (n2 / k.sqrt2);
    const T f3 = n3 / k.sqrt2 + m.eta_third;
    const T ab0 = APEX_TRIAL ? et0 : e4_0;
    const T ab1 = APEX_TRIAL ? et1 : e4_1;
    const T ab2 = APEX_TRIAL ? et2 : e4_2;
    const T ab3 = APEX_TRIAL ? et3 : e4_3;
    ep_out[i] = ind_s ? ep0 + lam_s * f0 : (ind_a ? ab0 - m.shift : ep0);
    ep_out[n + i] = ind_s ? ep1 + lam_s * f1 : (ind_a ? ab1 - m.shift : ep1);
    ep_out[2 * n + i] = ind_s ? ep2 + lam_s * f2 : (ind_a ? ab2 : ep2);
    ep_out[3 * n + i] = ind_s ? ep3 + lam_s * f3 : (ind_a ? ab3 - m.shift : ep3);
  } else {
    ep_out[i] = ep0;
    ep_out[n + i] = ep1;
    ep_out[2 * n + i] = ep2;
    ep_out[3 * n + i] = ep3;
  }
}

template <typename T, bool APPLY_EP, bool APEX_TRIAL>
__global__ void __launch_bounds__(kThreads)
dp_return_map_kernel(long long n, const T* __restrict__ e0_dir, T zeta,
                     const T* __restrict__ e3, const T* __restrict__ ep,
                     T* __restrict__ out, bool* __restrict__ ind_out, Consts<T> k) {
  const T zero = T(0);
  const T e0_0 = e0_dir ? e0_dir[0] * zeta : zero;
  const T e0_1 = e0_dir ? e0_dir[1] * zeta : zero;
  const T e0_2 = e0_dir ? e0_dir[2] * zeta : zero;
  const T e0_3 = e0_dir ? e0_dir[3] * zeta : zero;
  const Material<T> m = material(k, k.eta, k.c);  // once per thread
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    return_map_point<T, APPLY_EP, APEX_TRIAL>(
        i, n, k, m, e0_0, e0_1, e0_2, e0_3, e3, ep, out + kRowS * n, out + kRowD * n,
        out + kRowLam * n, out + kRowEp * n, ind_out);
  }
}

// B members x n points: member b's e3 (3, n), ep (4, n), s (4, n), d (9, n),
// lam (n), ep_out (4, n) and ind (n) start at b times their size; params
// holds (eta, c, zeta) of each member as doubles.  k.eta and k.c are unused.
template <typename T, bool APPLY_EP, bool APEX_TRIAL>
__global__ void __launch_bounds__(kThreads)
dp_return_map_batched_kernel(long long n_members, long long n,
                             const double* __restrict__ params,
                             const T* __restrict__ e0_dir, const T* __restrict__ e3,
                             const T* __restrict__ ep, T* __restrict__ s, T* __restrict__ d,
                             T* __restrict__ lam, T* __restrict__ ep_out,
                             bool* __restrict__ ind, Consts<T> k) {
  const T zero = T(0);
  const long long total = n_members * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < total; j += stride) {
    const long long b = j / n;
    const long long i = j - b * n;
    const T eta = static_cast<T>(params[3 * b]);
    const T c = static_cast<T>(params[3 * b + 1]);
    const T zeta = static_cast<T>(params[3 * b + 2]);
    const T e0_0 = e0_dir ? e0_dir[0] * zeta : zero;
    const T e0_1 = e0_dir ? e0_dir[1] * zeta : zero;
    const T e0_2 = e0_dir ? e0_dir[2] * zeta : zero;
    const T e0_3 = e0_dir ? e0_dir[3] * zeta : zero;
    const Material<T> m = material(k, eta, c);
    return_map_point<T, APPLY_EP, APEX_TRIAL>(
        i, n, k, m, e0_0, e0_1, e0_2, e0_3, e3 + 3 * n * b, ep + 4 * n * b, s + 4 * n * b,
        d + 9 * n * b, lam + n * b, ep_out + 4 * n * b, ind + n * b);
  }
}

constexpr long long kMaxBlocks = 8192;

template <typename T, bool APPLY_EP, bool APEX_TRIAL>
int launch_t(long long n, const void* e0_dir, T zeta, const void* e3,
             const void* ep, void* out, void* ind, const Consts<T>& k, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dp_return_map_kernel<T, APPLY_EP, APEX_TRIAL>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          n, static_cast<const T*>(e0_dir), zeta, static_cast<const T*>(e3),
          static_cast<const T*>(ep), static_cast<T*>(out), static_cast<bool*>(ind), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(long long n, int apply_ep, int apex_trial, const double* consts,
           const void* e0_dir, double zeta, const void* e3, const void* ep, void* out,
           void* ind, void* stream_ptr) {
  if (n <= 0) return 0;
  Consts<T> k;
  T* fields = reinterpret_cast<T*>(&k);
  for (int j = 0; j < kNumConsts; ++j) fields[j] = static_cast<T>(consts[j]);
  const T z = static_cast<T>(zeta);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (apply_ep) {
    if (apex_trial)
      return launch_t<T, true, true>(n, e0_dir, z, e3, ep, out, ind, k, stream);
    return launch_t<T, true, false>(n, e0_dir, z, e3, ep, out, ind, k, stream);
  }
  return launch_t<T, false, false>(n, e0_dir, z, e3, ep, out, ind, k, stream);
}

template <typename T, bool APPLY_EP, bool APEX_TRIAL>
int launch_batched_t(long long n_members, long long n, const void* params,
                     const void* e0_dir, const void* e3, const void* ep, void* s, void* d,
                     void* lam, void* ep_out, void* ind, const Consts<T>& k,
                     cudaStream_t stream) {
  long long blocks = (n_members * n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dp_return_map_batched_kernel<T, APPLY_EP, APEX_TRIAL>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          n_members, n, static_cast<const double*>(params), static_cast<const T*>(e0_dir),
          static_cast<const T*>(e3), static_cast<const T*>(ep), static_cast<T*>(s),
          static_cast<T*>(d), static_cast<T*>(lam), static_cast<T*>(ep_out),
          static_cast<bool*>(ind), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_batched(long long n_members, long long n, int apply_ep, int apex_trial,
                   const double* consts, const void* params, const void* e0_dir,
                   const void* e3, const void* ep, void* s, void* d, void* lam, void* ep_out,
                   void* ind, void* stream_ptr) {
  if (n_members <= 0 || n <= 0) return 0;
  Consts<T> k;
  T* fields = reinterpret_cast<T*>(&k);
  for (int j = 0; j < kNumConsts - 2; ++j) fields[j] = static_cast<T>(consts[j]);
  k.eta = T(0);
  k.c = T(0);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define DP_BATCHED(A, X)                                                               \
  launch_batched_t<T, A, X>(n_members, n, params, e0_dir, e3, ep, s, d, lam, ep_out, ind, \
                            k, stream)
  if (apply_ep) {
    if (apex_trial) return DP_BATCHED(true, true);
    return DP_BATCHED(true, false);
  }
  return DP_BATCHED(false, false);
#undef DP_BATCHED
}

static_assert(sizeof(Consts<float>) == kNumConsts * sizeof(float), "Consts layout");
static_assert(sizeof(Consts<double>) == kNumConsts * sizeof(double), "Consts layout");

}  // namespace

// Launch K2 on `stream` (a cudaStream_t passed as a pointer).  `consts` is a host array of
// kNumConsts doubles; `e0_dir` a device array of 4 values of the working
// type, or null; `zeta` the scale of e0_dir.  `out` is one (18, n) array of
// the working type: rows 0-3 s, 4-12 D (row 3 a + b holds D[a][b]), 13 lam,
// 14-17 ep; `ind` (n,) bools, lam > 0.  Returns the cudaError_t of the
// launch; 0 means the kernel was queued.
extern "C" int dp_return_map_f32(long long n, int apply_ep, int apex_trial,
                                 const double* consts, const void* e0_dir, double zeta,
                                 const void* e3, const void* ep, void* out, void* ind,
                                 void* stream) {
  return launch<float>(n, apply_ep, apex_trial, consts, e0_dir, zeta, e3, ep, out,
                       ind, stream);
}

extern "C" int dp_return_map_f64(long long n, int apply_ep, int apex_trial,
                                 const double* consts, const void* e0_dir, double zeta,
                                 const void* e3, const void* ep, void* out, void* ind,
                                 void* stream) {
  return launch<double>(n, apply_ep, apex_trial, consts, e0_dir, zeta, e3, ep, out,
                        ind, stream);
}

// The member-batched instance on `stream`: n_members members of n points.
// `consts` is a host array of the first kNumConsts - 2 constants (the shared
// ones; eta and c are per member); `params` a device array of n_members x 3
// doubles (eta, c, zeta); `e0_dir` a device array of 4 values of the working
// type, or null.  e3 (B, 3, n) and ep (B, 4, n) in; s (B, 4, n), d (B, 9, n)
// (row 3 a + b of a member holds D[a][b]), lam (B, n), ep_out (B, 4, n) and
// ind (B, n) bools out, each contiguous.  Returns the cudaError_t of the
// launch.
extern "C" int dp_return_map_batched_f32(long long n_members, long long n, int apply_ep,
                                         int apex_trial, const double* consts,
                                         const void* params, const void* e0_dir,
                                         const void* e3, const void* ep, void* s, void* d,
                                         void* lam, void* ep_out, void* ind, void* stream) {
  return launch_batched<float>(n_members, n, apply_ep, apex_trial, consts, params, e0_dir, e3,
                               ep, s, d, lam, ep_out, ind, stream);
}

extern "C" int dp_return_map_batched_f64(long long n_members, long long n, int apply_ep,
                                         int apex_trial, const double* consts,
                                         const void* params, const void* e0_dir,
                                         const void* e3, const void* ep, void* s, void* d,
                                         void* lam, void* ep_out, void* ind, void* stream) {
  return launch_batched<double>(n_members, n, apply_ep, apex_trial, consts, params, e0_dir,
                                e3, ep, s, d, lam, ep_out, ind, stream);
}
