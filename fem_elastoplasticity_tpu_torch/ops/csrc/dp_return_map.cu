// K2: the fused Drucker-Prager return map on Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package
// (fem_elastoplasticity_tpu/ops/return_map_pallas.py: dp_return_map_pallas,
// kernel _kernel).  Per integration point it computes the trial state, the
// elastic / smooth-cone / apex branch, the returned stress s (4), the packed
// consistent tangent ds6 = [d00, d11, d22, d01, d02, d12], the multiplier lam
// and, with APPLY_EP, the updated plastic strain (4); without it, ep passes
// through unchanged.
//
// What bounds it: memory.  A point reads 7 values (e3: 3, ep: 4) and writes
// 15 (s: 4, ds6: 6, lam: 1, ep: 4), 88 bytes in f32 and 176 in f64, for
// about 150 flops: far below the card's flop/byte balance.  The design
// keeps the JAX kernel's component-major (SoA) layout, (k, n) contiguous,
// so in every row neighbouring threads touch neighbouring addresses and each
// warp's loads and stores coalesce into full lines.  One thread owns one
// point, a grid-stride loop covers any n (no multiple of 128 needed), and
// every intermediate stays in registers: each byte crosses the memory bus
// once.  At the main path's 896 points the launch, not the bytes, sets the
// time.
//
// Rounding: the expressions and their order follow _kernel line by line and
// the plain PyTorch version (ops/return_map.py dp_return_map_plain), and the
// file is built with -fmad=false, so no a*b+c is contracted into an FMA that
// the plain version, which rounds after every operation, does not do.  The
// material constants arrive as doubles computed in Python by the same
// expressions as the plain version's and are rounded to the working type
// here, as the Pallas kernel's weakly typed Python floats are.  eta, c and
// the zeta-scaled initial strain e0 arrive through a device pointer, so the
// caller's host loop needs no sync to pass them.

#include <cuda_runtime.h>

namespace {

// Host-computed material constants, rounded to T (ops/return_map.py
// _material_constants gives them in this order).
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
};
constexpr int kNumConsts = 9;

template <typename T, bool APPLY_EP, bool APEX_TRIAL>
__global__ void __launch_bounds__(256)
dp_return_map_kernel(long long n, const T* __restrict__ params,
                     const T* __restrict__ e3, const T* __restrict__ ep,
                     T* __restrict__ s, T* __restrict__ ds,
                     T* __restrict__ lam_out, T* __restrict__ ep_out,
                     Consts<T> k) {
  const T zero = T(0);
  const T one = T(1);
  const T three = T(3);
  const T e0_0 = params[0];
  const T e0_1 = params[1];
  const T e0_2 = params[2];
  const T e0_3 = params[3];
  const T eta = params[4];
  const T c = params[5];

  // scalar terms of the kernel, once per thread
  const T denom_a = k.bulk * eta * eta;
  const T denom_s = k.shear + denom_a;
  const T ke = k.bulk * eta;
  const T apex = c / eta;
  const T eta_third = eta / three;
  const T shift = c / (k.three_bulk * eta);

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
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
    const T crit2 = eta * p_tr - denom_a * rho_tr / k.shear_sqrt2 - c;

    const bool ind_p = crit1 > zero;
    const bool ind_s = ind_p && (crit2 <= zero);
    const bool ind_a = ind_p && (crit2 > zero);

    const T lam_s = crit1 / denom_s;
    const T lam_a = (eta * p_tr - c) / denom_a;
    lam_out[i] = ind_s ? lam_s : (ind_a ? lam_a : zero);

    const T inv_norm = norm_e > zero ? one / norm_e : zero;
    const T n0 = dev0 * inv_norm;
    const T n1 = dev1 * inv_norm;
    const T n2 = dev2 * inv_norm;
    const T n3 = dev3 * inv_norm;

    const T m0 = k.shear_sqrt2 * n0 + ke;
    const T m1 = k.shear_sqrt2 * n1 + ke;
    const T m2 = k.shear_sqrt2 * n2;
    const T m3 = k.shear_sqrt2 * n3 + ke;

    const T apex_v = apex + zero;
    s[i] = ind_s ? st0 - lam_s * m0 : (ind_a ? apex_v : st0);
    s[n + i] = ind_s ? st1 - lam_s * m1 : (ind_a ? apex_v : st1);
    s[2 * n + i] = ind_s ? st2 - lam_s * m2 : (ind_a ? zero : st2);
    s[3 * n + i] = ind_s ? st3 - lam_s * m3 : (ind_a ? apex_v : st3);

    const T safe_rho = rho_tr > zero ? rho_tr : one;
    const T ca = ind_s ? k.ca * lam_s / safe_rho : zero;
    const T ms = ind_s ? one / denom_s : zero;
    const T not_a = ind_a ? zero : one;
    const T two_thirds = T(2.0 / 3.0);
    const T minus_third = T(-1.0 / 3.0);
    ds[i] = (k.e_diag - ca * (two_thirds - n0 * n0) - m0 * m0 * ms) * not_a;
    ds[n + i] = (k.e_diag - ca * (two_thirds - n1 * n1) - m1 * m1 * ms) * not_a;
    ds[2 * n + i] = (k.shear - ca * (T(0.5) - n2 * n2) - m2 * m2 * ms) * not_a;
    ds[3 * n + i] = (k.e_off - ca * (minus_third - n0 * n1) - m0 * m1 * ms) * not_a;
    ds[4 * n + i] = (ca * n0 * n2 - m0 * m2 * ms) * not_a;
    ds[5 * n + i] = (ca * n1 * n2 - m1 * m2 * ms) * not_a;

    if (APPLY_EP) {
      const T f0 = n0 / k.sqrt2 + eta_third;
      const T f1 = n1 / k.sqrt2 + eta_third;
      const T f2 = T(2) * (n2 / k.sqrt2);
      const T f3 = n3 / k.sqrt2 + eta_third;
      const T ab0 = APEX_TRIAL ? et0 : e4_0;
      const T ab1 = APEX_TRIAL ? et1 : e4_1;
      const T ab2 = APEX_TRIAL ? et2 : e4_2;
      const T ab3 = APEX_TRIAL ? et3 : e4_3;
      ep_out[i] = ind_s ? ep0 + lam_s * f0 : (ind_a ? ab0 - shift : ep0);
      ep_out[n + i] = ind_s ? ep1 + lam_s * f1 : (ind_a ? ab1 - shift : ep1);
      ep_out[2 * n + i] = ind_s ? ep2 + lam_s * f2 : (ind_a ? ab2 : ep2);
      ep_out[3 * n + i] = ind_s ? ep3 + lam_s * f3 : (ind_a ? ab3 - shift : ep3);
    } else {
      ep_out[i] = ep0;
      ep_out[n + i] = ep1;
      ep_out[2 * n + i] = ep2;
      ep_out[3 * n + i] = ep3;
    }
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

template <typename T, bool APPLY_EP, bool APEX_TRIAL>
int launch_t(long long n, const void* params, const void* e3, const void* ep,
             void* s, void* ds, void* lam, void* ep_out, const Consts<T>& k,
             cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dp_return_map_kernel<T, APPLY_EP, APEX_TRIAL>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          n, static_cast<const T*>(params), static_cast<const T*>(e3),
          static_cast<const T*>(ep), static_cast<T*>(s), static_cast<T*>(ds),
          static_cast<T*>(lam), static_cast<T*>(ep_out), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(long long n, int apply_ep, int apex_trial, const double* consts,
           const void* params, const void* e3, const void* ep, void* s,
           void* ds, void* lam, void* ep_out, void* stream_ptr) {
  if (n <= 0) return 0;
  Consts<T> k;
  T* fields = reinterpret_cast<T*>(&k);
  for (int j = 0; j < kNumConsts; ++j) fields[j] = static_cast<T>(consts[j]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (apply_ep) {
    if (apex_trial)
      return launch_t<T, true, true>(n, params, e3, ep, s, ds, lam, ep_out, k, stream);
    return launch_t<T, true, false>(n, params, e3, ep, s, ds, lam, ep_out, k, stream);
  }
  return launch_t<T, false, false>(n, params, e3, ep, s, ds, lam, ep_out, k, stream);
}

static_assert(sizeof(Consts<float>) == kNumConsts * sizeof(float), "Consts layout");
static_assert(sizeof(Consts<double>) == kNumConsts * sizeof(double), "Consts layout");

}  // namespace

// Launch K2 on `stream` (a cudaStream_t passed as a pointer).  `consts` is a
// host array of kNumConsts doubles; `params` a device array of 8 values of
// the working type, [e0_0..e0_3, eta, c, 0, 0].  Returns the cudaError_t of
// the launch; 0 means the kernel was queued.
extern "C" int dp_return_map_f32(long long n, int apply_ep, int apex_trial,
                                 const double* consts, const void* params,
                                 const void* e3, const void* ep, void* s,
                                 void* ds, void* lam, void* ep_out,
                                 void* stream) {
  return launch<float>(n, apply_ep, apex_trial, consts, params, e3, ep, s, ds,
                       lam, ep_out, stream);
}

extern "C" int dp_return_map_f64(long long n, int apply_ep, int apex_trial,
                                 const double* consts, const void* params,
                                 const void* e3, const void* ep, void* s,
                                 void* ds, void* lam, void* ep_out,
                                 void* stream) {
  return launch<double>(n, apply_ep, apex_trial, consts, params, e3, ep, s, ds,
                        lam, ep_out, stream);
}
