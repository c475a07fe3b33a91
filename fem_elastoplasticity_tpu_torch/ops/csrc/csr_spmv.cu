// y = A x for a CSR matrix on Hopper (sm_90a), square or rectangular: K1
// (f64) and K3's CSR kernel (f32), one template.
//
// Replaces the slot SpMVs of the JAX package
// (fem_elastoplasticity_tpu/ops/spmv.py): slot_matvec_df (kernels
// _slot_kernel_df and _rslot_kernel_df), which carries every value as a pair
// of f32 numbers with Dekker transforms because a TPU has no f64, and
// slot_matvec (_slot_kernel and _rslot_kernel), f32 y = A v.  Their function
// is kept; their 8x128 tile layout is not: the card gathers x from L2 at full
// rate, so the matrix stays in CSR.
//
// The operators: the residual's strain and force operators G and S (P1: 3 to
// 12 entries a row; P4: about 20 a row in G, 44 on average and up to 192 at
// vertices in S), their f32 heads on the high-order tangent and predictor,
// and the footing's Galerkin value maps (a dozen a row).
//
// What bounds it: memory.  Each entry moves 12 bytes of matrix (f64 value,
// i32 index) or 8 (f32), plus a gather of x that L2 serves (x is at most a
// few MB), for 2 flops.  A thread a row reads nothing coalesced (G's rows lie
// ~20 entries apart, so every lane of a warp touches its own sector), and a
// warp waits for its longest row (S's vertex rows).  So a launch works in row
// blocks, cut once per structure on the host (ops/spmv.py: row_blocks): runs
// of consecutive rows, at most blockDim.x rows and about `cap` entries a
// block, or a single longer row.  Each block walks its entries in chunks of
// `cap`:
//
//   phase 1: the block's threads stream the chunk, neighbouring threads on
//            neighbouring entries (coalesced value and index loads; the x
//            gathers of one row's neighbouring columns share sectors), and
//            stage each entry in shared memory: f64 the pair (v, x), since
//            the fma must see both; f32 the product __fmul_rn(v, x);
//   phase 2: thread t sums the part of row t in the chunk from shared memory
//            in CSR order with one accumulator, fma(v, x, acc) in f64 and
//            __fadd_rn(acc, p) in f32, and carries it to the next chunk.
//
// So every row's result is the same sequence of roundings as one thread
// walking the row in order with the same arithmetic (the earlier design, a
// thread a row), whatever the blocking: two launches, and two tables, give
// bit-identical y.  The f32 instance rounds the product and the sum apart, as
// the TPU kernel does; build with -fmad=false (the f64 instance's explicit fma
// is unaffected).  Shared slots are padded (a word in 32 for f32, a pair in 8
// for f64) so that phase 2's lanes, a row length apart, spread over the
// banks.  With cap 1024 and 256 threads a block stages 18 KB (f64) or 4 KB
// (f32), and eight blocks fill an SM.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;  // entries a thread has in flight in phase 1

// A matrix entry is read once a product.  A matrix larger than about half
// the L2 cache streams its values and indices with the evict-first hint
// (ld.global.cs), so that x's lines stay in L2 for the gathers; a smaller
// one is read through the caches and stays in L2 between products.
template <bool kStream, typename T>
__device__ __forceinline__ T load_entry(const T* p) {
  if constexpr (kStream) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

template <typename V>
struct Staging;

// f64: the pair (v, x), one 16-byte slot an entry, a pad slot every 8
template <>
struct Staging<double> {
  using Slot = double2;
  __device__ static int slot(int j) { return j + (j >> 3); }
  __device__ static Slot put(double v, double x) { return make_double2(v, x); }
  __device__ static double add(Slot s, double acc) { return fma(s.x, s.y, acc); }
};

// f32: the product, rounded as the earlier kernel rounded it, a pad word
// every 32
template <>
struct Staging<float> {
  using Slot = float;
  __device__ static int slot(int j) { return j + (j >> 5); }
  __device__ static Slot put(float v, float x) { return __fmul_rn(v, x); }
  __device__ static float add(Slot s, float acc) { return __fadd_rn(acc, s); }
};

template <typename V>
__host__ __device__ constexpr int staging_slots(int cap) {
  return sizeof(V) == 8 ? cap + (cap >> 3) + 1 : cap + (cap >> 5) + 1;
}

template <typename V, bool kStream>
__global__ void csr_spmv_kernel(const int* __restrict__ row_blocks,
                                const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const V* __restrict__ values,
                                const V* __restrict__ x,
                                V* __restrict__ y, int cap) {
  using S = Staging<V>;
  using Slot = typename S::Slot;
  extern __shared__ __align__(16) unsigned char smem[];
  Slot* stage = reinterpret_cast<Slot*>(smem);

  // (first row, first entry) of this block and of the next: one load
  const int2 lo = reinterpret_cast<const int2*>(row_blocks)[blockIdx.x];
  const int2 hi = reinterpret_cast<const int2*>(row_blocks)[blockIdx.x + 1];
  const int r0 = lo.x, k0 = lo.y, r1 = hi.x, k1 = hi.y;
  const int t = threadIdx.x;
  const int row = r0 + t;
  int kb = 0, ke = 0;  // this thread's row, as entry positions
  if (row < r1) {
    kb = indptr[row];
    ke = indptr[row + 1];
  }
  V acc = V(0);
  // the block's entries in chunks of cap; a row carries its sum across them
  for (int c0 = k0; c0 < k1; c0 += cap) {
    const int c1 = min(c0 + cap, k1);
    for (int base = c0 + t; base < c1; base += kUnroll * blockDim.x) {
      int col[kUnroll];
      V val[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = base + u * blockDim.x;
        col[u] = k < c1 ? load_entry<kStream>(indices + k) : 0;
        val[u] = k < c1 ? load_entry<kStream>(values + k) : V(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xv[u] = base + u * blockDim.x < c1 ? __ldg(x + col[u]) : V(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = base + u * blockDim.x;
        if (k < c1) stage[S::slot(k - c0)] = S::put(val[u], xv[u]);
      }
    }
    __syncthreads();
    const int a = max(kb, c0);
    const int b = min(ke, c1);
#pragma unroll 4
    for (int k = a; k < b; ++k) acc = S::add(stage[S::slot(k - c0)], acc);
    __syncthreads();  // the next chunk overwrites the stage
  }
  if (row < r1) y[row] = acc;
}

template <typename V, bool kStream>
int launch_as(int n_blocks, const int* row_blocks, const int* indptr,
              const int* indices, const V* values, const V* x, V* y, int cap,
              int threads, cudaStream_t stream) {
  // at most 48 KB of dynamic shared memory without an opt-in: cap up to
  // about 2,700 entries (f64); a larger one fails at launch
  const size_t bytes = sizeof(typename Staging<V>::Slot) * staging_slots<V>(cap);
  csr_spmv_kernel<V, kStream><<<n_blocks, threads, bytes, stream>>>(
      row_blocks, indptr, indices, values, x, y, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch(int n_blocks, const int* row_blocks, const int* indptr,
           const int* indices, const V* values, const V* x, V* y, int cap,
           int threads, int stream_entries, void* stream) {
  if (n_blocks <= 0) return 0;
  if (cap <= 0 || threads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stream_entries
             ? launch_as<V, true>(n_blocks, row_blocks, indptr, indices, values,
                                  x, y, cap, threads, s)
             : launch_as<V, false>(n_blocks, row_blocks, indptr, indices,
                                   values, x, y, cap, threads, s);
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) one block of
// `threads` threads for each of the `n_blocks` row blocks (row_blocks holds
// n_blocks + 1 pairs (first row, first entry); no block has more than
// `threads` rows), staging `cap` entries at a time; `stream_entries` != 0
// reads the matrix with the evict-first hint.  Returns the cudaError_t of
// the launch, 0 when the kernel was queued.
extern "C" int csr_spmv_f64(int n_blocks, const int* row_blocks,
                            const int* indptr, const int* indices,
                            const double* values, const double* x, double* y,
                            int cap, int threads, int stream_entries,
                            void* stream) {
  return launch<double>(n_blocks, row_blocks, indptr, indices, values, x, y,
                        cap, threads, stream_entries, stream);
}

extern "C" int csr_spmv_f32(int n_blocks, const int* row_blocks,
                            const int* indptr, const int* indices,
                            const float* values, const float* x, float* y,
                            int cap, int threads, int stream_entries,
                            void* stream) {
  return launch<float>(n_blocks, row_blocks, indptr, indices, values, x, y,
                       cap, threads, stream_entries, stream);
}
