// Sparse product y = A x over a row-degree-capped ELL layout, f32 and f64, on
// Hopper (sm_90a).
//
// Replaces the windowed-ELL kernels of the JAX package
// (fem_elastoplasticity_tpu/ops/spmv.py: ell_matvec with _ell_kernel, f32,
// and ell_matvec_df with _ell_kernel_df, double-float).  The port keeps the
// double-float state in f64, so the second instance is a plain f64 product.
//
// Layout: slot s of row i sits at [s * ld + i] in `values` and `cols`
// (column-major (deg, ld), ld >= n_rows), so the 32 threads of a warp, one a
// row, read 32 neighbouring values and indices of one slot.  Padding slots
// hold value 0 and a valid column.  The TPU kernel stages a 128-lane window
// of x in VMEM around each row group; the card gathers x from L2, so there is
// no window here.  Entries past the degree cap are not in these arrays: the
// wrapper applies them as a CSR over their rows and adds the result.
//
// One thread a row walks its slots in order; products and sums are rounded
// separately (and the file is built with -fmad=false), so the kernel and its
// plain PyTorch version differ only by the summation order.  No atomics: two
// launches give bit-identical output.
//
// What bounds it: memory.  Every slot, padding included, is 8 bytes (f32) or
// 12 bytes (f64) of values and indices; x is gathered from L2; y is written
// once.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void ell_spmv_kernel(int n_rows, int deg, int ld,
                                const int* __restrict__ cols,
                                const T* __restrict__ values,
                                const T* __restrict__ x, T* __restrict__ y) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  T acc = T(0);
  for (int s = 0; s < deg; ++s) {
    const size_t k = static_cast<size_t>(s) * ld + row;
    acc = add_rn(acc, mul_rn(values[k], __ldg(x + cols[k])));
  }
  y[row] = acc;
}

constexpr int kThreads = 128;

template <typename T>
int launch(int n_rows, int deg, int ld, const int* cols, const T* values,
           const T* x, T* y, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  ell_spmv_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rows, deg, ld, cols, values, x, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) and return the
// cudaError_t of the launch; 0 means the kernel was queued.
extern "C" int ell_spmv_f32(int n_rows, int deg, int ld, const int* cols,
                            const float* values, const float* x, float* y,
                            void* stream) {
  return launch(n_rows, deg, ld, cols, values, x, y, stream);
}

extern "C" int ell_spmv_f64(int n_rows, int deg, int ld, const int* cols,
                            const double* values, const double* x, double* y,
                            void* stream) {
  return launch(n_rows, deg, ld, cols, values, x, y, stream);
}
