// Sparse product y = A x over a sliced ELL layout, f32 and f64, on Hopper
// (sm_90a).
//
// Replaces the windowed-ELL kernels of the JAX package
// (fem_elastoplasticity_tpu/ops/spmv.py: ell_matvec with _ell_kernel, f32,
// and ell_matvec_df with _ell_kernel_df, double-float).  The port keeps the
// double-float state in f64, so the second instance is a plain f64 product.
//
// The TPU layout pads every row to one global degree cap, stages a 128-lane
// window of x in VMEM, sends the entries past the cap through a second
// kernel, and splits S into three column parts to fit the window.  The card
// gathers x from L2 and has no window, so none of that is carried over:
//
// * Rows are grouped into slices of 32, one warp.  Slice s stores its rows'
//   slots column-major from slice_ptr[s] at its own width (the longest of
//   its rows, at most the JAX package's cap): slot j of lane l sits at
//   slice_ptr[s] + 32 j + l, so a warp reads 32 neighbouring values and
//   columns a slot.  Padding is only what a slice's shorter rows leave.
//   Where every slice has one width w (the multigrid transfers), the
//   offsets are 32 w s and the kernel does not read slice_ptr.
// * A row's entries past the cap form its tail, a CSR over all rows
//   (tail_ptr), which the same thread walks after its slots: one launch a
//   product, no side kernel, no index write.  An operator without a tail
//   does not read tail_ptr.
//
// One thread a row walks its slots, then its tail, in order; products and
// sums are rounded separately (the file is built with -fmad=false), so the
// kernel and its plain PyTorch version (`ell_matvec_plain`, which adds in the
// same order) differ at most by the CPU's and the card's rounding of the
// same operations.  No atomics: two launches give bit-identical output.
//
// What bounds it: memory.  The product needs each entry's value and column
// once (8 bytes f32, 12 bytes f64), x (from L2 after its first gather) and y;
// the layout adds its padding slots and the tail's row pointers.

#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;    // rows a slice: one warp
constexpr int kThreads = 128;  // four slices a block

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sliced_ell_kernel(int n_rows, int width, bool has_tail, const int* __restrict__ slice_ptr,
                  const int* __restrict__ cols, const T* __restrict__ values,
                  const int* __restrict__ tail_ptr, const int* __restrict__ tail_cols,
                  const T* __restrict__ tail_values, const T* __restrict__ x,
                  T* __restrict__ y) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const int slice = row / kSlice, lane = row % kSlice;
  const int begin = width > 0 ? slice * kSlice * width : slice_ptr[slice];
  const int end = width > 0 ? begin + kSlice * width : slice_ptr[slice + 1];
  T acc = T(0);
  for (int k = begin + lane; k < end; k += kSlice) {
    acc = add_rn(acc, mul_rn(values[k], __ldg(x + cols[k])));
  }
  if (has_tail) {
    const int tail_end = tail_ptr[row + 1];
    for (int k = tail_ptr[row]; k < tail_end; ++k) {
      acc = add_rn(acc, mul_rn(tail_values[k], __ldg(x + tail_cols[k])));
    }
  }
  y[row] = acc;
}

template <typename T>
int launch(int n_rows, int width, int n_tail, const int* slice_ptr, const int* cols,
           const T* values, const int* tail_ptr, const int* tail_cols, const T* tail_values,
           const T* x, T* y, void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  sliced_ell_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rows, width, n_tail > 0, slice_ptr, cols, values, tail_ptr, tail_cols, tail_values, x, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `width`: every slice's width where they share one, else 0.  Launch on
// `stream` (a cudaStream_t passed as a pointer) and return the cudaError_t
// of the launch; 0 means the kernel was queued.
extern "C" int ell_spmv_f32(int n_rows, int width, int n_tail, const int* slice_ptr,
                            const int* cols, const float* values, const int* tail_ptr,
                            const int* tail_cols, const float* tail_values, const float* x,
                            float* y, void* stream) {
  return launch(n_rows, width, n_tail, slice_ptr, cols, values, tail_ptr, tail_cols,
                tail_values, x, y, stream);
}

extern "C" int ell_spmv_f64(int n_rows, int width, int n_tail, const int* slice_ptr,
                            const int* cols, const double* values, const int* tail_ptr,
                            const int* tail_cols, const double* tail_values, const double* x,
                            double* y, void* stream) {
  return launch(n_rows, width, n_tail, slice_ptr, cols, values, tail_ptr, tail_cols,
                tail_values, x, y, stream);
}
