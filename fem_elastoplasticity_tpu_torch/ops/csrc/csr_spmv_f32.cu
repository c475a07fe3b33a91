// y = A x for an f32 CSR matrix on Hopper (sm_90a), square or rectangular.
//
// Replaces the compacted-slot SpMV of the JAX package
// (fem_elastoplasticity_tpu/ops/spmv.py: slot_matvec, kernels _slot_kernel
// and _rslot_kernel).  That kernel streams 8x128 value tiles and gathers the
// input through lane permutations, because a TPU has no fast arbitrary
// gather; its function is y = A v in f32, and that is what is kept.  The
// card gathers from L2 at full rate, so the matrix stays in CSR.
//
// The solvers apply it to the Galerkin value maps of the footing's tangent
// multigrid (rectangular, one coarse node-block value a row, a dozen entries
// a row); it was designed for a level's stiffness (about 14 entries a row for
// P1 triangles) and the transfers P and R = P^T.  One thread owns one row, walks
// it in index order and keeps one f32 accumulator, with the product and the
// sum rounded separately as the TPU kernel rounds them.  The order of the sum
// is fixed and there are no atomics, so two launches give bit-identical y.
//
// The values are an argument of their own: the Newton solver passes a new
// value array on the same structure at every iteration.
//
// What bounds it: memory.  Each entry moves 8 bytes of matrix (f32 value,
// i32 index) plus a 4-byte gather of x that L2 mostly serves, for 2 flops.

#include <cuda_runtime.h>

namespace {

__global__ void csr_spmv_f32_kernel(int n_rows,
                                    const int* __restrict__ indptr,
                                    const int* __restrict__ indices,
                                    const float* __restrict__ values,
                                    const float* __restrict__ x,
                                    float* __restrict__ y) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int begin = indptr[row];
  const int end = indptr[row + 1];
  float acc = 0.0f;
  for (int k = begin; k < end; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(values[k], __ldg(x + indices[k])));
  }
  y[row] = acc;
}

constexpr int kThreads = 256;

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns the
// cudaError_t of the launch; 0 means the kernel was queued.
extern "C" int csr_spmv_f32(int n_rows, const int* indptr, const int* indices,
                            const float* values, const float* x, float* y,
                            void* stream) {
  if (n_rows <= 0) return 0;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  csr_spmv_f32_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      n_rows, indptr, indices, values, x, y);
  return static_cast<int>(cudaGetLastError());
}
