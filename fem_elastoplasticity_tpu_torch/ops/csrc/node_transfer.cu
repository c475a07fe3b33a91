// A multigrid transfer on Hopper (sm_90a), node by node, with the V-cycle's
// mask and add fused in: K3's rectangular half.
//
// Replaces the transfers of the JAX package's compacted-slot SpMV
// (fem_elastoplasticity_tpu/ops/spmv.py: slot_matvec on the prolongation P
// and, through its _rslot_kernel, on the restriction R = P^T) together with
// the elementwise ops that follow them in its V-cycle
// (fem_elastoplasticity_tpu/solve/multigrid.py make_vcycle_ell):
//
//   mode 0   y = T x
//   mode 1   y = where(free, T x, 0)       R, the coarse level's right-hand side
//   mode 2   y = z + where(free, T x, 0)   P, the correction added to z
//
// The layout (ops/spmv.py NodeTransfer): P is a node-level operator times
// I_2 (a fine node copies its coarse parent, weight 1, or averages two,
// 0.5 each, on both displacement components alike), and R inherits that.
// Node k owns entries node_ptr[k] .. node_ptr[k+1]-1: an ascending node
// column m and one f32 weight w, which stand for the CSR entries
// (2k, 2m, w) and (2k+1, 2m+1, w).
//
// What bounds it: on all but the largest levels the latency of a launch
// (a level of some thousand nodes moves some ten kilobytes); on the largest,
// bytes: 8 bytes of column and weight an entry for two CSR entries, the
// float2 gather of x's pair, y (and z) as float2.  So the design saves
// launches: one thread a node, both components summed in one pass, the
// mask and the add in the same thread, where the V-cycle ran a product, a
// where and an add.
//
// Bits: each component is summed from +0 in ascending column order, the
// product and the sum rounded separately (the file is built with
// -fmad=false), as the CSR kernel (csr_spmv_f32.cu) sums rows 2k and 2k+1;
// the mask and the add are the same single roundings as torch.where and
// torch.add.  So every mode gives the bits of that kernel followed by the
// elementwise ops.  No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
node_transfer_kernel(int n_nodes, const int* __restrict__ node_ptr,
                     const int* __restrict__ node_cols, const float* __restrict__ weights,
                     const float* __restrict__ x, const unsigned char* __restrict__ free,
                     const float* __restrict__ z, float* __restrict__ y, int mode) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_nodes) return;
  const int begin = __ldg(node_ptr + k);
  const int end = __ldg(node_ptr + k + 1);
  float a0 = 0.0f, a1 = 0.0f;
  for (int e = begin; e < end; ++e) {
    const float w = __ldg(weights + e);
    const float2 xm = __ldg(reinterpret_cast<const float2*>(x) + __ldg(node_cols + e));
    a0 = __fadd_rn(a0, __fmul_rn(w, xm.x));
    a1 = __fadd_rn(a1, __fmul_rn(w, xm.y));
  }
  if (mode != 0) {
    a0 = free[2 * k] ? a0 : 0.0f;
    a1 = free[2 * k + 1] ? a1 : 0.0f;
    if (mode == 2) {
      const float2 zz = __ldg(reinterpret_cast<const float2*>(z) + k);
      a0 = __fadd_rn(zz.x, a0);
      a1 = __fadd_rn(zz.y, a1);
    }
  }
  reinterpret_cast<float2*>(y)[k] = make_float2(a0, a1);
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns the
// cudaError_t of the launch; 0 means the kernel was queued.  x has 2 n_cols
// entries, y (and z) 2 n_nodes, all 8-byte aligned; `free` is 2 n_nodes
// bytes of 0 or 1 (a torch.bool tensor).  free and z may be null where the
// mode does not read them.
extern "C" int node_transfer(int n_nodes, const int* node_ptr, const int* node_cols,
                             const float* weights, const float* x,
                             const unsigned char* free, const float* z, float* y,
                             int mode, void* stream) {
  if (n_nodes <= 0) return 0;
  const int blocks = (n_nodes + kThreads - 1) / kThreads;
  node_transfer_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_nodes, node_ptr, node_cols, weights, x, free, z, y, mode);
  return static_cast<int>(cudaGetLastError());
}
