// One fused damped block-Jacobi smoother sweep on a CSR operator with 2x2
// nodal blocks, on Hopper (sm_90a): f32 values (K4) or bf16 values (K5).
//
// K4 replaces the fused sweep of the JAX package
// (fem_elastoplasticity_tpu/ops/spmv.py: slot_sweep and slot_sweep_b, kernels
// _slot_sweep_kernel and _rslot_sweep_kernel); K5 replaces its packed-stream
// variant (slot_sweep_pk, with _accum_pk), which smooths the hierarchy
// levels of 500,000 rows or more from bf16 values.  For DOF i = 2k+c of
// node k:
//
//   res_i = (r_i - sum_j A_ij z_j) * mask_i
//   out_i = z_i + (msf_i * res_i + mpr_i * res_partner) * mask_i   (update)
//   out_i = res_i                                                  (otherwise)
//
// msf/mpr hold the damped inverse of the node's diagonal block (own and
// partner coefficient), mask is 1 on free DOFs and 0 on constrained ones.
// Without `update` the kernel returns the masked residual, the input of the
// multigrid restriction.
//
// One thread owns one node: it forms both of the node's row products against
// the OLD z (Jacobi, so `out` must not alias `z`), and the partner residual
// is already in the thread, where the TPU kernel needs a lane swap.  The
// expression order is the TPU kernel's; products and sums are rounded
// separately (the file is also built with -fmad=false), so the kernel and its
// plain PyTorch version differ only by the summation order of the row
// product.  No atomics: two launches give bit-identical output.
//
// K5 reads the same int32 CSR structure as K4 and a separate array of bf16
// values (the f32 values rounded to nearest even).  A bf16 is the top half
// of the f32 of the same value, so the kernel widens it by a 16-bit shift,
// exactly, and computes in f32 as K4 does: on bf16-rounded values the two
// instances give the same bits.  The TPU kernel also packs its lane index
// into a byte, which is tile geometry and has no counterpart here.
//
// What bounds it: memory.  The operator's values and indices (8 bytes an
// entry for K4, 6 for K5) dominate; z is gathered from L2; r, mask, msf, mpr
// are read once and out is written once.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_value(const float* __restrict__ values, int k) {
  return values[k];
}

__device__ __forceinline__ float load_value(const unsigned short* __restrict__ values,
                                            int k) {
  return __uint_as_float(static_cast<unsigned>(values[k]) << 16);
}

template <typename V>
__device__ __forceinline__ float row_product(int row,
                                             const int* __restrict__ indptr,
                                             const int* __restrict__ indices,
                                             const V* __restrict__ values,
                                             const float* __restrict__ z) {
  const int begin = indptr[row];
  const int end = indptr[row + 1];
  float acc = 0.0f;
  for (int k = begin; k < end; ++k) {
    acc = __fadd_rn(acc, __fmul_rn(load_value(values, k), __ldg(z + indices[k])));
  }
  return acc;
}

template <typename V>
__global__ void block_jacobi_sweep_kernel(int n_nodes,
                                          const int* __restrict__ indptr,
                                          const int* __restrict__ indices,
                                          const V* __restrict__ values,
                                          const float* __restrict__ z,
                                          const float* __restrict__ r,
                                          const float* __restrict__ mask,
                                          const float* __restrict__ msf,
                                          const float* __restrict__ mpr,
                                          float* __restrict__ out,
                                          int update) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const int i0 = 2 * node;
  const int i1 = i0 + 1;
  const float acc0 = row_product(i0, indptr, indices, values, z);
  const float acc1 = row_product(i1, indptr, indices, values, z);
  const float2 rr = *reinterpret_cast<const float2*>(r + i0);
  const float2 mk = *reinterpret_cast<const float2*>(mask + i0);
  const float res0 = __fmul_rn(__fsub_rn(rr.x, acc0), mk.x);
  const float res1 = __fmul_rn(__fsub_rn(rr.y, acc1), mk.y);
  float2 o;
  if (update) {
    const float2 zz = *reinterpret_cast<const float2*>(z + i0);
    const float2 sf = *reinterpret_cast<const float2*>(msf + i0);
    const float2 pr = *reinterpret_cast<const float2*>(mpr + i0);
    const float d0 = __fadd_rn(__fmul_rn(sf.x, res0), __fmul_rn(pr.x, res1));
    const float d1 = __fadd_rn(__fmul_rn(sf.y, res1), __fmul_rn(pr.y, res0));
    o.x = __fadd_rn(zz.x, __fmul_rn(d0, mk.x));
    o.y = __fadd_rn(zz.y, __fmul_rn(d1, mk.y));
  } else {
    o.x = res0;
    o.y = res1;
  }
  *reinterpret_cast<float2*>(out + i0) = o;
}

constexpr int kThreads = 128;

template <typename V>
int launch(int n_nodes, const int* indptr, const int* indices, const V* values,
           const float* z, const float* r, const float* mask, const float* msf,
           const float* mpr, float* out, int update, void* stream) {
  if (n_nodes <= 0) return 0;
  const int blocks = (n_nodes + kThreads - 1) / kThreads;
  block_jacobi_sweep_kernel<V><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_nodes, indptr, indices, values, z, r, mask, msf, mpr, out, update);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` (a cudaStream_t passed as a pointer) and return the
// cudaError_t of the launch; 0 means the kernel was queued.  All vectors have
// 2*n_nodes entries; PyTorch allocations are aligned for the float2 accesses.
extern "C" int block_jacobi_sweep(int n_nodes, const int* indptr,
                                  const int* indices, const float* values,
                                  const float* z, const float* r,
                                  const float* mask, const float* msf,
                                  const float* mpr, float* out, int update,
                                  void* stream) {
  return launch(n_nodes, indptr, indices, values, z, r, mask, msf, mpr, out, update, stream);
}

// K5: `values` are bf16 bit patterns (torch.bfloat16 storage).
extern "C" int block_jacobi_sweep_bf16(int n_nodes, const int* indptr,
                                       const int* indices,
                                       const unsigned short* values,
                                       const float* z, const float* r,
                                       const float* mask, const float* msf,
                                       const float* mpr, float* out, int update,
                                       void* stream) {
  return launch(n_nodes, indptr, indices, values, z, r, mask, msf, mpr, out, update, stream);
}
