// One fused damped block-Jacobi smoother sweep on Hopper (sm_90a), on an
// operator stored as 2x2 node blocks: f32 block values (K4) or bf16 (K5).
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
// Its third epilogue is the plain product out_i = sum_j A_ij z_j on f32
// blocks (node_block_spmv): K3's square half, which replaces the JAX
// package's slot_matvec (_slot_kernel) for the CG operator, the Newton
// criterion and the elastic predictor.  It reads no r, mask, msf or mpr.
//
// The layout (ops/spmv.py NodeBlockMatrix, built once per multigrid level):
// node k owns blocks node_ptr[k] .. node_ptr[k+1]-1, in ascending neighbour
// node m = block_cols[b]; block b holds a(2k,2m), a(2k,2m+1), a(2k+1,2m),
// a(2k+1,2m+1).  An interior P1 node has 7 blocks (14 entries a row).
//
// What bounds it: bytes (about 2 operations a byte).  A block of four
// entries costs 16 B of f32 values (K4) or 8 B of bf16 (K5) and one 4-byte
// node column: 5 or 3 bytes an entry, where the CSR this layout replaces
// paid 8 or 6 (a value and an int32 column each; the TPU's packed stream
// pays 3).  z is gathered from L2 as one float2 a block.  At level 5
// (910,368 rows, 3.2 M blocks) K5 reads about 62 MB, the CSR 100 MB.
//
// Design: a group of G = 8 lanes owns one node (the FEM levels have 7
// blocks a node inside, at most 9).  Lane j loads block j of the node
// (values, column, the z pair at that column), so neighbouring lanes read
// neighbouring addresses; a node with more blocks than lanes takes further
// rounds.  Each lane forms its four products, each rounded (__fmul_rn).
// The bf16 instance widens a value by a 16-bit shift (a bf16 is the top
// half of the f32 of the same value), exactly, and computes in f32 as K4
// does: on bf16-rounded values the two instances give the same bits.
//
// Why the order of the sum is kept: each row is summed in ascending block
// order, product by product, a(.,2m) z_2m then a(.,2m+1) z_2m+1, each add
// rounded (__fadd_rn).  That is the CSR row in index order, the order of
// the thread-per-node kernel this layout replaced, so the sweep gives that
// kernel's bits and the solves' counts and fields do not move with the
// layout; the plain version (ops/spmv.py node_block_sweep_plain) sums in
// the same order, so kernel and plain are equal bit for bit.  The lanes
// park their products in shared memory and lanes 0 and 1 of the group walk
// them in order (row 2k and row 2k+1): G float2 loads and 2G adds a round,
// far below the bytes.  Lane 1 hands its row to lane 0, which runs the
// epilogue: float2 loads of r, mask, msf, mpr (and z), one float2 store.
//
// The product's bits are K3's: the CSR kernel it replaces (csr_spmv_f32.cu,
// a thread a row) sums a row in index order from +0 with the same rounded
// products, and an entry missing from a present block adds +0 exactly (the
// FEM operators have none: every block of an element pattern is whole).
//
// Split z (K4 on one rank's row slice of a row-sharded operator, the JAX
// package's ShardedMeta branch of slot_sweep with split_z): the slice holds
// nodes node_offset .. node_offset + n_nodes - 1 with global block columns.
// The product reads z at those global columns; the update term reads the
// slice's own rows of z, 2 (node_offset + node); r, mask, msf, mpr and out
// are the slice's rows.  With node_offset 0 on a whole operator the launch
// and its bits are the unsharded sweep's.
//
// Jacobi: every row reads the old z, so `out` must not alias z.  No
// atomics: two launches give bit-identical output.  The file is built with
// -fmad=false.  TMA and wgmma do not apply: there is no matrix product and
// no regular tile.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int G = 8;                   // lanes a node
constexpr int kGroups = kThreads / G;  // nodes a block

// the epilogue, an argument of the launch
constexpr int kResidual = 0;  // out = mask (r - A z)
constexpr int kUpdate = 1;    // out = z + mask (msf res + mpr res_partner)
constexpr int kProduct = 2;   // out = A z

struct Block {
  float a00, a01, a10, a11;
};

__device__ __forceinline__ Block load_block(const float* __restrict__ values, int b) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(values) + b);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Block load_block(const unsigned short* __restrict__ values, int b) {
  // four bf16, little-endian: the even one in the low half of each word
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(values) + b);
  return {__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
          __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u)};
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
block_jacobi_sweep_kernel(int n_nodes, const int* __restrict__ node_ptr,
                          const int* __restrict__ block_cols, const V* __restrict__ values,
                          const float* __restrict__ z, const float* __restrict__ r,
                          const float* __restrict__ mask, const float* __restrict__ msf,
                          const float* __restrict__ mpr, float* __restrict__ out, int mode,
                          int node_offset) {
  // a group's products, a float4 a lane (row 2k: x, y; row 2k+1: z, w); the
  // slot after each group keeps the row walkers of a warp on distinct banks
  __shared__ float4 prod[kGroups * (G + 1)];
  const int sub = threadIdx.x % G;
  const int grp = threadIdx.x / G;
  const int node = blockIdx.x * kGroups + grp;
  const bool live = node < n_nodes;
  const int begin = live ? __ldg(node_ptr + node) : 0;
  const int end = live ? __ldg(node_ptr + node + 1) : 0;
  const int i0 = 2 * node;

  // the epilogue's inputs, requested before the row walk
  float2 rr = make_float2(0.f, 0.f), mk = rr, zz = rr, sf = rr, pr = rr;
  if (live && sub == 0 && mode != kProduct) {
    rr = __ldg(reinterpret_cast<const float2*>(r + i0));
    mk = __ldg(reinterpret_cast<const float2*>(mask + i0));
    if (mode == kUpdate) {
      // the slice's own rows of z (split z); i0 itself on a whole operator
      zz = __ldg(reinterpret_cast<const float2*>(z + 2 * (node_offset + node)));
      sf = __ldg(reinterpret_cast<const float2*>(msf + i0));
      pr = __ldg(reinterpret_cast<const float2*>(mpr + i0));
    }
  }

  float4* mine = prod + grp * (G + 1);
  float acc = 0.0f;  // lane 0: row 2k, lane 1: row 2k+1
  // every lane of the warp takes the same number of rounds (the shuffles
  // and warp barriers need them all)
  const int rounds = __reduce_max_sync(0xffffffffu, (end - begin + G - 1) / G);
  for (int round = 0; round < rounds; ++round) {
    const int base = begin + round * G;
    const int b = base + sub;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b < end) {
      const Block a = load_block(values, b);
      const int m = __ldg(block_cols + b);
      const float2 zm = __ldg(reinterpret_cast<const float2*>(z) + m);
      p = make_float4(__fmul_rn(a.a00, zm.x), __fmul_rn(a.a01, zm.y),
                      __fmul_rn(a.a10, zm.x), __fmul_rn(a.a11, zm.y));
    }
    mine[sub] = p;
    __syncwarp();
    if (sub < 2) {
      const int count = min(G, end - base);
      for (int j = 0; j < count; ++j) {
        const float2 q = reinterpret_cast<const float2*>(mine + j)[sub];
        acc = __fadd_rn(acc, q.x);
        acc = __fadd_rn(acc, q.y);
      }
    }
    __syncwarp();
  }
  const float acc1 = __shfl_down_sync(0xffffffffu, acc, 1);
  if (!live || sub != 0) return;
  if (mode == kProduct) {
    *reinterpret_cast<float2*>(out + i0) = make_float2(acc, acc1);
    return;
  }

  const float res0 = __fmul_rn(__fsub_rn(rr.x, acc), mk.x);
  const float res1 = __fmul_rn(__fsub_rn(rr.y, acc1), mk.y);
  float2 o;
  if (mode == kUpdate) {
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

template <typename V>
int launch(int n_nodes, const int* node_ptr, const int* block_cols, const V* values,
           const float* z, const float* r, const float* mask, const float* msf,
           const float* mpr, float* out, int mode, int node_offset, void* stream) {
  if (n_nodes <= 0) return 0;
  // 16 nodes a block: level 1 (1,839 nodes) spreads over 115 blocks
  const int blocks = (n_nodes + kGroups - 1) / kGroups;
  block_jacobi_sweep_kernel<V><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_nodes, node_ptr, block_cols, values, z, r, mask, msf, mpr, out, mode, node_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All launch on `stream` (a cudaStream_t passed as a pointer) and return the
// cudaError_t of the launch; 0 means the kernel was queued.  r, mask, msf,
// mpr and out have 2*n_nodes entries, z (and the product's x) one pair a
// node of the whole operator; z, r, mask, msf, mpr and out are 8-byte
// aligned, the f32 block values 16-byte aligned.  `node_offset`: the first
// node of a row slice (0 on a whole operator).
extern "C" int block_jacobi_sweep(int n_nodes, const int* node_ptr,
                                  const int* block_cols, const float* values,
                                  const float* z, const float* r,
                                  const float* mask, const float* msf,
                                  const float* mpr, float* out, int update,
                                  int node_offset, void* stream) {
  return launch(n_nodes, node_ptr, block_cols, values, z, r, mask, msf, mpr, out,
                update ? kUpdate : kResidual, node_offset, stream);
}

// The product y = A x on f32 blocks: the sweep's row walk, no epilogue input.
extern "C" int node_block_spmv(int n_nodes, const int* node_ptr, const int* block_cols,
                               const float* values, const float* x, float* y,
                               void* stream) {
  return launch(n_nodes, node_ptr, block_cols, values, x, nullptr, nullptr, nullptr,
                nullptr, y, kProduct, 0, stream);
}

// K5: `values` are bf16 bit patterns (torch.bfloat16 storage), four a block.
extern "C" int block_jacobi_sweep_bf16(int n_nodes, const int* node_ptr,
                                       const int* block_cols,
                                       const unsigned short* values,
                                       const float* z, const float* r,
                                       const float* mask, const float* msf,
                                       const float* mpr, float* out, int update,
                                       void* stream) {
  return launch(n_nodes, node_ptr, block_cols, values, z, r, mask, msf, mpr, out,
                update ? kUpdate : kResidual, 0, stream);
}
