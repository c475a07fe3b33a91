// Blocked right-looking Cholesky factor and solve of one SPD f32 matrix on
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's
// fem_elastoplasticity_tpu/ops/cholesky_pallas.py: `cholesky_factor`
// (_factor_kernel) and `cholesky_solve` (_solve_kernel).  The TPU kernel
// holds the whole padded matrix in VMEM and factors it in one launch; on the
// card a 908 x 908 f32 matrix (3.3 MB) is fifteen times a block's shared
// memory, so the factor works in a scratch copy of the padded matrix in
// global memory (it stays in the 50 MB L2).
//
// What bounds it: the operations, n^3/3 multiply-adds: 3.72 us at n = 908 and
// 39.8 us at n = 2000 at 67 TFLOP/s f32 (the products stay off the tensor
// cores: the port keeps TF32 off); the bytes (K read, L written) take about
// 2 us at 908.  At these sizes neither binds: the factor is a chain of
// dependent steps, 128 pivots a panel, and the card must be filled between
// them.  The design:
//
// * One persistent cooperative launch a factorization, the identity-tail
//   padding of K included.  Its grid is no larger than what is co-resident (the host checks the occupancy and
//   refuses otherwise); `grid.sync()` separates a panel's two stages, and a
//   flag a panel (a counter that each of ten blocks raises once, no data
//   summed through it) lets block 0 start the next panel early.
// * The diagonal 128-block, in block 0's shared memory, is factored as four
//   32-wide sub-panels.  Warp 0 factors the 32 x 32 diagonal sub-block in
//   registers (a lane holds a row, the pivot column travels by
//   __shfl_sync, no block barrier in its 32 steps) and inverts it (a lane
//   a column, by forward substitution).  Then all eight warps form the
//   sub-panel's rows below through that inverse and update the rest of the
//   block: three block barriers a sub-panel.  The 128-block's inverse is
//   assembled from the four 32 x 32 inverses by block substitution
//   (X_ij = -X_ii sum_k L_ik X_kj), not by 128 barrier-separated row steps;
//   warps 1-7 form the blocks that are ready while warp 0 factors the next
//   sub-block, so only the last block row follows the last sub-block.
// * Panel k, stage 1: L21 = A21 Li^T in 32 x 32 output tiles over the grid
//   (112 at n = 908 for the first panel).  Stage 2: A22 -= L21 L21^T on
//   its lower tiles: blocks 1-10 take the ten lower 32-tiles of the next
//   diagonal block first and raise the panel's flag; block 0 waits for the
//   flag and factors that block while the others update the 64 x 64 tiles
//   below it (99 at 908).  So block 0's chain overlaps the update, and a
//   panel costs two grid barriers.  Tile products are f32 FMAs over
//   register tiles, both operands staged whole in shared memory by one
//   round of 16-byte loads.
//
// No sum uses atomics and every tile is computed the same way whichever
// block takes it: two factorizations are bit-identical.
//
// The solve (_solve_kernel: y_k = Li_k (b_k - sum_{j<k} L_kj y_j), then
// x_k = Li_k^T (y_k - sum_{j>k} L_jk^T x_j)) reads n (n + 1) / 2 entries
// once (L below its diagonal blocks, the inverses' lower triangles) for
// about 2 n^2 flops: bytes bound it (0.49 us at n = 908, 2.39 us at 2000, as
// chip_smoke.py counts them), but its 2 nb block steps form a chain.  The
// design:
//
// * One persistent cooperative launch, tile-stationary.  Block (k mod grid)
//   owns diagonal step k: the inverse Li_k and the two sub-diagonal tiles
//   L_{k,k-1} (forward) and L_{k+1,k} (backward), the tiles on the chain.
//   Every other lower tile L_jk (j >= k + 2) has a block of its own while
//   the grid allows (nb + (nb - 1)(nb - 2)/2 blocks: 29 at n = 908, 121 at
//   2000).  A block stages its first three 64 KB tiles into shared memory
//   with cp.async once, and serves both passes from there (L_jk forward,
//   L_jk^T backward), so L crosses device memory once; tiles past three,
//   when nb is large, are read from global memory in each pass.
// * Forward step k: the owner of step k subtracts each partial L_kj y_j,
//   j < k - 1, in ascending j as it arrives, then forms L_{k,k-1} y_{k-1}
//   itself as soon as y_{k-1} is in, subtracts it last and multiplies by
//   Li_k.  The owner of tile (j, k) waits for y_k and writes L_jk y_k into
//   a slot of its own.  Backward the same on L^T, the partials in
//   descending j, so that again the one on the chain, L_{k+1,k}^T x_{k+1},
//   comes last.  No atomics: each partial has one writer, each sum one
//   order, so two launches are bit-identical.
// * Synchronization: the scratch (y, x, the partials) is cleared to a NaN
//   that no arithmetic result takes, then one grid barrier; a reader polls
//   the values themselves past L1 until none is unset (a vector by the
//   reading block's warp 0 alone, handed to its other warps through shared
//   memory).  So a block waits only for what it reads, and a step on the
//   chain costs one store-to-load trip through L2, with no fence and no
//   flag.
// * The products: a tile sits in registers, a warp 8 rows, a lane 4
//   columns, loaded before its owner waits; rows reduce by warp shuffles,
//   so no product needs shared memory.  The backward pass loads the tiles
//   transposed; the staged tiles' float4 chunks are permuted by row
//   (c4 ^ r / 4) so that row and column loads both miss no bank.  A vector
//   crosses the warps through shared memory: two block barriers a step.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 128;          // panel width (BLOCK of the TPU kernel)
constexpr int kSub = 32;         // sub-panel width: one warp
constexpr int kNs = kB / kSub;   // sub-panels a diagonal block
constexpr int kT = 64;           // output tile of the panel and update products
constexpr int kThreads = 256;    // eight warps
constexpr int kLd = kB + 4;      // row stride of the 128 x 128 blocks in shared memory
constexpr int kPld = kSub + 4;   // row stride of the 32-column scratch blocks
constexpr int kDiagTiles = 10;   // lower 32-tiles of a 128 diagonal block

// shared memory, in floats: the diagonal block D and its inverse Xi (a tile
// product stages its two operands over them), the rows below a sub-panel P
// (three 32 x 32 blocks) and five blocks T for the inverse's partial sums
constexpr int kSmemD = kB * kLd;
constexpr int kSmemP = (kB - kSub) * kPld;
constexpr int kSmemT = 5 * kSub * kPld;
constexpr size_t kFactorSmem = (2 * kSmemD + kSmemP + kSmemT) * sizeof(float);
static_assert(kB * (kT + 4) <= kSmemD, "a staged tile operand fits over D");

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// C (R x R, R = 32 or 64) = or -= X (R x 128) Y (R x 128)^T, one block.  Both
// operands are staged whole, depth-major, in one round of 16-byte loads (two
// neighbouring lanes read 32 bytes of a row); a thread holds an (R/16)^2
// register tile.
// ---------------------------------------------------------------------------
template <int R>
__device__ void tile_nt(const float* X, int ldx, const float* Y, int ldy, float* C,
                        int ldc, bool subtract, float* Xs, float* Ys) {
  constexpr int kTs = R + 4;  // (depth, row) stride: the staging stores miss no bank
  constexpr int M = R / 16;
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < R * kB / 4 / kThreads; ++i) {
    const int idx = t + i * kThreads;
    const int r = (idx >> 1) & (R - 1), k = 4 * (2 * (idx / (2 * R)) + (idx & 1));
    // written by other blocks of this launch: read past L1
    const float4 xv = __ldcg(reinterpret_cast<const float4*>(X + (size_t)r * ldx + k));
    const float4 yv = __ldcg(reinterpret_cast<const float4*>(Y + (size_t)r * ldy + k));
    Xs[k * kTs + r] = xv.x;
    Xs[(k + 1) * kTs + r] = xv.y;
    Xs[(k + 2) * kTs + r] = xv.z;
    Xs[(k + 3) * kTs + r] = xv.w;
    Ys[k * kTs + r] = yv.x;
    Ys[(k + 1) * kTs + r] = yv.y;
    Ys[(k + 2) * kTs + r] = yv.z;
    Ys[(k + 3) * kTs + r] = yv.w;
  }
  __syncthreads();
  const int tx = t & 15, ty = t >> 4;  // rows M ty .. M ty + M - 1, columns M tx ..
  float acc[M][M];
#pragma unroll
  for (int p = 0; p < M; ++p)
#pragma unroll
    for (int q = 0; q < M; ++q) acc[p][q] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kB; ++k) {
    float xs[M], ys[M];
    if constexpr (M == 4) {
      const float4 xv = *reinterpret_cast<const float4*>(Xs + k * kTs + M * ty);
      const float4 yv = *reinterpret_cast<const float4*>(Ys + k * kTs + M * tx);
      xs[0] = xv.x, xs[1] = xv.y, xs[2] = xv.z, xs[3] = xv.w;
      ys[0] = yv.x, ys[1] = yv.y, ys[2] = yv.z, ys[3] = yv.w;
    } else {
      const float2 xv = *reinterpret_cast<const float2*>(Xs + k * kTs + M * ty);
      const float2 yv = *reinterpret_cast<const float2*>(Ys + k * kTs + M * tx);
      xs[0] = xv.x, xs[1] = xv.y;
      ys[0] = yv.x, ys[1] = yv.y;
    }
#pragma unroll
    for (int p = 0; p < M; ++p)
#pragma unroll
      for (int q = 0; q < M; ++q) acc[p][q] += xs[p] * ys[q];
  }
#pragma unroll
  for (int p = 0; p < M; ++p) {
    float* dst = C + (size_t)(M * ty + p) * ldc + M * tx;
#pragma unroll
    for (int q = 0; q < M; ++q) dst[q] = subtract ? __ldcg(dst + q) - acc[p][q] : acc[p][q];
  }
  __syncthreads();  // Xs and Ys free again
}

// ---------------------------------------------------------------------------
// warp 0: factor and invert the 32 x 32 diagonal sub-block at (c0, c0) of D
// ---------------------------------------------------------------------------
__device__ void factor_sub_block(float* D, float* Xi, int c0) {
  const int lane = threadIdx.x & 31;
  float d[kSub];  // row c0 + lane of the sub-block
#pragma unroll
  for (int q = 0; q < kSub; ++q) d[q] = D[(c0 + lane) * kLd + c0 + q];

  // column j: col = d[:, j] rsqrt(d[j, j]); the trailing part loses col[r]
  // col[c] (the TPU kernel's chol_step).  Every lane updates all its
  // columns c > j, so no lane branches: the entries above the diagonal take
  // values nobody reads and are zeroed as j reaches them.
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float col = d[j] * rsqrtf(__shfl_sync(kFull, d[j], j));
#pragma unroll
    for (int c = j + 1; c < kSub; ++c) d[c] -= col * __shfl_sync(kFull, col, c);
    d[j] = lane >= j ? col : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kSub; ++q) D[(c0 + lane) * kLd + c0 + q] = d[q];
  __syncwarp();

  // X = Lss^-1 by columns, lane c solving Lss X[:, c] = e_c by forward
  // substitution: the entries of Lss are broadcast reads independent of X,
  // so the dependent chain is one multiply and one FMA a row
  const float rd = 1.0f / D[(c0 + lane) * kLd + c0 + lane];
  float x[kSub];
#pragma unroll
  for (int r = 0; r < kSub; ++r) x[r] = lane == r ? 1.0f : 0.0f;
#pragma unroll
  for (int q = 0; q < kSub; ++q) {
    x[q] *= __shfl_sync(kFull, rd, q);
#pragma unroll
    for (int r = q + 1; r < kSub; ++r) x[r] -= D[(c0 + r) * kLd + c0 + q] * x[q];
  }
#pragma unroll
  for (int r = 0; r < kSub; ++r) Xi[(c0 + r) * kLd + c0 + lane] = x[r];
}

// ---------------------------------------------------------------------------
// 32 x 32 block products for the inverse: jobs (out, A, B, depth) with
// out[r][c] (=, +=, or = -) sum_{q < depth} A[r][q] B[q][c]; a thread takes
// four rows of one column of one job, `tid` of `nth` threads
// ---------------------------------------------------------------------------
enum { kStore, kAdd, kNegate };

// out rows r0 .. r0 + 3, column c of one 32 x 32 block product
template <int Mode>
__device__ __forceinline__ void block_quad(float* __restrict__ out, int ldo,
                                           const float* __restrict__ A, int lda,
                                           const float* __restrict__ B, int ldb, int depth,
                                           int quad) {
  const int r0 = 4 * (quad / kSub), c = quad % kSub;
  float acc[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) acc[p] = Mode == kAdd ? out[(r0 + p) * ldo + c] : 0.0f;
#pragma unroll 4
  for (int q = 0; q < depth; q += 4) {
    const float bv[4] = {B[q * ldb + c], B[(q + 1) * ldb + c], B[(q + 2) * ldb + c],
                         B[(q + 3) * ldb + c]};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float4 av = *reinterpret_cast<const float4*>(A + (r0 + p) * lda + q);
      acc[p] += av.x * bv[0];
      acc[p] += av.y * bv[1];
      acc[p] += av.z * bv[2];
      acc[p] += av.w * bv[3];
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) out[(r0 + p) * ldo + c] = Mode == kNegate ? -acc[p] : acc[p];
}

// D's lower part under the sub-panel at c0 loses P P^T on the 32-column
// blocks cb_lo .. cb_hi - 1 to its right (`below` rows), warp w of nw a row
__device__ __forceinline__ void trailing_update(float* D, const float* P, int c0, int below,
                                                int cb_lo, int cb_hi, int w, int nw) {
  const int lane = threadIdx.x & 31;
  for (int cb = cb_lo; cb < cb_hi; ++cb) {
    float pc[kSub];
#pragma unroll
    for (int q = 0; q < kSub; ++q) pc[q] = P[(cb * kSub + lane) * kPld + q];
    for (int rr = cb * kSub + w; rr < below; rr += nw) {
      const float* prow = P + rr * kPld;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < kSub; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(prow + q);
        acc[0] += v.x * pc[q];
        acc[1] += v.y * pc[q + 1];
        acc[2] += v.z * pc[q + 2];
        acc[3] += v.w * pc[q + 3];
      }
      // columns right of the diagonal take values nobody reads
      D[(c0 + kSub + rr) * kLd + c0 + kSub + cb * kSub + lane] -=
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
}

// the barrier of warps 1-7 while warp 0 factors a sub-block
__device__ __forceinline__ void helpers_sync() { asm volatile("bar.sync 1, 224;" ::: "memory"); }

// ---------------------------------------------------------------------------
// one block: factor the diagonal block at `off` of the scratch `a` (already
// updated by the panels before it); write L's diagonal block and its inverse
// ---------------------------------------------------------------------------
__device__ void factor_diag_block(int n_pad, int off, const float* a, float* L,
                                  float* inv, float* sm) {
  float* D = sm;
  float* Xi = D + kSmemD;
  float* P = Xi + kSmemD;
  float* T = P + kSmemP;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  constexpr int kWarps = kThreads / 32;
  constexpr int kQuads = kSub * kSub / 4;  // four rows of one column: a thread's share
  // sub-blocks of D and Xi, and the partial-sum blocks
  auto Db = [&](int i, int j) { return D + kSub * i * kLd + kSub * j; };
  auto Xb = [&](int i, int j) { return Xi + kSub * i * kLd + kSub * j; };
  auto Pb = [&](int i) { return T + kSub * i * kPld; };

  for (int idx = t; idx < kB * kB / 4; idx += kThreads) {
    const int r = idx / (kB / 4), c = 4 * (idx % (kB / 4));
    // written by other blocks of this launch: read past L1
    const float4 v = __ldcg(reinterpret_cast<const float4*>(a + (size_t)(off + r) * n_pad + off + c));
    *reinterpret_cast<float4*>(D + r * kLd + c) = v;
    *reinterpret_cast<float4*>(Xi + r * kLd + c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  for (int s = 0; s < kNs; ++s) {
    const int c0 = s * kSub;
    const int below = kB - c0 - kSub;  // rows of the block under the sub-panel
    if (warp == 0) {
      factor_sub_block(D, Xi, c0);
    } else if (s >= 1) {
      // meanwhile the other warps finish the previous sub-panel's update
      // right of the sub-panel that warp 0 factors
      trailing_update(D, P, c0 - kSub, below + kSub, 1, (below + kSub) / kSub, warp - 1,
                      kWarps - 1);
    }
    if (warp > 0 && s == 2) {
      // and form the inverse's blocks below the diagonal that are ready:
      // X10 = -X11 (L10 X00)
      for (int e = t - 32; e < kQuads; e += 224)
        block_quad<kStore>(Pb(0), kPld, Db(1, 0), kLd, Xb(0, 0), kLd, kSub, e);
      helpers_sync();
      for (int e = t - 32; e < kQuads; e += 224)
        block_quad<kNegate>(Xb(1, 0), kLd, Xb(1, 1), kLd, Pb(0), kPld, kSub, e);
    } else if (warp > 0 && s == 3) {
      // X2j = -X22 T2j, and T3j = sum_k L3k Xkj but for X33's factor
      for (int e = t - 32; e < 5 * kQuads; e += 224) {
        const int q = e % kQuads;
        switch (e / kQuads) {
          case 0:  // T20 = L20 X00 + L21 X10
            block_quad<kStore>(Pb(0), kPld, Db(2, 0), kLd, Xb(0, 0), kLd, 2 * kSub, q);
            break;
          case 1:  // T21 = L21 X11
            block_quad<kStore>(Pb(1), kPld, Db(2, 1), kLd, Xb(1, 1), kLd, kSub, q);
            break;
          case 2:  // T30 = L30 X00 + L31 X10 (+ L32 X20 below)
            block_quad<kStore>(Pb(2), kPld, Db(3, 0), kLd, Xb(0, 0), kLd, 2 * kSub, q);
            break;
          case 3:  // T31 = L31 X11 (+ L32 X21 below)
            block_quad<kStore>(Pb(3), kPld, Db(3, 1), kLd, Xb(1, 1), kLd, kSub, q);
            break;
          default:  // T32 = L32 X22
            block_quad<kStore>(Pb(4), kPld, Db(3, 2), kLd, Xb(2, 2), kLd, kSub, q);
        }
      }
      helpers_sync();
      for (int e = t - 32; e < 2 * kQuads; e += 224) {
        const int j = e / kQuads;
        block_quad<kNegate>(Xb(2, j), kLd, Xb(2, 2), kLd, Pb(j), kPld, kSub, e % kQuads);
      }
      helpers_sync();
      for (int e = t - 32; e < 2 * kQuads; e += 224) {
        const int j = e / kQuads;
        block_quad<kAdd>(Pb(2 + j), kPld, Db(3, 2), kLd, Xb(2, j), kLd, kSub, e % kQuads);
      }
    }
    __syncthreads();
    if (below == 0) break;
    // P = D[c0 + 32 :, c0 : c0 + 32] Xss^T: lane = column, a warp per row
    {
      float xr[kSub];
#pragma unroll
      for (int q = 0; q < kSub; ++q) xr[q] = Xi[(c0 + lane) * kLd + c0 + q];
      for (int rr = warp; rr < below; rr += kWarps) {
        const float* drow = D + (c0 + kSub + rr) * kLd + c0;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < kSub; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(drow + q);
          acc[0] += v.x * xr[q];
          acc[1] += v.y * xr[q + 1];
          acc[2] += v.z * xr[q + 2];
          acc[3] += v.w * xr[q + 3];
        }
        P[rr * kPld + lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
    __syncthreads();
    // the sub-panel's rows below into D, and the next sub-panel's columns
    // lose P P^T (the rest of the update waits for the next warp-0 phase)
    for (int idx = t; idx < below * kSub; idx += kThreads) {
      const int rr = idx / kSub, q = idx % kSub;
      D[(c0 + kSub + rr) * kLd + c0 + q] = P[rr * kPld + q];
    }
    trailing_update(D, P, c0, below, 0, 1, warp, kWarps);
    __syncthreads();
  }

  // the last block row of the inverse: X3j = -X33 T3j
  for (int e = t; e < 3 * kQuads; e += kThreads) {
    const int j = e / kQuads;
    block_quad<kNegate>(Xb(3, j), kLd, Xb(3, 3), kLd, Pb(2 + j), kPld, kSub, e % kQuads);
  }
  __syncthreads();

  for (int idx = t; idx < kB * kB / 4; idx += kThreads) {
    const int r = idx / (kB / 4), c = 4 * (idx % (kB / 4));
    float4 v = *reinterpret_cast<const float4*>(D + r * kLd + c);
    if (c + 0 > r) v.x = 0.0f;
    if (c + 1 > r) v.y = 0.0f;
    if (c + 2 > r) v.z = 0.0f;
    if (c + 3 > r) v.w = 0.0f;
    *reinterpret_cast<float4*>(L + (size_t)(off + r) * n_pad + off + c) = v;
    *reinterpret_cast<float4*>(inv + (size_t)(off + r) * kB + c) =
        *reinterpret_cast<const float4*>(Xi + r * kLd + c);
  }
}

// lower tile t (row-major over i >= j) of an m x m grid of tiles -> (i, j)
__device__ __forceinline__ void lower_tile(int t, int* i, int* j) {
  int r = 0;
  while (t > r) {
    t -= r + 1;
    ++r;
  }
  *i = r;
  *j = t;
}

// ---------------------------------------------------------------------------
// the factorization, one persistent cooperative launch
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
chol_factor_kernel(int n, int n_pad, const float* __restrict__ K, float* a, float* L,
                   float* inv, int* flags) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Xs = sm;  // tile operands over D and Xi: block 0 has written those out
  float* Ys = sm + kSmemD;
  const int nb = n_pad / kB;
  const int g = gridDim.x, b = blockIdx.x;

  // the scratch: K padded with an identity tail (the TPU kernel's padding);
  // L's blocks above the diagonal, which nothing else writes, zeroed; the
  // flags reset
  for (int r = b; r < n_pad; r += g) {
    float* arow = a + (size_t)r * n_pad;
    float* lrow = L + (size_t)r * n_pad;
    for (int c = threadIdx.x; c < n_pad; c += kThreads) {
      arow[c] = r < n && c < n ? K[(size_t)r * n + c] : (r == c ? 1.0f : 0.0f);
      if (c / kB > r / kB) lrow[c] = 0.0f;
    }
  }
  if (b == 0 && static_cast<int>(threadIdx.x) < nb) flags[threadIdx.x] = 0;
  grid.sync();

  if (b == 0) factor_diag_block(n_pad, 0, a, L, inv, sm);
  for (int k = 0; k + 1 < nb; ++k) {
    const int off = k * kB;
    const int mt = (n_pad - off - kB) / kT;  // 64-row tiles below the diagonal block
    grid.sync();
    // stage 1: L21 = A21 Li^T in 32 x 32 tiles
    for (int t = b; t < 8 * mt; t += g) {
      const size_t row = (size_t)off + kB + (t >> 2) * kSub;
      const int c = (t & 3) * kSub;
      tile_nt<kSub>(a + row * n_pad + off, n_pad, inv + (size_t)(off + c) * kB, kB,
                    L + row * n_pad + off + c, n_pad, false, Xs, Ys);
    }
    grid.sync();
    // stage 2: A22 -= L21 L21^T on its lower tiles: first the ten lower
    // 32-tiles of the next diagonal block, which block 0 factors once they
    // are in, then the 64-tiles below it
    if (b == 0) {
      if (threadIdx.x == 0) {
        while (atomicAdd(flags + k, 0) < kDiagTiles) __nanosleep(100);
        __threadfence();
      }
      __syncthreads();
      factor_diag_block(n_pad, off + kB, a, L, inv, sm);
    } else {
      const int n_tiles = kDiagTiles + mt * (mt + 1) / 2 - 3;
      for (int t = b - 1; t < n_tiles; t += g - 1) {
        int i, j;
        if (t < kDiagTiles) {
          lower_tile(t, &i, &j);
          const size_t ri = (size_t)off + kB + i * kSub, rj = (size_t)off + kB + j * kSub;
          tile_nt<kSub>(L + ri * n_pad + off, n_pad, L + rj * n_pad + off, n_pad,
                        a + ri * n_pad + rj, n_pad, true, Xs, Ys);
        } else {
          lower_tile(t - kDiagTiles + 3, &i, &j);  // 64-tile rows 2 ..
          const size_t ri = (size_t)off + kB + i * kT, rj = (size_t)off + kB + j * kT;
          tile_nt<kT>(L + ri * n_pad + off, n_pad, L + rj * n_pad + off, n_pad,
                      a + ri * n_pad + rj, n_pad, true, Xs, Ys);
        }
        if (t < kDiagTiles) {  // release the tile to block 0
          __threadfence();
          __syncthreads();
          if (threadIdx.x == 0) atomicAdd(flags + k, 1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the solve: one cooperative launch, L's tiles stationary across the grid
// ---------------------------------------------------------------------------
constexpr int kSolveThreads = 512;                     // sixteen warps
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kWarpRows = kB / kSolveWarps;            // a warp's rows of a tile: 8
constexpr int kTile = kB * kB;                         // floats of a 128 x 128 tile
constexpr int kStage = 3;                              // tiles a block stages: 192 KB
constexpr size_t kSolveSmem = (kStage * kTile + 2 * kB) * sizeof(float);  // tiles, ring
static_assert(kWarpRows == 8, "a lane holds an 8 x 4 piece of a tile");
static_assert(kSolveSmem <= 232448, "the solve's shared memory fits a block");
// the scratch's "not written yet": a NaN that no arithmetic result takes
// (the card's NaN results are canonical, 0x7fffffff)
constexpr unsigned kUnset = 0xffbadbadu;

// A tile in registers: warp w holds rows 8 w .. 8 w + 7, lane l columns
// 4 l .. 4 l + 3.
struct RegTile {
  float v[kWarpRows][4];
};

// where a tile lives: staged in shared memory (row stride 128, the float4
// chunks of row r permuted by r / 4 so that row and column reads both miss
// no bank) or in global memory (row stride ld)
struct TileRef {
  const float* p;
  int ld;
  bool swizzled;
  __device__ const float4* chunk(int r, int c4) const {
    return reinterpret_cast<const float4*>(p + (size_t)r * ld) +
           (swizzled ? c4 ^ ((r >> 2) & 31) : c4);
  }
};

// T into registers
__device__ __forceinline__ void load_rows(RegTile& t, const TileRef& T) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const float4 x = *T.chunk(kWarpRows * w + i, lane);
    t.v[i][0] = x.x, t.v[i][1] = x.y, t.v[i][2] = x.z, t.v[i][3] = x.w;
  }
}

// T^T into registers: lane l reads rows 4 l .. 4 l + 3, columns 8 w .. 8 w + 7
__device__ __forceinline__ void load_cols(RegTile& t, const TileRef& T) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = *T.chunk(4 * lane + q, 2 * w);
    const float4 b = *T.chunk(4 * lane + q, 2 * w + 1);
    t.v[0][q] = a.x, t.v[1][q] = a.y, t.v[2][q] = a.z, t.v[3][q] = a.w;
    t.v[4][q] = b.x, t.v[5][q] = b.y, t.v[6][q] = b.z, t.v[7][q] = b.w;
  }
}

// sums[i] = sum_c t[8 w + i][c] v[c] in every lane of warp w; v4 holds this
// lane's v[4 lane .. 4 lane + 3].  The lanes' partial sums reduce by a
// butterfly, so every lane ends with the same bits.
__device__ __forceinline__ void row_sums(const RegTile& t, float4 v4, float* sums) {
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    sums[i] = t.v[i][0] * v4.x + t.v[i][1] * v4.y + t.v[i][2] * v4.z + t.v[i][3] * v4.w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) sums[i] += __shfl_xor_sync(kFull, sums[i], off);
}

// lane i of warp w writes row 8 w + i
__device__ __forceinline__ void store_rows(const float* sums, float* out) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    if (lane == i) out[kWarpRows * w + i] = sums[i];
}

__device__ __forceinline__ bool is_set(float v) { return __float_as_uint(v) != kUnset; }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// four floats another block writes once into the cleared scratch: read past
// L1 until all four are set.  The value is its own flag: no fence, no
// second read.  Every wait ends: the cooperative launch makes the whole grid
// co-resident, and each value is written by a block that waits only for
// earlier steps.  A wait of seconds therefore means a fault in the schedule,
// and the kernel traps.  The trap ends the launch with an error that the
// caller's next CUDA call reports, and leaves the process's CUDA context
// unusable; a hang instead would hold the card, and every process queued on
// it, until the machine is reset.  No input reaches the trap (no arithmetic
// result is the unset NaN), so no test does.
__device__ __forceinline__ float4 await4(const float* p) {
  constexpr unsigned long long kWaitLimitNs = 2000000000ull;
  unsigned long long t0 = 0;
  float4 v;
  for (;;) {
    asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p)
                 : "memory");
    if (is_set(v.x) && is_set(v.y) && is_set(v.z) && is_set(v.w)) return v;
    const unsigned long long t = global_ns();
    if (t0 == 0) {
      t0 = t;
    } else if (t - t0 > kWaitLimitNs) {
      __trap();
    }
    __nanosleep(32);
  }
}

// A block's two 128-float buffers that carry a vector across its warps, used
// in turns: one block barrier a hand-over, so a buffer is written again only
// after every warp has read it.
struct Ring {
  float* buf;
  int turn;
  __device__ float* next() { return buf + (turn++ & 1) * kB; }
};

// a vector another block writes, v[4 lane .. 4 lane + 3] in every warp:
// warp 0 alone polls it (one block's requests on the line, not sixteen
// warps') and hands it over through the ring
__device__ __forceinline__ float4 share4(const float* v, Ring& ring) {
  float4* dst = reinterpret_cast<float4*>(ring.next());
  if (threadIdx.x < 32) dst[threadIdx.x] = await4(v + 4 * threadIdx.x);
  __syncthreads();
  return dst[threadIdx.x & 31];
}

// acc[i] -= part[8 w + i], every lane of warp w
__device__ __forceinline__ void subtract_part(float* acc, const float* part) {
  const int w = threadIdx.x >> 5;
  const float4 a = await4(part + kWarpRows * w);
  const float4 b = await4(part + kWarpRows * w + 4);
  acc[0] -= a.x, acc[1] -= a.y, acc[2] -= a.z, acc[3] -= a.w;
  acc[4] -= b.x, acc[5] -= b.y, acc[6] -= b.z, acc[7] -= b.w;
}

// the solve's schedule: block (k mod grid) owns diagonal step k (Li_k, and
// the sub-diagonal tiles L_{k,k-1}, L_{k+1,k} that sit on the chain); the
// other tiles (j, k), j >= k + 2, are numbered down the columns (`slot`)
// and dealt out after them
struct SolvePlan {
  int nb, grid, b;
  __device__ int slot(int j, int k) const { return k * (nb - 2) - k * (k - 1) / 2 + j - k - 2; }
  __device__ bool owns_step(int k) const { return k % grid == b; }
  __device__ bool owns_slot(int t) const { return (nb + t) % grid == b; }
};

// the block's staged tiles, found by their address in global memory
struct Staged {
  const float* src[kStage];
  const float* smem;
  __device__ TileRef find(const float* p, int global_ld) const {
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (src[s] == p) return TileRef{smem + s * kTile, kB, true};
    return TileRef{p, global_ld, false};
  }
};

__global__ void __launch_bounds__(kSolveThreads, 1)
chol_solve_kernel(int n, int n_pad, const float* __restrict__ L,
                  const float* __restrict__ inv, const float* __restrict__ b,
                  float* __restrict__ x_out, float* scratch) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Ring ring{sm + kStage * kTile, 0};  // (2, 128)
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int nb = n_pad / kB, slots = (nb - 1) * (nb - 2) / 2;
  const SolvePlan P{nb, static_cast<int>(gridDim.x), static_cast<int>(blockIdx.x)};
  // the scratch, cleared to kUnset below: y and x (n_pad each), then a 128
  // slot a tile off the chain for L_jk y_k and one for L_jk^T x_j
  float* y = scratch;
  float* x = y + n_pad;
  float* part = x + n_pad;
  float* qpart = part + (size_t)slots * kB;
  auto Ltile = [&](int j, int k) { return L + (size_t)j * kB * n_pad + (size_t)k * kB; };
  auto Itile = [&](int k) { return inv + (size_t)k * kTile; };

  // stage the block's first tiles, in the order it uses them, with cp.async
  // (swizzled: chunk c4 of row r at c4 ^ (r / 4 mod 32)); clear the scratch
  // meanwhile
  Staged st;
  st.smem = sm;
  {
    int m = 0, lds[kStage];
    auto stage = [&](const float* p, int ld) {
      if (m < kStage) st.src[m] = p, lds[m++] = ld;
    };
    for (int k = P.b; k < nb && m < kStage; k += P.grid) {
      stage(Itile(k), kB);
      if (k > 0) stage(Ltile(k, k - 1), n_pad);
      if (k + 1 < nb) stage(Ltile(k + 1, k), n_pad);
    }
    for (int k = 0; k < nb && m < kStage; ++k)
      for (int j = k + 2; j < nb && m < kStage; ++j)
        if (P.owns_slot(P.slot(j, k))) stage(Ltile(j, k), n_pad);
    for (int s = 0; s < kStage; ++s) {
      if (s >= m) {
        st.src[s] = nullptr;
        continue;
      }
      for (int idx = tid; idx < kTile / 4; idx += kSolveThreads) {
        const int r = idx / (kB / 4), c4 = idx % (kB / 4);
        __pipeline_memcpy_async(sm + s * kTile + r * kB + 4 * (c4 ^ ((r >> 2) & 31)),
                                st.src[s] + (size_t)r * lds[s] + 4 * c4, 16);
      }
    }
    __pipeline_commit();
  }
  const float unset = __uint_as_float(kUnset);
  for (size_t i = (size_t)P.b * kSolveThreads + tid; i < 2 * (size_t)n_pad + 2 * (size_t)slots * kB;
       i += (size_t)P.grid * kSolveThreads)
    scratch[i] = unset;
  __pipeline_wait_prior(0);
  grid.sync();  // the scratch clear everywhere; the staged tiles in (this block's barrier)

  RegTile A, B;
  float acc[kWarpRows], sums[kWarpRows];
  // acc (rows 8 w + i in every lane of warp w) through a diagonal inverse:
  // out[8 w + i] = sum_c T[8 w + i][c] acc[c]
  auto through = [&](const RegTile& T, float* out) {
    float* rhs = ring.next();
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
      if (lane == i) rhs[kWarpRows * w + i] = acc[i];
    __syncthreads();
    row_sums(T, reinterpret_cast<const float4*>(rhs)[lane], sums);
    store_rows(sums, out);
  };

  // forward: y_k = Li_k (b_k - sum_{j<k} L_kj y_j), the partials in
  // ascending j, the one on the chain (j = k - 1) last
  for (int k = 0; k < nb; ++k) {
    const int off = k * kB;
    if (P.owns_step(k)) {
      load_rows(A, st.find(Itile(k), kB));
      if (k > 0) load_rows(B, st.find(Ltile(k, k - 1), n_pad));
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const int r = off + kWarpRows * w + i;
        acc[i] = r < n ? b[r] : 0.0f;
      }
      for (int j = 0; j + 1 < k; ++j) subtract_part(acc, part + (size_t)P.slot(k, j) * kB);
      if (k > 0) {
        row_sums(B, share4(y + off - kB, ring), sums);
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) acc[i] -= sums[i];
      }
      through(A, y + off);
    }
    for (int j = k + 2; j < nb; ++j) {
      const int t = P.slot(j, k);
      if (!P.owns_slot(t)) continue;
      load_rows(B, st.find(Ltile(j, k), n_pad));
      row_sums(B, share4(y + off, ring), sums);
      store_rows(sums, part + (size_t)t * kB);
    }
  }

  // backward: x_k = Li_k^T (y_k - sum_{j>k} L_jk^T x_j), the partials in
  // descending j, the one on the chain (j = k + 1) last
  for (int k = nb - 1; k >= 0; --k) {
    const int off = k * kB;
    if (P.owns_step(k)) {
      load_cols(A, st.find(Itile(k), kB));
      if (k + 1 < nb) load_cols(B, st.find(Ltile(k + 1, k), n_pad));
      const float4 ya = await4(y + off + kWarpRows * w);  // this block's own y_k
      const float4 yb = await4(y + off + kWarpRows * w + 4);
      acc[0] = ya.x, acc[1] = ya.y, acc[2] = ya.z, acc[3] = ya.w;
      acc[4] = yb.x, acc[5] = yb.y, acc[6] = yb.z, acc[7] = yb.w;
      for (int j = nb - 1; j >= k + 2; --j) subtract_part(acc, qpart + (size_t)P.slot(j, k) * kB);
      if (k + 1 < nb) {
        row_sums(B, share4(x + off + kB, ring), sums);
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) acc[i] -= sums[i];
      }
      through(A, x + off);
      if (lane < kWarpRows && off + kWarpRows * w + lane < n) {
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i)
          if (lane == i) x_out[off + kWarpRows * w + i] = sums[i];
      }
    }
    // the tiles of block row k feed the steps left of it
    for (int c = 0; c + 2 <= k; ++c) {
      const int t = P.slot(k, c);
      if (!P.owns_slot(t)) continue;
      load_cols(B, st.find(Ltile(k, c), n_pad));
      row_sums(B, share4(x + off, ring), sums);
      store_rows(sums, qpart + (size_t)t * kB);
    }
  }
}

}  // namespace

// The factorization's grid: one block per tile of the first panel's trailing
// update (plus block 0), at least eleven, at most what is co-resident.  Writes the grid to *blocks and the co-resident capacity to
// *capacity; returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge when
// eleven blocks do not fit, or the device takes no cooperative launch).
extern "C" int cholesky_factor_grid(int n_pad, int* blocks, int* capacity) {
  *blocks = 0;
  *capacity = 0;
  if (n_pad <= 0 || n_pad % kB) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      chol_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFactorSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_factor_kernel, kThreads,
                                                           kFactorSmem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  *capacity = per_sm * sms;
  const int mt = 2 * (n_pad / kB - 1);
  int want = mt * (mt + 1) / 2 - 3 + kDiagTiles + 1;
  if (want < kDiagTiles + 1) want = kDiagTiles + 1;
  if (!coop || *capacity < kDiagTiles + 1) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  *blocks = want < *capacity ? want : *capacity;
  return 0;
}

// Factor the SPD matrix `K` (n x n, row-major), padded with an identity
// tail to n_pad (a multiple of 128, at most 128 * kThreads), into `L`
// (n_pad x n_pad, lower, the strict upper part zero) and `inv` (n_pad x
// 128, the inverses of L's diagonal blocks), on `blocks` blocks
// (`cholesky_factor_grid`).  `a` (n_pad x n_pad) and `flags` (n_pad / 128
// ints) are scratch; no output needs to be initialised.  Launches one
// cooperative kernel on `stream`, writes the number of kernels it launched
// to `*launched` and returns the cudaError_t of the launch, or 0.
extern "C" int cholesky_factor_f32(int n, int n_pad, const float* K, float* a, float* L,
                                   float* inv, int* flags, int blocks, void* stream,
                                   int* launched) {
  *launched = 0;
  if (n <= 0 || n > n_pad || n_pad % kB || n_pad / kB > kThreads ||
      blocks < kDiagTiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&n, &n_pad, &K, &a, &L, &inv, &flags};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chol_factor_kernel), dim3(blocks), dim3(kThreads), args,
      kFactorSmem, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  return 0;
}

// The solve's grid: a block for each diagonal step and each tile off the
// chain, nb + (nb - 1)(nb - 2) / 2, at most what is co-resident.  Writes the
// grid to *blocks, the co-resident capacity to *capacity and the floats of
// scratch the solve needs to *scratch_floats; returns a cudaError_t.
extern "C" int cholesky_solve_grid(int n_pad, int* blocks, int* capacity,
                                   long long* scratch_floats) {
  *blocks = 0;
  *capacity = 0;
  *scratch_floats = 0;
  if (n_pad <= 0 || n_pad % kB) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSolveSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_solve_kernel,
                                                           kSolveThreads, kSolveSmem)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  *capacity = per_sm * sms;
  if (!coop || *capacity < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long nb = n_pad / kB, slots = (nb - 1) * (nb - 2) / 2;
  const long long want = nb + slots;
  *blocks = static_cast<int>(want < *capacity ? want : *capacity);
  // y, x and two partial products a tile off the chain
  *scratch_floats = 2 * (long long)n_pad + 2 * slots * kB;
  return 0;
}

// Solve L L^T x = b for x (n,) from the factor's L and inv; b is (n,).
// `scratch` holds `cholesky_solve_grid`'s scratch_floats floats, uninitialised;
// `blocks` is its grid.  Launches one cooperative kernel on `stream` and
// returns the cudaError_t of the launch, or 0.
extern "C" int cholesky_solve_f32(int n, int n_pad, const float* L, const float* inv,
                                  const float* b, float* x, float* scratch, int blocks,
                                  void* stream) {
  if (n <= 0 || n > n_pad || n_pad % kB || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&n, &n_pad, &L, &inv, &b, &x, &scratch};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chol_solve_kernel), dim3(blocks), dim3(kSolveThreads), args,
      kSolveSmem, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
