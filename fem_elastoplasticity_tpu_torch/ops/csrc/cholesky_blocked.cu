// Blocked right-looking Cholesky factor and solve of one SPD f32 matrix on
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's
// fem_elastoplasticity_tpu/ops/cholesky_pallas.py: `cholesky_factor`
// (_factor_kernel) and `cholesky_solve` (_solve_kernel).  The TPU kernel
// holds the whole padded matrix in VMEM and factors it in one launch; on the
// card a 908 x 908 f32 matrix (3.3 MB) is fifteen times a block's shared
// memory, so the factor works in a scratch copy of the padded matrix in
// global memory (it stays in the 50 MB L2) and takes three launches for each
// 128-wide panel k:
//
//   1. chol_diag_kernel: one block holds the 128 x 128 diagonal block in
//      shared memory, factors it column by column with the pivot's reciprocal
//      square root (the TPU kernel's chol_step), writes Lk, forms its inverse
//      Li = Lk^-1 by forward substitution and writes it to inv_blocks;
//   2. chol_panel_kernel: L21 = A21 Li^T, one block for each 128-row tile
//      below the diagonal;
//   3. chol_update_kernel: A22 -= L21 L21^T on the tiles on and below the
//      diagonal only, one block a tile.
//
// Panels 0 .. nb-1 give 3 nb - 2 launches (22 at n = 908).  The solve is one
// launch of one block that walks the 2 nb block steps of _solve_kernel:
// y_k = (b_k - sum_{j<k} L_kj y_j) through Li, then
// x_k = (y_k - sum_{j>k} L_jk^T x_j) through Li^T, with y and x in shared
// memory and L and inv_blocks read from global memory.
//
// Products are plain f32 FMAs outside the tensor cores (the port keeps TF32
// off).  No sum uses atomics: two launches give bit-identical results.
//
// What bounds it: the operations, n^3/3 multiply-adds, 3.7 us at n = 908 at
// 67 TFLOP/s; the bytes (K read, L written) take 2 us.  This first design
// is bound by neither: the diagonal block's 2 x 128 dependent column steps,
// each ending in a block-wide barrier, form a serial chain of some 500
// barriers a panel, and the tile products are one 128 x 128 tile a block.
// A later design would factor the diagonal block with warp shuffles and run
// the products on the tensor cores (3xTF32 or wgmma).

#include <cuda_runtime.h>

namespace {

constexpr int kB = 128;             // panel width (BLOCK of the TPU kernel)
constexpr int kDiagThreads = 1024;  // 8 row groups of 128 columns
constexpr int kTileThreads = 256;   // 16 x 16, an 8 x 8 micro-tile each
constexpr int kChunk = 32;          // k-depth staged in shared memory

// ---------------------------------------------------------------------------
// 1. the diagonal block: factor, then invert
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kDiagThreads)
chol_diag_kernel(int n_pad, int off, const float* __restrict__ a,
                 float* __restrict__ L, float* __restrict__ inv) {
  extern __shared__ float sm[];
  float* D = sm;              // (128, 128) row-major: the block, then Lk
  float* X = D + kB * kB;     // (128, 128): the inverse, built in place
  float* col = X + kB * kB;   // (128,): the scaled pivot column
  const int t = threadIdx.x;
  const int c = t & (kB - 1);  // this thread's column
  const int g = t >> 7;        // its row group: rows g, g + 8, ...
  const int groups = kDiagThreads / kB;

  for (int r = g; r < kB; r += groups) {
    D[r * kB + c] = a[(size_t)(off + r) * n_pad + off + c];
    X[r * kB + c] = r == c ? 1.0f : 0.0f;
  }
  __syncthreads();

  // column j: col = D[:, j] / sqrt(D[j, j]) on rows >= j; the lower
  // trailing triangle r >= c > j loses col[r] col[c]; column j becomes col
  for (int j = 0; j < kB; ++j) {
    if (t >= j && t < kB) {
      const float pivot = 1.0f / sqrtf(D[j * kB + j]);
      col[t] = D[t * kB + j] * pivot;
    }
    __syncthreads();
    if (c > j) {
      const float cc = col[c];
      int r = g;
      if (r < c) r += ((c - r + groups - 1) / groups) * groups;
      for (; r < kB; r += groups) D[r * kB + c] -= col[r] * cc;
    } else if (c == j) {
      for (int r = g; r < kB; r += groups) D[r * kB + c] = r >= j ? col[r] : 0.0f;
    }
    __syncthreads();
  }
  for (int r = g; r < kB; r += groups) {
    const float v = r >= c ? D[r * kB + c] : 0.0f;
    D[r * kB + c] = v;
    L[(size_t)(off + r) * n_pad + off + c] = v;
  }
  __syncthreads();

  // Lk X = I by forward substitution, row j of X at step j: X[j] /= Lk[j, j],
  // then every later row i loses Lk[i, j] X[j]
  for (int j = 0; j < kB; ++j) {
    if (t < kB) X[j * kB + t] = X[j * kB + t] / D[j * kB + j];
    __syncthreads();
    if (c <= j) {
      const float xj = X[j * kB + c];
      int r = g;
      if (r <= j) r += ((j + 1 - r + groups - 1) / groups) * groups;
      for (; r < kB; r += groups) X[r * kB + c] -= D[r * kB + j] * xj;
    }
    __syncthreads();
  }
  for (int r = g; r < kB; r += groups) {
    inv[(size_t)(off + r) * kB + c] = X[r * kB + c];
  }
}

// ---------------------------------------------------------------------------
// 2 and 3. tile products C (128 x 128) = or -= X Y^T, depth 128
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tile_nt(const float* __restrict__ Xg, int ldx,
                                        const float* __restrict__ Yg, int ldy,
                                        float* __restrict__ Cg, int ldc,
                                        bool subtract) {
  __shared__ float Xs[kB][kChunk + 1];
  __shared__ float Ys[kB][kChunk + 1];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;

  for (int k0 = 0; k0 < kB; k0 += kChunk) {
#pragma unroll
    for (int i = 0; i < kB * kChunk / kTileThreads; ++i) {
      const int idx = t + i * kTileThreads;
      const int r = idx / kChunk, k = idx % kChunk;
      Xs[r][k] = Xg[(size_t)r * ldx + k0 + k];
      Ys[r][k] = Yg[(size_t)r * ldy + k0 + k];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float xv[8], yv[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) xv[p] = Xs[ty + 16 * p][k];
#pragma unroll
      for (int q = 0; q < 8; ++q) yv[q] = Ys[tx + 16 * q][k];
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] += xv[p] * yv[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float* dst = Cg + (size_t)(ty + 16 * p) * ldc + tx + 16 * q;
      *dst = subtract ? *dst - acc[p][q] : acc[p][q];
    }
}

// L21 tile i (rows off + 128 (i + 1) ..) = A21 tile i · Li^T
__global__ void __launch_bounds__(kTileThreads)
chol_panel_kernel(int n_pad, int off, const float* __restrict__ a,
                  const float* __restrict__ inv, float* __restrict__ L) {
  const size_t row = (size_t)off + kB * (blockIdx.x + 1);
  tile_nt(a + row * n_pad + off, n_pad, inv + (size_t)off * kB, kB,
          L + row * n_pad + off, n_pad, false);
}

// A22 tile (i, j), i >= j, -= L21 tile i · (L21 tile j)^T; the block index
// walks the lower tiles row by row
__global__ void __launch_bounds__(kTileThreads)
chol_update_kernel(int n_pad, int off, const float* __restrict__ L,
                   float* __restrict__ a) {
  int i = 0, b = blockIdx.x;
  while (b > i) {
    b -= i + 1;
    ++i;
  }
  const int j = b;
  const size_t ri = (size_t)off + kB * (i + 1), rj = (size_t)off + kB * (j + 1);
  tile_nt(L + ri * n_pad + off, n_pad, L + rj * n_pad + off, n_pad,
          a + ri * n_pad + rj, n_pad, true);
}

// ---------------------------------------------------------------------------
// the solve: one block, y and x in shared memory
// ---------------------------------------------------------------------------
constexpr int kSolveThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

__global__ void __launch_bounds__(kSolveThreads)
chol_solve_kernel(int n, int n_pad, const float* __restrict__ L,
                  const float* __restrict__ inv, const float* __restrict__ b,
                  float* __restrict__ x_out) {
  extern __shared__ float sm[];
  float* y = sm;               // (n_pad,)
  float* x = y + n_pad;        // (n_pad,)
  float* acc = x + n_pad;      // (128,)
  float* part = acc + kB;      // (8, 128) partial column sums
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int c = t & (kB - 1), g = t >> 7;
  const int warps = kSolveThreads / 32, groups = kSolveThreads / kB;
  const int nb = n_pad / kB;

  // forward: acc = b_k - L[k rows, :off] y[:off]; y_k = Li acc
  for (int k = 0; k < nb; ++k) {
    const int off = k * kB;
    for (int r = warp; r < kB; r += warps) {
      const float* lrow = L + (size_t)(off + r) * n_pad;
      float s = 0.0f;
      for (int q = lane; q < off; q += 32) s += lrow[q] * y[q];
      s = warp_sum(s);
      if (lane == 0) acc[r] = (off + r < n ? b[off + r] : 0.0f) - s;
    }
    __syncthreads();
    for (int r = warp; r < kB; r += warps) {
      const float* irow = inv + (size_t)(off + r) * kB;
      float s = 0.0f;
      for (int q = lane; q < kB; q += 32) s += irow[q] * acc[q];
      s = warp_sum(s);
      if (lane == 0) y[off + r] = s;
    }
    __syncthreads();
  }

  // backward: acc = y_k - L[off + 128:, k cols]^T x[off + 128:]; x_k = Li^T acc
  for (int k = nb - 1; k >= 0; --k) {
    const int off = k * kB;
    float s = 0.0f;
    for (int q = off + kB + g; q < n_pad; q += groups) {
      s += L[(size_t)q * n_pad + off + c] * x[q];
    }
    part[g * kB + c] = s;
    __syncthreads();
    if (t < kB) {
      float tot = 0.0f;
      for (int h = 0; h < groups; ++h) tot += part[h * kB + t];
      acc[t] = y[off + t] - tot;
    }
    __syncthreads();
    s = 0.0f;
    for (int r = g; r < kB; r += groups) s += inv[(size_t)(off + r) * kB + c] * acc[r];
    part[g * kB + c] = s;
    __syncthreads();
    if (t < kB) {
      float tot = 0.0f;
      for (int h = 0; h < groups; ++h) tot += part[h * kB + t];
      x[off + t] = tot;
    }
    __syncthreads();
  }
  for (int q = t; q < n; q += kSolveThreads) x_out[q] = x[q];
}

constexpr size_t kDiagSmem = (2 * kB * kB + kB) * sizeof(float);

size_t solve_smem(int n_pad) {
  return (2 * (size_t)n_pad + kB + (kSolveThreads / kB) * kB) * sizeof(float);
}

}  // namespace

// The largest n_pad the solve's shared memory takes (232,448 bytes a block).
extern "C" int cholesky_solve_max_n_pad() {
  return static_cast<int>((232448 / sizeof(float) - kB - (kSolveThreads / kB) * kB) / 2 / kB * kB);
}

// Factor the padded SPD matrix `a` (n_pad x n_pad, row-major, n_pad a
// multiple of 128; overwritten: it is the scratch of the trailing updates)
// into `L` (n_pad x n_pad; the caller zeroes it, only the lower tiles are
// written) and `inv` (n_pad x 128, the inverses of L's diagonal blocks).
// Launches on `stream`, writes the number of kernels it launched to
// `*launched` (also when a launch fails) and returns the first nonzero
// cudaError_t, or 0.
extern "C" int cholesky_factor_f32(int n_pad, float* a, float* L, float* inv,
                                   void* stream, int* launched) {
  *launched = 0;
  if (n_pad <= 0 || n_pad % kB) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      chol_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDiagSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n_pad / kB;
  for (int k = 0; k < nb; ++k) {
    const int off = k * kB;
    chol_diag_kernel<<<1, kDiagThreads, kDiagSmem, s>>>(n_pad, off, a, L, inv);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    const int m = nb - 1 - k;
    if (m == 0) break;
    chol_panel_kernel<<<m, kTileThreads, 0, s>>>(n_pad, off, a, inv, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    chol_update_kernel<<<m * (m + 1) / 2, kTileThreads, 0, s>>>(n_pad, off, L, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}

// Solve L L^T x = b for x (n,) from the factor's L and inv; b is (n,).
extern "C" int cholesky_solve_f32(int n, int n_pad, const float* L,
                                  const float* inv, const float* b, float* x,
                                  void* stream) {
  if (n <= 0 || n > n_pad || n_pad % kB || n_pad > cholesky_solve_max_n_pad()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = solve_smem(n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_kernel<<<1, kSolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, n_pad, L, inv, b, x);
  return static_cast<int>(cudaGetLastError());
}
