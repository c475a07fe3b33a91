"""Kernel K7, the blocked f32 Cholesky factor and solve, and its plain version.

Counterpart of `fem_elastoplasticity_tpu/ops/cholesky_pallas.py`, with the
same names, arguments and output shapes:

* `cholesky_factor(K) -> (L, inv_blocks)`: K (n, n) SPD is padded with an
  identity tail to n_pad, a multiple of BLOCK = 128, and factored by the
  right-looking blocked algorithm of 128-wide panels.  L is (n_pad, n_pad)
  f32, lower, its strict upper part zero; inv_blocks is (n_pad, 128) f32,
  the inverses of L's 128 x 128 diagonal blocks.
* `cholesky_solve(L, inv_blocks, b, n) -> x`: x (n,) f32 with
  L L^T x = b, by block forward and back substitution through the stored
  inverses.

Each has a `_plain` version that follows the TPU kernel's algorithm step
for step in PyTorch (the column loop with the pivot's reciprocal square
root, the forward-substitution inverse, the two block products), and a
`_cuda` version that launches the hand-written kernels of
`csrc/cholesky_blocked.cu` on PyTorch's current stream: the factor and the
solve are one cooperative launch each, on a grid no larger than what is
co-resident (the solve's: a block for each diagonal step and each tile of
L off the chain, each holding its tiles for both passes).  The entry points
launch the kernels on a CUDA tensor and run the plain version on a CPU
tensor; they never fall back from one to the other.

No solve of the JAX package calls these functions (its dense paths factor
with `jax.scipy.linalg.cho_factor`, the port's with `torch.linalg`), and
the port wires them into none: they are an entry point of their own.

`LAUNCHES` counts, per process, the kernels launched ("cholesky_factor":
the kernels a factorization launched, as the library reports them: one;
"cholesky_solve": one a solve), the factorizations
("cholesky_factorizations") and the calls routed to the plain versions
("cholesky_factor_plain", "cholesky_solve_plain").
"""
from __future__ import annotations

import collections
import ctypes
import functools
import pathlib
from typing import Tuple

import torch

BLOCK = 128
KERNEL_SOURCE = pathlib.Path(__file__).parent / "csrc" / "cholesky_blocked.cu"
LAUNCHES: collections.Counter = collections.Counter()


def _pad_to_block(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def pad_matrix(K: torch.Tensor) -> torch.Tensor:
    """K (n, n) -> f32 (n_pad, n_pad) with K in the top-left corner and an
    identity tail (`cholesky_pallas.py:154-156`)."""
    n = K.shape[0]
    if K.dim() != 2 or K.shape[1] != n:
        raise ValueError(f"cholesky_factor: K must be square; got {tuple(K.shape)}")
    n_pad = _pad_to_block(n)
    Kp = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=K.device)
    Kp[:n, :n] = K.to(torch.float32)
    Kp.diagonal()[n:].fill_(1.0)
    return Kp


def cholesky_factor_plain(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's factorization in PyTorch (`_factor_kernel`,
    `cholesky_pallas.py:38-96`), on K's device."""
    A = pad_matrix(K)
    n_pad = A.shape[0]
    nb = n_pad // BLOCK
    L = torch.zeros_like(A)
    inv = torch.zeros((n_pad, BLOCK), dtype=torch.float32, device=A.device)
    idx = torch.arange(BLOCK, device=A.device)
    rows, cols = idx[:, None], idx[None, :]
    eye = torch.eye(BLOCK, dtype=torch.float32, device=A.device)
    zero = torch.zeros((), dtype=torch.float32, device=A.device)
    for k in range(nb):
        off = k * BLOCK
        D = A[off:off + BLOCK, off:off + BLOCK].clone()
        for j in range(BLOCK):  # chol_step
            pivot = torch.rsqrt(D[j, j])
            col = D[:, j] * pivot
            colm = torch.where(idx > j, col, zero)
            D = D - colm[:, None] * colm[None, :]
            D[:, j] = torch.where(idx >= j, col, zero)
        Lk = torch.where(rows >= cols, D, zero)
        L[off:off + BLOCK, off:off + BLOCK] = Lk
        X = torch.zeros((BLOCK, BLOCK), dtype=torch.float32, device=A.device)
        for j in range(BLOCK):  # inv_step: Lk X = I by forward substitution
            lrow = torch.where(idx < j, Lk[j], zero)
            X[j] = (eye[j] - lrow @ X) / Lk[j, j]
        inv[off:off + BLOCK] = X
        if k < nb - 1:
            L21 = A[off + BLOCK:, off:off + BLOCK] @ X.T
            L[off + BLOCK:, off:off + BLOCK] = L21
            A[off + BLOCK:, off + BLOCK:] -= L21 @ L21.T
    return L, inv


def cholesky_solve_plain(
    L: torch.Tensor, inv_blocks: torch.Tensor, b: torch.Tensor, n: int
) -> torch.Tensor:
    """The TPU kernel's block substitution in PyTorch (`_solve_kernel`,
    `cholesky_pallas.py:99-128`), on L's device."""
    n_pad = L.shape[0]
    nb = n_pad // BLOCK
    bp = torch.zeros(n_pad, dtype=torch.float32, device=L.device)
    bp[:n] = b.to(torch.float32)
    y = torch.zeros_like(bp)
    x = torch.zeros_like(bp)
    for k in range(nb):  # y_k = (b_k - sum_{j<k} y_j Lkj^T) Li^T
        off = k * BLOCK
        acc = bp[off:off + BLOCK].clone()
        for j in range(k):
            acc = acc - y[j * BLOCK:(j + 1) * BLOCK] @ L[off:off + BLOCK, j * BLOCK:(j + 1) * BLOCK].T
        y[off:off + BLOCK] = acc @ inv_blocks[off:off + BLOCK].T
    for k in range(nb - 1, -1, -1):  # x_k = (y_k - sum_{j>k} x_j Ljk) Li
        off = k * BLOCK
        acc = y[off:off + BLOCK].clone()
        for j in range(k + 1, nb):
            acc = acc - x[j * BLOCK:(j + 1) * BLOCK] @ L[j * BLOCK:(j + 1) * BLOCK, off:off + BLOCK]
        x[off:off + BLOCK] = acc @ inv_blocks[off:off + BLOCK]
    return x[:n]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import build_library

    lib = build_library(KERNEL_SOURCE, "cholesky_blocked")
    lib.cholesky_factor_grid.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.cholesky_factor_grid.restype = ctypes.c_int
    lib.cholesky_factor_f32.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cholesky_factor_f32.restype = ctypes.c_int
    lib.cholesky_solve_grid.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.cholesky_solve_grid.restype = ctypes.c_int
    lib.cholesky_solve_f32.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.cholesky_solve_f32.restype = ctypes.c_int
    return lib


def load_kernel() -> None:
    """Build (first use) and load K7; raises if the build fails."""
    _library()


def _check(name: str, t: torch.Tensor, device: torch.device, shape: tuple) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 tensor on {device}; got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _factor_grid(device_index: int, n_pad: int) -> int:
    """The factorization's cooperative grid on the card (the library checks
    that it is co-resident); raises if the eleven blocks it needs at least
    do not fit."""
    blocks, capacity = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().cholesky_factor_grid(n_pad, ctypes.byref(blocks), ctypes.byref(capacity))
    if err != 0:
        raise RuntimeError(f"cholesky_factor: no cooperative grid of 11 blocks fits on cuda:"
                           f"{device_index} ({capacity.value} co-resident): cudaError_t {err}")
    return blocks.value


@functools.lru_cache(maxsize=None)
def _solve_grid(device_index: int, n_pad: int) -> Tuple[int, int]:
    """(blocks, scratch floats) of the solve's cooperative launch on the
    card: a block a diagonal step and a tile off the chain, at most what is
    co-resident."""
    blocks, capacity, scratch = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        err = _library().cholesky_solve_grid(n_pad, ctypes.byref(blocks), ctypes.byref(capacity),
                                             ctypes.byref(scratch))
    if err != 0:
        raise RuntimeError(f"cholesky_solve: no cooperative grid fits on cuda:{device_index} "
                           f"({capacity.value} co-resident): cudaError_t {err}")
    return blocks.value, scratch.value


def cholesky_factor_cuda(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7's factorization on K's device and PyTorch's current
    stream; no sync.  Same output as `cholesky_factor_plain`."""
    if not K.is_cuda:
        raise ValueError(f"cholesky_factor_cuda needs a CUDA tensor; got one on {K.device}")
    n = K.shape[0]
    if K.dim() != 2 or K.shape[1] != n or n == 0:
        raise ValueError(f"cholesky_factor: K must be square; got {tuple(K.shape)}")
    K = K.to(torch.float32).contiguous()
    n_pad = _pad_to_block(n)
    # the kernel pads K into the scratch A and writes every entry of L
    A = torch.empty((n_pad, n_pad), dtype=torch.float32, device=K.device)
    L = torch.empty_like(A)
    inv = torch.empty((n_pad, BLOCK), dtype=torch.float32, device=K.device)
    flags = torch.empty(n_pad // BLOCK, dtype=torch.int32, device=K.device)
    for name, t, shape in (("A", A, (n_pad, n_pad)), ("L", L, (n_pad, n_pad)),
                           ("inv_blocks", inv, (n_pad, BLOCK))):
        _check(f"cholesky_factor: {name}", t, K.device, shape)
    blocks = _factor_grid(K.device.index, n_pad)
    stream = torch.cuda.current_stream(K.device).cuda_stream
    launched = ctypes.c_int(0)
    err = _library().cholesky_factor_f32(n, n_pad, K.data_ptr(), A.data_ptr(), L.data_ptr(),
                                         inv.data_ptr(), flags.data_ptr(), blocks, stream,
                                         ctypes.byref(launched))
    LAUNCHES["cholesky_factor"] += launched.value
    if err != 0:
        raise RuntimeError(f"cholesky_factor launch failed: cudaError_t {err}")
    LAUNCHES["cholesky_factorizations"] += 1
    return L, inv


def cholesky_solve_cuda(
    L: torch.Tensor, inv_blocks: torch.Tensor, b: torch.Tensor, n: int
) -> torch.Tensor:
    """Launch K7's solve on L's device and PyTorch's current stream; no
    sync.  Same output as `cholesky_solve_plain`."""
    if not L.is_cuda:
        raise ValueError(f"cholesky_solve_cuda needs a CUDA tensor; got one on {L.device}")
    n_pad = L.shape[0]
    if n_pad % BLOCK or not 0 < n <= n_pad:
        raise ValueError(f"cholesky_solve: n {n} with n_pad {n_pad} is not supported")
    b = b.to(torch.float32).contiguous()
    for name, t, shape in (("L", L, (n_pad, n_pad)), ("inv_blocks", inv_blocks, (n_pad, BLOCK)),
                           ("b", b, (n,))):
        _check(f"cholesky_solve: {name}", t, L.device, shape)
    blocks, scratch_floats = _solve_grid(L.device.index, n_pad)
    x = torch.empty(n, dtype=torch.float32, device=L.device)
    # y, x and the partial products, cleared inside the launch
    scratch = torch.empty(scratch_floats, dtype=torch.float32, device=L.device)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    err = _library().cholesky_solve_f32(
        n, n_pad, L.data_ptr(), inv_blocks.data_ptr(), b.data_ptr(), x.data_ptr(),
        scratch.data_ptr(), blocks, stream,
    )
    if err != 0:
        raise RuntimeError(f"cholesky_solve launch failed: cudaError_t {err}")
    LAUNCHES["cholesky_solve"] += 1
    return x


def cholesky_factor(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor an SPD matrix (f32): returns (L, inv_blocks).  K7 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if K.is_cuda:
        return cholesky_factor_cuda(K)
    if K.device.type != "cpu":
        raise ValueError(f"cholesky_factor: no route for device {K.device}")
    LAUNCHES["cholesky_factor_plain"] += 1
    return cholesky_factor_plain(K)


def cholesky_solve(
    L: torch.Tensor, inv_blocks: torch.Tensor, b: torch.Tensor, n: int
) -> torch.Tensor:
    """Solve K x = b from `cholesky_factor`'s output; returns (n,) f32.  K7
    on a CUDA tensor, the plain version on a CPU tensor."""
    if L.is_cuda:
        return cholesky_solve_cuda(L, inv_blocks, b, n)
    if L.device.type != "cpu":
        raise ValueError(f"cholesky_solve: no route for device {L.device}")
    LAUNCHES["cholesky_solve_plain"] += 1
    return cholesky_solve_plain(L, inv_blocks, b, n)
