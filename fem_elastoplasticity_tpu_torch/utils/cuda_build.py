"""Build a CUDA source of the port into a shared library and load it.

Kernels have a plain C interface and are bound with `ctypes`: `nvcc` takes
seconds for such a file, where a source that includes PyTorch's headers takes
minutes, and this route needs no `ninja`.  The library is built at first
use into `.torch_ext_build/` beside the package (listed in `.gitignore`),
under a name that hashes the source and the flags, so an edited source or a
changed flag is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Sequence

BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of `nvcc`: CUDA_HOME as PyTorch resolves it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build kernels")
    return found


def build_library(
    source: pathlib.Path, name: str, extra_flags: Sequence[str] = ()
) -> ctypes.CDLL:
    """Compile `source` with nvcc for sm_90a (if not built yet) and load it.

    `extra_flags` follow NVCC_FLAGS on the command line (K2 passes
    `-fmad=false`) and enter the hash in the library's name.  Raises
    RuntimeError with the compiler's output when the build fails.  The
    ptxas report (registers, spills) is kept beside the library as
    `<library>.log`.
    """
    src = pathlib.Path(source)
    flags = (*NVCC_FLAGS, *extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
