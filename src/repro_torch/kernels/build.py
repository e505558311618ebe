"""Shared loader for the port's CUDA C++ kernels: `nvcc` into a shared
library with a plain C interface, bound with `ctypes`.

Sources live under each kernel's ``csrc/``; nothing is compiled at
import. The first call that needs a kernel builds its library into the
build directory (``build/repro_torch`` at the repository root unless
the caller names another) and later calls in the same process reuse the
loaded handle. The file name carries a digest of the source text and
the compiler flags, so an edited source is rebuilt rather than served
stale, and the library is written under a temporary name and renamed
into place so that two processes building at once never load a partial
file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from ..env import nvcc_path

# Hopper-only target: keep the "a" so later kernels may use wgmma
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_LIBS: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelCompileError(RuntimeError):
    """The CUDA compiler is missing or refused a source."""


def library_path(name: str, sources: Sequence[Path],
                 extra_flags: Sequence[str] = (),
                 build_dir: Optional[Path] = None) -> Path:
    """Where the library for these sources and flags is (or will be)."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    root = Path(build_dir) if build_dir is not None else DEFAULT_BUILD_DIR
    return root / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_library(name: str, sources: Sequence[Path],
                  extra_flags: Sequence[str] = (),
                  build_dir: Optional[Path] = None) -> Path:
    """Compile ``sources`` into one shared library (no-op when the
    library for this exact source text already exists). Returns its
    path; raises `KernelCompileError` when `nvcc` is missing or fails."""
    out = library_path(name, sources, extra_flags, build_dir)
    if out.exists():
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelCompileError(
            f"cannot build kernel library {name!r}: nvcc not found on PATH, "
            "under $CUDA_HOME or under /usr/local/cuda")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.so")
    cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           *[str(s) for s in sources]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelCompileError(
                f"nvcc failed for {name!r} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load_library(name: str, sources: Sequence[Path],
                 extra_flags: Sequence[str] = (),
                 build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Build (if needed) and `ctypes`-load a kernel library, once per
    process and path. Callers set ``argtypes``/``restype`` on the
    functions they use: without them `ctypes` passes a pointer as a
    32-bit int and cuts it."""
    with _LOCK:
        path = build_library(name, sources, extra_flags, build_dir)
        lib = _LIBS.get(path)
        if lib is None:
            lib = _LIBS[path] = ctypes.CDLL(str(path))
        return lib
