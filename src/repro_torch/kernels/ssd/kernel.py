"""Build, bind and launch the CUDA SSD kernel.

The source is `csrc/ssd.cu` (see its head note for what it replaces and
how it is laid out). It is compiled by `nvcc` for ``sm_90a`` at first
use through `kernels.build` and bound with `ctypes`. Nothing here runs
at import, so hosts without a CUDA toolkit can import the module.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .. import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
# (N, P) template instantiations in the source: the reduced configs and
# the reference's test rows, zamba2-2.7b (64, 64) and mamba2-1.3b (128, 64)
SHAPES = ((4, 8), (8, 16), (16, 32), (32, 64), (64, 64), (128, 64))
MAX_CHUNK = 256
DTYPES = (torch.float32, torch.bfloat16)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises
    `build.KernelCompileError` when it cannot be built."""
    lib = build.load_library("ssd", [SOURCE])
    if getattr(lib.ssd_launch, "argtypes", None) is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_launch.argtypes = [p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, i, i, p]
        lib.ssd_launch.restype = ctypes.c_int
        lib.ssd_shape_supported.argtypes = [i, i]
        lib.ssd_shape_supported.restype = ctypes.c_int
        lib.ssd_workspace_bytes.argtypes = [i, i, i, i, i, i]
        lib.ssd_workspace_bytes.restype = ctypes.c_longlong
        lib.ssd_max_chunk.argtypes = []
        lib.ssd_max_chunk.restype = ctypes.c_int
        if lib.ssd_max_chunk() != MAX_CHUNK:
            raise RuntimeError("ssd library built for another MAX_CHUNK")
    return lib


def check_inputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int
                 ) -> Tuple[int, int, int, int, int, int]:
    """Validate the model-layout inputs: x [B, S, H, P] and b, c
    [B, S, N] of one float dtype, dt [B, S, H] and a [H] float32, one
    device, contiguous, S % min(chunk, S) == 0 (the reference's
    assertion). Returns (B, S, H, P, N, L)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t, dt_want in (("x", x, x.dtype), ("dt", dt, torch.float32),
                             ("a", a, torch.float32), ("b", b, x.dtype),
                             ("c", c, x.dtype)):
        if t.dtype != dt_want:
            raise TypeError(f"{name} must be {dt_want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if b.dim() != 3 or b.shape[:2] != (B, S) or c.shape != b.shape:
        raise ValueError(f"b, c must be [{B}, {S}, N], got {tuple(b.shape)} "
                         f"/ {tuple(c.shape)}")
    N = b.shape[2]
    if dt.shape != (B, S, H) or a.shape != (H,):
        raise ValueError(f"dt must be [{B}, {S}, {H}] and a [{H}], got "
                         f"{tuple(dt.shape)} / {tuple(a.shape)}")
    if min(B, S, H, P, N, chunk) < 1:
        raise ValueError("all sizes and chunk must be >= 1")
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"S={S} is not a multiple of the chunk length {L}")
    return B, S, H, P, N, L


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """The bf16 stages copy 16 bytes at a time: a view that does not
    start on a 16-byte boundary is copied once."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors in the model layout -> (y
    [B, S, H, P] in x's dtype, h_final [B, H, N, P] f32). One launch is
    three CUDA kernels (chunk_state, state_pass, chunk_scan; see the
    source's head note) on the current stream, through a workspace of
    the library's ``ssd_workspace_bytes`` (each chunk's cum and dt, the
    f32 state scratch [B, H, S / L, N, P], the chunk decays) that the
    caching allocator hands back when the call returns. Does not
    synchronise."""
    B, S, H, P, N, L = check_inputs(x, dt, a, b, c, chunk)
    if (N, P) not in SHAPES:
        raise ValueError(f"(ssm_state, head_dim) = {(N, P)} has no kernel "
                         f"instantiation; supported: {SHAPES}")
    if L > MAX_CHUNK:
        raise ValueError(f"chunk length {L} exceeds the kernel's {MAX_CHUNK}")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_cuda needs CUDA tensors, got {x.device}")
    lib = load()
    if x.dtype == torch.bfloat16:
        x, b, c = (_aligned16(t) for t in (x, b, c))
    nbytes = lib.ssd_workspace_bytes(B, S, H, P, N, L)
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_launch(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                             b.data_ptr(), c.data_ptr(), y.data_ptr(),
                             h.data_ptr(), ws.data_ptr(), B, S, H, P, N, L,
                             int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {err} "
                           f"(x {tuple(x.shape)}, N={N}, L={L}, {x.dtype})")
    return y, h
