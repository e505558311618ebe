"""Parameter registry + elementary layers, in PyTorch.

Counterpart of `repro.models.layers`. Every module exposes a
``*_defs(cfg) -> nested dict of ParamDef`` and an apply-style function
consuming the matching nested dict of tensors: parameters are plain
nested dicts, with layers stacked on a leading axis exactly as the
reference stacks them, so a parameter tree carries over key for key
(`models.interop`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..env import DeviceLike, resolve_device
from ..parallel.sharding import replicate_like

# the logical names of the axes that `model._stack_defs` puts in front of
# a block's ParamDefs (one slice per layer; per group and layer in the
# hybrid)
STACKED_AXES = ("layers", "layers_inner", "groups")
# axes that index a set of matrices, not an input width: the stacking
# axes and the experts of a MoE layer ([E, d, f] is E projections of d)
SET_AXES = STACKED_AXES + ("experts",)

@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"           # normal | zeros | ones | ssm_dt | ssm_alog
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map_defs(f: Callable[[ParamDef], Any], defs):
    """``f`` applied to every `ParamDef` of a nested dict, same nesting."""
    if is_def(defs):
        return f(defs)
    return {k: tree_map_defs(f, v) for k, v in defs.items()}


def def_leaves(defs) -> List[ParamDef]:
    """The `ParamDef` leaves in sorted-key order (the reference's
    flattening order)."""
    if is_def(defs):
        return [defs]
    return [leaf for k in sorted(defs) for leaf in def_leaves(defs[k])]


def fan_in(d: ParamDef) -> int:
    """The input width of a projection: its first axis that is not a
    stacking or experts axis (`SET_AXES`); a vector's own length. The
    reference takes the first axis whatever it is, so a stacked
    projection comes out with std 1/sqrt(n_layers) there (ROADMAP
    Queue C)."""
    k = 0
    while k < len(d.logical) - 1 and d.logical[k] in SET_AXES:
        k += 1
    own = d.shape[k:]
    return own[0] if len(own) > 1 else max(own[-1], 1)


def init_params(generator: torch.Generator, defs,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = "cuda"):
    """Random parameters for ``defs``, drawn from ``generator`` (which
    must live on ``device``) with the reference's distributions: normal
    times ``scale`` (default 1/sqrt(`fan_in`), where the port reads the
    input width past the stacking axes), zeros, ones, a log-uniform dt
    bias in [1e-3, 1e-1] and A in [1, 16] stored as log. The bits differ
    from the reference's (another generator). In a ``dtype`` other than
    f32, a normal leaf stacked over layers is drawn slice by slice along
    its stacking axis (other bits than one f32 draw of the whole leaf,
    the same distribution), so the peak is one slice of f32 beside the
    parameters."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, "
                         f"parameters are asked for on {dev}")
    f32 = torch.float32

    def one(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "ssm_dt":        # dt bias ~ log-uniform in [1e-3, 1e-1]
            u = torch.empty(d.shape, dtype=f32, device=dev).uniform_(
                math.log(1e-3), math.log(1e-1), generator=generator)
            return torch.exp(u).to(dtype)
        if d.init == "ssm_alog":      # A in [1, 16], stored as log
            u = torch.empty(d.shape, dtype=f32, device=dev).uniform_(
                1.0, 16.0, generator=generator)
            return torch.log(u).to(dtype)
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in(d))
        if dtype == f32 or d.logical[0] not in STACKED_AXES:
            w = torch.randn(d.shape, generator=generator, dtype=f32, device=dev)
            return w.mul_(scale).to(dtype)
        # a stacked leaf in a narrower dtype is drawn one slice at a time
        # into its final storage: no f32 copy of the whole leaf (25.8 GB
        # for 8 layers of mixtral-8x22b's wg) is ever held
        w = torch.empty(d.shape, dtype=dtype, device=dev)
        for i in range(d.shape[0]):
            w[i] = torch.randn(d.shape[1:], generator=generator, dtype=f32,
                               device=dev).mul_(scale)
        return w

    return tree_map_defs(one, defs)


def count_params(defs) -> int:
    return sum(int(np.prod(d.shape)) for d in def_leaves(defs))


# ----------------- elementary ops ----------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: [...]; returns (cos, sin) of shape [..., head_dim//2]."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [..., n_heads, head_dim]; cos/sin broadcastable [..., 1, head_dim//2].
    On a DTensor ``x`` the tables (plain tensors every rank computes
    alike) are replicated onto its mesh."""
    cos, sin = replicate_like(cos, x), replicate_like(sin, x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    g = x @ wg.to(x.dtype)
    u = x @ wu.to(x.dtype)
    return (F.silu(g) * u) @ wd.to(x.dtype)


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          state: Optional[torch.Tensor] = None):
    """Short causal depthwise conv (Mamba2). x: [B, S, C], w: [C, K].

    Returns (y, new_state) where state is the last K-1 inputs for decode.
    The K taps are summed as shifted slices in f32 and rounded once to
    x's dtype, as the reference's einsum over [B, S, K, C] windows does,
    without building the windows and without cuDNN (whose f32 conv runs
    in TF32 by default). On a DTensor ``x`` the zero pad is replicated
    onto its mesh."""
    B, S, C = x.shape
    K = w.shape[-1]
    if state is None:
        pad = replicate_like(torch.zeros((B, K - 1, C), dtype=x.dtype,
                                         device=x.device), x)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                             # [B, S+K-1, C]
    wf = w.float()
    acc = xp[:, 0:S].float() * wf[:, 0]
    for k in range(1, K):
        acc += xp[:, k:k + S].float() * wf[:, k]
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return F.silu(acc.to(x.dtype)), new_state
