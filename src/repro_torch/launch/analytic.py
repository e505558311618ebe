"""Analytic FLOP/byte model per (arch x shape) — the roofline's
compute and memory terms, and a counter of what a traced step does.

The closed-form counts are the reference's (`repro.launch.analytic`),
copied onto the port's `ArchConfig`/`ShapeConfig`, so each equals the
reference's to the bit. The dry run takes its compute and memory terms
from them; `OpCounter` stands where the reference read XLA's
`cost_analysis()`: FLOPs by `torch.utils.flop_counter`'s formulas (those
of `FlopCounterMode`) and bytes as the input and output bytes of every
aten op that is not a view, the counterpart of XLA's "bytes accessed"
(an op's operands read once, its result written once, no fusion). On
DTensors it counts each rank's local ops, so its numbers are per device;
the fake-tensor ops by which DTensor derives global shapes are not
counted.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..models.config import ArchConfig, ShapeConfig
from ..models.layers import count_params
from ..models.model import model_defs, padded_vocab


def _tensor_bytes(xs) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(xs)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """FLOPs and bytes accessed of the aten ops run under it. DTensor ops
    are let through first (``NotImplemented``), so what is counted is
    the local ops each rank runs."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0

    def count(self, func, args, kwargs, out) -> None:
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes_accessed += _tensor_bytes((args, kwargs)) \
                + _tensor_bytes(out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor derives each output's global shape by running the op on
        # fake tensors; those ops are bookkeeping, not work of a rank
        if not any(isinstance(t, FakeTensor) for t in tree_leaves(out)):
            self.count(func, args, kwargs, out)
        return out


def cost_analysis_dict(fn, *args, **kwargs) -> Dict[str, float]:
    """``{"flops", "bytes accessed"}`` of one call ``fn(*args, **kwargs)``,
    the keys of XLA's cost analysis the reference reads."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return {"flops": float(c.flops), "bytes accessed": float(c.bytes_accessed)}


def _attn_flops(arch: ArchConfig, B: int, Sq: int, Skv: int, *,
                causal: bool) -> float:
    H, K, hd, d = arch.n_heads, arch.n_kv_heads, arch.head_dim, arch.d_model
    if H == 0:
        return 0.0
    proj = 2.0 * B * Sq * d * (H * hd) + 2 * (2.0 * B * Sq * d * (K * hd))
    o = 2.0 * B * Sq * (H * hd) * d
    eff_kv = min(Skv, arch.window) if arch.window else Skv
    pairs = B * Sq * eff_kv * (0.5 if (causal and Sq == Skv and not arch.window) else 1.0)
    core = 2.0 * pairs * H * hd * 2          # QK^T and PV
    return proj + o + core


def _ffn_flops(arch: ArchConfig, B: int, S: int) -> float:
    d = arch.d_model
    if arch.uses_moe:
        router = 2.0 * B * S * d * arch.n_experts
        # top_k experts per token, capacity_factor head-room is zero-padded
        # compute in the static dispatch — count it (it burns real MXU time)
        tokens = B * S * arch.top_k * arch.capacity_factor
        return router + 3 * 2.0 * tokens * d * arch.d_ff
    return 3 * 2.0 * B * S * d * arch.d_ff


def _ssd_flops(arch: ArchConfig, B: int, S: int) -> float:
    d, di, N, H = arch.d_model, arch.d_inner, arch.ssm_state, arch.ssm_heads
    L = min(arch.ssm_chunk, S)
    proj = 2.0 * B * S * d * (2 * di + 2 * N + H) + 2.0 * B * S * di * d
    conv = 2.0 * B * S * (di + 2 * N) * 4
    scores = 2.0 * B * S * L * N              # C.B^T per chunk
    intra = 2.0 * B * S * L * di              # w @ (dt x)
    states = 2 * 2.0 * B * S * N * di         # chunk states + y_inter
    return proj + conv + scores + intra + states


def _ssd_decode_flops(arch: ArchConfig, B: int) -> float:
    d, di, N, H = arch.d_model, arch.d_inner, arch.ssm_state, arch.ssm_heads
    proj = 2.0 * B * d * (2 * di + 2 * N + H) + 2.0 * B * di * d
    state = 2 * 2.0 * B * di * N              # state update + readout
    return proj + state


def _attn_decode_flops(arch: ArchConfig, B: int, Skv: int) -> float:
    H, K, hd, d = arch.n_heads, arch.n_kv_heads, arch.head_dim, arch.d_model
    if H == 0:
        return 0.0
    eff = min(Skv, arch.window) if arch.window else Skv
    proj = 2.0 * B * d * (H + 2 * K) * hd + 2.0 * B * (H * hd) * d
    core = 2 * 2.0 * B * eff * H * hd
    return proj + core


def forward_flops(arch: ArchConfig, B: int, S: int, *, decode: bool = False,
                  ctx: int = 0) -> float:
    """One forward pass, all layers + head. decode: S==1 vs a ctx cache."""
    head = 2.0 * B * (1 if decode else S) * arch.d_model * padded_vocab(arch.vocab)
    total = head
    if arch.family in ("dense", "moe", "audio", "vlm"):
        per = (_attn_decode_flops(arch, B, ctx) if decode
               else _attn_flops(arch, B, S, S, causal=True))
        per += (_ffn_flops(arch, B, 1) if decode else _ffn_flops(arch, B, S))
        total += arch.n_layers * per
    elif arch.family == "ssm":
        per = (_ssd_decode_flops(arch, B) if decode
               else _ssd_flops(arch, B, S))
        total += arch.n_layers * per
    elif arch.family == "hybrid":
        per = (_ssd_decode_flops(arch, B) if decode
               else _ssd_flops(arch, B, S))
        total += arch.n_layers * per
        n_groups = arch.n_layers // arch.shared_attn_every
        shared = (_attn_decode_flops(arch, B, ctx) if decode
                  else _attn_flops(arch, B, S, S, causal=True))
        shared += (_ffn_flops(arch, B, 1) if decode else _ffn_flops(arch, B, S))
        total += n_groups * shared
    return total


def cell_flops(arch: ArchConfig, shape: ShapeConfig, *, remat: bool = True) -> float:
    """Total HLO-grade flops for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fwd = forward_flops(arch, B, S)
        n = count_params(model_defs(arch))
        opt = 10.0 * n                       # AdamW update
        mult = 4.0 if remat else 3.0         # fwd + 2x bwd (+1 remat fwd)
        return mult * fwd + opt
    if shape.kind == "prefill":
        return forward_flops(arch, B, S)
    return forward_flops(arch, B, 1, decode=True, ctx=S)


def cell_bytes(arch: ArchConfig, shape: ShapeConfig) -> float:
    """HBM traffic (global, all chips) for one step — napkin model:
    weights + optimizer state + activations (+ KV cache for decode)."""
    n = count_params(model_defs(arch))
    B, S = shape.global_batch, shape.seq_len
    d = arch.d_model
    act_bytes = 2.0  # bf16
    if shape.kind == "train":
        # params f32 read (fwd+bwd+remat ~ 3x), grads + adam m/v read+write
        w = n * 4.0 * (3 + 1 + 4)
        acts = 3.0 * B * S * d * arch.n_layers * act_bytes * 4  # remat'd residuals
        return w + acts
    if shape.kind == "prefill":
        return n * 2.0 + 8.0 * B * S * d * arch.n_layers * act_bytes
    # decode: weights (active) + cache read/write
    n_active = n
    if arch.uses_moe:
        n_active = n - arch.n_layers * (arch.n_experts - arch.top_k) * 3 * d * arch.d_ff
        n_active += arch.n_layers * min(B * arch.top_k, arch.n_experts) * 3 * d * arch.d_ff
        n_active = min(n_active, n)
    cache = 0.0
    if arch.uses_attention:
        eff = min(S, arch.window) if arch.window else S
        n_attn = (arch.n_layers if arch.family in ("dense", "moe", "audio", "vlm")
                  else arch.n_layers // arch.shared_attn_every)
        cache = n_attn * B * eff * arch.n_kv_heads * arch.head_dim * 2 * act_bytes
    if arch.ssm_state:
        P = arch.d_inner // arch.ssm_heads
        cache += 2 * arch.n_layers * B * arch.ssm_heads * arch.ssm_state * P * 4.0
    return n_active * 2.0 + cache


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> float:
    """The 6·N·D (train) / 2·N_active·D (inference) reference."""
    n = count_params(model_defs(arch))
    if arch.uses_moe:
        n = n - arch.n_layers * (arch.n_experts - arch.top_k) * 3 \
            * arch.d_model * arch.d_ff
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens
