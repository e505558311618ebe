"""Mixture-of-Experts layer: top-k routing with capacity-bounded scatter
dispatch, in PyTorch — the counterpart of `repro.models.moe`.

Dispatch builds an [E, C, d] buffer by scatter (no dense [T, E, C]
one-hots), runs all experts as one grouped product (three einsums, or
the hand-written kernel of `kernels.moe_gmm` with ``use_kernel=True``)
and combines with the routing weights. Tokens overflowing an expert's
capacity are dropped (they contribute zero), the standard Switch/GShard
behaviour. Without a device mesh the reference dispatches in one group
(``G = 1``); so does the port.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import ParamDef


def moe_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamDef((d, E), ("embed", "experts_router")),
        "wg": ParamDef((E, d, f), ("experts", "embed", "ffn")),
        "wu": ParamDef((E, d, f), ("experts", "embed", "ffn")),
        "wd": ParamDef((E, f, d), ("experts", "ffn", "embed")),
    }


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)     # pad to a multiple of 8 lanes


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ArchConfig):
    """x: [T, d] -> (top_idx [T, k] int64, top_w [T, k] in x's dtype,
    aux_loss). Among equal probabilities the lower expert index comes
    first, as `jax.lax.top_k` orders them (a stable descending sort;
    `torch.topk` promises no order among ties)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :cfg.top_k], top_idx[:, :cfg.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    # load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e
    E = cfg.n_experts
    f_e = F.one_hot(top_idx, E).float().sum(1).mean(0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e) / cfg.top_k
    return top_idx, top_w.to(x.dtype), aux


def expert_ffn_einsum(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                      wd: torch.Tensor) -> torch.Tensor:
    """The plain grouped product, three einsums in buf's dtype, as the
    reference's ``use_kernel=False`` branch: buf [G, E, C, d]."""
    dt = buf.dtype
    g = torch.einsum("gecd,edf->gecf", buf, wg.to(dt))
    u = torch.einsum("gecd,edf->gecf", buf, wu.to(dt))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, wd.to(dt))


def moe_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
              use_kernel: bool = False, counts=None) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]. One dispatch group (the reference's
    ``G = 1`` without a mesh). The scatter adds in place into a fresh
    buffer (`index_add_`), which autograd differentiates."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    top_idx, top_w, _aux = route(p["router"], xt, cfg)
    flat_e = top_idx.reshape(T * k)                     # (token, j) order

    # positions within each expert's capacity buffer, in the flattened
    # (token, j) order: which assignments overflow depends on it exactly
    onehot = F.one_hot(flat_e, E)                       # [T*k, E]
    pos_all = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_all, 1, flat_e[:, None])[:, 0]
    slot = torch.where(pos < C, flat_e * C + pos,
                       torch.full_like(flat_e, E * C))   # E*C: the dump row

    # scatter: every slot below E*C receives one token, so adding into
    # zeros is exact; dropped tokens pile up in the dump row, cut off
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        buf.index_add_(0, slot.view(T, k)[:, j], xt)
    buf = buf[:E * C].reshape(E, C, d)

    dt = x.dtype
    if use_kernel:
        from ..kernels.moe_gmm import ops as gmm_ops
        out = gmm_ops.expert_ffn(buf, p["wg"].to(dt), p["wu"].to(dt),
                                 p["wd"].to(dt), use_kernel=True,
                                 counts=counts)
    else:
        out = expert_ffn_einsum(buf[None], p["wg"], p["wu"], p["wd"])[0]

    # gather (the dump row reads zeros), weight, sum over the k choices
    flat = torch.cat([out.reshape(E * C, d),
                      torch.zeros((1, d), dtype=dt, device=x.device)])
    y = flat[slot] * top_w.reshape(T * k)[:, None]
    return y.reshape(B, S, k, d).sum(dim=2)
