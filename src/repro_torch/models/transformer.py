"""Decoder-only transformer blocks: GQA attention (full causal or sliding
window), SwiGLU MLP or top-k MoE (`models.moe`), RMSNorm — in PyTorch,
the counterpart of `repro.models.transformer`.

`flash_mha` is the plain blocked online-softmax attention the model
takes with ``use_kernel=False``; with ``use_kernel=True`` prefill goes
through the hand-written CUDA kernel of `kernels.flash_attention`.
Decode (`decode_mha`) runs no kernel, as in the reference; the MoE
layer runs its expert kernel in prefill and in decode alike.

The reference's `repro.parallel.sharding.constrain_*` calls are no-ops
without a device mesh and are left out here (sharding is ROADMAP Queue A
item 12).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..env import DeviceLike, resolve_device
from .config import ArchConfig
from .layers import ParamDef, apply_rope, rms_norm, rope_tables, swiglu
from .moe import moe_apply, moe_defs

NEG_INF = -1e30


def attn_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, H * hd), ("embed", "heads_flat")),
        "wk": ParamDef((d, K * hd), ("embed", "kv_flat")),
        "wv": ParamDef((d, K * hd), ("embed", "kv_flat")),
        "wo": ParamDef((H * hd, d), ("heads_flat", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), ("heads_flat",), init="zeros")
        defs["bk"] = ParamDef((K * hd,), ("kv_flat",), init="zeros")
        defs["bv"] = ParamDef((K * hd,), ("kv_flat",), init="zeros")
    return defs


def mlp_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": ParamDef((d, f), ("embed", "ffn")),
        "wu": ParamDef((d, f), ("embed", "ffn")),
        "wd": ParamDef((f, d), ("ffn", "embed")),
    }


def block_defs(cfg: ArchConfig) -> Dict:
    defs = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_defs(cfg),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.uses_moe:
        defs["moe"] = moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(cfg)
    return defs


# ----------------- attention ------------------------------------------------------

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """[Sq, Sk] True where q may attend k (causal, optional sliding window)."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_offset: int = 0, window: int = 0,
              q_block: int = 512, kv_block: int = 512) -> torch.Tensor:
    """Blocked online-softmax attention (the plain "flash" path).

    q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] with H == G*K (GQA).
    Causal with optional sliding window; q positions are offset by
    ``q_offset`` relative to k positions. Peak memory
    O(q_block * kv_block) per (batch, head).
    """
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    q = q.reshape(B, Sq, K, G, hd)

    qb = min(q_block, Sq)
    kb = min(kv_block, Sk)
    if Sq % qb or Sk % kb:
        raise ValueError(f"flash_mha needs Sq % q_block == 0 and "
                         f"Sk % kv_block == 0, got {(Sq, qb, Sk, kb)}")
    n_qb, n_kb = Sq // qb, Sk // kb
    f32 = torch.float32
    q_poss = q_offset + torch.arange(Sq, device=q.device)

    outs = []
    for qi in range(n_qb):
        qblk = q[:, qi * qb:(qi + 1) * qb].to(f32)
        qpos = q_poss[qi * qb:(qi + 1) * qb]
        m_run = torch.full((B, K, G, qb), NEG_INF, dtype=f32, device=q.device)
        l_run = torch.zeros((B, K, G, qb), dtype=f32, device=q.device)
        acc = torch.zeros((B, K, G, qb, hd), dtype=f32, device=q.device)
        for ki in range(n_kb):
            kblk = k[:, ki * kb:(ki + 1) * kb].to(f32)
            vblk = v[:, ki * kb:(ki + 1) * kb].to(f32)
            kpos = ki * kb + torch.arange(kb, device=q.device)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk) * scale
            mask = _mask(qpos, kpos, window)                       # [qb, kb]
            s = torch.where(mask[None, None, None], s,
                            torch.tensor(NEG_INF, dtype=f32, device=q.device))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh",
                                                       p, vblk)
            m_run = m_new
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    out = torch.cat(outs, dim=3)                                    # [B,K,G,Sq,hd]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(v.dtype)


def decode_mha(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               cache_len: int, *, window: int = 0) -> torch.Tensor:
    """Single-step attention against a cache.

    q: [B, 1, H, hd]; caches: [B, S_max, K, hd]; cache_len: current
    length (the new token's K/V must already be written at
    cache_len - 1).
    """
    B, _, H, hd = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qh = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh.to(f32), k_cache.to(f32)) * scale
    kpos = torch.arange(S, device=q.device)
    valid = kpos < cache_len
    if window > 0:
        valid &= kpos >= cache_len - window
    s = torch.where(valid[None, None, None], s,
                    torch.tensor(NEG_INF, dtype=f32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(f32))
    return out.reshape(B, 1, H, hd).to(v_cache.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, S_max, K, hd]
    v: torch.Tensor
    length: int           # tokens already written


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = "cuda") -> KVCache:
    dev = resolve_device(device)
    if cfg.window:
        max_len = min(max_len, cfg.window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev), 0)


def _project(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def attention(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
              cache: Optional[KVCache] = None,
              use_kernel: bool = False, counts=None
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full attention sub-layer. Prefill when cache is None; decode (x is
    [B, 1, d]) writes the new K/V into the cache IN PLACE (the port keeps
    one cache buffer instead of the reference's functional copy) and
    returns it with the length advanced."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _project(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = _project(x, p["wk"], p.get("bk")).reshape(B, S, K, hd)
    v = _project(x, p["wv"], p.get("bv")).reshape(B, S, K, hd)

    if cache is None:
        pos = torch.arange(S, device=x.device)
        cos, sin = rope_tables(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos[None, :, None], sin[None, :, None])
        k = apply_rope(k, cos[None, :, None], sin[None, :, None])
        if use_kernel:
            from ..kernels.flash_attention import ops as fa_ops
            out = fa_ops.flash_attention(q, k, v, causal=True,
                                         window=cfg.window, use_kernel=True,
                                         counts=counts)
        else:
            out = flash_mha(q, k, v, window=cfg.window)
        new_cache = None
    else:
        # decode step: S == 1, rotary at absolute position cache.length
        pos = torch.tensor([cache.length], device=x.device)
        cos, sin = rope_tables(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos[None, :, None], sin[None, :, None])
        k = apply_rope(k, cos[None, :, None], sin[None, :, None])
        S_max = cache.k.shape[1]
        # sliding-window caches wrap around (ring buffer); full caches are
        # sized by the caller so that length < S_max
        slot = cache.length % S_max if cfg.window > 0 \
            else min(cache.length, S_max - 1)
        cache.k[:, slot:slot + 1] = k.to(cache.k.dtype)
        cache.v[:, slot:slot + 1] = v.to(cache.v.dtype)
        new_len = cache.length + 1
        if cfg.window > 0:
            # ring buffer: every live slot is valid once length >= S_max
            out = decode_mha(q, cache.k, cache.v, min(new_len, S_max), window=0)
        else:
            out = decode_mha(q, cache.k, cache.v, new_len, window=0)
        new_cache = KVCache(cache.k, cache.v, new_len)

    out = out.reshape(B, S, H * hd)
    return out @ p["wo"].to(out.dtype), new_cache


def block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                cache: Optional[KVCache] = None, use_kernel: bool = False,
                counts=None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One attention + MLP (or MoE) block; ``counts`` (a
    `kernels.counts.KernelCounts`) receives the block's kernel launches."""
    h, new_cache = attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                             cfg, cache=cache, use_kernel=use_kernel,
                             counts=counts)
    x = x + h
    y = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.uses_moe:
        x = x + moe_apply(p["moe"], y, cfg, use_kernel=use_kernel,
                          counts=counts)
    else:
        x = x + swiglu(y, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
    return x, new_cache
