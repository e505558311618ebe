"""Decoder-only transformer blocks: GQA attention (full causal or sliding
window), SwiGLU MLP or top-k MoE (`models.moe`), RMSNorm — in PyTorch,
the counterpart of `repro.models.transformer`.

`flash_mha` is the plain blocked online-softmax attention the model
takes with ``use_kernel=False``; with ``use_kernel=True`` prefill goes
through the hand-written CUDA kernel of `kernels.flash_attention`.
Decode (`decode_mha`) runs no kernel, as in the reference; the MoE
layer runs its expert kernel in prefill and in decode alike.

On DTensor activations (a device mesh, `repro_torch.parallel`) the
projections run as DTensor ops; each head split is preceded by a
placement whose model shards hold whole heads (`shard_heads`), prefill
attention runs on each rank's heads and batch rows (`run_local`), and
decode writes the new K/V into the rank's own shard of the cache and
constrains it as the reference does (`constrain_decode_kv`). A cache
whose kv heads split over "model" is attended per rank; one sharded on
the sequence (kv heads indivisible by the model axis) flash-decode
style, as DTensor ops: `decode_mha`'s max and sums reduce across the
shards.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..env import DeviceLike, resolve_device
from ..parallel.sharding import (batch_and, constrain_activations,
                                 constrain_decode_kv, decode_kv_spec,
                                 model_axis_if, placements, replicate_like,
                                 run_local, shard_heads, shard_offset,
                                 softmax_last)
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
    cache_len - 1). On a cache sharded along S the softmax is spelt out
    (`softmax_last`), so each step reduces across the shards
    (flash-decode) instead of gathering the scores.
    """
    B, _, H, hd = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qh = shard_heads(q, K).reshape(B, K, G, hd)
    # batched products over (b, k), spelt as matmuls: DTensor decomposes
    # these einsums through a copy of the cache broadcast over g
    s = torch.matmul(qh.to(f32), k_cache.to(f32).permute(0, 2, 3, 1)) * scale
    kpos = torch.arange(S, device=q.device)
    valid = kpos < cache_len
    if window > 0:
        valid &= kpos >= cache_len - window
    s = torch.where(replicate_like(valid[None, None, None], s), s,
                    torch.tensor(NEG_INF, dtype=f32, device=q.device))
    p = softmax_last(s)
    out = torch.matmul(p, v_cache.to(f32).permute(0, 2, 1, 3))
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


def _attend(q, k, v, cfg: ArchConfig, use_kernel: bool, counts):
    """Causal prefill attention: the kernel or the plain `flash_mha`."""
    if use_kernel:
        from ..kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=True, window=cfg.window,
                                      use_kernel=True, counts=counts)
    return flash_mha(q, k, v, window=cfg.window)


def _attend_on_mesh(q: DTensor, k: DTensor, v: DTensor, cfg: ArchConfig,
                    use_kernel: bool, counts) -> DTensor:
    """`_attend` on each rank's batch rows and heads. The q heads shard
    on "model" when they split evenly, the kv heads too when they do;
    else a rank holds every kv head and picks the one of each of its q
    heads (GQA with groups of one), so no rank attends a head twice."""
    mesh = q.device_mesh
    H, K = cfg.n_heads, cfg.n_kv_heads
    G = H // K
    q_ax = model_axis_if(H, mesh)
    q_spec = batch_and(q, {2: q_ax})
    kv_spec = batch_and(k, {2: model_axis_if(K, mesh) if q_ax else None})

    def local(ql, kl, vl):
        if kl.shape[2] == K and ql.shape[2] < H:
            h0 = mesh.get_local_rank("model") * ql.shape[2]
            idx = (h0 + torch.arange(ql.shape[2], device=ql.device)) // G
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        return _attend(ql, kl, vl, cfg, use_kernel, counts)

    return run_local(local, mesh, [q_spec, kv_spec, kv_spec], q_spec, q, k, v)


def _write_slot(cache_t: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache_t[:, slot] = new`` in place. On a DTensor cache (placed as
    `decode_state_specs` says) each rank writes its own shard: its kv
    heads of the new K/V, or, on a cache sharded along S, the slot if
    it falls in the rank's range."""
    if not isinstance(cache_t, DTensor):
        cache_t[:, slot:slot + 1] = new
        return
    spec = decode_kv_spec(cache_t)
    if tuple(cache_t.placements) != placements(spec, cache_t.device_mesh):
        raise ValueError(f"decode cache placed {cache_t.placements}, not as "
                         f"decode_state_specs says ({spec}): a write into a "
                         "redistributed copy would be lost")
    off = shard_offset(cache_t, 1)

    def local(c, n):
        s = slot - off
        if 0 <= s < c.shape[1]:
            c[:, s:s + 1] = n
        return c

    run_local(local, cache_t.device_mesh, [spec, (spec[0], None, spec[2], None)],
              spec, cache_t, new)


def _decode_on_mesh(q: DTensor, kc: DTensor, vc: DTensor,
                    n_valid: int) -> DTensor:
    """`decode_mha` on each rank's batch rows and kv heads, for a cache
    whose sequence is whole on every rank (kv heads split on "model", or
    not split): no shard holds a part of a softmax."""
    spec = decode_kv_spec(kc)
    q_spec = batch_and(q, {2: spec[2]})
    return run_local(lambda ql, kl, vl: decode_mha(ql, kl, vl, n_valid),
                     q.device_mesh, [q_spec, spec, spec], q_spec, q, kc, vc)


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
    q = shard_heads(_project(x, p["wq"], p.get("bq")), H).reshape(B, S, H, hd)
    k = shard_heads(_project(x, p["wk"], p.get("bk")), K).reshape(B, S, K, hd)
    v = shard_heads(_project(x, p["wv"], p.get("bv")), K).reshape(B, S, K, hd)

    if cache is None:
        pos = torch.arange(S, device=x.device)
        cos, sin = rope_tables(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos[None, :, None], sin[None, :, None])
        k = apply_rope(k, cos[None, :, None], sin[None, :, None])
        if isinstance(q, DTensor):
            out = _attend_on_mesh(q, k, v, cfg, use_kernel, counts)
        else:
            out = _attend(q, k, v, cfg, use_kernel, counts)
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
        _write_slot(cache.k, k.to(cache.k.dtype), slot)
        _write_slot(cache.v, v.to(cache.v.dtype), slot)
        kc, vc = constrain_decode_kv(cache.k), constrain_decode_kv(cache.v)
        new_len = cache.length + 1
        # ring buffer: every live slot is valid once length >= S_max
        n_valid = min(new_len, S_max) if cfg.window > 0 else new_len
        if isinstance(kc, DTensor) and decode_kv_spec(kc)[1] is None:
            out = _decode_on_mesh(q, kc, vc, n_valid)
        else:
            out = decode_mha(q, kc, vc, n_valid, window=0)
        new_cache = KVCache(kc, vc, new_len)

    out = out.reshape(B, S, H * hd)
    return out @ p["wo"].to(out.dtype), new_cache


def block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                cache: Optional[KVCache] = None, use_kernel: bool = False,
                counts=None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One attention + MLP (or MoE) block; ``counts`` (a
    `kernels.counts.KernelCounts`) receives the block's kernel launches.
    Under a mesh each sublayer's output, a sum over the model shards, is
    reduced (`constrain_activations`) before it joins the residual, so
    the residual stream stays whole and in its own dtype."""
    h, new_cache = attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                             cfg, cache=cache, use_kernel=use_kernel,
                             counts=counts)
    x = x + constrain_activations(h)
    y = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.uses_moe:
        y = moe_apply(p["moe"], y, cfg, use_kernel=use_kernel, counts=counts)
    else:
        y = swiglu(y, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
    return x + constrain_activations(y), new_cache
