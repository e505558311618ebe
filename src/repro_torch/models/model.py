"""Full language-model assembly, in PyTorch — the counterpart of
`repro.models.model` for the serving path.

Families
--------
dense / audio / vlm : embed -> loop(attention+MLP blocks) -> norm -> head
moe                 : same, MLP replaced by top-k MoE (`models.moe`)
ssm                 : embed -> loop(Mamba2 SSD blocks) -> norm -> head
hybrid (zamba2)     : groups of Mamba2 blocks with ONE shared attention+MLP
                      block applied after each group (shared weights, as in
                      Zamba2's shared transformer block)

`audio`/`vlm` backbones consume precomputed frame/patch embeddings
([B, S, d_model]) through the frontend stub.

Parameters are nested dicts of tensors with layers stacked on a leading
axis, as in the reference; the reference's `lax.scan` over layers is a
Python loop over that axis here (each stacked leaf is split once with
`torch.unbind`, whose backward stacks the per-layer gradients in one
step), so the reference's ``unroll`` switch has nothing to select and is
left out. ``remat=True`` wraps each layer body (each group body for the
hybrid, as the reference checkpoints ``group_body``) in
`torch.utils.checkpoint.checkpoint` with ``use_reentrant=False``, the
counterpart of `jax.checkpoint`. The reference's
`repro.parallel.sharding.constrain_*` calls and `_constrain_logits` are
sharding constraints that do nothing without a device mesh and are left
out (ROADMAP Queue A item 12).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..env import DeviceLike, resolve_device
from .config import ArchConfig
from .layers import ParamDef, count_params, init_params, rms_norm, tree_map_defs
from .ssm import SSMState, init_ssm_state, ssm_block_apply, ssm_block_defs
from .transformer import KVCache, block_apply, block_defs, init_kv_cache

VOCAB_PAD = 256
ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def _stack_defs(defs, n: int, axis_name: str = "layers"):
    return tree_map_defs(
        lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.logical,
                           init=d.init, scale=d.scale), defs)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ATTN_FAMILIES + ("ssm", "hybrid"):
        raise ValueError(cfg.family)


def model_defs(cfg: ArchConfig) -> Dict:
    _check_family(cfg)
    vp = padded_vocab(cfg.vocab)
    defs: Dict[str, Any] = {
        "embed": ParamDef((vp, cfg.d_model), ("vocab", "embed"), scale=1.0),
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, vp), ("embed", "vocab"))
    if cfg.family in ATTN_FAMILIES:
        defs["blocks"] = _stack_defs(block_defs(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        defs["blocks"] = _stack_defs(ssm_block_defs(cfg), cfg.n_layers)
    else:                                   # hybrid
        every = cfg.shared_attn_every
        if not every or cfg.n_layers % every:
            raise ValueError("hybrid needs n_layers % shared_attn_every == 0")
        groups = cfg.n_layers // every
        defs["blocks"] = _stack_defs(
            _stack_defs(ssm_block_defs(cfg), every, "layers_inner"),
            groups, "groups")
        defs["shared"] = block_defs(cfg)     # ONE shared attention block
    return defs


def init(generator: torch.Generator, cfg: ArchConfig,
         dtype: Optional[torch.dtype] = None, device: DeviceLike = "cuda"):
    """Random parameters for ``cfg`` from ``generator`` (on ``device``),
    in ``dtype`` (default: the config's ``param_dtype``). Asked for in
    bf16, stacked leaves are drawn without a whole f32 copy
    (`layers.init_params`), as a full-width MoE layer needs."""
    return init_params(generator, model_defs(cfg),
                       dtype or getattr(torch, cfg.param_dtype), device)


def n_params(cfg: ArchConfig) -> int:
    return count_params(model_defs(cfg))


def cast_params(params, cfg: ArchConfig):
    """>=2-D float parameters in the compute dtype, 1-D ones (norms, SSM
    dt/A/D vectors) as they are (f32), as the reference's `_cast_params`
    does at every step entry. `forward` and `decode_step` call it too;
    a tensor already in the compute dtype is passed through uncopied, so
    a caller that casts once up front (as the serving loop should) pays
    nothing per step."""
    dt = getattr(torch, cfg.dtype)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if x.dim() >= 2 and x.is_floating_point():
            return x.to(dt)
        return x

    return one(params)


# ----------------- caches (decode) ------------------------------------------------

class DecodeState(NamedTuple):
    """Stacked per-layer decode caches (family-dependent contents).
    `decode_step` writes the new K/V and SSM states into these tensors
    in place and returns a state that shares them."""

    kv: Optional[KVCache]          # [n_layers or n_groups, ...] or None
    ssm: Optional[SSMState]        # [n_layers, ...] (hybrid: [groups, every, ...])
    pos: int                       # tokens already in context


def _stacked(n, tensors):
    return [t.unsqueeze(0).repeat((n,) + (1,) * t.dim()) for t in tensors]


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = "cuda") -> DecodeState:
    _check_family(cfg)
    dev = resolve_device(device)
    kv = ssm = None
    if cfg.family in ATTN_FAMILIES:
        c = init_kv_cache(cfg, batch, max_len, dtype, dev)
        kv = KVCache(*_stacked(cfg.n_layers, (c.k, c.v)), 0)
    elif cfg.family == "ssm":
        s = init_ssm_state(cfg, batch, device=dev)
        ssm = SSMState(*_stacked(cfg.n_layers, s))
    else:                                   # hybrid
        groups = cfg.n_layers // cfg.shared_attn_every
        c = init_kv_cache(cfg, batch, max_len, dtype, dev)
        kv = KVCache(*_stacked(groups, (c.k, c.v)), 0)
        s = init_ssm_state(cfg, batch, device=dev)
        ssm = SSMState(*_stacked(groups, _stacked(cfg.shared_attn_every, s)))
    return DecodeState(kv=kv, ssm=ssm, pos=0)


# ----------------- forward --------------------------------------------------------

def _embed(params, tokens_or_embeds: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend in ("audio", "vlm"):
        # frontend stub: precomputed frame/patch embeddings, already [B,S,d]
        return tokens_or_embeds.to(dt)
    return params["embed"].to(dt)[tokens_or_embeds]


def _head(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = params.get("head")
    if w is None:
        w = params["embed"].T
    return x @ w.to(x.dtype)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> List:
    """A tree stacked on a leading axis of length ``n`` as ``n`` trees of
    views (`torch.unbind` per leaf)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def forward(params, tokens_or_embeds: torch.Tensor, cfg: ArchConfig, *,
            use_kernel: bool = False, remat: bool = True,
            counts=None) -> torch.Tensor:
    """Train/prefill forward -> logits [B, S, vocab_padded]. With
    ``use_kernel=True`` every attention block runs the flash-attention
    kernel, every Mamba2 block the SSD kernel and every MoE block the
    grouped expert-FFN kernel (on CUDA tensors; on CPU tensors their
    plain versions); the kernels have no backward pass, so a forward
    that is to be differentiated takes ``use_kernel=False``. ``counts``
    (a `kernels.counts.KernelCounts`) receives the kernel launches.
    ``remat`` recomputes each layer (hybrid: each group) in the backward
    pass instead of keeping its activations."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    x = _embed(params, tokens_or_embeds, cfg)
    kw = dict(use_kernel=use_kernel, counts=counts)

    def attn_body(y, p_layer):
        return block_apply(p_layer, y, cfg, **kw)[0]

    def ssm_body(y, p_layer):
        return ssm_block_apply(p_layer, y, cfg, **kw)[0]

    def group_body(y, p_group):
        for p_layer in _unstack(p_group, cfg.shared_attn_every):
            y = ssm_body(y, p_layer)
        return attn_body(y, params["shared"])

    if cfg.family in ATTN_FAMILIES:
        body, n = attn_body, cfg.n_layers
    elif cfg.family == "ssm":
        body, n = ssm_body, cfg.n_layers
    else:                                   # hybrid
        body, n = group_body, cfg.n_layers // cfg.shared_attn_every
    for p_layer in _unstack(params["blocks"], n):
        if remat:
            x = checkpoint(body, x, p_layer, use_reentrant=False)
        else:
            x = body(x, p_layer)

    return _head(params, x, cfg)


def _ssm_step(p_layer, x, cfg, h, conv, use_kernel, counts):
    """One Mamba2 block in decode; its state tensors are updated in place."""
    x, new = ssm_block_apply(p_layer, x, cfg, state=SSMState(h, conv),
                             use_kernel=use_kernel, counts=counts)
    h.copy_(new.h)
    conv.copy_(new.conv)
    return x


def decode_step(params, state: DecodeState, tokens: torch.Tensor,
                cfg: ArchConfig, *, use_kernel: bool = False, counts=None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One serve step: tokens [B] (or embeds [B, d] for stub frontends)
    -> (logits [B, vocab_padded], new state). The caches of ``state`` are
    updated in place (so decode is never differentiated); the returned
    state shares them. ``counts`` receives the kernel launches."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    tok = tokens[:, None] if tokens.dim() == 1 else tokens[:, None, :]
    x = _embed(params, tok, cfg)

    kv, ssm = state.kv, state.ssm
    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            x, _ = block_apply(_layer(params["blocks"], i), x, cfg,
                               cache=KVCache(kv.k[i], kv.v[i], kv.length),
                               use_kernel=use_kernel, counts=counts)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_step(_layer(params["blocks"], i), x, cfg, ssm.h[i],
                          ssm.conv[i], use_kernel, counts)
    else:                                   # hybrid
        shared = params["shared"]
        for g in range(cfg.n_layers // cfg.shared_attn_every):
            p_group = _layer(params["blocks"], g)
            for j in range(cfg.shared_attn_every):
                x = _ssm_step(_layer(p_group, j), x, cfg, ssm.h[g, j],
                              ssm.conv[g, j], use_kernel, counts)
            x, _ = block_apply(shared, x, cfg,
                               cache=KVCache(kv.k[g], kv.v[g], kv.length),
                               use_kernel=use_kernel, counts=counts)

    new_kv = None if kv is None else KVCache(kv.k, kv.v, kv.length + 1)
    logits = _head(params, x, cfg)[:, 0]
    return logits, DecodeState(kv=new_kv, ssm=ssm, pos=state.pos + 1)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            use_kernel: bool = False, remat: bool = True, counts=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy. batch: {tokens|embeds, labels, [mask]}.

    ``logsumexp`` runs over the f32 logits; the label logit is a
    `gather` of the logits in their own dtype, the value the reference's
    one-hot contraction gives, without building a [B, S, Vp] one-hot.
    The loss and the accuracy (the first index among equal logits) are
    masked by ``mask``. Returns (loss, {"loss", "accuracy", "tokens"}),
    all 0-d tensors."""
    inp = batch.get("tokens", batch.get("embeds"))
    logits = forward(params, inp, cfg, use_kernel=use_kernel, remat=remat,
                     counts=counts)                 # [B, S, Vp]
    labels = batch["labels"].long()
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0].float()
    ll = label_logit - lse
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = -(ll * mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc,
                  "tokens": mask.sum()}
