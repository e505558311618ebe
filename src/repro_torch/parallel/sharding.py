"""Sharding rules: logical parameter axes -> mesh axes -> specs, and the
constraints that keep activations where the rules put them — the
counterpart of `repro.parallel.sharding`, on `torch.distributed.tensor`.

Production meshes (see `repro_torch.launch.mesh`):
    single-pod  (16, 16)        axes ("data", "model")
    multi-pod   (2, 16, 16)     axes ("pod", "data", "model")

A spec is what the reference's `PartitionSpec` holds, as a plain tuple:
one entry per tensor dimension, each None (replicated), a mesh-axis name
or a tuple of names (sharded over their product, the first the major).
`to_shardings` turns a spec into DTensor placements on a `DeviceMesh`
(one `Shard(dim)` or `Replicate()` per mesh dimension). The spec
functions read only the mesh's axis sizes, so they take a `DeviceMesh`
or any object whose ``shape`` is a dict of axis sizes.

Baseline strategy, as the reference's:
  * weights tensor-parallel on the "model" axis along dimensions that are
    divisible by its size: flattened head dims (H*hd, K*hd), d_ff, vocab
    (padded to 256), d_inner, expert count (when divisible, EP;
    otherwise TP on the expert FFN dim),
  * batch data-parallel over ("pod", "data"); the B=1 long-context shape
    shards the sequence over "data" instead,
  * decode KV caches shard kv-heads on "model" when divisible, else the
    sequence.

The constraints (`constrain_*`) redistribute a DTensor to the
reference's placements on the tensor's own mesh and pass a plain tensor
through untouched: the mesh is read off the tensor, never kept in
module state. `replicate_like` and `run_local` are what the model's mesh paths build
on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (TYPE_CHECKING, Any, Callable, Dict, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

if TYPE_CHECKING:
    from ..models.config import ArchConfig, ShapeConfig

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of a stand-in whose
    ``shape`` is already that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _divisible(n: int, shape: Dict[str, int], axis: str) -> bool:
    return axis in shape and n % shape[axis] == 0


def logical_rules(cfg: ArchConfig, mesh) -> Dict[str, Optional[str]]:
    """Map each logical axis name to a mesh axis (or None = replicate)."""
    shape = axis_sizes(mesh)
    rules: Dict[str, Optional[str]] = {
        "embed": None, "vocab": "model", "heads_flat": "model",
        "kv_flat": "model", "ffn": "model", "experts": None,
        "experts_router": None, "ssm_in": "model", "ssm_inner": "model",
        "ssm_conv": "model", "ssm_heads": None, "ssm_state": None,
        "head_dim": None, "layers": None, "groups": None,
        "layers_inner": None, "conv": None,
    }
    if cfg.uses_moe and _divisible(cfg.n_experts, shape, "model"):
        rules["experts"] = "model"      # expert parallelism
        rules["ffn"] = None
    return rules


FSDP_THRESHOLD_BYTES = 8 * 1024 ** 3     # params+opt per device before FSDP kicks in


def param_specs(cfg: ArchConfig, mesh):
    """Spec tree matching `model_defs(cfg)`.

    One dimension of every weight is tensor-parallel on "model" (per
    `logical_rules`). When params+optimizer state would exceed
    FSDP_THRESHOLD_BYTES per device, a second dimension is fully-sharded
    over "data" (ZeRO-3 style)."""
    from ..models.layers import count_params, tree_map_defs
    from ..models.model import model_defs
    shape = axis_sizes(mesh)
    rules = logical_rules(cfg, mesh)
    defs = model_defs(cfg)
    total_bytes = 12.0 * count_params(defs)
    fsdp = (total_bytes / shape["model"]) > FSDP_THRESHOLD_BYTES \
        and "data" in shape

    def spec(d) -> Spec:
        axes: list = []
        used = set()
        for dim, name in zip(d.shape, d.logical):
            ax = rules.get(name) if name else None
            if ax is not None and ax not in used and dim % shape[ax] == 0:
                axes.append(ax)
                used.add(ax)
            else:
                axes.append(None)
        if fsdp and "data" not in used and len(d.shape) >= 2:
            # biggest still-unsharded divisible dim -> "data"
            cand = [(dim, i) for i, (dim, ax) in enumerate(zip(d.shape, axes))
                    if ax is None and dim % shape["data"] == 0
                    and d.logical[i] not in ("layers", "groups", "layers_inner")]
            if cand:
                _, i = max(cand)
                axes[i] = "data"
        return tuple(axes)

    return tree_map_defs(spec, defs)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _dp(mesh) -> int:
    shape = axis_sizes(mesh)
    return int(np.prod([shape[a] for a in batch_axes(mesh)]))


def data_specs(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Specs for one training/prefill batch dict."""
    b_ax = batch_axes(mesh)
    if shape.global_batch % _dp(mesh) == 0:
        tok: Spec = (b_ax, None)
    else:
        # B=1 long-context: shard the sequence instead
        tok = (None, b_ax)
    if cfg.frontend in ("audio", "vlm"):
        return {"embeds": tok + (None,), "labels": tok, "mask": tok}
    return {"tokens": tok, "labels": tok, "mask": tok}


def decode_state_specs(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Specs mirroring `init_decode_state` (stacked leading layer/group
    dim); the cache length and the position are scalars, spec ``()``."""
    from ..models.model import DecodeState
    from ..models.ssm import SSMState
    from ..models.transformer import KVCache
    sizes = axis_sizes(mesh)
    b_ax = batch_axes(mesh)
    batch_sharded = shape.global_batch % _dp(mesh) == 0
    bspec = b_ax if batch_sharded else None
    sspec = None if batch_sharded else b_ax      # B=1: shard cache seq on data

    # KV cache [L, B, S, K, hd]: kv-heads on "model" when divisible, else
    # the SEQUENCE on "model" (flash-decode: each shard attends its slice
    # of the cache and the softmax statistics combine across shards)
    if cfg.n_kv_heads % sizes["model"] == 0:
        kv_head_ax: Optional[str] = "model"
        seq_axes = sspec
    else:
        kv_head_ax = None
        seq_axes = (("model",) if sspec is None
                    else tuple(sspec) + ("model",))

    kv_spec = (None, bspec, seq_axes, kv_head_ax, None)      # [L, B, S, K, hd]
    len_spec: Spec = ()
    ssm_h_ax = "model" if cfg.ssm_heads and cfg.ssm_heads % sizes["model"] == 0 \
        else None
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    conv_ax = "model" if conv_dim and conv_dim % sizes["model"] == 0 else None

    specs_kv = specs_ssm = None
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        specs_kv = KVCache(kv_spec, kv_spec, len_spec)
    elif cfg.family == "ssm":
        specs_ssm = SSMState(h=(None, bspec, ssm_h_ax, None, None),
                             conv=(None, bspec, None, conv_ax))
    elif cfg.family == "hybrid":
        specs_kv = KVCache(kv_spec, kv_spec, len_spec)
        specs_ssm = SSMState(h=(None, None, bspec, ssm_h_ax, None, None),
                             conv=(None, None, bspec, None, conv_ax))
    return DecodeState(kv=specs_kv, ssm=specs_ssm, pos=())


# ----------------- specs -> DTensor placements ----------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> Tuple:
    """One placement per mesh dimension: ``Shard(d)`` where tensor dim
    ``d``'s entry names that mesh axis, else ``Replicate()``. A dim
    sharded over several axes lists them in mesh order (the major
    first), which is the order DTensor splits a dim in. An axis of size
    1 splits nothing and is ``Replicate()`` (DTensor will not reshape a
    dim of size 1 that is marked sharded)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} "
                                 "twice")
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec placed on a mesh: the counterpart of JAX's `NamedSharding`."""

    mesh: Any
    spec: Spec
    placements: Tuple


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_specs(f: Callable[[Spec], Any], tree):
    """``f`` applied to every spec of a spec tree (nested dicts and
    NamedTuples whose leaves are spec tuples; a None subtree stays)."""
    if tree is None:
        return None
    if _is_spec(tree):
        return f(tree)
    if isinstance(tree, dict):
        return {k: map_specs(f, v) for k, v in tree.items()}
    return type(tree)(*(map_specs(f, v) for v in tree))


def to_shardings(tree_specs, mesh):
    return map_specs(lambda s: NamedSharding(mesh, s, placements(s, mesh)),
                     tree_specs)


def distribute(x, sharding: NamedSharding) -> DTensor:
    """A host or device value (tensor, numpy array, number) placed as
    ``sharding`` says, from the full value every rank holds: each rank
    keeps its own pieces, no collective moves them. The pieces are
    copies (a step that updates them in place leaves ``x`` as it was); a
    meta tensor stays on the meta device."""
    from torch.distributed.tensor import distribute_tensor
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.device.type != "meta":
        t = t.to(sharding.mesh.device_type, copy=True)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# ----------------- constraints --------------------------------------------------

SEQ_SHARD_ACTIVATIONS = False   # residual stream batch-sharded only; the
# switch shards its sequence over "model" too (not measured on this port)


def _redistribute(x: DTensor, spec: Spec) -> DTensor:
    target = placements(spec, x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def _batch_spec(x: DTensor) -> Tuple[Tuple[str, ...], int]:
    mesh = x.device_mesh
    b_ax = batch_axes(mesh)
    return b_ax, _dp(mesh)


def constrain_activations(x):
    """Residual-stream constraint [B, S, d]: batch on the data axes (and,
    if SEQ_SHARD_ACTIVATIONS, sequence on "model")."""
    if not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(x.device_mesh)
    b_ax, dp = _batch_spec(x)
    axes: list = [None] * x.ndim
    if b_ax and x.shape[0] % dp == 0:
        axes[0] = b_ax
    if (SEQ_SHARD_ACTIVATIONS and x.ndim >= 3 and "model" in sizes
            and x.shape[1] % sizes["model"] == 0 and x.shape[1] > 1):
        axes[1] = "model"
    return _redistribute(x, tuple(axes))


def constrain_batch_dim(tree, dim: int = 0):
    """Shard ``dim`` of every DTensor leaf of a dict (or the tensor
    itself) over the data axes of its mesh; no-op for plain tensors or
    when indivisible. Used after reshapes that would otherwise lose
    batch sharding (the microbatch split of gradient accumulation)."""
    if isinstance(tree, dict):
        return {k: constrain_batch_dim(v, dim) for k, v in tree.items()}
    x = tree
    if not isinstance(x, DTensor):
        return x
    b_ax, dp = _batch_spec(x)
    if not b_ax or x.ndim <= dim or x.shape[dim] % dp != 0:
        return x
    axes: list = [None] * x.ndim
    axes[dim] = b_ax
    return _redistribute(x, tuple(axes))


def decode_kv_spec(x) -> Spec:
    """The spec of one layer's KV cache [B, S, K, hd] on its mesh,
    mirroring `decode_state_specs`."""
    sizes = axis_sizes(x.device_mesh)
    b_ax, dp = _batch_spec(x)
    batch_sharded = bool(b_ax) and x.shape[0] % dp == 0
    bspec = b_ax if batch_sharded else None
    sspec = None if batch_sharded else (b_ax or None)
    if x.shape[2] % sizes["model"] == 0:
        kv_head_ax: Optional[str] = "model"
        seq_axes = sspec
    else:
        kv_head_ax = None
        seq_axes = ("model",) if sspec is None else tuple(sspec) + ("model",)
    return (bspec, seq_axes, kv_head_ax, None)


def replicated(x):
    """A DTensor redistributed whole onto every rank (a plain tensor as
    it is): before a reshape that splits a sharded dim unevenly, such as
    the microbatch split of gradient accumulation."""
    if not isinstance(x, DTensor):
        return x
    return _redistribute(x, (None,) * x.ndim)


def constrain_decode_kv(x):
    """KV-cache constraint [B, S, K, hd], mirroring `decode_state_specs`:
    kv-heads on "model" when divisible, else the sequence."""
    if (not isinstance(x, DTensor) or x.ndim != 4
            or "model" not in axis_sizes(x.device_mesh)):
        return x
    return _redistribute(x, decode_kv_spec(x))


def constrain_logits(x):
    """Keep the [B, S, V] logits vocab-sharded on the model axis (and
    batch on data axes) so the loss never gathers the full vocab."""
    if not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(x.device_mesh)
    axes: list = [None] * x.ndim
    if "model" in sizes and x.shape[-1] % sizes["model"] == 0:
        axes[-1] = "model"
    b_ax, dp = _batch_spec(x)
    if b_ax and x.shape[0] % dp == 0:
        axes[0] = b_ax
    return _redistribute(x, tuple(axes))


# ----------------- helpers of the model's mesh paths ----------------------------

def replicate_like(t: torch.Tensor, x):
    """``t`` (a plain tensor every rank computes alike: rotary tables, a
    zero pad) as a replicated DTensor on ``x``'s mesh when ``x`` is a
    DTensor; else ``t`` itself."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def batch_and(x: DTensor, dim_axes: Dict[int, Optional[str]]) -> Spec:
    """The spec that shards dim 0 of ``x`` over the data axes (when
    divisible) and each dim of ``dim_axes`` over its axis (None: that
    dim replicated)."""
    b_ax, dp = _batch_spec(x)
    axes: list = [None] * x.ndim
    if b_ax and x.shape[0] % dp == 0:
        axes[0] = b_ax
    for d, ax in dim_axes.items():
        axes[d] = ax
    return tuple(axes)


def model_axis_if(n: int, mesh) -> Optional[str]:
    """"model" when a dimension of size ``n`` splits evenly over it."""
    sizes = axis_sizes(mesh)
    return "model" if "model" in sizes and n % sizes["model"] == 0 else None


class ModelPartial(NamedTuple):
    """An output spec of `run_local` whose values are still to be
    reduced over the "model" axis by ``op`` (each rank holds a part)."""

    spec: Spec
    op: str = "sum"


def run_local(fn: Callable, mesh, in_specs: Sequence[Optional[Spec]],
              out_specs, *args):
    """``fn`` on each rank's local pieces: every DTensor argument is
    redistributed to its spec of ``in_specs`` (None: not a tensor) and
    handed over as its local shard; the outputs come back as DTensors
    with ``out_specs`` (a spec or a `ModelPartial`; a list of those for
    several outputs). Differentiable: ``fn``'s local backward gives each
    input's gradient, summed over the ranks that computed parts of it."""
    from torch.distributed.tensor.experimental import local_map

    def place(s):
        if s is None:
            return None
        if isinstance(s, ModelPartial):
            out = list(placements(s.spec, mesh))
            out[list(mesh.mesh_dim_names).index("model")] = Partial(s.op)
            return out
        return list(placements(s, mesh))   # a list: one output's placements

    many = isinstance(out_specs, list)
    outs = tuple(place(s) for s in out_specs) if many else place(out_specs)
    ins = [place(s) for s in in_specs]
    # along a mesh axis that splits some input, each rank computes a part
    # of the whole: the gradient of an input replicated along it is that
    # rank's part of a sum (Partial); along an axis that splits nothing
    # every rank computes the same, and so does its gradient
    split = {i for pl in ins if pl for i, q in enumerate(pl) if q.is_shard()}
    grads = tuple(None if pl is None else
                  [Partial() if i in split and not q.is_shard() else q
                   for i, q in enumerate(pl)] for pl in ins)
    return local_map(fn, outs, in_placements=tuple(ins),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def shard_heads(t, n_heads: int):
    """A [B, S, n_heads * hd] or [B, S, n_heads, hd] DTensor with the
    batch on the data axes and dim 2 on "model" when ``n_heads`` splits
    evenly over it (each shard whole heads), else replicated there: the
    placement a head split or a per-head computation needs. A plain
    tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    return _redistribute(t, batch_and(t, {2: model_axis_if(n_heads,
                                                           t.device_mesh)}))


def shard_offset(t: DTensor, dim: int) -> int:
    """Where this rank's shard of ``t`` starts along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(offset[dim])


def _vocab_local(logits: DTensor, labels) -> Tuple[Any, Spec, Spec, Optional[str]]:
    mesh = logits.device_mesh
    v_ax = model_axis_if(logits.shape[-1], mesh)
    labels = replicate_like(labels, logits)
    return (labels, batch_and(logits, {logits.ndim - 1: v_ax}),
            batch_and(labels, {}), v_ax)


def embed_lookup(table, tokens):
    """``table[tokens]`` (rows of a [V, d] table). On a DTensor table,
    sharded over the vocab, each model shard looks up the tokens that
    fall in its rows (zeros elsewhere) and the parts are summed over the
    model axis, as `label_logit` picks labels."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = replicate_like(tokens, table)
    v_ax = model_axis_if(table.shape[0], mesh)
    tok_spec = batch_and(tokens, {})
    out_spec = tok_spec + (None,)

    def local(tb, tk):
        if v_ax is None:
            return tb[tk]
        rows = tb.shape[0]
        rel = tk - mesh.get_local_rank("model") * rows
        inside = (rel >= 0) & (rel < rows)
        got = tb[rel.clamp(0, rows - 1)]
        return got * inside[..., None].to(got.dtype)

    return run_local(local, mesh, [(v_ax, None), tok_spec],
                     ModelPartial(out_spec) if v_ax else out_spec,
                     table, tokens)


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``. On a DTensor it is spelt out as a
    max and a sum of exponentials, each of which reduces across the
    shards of the last dim, so a vocab- or sequence-sharded operand is
    never gathered."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    top = x.amax(dim=-1, keepdim=True)
    return (torch.log(torch.exp(x - top).sum(dim=-1, keepdim=True))
            + top)[..., 0]


def softmax_last(x):
    """``torch.softmax(x, dim=-1)``, spelt out (max, exp, sum, divide) on
    a DTensor for the reason `logsumexp_last` gives."""
    if not isinstance(x, DTensor):
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def label_logit(logits, labels):
    """``logits[..., labels]`` ([B, S, V] and [B, S] -> [B, S]), in the
    logits' dtype. On DTensor logits each model shard picks the labels
    that fall in its slice of the vocab (0 elsewhere) and the parts are
    summed over the model axis: the full vocab is never gathered."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh = logits.device_mesh
    labels, spec, lab_spec, v_ax = _vocab_local(logits, labels)

    def local(lg, lb):
        if v_ax is None:
            return torch.gather(lg, -1, lb[..., None])[..., 0]
        width = lg.shape[-1]
        rel = lb - mesh.get_local_rank("model") * width
        inside = (rel >= 0) & (rel < width)
        picked = torch.gather(lg, -1, rel.clamp(0, width - 1)[..., None])[..., 0]
        return torch.where(inside, picked, torch.zeros_like(picked))

    out = ModelPartial(lab_spec) if v_ax else lab_spec
    return run_local(local, mesh, [spec, lab_spec], out, logits, labels)


def first_argmax(logits):
    """The first index of the largest logit ([B, S, V] -> [B, S]). On
    DTensor logits each model shard reports the first index of the
    largest value (reduced over the shards) in its slice (V where it
    has none) and the least over the model axis wins, as `argmax` picks
    the first of equal maxima."""
    if not isinstance(logits, DTensor):
        return logits.argmax(-1)
    mesh = logits.device_mesh
    top, spec, lab_spec, v_ax = _vocab_local(logits, logits.amax(dim=-1))
    vocab = logits.shape[-1]

    def local(lg, tp):
        if v_ax is None:
            return lg.argmax(-1)
        hit = lg == tp[..., None]
        first = hit.int().argmax(-1) + mesh.get_local_rank("model") * lg.shape[-1]
        return torch.where(hit.any(-1), first, torch.full_like(first, vocab))

    out = ModelPartial(lab_spec, "min") if v_ax else lab_spec
    return run_local(local, mesh, [spec, lab_spec], out, logits, top)
