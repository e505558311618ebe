"""Multi-pod dry run: trace every (architecture x input-shape x mesh) cell
on the production meshes over a fake process group and extract the
roofline terms — the counterpart of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.json

One process stands in for all 256 (512) ranks: the mesh is built over
torch's in-process fake process group, whose collectives move nothing,
and every tensor is a DTensor whose local shard lives on the meta
device (shapes, no data). Tracing one step as rank 0 (`lower_cell`)
shows that the sharding is coherent (every op finds a placement) and
gives, per device, the collectives DTensor issues, the FLOPs and bytes
of the local ops, and the peak of the temporaries. The per-device
memory is the state's exact local bytes at full depth plus the peak
temporaries extrapolated from a 2- and a 4-layer trace (hybrid: 1 and 2
groups), as the reference extrapolates its per-layer HLO costs; the
compute and memory roofline terms are the closed-form counts of
`launch.analytic`, against one NVIDIA H100's roofs (`dryrun_meta`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from types import MappingProxyType
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_leaves as pt_leaves

from .. import configs as cfgs
from ..kernels.counts import KernelCounts
from ..models import (ArchConfig, ShapeConfig, init_decode_state, model_defs,
                      n_params)
from ..models.layers import tree_map_defs
from ..optim import adamw
from ..parallel.sharding import (NamedSharding, axis_sizes, batch_axes,
                                 data_specs, decode_state_specs, param_specs,
                                 to_shardings)
from ..train import (TrainState, make_prefill_step, make_serve_step,
                     make_train_step)
from ..tree import tree_leaves, tree_map
from . import analytic
from .dryrun_meta import (HBM_BYTES, HBM_BW, LINK_BW, PEAK_FLOPS,
                          WIRE_FACTOR as _WIRE_FACTOR, wrap_results)
from .mesh import make_elastic_mesh, make_production_mesh


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for one global batch (shape and dtype, no
    data)."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        batch = {"labels": meta((B, S), torch.int32),
                 "mask": meta((B, S), torch.float32)}
        if arch.frontend in ("audio", "vlm"):
            batch["embeds"] = meta((B, S, arch.d_model), torch.bfloat16)
        else:
            batch["tokens"] = meta((B, S), torch.int32)
        return batch
    # decode: one new token against a cache of S
    if arch.frontend in ("audio", "vlm"):
        return {"tokens": meta((B, arch.d_model), torch.bfloat16)}
    return {"tokens": meta((B,), torch.int32)}


def abstract_train_state(arch: ArchConfig) -> TrainState:
    """The training state on the meta device: f32 parameters and moments,
    a 0-d int32 step count."""
    p = tree_map_defs(lambda d: torch.empty(d.shape, dtype=torch.float32,
                                            device="meta"), model_defs(arch))
    zeros = lambda: tree_map(torch.empty_like, p)
    return TrainState(params=p, opt=adamw.OptState(
        mu=zeros(), nu=zeros(),
        count=torch.empty((), dtype=torch.int32, device="meta")))


def abstract_decode_state(arch: ArchConfig, shape: ShapeConfig):
    return init_decode_state(arch, shape.global_batch, shape.seq_len,
                             device="meta")


# --- placing a tree on the mesh -------------------------------------------------

def local_shape(global_shape, sharding: NamedSharding) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``global_shape``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shp, _off = compute_local_shape_and_global_offset(
        tuple(global_shape), sharding.mesh, sharding.placements)
    return tuple(shp)


def place_zeros(tree, shardings, device: str = "meta"):
    """``tree``'s tensors (meta stand-ins) as DTensors whose local shards
    are zeros on ``device`` ("meta": no data), placed as ``shardings``
    says; other leaves (the cache length, the position) as they are.
    Only the shard is made, never the global tensor."""
    def one(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        local = torch.zeros(local_shape(x.shape, s), dtype=x.dtype,
                            device=device)
        return DTensor.from_local(local, s.mesh, s.placements, run_check=False,
                                  shape=x.shape, stride=_contiguous(x.shape))
    return tree_map(one, tree, shardings)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local_bytes(tree, shardings) -> int:
    """Bytes of this rank's shards of every tensor of ``tree``."""
    total = 0
    for x, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        if isinstance(x, torch.Tensor):
            total += int(np.prod(local_shape(x.shape, s))) * x.element_size()
    return total


# --- what one traced step does, per device -----------------------------------------

_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")
_COLLECTIVE_KIND = MappingProxyType({
    "all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute"})


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in _COLLECTIVE_NS:
        return None
    name = func._overloadpacket.__name__
    return _COLLECTIVE_KIND.get(name.removesuffix("_coalesced"))


class StepTrace(analytic.OpCounter):
    """`OpCounter` plus, for the local ops each rank runs: every
    collective DTensor issues (kind, bytes of its result), and the peak
    of live temporaries — the bytes of the storages the ops create,
    from creation until the last reference goes (storages of ``known``
    tensors, the state and the inputs, are not temporaries)."""

    def __init__(self, known: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.collectives: List[Tuple[str, int]] = []
        self._known = {_local(t).untyped_storage()._cdata for t in known
                       if isinstance(t, torch.Tensor)}
        self._live: Dict[int, Tuple[StorageWeakRef, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def count(self, func, args, kwargs, out) -> None:
        super().count(func, args, kwargs, out)
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives.append((kind, analytic._tensor_bytes(out)))
        for t in pt_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            seen = self._live.get(key)
            if seen is not None:
                if not seen[0].expired():
                    continue
                self.live_bytes -= seen[1]      # a dead storage's address
            self._live[key] = (StorageWeakRef(st), st.nbytes())
            self.live_bytes += st.nbytes()
        # dead storages only inflate live_bytes: drop them when it would
        # set a new peak, which then is exact
        if self.live_bytes > self.peak_bytes:
            for key, (ref, n) in list(self._live.items()):
                if ref.expired():
                    del self._live[key]
                    self.live_bytes -= n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def collective_bytes(collectives: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Result bytes of every collective of a traced step (a `StepTrace`'s
    ``collectives``), weighted by ring wire factors. Per-device bytes."""
    out: Dict[str, float] = {}
    for kind, nbytes in collectives:
        out[kind] = out.get(kind, 0.0) + nbytes * _WIRE_FACTOR[kind]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# --- per-cell dry run -----------------------------------------------------------

def train_accum(arch: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Microbatching: the per-device microbatch keeps the remat'd
    per-layer residual stack ([L, mb, S, d] bf16) ~<= 5 GB (MoE at most
    2: capacity buffers dominate); the reference's rule."""
    sizes = axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in batch_axes(mesh)]))
    resid_per_seq = 2.0 * arch.n_layers * shape.seq_len * arch.d_model
    per_dev = int(max(1, min(8, (5 * 1024 ** 3) // resid_per_seq)))
    if arch.uses_moe:
        per_dev = min(per_dev, 2)
    return max(1, shape.global_batch // (dp * per_dev))


class Cell(NamedTuple):
    """One step of a cell, ready to run on its mesh."""

    run: Callable[[], Any]      # takes the step
    placed: Tuple               # the step's state and inputs, as DTensors
    abstract: Tuple             # the same on the meta device, global shapes
    shardings: Tuple            # their `NamedSharding` trees


def build_cell(arch: ArchConfig, shape: ShapeConfig, mesh, *,
               use_kernel: bool = False, accum: Optional[int] = None,
               device: str = "meta",
               counts: Optional[KernelCounts] = None) -> Cell:
    """One step of the cell with its state and inputs placed on ``mesh``
    as local shards of zeros on ``device``."""
    pspecs = param_specs(arch, mesh)
    batch = input_specs(arch, shape)
    if shape.kind != "decode":
        bshard = to_shardings({k: data_specs(arch, shape, mesh)[k]
                               for k in batch}, mesh)
    if shape.kind == "train":
        accum = accum or train_accum(arch, shape, mesh)
        step = make_train_step(arch, adamw.AdamWConfig(), use_kernel=use_kernel,
                               accum=accum, counts=counts)
        state = abstract_train_state(arch)
        sshard = to_shardings(TrainState(params=pspecs, opt=adamw.OptState(
            mu=pspecs, nu=pspecs, count=())), mesh)
        st, b = place_zeros(state, sshard, device), place_zeros(batch, bshard,
                                                                device)
        return Cell(lambda: step(st, b), (st, b), (state, batch),
                    (sshard, bshard))
    params = tree_map_defs(lambda d: torch.empty(d.shape, dtype=torch.float32,
                                                 device="meta"),
                           model_defs(arch))
    pshard = to_shardings(pspecs, mesh)
    p = place_zeros(params, pshard, device)
    if shape.kind == "prefill":
        step = make_prefill_step(arch, use_kernel=use_kernel, counts=counts)
        key = "embeds" if arch.frontend in ("audio", "vlm") else "tokens"
        batch, bshard = {key: batch[key]}, {key: bshard[key]}
        b = place_zeros(batch, bshard, device)
        return Cell(lambda: step(p, b[key]), (p, b), (params, batch),
                    (pshard, bshard))
    step = make_serve_step(arch, use_kernel=use_kernel, counts=counts)
    dstate = abstract_decode_state(arch, shape)
    dshard = to_shardings(decode_state_specs(arch, shape, mesh), mesh)
    b_ax = batch_axes(mesh)
    sizes = axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in b_ax]))
    bspec = b_ax if shape.global_batch % dp == 0 else None
    tok = batch["tokens"]
    tshard = to_shardings({"tokens": (bspec,) + (None,) * (tok.dim() - 1)},
                          mesh)
    ds, t = place_zeros(dstate, dshard, device), place_zeros(batch, tshard,
                                                             device)
    return Cell(lambda: step(p, ds, t["tokens"]), (p, ds, t),
                (params, dstate, batch), (pshard, dshard, tshard))


def lower_cell(arch: ArchConfig, shape: ShapeConfig, mesh, *,
               use_kernel: bool = False,
               accum: Optional[int] = None) -> StepTrace:
    """Trace one step of the cell on ``mesh`` (meta shards), as rank 0."""
    cell = build_cell(arch, shape, mesh, use_kernel=use_kernel, accum=accum,
                      counts=KernelCounts())
    with StepTrace(tree_leaves(cell.placed)) as tr:
        cell.run()
    return tr


def _reduced_layers(arch: ArchConfig, units: int) -> ArchConfig:
    """Same-width model with `units` layer units (hybrid unit = one group)."""
    if arch.family == "hybrid":
        return arch.replace(n_layers=units * arch.shared_attn_every)
    return arch.replace(n_layers=units)


def _layer_units(arch: ArchConfig) -> int:
    return (arch.n_layers // arch.shared_attn_every
            if arch.family == "hybrid" else arch.n_layers)


def delta_costs(arch: ArchConfig, shape: ShapeConfig, mesh, *,
                use_kernel: bool = False) -> Dict:
    """Per-layer costs via the 2-vs-4-layer delta (hybrid: 1 vs 2 groups):
    the traces of the reduced models give per-layer collective, flop,
    byte and temporary deltas that extrapolate linearly in depth. Both
    traces take the full model's microbatching."""
    a_units, b_units = (1, 2) if arch.family == "hybrid" else (2, 4)
    accum = train_accum(arch, shape, mesh) if shape.kind == "train" else None
    out = {}
    for tag, units in (("a", a_units), ("b", b_units)):
        tr = lower_cell(_reduced_layers(arch, units), shape, mesh,
                        use_kernel=use_kernel, accum=accum)
        coll = collective_bytes(tr.collectives)
        out[tag] = {"units": units, "coll": coll["total"],
                    "coll_by_kind": coll, "flops": float(tr.flops),
                    "bytes": float(tr.bytes_accessed),
                    "temp": float(tr.peak_bytes)}
    total = _layer_units(arch)
    span = b_units - a_units

    def extrap(key):
        per = (out["b"][key] - out["a"][key]) / span
        return out["a"][key] + (total - a_units) * per

    return {"collective_bytes_per_device": max(extrap("coll"), 0.0),
            "hlo_flops_extrap": max(extrap("flops"), 0.0),
            "hlo_bytes_extrap": max(extrap("bytes"), 0.0),
            "temp_bytes_extrap": max(extrap("temp"), 0.0),
            "per_layer_collective": (out["b"]["coll"] - out["a"]["coll"]) / span,
            "samples": out}


def argument_bytes(arch: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Exact bytes of rank 0's shards of the step's state and inputs at
    full depth."""
    cell = build_cell(arch, shape, mesh)
    return sum(local_bytes(t, s) for t, s in zip(cell.abstract, cell.shardings))


def roofline(arch: ArchConfig, shape: ShapeConfig, mesh, deltas: Dict,
             arg_bytes: int) -> Dict:
    """One cell's report, with the reference's keys. ``bytes_per_device``
    is ``arg_bytes`` plus the extrapolated peak of the temporaries;
    ``bytes_per_device_bf16_est`` equals it, because the port counts
    every tensor in its true dtype (the reference halves the temporaries
    its CPU backend promotes to f32), and ``fits_hbm`` compares it with
    the H100's HBM_BYTES."""
    n_chips = int(np.prod(list(axis_sizes(mesh).values())))
    flops = analytic.cell_flops(arch, shape)
    bytes_acc = analytic.cell_bytes(arch, shape)
    coll = deltas["collective_bytes_per_device"]

    t_compute = flops / (n_chips * PEAK_FLOPS)
    t_memory = bytes_acc / (n_chips * HBM_BW)
    t_coll = coll / LINK_BW                     # per-device bytes
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]

    mdl = analytic.model_flops(arch, shape)
    # traced flops are per device; scale to global for the comparison
    hlo_flops_global = deltas["hlo_flops_extrap"] * n_chips
    bound = max(t_compute, t_memory, t_coll)
    used = int(arg_bytes + deltas["temp_bytes_extrap"])
    return {
        "arch": arch.name, "shape": shape.name, "chips": n_chips,
        "params": n_params(arch),
        "analytic_flops": flops, "analytic_bytes": bytes_acc,
        "hlo_flops_extrap_global": hlo_flops_global,
        "collective_bytes_per_device": coll,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "roofline_fraction": t_compute / bound if bound else 0.0,
        "model_flops": mdl,
        "useful_flops_ratio": mdl / flops if flops else 0.0,
        "bytes_per_device": used,
        "fits_hbm": used < HBM_BYTES,
        "bytes_per_device_bf16_est": used,
        "fits_hbm_bf16_est": used < HBM_BYTES,
        "per_layer_collective": deltas["per_layer_collective"],
    }


@contextlib.contextmanager
def fake_world(world_size: int):
    """An in-process fake process group of ``world_size`` ranks (this
    process is rank 0; collectives move nothing), destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_name(shape: Tuple[int, ...]) -> str:
    return "x".join(map(str, shape))


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool = False,
             use_kernel: bool = False, verbose: bool = True,
             mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict:
    """The report of one cell on the production mesh (``multi_pod``), or
    on a mesh of ``mesh_shape`` ((data, model) or (pod, data, model)).
    Sets up its own fake process group of the mesh's size and destroys
    it after. ``compile_s`` is the seconds of tracing."""
    arch = cfgs.get(arch_name)
    shape = {s.name: s for s in cfgs.ALL_SHAPES}[shape_name]
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return {"arch": arch.name, "shape": shape.name,
                "multi_pod": multi_pod,
                "skipped": "full attention is O(L^2) at 500k context"}
    dims = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    with fake_world(int(np.prod(dims))):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod)
        else:
            mesh = make_elastic_mesh(dims[0] if len(dims) == 3 else 1,
                                     data=dims[-2], model=dims[-1])
        t0 = time.monotonic()
        deltas = delta_costs(arch, shape, mesh, use_kernel=use_kernel)
        dt = time.monotonic() - t0
        rep = roofline(arch, shape, mesh, deltas,
                       argument_bytes(arch, shape, mesh))
    rep["compile_s"] = dt
    rep["multi_pod"] = multi_pod
    rep["mesh"] = _mesh_name(dims)
    if verbose:
        print(f"[{arch.name} x {shape.name} x {rep['mesh']}] traced in "
              f"{dt:.1f}s")
        print(f"  bytes_per_device={rep['bytes_per_device']} "
              f"collective_bytes_per_device={rep['collective_bytes_per_device']}")
        print(f"  roofline: compute={rep['t_compute_s']:.4g}s "
              f"memory={rep['t_memory_s']:.4g}s "
              f"collective={rep['t_collective_s']:.4g}s "
              f"-> {rep['dominant']}-bound; fits_hbm={rep['fits_hbm']} "
              f"roofline_fraction={rep['roofline_fraction']:.2f}", flush=True)
    return rep


def _parse_mesh(text: str) -> Tuple[int, ...]:
    dims = tuple(int(n) for n in text.lower().split("x"))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise argparse.ArgumentTypeError(
            f"--mesh wants DATAxMODEL or PODxDATAxMODEL, got {text!r}")
    return dims


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--mesh", type=_parse_mesh, default=None,
                    help="trace on a DATAxMODEL or PODxDATAxMODEL mesh "
                         "instead of the production mesh")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    results = []
    if args.all:
        todo = [(a.name, s.name)
                for a in cfgs.ARCHS.values() for s in cfgs.ALL_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    ok = True
    for arch_name, shape_name in todo:
        for mp in meshes:
            try:
                rep = run_cell(arch_name, shape_name, multi_pod=mp,
                               use_kernel=args.kernels, mesh_shape=args.mesh)
                results.append(rep)
            except Exception as e:  # a failed cell is a bug in the system
                ok = False
                print(f"FAILED {arch_name} x {shape_name} "
                      f"(multi_pod={mp}): {type(e).__name__}: {e}")
                results.append({"arch": arch_name, "shape": shape_name,
                                "multi_pod": mp, "error": str(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(wrap_results(results), f, indent=1)
        print(f"wrote {len(results)} cells to {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
