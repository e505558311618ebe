"""Seeded synthetic workflow generator: parameterized workflow *families*.

The paper's synthetic benchmarks (Fig. 3) are three fixed shapes; real
workflow archives show far messier structure — skewed file sizes,
irregular fan-out, stragglers, iteration. This generator produces
`TraceWorkflow`s drawn from parameterized families so sweeps can cover
that space:

    pipeline    width parallel chains of depth stages
    fan_out     a root tree whose out-degrees are Zipf-distributed
    fan_in      leaves reduced through a random-arity merge tree
    iterative   depth rounds of map -> shuffle -> reduce
    straggler   a pipeline where one chain per level draws a heavy
                compute + output-size multiplier

File sizes are lognormal (``mean_mb`` / ``sigma`` — crank ``sigma`` for
heavy-tailed, skewed mixes), fan-out degrees Zipf(``zipf_a``), and every
draw comes from one `numpy.random.default_rng(seed)` stream —
**deterministic under the seed across processes** (PCG64 streams are
version-stable), so the same ``(spec, seed)`` always yields a
byte-identical `Workflow.fingerprint()` and sweeps over generated
families are exactly reproducible.

`generate_family` models the recurrence real archives show (the same
Montage DAG resubmitted daily): with ``n_structures=k`` the n members
draw their structure seeds from only k distinct values, so families
contain structurally-equal siblings that `CompileCache.compile_grid`
dedups into one compiled DAG each — the multi-workflow sweep's payoff.

Host-side only: NumPy and the stdlib.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import MB
from .ir import TraceError, TraceTask, TraceWorkflow

FAMILIES = ("pipeline", "fan_out", "fan_in", "iterative", "straggler")


@dataclass(frozen=True)
class GenSpec:
    """Knobs of one workflow family. Everything random about a generated
    workflow comes from `generate`'s seed, not the spec — one spec and a
    seed range IS a reproducible family."""

    family: str = "pipeline"
    depth: int = 3            # stages / levels / rounds
    width: int = 8            # chains / leaves / mappers (level-width cap)
    mean_mb: float = 16.0     # lognormal median file size, MB
    sigma: float = 0.5        # lognormal sigma (skew knob; 0 = constant)
    zipf_a: float = 0.0       # >1: Zipf fan-out/arity exponent; else uniform
    max_degree: int = 8       # degree cap for fan_out / fan_in draws
    runtime_s: float = 0.0    # per-task compute seconds
    straggler_factor: float = 8.0   # straggler compute+size multiplier
    size_quantum: int = MB    # sizes round up to a multiple of this

    def replace(self, **kw) -> "GenSpec":
        return replace(self, **kw)


def _check(spec: GenSpec) -> None:
    if spec.family not in FAMILIES:
        raise TraceError(f"unknown family {spec.family!r} "
                         f"(expected one of {FAMILIES})")
    if spec.depth < 1 or spec.width < 1:
        raise TraceError(f"depth/width must be >= 1, got "
                         f"{spec.depth}/{spec.width}")
    if spec.mean_mb <= 0 or spec.sigma < 0:
        raise TraceError(f"mean_mb must be > 0 and sigma >= 0, got "
                         f"{spec.mean_mb}/{spec.sigma}")
    if spec.max_degree < 1 or spec.size_quantum < 1:
        raise TraceError("max_degree and size_quantum must be >= 1")


def _size(rng: np.random.Generator, spec: GenSpec, scale: float = 1.0) -> int:
    """One lognormal file-size draw, quantized up (never 0 bytes)."""
    mb = math.exp(rng.normal(math.log(spec.mean_mb), spec.sigma)) * scale \
        if spec.sigma > 0 else spec.mean_mb * scale
    q = spec.size_quantum
    return max(int(math.ceil(mb * MB / q)), 1) * q


def _degree(rng: np.random.Generator, spec: GenSpec) -> int:
    """Fan-out / merge-arity draw: Zipf when zipf_a > 1, else uniform."""
    if spec.zipf_a > 1.0:
        return int(min(rng.zipf(spec.zipf_a), spec.max_degree))
    return int(rng.integers(1, spec.max_degree + 1))


class _Ctx:
    def __init__(self, spec: GenSpec, seed: int):
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.tasks: List[TraceTask] = []
        self.sizes: Dict[str, int] = {}

    def file(self, name: str, scale: float = 1.0) -> str:
        self.sizes[name] = _size(self.rng, self.spec, scale)
        return name

    def task(self, tid: str, category: str, inputs: Tuple[str, ...],
             outputs: Tuple[str, ...], runtime: Optional[float] = None) -> None:
        self.tasks.append(TraceTask(
            tid=tid, category=category,
            runtime=self.spec.runtime_s if runtime is None else runtime,
            inputs=inputs, outputs=outputs))


def _gen_pipeline(ctx: _Ctx, straggler: bool) -> None:
    spec, rng = ctx.spec, ctx.rng
    for lvl in range(spec.depth):
        slow = int(rng.integers(0, spec.width)) if straggler else -1
        for w in range(spec.width):
            src = ctx.file(f"in{w}") if lvl == 0 else f"c{w}s{lvl - 1}"
            heavy = w == slow
            out = ctx.file(f"c{w}s{lvl}",
                           scale=spec.straggler_factor if heavy else 1.0)
            ctx.task(f"p_l{lvl}_t{w}", f"stage{lvl}", (src,), (out,),
                     runtime=spec.runtime_s * (spec.straggler_factor
                                               if heavy else 1.0))


def _gen_fan_out(ctx: _Ctx) -> None:
    spec = ctx.spec
    src = ctx.file("root_in")
    frontier: List[Tuple[str, ...]] = [(src,)]   # input sets of the next level
    tid = 0
    for lvl in range(spec.depth):
        nxt: List[Tuple[str, ...]] = []
        for ins in frontier:
            deg = max(_degree(ctx.rng, spec), 2) if lvl < spec.depth - 1 else 1
            outs = tuple(ctx.file(f"f{tid}_{j}") for j in range(deg))
            ctx.task(f"fo_l{lvl}_t{tid}", f"expand{lvl}", ins, outs)
            tid += 1
            nxt.extend((o,) for o in outs)
        # cap the level width so Zipf tails can't explode the DAG
        frontier = nxt[:spec.width]
    for k, ins in enumerate(frontier):
        out = ctx.file(f"leaf_out{k}", scale=0.25)
        ctx.task(f"fo_leaf_t{k}", "collect", ins, (out,))


def _gen_fan_in(ctx: _Ctx) -> None:
    spec = ctx.spec
    frontier: List[str] = []
    for w in range(spec.width):
        src = ctx.file(f"in{w}")
        out = ctx.file(f"m{w}")
        ctx.task(f"fi_leaf_t{w}", "produce", (src,), (out,))
        frontier.append(out)
    rnd, tid = 0, 0
    while len(frontier) > 1:
        nxt: List[str] = []
        i = 0
        while i < len(frontier):
            arity = max(_degree(ctx.rng, spec), 2)
            grp = tuple(frontier[i:i + arity])
            i += arity
            if len(grp) == 1:
                nxt.append(grp[0])
                continue
            out = ctx.file(f"r{rnd}_{tid}")
            ctx.task(f"fi_merge_r{rnd}_t{tid}", f"merge{rnd}", grp, (out,))
            tid += 1
            nxt.append(out)
        frontier = nxt
        rnd += 1


def _gen_iterative(ctx: _Ctx) -> None:
    spec = ctx.spec
    n_red = max(spec.width // 2, 1)
    inputs = [ctx.file(f"it_in{m}") for m in range(spec.width)]
    for rd in range(spec.depth):
        parts: List[List[str]] = [[] for _ in range(n_red)]
        for m, src in enumerate(inputs):
            outs = tuple(ctx.file(f"r{rd}p{m}_{r}", scale=1.0 / n_red)
                         for r in range(n_red))
            ctx.task(f"it_map_r{rd}_t{m}", f"map{rd}", (src,), outs)
            for r, o in enumerate(outs):
                parts[r].append(o)
        inputs = []
        for r in range(n_red):
            out = ctx.file(f"r{rd}red{r}")
            ctx.task(f"it_red_r{rd}_t{r}", f"reduce{rd}",
                     tuple(parts[r]), (out,))
            inputs.append(out)


def generate(spec: GenSpec, seed: int = 0) -> TraceWorkflow:
    """One workflow of the family — deterministic in ``(spec, seed)``."""
    _check(spec)
    ctx = _Ctx(spec, seed)
    if spec.family in ("pipeline", "straggler"):
        _gen_pipeline(ctx, straggler=spec.family == "straggler")
    elif spec.family == "fan_out":
        _gen_fan_out(ctx)
    elif spec.family == "fan_in":
        _gen_fan_in(ctx)
    else:
        _gen_iterative(ctx)
    tw = TraceWorkflow(name=f"{spec.family}_s{seed}", tasks=ctx.tasks,
                       file_sizes=ctx.sizes)
    tw.validate()
    return tw


def generate_family(spec: GenSpec, n: int, *, seed: int = 0,
                    n_structures: Optional[int] = None) -> List[TraceWorkflow]:
    """A family of ``n`` workflows with seeds ``seed..seed+k-1``.

    ``n_structures=k`` draws member structure-seeds from only ``k``
    distinct values (round-robin), modeling the DAG recurrence of real
    trace archives; structurally-equal siblings then share one compiled
    DAG in multi-workflow sweeps. Default: all members distinct."""
    if n < 1:
        raise TraceError(f"family size must be >= 1, got {n}")
    k = n if n_structures is None else n_structures
    if k < 1 or k > n:
        raise TraceError(f"n_structures must be in [1, {n}], got {k}")
    out = []
    for i in range(n):
        tw = generate(spec, seed=seed + (i % k))
        tw.name = f"{tw.name}#{i}"     # cosmetic: excluded from fingerprints
        out.append(tw)
    return out
