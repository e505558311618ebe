"""Workload descriptions (§2.6): generators for the paper's synthetic
benchmarks (Fig. 3), the BLAST provisioning scenarios (§3.2), and the
framework-integration workloads (checkpoint write / restore, which are
exactly the paper's pipeline-write and broadcast-read patterns).

Sizes follow the paper's *medium* workload scale (exact figures in the
paper are in a bitmap; we use 100 MB-class files as stated in the text,
and `scale=10` gives the *large* workload).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .types import MB, FileAttr, Placement, Task, Workflow

# Paper: 19 worker hosts in the testbed (20 minus the manager node)
DEFAULT_WIDTH = 19


def pipeline(n_pipes: int = DEFAULT_WIDTH, *, scale: int = 1, wass: bool = False,
             stage_mb: Tuple[int, int, int, int] = (100, 200, 100, 10),
             runtime: float = 0.0) -> Workflow:
    """`n_pipes` parallel 3-stage pipelines (Fig. 3 left).

    stage_mb = (input, after stage 1, after stage 2, final output) sizes.
    WASS: intermediate files use the `local` placement so the next stage
    is scheduled on the same node (locality-aware scheduling).
    """
    attr = FileAttr(placement=Placement.LOCAL) if wass else None
    tasks: List[Task] = []
    pre: Dict[str, Tuple[int, Optional[FileAttr]]] = {}
    tid = 0
    for p in range(n_pipes):
        pre[f"in{p}"] = (stage_mb[0] * scale * MB, None)
        prev = f"in{p}"
        for s in range(3):
            out = f"p{p}s{s}"
            size = stage_mb[s + 1] * scale * MB
            fa = {out: attr} if (attr and s < 2) else {}
            tasks.append(Task(tid=tid, inputs=(prev,), outputs=((out, size),),
                              runtime=runtime, client=p, stage=f"stage{s}",
                              file_attrs=fa))
            prev = out
            tid += 1
    return Workflow(tasks=tasks, name=f"pipeline{'_wass' if wass else '_dss'}",
                    preloaded=pre)


def reduce_(n_workers: int = DEFAULT_WIDTH, *, scale: int = 1, wass: bool = False,
            in_mb: int = 100, mid_mb: int = 100, out_mb: int = 200,
            runtime: float = 0.0) -> Workflow:
    """Reduce/gather (Fig. 3 middle): n parallel producers, one consumer.

    WASS: intermediate files are collocated on one node; the reduce task
    is scheduled there (data-location aware scheduling).
    """
    attr = (FileAttr(placement=Placement.COLLOCATE, collocate_group="reduce")
            if wass else None)
    local = FileAttr(placement=Placement.LOCAL) if wass else None
    tasks: List[Task] = []
    pre = {f"in{k}": (in_mb * scale * MB, None) for k in range(n_workers)}
    for k in range(n_workers):
        fa = {f"mid{k}": attr} if attr else {}
        tasks.append(Task(tid=k, inputs=(f"in{k}",),
                          outputs=((f"mid{k}", mid_mb * scale * MB),),
                          runtime=runtime, client=k, stage="map", file_attrs=fa))
    tasks.append(Task(tid=n_workers, inputs=tuple(f"mid{k}" for k in range(n_workers)),
                      outputs=(("reduced", out_mb * scale * MB),),
                      runtime=runtime, client=None, stage="reduce",
                      file_attrs={"reduced": local} if local else {}))
    return Workflow(tasks=tasks, name=f"reduce{'_wass' if wass else '_dss'}",
                    preloaded=pre)


def broadcast(n_consumers: int = DEFAULT_WIDTH, *, scale: int = 1,
              replication: int = 1, file_mb: int = 100, out_mb: int = 1,
              runtime: float = 0.0) -> Workflow:
    """Broadcast (Fig. 3 right): one producer, n consumers.

    The WASS knob here is the replication level of the hot file (Fig. 6
    evaluates 1, 2 and 4 replicas).
    """
    attr = FileAttr(placement=Placement.BROADCAST, replication=replication) \
        if replication > 1 else None
    tasks = [Task(tid=0, inputs=("in0",), outputs=(("hot", file_mb * scale * MB),),
                  runtime=runtime, client=0, stage="produce",
                  file_attrs={"hot": attr} if attr else {})]
    for k in range(n_consumers):
        tasks.append(Task(tid=1 + k, inputs=("hot",),
                          outputs=((f"out{k}", out_mb * scale * MB),),
                          runtime=runtime, client=k, stage="consume"))
    return Workflow(tasks=tasks, name=f"broadcast_r{replication}",
                    preloaded={"in0": (file_mb * scale * MB, None)})


def blast(n_app: int, *, n_queries: int = 200, db_mb: int = 1710,
          per_query_s: float = 4.0, query_mb: int = 1, out_mb: int = 8) -> Workflow:
    """The BLAST workflow (§3.2, Fig. 7): every app node reads the shared
    database from intermediate storage plus its own query file, searches
    its share of the `n_queries` queries, and writes results.

    The compute/IO balance is what creates the partitioning trade-off of
    Scenario I: more app nodes shrink per-node compute but starve the
    storage partition.
    """
    tasks: List[Task] = []
    pre: Dict[str, Tuple[int, Optional[FileAttr]]] = {
        "db": (db_mb * MB, None)}
    per_node = [n_queries // n_app + (1 if k < n_queries % n_app else 0)
                for k in range(n_app)]
    for k in range(n_app):
        pre[f"queries{k}"] = (query_mb * MB, None)
        tasks.append(Task(tid=k, inputs=("db", f"queries{k}"),
                          outputs=((f"result{k}", out_mb * MB),),
                          runtime=per_node[k] * per_query_s, client=k,
                          stage="search"))
    return Workflow(tasks=tasks, name=f"blast_{n_app}app", preloaded=pre)


def stripe_sweep_workload(n_clients: int, *, file_mb: int = 100,
                          n_hot: int = 2) -> Workflow:
    """Montage-like mix for the Fig. 1 stripe-width illustration: a few
    producers write shared files that EVERY client then reads — low stripe
    widths congest the hot nodes, high widths pay per-connection and
    per-chunk overheads (visible on the emulated cluster)."""
    tasks: List[Task] = []
    pre = {}
    tid = 0
    for h in range(n_hot):
        pre[f"in{h}"] = (file_mb * MB, None)
        tasks.append(Task(tid=tid, inputs=(f"in{h}",),
                          outputs=((f"hot{h}", file_mb * MB),), client=h,
                          stage="write"))
        tid += 1
    for k in range(n_clients):
        tasks.append(Task(tid=tid, inputs=tuple(f"hot{h}" for h in range(n_hot)),
                          outputs=((f"out{k}", 1 * MB),), client=k,
                          stage="read"))
        tid += 1
    return Workflow(tasks=tasks, name="stripe_sweep", preloaded=pre)


def scatter_gather(n_workers: int = DEFAULT_WIDTH, *, scale: int = 1,
                   wass: bool = False, in_mb: int = 100, shard_mb: int = 10,
                   out_mb: int = 4, runtime: float = 0.0) -> Workflow:
    """Scatter/gather: one distributor splits a preloaded dataset into
    per-worker shards, workers process their shard, one collector merges
    the results. Combines the paper's broadcast-write fan-out with the
    reduce fan-in — the asymmetric pattern neither Fig. 3 benchmark
    covers on its own.

    WASS: worker results are collocated on one node so the gather task is
    scheduled there (data-location aware scheduling).
    """
    coll = (FileAttr(placement=Placement.COLLOCATE, collocate_group="gather")
            if wass else None)
    tasks: List[Task] = [Task(
        tid=0, inputs=("dataset",),
        outputs=tuple((f"shard{k}", shard_mb * scale * MB)
                      for k in range(n_workers)),
        runtime=runtime, client=0, stage="scatter")]
    for k in range(n_workers):
        fa = {f"part{k}": coll} if coll else {}
        tasks.append(Task(tid=1 + k, inputs=(f"shard{k}",),
                          outputs=((f"part{k}", out_mb * scale * MB),),
                          runtime=runtime, client=k, stage="work",
                          file_attrs=fa))
    tasks.append(Task(tid=1 + n_workers,
                      inputs=tuple(f"part{k}" for k in range(n_workers)),
                      outputs=(("gathered", out_mb * scale * MB),),
                      runtime=runtime, client=None, stage="gather"))
    return Workflow(tasks=tasks,
                    name=f"scatter_gather{'_wass' if wass else '_dss'}",
                    preloaded={"dataset": (in_mb * scale * MB, None)})


def map_reduce_shuffle(n_mappers: int = DEFAULT_WIDTH,
                       n_reducers: Optional[int] = None, *, scale: int = 1,
                       rounds: int = 1, in_mb: int = 100, part_mb: int = 4,
                       out_mb: int = 50, runtime: float = 0.0) -> Workflow:
    """Multi-stage MapReduce with an all-to-all shuffle: each mapper
    writes one partition per reducer; each reducer reads its partition
    from every mapper. ``rounds`` chains map->shuffle->reduce stages —
    round i's reduce outputs are round i+1's map inputs — producing the
    deep intermediate-storage pressure of iterative analytics jobs.

    The shuffle's m x r small-file traffic is what makes the manager and
    per-request costs (chunk size, §2.4) bite, unlike the streaming
    patterns of Fig. 3.
    """
    n_reducers = n_reducers or max(n_mappers // 2, 1)
    tasks: List[Task] = []
    tid = 0
    pre = {f"mr_in{m}": (in_mb * scale * MB, None) for m in range(n_mappers)}
    inputs = [f"mr_in{m}" for m in range(n_mappers)]
    for rd in range(rounds):
        for m, inp in enumerate(inputs):
            tasks.append(Task(
                tid=tid, inputs=(inp,),
                outputs=tuple((f"r{rd}p{m}_{r}", part_mb * scale * MB)
                              for r in range(n_reducers)),
                runtime=runtime, client=None, stage=f"map{rd}"))
            tid += 1
        nxt: List[str] = []
        for r in range(n_reducers):
            out = f"r{rd}red{r}"
            tasks.append(Task(
                tid=tid,
                inputs=tuple(f"r{rd}p{m}_{r}" for m in range(len(inputs))),
                outputs=((out, out_mb * scale * MB),),
                runtime=runtime, client=None, stage=f"reduce{rd}"))
            tid += 1
            nxt.append(out)
        inputs = nxt
    return Workflow(tasks=tasks, name=f"map_reduce_shuffle_x{rounds}",
                    preloaded=pre)


# --- framework integration: checkpoints over intermediate storage -------------------

def checkpoint_write(n_writers: int, shard_bytes: int, *, local: bool = True) -> Workflow:
    """Sharded checkpoint write: every host persists its parameter+optimizer
    shard to intermediate storage. `local=True` mirrors the paper's
    pipeline optimization (write to the co-located storage node);
    `local=False` stripes system-wide."""
    attr = FileAttr(placement=Placement.LOCAL) if local else None
    tasks = [Task(tid=k, inputs=(), outputs=((f"ckpt_shard{k}", shard_bytes),),
                  client=k, stage="ckpt_write",
                  file_attrs={f"ckpt_shard{k}": attr} if attr else {})
             for k in range(n_writers)]
    return Workflow(tasks=tasks, name="checkpoint_write")


def checkpoint_restore(n_readers: int, shard_bytes: int, *, replication: int = 1,
                       full_restore: bool = False) -> Workflow:
    """Restart after failure: each host reads back a shard. With elastic
    re-meshing (`full_restore`), every host must read *all* shards it now
    owns — the paper's broadcast pattern, where replication is the knob."""
    attr = (FileAttr(placement=Placement.BROADCAST, replication=replication)
            if replication > 1 else None)
    pre = {f"ckpt_shard{k}": (shard_bytes, attr) for k in range(n_readers)}
    tasks = []
    for k in range(n_readers):
        ins = tuple(f"ckpt_shard{j}" for j in range(n_readers)) if full_restore \
            else (f"ckpt_shard{k}",)
        tasks.append(Task(tid=k, inputs=ins, outputs=((f"restored{k}", 1),),
                          client=k, stage="restore"))
    return Workflow(tasks=tasks, name="checkpoint_restore", preloaded=pre)
