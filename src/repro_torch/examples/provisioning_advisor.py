"""Provisioning advisor: the paper's Scenario I and II as a tool.

Given a workflow and a node budget, answer:
  I.  fixed cluster — how to split app/storage nodes + configure storage?
  II. metered environment — what is the cost/turnaround Pareto frontier?

All sweeps run inside one `SweepSession` whose ``--backend`` decides HOW
they execute; the session owns every piece of sweep state (engine, DAG
cache, worker pools) and releases it on exit. The workload comes from
one of three front-ends:

  --workload NAME   a builtin builder (BLAST, scatter/gather, shuffle)
  --trace PATH      a real trace: WfCommons-style .json or Pegasus .dax
  --gen FAMILY      a seeded synthetic family (pipeline, fan_out,
                    fan_in, iterative, straggler); sweeps all members
                    against the grid in ONE batched `explore_many` run
                    and also reports the best *shared* configuration

    python -m repro_torch.examples.provisioning_advisor [--nodes 20]
        [--workload blast|scatter_gather|map_reduce_shuffle]
        [--trace examples/traces/montage_small.json]
        [--gen iterative --gen-n 8 --gen-seed 0 --gen-structures 4]
        [--stripe-widths 0,2,4] [--replications 1,2]
        [--faults disk=0:8,kill=1@4]
        [--backend inline|sharded|multiproc] [--devices 0] [--workers 2]
        [--cache-dir .dagcache] [--profile OUT.json] [--device cuda|cpu]

`--faults` crosses a what-if failure scenario into the sweep next to the
healthy baseline; pair with `--replications 1,2` to see when replication
earns its node-seconds.

`--backend sharded` splits the candidate batch axis over CUDA devices
(`--devices`: 0 = every visible card, n = the first n, rounded down to a
power of two). The reference script's note about splitting the host CPU
into several XLA devices has no counterpart here: a CPU engine has one
device, so `--device cpu --backend sharded` runs unsplit. `--backend
multiproc` fans the sweep out across `--workers` spawned host processes
instead, each with its own engine on `--device`; they re-import this
module, whose work stays under ``if __name__ == "__main__":``. Combine
it with `--cache-dir` so the fleet warm-starts from the shared on-disk
DAG cache. Passing `--devices`/`--workers` alone implies the matching
backend. `--cache-dir` persists compiled DAGs to disk so repeat advisor
runs warm-start with zero workflow compiles.

Besides what the reference script prints, the run ends with two lines
of its own: the device and the sweep kernel's launches and fallbacks,
and the wall seconds of each scenario and of exact verification (with
the verified best's makespan at full precision).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import (MB, PAPER_RAMDISK, MultiprocBackend,
                              ShardedBackend, SweepSession, explore,
                              explore_many, grid, pareto_front, parse_faults)
from repro_torch.core import workloads as W
from repro_torch.core.trace import (FAMILIES, GenSpec, generate_family,
                                    load_trace, to_workflow)
from repro_torch.env import resolve_device
from repro_torch.obs import (Tracer, metrics_snapshot, spans_to_events,
                             timeline_to_events, write_trace)


def workflow_factory(kind: str, queries: int):
    if kind == "blast":
        return lambda c: W.blast(c.n_app, n_queries=queries)
    if kind == "scatter_gather":
        return lambda c: W.scatter_gather(c.n_app, in_mb=200, shard_mb=40,
                                          out_mb=10)
    if kind == "map_reduce_shuffle":
        return lambda c: W.map_reduce_shuffle(c.n_app, rounds=2, in_mb=100,
                                              part_mb=8, out_mb=50)
    raise SystemExit(f"unknown workload {kind!r}")


def fmt(c):
    s = (f"{c.n_app} app / {c.n_storage} storage, "
         f"chunk {c.chunk_size >> 10} KB, "
         f"stripe {c.stripe_width or 'all'}")
    if c.replication > 1:
        s += f", r={c.replication}"
    if c.faults is not None:
        s += f" [{c.faults.name or 'faulted'}]"
    return s


def scenario_one(wf, cands, st, session, timeline_top_k=0):
    evals = explore(wf, cands, st, verify_top_k=3, session=session,
                    timeline_top_k=timeline_top_k)
    print(f"  swept {len(cands)} configurations through the batch engine")
    best, worst = evals[0], evals[-1]
    print(f"  best : {fmt(best.candidate)} -> {best.makespan:.1f}s "
          f"({'verified' if best.verified else 'scan'})")
    w = "FAILED (unservable under fault)" if worst.failed else \
        (f"{worst.makespan:.1f}s "
         f"({worst.makespan / best.makespan:.1f}x slower)")
    print(f"  worst: {fmt(worst.candidate)} -> {w}")
    # with a --faults axis, also answer the what-if: best config *under*
    # the scenario (failed runs carry a DEAD_TIME-scale makespan and are
    # reported as such, not as a prediction)
    faulted = [e for e in evals if e.candidate.faults is not None]
    if faulted:
        fb = faulted[0]
        verdict = "FAILED (no surviving replica)" if fb.failed \
            else (f"{fb.makespan:.1f}s "
                  f"({fb.makespan / best.makespan:.2f}x healthy best)")
        print(f"  under fault: {fmt(fb.candidate)} -> {verdict}")
    return evals


def scenario_two(wf, st, stripe_widths, session, replications=(1,),
                 fault_axis=(None,)):
    cands = grid(n_nodes=[11, 17, 20], chunk_sizes=[256 * 1024, 1 * MB],
                 stripe_widths=stripe_widths, replications=replications,
                 faults=fault_axis)
    evals = explore(wf, cands, st, verify_top_k=0, objective="cost",
                    session=session)
    front = pareto_front(evals)
    print(f"  Pareto frontier ({len(front)} of {len(evals)} configs):")
    for e in front[:8]:
        c = e.candidate
        print(f"    {c.n_nodes:2d} nodes ({c.n_app:2d} app/{c.n_storage:2d} sto, "
              f"{c.chunk_size >> 10:4d} KB) : {e.makespan:7.1f}s, "
              f"{e.cost_node_seconds:9.0f} node-s")
    cheapest = min(front, key=lambda e: e.cost_node_seconds)
    fastest = min(front, key=lambda e: e.makespan)
    if cheapest is not fastest:
        dt = cheapest.makespan / fastest.makespan
        dc = fastest.cost_node_seconds / cheapest.cost_node_seconds
        print(f"  -> paying {dc:.2f}x more buys a {dt:.2f}x faster run "
              f"(the paper's Scenario-II trade-off)")
    return evals


def family_sweep(wfs, cands, st, session):
    """Multi-workflow Scenario I: every family member against the grid in
    one batched run, plus the best configuration *shared* by the family
    (one cluster serving all members — minimal aggregate makespan)."""
    groups = explore_many(wfs, cands, st, verify_top_k=1, session=session)
    print(f"  swept {len(wfs)} workflows x {len(cands)} configurations "
          f"in one batched run")
    for wf, g in zip(wfs, groups):
        b = g[0]
        print(f"    {wf.name:20s}: best {fmt(b.candidate)} "
              f"-> {b.makespan:.1f}s "
              f"({'verified' if b.verified else 'scan'})")
    # aggregate over scan_makespan, not makespan: the top-1 of each group
    # was exact-verified, and mixing backends across cells could flip the
    # ranking inside the scan-vs-exact gap
    total = {}
    for g in groups:
        for e in g:
            total[e.index % len(cands)] = \
                total.get(e.index % len(cands), 0.0) + e.scan_makespan
    j = min(total, key=total.get)
    print(f"  shared pick: {fmt(cands[j])} -> {total[j]:.1f}s family-total "
          f"makespan (scan-mode)")
    return groups


def exact_verify_summary(tracer) -> tuple:
    """(seconds, bucket shapes) of the run's exact-mode batches, from the
    session's spans: each ``simulate_batch`` span of phase exact-verify,
    and the ``sim[n_ops x n_res x candidates]`` buckets inside them."""
    secs, shapes = 0.0, []
    for s in tracer.spans():
        if s.phase != "exact-verify":
            continue
        if s.name == "simulate_batch":
            secs += s.dur
        elif s.name.startswith("sim["):
            shapes.append(s.name[4:-1])
    return secs, shapes


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--workload", default="blast",
                    choices=["blast", "scatter_gather", "map_reduce_shuffle"])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--trace", default=None, metavar="PATH",
                     help="sweep an ingested trace (.json WfCommons-style "
                          "or .dax/.xml Pegasus-style) instead of a builder")
    src.add_argument("--gen", default=None, choices=list(FAMILIES),
                     help="sweep a seeded synthetic family instead")
    ap.add_argument("--gen-n", type=int, default=6,
                    help="family size for --gen")
    ap.add_argument("--gen-seed", type=int, default=0)
    ap.add_argument("--gen-structures", type=int, default=None,
                    help="distinct structures in the family (recurring "
                         "DAGs dedup in the compile cache)")
    ap.add_argument("--replications", default="1",
                    help="comma-separated replication levels to sweep "
                         "(e.g. 1,2 — pair with --faults to see when "
                         "replication earns its cost)")
    ap.add_argument("--faults", default="", metavar="SPEC",
                    help="fault scenario to sweep WHAT-IF style: "
                         "kill=N[@K],disk=N:F,slow=R:F; the healthy "
                         "baseline stays in the ranking")
    ap.add_argument("--stripe-widths", default="0",
                    help="comma-separated stripe widths to sweep "
                         "(0 = stripe over all storage nodes)")
    ap.add_argument("--backend", default=None,
                    choices=["inline", "sharded", "multiproc"],
                    help="execution backend for the sweeps (default: "
                         "inline, or whichever --devices/--workers imply)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the sweep batch over this many CUDA "
                         "devices (0 = all visible; rounded down to a "
                         "power of two)")
    ap.add_argument("--workers", type=int, default=1,
                    help="fan the sweep out across this many host "
                         "processes (workers warm-start from --cache-dir)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persist compiled DAGs here; repeat runs "
                         "warm-start with zero workflow compiles")
    ap.add_argument("--profile", default=None, metavar="OUT.json",
                    help="write a Perfetto-loadable trace of the run's "
                         "wall-clock spans (plus the best candidate's "
                         "simulated timeline and a metrics snapshot) to "
                         "this path")
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run (cuda, or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()
    dev = resolve_device(args.device)
    st = PAPER_RAMDISK
    stripe_widths = tuple(int(s) for s in args.stripe_widths.split(","))
    replications = tuple(int(r) for r in args.replications.split(","))
    scen = parse_faults(args.faults)
    # keep the healthy baseline in the same ranking so the output shows
    # what the fault costs (and whether replication buys it back)
    fault_axis = (None, scen) if scen is not None else (None,)
    backend_name = args.backend or (
        "multiproc" if args.workers > 1
        else "sharded" if args.devices != 1 else "inline")
    if backend_name == "multiproc":
        backend = MultiprocBackend(max(args.workers, 2))
    elif backend_name == "sharded":
        backend = ShardedBackend(args.devices)
    else:
        backend = None  # SweepSession's InlineBackend default

    cands = grid(n_nodes=[args.nodes],
                 chunk_sizes=[256 * 1024, 1 * MB, 4 * MB],
                 stripe_widths=stripe_widths, replications=replications,
                 faults=fault_axis)

    # the spans feed the closing wall-time line; --profile also writes
    # them out (the reference records them only under --profile; the
    # sweep path runs the same either way)
    tracer = Tracer()
    best_eval = None
    scen_s = []
    with SweepSession(backend, cache_dir=args.cache_dir, tracer=tracer,
                      device=dev) as sess:
        t0 = time.perf_counter()
        if args.gen:
            spec = GenSpec(family=args.gen, runtime_s=1.0)
            fam = generate_family(spec, args.gen_n, seed=args.gen_seed,
                                  n_structures=args.gen_structures)
            wfs = [to_workflow(t) for t in fam]
            print(f"== Scenario I (family): {args.nodes}-node cluster, "
                  f"{args.gen_n}-member {args.gen} family ==")
            groups = family_sweep(wfs, cands, st, sess)
            scen_s.append(("scenario I", time.perf_counter() - t0))
            verified = [g[0] for g in groups if g[0].verified]
        else:
            if args.trace:
                tw = load_trace(args.trace)
                fixed = to_workflow(tw)
                wf = lambda c: fixed  # noqa: E731
                label = f"trace {tw.name} ({len(fixed.tasks)} tasks)"
            else:
                wf = workflow_factory(args.workload, args.queries)
                label = args.workload
            print(f"== Scenario I: {args.nodes}-node cluster, {label} ==")
            evals = scenario_one(wf, cands, st, sess,
                                 timeline_top_k=1 if args.profile else 0)
            scen_s.append(("scenario I", time.perf_counter() - t0))
            best_eval = evals[0]
            verified = [best_eval] if best_eval.verified else []
            print("\n== Scenario II: elastic+metered — cost/time trade-off ==")
            t0 = time.perf_counter()
            scenario_two(wf, st, stripe_widths, sess,
                         replications=replications, fault_axis=fault_axis)
            scen_s.append(("scenario II", time.perf_counter() - t0))

        s = sess.stats
        c = sess.compile_stats
        n_shards = sess.engine.n_shards
        print(f"\n[backend: {backend_name}"
              + (f", {n_shards} devices" if n_shards > 1 else "") + "]")
        print(f"[sweep engine: {s.sims} sims in {s.batch_calls} batch calls, "
              f"{s.misses} compiles, {s.hits} cache hits]")
        print(f"[compile cache: {c.grid_candidates} candidates -> "
              f"{c.misses} DAG compiles, {c.hits} hits, "
              f"{c.dedup_shared} shared by dedup"
              + (f", {c.disk_hits} disk hits" if args.cache_dir else "") + "]")
        if s.device_rows:
            placed = ", ".join(f"{d}: {n}"
                               for d, n in sorted(s.device_rows.items()))
            print(f"[device placement: {s.sharded_batch_calls} sharded batch "
                  f"calls, {s.padded_rows} padded rows — {placed}]")
        if s.worker_rows:
            placed = ", ".join(f"{w}: {n}"
                               for w, n in sorted(s.worker_rows.items()))
            compiled = ", ".join(f"{w}: {n}" for w, n in
                                 sorted(c.worker_compiles.items()))
            print(f"[worker fleet: {s.mp_items} work items over "
                  f"{len(s.worker_rows)} processes — rows {placed}; "
                  f"compiles {compiled or 'none'}"
                  + (f"; {s.mp_fallbacks} in-process fallbacks"
                     if s.mp_fallbacks else "") + "]")
        print(f"[device: {sess.device}; sweep_scan kernel: "
              f"{s.kernel_launches} launches, {s.kernel_fallbacks} "
              f"fallbacks to the plain loop]")
        ev_s, ev_shapes = exact_verify_summary(tracer)
        print(f"[wall: " + ", ".join(f"{n} {t:.3f}s" for n, t in scen_s)
              + f"; exact verify {ev_s:.3f}s over "
              f"{'+'.join(ev_shapes) or 'no'} buckets (ops x resources x "
              f"candidates); verified best makespans "
              f"{[e.makespan for e in verified]}]")

    if args.profile:
        events = spans_to_events(tracer.spans())
        if best_eval is not None and best_eval.timeline is not None:
            events += timeline_to_events(
                best_eval.timeline,
                label=f"best candidate: {fmt(best_eval.candidate)}")
        path = write_trace(args.profile, events,
                           metrics=metrics_snapshot(sess),
                           meta={"tool": "provisioning_advisor",
                                 "backend": backend_name})
        print(f"[profile: {len(tracer.spans())} spans -> {path} "
              f"(load in https://ui.perfetto.dev)]")
    print(f"[wall: total {time.perf_counter() - t_start:.3f}s]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
