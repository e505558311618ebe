#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and nothing from the network; imports
`repro_torch` only. It exits non-zero, printing no result, when no card
is present or when any phase fails (no phase's exception is caught and
passed over, nothing carries on on the CPU). Each phase prints one JSON
line:

  env          what the host offers (card, capability, power limit,
               torch / CUDA / nvcc versions)
  build        seconds `nvcc` took to build the sweep_scan library from
               the sources in this checkout
  kernel_check sweep_scan kernel vs its plain PyTorch version ON THE
               CARD, `torch.equal` on makespan and end (tolerance: none,
               the arithmetic is max and + in f64 in one order), over
               boundary and multi-tile shapes, in the shared-memory and
               the device-memory regime, healthy and with 1e30 durations
  main_path    the paper's Scenario I at paper scale through the normal
               entry points: BLAST with the 1710 MB database on a
               20-node cluster, a grid over partitioning x chunk size x
               stripe width swept by `explore` on a `SweepSession`, then
               the same grid crossed with a fault scenario and
               replication; counters, one full-size row recomputed by a
               scalar loop on the host, and a warm re-sweep
  exact_path   `explore` with exact verification on a small sweep, held
               against the port's `ref_sim`; `Predictor` ref vs exact
  {"kernels": [...]}  one entry per kernel: launches counted during the
               main path, its time at the main path's largest bucket
               beside its byte bound and the chain bound, and the plain
               version's time beside the kernel's (results compared,
               `torch.equal`) at the largest main-path bucket the plain
               version can walk in seconds
  <card name, power limit>   as nvidia-smi prints them
  {"ok": true, "device": {...}}   the last line
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# non-tensor-core FP64; the bound is stated against these whatever the
# power limit the card runs under (printed beside it)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 33.5e12
BYTES_PER_OPROW = 44      # res 4, dur 8, lag 8, deps 16 read; end 8 written
FLOPS_PER_OPROW = 8       # five max + three add per op row
MAXD = 4
SEED = 0
# the plain version is N steps of a dozen small launches each (1.4 s for
# 8192 steps on an H100 SXM at 700 W, whatever C), so it is timed and
# compared at the largest main-path bucket of at most this many op rows
PLAIN_MAX_N = 1 << 17

# the main path's grid: Scenario I on a 20-node cluster. If the script
# ever nears its time limit, cut FAULT_CHUNKS_KB (drop 256 first), never
# the database size.
NODES = 20
CHUNKS_KB = (256, 1024, 4096)        # healthy grid
FAULT_CHUNKS_KB = (256, 1024, 4096)  # grid crossed with faults x replication

KB = 1024
BOUNDARY = [(1, 1, 1, 0), (7, 3, 4, 1), (8, 2, 8, 2), (9, 5, 3, 3),
            (19, 4, 6, 4)]
MULTI_TILE = [(64, 4, 8, 64), (600, 4, 8, 600), (1024, 3, 8, 1024)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def random_bucket(n_ops, n_cand, n_res, seed):
    """A valid padded scan bucket: deps point strictly earlier or -1."""
    rng = np.random.default_rng(seed)
    res = rng.integers(0, n_res, (n_cand, n_ops), dtype=np.int32)
    dur = rng.uniform(0.01, 1.0, (n_cand, n_ops))
    lag = rng.uniform(0.0, 0.1, (n_cand, n_ops))
    deps = np.full((n_cand, n_ops, MAXD), -1, dtype=np.int32)
    for i in range(1, n_ops):
        k = int(rng.integers(0, MAXD + 1))
        if k:
            deps[:, i, :k] = rng.integers(0, i, (n_cand, k))
    return res, dur, lag, deps


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_env(env):
    info = env.probe()
    emit({"phase": "env", **info})
    return info


def phase_build(kernel_mod):
    t0 = time.perf_counter()
    kernel_mod.load()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "library": "sweep_scan",
          "source": "src/repro_torch/kernels/sweep_scan/csrc/sweep_scan.cu",
          "seconds": secs})
    return secs


def phase_kernel_check(ops_mod, kernel_mod):
    """Kernel vs plain version on the card; returns the largest absolute
    difference seen (the contract is 0.0)."""
    dev = torch.device("cuda")
    # forces end[N] out of shared memory even at tiny N
    small_cap = kernel_mod.load().sweep_scan_base_smem_bytes(128)
    cases = []
    worst = 0.0

    def check(tag, arrays, n_res, caps):
        nonlocal worst
        res, dur, lag, deps = (torch.from_numpy(a).to(dev) for a in arrays)
        mk_p, end_p = ops_mod.sweep_scan(res, dur, lag, deps,
                                         n_resources=n_res, use_kernel=False)
        for regime, cap in caps:
            mk_k, end_k = ops_mod.sweep_scan(res, dur, lag, deps,
                                             n_resources=n_res,
                                             use_kernel=True,
                                             max_smem_bytes=cap)
            torch.cuda.synchronize()
            err = max(float((mk_k - mk_p).abs().max()),
                      float((end_k - end_p).abs().max()))
            worst = max(worst, err)
            equal = torch.equal(mk_k, mk_p) and torch.equal(end_k, end_p)
            cases.append({"case": tag, "regime": regime, "equal": equal})
            if not equal:
                raise AssertionError(
                    f"sweep_scan kernel != plain version: {tag} [{regime}] "
                    f"max abs err {err}")

    both = [("smem", kernel_mod.MAX_SMEM_BYTES), ("gmem", None)]
    for n_ops, n_cand, n_res, seed in BOUNDARY + MULTI_TILE:
        caps = [(r, c if c is not None
                 else kernel_mod.load().sweep_scan_base_smem_bytes(n_res))
                for r, c in both]
        check(f"N={n_ops},C={n_cand},R={n_res}",
              random_bucket(n_ops, n_cand, n_res, seed), n_res, caps)
    big = random_bucket(4096, 64, 128, SEED)
    caps = [("smem", kernel_mod.MAX_SMEM_BYTES), ("gmem", small_cap)]
    check("N=4096,C=64,R=128 healthy", big, 128, caps)
    res, dur, lag, deps = big
    rng = np.random.default_rng(SEED + 1)
    dur = dur.copy()
    dur[rng.random(dur.shape) < 0.01] += 1e30     # dead-op style durations
    check("N=4096,C=64,R=128 dead-ops", (res, dur, lag, deps), 128, caps)
    emit({"phase": "kernel_check", "kernel": "sweep_scan",
          "tolerance": "none (torch.equal)", "cases": len(cases),
          "all_equal": all(c["equal"] for c in cases),
          "max_abs_err": worst, "detail": cases})
    return worst


def host_scan_makespan(ops, st, torch_sim, ref_sim) -> float:
    """The scan-mode makespan of one DAG by a scalar loop on the host:
    same order, same recurrence, plain Python floats."""
    perm = torch_sim.scan_order(ops, st)
    n = ops.n_ops
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    dur = ref_sim.durations(ops, st)[perm].tolist()
    lag = (ops.nlat * st.net_latency)[perm].tolist()
    res = ops.res[perm].tolist()
    deps = np.where(ops.deps >= 0, inv[ops.deps], -1)[perm].tolist()
    avail = [0.0] * ops.n_resources
    end = [0.0] * n
    mk = 0.0
    for i in range(n):
        ready = 0.0
        for d in deps[i]:
            if d >= 0 and end[d] > ready:
                ready = end[d]
        r = res[i]
        start = ready if ready > avail[r] else avail[r]
        fin = start + dur[i]
        avail[r] = fin
        end[i] = fin + lag[i]
        if fin > mk:
            mk = fin
    return mk


def phase_sums(tracer):
    out = {"compile_s": 0.0, "host_prep_s": 0.0, "device_s": 0.0,
           "scan_buckets": 0}
    for s in tracer.spans():
        if s.name == "compile_grid":
            out["compile_s"] += s.dur
        elif s.name.startswith("prep["):
            out["host_prep_s"] += s.dur
        elif s.name.startswith("sim["):
            out["device_s"] += s.dur
            out["scan_buckets"] += s.phase == "device-sim"
    return out


def describe(e):
    c = e.candidate
    return {"n_app": c.n_app, "n_storage": c.n_storage,
            "chunk_kb": c.chunk_size // KB, "stripe_width": c.stripe_width,
            "replication": c.replication,
            "faults": c.faults.name if c.faults is not None else None,
            "makespan_s": e.makespan}


def phase_main_path(core, ops_mod):
    """Scenario I at paper scale. Returns (kernel launches, timing
    inputs for the kernels line)."""
    from repro_torch.core import ref_sim, torch_sim, workloads
    from repro_torch.core import compile as compile_mod
    from repro_torch.obs import Tracer

    st = core.PAPER_RAMDISK
    chunks = [k * KB for k in CHUNKS_KB]
    fault_chunks = [k * KB for k in FAULT_CHUNKS_KB]
    wf_by_app = {}

    def workflow_for(c):
        # one Workflow object per partition: candidates that share it
        # share its fingerprint computation too
        if c.n_app not in wf_by_app:
            wf_by_app[c.n_app] = workloads.blast(c.n_app, n_queries=100)
        return wf_by_app[c.n_app]

    tracer = Tracer()
    sess = core.SweepSession(core.InlineBackend(), tracer=tracer)
    assert sess.device.type == "cuda"
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_count()

    # -- healthy grid --------------------------------------------------------
    cands = core.grid(n_nodes=[NODES], chunk_sizes=chunks,
                      stripe_widths=(0, 2, 4))
    t0 = time.perf_counter()
    evals = core.explore(workflow_for, cands, st, verify_top_k=0, session=sess)
    torch.cuda.synchronize()
    healthy_s = time.perf_counter() - t0
    healthy = phase_sums(tracer)
    stats = sess.stats
    assert len(evals) == len(cands)
    assert all(np.isfinite(e.makespan) and e.makespan > 0 for e in evals)
    assert stats.kernel_buckets > 0, "no bucket took the kernel"
    assert stats.kernel_fallbacks == 0, "a scan batch fell back"
    assert ops_mod.launch_count() == healthy["scan_buckets"], \
        (ops_mod.launch_count(), healthy["scan_buckets"])
    batches = sess.engine.cached_batches()
    assert batches and all(t.is_cuda for b, _ in batches
                           for t in (b.res, b.deps, b.nbytes))
    buckets = sorted({(k[0], k[1], k[2]) for k in sess.engine.cache_keys()})

    # one full-size row against the host recurrence, to the bit
    ops_all = [sess.compile_cache.get(workflow_for(c), c.to_config())
               for c in cands]
    big_i = int(np.argmax([o.n_ops for o in ops_all]))
    t0 = time.perf_counter()
    host_mk = host_scan_makespan(ops_all[big_i], st, torch_sim, ref_sim)
    host_check_s = time.perf_counter() - t0
    dev_mk = next(e.makespan for e in evals if e.index == big_i)
    assert host_mk == dev_mk, (host_mk, dev_mk)

    # timing inputs, taken from the buckets this sweep really produced:
    # the largest, and the largest the plain version can walk in seconds
    def scan_inputs(batch):
        C, N = batch.res.shape
        r_pad = max(k[1] for k in sess.engine.cache_keys() if k[0] == N)
        st_vecs = torch.from_numpy(
            np.stack([torch_sim.st_to_vec(st)] * C)).to(sess.device)
        dur, lag = torch_sim._durations(batch, st_vecs)
        return {"res": batch.res.clone(), "dur": dur.contiguous(),
                "lag": lag.contiguous(), "deps": batch.deps.clone(),
                "n_resources": r_pad}

    def shape_of(bf):
        return (bf[0].res.shape[1], bf[0].res.shape[0])

    timing = {"largest": scan_inputs(max(batches, key=shape_of)[0]),
              "plain": scan_inputs(max(
                  (bf for bf in batches if shape_of(bf)[0] <= PLAIN_MAX_N),
                  key=shape_of)[0])}

    # -- warm re-sweep: no DAG compiles, no new bucket callables --------------
    compiles0, misses0, rows0 = (compile_mod.compile_count(), stats.misses,
                                 stats.row_misses)
    t0 = time.perf_counter()
    evals2 = core.explore(workflow_for, cands, st, verify_top_k=0,
                          session=sess)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert compile_mod.compile_count() == compiles0, "warm sweep compiled"
    assert stats.misses == misses0, "warm sweep missed a bucket callable"
    assert stats.row_misses == rows0, "warm sweep re-prepped a row"
    assert [e.makespan for e in evals2] == [e.makespan for e in evals]

    # -- the same grid x fault scenario x replication ---------------------------
    scenario = core.parse_faults("disk=0:8,kill=1@40")
    fcands = core.grid(n_nodes=[NODES], chunk_sizes=fault_chunks,
                       stripe_widths=(0, 2, 4), replications=(1, 2),
                       faults=(None, scenario))
    tracer.clear()
    t0 = time.perf_counter()
    fevals = core.explore(workflow_for, fcands, st, verify_top_k=0,
                          session=sess)
    torch.cuda.synchronize()
    faulted_s = time.perf_counter() - t0
    faulted = phase_sums(tracer)
    assert len(fevals) == len(fcands)
    assert all(np.isfinite(e.makespan) and e.makespan > 0 for e in fevals)
    assert stats.kernel_fallbacks == 0
    assert any(k[5] and k[6] for k in sess.engine.cache_keys()), \
        "no faulted bucket took the kernel"
    # healthy rows of the crossed grid repeat the healthy sweep's values
    healthy_by_key = {(e.candidate.n_app, e.candidate.chunk_size,
                       e.candidate.stripe_width): e.makespan for e in evals}
    for e in fevals:
        c = e.candidate
        if c.faults is None and c.replication == 1:
            assert e.makespan == healthy_by_key[(c.n_app, c.chunk_size,
                                                 c.stripe_width)]
    launches = ops_mod.launch_count()
    # one launch per scan bucket; the warm re-sweep reran the healthy ones
    assert launches == 2 * healthy["scan_buckets"] + faulted["scan_buckets"], \
        (launches, healthy, faulted)
    served = [e for e in fevals if not e.failed]

    emit({"phase": "main_path", "workload": "BLAST db_mb=1710 n_queries=100",
          "nodes": NODES, "chunks_kb": CHUNKS_KB,
          "fault_chunks_kb": FAULT_CHUNKS_KB,
          "healthy": {"candidates": len(cands), "seconds": healthy_s,
                      **healthy,
                      "total_ops": int(sum(o.n_ops for o in ops_all)),
                      "max_ops": int(ops_all[big_i].n_ops),
                      "buckets_n_r_c": buckets,
                      "best": describe(evals[0]), "worst": describe(evals[-1])},
          "full_size_row": {"n_ops": int(ops_all[big_i].n_ops),
                            "host_makespan": host_mk,
                            "device_makespan": dev_mk,
                            "equal": host_mk == dev_mk,
                            "host_loop_s": host_check_s},
          "warm_resweep": {"seconds": warm_s, "compile_workflow_calls": 0,
                           "executable_misses": 0, "row_misses": 0},
          "faulted": {"candidates": len(fcands), "seconds": faulted_s,
                      **faulted, "failed": len(fevals) - len(served),
                      "best": describe(served[0]) if served else None,
                      "worst": describe(served[-1]) if served else None},
          "kernel_buckets": stats.kernel_buckets,
          "kernel_fallbacks": stats.kernel_fallbacks,
          "kernel_launches": launches,
          "results_device": str(sess.device),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    sess.close()
    return launches, timing


def phase_exact_path(core):
    from repro_torch.core import ref_sim, workloads

    # the tie rule exact mode rests on, checked on the card itself
    dev = torch.device("cuda")
    key = torch.full((1 << 16,), 7.0, dtype=torch.float64, device=dev)
    key[[4097, 30000, 65535]] = 1.0
    assert int(key.argmin()) == 4097, "argmin does not take the first of ties"
    assert int(torch.zeros(100001, dtype=torch.float64,
                           device=dev).argmin()) == 0
    rows = torch.full((4, 1000), 3.0, dtype=torch.float64, device=dev)
    rows[:, 500:] = 2.0
    assert rows.argmin(dim=1).tolist() == [500] * 4

    st = core.PAPER_RAMDISK

    def workflow_for(c):
        return workloads.scatter_gather(c.n_app, in_mb=200, shard_mb=40,
                                        out_mb=10)

    cands = core.grid(n_nodes=[12])
    t0 = time.perf_counter()
    with core.SweepSession(core.InlineBackend()) as sess:
        evals = core.explore(workflow_for, cands, st, verify_top_k=3,
                             session=sess)
        assert sess.stats.exact_batch_calls == 1
        assert sess.stats.exact_sims == 3
        verified = [e for e in evals if e.verified]
        assert len(verified) == 3
        rows = []
        for e in verified:
            ops = sess.compile_cache.get(workflow_for(e.candidate),
                                         e.candidate.to_config())
            ref = ref_sim.simulate(ops, st).makespan
            np.testing.assert_allclose(e.makespan, ref, rtol=1e-12)
            rows.append({"n_ops": ops.n_ops, "exact": e.makespan, "ref": ref,
                         "scan": e.scan_makespan})
        pred = core.Predictor(st, session=sess)
        c = verified[0].candidate
        p_ref = pred.predict(workflow_for(c), c.to_config(), backend="ref")
        p_exact = pred.predict(workflow_for(c), c.to_config(),
                               backend="exact")
        np.testing.assert_allclose(p_exact.makespan, p_ref.makespan,
                                   rtol=1e-12)
        for tid, t in p_ref.per_task_end.items():
            np.testing.assert_allclose(p_exact.per_task_end[tid], t,
                                       rtol=1e-12)
    emit({"phase": "exact_path", "candidates": len(cands), "rtol": 1e-12,
          "argmin_first_of_ties_on_card": True, "verified": rows,
          "predictor_ref": p_ref.makespan, "predictor_exact": p_exact.makespan,
          "seconds": time.perf_counter() - t0})


def kernels_line(ops_mod, launches, timing, max_abs_err):
    """Time sweep_scan on the main path's own buckets and print the
    kernels line: the kernel at the largest bucket beside its bounds,
    and kernel and plain version side by side (and compared) at the
    largest bucket the plain version can walk."""
    def run(use_kernel, t):
        return ops_mod.sweep_scan(t["res"], t["dur"], t["lag"], t["deps"],
                                  n_resources=t["n_resources"],
                                  use_kernel=use_kernel)

    big, mid = timing["largest"], timing["plain"]
    C, N = big["res"].shape
    before = ops_mod.launch_count()
    kernel_ms = cuda_time_ms(lambda: run(True, big), reps=3)
    # one candidate alone on the card: N dependent steps at the latency
    # of one step, the floor a sequential recurrence cannot go below
    one = {k: (v[:1].contiguous() if torch.is_tensor(v) else v)
           for k, v in big.items()}
    chain_ms = cuda_time_ms(lambda: run(True, one), reps=3)
    # the plain version: one run, no warm-up (tens of seconds of small
    # launches, which a warm-up would not change), the kernel beside it
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    mk_p, end_p = run(False, mid)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    kernel_mid_ms = cuda_time_ms(lambda: run(True, mid), reps=5)
    mk_k, end_k = run(True, mid)
    torch.cuda.synchronize()
    err = max(float((mk_k - mk_p).abs().max()),
              float((end_k - end_p).abs().max()))
    assert torch.equal(mk_k, mk_p) and torch.equal(end_k, end_p), \
        f"sweep_scan kernel != plain version on a main-path bucket: {err}"
    assert ops_mod.launch_count() > before      # timing launches, not counted
    bytes_ms = BYTES_PER_OPROW * C * N / PEAK_BYTES_PER_S * 1e3
    flops_ms = FLOPS_PER_OPROW * C * N / PEAK_F64_FLOPS * 1e3
    emit({"kernels": [{
        "name": "sweep_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/sweep_scan/csrc/sweep_scan.cu",
        "replaces": "src/repro/kernels/sweep_scan/kernel.py:95",
        "launches": launches, "max_abs_err": max(max_abs_err, err),
        "shape_c_n_r": [C, N, big["n_resources"]],
        "ms": kernel_ms, "kernel_ms": kernel_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "chain_ms": chain_ms, "chain_ns_per_step": chain_ms * 1e6 / N,
        "plain_ms": plain_ms,
        "plain_shape_c_n_r": [mid["res"].shape[0], mid["res"].shape[1],
                              mid["n_resources"]],
        "ms_at_plain_shape": kernel_mid_ms,
        "library_ms": None}]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script does not run on the CPU", file=sys.stderr)
        return 1
    from repro_torch import core, env
    from repro_torch.kernels.sweep_scan import kernel as kernel_mod
    from repro_torch.kernels.sweep_scan import ops as ops_mod
    assert "jax" not in sys.modules and "repro" not in sys.modules

    t_start = time.perf_counter()
    phase_env(env)
    phase_build(kernel_mod)
    max_abs_err = phase_kernel_check(ops_mod, kernel_mod)
    launches, timing = phase_main_path(core, ops_mod)
    phase_exact_path(core)
    kernels_line(ops_mod, launches, timing, max_abs_err)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
