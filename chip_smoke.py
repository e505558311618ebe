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
  build        seconds `nvcc` took to build each kernel library
               (sweep_scan, flash_attention, ssd, moe_gmm) from the
               sources in this checkout, one `nvcc` per source, all
               started together
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
  model_kernel_check  flash_attention, ssd and moe_gmm kernels vs their
               plain PyTorch versions ON THE CARD, f32 and bf16, on the
               reference's kernel-test shapes, zamba2-2.7b's, and
               mixtral-8x22b's and qwen3-moe-235b-a22b's expert shapes
  model_path   the serving path at full width and depth: zamba2-2.7b
               (54 layers, d_model 2560, vocab 32000, random weights from
               a seeded generator), 8 requests of 512-token prompts
               prefilled through the kernels and compared with the plain
               path (argmax agreement held in f32; in bf16 reported beside
               the plain path's own rounding spread), every kernel call
               held in situ against its plain version, f32 serve steps
               held against the f32 prefill, served in bf16 as
               `examples/serve_batch.py` serves (teacher-forced steps,
               then 64 greedy tokens), then one prefill of 32768 tokens
               (batch cut from 32 to 1), its kernel calls held in situ
               against the model's own plain path in bf16, and its first
               K2 and K3 calls again in f32
  moe_path     the MoE serving path: mixtral-8x22b at full width (d_model
               6144, 8 experts of d_ff 16384, top-2, window 4096) with
               its depth cut from 56 to 8 layers, random weights drawn
               in bf16; a 2-layer f32 copy held kernel vs plain path
               (argmax agreement) and serve steps vs prefill; then the
               same traffic as model_path, every K2 and K4 call of one
               forward per shape held in situ, one K4 launch per layer
               in every prefill forward and every serve step
  {"kernels": [...]}  one entry per kernel: launches counted during its
               path, its time at the path's largest shape beside its
               bound, the plain version's time beside the kernel's at a
               shape the plain version can take, and a library call's
               time where one PyTorch call computes the same function
  <card name, power limit>   as nvidia-smi prints them
  {"ok": true, "device": {...}}   the last line
"""
from __future__ import annotations

import contextlib
import json
import math
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
PEAK_BF16_FLOPS = 989e12          # dense tensor-core rate
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

# the serving path: zamba2-2.7b at full width and depth. Requests are
# served as `examples/serve_batch.py` serves them, 8 prompts of 512
# tokens; the long prefill is the repo's prefill_32k length with its
# batch cut to 1 (one card).
MODEL = "zamba2-2.7b"
N_REQUESTS, PROMPT_LEN, GEN_LEN = 8, 512, 64
LONG_BATCH = 1
# argmax agreement of the kernel path with the plain path over the
# prompt positions, held in f32. In bf16 the two paths round at other
# places and 54 layers amplify one-ulp differences until the argmax is
# a coin toss for any random weights, so there it is only reported,
# beside the plain path's agreement with itself under a change of
# rounding alone (another SSD chunk length); every kernel call is also
# held in situ.
MIN_ARGMAX_AGREEMENT = 0.98
# f32 serve steps over the first DECODE_CHECK_LEN prompt positions, held
# against the f32 prefill at those positions: argmax agreement at
# MIN_ARGMAX_AGREEMENT and max |decode - prefill| <= DECODE_TOL x max
# |prefill logit|. The two compute the same function in another order
# (a recurrence for the chunked SSD, one cached row for the flash
# attention); 54 layers carry f32 rounding to ~3e-3 of the largest logit
# (the kernel and plain prefills differ by that, H100 80GB HBM3 at 700 W),
# while a wrong cache slot or state moves logits by their whole scale.
DECODE_CHECK_LEN = 64
DECODE_TOL = 2e-2
# (B, S, H, K, hd, window): tests/test_kernels.py's flash-attention rows
# and zamba2's request shape
FA_CHECK = [(2, 256, 4, 2, 64, 0), (1, 128, 4, 4, 32, 0),
            (2, 256, 8, 2, 64, 64), (1, 512, 2, 1, 128, 128),
            (3, 192, 6, 3, 16, 0), (2, 512, 32, 32, 80, 0)]
# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD rows and zamba2's
SSD_CHECK = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 16, 8, 64),
             (2, 96, 3, 8, 4, 32), (1, 64, 8, 64, 32, 64),
             (2, 512, 80, 64, 64, 256)]
# (G, E, C, d, f, drawn at the model's scale): tests/test_kernels.py's
# moe_gmm rows; mixtral-8x22b's capacity at 8 x 512 prompt tokens and in
# decode (batch 8); qwen3-moe-235b-a22b's at 8 x 512 (C = 320, no
# multiple of 128: the reference's kernel refuses it) with 128 experts
GMM_CHECK = [(1, 4, 64, 32, 64, False), (2, 2, 128, 64, 128, False),
             (1, 8, 32, 16, 48, False), (4, 2, 64, 128, 64, False),
             (1, 8, 1280, 6144, 16384, True), (1, 8, 8, 6144, 16384, True),
             (1, 128, 320, 4096, 1536, True)]

# the MoE serving path: mixtral-8x22b at full width (d_model 6144, 48
# heads of 128, 8 kv heads, 8 experts of d_ff 16384, top-2, window 4096,
# vocab 32768) with its depth cut from 56 to 8 layers: 20.4e9 parameters,
# 40.9 GB in bf16, where 56 layers (281 GB) fit no card. The f32 argmax
# agreement is held on a 2-layer copy at full width (21.6 GB in f32),
# since 8 layers in f32 do not fit beside the bf16 model. Same traffic
# as zamba2's: 8 requests of 512-token prompts, then one 32768-token
# prefill with the batch cut from 32 to 1.
MOE_MODEL = "mixtral-8x22b"
MOE_LAYERS = 8
MOE_F32_LAYERS = 2


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


def phase_build(kernel_mods):
    """Each kernel module's own `load()` (one `nvcc` per source, then
    the `ctypes` binding), all started together."""
    from concurrent.futures import ThreadPoolExecutor

    def one(mod):
        t0 = time.perf_counter()
        mod.load()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_mods)) as pool:
        secs = list(pool.map(one, kernel_mods))
    wall = time.perf_counter() - t0
    emit({"phase": "build", "seconds": wall, "libraries": [
        {"library": mod.SOURCE.parent.parent.name,
         "source": str(mod.SOURCE.relative_to(ROOT)), "seconds": s}
        for mod, s in zip(kernel_mods, secs)]})
    return wall


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


def fa_inputs(B, S, H, K, hd, dtype, gen):
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))


def ssd_inputs(B, S, H, P, N, dtype, gen):
    """Inputs as the reference's SSD tests draw them: x, b, c scaled by
    0.5, dt = softplus(normal), a = exp(uniform[0, 1))."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (randn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    a = torch.exp(torch.rand(H, generator=gen, device="cuda"))
    b = (randn(B, S, N) * 0.5).to(dtype)
    c = (randn(B, S, N) * 0.5).to(dtype)
    return x, dt, a, b, c


def gmm_inputs(GE, E, C, d, f, dtype, gen, model_scale):
    """x [GE, C, d], wg, wu [E, d, f], wd [E, f, d]: as the reference's
    kernel test draws them (x * 0.3, weights * 0.1), or as the model
    meets them (unit tokens, weights at 1/sqrt(input width))."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if model_scale:
        return (randn(GE, C, d).to(dtype), (randn(E, d, f) / d ** 0.5).to(dtype),
                (randn(E, d, f) / d ** 0.5).to(dtype),
                (randn(E, f, d) / f ** 0.5).to(dtype))
    return ((randn(GE, C, d) * 0.3).to(dtype), (randn(E, d, f) * 0.1).to(dtype),
            (randn(E, d, f) * 0.1).to(dtype), (randn(E, f, d) * 0.1).to(dtype))


def check_close(tag, got, want, rtol, atol):
    """Raise unless |got - want| <= atol + rtol |want| everywhere;
    returns the largest absolute difference."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - (atol + rtol * want.abs())).max())
    if not (torch.isfinite(got).all() and excess <= 0.0):
        raise AssertionError(f"{tag}: kernel != plain version, max abs err "
                             f"{err} (rtol={rtol}, atol={atol})")
    return err


def phase_model_kernel_check(fa_ops, ssd_ops, gmm_ops):
    """flash_attention, ssd and moe_gmm kernels vs their plain versions
    on the card. Tolerances: the reference's `_tol` (f32 1e-5, bf16 2e-2:
    both sides compute in f32 in another order, bf16 outputs are rounded
    once; moe_gmm's bf16 path also rounds act once), and the SSD state at
    1e-4 / 5e-2 as the reference holds its own kernel. The f32 moe_gmm
    kernel is held against its plain version evaluated in f64: at full
    width cuBLAS's f32 evaluation itself strays ~2e-5 from the exact
    sums (reported beside). Returns the largest absolute difference per
    kernel."""
    from repro_torch.kernels.moe_gmm.ref import expert_ffn_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_attention": 0.0, "ssd": 0.0, "moe_gmm": 0.0}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        rt = 2e-2 if bf16 else 1e-5
        for B, S, H, K, hd, win in FA_CHECK:
            q, k, v = fa_inputs(B, S, H, K, hd, dtype, gen)
            want = fa_ops.flash_attention(q, k, v, window=win, use_kernel=False)
            got = fa_ops.flash_attention(q, k, v, window=win, use_kernel=True)
            torch.cuda.synchronize()
            tag = f"flash_attention {dtype} B,S,H,K,hd,win={B},{S},{H},{K},{hd},{win}"
            err = check_close(tag, got, want, rt, rt)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            cases.append({"kernel": "flash_attention", "dtype": str(dtype),
                          "shape": [B, S, H, K, hd, win], "tol": rt,
                          "max_abs_err": err})
        for B, S, H, P, N, chunk in SSD_CHECK:
            x, dt, a, b, c = ssd_inputs(B, S, H, P, N, dtype, gen)
            y0, h0 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=False)
            y1, h1 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=True)
            torch.cuda.synchronize()
            tag = f"ssd {dtype} B,S,H,P,N,chunk={B},{S},{H},{P},{N},{chunk}"
            ht = 5e-2 if bf16 else 1e-4
            err = check_close(tag + " y", y1, y0, rt, rt)
            herr = check_close(tag + " h", h1, h0, ht, ht)
            worst["ssd"] = max(worst["ssd"], err, herr)
            cases.append({"kernel": "ssd", "dtype": str(dtype),
                          "shape": [B, S, H, P, N, chunk], "tol_y": rt,
                          "tol_h": ht, "max_abs_err_y": err,
                          "max_abs_err_h": herr})
        for G, E, C, d, f, model_scale in GMM_CHECK:
            x, wg, wu, wd = gmm_inputs(G * E, E, C, d, f, dtype, gen,
                                       model_scale)
            plain = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=False)
            got = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=True)
            # f32: the plain version evaluated in f64 (its own f32
            # evaluation strays ~2e-5 at full width); bf16: as it is
            want = plain if bf16 else expert_ffn_ref(
                *(t.double() for t in (x, wg, wu, wd)))
            torch.cuda.synchronize()
            tag = f"moe_gmm {dtype} G,E,C,d,f={G},{E},{C},{d},{f}"
            err = check_close(tag, got, want, rt, rt)
            worst["moe_gmm"] = max(worst["moe_gmm"], err)
            cases.append({"kernel": "moe_gmm", "dtype": str(dtype),
                          "shape": [G, E, C, d, f], "tol": rt,
                          "oracle": "expert_ffn_ref in " +
                                    ("f32" if bf16 else "f64"),
                          "max_abs_err": err,
                          "plain_f32_vs_oracle_max_abs_err_not_held":
                              None if bf16 else float(
                                  (plain.double() - want).abs().max()),
                          "max_abs_plain": float(want.float().abs().max())})
            del x, wg, wu, wd, want, got, plain
    emit({"phase": "model_kernel_check", "cases": len(cases),
          "max_abs_err": worst, "detail": cases})
    return worst


def agreement(a, b):
    """(max |a - b|, share of positions whose argmax agrees)."""
    return (float((a.float() - b.float()).abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def reset_counts(ops_mods):
    for m in ops_mods:
        m.reset_launch_count()


class InSituCheck:
    """For one model forward, every flash_attention / ssd / moe_gmm kernel
    launch the model makes is also run through the plain version on the
    same inputs and compared: the kernels held at the real activations of
    the full-size model, where a comparison of final logits cannot reach
    through 54 layers in bf16. The bound is relative to the tensor's
    scale, max |kernel - plain| <= tol * max |plain|: an element that is a
    near-cancelling sum of large terms carries an absolute rounding error
    of eps times those terms in either version. The plain runs launch
    nothing and count nothing. Restores the wrappers on exit.

    ``plain`` replaces some of the wrappers' plain versions by others,
    keyed by kernel: ``flash_attention(q, k, v, window)``,
    ``ssd(x, dt, a, b, c, chunk)``, ``moe_gmm(x, wg, wu, wd)``: at lengths
    where `attention_ref`'s S x S scores, `ssd_ref`'s S sequential steps
    or `expert_ffn_ref`'s f32 intermediates do not fit, the model's own
    plain path (`flash_mha`, `ssd_chunked`, `expert_ffn_einsum`). With
    ``capture`` the inputs of each kernel's first call are kept in
    `captured`, to be held again in f32 (`hold_captured_f32`)."""

    def __init__(self, fa_ops, ssd_ops, fa_tol, ssd_tol, h_tol, plain=None,
                 capture=False, gmm_ops=None, gmm_tol=None):
        self.fa_ops, self.ssd_ops, self.gmm_ops = fa_ops, ssd_ops, gmm_ops
        self.tols = {"fa": fa_tol, "ssd": ssd_tol, "h": h_tol,
                     "gmm": gmm_tol}
        self.plain = plain or {}
        self.captured = {} if capture else None
        names = ["flash_attention", "ssd"] + (["moe_gmm"] if gmm_ops else [])
        self.calls = {n: 0 for n in names}
        self.worst = {n: 0.0 for n in names}

    @staticmethod
    def check(tag, got, want, tol):
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not (torch.isfinite(got).all() and err <= tol * scale):
            raise AssertionError(f"{tag}: kernel != plain version, max abs "
                                 f"err {err} > {tol} x max |plain| {scale}")
        return err / scale if scale else 0.0

    def __enter__(self):
        fa, ssd = self.fa_ops.flash_attention, self.ssd_ops.ssd
        gmm = self.gmm_ops.expert_ffn if self.gmm_ops else None
        self.orig = (fa, ssd, gmm)
        t = self.tols
        self._plain = {
            "flash_attention": lambda q, k, v, window: fa(
                q, k, v, window=window, use_kernel=False),
            "ssd": lambda x, dt, a, b, c, chunk: ssd(
                x, dt, a, b, c, chunk=chunk, use_kernel=False),
            "moe_gmm": lambda x, wg, wu, wd: gmm(x, wg, wu, wd,
                                                 use_kernel=False),
            **self.plain}
        fa_plain, ssd_plain, gmm_plain = (
            self._plain[n] for n in ("flash_attention", "ssd", "moe_gmm"))

        def keep(name, args):
            if self.captured is not None and name not in self.captured:
                self.captured[name] = tuple(
                    x.clone() if torch.is_tensor(x) else x for x in args)

        def fa_checked(q, k, v, *, causal=True, window=0, use_kernel):
            assert causal, "the model's attention is causal"
            out = fa(q, k, v, causal=causal, window=window,
                     use_kernel=use_kernel)
            want = fa_plain(q, k, v, window)
            err = self.check(f"flash_attention in situ, call "
                             f"{self.calls['flash_attention']}", out, want,
                             t["fa"])
            keep("flash_attention", (q, k, v, window))
            self._note("flash_attention", err)
            return out

        def ssd_checked(x, dt, a, b, c, *, chunk=128, use_kernel):
            y, h = ssd(x, dt, a, b, c, chunk=chunk, use_kernel=use_kernel)
            y0, h0 = ssd_plain(x, dt, a, b, c, chunk)
            keep("ssd", (x, dt, a, b, c, chunk))
            tag = f"ssd in situ, call {self.calls['ssd']}"
            err = max(self.check(tag + " y", y, y0, t["ssd"]),
                      self.check(tag + " h", h, h0, t["h"]))
            self._note("ssd", err)
            return y, h

        def gmm_checked(x, wg, wu, wd, *, use_kernel):
            out = gmm(x, wg, wu, wd, use_kernel=use_kernel)
            want = gmm_plain(x, wg, wu, wd)
            err = self.check(f"moe_gmm in situ, call {self.calls['moe_gmm']}",
                             out, want, t["gmm"])
            self._note("moe_gmm", err)
            return out

        self.fa_ops.flash_attention = fa_checked
        self.ssd_ops.ssd = ssd_checked
        if self.gmm_ops:
            self.gmm_ops.expert_ffn = gmm_checked
        return self

    def _note(self, name, err):
        self.calls[name] += 1
        self.worst[name] = max(self.worst[name], err)

    def __exit__(self, *exc):
        self.fa_ops.flash_attention, self.ssd_ops.ssd, gmm = self.orig
        if self.gmm_ops:
            self.gmm_ops.expert_ffn = gmm
        return False

    def hold_captured_f32(self, fa_tol, ssd_tol, h_tol):
        """After the `with`: each captured first call again with its
        inputs cast to f32, under f32 tolerances. K2 is held against this
        check's plain attention; K3 against the wrapper's plain version,
        the sequential recurrence, because the chunked plain path sums
        its log decays in f32 and at 128 chunks of 256 steps strays
        further than 1e-5 itself (the kernel sums them in f64); how far
        is reported beside. Returns the largest error over max |plain|
        per kernel. These launches are a comparison's: read the path's
        launch counts before."""
        fa, ssd, _ = self.orig
        fa_plain, ssd_chunked_plain = (self._plain["flash_attention"],
                                       self._plain["ssd"])
        f32 = torch.float32
        q, k, v, window = (x.to(f32) if torch.is_tensor(x) else x
                           for x in self.captured["flash_attention"])
        err_fa = self.check("flash_attention f32, first call", fa(
            q, k, v, window=window, use_kernel=True),
            fa_plain(q, k, v, window), fa_tol)
        x, dt, a, b, c, chunk = (t.to(f32) if torch.is_tensor(t) else t
                                 for t in self.captured["ssd"])
        y, h = ssd(x, dt, a, b, c, chunk=chunk, use_kernel=True)
        y0, h0 = ssd(x, dt, a, b, c, chunk=chunk, use_kernel=False)
        err_ssd = max(self.check("ssd f32 y, first call", y, y0, ssd_tol),
                      self.check("ssd f32 h, first call", h, h0, h_tol))
        y1, h1 = ssd_chunked_plain(x, dt, a, b, c, chunk)
        chunked = max(self.check("ssd_chunked f32 y", y1, y0, math.inf),
                      self.check("ssd_chunked f32 h", h1, h0, math.inf))
        torch.cuda.synchronize()
        return {"flash_attention": err_fa, "ssd": err_ssd,
                "ssd_chunked_vs_sequential_not_held": chunked}


def hold_decode_against_prefill(cfg32, params32, prompts, prefill32):
    """DECODE_CHECK_LEN teacher-forced f32 serve steps, each step's logits
    held against the f32 prefill's at that position (cache slot, in-place
    state, rotary offset): argmax agreement at MIN_ARGMAX_AGREEMENT and
    max |decode - prefill| <= DECODE_TOL x max |prefill logit|. Returns
    (max diff, max |prefill logit|, agreement)."""
    from repro_torch.models import init_decode_state
    from repro_torch.train.step import make_serve_step
    state = init_decode_state(cfg32, N_REQUESTS, PROMPT_LEN + GEN_LEN,
                              dtype=torch.float32, device=prompts.device)
    serve = make_serve_step(cfg32, use_kernel=True)
    dec = []
    for t in range(DECODE_CHECK_LEN):
        _nxt, lg, state = serve(params32, state, prompts[:, t])
        dec.append(lg[:, :cfg32.vocab])
    dec = torch.stack(dec, dim=1)
    pre = prefill32[:, :DECODE_CHECK_LEN, :cfg32.vocab]
    torch.cuda.synchronize()
    assert state.pos == DECODE_CHECK_LEN, state.pos
    assert bool(torch.isfinite(dec).all())
    diff, agree = agreement(dec, pre)
    scale = float(pre.abs().max())
    assert agree >= MIN_ARGMAX_AGREEMENT, agree
    assert diff <= DECODE_TOL * scale, (diff, scale)
    return diff, scale, agree


def serve_requests(cfg, params, prompts, last_prefill):
    """Serve the prompts as `examples/serve_batch.py` serves: PROMPT_LEN - 1
    teacher-forced serve steps, then GEN_LEN greedy tokens, in the served
    dtype; the first greedy step's logits are compared with the
    prefill's last position (reported). Returns the readings."""
    from repro_torch.models import init_decode_state
    from repro_torch.train.step import make_serve_step
    state = init_decode_state(cfg, N_REQUESTS, PROMPT_LEN + GEN_LEN,
                              device=prompts.device)
    serve = make_serve_step(cfg, use_kernel=True)
    t0 = time.perf_counter()
    for t in range(PROMPT_LEN - 1):
        _nxt, _logits, state = serve(params, state, prompts[:, t])
    toks = [prompts[:, -1]]
    first_logits = None
    for _ in range(GEN_LEN):
        nxt, logits, state = serve(params, state, toks[-1])
        if first_logits is None:
            first_logits = logits.float()
        toks.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    steps = PROMPT_LEN - 1 + GEN_LEN
    assert state.pos == steps, state.pos
    assert bool(torch.isfinite(logits).all())
    out = torch.stack(toks, dim=1)
    assert out.shape == (N_REQUESTS, GEN_LEN + 1)
    assert bool(((out >= 0) & (out < cfg.vocab)).all())
    return {"serve_steps": steps, "decode_s": decode_s,
            "decode_tokens_per_s": N_REQUESTS * steps / decode_s,
            "decode_step_ms": decode_s / steps * 1e3,
            "state_pos": state.pos,
            "decode_vs_prefill_last_pos_max_abs_diff":
                float((first_logits - last_prefill).abs().max()),
            "decode_vs_prefill_last_pos_argmax_agreement": float(
                (first_logits.argmax(-1) == last_prefill.argmax(-1))
                .float().mean()),
            "sample_continuation": out[0, :12].tolist(),
            "results_device": str(out.device)}


def phase_model_path(fa_ops, ssd_ops, gmm_ops, scan_ops):
    """zamba2-2.7b at full width and depth through the serving entry
    points. Returns (launches per kernel, timing inputs)."""
    from repro_torch import configs
    from repro_torch.models import PREFILL_32K, cast_params, init, n_params
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.transformer import flash_mha
    from repro_torch.train.step import make_prefill_step

    cfg = configs.get(MODEL)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = init(torch.Generator(device=dev).manual_seed(SEED), cfg,
                    device=dev)                   # f32 master weights
    n = sum(t.numel() for t in _leaves(params32))
    assert n == n_params(cfg), (n, n_params(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per_fwd_fa = cfg.n_layers // cfg.shared_attn_every
    per_fwd_ssd = cfg.n_layers

    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (N_REQUESTS, PROMPT_LEN))).to(dev)
    long_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LONG_BATCH, PREFILL_32K.seq_len))).to(dev)

    reset_counts((fa_ops, ssd_ops, gmm_ops, scan_ops))
    # -- the algorithm at full width and depth, in f32 (no TF32): kernel path
    # vs plain path on the 8 prompts, each kernel call also held in situ
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(dtype="float32")
    # f32 tolerances of model_kernel_check
    with InSituCheck(fa_ops, ssd_ops, 1e-5, 1e-5, 1e-4) as in_situ32:
        l32k = make_prefill_step(cfg32, use_kernel=True)(params32, prompts)
    l32p = make_prefill_step(cfg32, use_kernel=False)(params32, prompts)
    torch.cuda.synchronize()
    assert fa_ops.launch_count() == per_fwd_fa, fa_ops.launch_count()
    assert ssd_ops.launch_count() == per_fwd_ssd, ssd_ops.launch_count()
    assert in_situ32.calls == {"flash_attention": per_fwd_fa,
                               "ssd": per_fwd_ssd}, in_situ32.calls
    assert bool(torch.isfinite(l32k).all()) and bool(torch.isfinite(l32p).all())
    diff32, agree32 = agreement(l32k, l32p)
    assert agree32 >= MIN_ARGMAX_AGREEMENT, agree32
    # -- decode in f32: serve steps held against the f32 prefill
    dec_diff32, dec_scale32, dec_agree32 = hold_decode_against_prefill(
        cfg32, params32, prompts, l32p)
    del l32k, l32p
    assert fa_ops.launch_count() == per_fwd_fa       # no kernel in decode
    assert ssd_ops.launch_count() == per_fwd_ssd
    t0 = time.perf_counter()
    params = cast_params(params32, cfg)     # once, as a server would
    del params32
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0

    # -- the served dtype, bf16: prefill of the 8 requests -------------------
    prefill_k = make_prefill_step(cfg, use_kernel=True)
    prefill_p = make_prefill_step(cfg, use_kernel=False)
    t0 = time.perf_counter()
    logits_k = prefill_k(params, prompts)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    with InSituCheck(fa_ops, ssd_ops, 2e-2, 2e-2, 5e-2) as in_situ:
        prefill_k(params, prompts)
    assert in_situ.calls == {"flash_attention": per_fwd_fa,
                             "ssd": per_fwd_ssd}, in_situ.calls
    t0 = time.perf_counter()
    logits_k = prefill_k(params, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits_p = prefill_p(params, prompts)
    torch.cuda.synchronize()
    prefill_plain_s = time.perf_counter() - t0
    # the same plain function with another chunk length (equal in exact
    # arithmetic): how far bf16 rounding alone moves the logits
    logits_p2 = make_prefill_step(cfg.replace(ssm_chunk=cfg.ssm_chunk // 2),
                                  use_kernel=False)(params, prompts)
    torch.cuda.synchronize()
    assert fa_ops.launch_count() == 4 * per_fwd_fa
    assert ssd_ops.launch_count() == 4 * per_fwd_ssd
    assert logits_k.shape == (N_REQUESTS, PROMPT_LEN, cfg.vocab)
    assert all(bool(torch.isfinite(t).all())
               for t in (logits_k, logits_p, logits_p2))
    diff, agree = agreement(logits_k, logits_p)
    floor_diff, floor_agree = agreement(logits_p2, logits_p)
    last_prefill = logits_k[:, -1].float()
    del logits_k, logits_p, logits_p2

    # -- serve: teacher-forced steps over each prompt, then greedy tokens -----
    served = serve_requests(cfg, params, prompts, last_prefill)
    # no kernel on the decode path, as in the reference
    assert fa_ops.launch_count() == 4 * per_fwd_fa
    assert ssd_ops.launch_count() == 4 * per_fwd_ssd

    # -- one long prefill: prefill_32k's length, batch cut from 32 to 1 -------
    # first with every kernel call held in situ against the model's own
    # plain path (`attention_ref`'s S x S scores would not fit), at the
    # tolerances of the requests' bf16 check; then timed, unchecked
    long_plain = {
        "flash_attention": lambda q, k, v, window: flash_mha(
            q, k, v, window=window),
        "ssd": lambda x, dt, a, b, c, chunk: ssd_chunked(x, dt, a, b, c,
                                                         chunk=chunk)}
    with InSituCheck(fa_ops, ssd_ops, 2e-2, 2e-2, 5e-2, plain=long_plain,
                     capture=True) as in_situ_long:
        logits_long = prefill_k(params, long_toks)
    assert in_situ_long.calls == {"flash_attention": per_fwd_fa,
                                  "ssd": per_fwd_ssd}, in_situ_long.calls
    assert bool(torch.isfinite(logits_long).all())
    del logits_long
    t0 = time.perf_counter()
    logits_long = prefill_k(params, long_toks)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    assert logits_long.shape == (LONG_BATCH, PREFILL_32K.seq_len, cfg.vocab)
    assert bool(torch.isfinite(logits_long).all())
    del logits_long
    launches = {"flash_attention": fa_ops.launch_count(),
                "ssd": ssd_ops.launch_count()}
    assert launches == {"flash_attention": 6 * per_fwd_fa,
                        "ssd": 6 * per_fwd_ssd}, launches
    assert scan_ops.launch_count() == 0 and gmm_ops.launch_count() == 0
    # the long prefill's first K2 and K3 calls again, inputs cast to f32,
    # at the f32 tolerances (after the counts: comparison launches); K3's
    # plain version here is the sequential recurrence (~5 s at 32768)
    long_f32 = in_situ_long.hold_captured_f32(1e-5, 1e-5, 1e-4)
    in_situ_long.captured = None
    emit({"phase": "model_path", "model": MODEL, "n_params": n,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "dtype": cfg.dtype,
          "weights": f"random, torch.Generator(cuda).manual_seed({SEED}), "
                     "f32, cast once to bf16 (>=2-D) for serving",
          "init_s": init_s, "cast_s": cast_s,
          "f32_kernel_vs_plain": {"max_abs_logit_diff": diff32,
                                  "argmax_agreement": agree32,
                                  "required_agreement":
                                      MIN_ARGMAX_AGREEMENT},
          "f32_decode_vs_prefill": {"positions": DECODE_CHECK_LEN,
                                    "max_abs_logit_diff": dec_diff32,
                                    "max_abs_prefill_logit": dec_scale32,
                                    "tol_over_max_logit": DECODE_TOL,
                                    "argmax_agreement": dec_agree32,
                                    "required_agreement":
                                        MIN_ARGMAX_AGREEMENT},
          "in_situ_f32": {"calls": in_situ32.calls,
                          "max_err_over_max_plain": in_situ32.worst,
                          "tol": {"flash_attention": 1e-5, "ssd_y": 1e-5,
                                  "ssd_h": 1e-4}},
          "in_situ_bf16": {"calls": in_situ.calls,
                           "max_err_over_max_plain": in_situ.worst,
                           "tol": {"flash_attention": 2e-2, "ssd_y": 2e-2,
                                   "ssd_h": 5e-2}},
          "requests": {"batch": N_REQUESTS, "prompt_len": PROMPT_LEN,
                       "gen_len": GEN_LEN,
                       "prefill_first_call_s": prefill_first_s,
                       "prefill_s": prefill_s,
                       "prefill_tokens_per_s":
                           N_REQUESTS * PROMPT_LEN / prefill_s,
                       "prefill_plain_s": prefill_plain_s,
                       "kernel_vs_plain_max_abs_logit_diff": diff,
                       "kernel_vs_plain_argmax_agreement": agree,
                       "plain_chunk_halved_vs_plain_max_abs_logit_diff":
                           floor_diff,
                       "plain_chunk_halved_vs_plain_argmax_agreement":
                           floor_agree, **served},
          "long_prefill": {"batch": LONG_BATCH,
                           "seq_len": PREFILL_32K.seq_len,
                           "cut": f"{PREFILL_32K.name} batch "
                                  f"{PREFILL_32K.global_batch} -> "
                                  f"{LONG_BATCH}",
                           "seconds": long_s,
                           "tokens_per_s": LONG_BATCH * PREFILL_32K.seq_len
                           / long_s,
                           "in_situ_bf16": {
                               "plain": "flash_mha, ssd_chunked",
                               "calls": in_situ_long.calls,
                               "max_err_over_max_plain": in_situ_long.worst,
                               "tol": {"flash_attention": 2e-2,
                                       "ssd_y": 2e-2, "ssd_h": 5e-2}},
                           "first_calls_f32": {
                               "plain": "flash_mha, ssd_ref (sequential)",
                               "max_err_over_max_plain": long_f32,
                               "tol": {"flash_attention": 1e-5,
                                       "ssd_y": 1e-5, "ssd_h": 1e-4}}},
          "launches_per_prefill": {"flash_attention": per_fwd_fa,
                                   "ssd": per_fwd_ssd},
          "kernel_launches": launches, "prefill_forwards_with_kernels": 6,
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    del params
    torch.cuda.empty_cache()
    di = cfg.d_inner
    return launches, {
        "fa": {"long": (LONG_BATCH, PREFILL_32K.seq_len, cfg.n_heads,
                        cfg.n_kv_heads, cfg.head_dim, cfg.window),
               "request": (N_REQUESTS, PROMPT_LEN, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.window)},
        "ssd": {"long": (LONG_BATCH, PREFILL_32K.seq_len, cfg.ssm_heads,
                         di // cfg.ssm_heads, cfg.ssm_state, cfg.ssm_chunk),
                "request": (N_REQUESTS, PROMPT_LEN, cfg.ssm_heads,
                            di // cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_chunk)}}


@contextlib.contextmanager
def plain_kernel_versions(fa_ops, gmm_ops):
    """Within the `with`, the model's K2 and K4 calls take the wrappers'
    plain versions (`attention_ref`, `expert_ffn_ref`, all in f32): the
    function of the model's plain path, rounded at other places. They
    launch nothing and count nothing."""
    fa, gmm = fa_ops.flash_attention, gmm_ops.expert_ffn
    fa_ops.flash_attention = lambda q, k, v, *, causal=True, window=0, \
        use_kernel: fa(q, k, v, causal=causal, window=window,
                       use_kernel=False)
    gmm_ops.expert_ffn = lambda x, wg, wu, wd, *, use_kernel: gmm(
        x, wg, wu, wd, use_kernel=False)
    try:
        yield
    finally:
        fa_ops.flash_attention, gmm_ops.expert_ffn = fa, gmm


def phase_moe_path(fa_ops, ssd_ops, gmm_ops, scan_ops):
    """mixtral-8x22b at full width, depth cut to MOE_LAYERS, through the
    serving entry points: a 2-layer f32 copy (kernel vs plain path, f32
    serve steps vs the f32 prefill), then the bf16 model serving 8
    requests and one 32768-token prefill, every K2 and K4 call of one
    forward per shape held in situ. Returns (launches per kernel, the
    shapes the kernels met)."""
    from repro_torch import configs
    from repro_torch.models import PREFILL_32K, init, n_params, padded_vocab
    from repro_torch.kernels.moe_gmm.ref import expert_ffn_ref
    from repro_torch.models.moe import capacity, expert_ffn_einsum
    from repro_torch.models.transformer import flash_mha
    from repro_torch.train.step import make_prefill_step

    full = configs.get(MOE_MODEL)
    cfg = full.replace(n_layers=MOE_LAYERS)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (N_REQUESTS, PROMPT_LEN))).to(dev)
    long_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LONG_BATCH, PREFILL_32K.seq_len))).to(dev)
    torch.cuda.reset_peak_memory_stats()
    reset_counts((fa_ops, ssd_ops, gmm_ops, scan_ops))
    L, L32 = cfg.n_layers, MOE_F32_LAYERS

    def counts():
        return {"flash_attention": fa_ops.launch_count(),
                "moe_gmm": gmm_ops.launch_count()}

    # -- f32 (no TF32), 2 layers at full width: kernel path vs plain path on
    # the 8 prompts, every kernel call held in situ; then f32 serve steps
    # held against the f32 prefill
    cfg32 = cfg.replace(n_layers=L32, dtype="float32")
    t0 = time.perf_counter()
    p32 = init(torch.Generator(device=dev).manual_seed(SEED), cfg32,
               dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    init32_s = time.perf_counter() - t0
    # K4 is held against its plain version evaluated in f64 (the f32
    # evaluation by cuBLAS strays ~6e-6 of the scale at this width)
    f64_plain = {"moe_gmm": lambda x, wg, wu, wd: expert_ffn_ref(
        *(t.double() for t in (x, wg, wu, wd)))}
    with InSituCheck(fa_ops, ssd_ops, 1e-5, 1e-5, 1e-4, plain=f64_plain,
                     gmm_ops=gmm_ops, gmm_tol=1e-5) as in_situ32:
        l32k = make_prefill_step(cfg32, use_kernel=True)(p32, prompts)
    l32p = make_prefill_step(cfg32, use_kernel=False)(p32, prompts)
    torch.cuda.synchronize()
    assert in_situ32.calls == {"flash_attention": L32, "ssd": 0,
                               "moe_gmm": L32}, in_situ32.calls
    assert counts() == {"flash_attention": L32, "moe_gmm": L32}, counts()
    assert bool(torch.isfinite(l32k).all()) and bool(torch.isfinite(l32p).all())
    diff32, agree32 = agreement(l32k, l32p)
    assert agree32 >= MIN_ARGMAX_AGREEMENT, agree32
    dec_diff32, dec_scale32, dec_agree32 = hold_decode_against_prefill(
        cfg32, p32, prompts, l32p)
    # K4 in every decode step, K2 in none
    f32_counts = {"flash_attention": L32,
                  "moe_gmm": L32 + DECODE_CHECK_LEN * L32}
    assert counts() == f32_counts, counts()
    del p32, l32k, l32p
    torch.cuda.empty_cache()

    # -- the served model: 8 layers in bf16, drawn slice by slice ------------
    t0 = time.perf_counter()
    params = init(torch.Generator(device=dev).manual_seed(SEED), cfg,
                  dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in _leaves(params))
    assert n == n_params(cfg), (n, n_params(cfg))
    prefill_k = make_prefill_step(cfg, use_kernel=True)
    prefill_p = make_prefill_step(cfg, use_kernel=False)
    t0 = time.perf_counter()
    logits_k = prefill_k(params, prompts)
    torch.cuda.synchronize()
    prefill_first_s = time.perf_counter() - t0
    with InSituCheck(fa_ops, ssd_ops, 2e-2, 2e-2, 5e-2, gmm_ops=gmm_ops,
                     gmm_tol=2e-2) as in_situ:
        prefill_k(params, prompts)
    assert in_situ.calls == {"flash_attention": L, "ssd": 0, "moe_gmm": L}, \
        in_situ.calls
    t0 = time.perf_counter()
    logits_k = prefill_k(params, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits_p = prefill_p(params, prompts)
    torch.cuda.synchronize()
    prefill_plain_s = time.perf_counter() - t0
    # the kernels' plain versions in place of the kernels: the plain
    # path's function rounded at other places (f32 products)
    with plain_kernel_versions(fa_ops, gmm_ops):
        logits_w = prefill_k(params, prompts)
    torch.cuda.synchronize()
    expect = {k: v + 3 * L for k, v in f32_counts.items()}
    assert counts() == expect, (counts(), expect)
    assert logits_k.shape == (N_REQUESTS, PROMPT_LEN, padded_vocab(cfg.vocab))
    assert all(bool(torch.isfinite(t).all())
               for t in (logits_k, logits_p, logits_w))
    diff, agree = agreement(logits_k, logits_p)
    floor_diff, floor_agree = agreement(logits_w, logits_p)
    last_prefill = logits_k[:, -1].float()
    del logits_k, logits_p, logits_w

    # -- serve: teacher-forced steps over each prompt, then greedy tokens -----
    served = serve_requests(cfg, params, prompts, last_prefill)
    steps = served["serve_steps"]
    expect["moe_gmm"] += steps * L            # K4 in every decode step
    assert counts() == expect, (counts(), expect)

    # -- one long prefill: prefill_32k's length, batch cut from 32 to 1 -------
    # held in situ against the model's own plain path (flash_mha, the three
    # bf16 einsums: `attention_ref`'s S x S scores and `expert_ffn_ref`'s
    # f32 intermediates, 5.4 GB each, are not what the model runs there)
    long_plain = {
        "flash_attention": lambda q, k, v, window: flash_mha(
            q, k, v, window=window),
        "moe_gmm": lambda x, wg, wu, wd: expert_ffn_einsum(
            x[None], wg, wu, wd)[0]}
    with InSituCheck(fa_ops, ssd_ops, 2e-2, 2e-2, 5e-2, plain=long_plain,
                     gmm_ops=gmm_ops, gmm_tol=2e-2) as in_situ_long:
        logits_long = prefill_k(params, long_toks)
    assert in_situ_long.calls == {"flash_attention": L, "ssd": 0,
                                  "moe_gmm": L}, in_situ_long.calls
    assert bool(torch.isfinite(logits_long).all())
    del logits_long
    t0 = time.perf_counter()
    logits_long = prefill_k(params, long_toks)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    assert logits_long.shape == (LONG_BATCH, PREFILL_32K.seq_len,
                                 padded_vocab(cfg.vocab))
    assert bool(torch.isfinite(logits_long).all())
    del logits_long
    expect = {k: v + 2 * L for k, v in expect.items()}
    launches = counts()
    assert launches == expect, (launches, expect)
    assert ssd_ops.launch_count() == 0 and scan_ops.launch_count() == 0
    peak = torch.cuda.max_memory_allocated()
    E = cfg.n_experts
    emit({"phase": "moe_path", "model": MOE_MODEL, "n_params": n,
          "n_layers": L, "n_layers_published": full.n_layers,
          "cut": f"depth {full.n_layers} -> {L} layers (full width)",
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
          "n_experts": E, "top_k": cfg.top_k, "d_ff": cfg.d_ff,
          "window": cfg.window, "vocab": cfg.vocab, "dtype": cfg.dtype,
          "weights": f"random, torch.Generator(cuda).manual_seed({SEED}), "
                     "drawn in bf16 slice by slice",
          "init_s": init_s,
          "capacity": {"request": capacity(cfg, N_REQUESTS * PROMPT_LEN),
                       "decode": capacity(cfg, N_REQUESTS),
                       "long": capacity(cfg, LONG_BATCH *
                                        PREFILL_32K.seq_len)},
          "f32_copy": {"n_layers": L32, "init_s": init32_s,
                       "kernel_vs_plain_max_abs_logit_diff": diff32,
                       "kernel_vs_plain_argmax_agreement": agree32,
                       "required_agreement": MIN_ARGMAX_AGREEMENT,
                       "in_situ": {"calls": in_situ32.calls,
                                   "max_err_over_max_plain": in_situ32.worst,
                                   "plain": "attention_ref; expert_ffn_ref "
                                            "in f64",
                                   "tol": {"flash_attention": 1e-5,
                                           "moe_gmm": 1e-5}},
                       "decode_vs_prefill": {
                           "positions": DECODE_CHECK_LEN,
                           "max_abs_logit_diff": dec_diff32,
                           "max_abs_prefill_logit": dec_scale32,
                           "tol_over_max_logit": DECODE_TOL,
                           "argmax_agreement": dec_agree32}},
          "in_situ_bf16": {"calls": in_situ.calls,
                           "max_err_over_max_plain": in_situ.worst,
                           "tol": {"flash_attention": 2e-2,
                                   "moe_gmm": 2e-2}},
          "requests": {"batch": N_REQUESTS, "prompt_len": PROMPT_LEN,
                       "gen_len": GEN_LEN,
                       "prefill_first_call_s": prefill_first_s,
                       "prefill_s": prefill_s,
                       "prefill_tokens_per_s":
                           N_REQUESTS * PROMPT_LEN / prefill_s,
                       "prefill_plain_s": prefill_plain_s,
                       "kernel_vs_plain_max_abs_logit_diff": diff,
                       "kernel_vs_plain_argmax_agreement": agree,
                       "plain_versions_vs_plain_max_abs_logit_diff":
                           floor_diff,
                       "plain_versions_vs_plain_argmax_agreement":
                           floor_agree, **served},
          "long_prefill": {"batch": LONG_BATCH,
                           "seq_len": PREFILL_32K.seq_len,
                           "cut": f"{PREFILL_32K.name} batch "
                                  f"{PREFILL_32K.global_batch} -> "
                                  f"{LONG_BATCH}",
                           "seconds": long_s,
                           "tokens_per_s": LONG_BATCH * PREFILL_32K.seq_len
                           / long_s,
                           "in_situ_bf16": {
                               "plain": "flash_mha, expert_ffn_einsum",
                               "calls": in_situ_long.calls,
                               "max_err_over_max_plain": in_situ_long.worst,
                               "tol": {"flash_attention": 2e-2,
                                       "moe_gmm": 2e-2}}},
          "launches_per_prefill": {"flash_attention": L, "moe_gmm": L},
          "launches_per_decode_step": {"flash_attention": 0, "moe_gmm": L},
          "kernel_launches": launches,
          "peak_device_bytes": peak})
    del params
    torch.cuda.empty_cache()
    d, f = cfg.d_model, cfg.d_ff
    return launches, {
        "moe_gmm": {"long": (E, capacity(cfg, LONG_BATCH * PREFILL_32K.seq_len),
                             d, f),
                    "request": (E, capacity(cfg, N_REQUESTS * PROMPT_LEN), d, f),
                    "decode": (E, capacity(cfg, N_REQUESTS), d, f)},
        "fa": {"long": (LONG_BATCH, PREFILL_32K.seq_len, cfg.n_heads,
                        cfg.n_kv_heads, cfg.head_dim, cfg.window),
               "request": (N_REQUESTS, PROMPT_LEN, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, cfg.window)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def fa_cost(B, S, H, K, hd, window):
    """(FLOP, bytes) the causal attention needs: 2 * 2 * hd per (query,
    visible key) pair (QK^T and PV), q, k, v read once and o written
    once in bf16."""
    if window > 0:
        pairs = sum(min(t + 1, window) for t in range(S))
    else:
        pairs = S * (S + 1) // 2
    return 4 * hd * B * H * pairs, 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)


def ssd_cost(B, S, H, P, N, chunk):
    """(FLOP, bytes) the chunked SSD needs: per chunk of L steps, C B^T
    over s <= t once per batch row (b and c are shared by the heads),
    then per head the decay weights and their product with x*dt, the
    carried-state term and the state update; x, b, c read and y written
    in bf16, dt, a read and h written in f32."""
    L = min(chunk, S)
    nc = S // L
    tri = L * (L + 1) // 2
    flops = B * nc * tri * 2 * N + \
        B * H * nc * (tri * (1 + 2 * P) + 4 * L * N * P)
    nbytes = 2 * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H) \
        + 4 * B * H * N * P
    return flops, nbytes


def gmm_cost(GE, E, C, d, f):
    """(FLOP, bytes) the grouped expert FFN needs: three products of
    2 C d f per group; x, the three weight tensors and out moved once in
    bf16."""
    return 6 * GE * C * d * f, 2 * (2 * GE * C * d + 3 * E * d * f)


def bound(flops, nbytes):
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def model_kernel_entries(fa_ops, ssd_ops, launches, shapes, worst):
    """The kernels-line entries of flash_attention and ssd: each kernel at
    the long-prefill shape (ms, bound, library call) and at the request
    shape (ms, bound, plain version, library call), by CUDA events.
    These launches are not the main path's and are not counted in it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf16 = torch.bfloat16
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(q, k, v, is_causal):
        # the fused backends only: the math one would build S x S scores
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=is_causal)
    entries = []

    B, S, H, K, hd, win = shapes["fa"]["long"]
    assert win == 0, "the library yardstick below is full causal"
    q, k, v = fa_inputs(B, S, H, K, hd, bf16, gen)
    fa_long = cuda_time_ms(lambda: fa_ops.flash_attention(
        q, k, v, window=win, use_kernel=True), reps=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_long = cuda_time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=2)
    b_long, by_long = bound(*fa_cost(B, S, H, K, hd, win))
    del q, k, v, qt, kt, vt
    B2, S2, H2, K2, hd2, win2 = shapes["fa"]["request"]
    q, k, v = fa_inputs(B2, S2, H2, K2, hd2, bf16, gen)
    fa_req = cuda_time_ms(lambda: fa_ops.flash_attention(
        q, k, v, window=win2, use_kernel=True), reps=10)
    plain_req = cuda_time_ms(lambda: fa_ops.flash_attention(
        q, k, v, window=win2, use_kernel=False), reps=10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_req = cuda_time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps=10)
    err = check_close("flash_attention at the request shape",
                      fa_ops.flash_attention(q, k, v, window=win2,
                                             use_kernel=True),
                      fa_ops.flash_attention(q, k, v, window=win2,
                                             use_kernel=False), 2e-2, 2e-2)
    b_req, _ = bound(*fa_cost(B2, S2, H2, K2, hd2, win2))
    entries.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:89",
        "launches": launches["flash_attention"],
        "max_abs_err": max(worst["flash_attention"], err),
        "shape_b_s_h_k_hd": [B, S, H, K, hd], "dtype": "bfloat16",
        "ms": fa_long, "bound_ms": b_long, "bound_by": by_long,
        "library_ms": lib_long,
        "library_call": "torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True), timed as a yardstick only",
        "plain_ms": plain_req,
        "plain_shape_b_s_h_k_hd": [B2, S2, H2, K2, hd2],
        "ms_at_plain_shape": fa_req, "bound_ms_at_plain_shape": b_req,
        "library_ms_at_plain_shape": lib_req})
    del q, k, v, qt, kt, vt

    B, S, H, P, N, chunk = shapes["ssd"]["long"]
    x, dt, a, b, c = ssd_inputs(B, S, H, P, N, bf16, gen)
    ssd_long = cuda_time_ms(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk, use_kernel=True), reps=5)
    b_long, by_long = bound(*ssd_cost(B, S, H, P, N, chunk))
    del x, dt, a, b, c
    B2, S2, H2, P2, N2, chunk2 = shapes["ssd"]["request"]
    x, dt, a, b, c = ssd_inputs(B2, S2, H2, P2, N2, bf16, gen)
    ssd_req = cuda_time_ms(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk2, use_kernel=True), reps=10)
    # the plain version is S2 sequential steps of a few launches each
    plain_req = cuda_time_ms(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk2, use_kernel=False), reps=1)
    y1, h1 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk2, use_kernel=True)
    y0, h0 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk2, use_kernel=False)
    err = max(check_close("ssd y at the request shape", y1, y0, 2e-2, 2e-2),
              check_close("ssd h at the request shape", h1, h0, 5e-2, 5e-2))
    b_req, _ = bound(*ssd_cost(B2, S2, H2, P2, N2, chunk2))
    entries.append({
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:86",
        "launches": launches["ssd"],
        "max_abs_err": max(worst["ssd"], err),
        "shape_b_s_h_p_n_chunk": [B, S, H, P, N, chunk], "dtype": "bfloat16",
        "ms": ssd_long, "bound_ms": b_long, "bound_by": by_long,
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the chunked "
                        "SSD scan",
        "plain_ms": plain_req,
        "plain_shape_b_s_h_p_n_chunk": [B2, S2, H2, P2, N2, chunk2],
        "ms_at_plain_shape": ssd_req, "bound_ms_at_plain_shape": b_req})
    return entries


def moe_kernel_entries(fa_ops, gmm_ops, launches, shapes, worst):
    """The kernels-line entry of moe_gmm at mixtral-8x22b's three
    capacities (the long prefill's, the requests', a decode step's): ms
    beside the bound and beside three `torch.bmm` (cuBLAS) with the
    elementwise silu * u between them, a yardstick that is not one call;
    the plain version (`expert_ffn_ref`, f32) at the requests' capacity.
    Also flash_attention at mixtral's two prefill shapes (sliding window
    4096, hd 128, GQA 48/8), returned for K2's entry. By CUDA events; these
    launches are not the main path's and are not counted in it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    E, C_long, d, f = shapes["moe_gmm"]["long"]
    _, wg, wu, wd = gmm_inputs(E, E, 8, d, f, bf16, gen, True)

    def bmm3(x):
        g = torch.bmm(x, wg)
        u = torch.bmm(x, wu)
        return torch.bmm(torch.nn.functional.silu(g) * u, wd)

    at = {}
    for name, reps in (("decode", 20), ("request", 5), ("long", 2)):
        _, C, _, _ = shapes["moe_gmm"][name]
        x = torch.randn((E, C, d), generator=gen, device="cuda").to(bf16)
        ms = cuda_time_ms(lambda: gmm_ops.expert_ffn(x, wg, wu, wd,
                                                     use_kernel=True), reps)
        bmm_ms = cuda_time_ms(lambda: bmm3(x), reps)
        b, by = bound(*gmm_cost(E, E, C, d, f))
        at[name] = {"shape_ge_c_d_f": [E, C, d, f], "ms": ms,
                    "bound_ms": b, "bound_by": by, "three_bmm_ms": bmm_ms}
        if name == "request":
            plain_ms = cuda_time_ms(lambda: gmm_ops.expert_ffn(
                x, wg, wu, wd, use_kernel=False), reps=2)
            err = check_close("moe_gmm at the requests' capacity",
                              gmm_ops.expert_ffn(x, wg, wu, wd,
                                                 use_kernel=True),
                              gmm_ops.expert_ffn(x, wg, wu, wd,
                                                 use_kernel=False),
                              2e-2, 2e-2)
        del x
    del wg, wu, wd
    entry = {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:53",
        "launches": launches["moe_gmm"],
        "max_abs_err": max(worst["moe_gmm"], err), "dtype": "bfloat16",
        "shape_ge_c_d_f": at["long"]["shape_ge_c_d_f"],
        "ms": at["long"]["ms"], "bound_ms": at["long"]["bound_ms"],
        "bound_by": at["long"]["bound_by"], "library_ms": None,
        "library_call": "none: no single PyTorch call computes the grouped "
                        "SwiGLU FFN; three_bmm_ms times three torch.bmm "
                        "with silu(g) * u between them, as a yardstick only",
        "three_bmm_ms": at["long"]["three_bmm_ms"],
        "plain_ms": plain_ms,
        "plain_shape_ge_c_d_f": at["request"]["shape_ge_c_d_f"],
        "ms_at_plain_shape": at["request"]["ms"],
        "bound_ms_at_plain_shape": at["request"]["bound_ms"],
        "three_bmm_ms_at_plain_shape": at["request"]["three_bmm_ms"],
        "decode": at["decode"]}

    fa_extra = {}
    for name, reps in (("long", 2), ("request", 10)):
        B, S, H, K, hd, win = shapes["fa"][name]
        q, k, v = fa_inputs(B, S, H, K, hd, bf16, gen)
        fa_ms = cuda_time_ms(lambda: fa_ops.flash_attention(
            q, k, v, window=win, use_kernel=True), reps=reps)
        b, by = bound(*fa_cost(B, S, H, K, hd, win))
        del q, k, v
        fa_extra[f"mixtral_{name}"] = {
            "shape_b_s_h_k_hd_window": [B, S, H, K, hd, win], "ms": fa_ms,
            "bound_ms": b, "bound_by": by}
    return entry, fa_extra


def kernels_line(ops_mod, launches, timing, max_abs_err, model_entries):
    """Time sweep_scan on the main path's own buckets and print the
    kernels line: the kernel at the largest bucket beside its bounds,
    and kernel and plain version side by side (and compared) at the
    largest bucket the plain version can walk; then the model path's
    kernels (`model_kernel_entries`)."""
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
        "library_ms": None}] + model_entries})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script does not run on the CPU", file=sys.stderr)
        return 1
    from repro_torch import core, env
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.sweep_scan import kernel as kernel_mod
    from repro_torch.kernels.sweep_scan import ops as ops_mod
    assert "jax" not in sys.modules and "repro" not in sys.modules

    t_start = time.perf_counter()
    phase_env(env)
    phase_build([kernel_mod, fa_kernel, ssd_kernel, gmm_kernel])
    max_abs_err = phase_kernel_check(ops_mod, kernel_mod)
    model_worst = phase_model_kernel_check(fa_ops, ssd_ops, gmm_ops)
    # each path is driven with every launch count at 0 just before it
    reset_counts((ops_mod, fa_ops, ssd_ops, gmm_ops))
    launches, timing = phase_main_path(core, ops_mod)
    assert (fa_ops.launch_count(), ssd_ops.launch_count(),
            gmm_ops.launch_count()) == (0, 0, 0)
    phase_exact_path(core)
    model_launches, model_shapes = phase_model_path(fa_ops, ssd_ops, gmm_ops,
                                                    ops_mod)
    moe_launches, moe_shapes = phase_moe_path(fa_ops, ssd_ops, gmm_ops,
                                              ops_mod)
    # K2 runs on both serving paths: its launches are the two counts
    by_path = {"model_path": model_launches["flash_attention"],
               "moe_path": moe_launches["flash_attention"]}
    model_launches["flash_attention"] = sum(by_path.values())
    model_entries = model_kernel_entries(fa_ops, ssd_ops, model_launches,
                                         model_shapes, model_worst)
    gmm_entry, fa_moe = moe_kernel_entries(fa_ops, gmm_ops, moe_launches,
                                           moe_shapes, model_worst)
    model_entries[0].update(fa_moe, launches_by_path=by_path)
    kernels_line(ops_mod, launches, timing, max_abs_err,
                 model_entries + [gmm_entry])
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
