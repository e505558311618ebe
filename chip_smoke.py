#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and nothing from the network; imports
`repro_torch` only. It exits non-zero, printing no result, when no card
is present or when any phase fails (no phase's exception is caught and
passed over, nothing carries on on the CPU). Each phase prints one JSON
line:

  env          what the host offers (card, capability, power limit,
               torch / CUDA / nvcc versions, CPU count and affinity)
  build        seconds `nvcc` took to build each kernel library
               (sweep_scan, flash_attention, ssd, moe_gmm) from the
               sources in this checkout, one `nvcc` per source, all
               started together
  kernel_check sweep_scan kernel vs its plain PyTorch version ON THE
               CARD, `torch.equal` on makespan and end (tolerance: none,
               the arithmetic is max and + in f64 in one order), over
               boundary and multi-tile shapes and rows whose deps sit at
               every hand-over point of the kernel's tile schedule, in
               the shared-memory and the device-memory regime, healthy
               and with 1e30 durations; and with negative, -0.0,
               infinite and NaN durations and lags (the kernel's general
               walk), NaN where the plain version's is NaN
  main_path    the paper's Scenario I at paper scale through the normal
               entry points: BLAST with the 1710 MB database on a
               20-node cluster, a grid over partitioning x chunk size x
               stripe width swept by `explore` on a `SweepSession`, then
               the same grid crossed with a fault scenario and
               replication; counters (K1's launches counted in the
               session's `CacheStats`), one full-size row recomputed by a
               scalar loop on the host, a warm re-sweep
  backends_path the main path's BLAST grid through the other two
               backends, held to the bit against main_path's inline
               makespans: (a) `MultiprocBackend(W)` with W worker
               processes on the card (W from the CPU affinity), cold:
               fresh workers, a fresh DAG cache on an empty directory;
               wall seconds including the fleet's spawn, each worker's
               compile_or_load / host-prep / device seconds from the
               absorbed spans, worker rows and compiles (summing to the
               grid's structural classes), no fallback, no late drop,
               K1's launches rolled up from the workers, the K1 library
               left unbuilt by the workers; (b) the same sweep again on
               the warm fleet: 0 worker compiles; (c) `ShardedBackend(0)`
               on a fresh engine over the main path's DAG cache (one
               card: no mesh, the shard slot of every key 1), then
               `ShardedBackend([cuda:0, cuda:0], min_shard_oprows=0)`:
               every bucket split in two on the one card, both slots
               counted (this tests the split; it measures nothing about
               multi-GPU speed)
  advisor_path the advisor path on the main path's warm session: sysid
               (`identify` at probe_mb=8, file_mb=8, seed 7: seconds and
               `params_digest`); `explore(timeline_top_k=3)` on the BLAST
               grid, each timeline's makespan and `end` equal to the bit
               to the scalar host loop and its critical path equal to
               its makespan (rel 1e-9), one written as a Perfetto trace
               under build/chip_smoke/; an `AdvisorServer` on that
               session answering 8 tenants' concurrent requests over 2
               questions (the BLAST grid, asked as one request per
               app-node count since a request names one workflow; a
               generated fan_out workflow), one sweep per distinct
               request and the rest coalesced, answers equal to a direct
               `explore`, repeats from the results cache with no compile
               and no simulator call, one invalidation after the storage
               rate doubles; one checkpoint plan; the generated grid's
               best row and the plan's winner held to the bit against
               K1's plain version on the card. No K1 fallback
  fixture_sweep the three `examples/traces/` fixtures read by the port's
               own readers, each swept over a 9-node grid on the card,
               one full-size row of each equal to the bit to the scalar
               host loop; fingerprints, best makespans, no K1 fallback
  exact_path   `explore` with exact verification on a small sweep, held
               against the port's `ref_sim`; `Predictor` ref vs exact
  model_kernel_check  flash_attention, ssd and moe_gmm kernels vs their
               plain PyTorch versions ON THE CARD, f32 and bf16, on the
               reference's kernel-test shapes, zamba2-2.7b's (for ssd
               also at 4096 tokens: more row-chunks than SMs), and
               mixtral-8x22b's and qwen3-moe-235b-a22b's expert shapes,
               and the tensor-core kernels' edges (ragged S, windows of
               1, 63 and 4096 keys, GQA 6:1, C = 1 and 65); two bf16
               moe_gmm calls must be `torch.equal`
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
  train_path   the training path: (a) granite-3-2b at full width and
               depth (40 layers, 2.63e9 parameters in f32, bf16 compute,
               remat), 10 AdamW steps on one fixed 8 x 512 batch from
               the port's DataPipeline: loss and grad norm finite, the
               last 3 steps' mean loss below the first's, no K2-K4
               launch; ms a step (host clock), forward+backward and
               update (CUDA events), tokens/s, peak device bytes, and
               one step more under torch.profiler (device time by
               kernel class, the device's idle share); (b)
               one f32 train step on the card against the same step on
               the CPU, depth cut 40 -> 2, TF32 off (loss rtol 1e-5, grad
               norm rtol 1e-4, parameters atol 1e-6 + 1e-3 lr); (c)
               `train_loop` at full width, depth cut 40 -> 2, 8 steps of
               8 x 512, a checkpoint every 4 steps into the store planned
               by `plan_checkpoint` (27 candidates through K1 on the
               default session, the winner held to the bit against K1's
               plain version), a fault at step 6, the restored state
               `torch.equal` to the state saved at step 4; plan, write
               and restore seconds, bytes written
  {"kernels": [...]}  one entry per kernel: launches counted during its
               paths (K1's by path: main_path, backends_path,
               advisor_path, fixture_sweep, train_path), its time at the path's largest shape beside its
               bound, the plain version's time beside the kernel's at a
               shape the plain version can take, and a library call's
               time where one PyTorch call computes the same function
               (for flash_attention also at mixtral's windowed shapes);
               yardsticks that are several calls are named apart (ssd:
               the model's plain chunked path; moe_gmm: three bmm), ssd's
               allocation peak of one call is measured, and sweep_scan's
               one-candidate chain sits beside the latency of one
               dependent step through shared memory (a point of
               comparison, not a bound: the chain forwards in registers)
               and the general walk's time at the largest shape
  <card name, power limit>   as nvidia-smi prints them
  {"ok": true, "device": {...}}   the last line
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import shutil
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
# values the kernel's general walk is checked on (phase kernel_check)
SPECIAL_VALUES = (-0.5, -1e-300, -0.0, float("nan"), float("inf"),
                  -float("inf"))

# the advisor path (phase advisor_path), on the main path's warm session:
# sysid at the reference test's probe settings; timelines for the grid's
# three best candidates; 8 tenants asking 2 questions of one server (the
# BLAST grid, one request per app-node count, and the generated workflow
# examples/advisor_server.py asks about on its grid); one checkpoint plan for zamba2-2.7b's bf16 weights
# (2.7e9 parameters) written by 8 of 9 hosts
SYSID_PROBE_MB, SYSID_SEED = 8, 7
ADVISOR_TIMELINES = 3
ADVISOR_TENANTS = 8
ADVISOR_WINDOW_S = 0.05
GEN_SPEC = {"family": "fan_out", "depth": 2, "width": 5}
GEN_SEED = 3
GEN_GRID = {"n_nodes": [9], "partitions": [(2, 6), (4, 4)],
            "chunk_sizes": [512 * 1024, 1 << 20]}
CKPT_BYTES = 2 * 2_700_000_000
CKPT_HOSTS = 9
# the shipped trace fixtures (phase fixture_sweep), swept on a 9-node grid
TRACES = ROOT / "examples" / "traces"
FIXTURES = ("montage_small.json", "blast_small.json", "cycles_small.dax")
FIXTURE_GRID = {"n_nodes": [9], "chunk_sizes": [256 * 1024, 1 << 20, 4 << 20],
                "stripe_widths": (0, 2)}
# where the phase writes its Perfetto trace (ignored by git)
BUILD_DIR = ROOT / "build" / "chip_smoke"

# DAGs the main path's session keeps (more than its two grids hold)
MAIN_DAG_CACHE = 1024
# the multi-process sweep (phase backends_path): worker processes from
# the CPUs this process may run on, half of them (the parent and the
# card's host work keep the rest), at least 2, at most 8; a deadline per
# work item far above an item's seconds, so a hung worker fails the
# phase (as a fallback) instead of hanging the script
MAX_WORKERS = 8
ITEM_TIMEOUT_S = 600.0

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
# (n_ops, n_cand, n_res, seed): rows whose deps sit where the kernel's
# schedule changes hands (`adversarial_bucket`), over several 256-row tiles
ADVERSARIAL = [(1100, 3, 5, 0), (2053, 2, 7, 1)]

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
# (B, S, H, K, hd, window): tests/test_kernels.py's flash-attention rows,
# zamba2's request shape, and the tensor-core kernel's edges: S no multiple
# of the 64-row tiles, windows of 1 and 63 keys, mixtral's window 4096 at
# S = 4160 (one tile past it) with GQA 6:1 at hd 128, hd 80 at S = 100
FA_CHECK = [(2, 256, 4, 2, 64, 0), (1, 128, 4, 4, 32, 0),
            (2, 256, 8, 2, 64, 64), (1, 512, 2, 1, 128, 128),
            (3, 192, 6, 3, 16, 0), (2, 512, 32, 32, 80, 0),
            (1, 200, 6, 1, 128, 0), (1, 300, 4, 2, 64, 1),
            (1, 300, 4, 2, 64, 63), (1, 4160, 12, 2, 128, 4096),
            (1, 100, 4, 4, 80, 0)]
# (B, S, H, P, N, chunk): tests/test_kernels.py's SSD rows and zamba2's,
# the last at 4096 tokens: 16 chunks x 80 heads = 1280 row-chunks, more
# than the 132 SMs hold at once
SSD_CHECK = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 16, 8, 64),
             (2, 96, 3, 8, 4, 32), (1, 64, 8, 64, 32, 64),
             (2, 512, 80, 64, 64, 256), (1, 4096, 80, 64, 64, 256)]
# (G, E, C, d, f, drawn at the model's scale): tests/test_kernels.py's
# moe_gmm rows (d = 16, f = 48 among them); mixtral-8x22b's capacity at
# 8 x 512 prompt tokens and in decode (batch 8); qwen3-moe-235b-a22b's at
# 8 x 512 (C = 320, no multiple of 128: the reference's kernel refuses it)
# with 128 experts; the bf16 kernel's edges: C = 1 at full width, C = 65
# (one slot past the 64-row tile, 128-row tiles then)
GMM_CHECK = [(1, 4, 64, 32, 64, False), (2, 2, 128, 64, 128, False),
             (1, 8, 32, 16, 48, False), (4, 2, 64, 128, 64, False),
             (1, 8, 1280, 6144, 16384, True), (1, 8, 8, 6144, 16384, True),
             (1, 128, 320, 4096, 1536, True), (1, 8, 1, 6144, 16384, True),
             (2, 4, 65, 256, 384, False)]

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

# the training path: granite-3-2b (the reference's training architecture)
# at full width and depth, 40 layers, 2.63e9 parameters in f32 with bf16
# compute and remat: parameters, gradients and the two AdamW moments are
# 42 GB, so it trains on one 80 GB card uncut. (a) TRAIN_STEPS steps on
# one fixed 8 x 512 batch from the port's DataPipeline (4 shards), the
# AdamW defaults but a warmup of 2 steps; (b) one f32 step on the card
# against the same step on the CPU at full width, depth cut 40 -> 2, on a
# 1 x 128 batch; (c) the driver, `train_loop`, at full width, depth cut
# 40 -> 2 (0.32e9 parameters, a 3.9 GB state, which every checkpoint
# copies to the host), 8 steps of 8 x 512 with a checkpoint every 4
# steps, a fault at step 6 and the predictor-planned store under
# build/chip_smoke/train/
TRAIN_MODEL = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SHARDS = 8, 512, 4
TRAIN_STEPS = 10
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
TRAIN_CUT_LAYERS = 2
PARITY_BATCH, PARITY_SEQ = 1, 128
DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_FAIL_AT = 8, 4, 6


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


def adversarial_bucket(n_ops, n_cand, n_res, seed, tile):
    """Rows whose deps sit where sweep_scan's schedule changes hands: at
    base_k - 1 and base_k (base_k = the tile before the row's), at i - 1
    (forwarded in a register), at i and i + 1 (not served yet: 0.0), far
    back across several tiles, and -1."""
    res, dur, lag, _ = random_bucket(n_ops, n_cand, n_res, seed)
    rng = np.random.default_rng(seed + 1)
    deps = np.full((n_cand, n_ops, MAXD), -1, dtype=np.int32)
    for i in range(n_ops):
        base_k = (i // tile - 1) * tile
        pool = [base_k - 1, base_k, i - 1, i, i + 1, i - 3 * tile - 5,
                i - 2 * tile, -1]
        pool = [d if 0 <= d < n_ops else -1 for d in pool]
        for c in range(n_cand):
            deps[c, i] = rng.choice(pool, MAXD)
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


def alloc_peak_bytes(fn) -> int:
    """How far one call of ``fn`` raises the caching allocator's peak of
    allocated bytes above what was allocated before it: its outputs and
    its scratch, as the run allocated them."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def phase_env(env):
    info = env.probe()
    info["cpu_count"] = os.cpu_count()
    info["cpu_affinity"] = len(os.sched_getaffinity(0))
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


def same_values(a, b) -> bool:
    """`torch.equal`, with NaN equal to NaN."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def abs_err(a, b) -> float:
    """Largest absolute difference where both values are finite."""
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0


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
            err = max(abs_err(mk_k, mk_p), abs_err(end_k, end_p))
            worst = max(worst, err)
            equal = same_values(mk_k, mk_p) and same_values(end_k, end_p)
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
    for n_ops, n_cand, n_res, seed in ADVERSARIAL:
        caps = [("smem", kernel_mod.MAX_SMEM_BYTES),
                ("gmem", kernel_mod.load().sweep_scan_base_smem_bytes(n_res))]
        check(f"N={n_ops},C={n_cand},R={n_res} adversarial deps",
              adversarial_bucket(n_ops, n_cand, n_res, seed,
                                 kernel_mod.TILE_ROWS), n_res, caps)
    big = random_bucket(4096, 64, 128, SEED)
    caps = [("smem", kernel_mod.MAX_SMEM_BYTES), ("gmem", small_cap)]
    check("N=4096,C=64,R=128 healthy", big, 128, caps)
    res, dur, lag, deps = big
    rng = np.random.default_rng(SEED + 1)
    dur = dur.copy()
    dur[rng.random(dur.shape) < 0.01] += 1e30     # dead-op style durations
    check("N=4096,C=64,R=128 dead-ops", (res, dur, lag, deps), 128, caps)
    # the general walk: a value outside dur, lag >= 0 at seeded places of
    # both, and every lag of one candidate negative
    for value in SPECIAL_VALUES:
        for n_ops, n_cand, n_res, seed in [(600, 4, 8, 9), ADVERSARIAL[0]]:
            res, dur, lag, deps = adversarial_bucket(
                n_ops, n_cand, n_res, seed, kernel_mod.TILE_ROWS)
            rng = np.random.default_rng(seed + 2)
            for arr in (dur, lag):
                arr[rng.integers(0, n_cand, 8),
                    rng.integers(0, n_ops, 8)] = value
            lag[1] -= 0.05
            caps = [("smem", kernel_mod.MAX_SMEM_BYTES),
                    ("gmem",
                     kernel_mod.load().sweep_scan_base_smem_bytes(n_res))]
            check(f"N={n_ops},C={n_cand},R={n_res} value {value!r}",
                  (res, dur, lag, deps), n_res, caps)
    emit({"phase": "kernel_check", "kernel": "sweep_scan",
          "tolerance": "none (torch.equal, NaN equal to NaN)",
          "cases": len(cases),
          "all_equal": all(c["equal"] for c in cases),
          "max_abs_err": worst, "detail": cases})
    return worst


def host_scan(ops, st, torch_sim, ref_sim):
    """The scan-mode makespan of one DAG, and its ops' completion times
    in op order, by a scalar loop on the host: same order, same
    recurrence, plain Python floats."""
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
    return mk, np.asarray(end)[inv]


def host_scan_makespan(ops, st, torch_sim, ref_sim) -> float:
    return host_scan(ops, st, torch_sim, ref_sim)[0]


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


def phase_main_path(core):
    """Scenario I at paper scale. Returns (kernel launches, timing
    inputs for the kernels line, the warm state `phase_advisor_path`
    reuses: its session, grid, workflow function and makespans)."""
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
    # a DAG cache that holds both grids (150 + 591 candidates; the
    # default keeps 256), so the advisor path that reuses this session
    # meets the healthy grid warm, as a long-lived server would
    sess = core.SweepSession(
        core.InlineBackend(), tracer=tracer,
        compile_cache=core.CompileCache(max_entries=MAIN_DAG_CACHE))
    assert sess.device.type == "cuda"
    torch.cuda.reset_peak_memory_stats()
    # K1 counts its launches in the session's CacheStats: 0 just before
    sess.stats.reset()

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
    assert stats.kernel_launches == healthy["scan_buckets"], \
        (stats.kernel_launches, healthy["scan_buckets"])
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
    launches = stats.kernel_launches
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
          "dag_cache_entries": len(sess.compile_cache.cache_keys()),
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    warm = {"session": sess, "tracer": tracer, "cands": cands,
            "workflow_for": workflow_for, "st": st,
            "makespans": [e.makespan for e in evals],
            "ranked": [(e.index, e.makespan) for e in evals],
            "seconds": healthy_s, "phases": healthy}
    return launches, timing, warm


def worker_sums(tracer):
    """Per worker track: its items, and the seconds of its compile or
    disk load, host prep and device spans (absorbed from the workers)."""
    out = {}
    for s in tracer.spans():
        if s.track == tracer.track:
            continue
        w = out.setdefault(s.track, {"items": 0, "compile_or_load_s": 0.0,
                                     "host_prep_s": 0.0, "device_s": 0.0})
        if s.name.startswith("compile_or_load["):
            w["items"] += 1
            w["compile_or_load_s"] += s.dur
        elif s.name.startswith("prep["):
            w["host_prep_s"] += s.dur
        elif s.name.startswith("sim["):
            w["device_s"] += s.dur
    return dict(sorted(out.items()))


def phase_backends_path(core, warm):
    """The main path's healthy BLAST grid through the multi-process and
    the sharded backend, each held to the bit against main_path's inline
    makespans; main_path's session is not touched (its DAG cache is
    read by the sharded runs). Returns the K1 launches of the phase,
    rolled up from the workers and counted in the sharded sessions."""
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels.sweep_scan import kernel as kernel_mod
    from repro_torch.obs import Tracer

    st, cands, workflow_for = warm["st"], warm["cands"], warm["workflow_for"]
    want = warm["ranked"]
    n_workers = min(MAX_WORKERS, max(2, len(os.sched_getaffinity(0)) // 2))
    # the K1 library the workers load: built by phase_build, rebuilt by
    # no worker (a rebuild would rename a new file into place)
    lib = build_mod.library_path("sweep_scan", [kernel_mod.SOURCE],
                                 kernel_mod.EXTRA_FLAGS)
    lib_mtime = lib.stat().st_mtime_ns

    def ranked(evals):
        return [(e.index, e.makespan) for e in evals]

    # -- (a) cold: fresh workers, a DAG cache on an empty directory ------------
    # (the directory is what lets a class whose item lands on another
    # worker in (b) load there instead of compiling again)
    cache_dir = BUILD_DIR / "backends_dag_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    cache = core.CompileCache(path=cache_dir, max_entries=MAIN_DAG_CACHE)
    tracer = Tracer()
    mp = core.SweepSession(core.MultiprocBackend(
        n_workers, item_timeout_s=ITEM_TIMEOUT_S), tracer=tracer,
        compile_cache=cache)
    stats, cstats = mp.stats, mp.compile_stats
    stats.reset()                               # K1's count: 0 just before
    t0 = time.perf_counter()
    evals = core.explore(workflow_for, cands, st, verify_top_k=0, session=mp)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    assert ranked(evals) == want, "multi-process sweep != inline sweep"
    assert stats.mp_fallbacks == 0, "a work item fell back in-process"
    assert stats.mp_late_drops == 0, "a worker's result came too late"
    assert stats.kernel_fallbacks == 0, "a worker bucket fell back"
    assert stats.kernel_launches > 0, "no worker launched K1"
    classes = cstats.grid_classes
    cold_compiles = dict(cstats.worker_compiles)
    assert sum(cold_compiles.values()) == classes, (cold_compiles, classes)
    workers = worker_sums(tracer)
    assert 1 <= len(workers) <= n_workers
    cold = {"seconds": cold_s, "items": stats.mp_items,
            "grid_classes": classes, "worker_compiles": cold_compiles,
            "worker_rows": dict(stats.worker_rows),
            "disk_stores": cstats.disk_stores, "workers": workers,
            "kernel_launches": stats.kernel_launches,
            "inline_cold_seconds": warm["seconds"],
            "inline_cold_compile_s": warm["phases"]["compile_s"]}

    # -- (b) the same sweep again: warm fleet, warm worker caches --------------
    compiles0 = sum(cstats.worker_compiles.values())
    items0, launches0 = stats.mp_items, stats.kernel_launches
    tracer.clear()
    t0 = time.perf_counter()
    evals = core.explore(workflow_for, cands, st, verify_top_k=0, session=mp)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert ranked(evals) == want, "warm multi-process sweep != inline sweep"
    assert sum(cstats.worker_compiles.values()) == compiles0, \
        "a warm worker compiled"
    assert stats.mp_fallbacks == 0 and stats.mp_late_drops == 0
    assert stats.kernel_fallbacks == 0
    warm_run = {"seconds": warm_s, "items": stats.mp_items - items0,
                "worker_compiles": 0, "disk_hits": cstats.disk_hits,
                "workers": worker_sums(tracer),
                "kernel_launches": stats.kernel_launches - launches0}
    mp_launches = stats.kernel_launches
    mp.close()
    assert mp.live_pools() == 0
    # the fleet's processes end with its session: none outlives the phase
    for child in multiprocessing.active_children():
        child.join(timeout=60)
    assert not multiprocessing.active_children(), "a worker outlived close()"
    shutil.rmtree(cache_dir)
    assert lib.stat().st_mtime_ns == lib_mtime, "a worker rebuilt K1"

    # -- (c) sharded: all visible cards, then two slots of the one card ---------
    def sharded_run(backend):
        sess = core.SweepSession(backend,
                                 compile_cache=warm["session"].compile_cache)
        sess.stats.reset()                      # K1's count: 0 just before
        t0 = time.perf_counter()
        evals = core.explore(workflow_for, cands, st, verify_top_k=0,
                             session=sess)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert ranked(evals) == want, "sharded sweep != inline sweep"
        s = sess.stats
        assert s.kernel_fallbacks == 0 and s.kernel_launches > 0
        keys = sess.engine.cache_keys()
        out = {"seconds": secs, "n_shards": sess.engine.n_shards,
               "mesh": [str(d) for d in sess.mesh or ()],
               "key_shards": sorted({k[4] for k in keys}),
               "sharded_batch_calls": s.sharded_batch_calls,
               "device_rows": dict(s.device_rows),
               "buckets": s.misses, "evictions": s.evictions,
               "kernel_launches": s.kernel_launches}
        sess.close()
        return out

    all_cards = sharded_run(core.ShardedBackend(0))
    if torch.cuda.device_count() == 1:
        # one card: no mesh, every key as the inline engine's
        assert all_cards["n_shards"] == 1 and all_cards["key_shards"] == [1]
        assert all_cards["sharded_batch_calls"] == 0
        assert all_cards["kernel_launches"] == all_cards["buckets"]
    two = [torch.device("cuda", 0)] * 2
    slots = sharded_run(core.ShardedBackend(two, min_shard_oprows=0))
    assert slots["n_shards"] == 2 and slots["key_shards"] == [2]
    assert slots["sharded_batch_calls"] > 0
    assert set(slots["device_rows"]) == {"cuda:0[0]", "cuda:0[1]"}
    assert len(set(slots["device_rows"].values())) == 1
    # every bucket split in two: one K1 launch per slot
    assert slots["kernel_launches"] == 2 * slots["buckets"]
    launches = (mp_launches + all_cards["kernel_launches"]
                + slots["kernel_launches"])
    emit({"phase": "backends_path", "workload": "BLAST db_mb=1710 "
          "n_queries=100", "candidates": len(cands), "workers": n_workers,
          "cpu_affinity": len(os.sched_getaffinity(0)),
          "multiproc_cold": cold, "multiproc_warm": warm_run,
          "sharded_all_cards": all_cards, "sharded_two_slots": slots,
          "makespans_equal_inline": True, "k1_library_rebuilt": False,
          "kernel_launches": launches})
    return launches


def hold_plan_winner(sess, plan, total_bytes, n_hosts, st) -> None:
    """The checkpoint plan's winner: its scan makespan held to the bit
    against K1's plain version on the card, a run that launches nothing."""
    from repro_torch.core import torch_sim
    from repro_torch.core.workloads import checkpoint_write
    launches = sess.stats.kernel_launches
    n_writers = n_hosts - 1
    w_ops = sess.compile_cache.get(
        checkpoint_write(n_writers, max(total_bytes // n_writers, 1),
                         local=plan.local_placement), plan.config)
    w_plain = torch_sim.simulate(w_ops, st, device=sess.device,
                                 use_kernel=False).makespan
    assert w_plain == plan.table[0]["predicted_write_s"], \
        (w_plain, plan.table[0])
    assert sess.stats.kernel_launches == launches, "a plain run launched K1"


def phase_advisor_path(core, warm):
    """The advisor path on the card, on the main path's warm session:
    sysid at the reference test's probe settings; the paper-scale BLAST
    grid explored again with timelines for its three best candidates,
    each held to the bit against the scalar host loop; an
    `AdvisorServer` on that session answering 8 tenants' concurrent
    requests over 2 questions, repeats from its results cache, and a
    re-identified system; one checkpoint plan; the generated grid's best
    row and the plan's winner held to the bit against K1's plain version
    on the card. Returns the K1 launches counted in the session while it
    ran (the plain version's runs launch nothing)."""
    from repro_torch.checkpoint import plan_checkpoint
    from repro_torch.core import compile as compile_mod
    from repro_torch.core import ref_sim, sysid, torch_sim, trace
    from repro_torch.core.emulator import EmulatorParams
    from repro_torch.obs import (metrics_snapshot, resource_names,
                                 timeline_to_events, write_trace)
    from repro_torch.serve import AdvisorRequest, AdvisorServer

    t_phase = time.perf_counter()
    sess, st, tracer = warm["session"], warm["st"], warm["tracer"]
    cands, workflow_for = warm["cands"], warm["workflow_for"]
    stats = sess.stats
    stats.reset()                               # K1's count: 0 just before

    # -- sysid: the host-side emulator probes, as the reference test runs them
    t0 = time.perf_counter()
    report = sysid.identify(probe_mb=SYSID_PROBE_MB, file_mb=SYSID_PROBE_MB,
                            seed=SYSID_SEED)
    sysid_s = time.perf_counter() - t0
    assert report.digest == sysid.params_digest(EmulatorParams())
    assert report.service_times.net_latency >= 1e-9

    # -- timelines for the three best candidates of the paper-scale grid
    t0 = time.perf_counter()
    evals = core.explore(workflow_for, cands, st, verify_top_k=0,
                         timeline_top_k=ADVISOR_TIMELINES, session=sess)
    torch.cuda.synchronize()
    timeline_s = time.perf_counter() - t0
    assert [e.makespan for e in evals] == warm["makespans"]
    timelines = []
    for e in evals[:ADVISOR_TIMELINES]:
        tl = e.timeline
        assert tl is not None and tl.n_ops > 0
        assert tl.makespan == e.makespan, (tl.makespan, e.makespan)
        t1 = time.perf_counter()
        cpd = tl.critical_path_duration()
        cp_s = time.perf_counter() - t1
        # the reference's own bound (tests/test_obs.py): rel 1e-9
        assert abs(cpd - tl.makespan) <= 1e-9 * tl.makespan, \
            (cpd, tl.makespan)
        # K1's run at C = 1 against the scalar host loop, to the bit (the
        # plain PyTorch loop would take minutes at these sizes)
        ops = sess.compile_cache.get(workflow_for(e.candidate),
                                     e.candidate.to_config())
        t1 = time.perf_counter()
        host_mk, host_end = host_scan(ops, st, torch_sim, ref_sim)
        host_s = time.perf_counter() - t1
        assert host_mk == tl.makespan, (host_mk, tl.makespan)
        assert np.array_equal(host_end, tl.end), "timeline end != host loop"
        timelines.append({"candidate": describe(e), "n_ops": tl.n_ops,
                          "makespan": tl.makespan,
                          "critical_path_duration": cpd,
                          "critical_path_equals_makespan": cpd == tl.makespan,
                          "critical_path_ops": len(tl.critical_path()),
                          "critical_path_s": cp_s,
                          "host_loop_equal": True, "host_loop_s": host_s,
                          "max_utilization": float(tl.utilization().max())})
    assert all(e.timeline is None for e in evals[ADVISOR_TIMELINES:])
    # one Perfetto trace, of the smallest of the three, under build/
    small = min(evals[:ADVISOR_TIMELINES], key=lambda e: e.timeline.n_ops)
    small.timeline.resource_names = tuple(
        resource_names(small.candidate.to_config()))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = write_trace(
        BUILD_DIR / "advisor_timeline.json",
        timeline_to_events(small.timeline, label="blast best candidates"),
        metrics=metrics_snapshot(sess))
    timeline_launches = stats.kernel_launches

    # -- the server on the warm session: 8 tenants, 2 questions. BLAST
    # splits its queries over a candidate's app nodes and a request names
    # one workflow, as the reference's does, so the BLAST question is one
    # request per app-node count of the grid
    gen_wf = trace.to_workflow(trace.generate_workflow(
        trace.GenSpec(**GEN_SPEC), seed=GEN_SEED))
    gen_cands = core.grid(**GEN_GRID)
    by_app = {}
    for c in cands:
        by_app.setdefault(c.n_app, []).append(c)
    questions = [dict(workflow=workflow_for(group[0]), candidates=group,
                      verify_top_k=0) for group in by_app.values()]
    gen_qi = len(questions)
    questions.append(dict(workflow=gen_wf, candidates=gen_cands,
                          verify_top_k=2))
    reqs, q_of = [], []
    for i in range(ADVISOR_TENANTS):
        for qi in (range(gen_qi) if i % 2 == 0 else [gen_qi]):
            reqs.append(AdvisorRequest(client=f"tenant{i}", **questions[qi]))
            q_of.append(qi)
    gen_req = reqs[q_of.index(gen_qi)]
    pred = core.Predictor(st, session=sess)

    async def serve():
        # one admission batch holds the whole burst (the default caps a
        # batch at 64 tickets, and a ticket of a later batch would find
        # its question answered in the results cache)
        async with AdvisorServer.from_predictor(
                pred, batch_window_s=ADVISOR_WINDOW_S,
                max_batch=len(reqs)) as srv:
            assert srv.session is sess and srv.session.device.type == "cuda"
            n0, b0 = compile_mod.compile_count(), stats.batch_calls
            tracer.clear()
            t0 = time.perf_counter()
            first = await asyncio.gather(*(srv.submit(r) for r in reqs))
            first_s = time.perf_counter() - t0
            burst = phase_sums(tracer)
            compiles = compile_mod.compile_count() - n0
            batches = stats.batch_calls - b0
            assert srv.stats.sweeps == len(questions), srv.stats
            assert srv.stats.coalesced == len(reqs) - len(questions), \
                srv.stats
            assert not any(r.cached for r in first)
            # repeats: the results cache, no compile, no simulator call
            n1, b1 = compile_mod.compile_count(), stats.batch_calls
            again = await asyncio.gather(srv.submit(reqs[0]),
                                         srv.submit(gen_req))
            assert all(r.cached for r in again)
            assert compile_mod.compile_count() == n1, "a cache hit compiled"
            assert stats.batch_calls == b1, "a cache hit simulated"
            assert srv.results.stats.hits == 2
            # a re-identified system: storage twice as slow
            st2 = st.replace(storage=st.storage * 2.0)
            srv.set_service_times(st2)
            fresh = await srv.submit(gen_req)
            assert not fresh.cached
            assert srv.results.stats.invalidations == 1
            return (first, first_s, burst, compiles, batches, again, fresh,
                    st2, dataclasses.asdict(srv.stats))

    (first, first_s, burst, compiles, batches, again, fresh, st2,
     serve_stats) = asyncio.run(serve())
    server_launches = stats.kernel_launches - timeline_launches

    # the answers against a direct explore on the same session
    direct = [core.explore(lambda c, wf=q["workflow"]: wf, q["candidates"],
                           st, verify_top_k=q["verify_top_k"], session=sess)
              for q in questions]
    want = [[e.makespan for e in d] for d in direct]
    for i, (r, qi) in enumerate(zip(first, q_of)):
        assert r.makespans.tolist() == want[qi], f"request {i}"
    assert [r.makespans.tolist() for r in again] == [want[0], want[gen_qi]]
    # the BLAST groups together are the whole grid's sweep
    assert sorted(m for w in want[:gen_qi] for m in w) == \
        sorted(warm["makespans"])
    direct_fresh = core.explore(lambda c: gen_wf, gen_cands, st2,
                                verify_top_k=2, session=sess)
    assert fresh.makespans.tolist() == [e.makespan for e in direct_fresh]
    assert fresh.makespans.tolist() != want[gen_qi]
    lat = sorted(r.latency_s for r in first)
    # the generated grid's best row: K1's scan makespan against its plain
    # version on the same card inputs (`use_kernel=False`)
    g_best = direct[gen_qi][0]
    g_ops = sess.compile_cache.get(gen_wf, g_best.candidate.to_config())
    g_plain = torch_sim.simulate(g_ops, st, device=sess.device,
                                 use_kernel=False).makespan
    assert g_plain == g_best.scan_makespan, (g_plain, g_best.scan_makespan)

    # -- one checkpoint plan on the card
    before_plan = stats.kernel_launches
    t0 = time.perf_counter()
    plan = plan_checkpoint(CKPT_BYTES, CKPT_HOSTS, st, session=sess)
    plan_s = time.perf_counter() - t0
    assert plan.predicted_write_s > 0 and plan.predicted_restore_s > 0
    assert stats.kernel_launches > before_plan, "the plan took no kernel"
    assert stats.kernel_fallbacks == 0, "an advisor-path bucket fell back"
    launches = stats.kernel_launches
    hold_plan_winner(sess, plan, CKPT_BYTES, CKPT_HOSTS, st)

    emit({"phase": "advisor_path",
          "sysid": {"seconds": sysid_s, "params_digest": report.digest,
                    "probe": report.probe,
                    "n_measurements": report.n_measurements,
                    "service_times": dataclasses.asdict(
                        report.service_times)},
          "timelines": {"candidates": len(cands), "seconds": timeline_s,
                        "top_k": timelines,
                        "trace_file": str(trace_path.relative_to(ROOT)),
                        "trace_bytes": trace_path.stat().st_size,
                        "trace_of_n_ops": small.timeline.n_ops},
          "server": {"tenants": ADVISOR_TENANTS, "questions": 2,
                     "requests": len(reqs),
                     "distinct_requests": len(questions),
                     "blast_candidates": len(cands),
                     "blast_requests_per_tenant": gen_qi,
                     "generated": {"spec": GEN_SPEC, "seed": GEN_SEED,
                                   "fingerprint": gen_wf.fingerprint(),
                                   "candidates": len(gen_cands)},
                     "first_burst_s": first_s,
                     "first_burst_split_s": {
                         k: burst[k] for k in ("compile_s", "host_prep_s",
                                               "device_s")},
                     "first_burst_scan_buckets": burst["scan_buckets"],
                     "latency_s_p50": lat[len(lat) // 2],
                     "latency_s_max": lat[-1],
                     "group_sizes": sorted({r.group_size for r in first}),
                     "compile_workflow_calls": compiles,
                     "batch_calls": batches,
                     "repeat_cached": [r.cached for r in again],
                     "repeat_compiles": 0, "repeat_batch_calls": 0,
                     "invalidations": 1,
                     "generated_best_plain_equal": True,
                     "stats": serve_stats},
          "planner": {"total_bytes": CKPT_BYTES, "n_hosts": CKPT_HOSTS,
                      "seconds": plan_s,
                      "kernel_launches": launches - before_plan,
                      "stripe_width": plan.config.stripe_width,
                      "chunk_mb": plan.config.chunk_size / (1 << 20),
                      "replication": plan.config.replication,
                      "local_placement": plan.local_placement,
                      "predicted_write_s": plan.predicted_write_s,
                      "predicted_restore_s": plan.predicted_restore_s,
                      "winner_scan_s": plan.table[0]["predicted_write_s"],
                      "winner_plain_equal": True,
                      "candidates": len(plan.table)},
          "kernel_launches": launches,
          "kernel_launches_timelines": timeline_launches,
          "kernel_launches_server": server_launches,
          "kernel_fallbacks": stats.kernel_fallbacks,
          "seconds": time.perf_counter() - t_phase})
    sess.close()
    return launches


def phase_fixture_sweep(core, torch_sim, ref_sim):
    """The three shipped trace fixtures, read by the port's own readers,
    each swept over a grid on the card; one full-size row of each held
    to the bit against the scalar host loop. Returns the K1 launches."""
    from repro_torch.core import trace

    st = core.PAPER_RAMDISK
    sess = core.SweepSession(core.InlineBackend())
    sess.stats.reset()                          # K1's count: 0 just before
    rows = []
    for name in FIXTURES:
        wf = trace.to_workflow(trace.load_trace(TRACES / name))
        cands = core.grid(**FIXTURE_GRID)
        t0 = time.perf_counter()
        evals = core.explore(lambda c: wf, cands, st, verify_top_k=0,
                             session=sess)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert all(np.isfinite(e.makespan) and e.makespan > 0 for e in evals)
        ops_all = [sess.compile_cache.get(wf, c.to_config()) for c in cands]
        big_i = int(np.argmax([o.n_ops for o in ops_all]))
        host_mk = host_scan_makespan(ops_all[big_i], st, torch_sim, ref_sim)
        dev_mk = next(e.makespan for e in evals if e.index == big_i)
        assert host_mk == dev_mk, (name, host_mk, dev_mk)
        rows.append({"fixture": name, "fingerprint": wf.fingerprint(),
                     "tasks": len(wf.tasks), "candidates": len(cands),
                     "seconds": secs,
                     "best": describe(evals[0]),
                     "full_size_row": {"n_ops": int(ops_all[big_i].n_ops),
                                       "host_makespan": host_mk,
                                       "device_makespan": dev_mk}})
    stats = sess.stats
    assert stats.kernel_fallbacks == 0, "a fixture bucket fell back"
    assert stats.kernel_launches > 0, "no fixture bucket took the kernel"
    emit({"phase": "fixture_sweep", "grid": FIXTURE_GRID, "fixtures": rows,
          "kernel_launches": stats.kernel_launches,
          "kernel_fallbacks": stats.kernel_fallbacks})
    sess.close()
    return stats.kernel_launches


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
        assert sess.stats.kernel_fallbacks == 0
        assert sess.stats.kernel_launches > 0
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
            # the bf16 kernel sums in one fixed order (no atomics): a second
            # call gives the same bits; the f32 kernel's atomics do not
            again = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=True) \
                if bf16 else None
            # f32: the plain version evaluated in f64 (its own f32
            # evaluation strays ~2e-5 at full width); bf16: as it is
            want = plain if bf16 else expert_ffn_ref(
                *(t.double() for t in (x, wg, wu, wd)))
            torch.cuda.synchronize()
            tag = f"moe_gmm {dtype} G,E,C,d,f={G},{E},{C},{d},{f}"
            err = check_close(tag, got, want, rt, rt)
            equal = None if again is None else torch.equal(got, again)
            assert equal is not False, f"{tag}: two calls differ"
            worst["moe_gmm"] = max(worst["moe_gmm"], err)
            cases.append({"kernel": "moe_gmm", "dtype": str(dtype),
                          "shape": [G, E, C, d, f], "tol": rt,
                          "oracle": "expert_ffn_ref in " +
                                    ("f32" if bf16 else "f64"),
                          "max_abs_err": err,
                          "two_calls_torch_equal": equal,
                          "plain_f32_vs_oracle_max_abs_err_not_held":
                              None if bf16 else float(
                                  (plain.double() - want).abs().max()),
                          "max_abs_plain": float(want.float().abs().max())})
            del x, wg, wu, wd, want, got, plain, again
    emit({"phase": "model_kernel_check", "cases": len(cases),
          "max_abs_err": worst, "detail": cases})
    return worst


def agreement(a, b):
    """(max |a - b|, share of positions whose argmax agrees)."""
    return (float((a.float() - b.float()).abs().max()),
            float((a.argmax(-1) == b.argmax(-1)).float().mean()))


class InSituCheck:
    """For one model forward, every flash_attention / ssd / moe_gmm kernel
    launch the model makes is also run through the plain version on the
    same inputs and compared: the kernels held at the real activations of
    the full-size model, where a comparison of final logits cannot reach
    through 54 layers in bf16. The bound is relative to the tensor's
    scale, max |kernel - plain| <= tol * max |plain|: an element that is a
    near-cancelling sum of large terms carries an absolute rounding error
    of eps times those terms in either version. The kernel call counts
    into the ``counts`` the model hands down; the plain runs launch
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

        def fa_checked(q, k, v, *, causal=True, window=0, use_kernel,
                       counts=None):
            assert causal, "the model's attention is causal"
            out = fa(q, k, v, causal=causal, window=window,
                     use_kernel=use_kernel, counts=counts)
            want = fa_plain(q, k, v, window)
            err = self.check(f"flash_attention in situ, call "
                             f"{self.calls['flash_attention']}", out, want,
                             t["fa"])
            keep("flash_attention", (q, k, v, window))
            self._note("flash_attention", err)
            return out

        def ssd_checked(x, dt, a, b, c, *, chunk=128, use_kernel,
                        counts=None):
            y, h = ssd(x, dt, a, b, c, chunk=chunk, use_kernel=use_kernel,
                       counts=counts)
            y0, h0 = ssd_plain(x, dt, a, b, c, chunk)
            keep("ssd", (x, dt, a, b, c, chunk))
            tag = f"ssd in situ, call {self.calls['ssd']}"
            err = max(self.check(tag + " y", y, y0, t["ssd"]),
                      self.check(tag + " h", h, h0, t["h"]))
            self._note("ssd", err)
            return y, h

        def gmm_checked(x, wg, wu, wd, *, use_kernel, counts=None):
            out = gmm(x, wg, wu, wd, use_kernel=use_kernel, counts=counts)
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
        per kernel. These launches are a comparison's and count nowhere."""
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


def hold_decode_against_prefill(cfg32, params32, prompts, prefill32, counts):
    """DECODE_CHECK_LEN teacher-forced f32 serve steps, each step's logits
    held against the f32 prefill's at that position (cache slot, in-place
    state, rotary offset): argmax agreement at MIN_ARGMAX_AGREEMENT and
    max |decode - prefill| <= DECODE_TOL x max |prefill logit|. Returns
    (max diff, max |prefill logit|, agreement)."""
    from repro_torch.models import init_decode_state
    from repro_torch.train.step import make_serve_step
    state = init_decode_state(cfg32, N_REQUESTS, PROMPT_LEN + GEN_LEN,
                              dtype=torch.float32, device=prompts.device)
    serve = make_serve_step(cfg32, use_kernel=True, counts=counts)
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


def serve_requests(cfg, params, prompts, last_prefill, counts):
    """Serve the prompts as `examples/serve_batch.py` serves: PROMPT_LEN - 1
    teacher-forced serve steps, then GEN_LEN greedy tokens, in the served
    dtype; the first greedy step's logits are compared with the
    prefill's last position (reported). Returns the readings."""
    from repro_torch.models import init_decode_state
    from repro_torch.train.step import make_serve_step
    state = init_decode_state(cfg, N_REQUESTS, PROMPT_LEN + GEN_LEN,
                              device=prompts.device)
    serve = make_serve_step(cfg, use_kernel=True, counts=counts)
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


def phase_model_path(fa_ops, ssd_ops, gmm_ops):
    """zamba2-2.7b at full width and depth through the serving entry
    points, its kernel launches counted in a `KernelCounts` of its own.
    Returns (launches per kernel, timing inputs)."""
    from repro_torch import configs
    from repro_torch.kernels.counts import KernelCounts
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

    counts = KernelCounts()                     # every count 0 just before
    # -- the algorithm at full width and depth, in f32 (no TF32): kernel path
    # vs plain path on the 8 prompts, each kernel call also held in situ
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = cfg.replace(dtype="float32")
    # f32 tolerances of model_kernel_check
    with InSituCheck(fa_ops, ssd_ops, 1e-5, 1e-5, 1e-4) as in_situ32:
        l32k = make_prefill_step(cfg32, use_kernel=True,
                                 counts=counts)(params32, prompts)
    l32p = make_prefill_step(cfg32, use_kernel=False,
                             counts=counts)(params32, prompts)
    torch.cuda.synchronize()
    assert counts == KernelCounts(flash_attention=per_fwd_fa,
                                  ssd=per_fwd_ssd), counts
    assert in_situ32.calls == {"flash_attention": per_fwd_fa,
                               "ssd": per_fwd_ssd}, in_situ32.calls
    assert bool(torch.isfinite(l32k).all()) and bool(torch.isfinite(l32p).all())
    diff32, agree32 = agreement(l32k, l32p)
    assert agree32 >= MIN_ARGMAX_AGREEMENT, agree32
    # -- decode in f32: serve steps held against the f32 prefill
    dec_diff32, dec_scale32, dec_agree32 = hold_decode_against_prefill(
        cfg32, params32, prompts, l32p, counts)
    del l32k, l32p
    assert counts == KernelCounts(flash_attention=per_fwd_fa,   # no kernel
                                  ssd=per_fwd_ssd), counts      # in decode
    t0 = time.perf_counter()
    params = cast_params(params32, cfg)     # once, as a server would
    del params32
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0

    # -- the served dtype, bf16: prefill of the 8 requests -------------------
    prefill_k = make_prefill_step(cfg, use_kernel=True, counts=counts)
    prefill_p = make_prefill_step(cfg, use_kernel=False, counts=counts)
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
                                  use_kernel=False,
                                  counts=counts)(params, prompts)
    torch.cuda.synchronize()
    assert counts == KernelCounts(flash_attention=4 * per_fwd_fa,
                                  ssd=4 * per_fwd_ssd), counts
    assert logits_k.shape == (N_REQUESTS, PROMPT_LEN, cfg.vocab)
    assert all(bool(torch.isfinite(t).all())
               for t in (logits_k, logits_p, logits_p2))
    diff, agree = agreement(logits_k, logits_p)
    floor_diff, floor_agree = agreement(logits_p2, logits_p)
    last_prefill = logits_k[:, -1].float()
    del logits_k, logits_p, logits_p2

    # -- serve: teacher-forced steps over each prompt, then greedy tokens -----
    served = serve_requests(cfg, params, prompts, last_prefill, counts)
    # no kernel on the decode path, as in the reference
    assert counts == KernelCounts(flash_attention=4 * per_fwd_fa,
                                  ssd=4 * per_fwd_ssd), counts

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
    assert counts == KernelCounts(flash_attention=6 * per_fwd_fa,
                                  ssd=6 * per_fwd_ssd), counts
    launches = {"flash_attention": counts.flash_attention,
                "ssd": counts.ssd}
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
        use_kernel, counts=None: fa(q, k, v, causal=causal, window=window,
                                    use_kernel=False)
    gmm_ops.expert_ffn = lambda x, wg, wu, wd, *, use_kernel, counts=None: \
        gmm(x, wg, wu, wd, use_kernel=False)
    try:
        yield
    finally:
        fa_ops.flash_attention, gmm_ops.expert_ffn = fa, gmm


def phase_moe_path(fa_ops, ssd_ops, gmm_ops):
    """mixtral-8x22b at full width, depth cut to MOE_LAYERS, through the
    serving entry points: a 2-layer f32 copy (kernel vs plain path, f32
    serve steps vs the f32 prefill), then the bf16 model serving 8
    requests and one 32768-token prefill, every K2 and K4 call of one
    forward per shape held in situ; its kernel launches counted in a
    `KernelCounts` of its own. Returns (launches per kernel, the shapes
    the kernels met)."""
    from repro_torch import configs
    from repro_torch.kernels.counts import KernelCounts
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
    launched = KernelCounts()                   # every count 0 just before
    L, L32 = cfg.n_layers, MOE_F32_LAYERS

    def counts():
        return {"flash_attention": launched.flash_attention,
                "moe_gmm": launched.moe_gmm}

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
        l32k = make_prefill_step(cfg32, use_kernel=True,
                                 counts=launched)(p32, prompts)
    l32p = make_prefill_step(cfg32, use_kernel=False,
                             counts=launched)(p32, prompts)
    torch.cuda.synchronize()
    assert in_situ32.calls == {"flash_attention": L32, "ssd": 0,
                               "moe_gmm": L32}, in_situ32.calls
    assert counts() == {"flash_attention": L32, "moe_gmm": L32}, counts()
    assert bool(torch.isfinite(l32k).all()) and bool(torch.isfinite(l32p).all())
    diff32, agree32 = agreement(l32k, l32p)
    assert agree32 >= MIN_ARGMAX_AGREEMENT, agree32
    dec_diff32, dec_scale32, dec_agree32 = hold_decode_against_prefill(
        cfg32, p32, prompts, l32p, launched)
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
    prefill_k = make_prefill_step(cfg, use_kernel=True, counts=launched)
    prefill_p = make_prefill_step(cfg, use_kernel=False, counts=launched)
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
    served = serve_requests(cfg, params, prompts, last_prefill, launched)
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
    assert launched.ssd == 0
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


def kernel_class(name: str) -> str:
    """The class a CUDA kernel's name puts it in, for a step's breakdown."""
    low = name.lower()
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "gemm"
    for w in ("memcpy", "memset", "elementwise", "reduce", "softmax"):
        if w in low:
            return w
    return "other"


def profile_step(run) -> dict:
    """``run()`` once under `torch.profiler`: the wall (host clock after
    `synchronize`), the device's busy time (CUDA kernels and copies, one
    stream, so they do not overlap) and its share of the wall, device
    time by `kernel_class`, and the kernels that took the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [a for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA]
    by_class: dict = {}
    for a in kernels:
        c = kernel_class(a.key)
        by_class[c] = by_class.get(c, 0.0) + a.self_device_time_total / 1e3
    busy_ms = sum(by_class.values())
    if busy_ms == 0:
        return {"wall_ms": wall_ms,
                "device": "not measured: the profiler recorded no device time"}
    top = sorted(kernels, key=lambda a: -a.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms, "by_class_ms": by_class,
            "top": [{"name": a.key[:96], "calls": a.count,
                     "ms": a.self_device_time_total / 1e3} for a in top]}


def phase_train_path():
    """The training path on the card: (a) granite-3-2b at full width and
    depth, TRAIN_STEPS steps on one fixed batch (loss and grad norm
    finite every step, the grad norm > 0, the mean loss of the last 3
    steps below the first step's, no K2-K4 launch), then one step under
    the profiler; (b) one f32 step on
    the card against the same step on the CPU, depth cut to 2 (loss rtol
    1e-5, grad norm rtol 1e-4, updated parameters atol 1e-6 + 1e-3 x lr,
    TF32 off); (c) `train_loop` at depth 2 with a predictor-planned
    checkpoint store and an injected fault: the plan's sweep through K1
    with no fallback, its winner equal to K1's plain version on the card,
    the restored state `torch.equal` to the state saved at step 4, the
    run ending at step 8 with its manifest. Returns K1's launches (the
    plan's) counted in the default session's CacheStats."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import TPU_POD_STAGING, default_session
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.counts import KernelCounts
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init, n_params
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train import step as step_mod
    from repro_torch.tree import tree_leaves, tree_map, tree_paths

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    full = configs.get(TRAIN_MODEL)
    shape = ShapeConfig("train_path", TRAIN_SEQ, TRAIN_BATCH, "train")

    def to_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    # -- (a) full width and depth, f32 parameters, bf16 compute, remat ------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init(torch.Generator(device=dev).manual_seed(SEED), full,
                  device=dev)
    state = TrainState(params=params, opt=adamw.init(params))
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in tree_leaves(state.params))
    assert n == n_params(full), (n, n_params(full))
    batch = to_dev(DataPipeline(full, shape, TRAIN_SHARDS,
                                seed=SEED).next_batch())
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS)
    counts = KernelCounts()                     # every count 0 just before
    step = make_train_step(full, opt, counts=counts)
    # the update's CUDA events, recorded around `adamw.update` as the train
    # step calls it: forward+backward is the time from the step's start
    update_events = []
    update = adamw.update

    def timed_update(*args, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = update(*args, **kw)
        e1.record()
        update_events.append((e0, e1))
        return out

    steps = []
    step_mod.adamw.update = timed_update
    try:
        for i in range(TRAIN_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            e0, e1 = update_events[-1]
            steps.append({"step": i + 1, "ms": wall * 1e3,
                          "fwd_bwd_ms": start.elapsed_time(e0),
                          "update_ms": e0.elapsed_time(e1),
                          "loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "lr": float(m["lr"]),
                          "accuracy": float(m["accuracy"])})
    finally:
        step_mod.adamw.update = update
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in steps]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
               and r["grad_norm"] > 0 for r in steps), steps
    assert sum(losses[-3:]) / 3 < losses[0], losses
    # one step more, under the profiler: where the step's device time goes
    profiled = profile_step(lambda: step(state, batch))
    assert counts == KernelCounts(), counts     # training runs no kernel
    steady = steps[1:]
    step_ms = sum(r["ms"] for r in steady) / len(steady)
    del state, batch, m
    torch.cuda.empty_cache()

    # -- (b) the card against the CPU, one f32 step at depth 2 --------------
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cut32 = full.replace(n_layers=TRAIN_CUT_LAYERS, dtype="float32")
    p_cpu = init(torch.Generator().manual_seed(SEED), cut32, device="cpu")
    p_dev = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
    b_cpu = {k: torch.from_numpy(v) for k, v in DataPipeline(
        cut32, ShapeConfig("parity", PARITY_SEQ, PARITY_BATCH, "train"), 1,
        seed=SEED).next_batch().items()}
    counts_b = KernelCounts()
    step_b = make_train_step(cut32, adamw.AdamWConfig(), counts=counts_b)
    t0 = time.perf_counter()
    s_dev, m_dev = step_b(TrainState(p_dev, adamw.init(p_dev)),
                          tree_map(lambda t: t.to(dev), b_cpu))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_cpu, m_cpu = step_b(TrainState(p_cpu, adamw.init(p_cpu)), b_cpu)
    cpu_s = time.perf_counter() - t0
    assert counts_b == KernelCounts(), counts_b
    lr_b = float(m_cpu["lr"])
    loss_rel = abs(float(m_dev["loss"]) / float(m_cpu["loss"]) - 1)
    gnorm_rel = abs(float(m_dev["grad_norm"]) / float(m_cpu["grad_norm"]) - 1)
    p_tol = 1e-6 + 1e-3 * lr_b
    p_err, over = 0.0, 0
    for (k, a), (_, b) in zip(tree_paths(s_dev.params),
                              tree_paths(s_cpu.params)):
        d = (a.cpu() - b).abs()
        p_err = max(p_err, float(d.max()))
        over += int((d > p_tol).sum())
    assert loss_rel <= 1e-5, (float(m_dev["loss"]), float(m_cpu["loss"]))
    assert gnorm_rel <= 1e-4, (float(m_dev["grad_norm"]),
                               float(m_cpu["grad_norm"]))
    assert p_err <= p_tol, (p_err, p_tol, over)
    n_cut = n_params(cut32)
    del p_cpu, p_dev, s_dev, s_cpu
    torch.cuda.empty_cache()

    # -- (c) the driver: planned checkpoints, a fault, a restore ------------
    train_dir = BUILD_DIR / "train"
    shutil.rmtree(train_dir, ignore_errors=True)
    sess = default_session()
    sess.stats.reset()                          # K1's count: 0 just before
    saved, restored = {}, []
    save, restore = CheckpointManager.save, CheckpointManager.restore

    def kept_save(self, st, at):
        if at == DRIVER_CKPT_EVERY:
            saved[at] = tree_map(lambda t: t.detach().clone(), st)
        return save(self, st, at)

    def kept_restore(self, like, *args, **kw):
        st, at = restore(self, like, *args, **kw)
        # a copy: the steps after the restore update the state in place
        restored.append((tree_map(lambda t: t.detach().clone(), st), at))
        return st, at

    CheckpointManager.save, CheckpointManager.restore = kept_save, kept_restore
    try:
        rep = train_loop(TRAIN_MODEL, steps=DRIVER_STEPS, reduced=False,
                         n_layers=TRAIN_CUT_LAYERS, ckpt_dir=str(train_dir),
                         ckpt_every=DRIVER_CKPT_EVERY, seq_len=TRAIN_SEQ,
                         batch=TRAIN_BATCH, n_shards=TRAIN_SHARDS,
                         fail_at=DRIVER_FAIL_AT, seed=SEED,
                         log_every=DRIVER_STEPS, device="cuda")
    finally:
        CheckpointManager.save = save
        CheckpointManager.restore = restore
    stats = sess.stats
    launches = stats.kernel_launches
    assert launches > 0, "the checkpoint plan took no kernel"
    assert stats.kernel_fallbacks == 0, "a plan bucket fell back"
    plan = rep["plan"]
    hold_plan_winner(sess, plan, rep["state_bytes"], TRAIN_SHARDS + 1,
                     TPU_POD_STAGING)
    (got, at), = restored
    assert at == DRIVER_CKPT_EVERY, at
    pairs = list(zip(tree_paths(got), tree_paths(saved[at])))
    assert len(pairs) == len(tree_paths(saved[at]))
    assert all(k == q and torch.equal(a, b) for (k, a), (q, b) in pairs), \
        "the restored state differs from the saved one"
    assert rep["final_step"] == DRIVER_STEPS
    assert (train_dir / f"manifest_{DRIVER_STEPS:08d}.json").exists()
    assert all(math.isfinite(x) for x in rep["losses"])
    del got, saved, restored, pairs
    shutil.rmtree(train_dir)
    torch.cuda.empty_cache()

    emit({"phase": "train_path", "model": TRAIN_MODEL,
          "full": {"n_params": n, "n_layers": full.n_layers,
                   "d_model": full.d_model, "d_ff": full.d_ff,
                   "vocab": full.vocab, "param_dtype": full.param_dtype,
                   "dtype": full.dtype, "remat": True,
                   "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
                   "data": f"DataPipeline({TRAIN_SHARDS} shards, seed "
                           f"{SEED}), one fixed batch",
                   "opt": dataclasses.asdict(opt), "init_s": init_s,
                   "steps": steps, "step_ms_steady": step_ms,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
                   "fwd_bwd_ms_steady": sum(r["fwd_bwd_ms"] for r in steady)
                   / len(steady),
                   "update_ms_steady": sum(r["update_ms"] for r in steady)
                   / len(steady),
                   "loss_first": losses[0],
                   "loss_last3_mean": sum(losses[-3:]) / 3,
                   "kernel_launches": dataclasses.asdict(counts),
                   "peak_device_bytes": peak, "profiled_step": profiled},
          "card_vs_cpu": {"n_layers": TRAIN_CUT_LAYERS, "n_params": n_cut,
                          "dtype": "float32", "batch": PARITY_BATCH,
                          "seq_len": PARITY_SEQ, "tf32": False,
                          "lr": lr_b, "card_s": card_s, "cpu_s": cpu_s,
                          "loss": [float(m_dev["loss"]),
                                   float(m_cpu["loss"])],
                          "loss_rel_err": loss_rel, "loss_rtol": 1e-5,
                          "grad_norm": [float(m_dev["grad_norm"]),
                                        float(m_cpu["grad_norm"])],
                          "grad_norm_rel_err": gnorm_rel,
                          "grad_norm_rtol": 1e-4,
                          "param_max_abs_err": p_err, "param_atol": p_tol,
                          "params_over_atol": over},
          "driver": {"n_layers": TRAIN_CUT_LAYERS,
                     "steps": DRIVER_STEPS, "ckpt_every": DRIVER_CKPT_EVERY,
                     "fail_at": DRIVER_FAIL_AT,
                     "state_bytes": rep["state_bytes"],
                     "plan_s": rep["plan_s"],
                     "plan": {"stripe_width": plan.config.stripe_width,
                              "chunk_mb": plan.config.chunk_size / (1 << 20),
                              "replication": plan.config.replication,
                              "local_placement": plan.local_placement,
                              "predicted_write_s": plan.predicted_write_s,
                              "predicted_restore_s":
                                  plan.predicted_restore_s,
                              "candidates": len(plan.table),
                              "winner_plain_equal": True},
                     "checkpoints": rep["checkpoints"],
                     "restores": rep["restores"],
                     "restored_equal_saved": True,
                     "final_step": rep["final_step"],
                     "losses": rep["losses"], "wall_s": rep["wall_s"]},
          "kernel_launches": launches,
          "kernel_fallbacks": stats.kernel_fallbacks,
          "seconds": time.perf_counter() - t_phase})
    return launches


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


def sdpa_time_ms(q, k, v, window, reps):
    """The library yardstick for K2: one `scaled_dot_product_attention`
    call computing the same function on the same bf16 inputs, timed by
    CUDA events; the port never calls it. K/V are expanded to q's heads
    outside the timing. Full causal (or a window no shorter than S) takes
    `is_causal=True` on the fused backends; a shorter window takes an
    additive band mask (0 where a key is visible, -inf elsewhere) on the
    memory-efficient backend, which visits every key tile. Returns (ms,
    what was called)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window == 0 or window >= S:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            ms = cuda_time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), reps)
        return ms, ("torch.nn.functional.scaled_dot_product_attention"
                    "(is_causal=True), K/V expanded to q's heads, timed as "
                    "a yardstick only")
    pos = torch.arange(S, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    mask = torch.zeros((S, S), dtype=q.dtype, device=q.device).masked_fill_(
        ~band, float("-inf"))[None, None]
    del band
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        ms = cuda_time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), reps)
    return ms, ("torch.nn.functional.scaled_dot_product_attention(attn_mask="
                f"band of {window} keys, additive bf16 [1, 1, S, S]), "
                "memory-efficient backend, K/V expanded to q's heads, "
                "timed as a yardstick only")


def model_kernel_entries(fa_ops, ssd_ops, launches, shapes, worst):
    """The kernels-line entries of flash_attention and ssd: each kernel at
    the long-prefill shape (ms, bound, library call) and at the request
    shape (ms, bound, plain version, library call), by CUDA events.
    These launches are not the main path's and are not counted in it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf16 = torch.bfloat16
    entries = []

    B, S, H, K, hd, win = shapes["fa"]["long"]
    q, k, v = fa_inputs(B, S, H, K, hd, bf16, gen)
    fa_long = cuda_time_ms(lambda: fa_ops.flash_attention(
        q, k, v, window=win, use_kernel=True), reps=2)
    lib_long, lib_call = sdpa_time_ms(q, k, v, win, reps=2)
    b_long, by_long = bound(*fa_cost(B, S, H, K, hd, win))
    del q, k, v
    B2, S2, H2, K2, hd2, win2 = shapes["fa"]["request"]
    q, k, v = fa_inputs(B2, S2, H2, K2, hd2, bf16, gen)
    fa_req = cuda_time_ms(lambda: fa_ops.flash_attention(
        q, k, v, window=win2, use_kernel=True), reps=10)
    plain_req = cuda_time_ms(lambda: fa_ops.flash_attention(
        q, k, v, window=win2, use_kernel=False), reps=10)
    lib_req, _ = sdpa_time_ms(q, k, v, win2, reps=10)
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
        "library_ms": lib_long, "library_call": lib_call,
        "plain_ms": plain_req,
        "plain_shape_b_s_h_k_hd": [B2, S2, H2, K2, hd2],
        "ms_at_plain_shape": fa_req, "bound_ms_at_plain_shape": b_req,
        "library_ms_at_plain_shape": lib_req})
    del q, k, v

    from repro_torch.models.ssm import ssd_chunked
    B, S, H, P, N, chunk = shapes["ssd"]["long"]
    x, dt, a, b, c = ssd_inputs(B, S, H, P, N, bf16, gen)
    ssd_long = cuda_time_ms(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk, use_kernel=True), reps=5)
    # the model's plain chunked path (cuBLAS einsums, a loop over chunks):
    # a yardstick of several calls, never called on the kernel path
    chunked_long = cuda_time_ms(lambda: ssd_chunked(x, dt, a, b, c,
                                                    chunk=chunk), reps=2)
    peak_long = alloc_peak_bytes(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk, use_kernel=True))
    b_long, by_long = bound(*ssd_cost(B, S, H, P, N, chunk))
    del x, dt, a, b, c
    B2, S2, H2, P2, N2, chunk2 = shapes["ssd"]["request"]
    x, dt, a, b, c = ssd_inputs(B2, S2, H2, P2, N2, bf16, gen)
    ssd_req = cuda_time_ms(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk2, use_kernel=True), reps=10)
    chunked_req = cuda_time_ms(lambda: ssd_chunked(x, dt, a, b, c,
                                                   chunk=chunk2), reps=10)
    # the plain version is S2 sequential steps of a few launches each
    plain_req = cuda_time_ms(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk2, use_kernel=False), reps=1)
    peak_req = alloc_peak_bytes(lambda: ssd_ops.ssd(
        x, dt, a, b, c, chunk=chunk2, use_kernel=True))
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
                        "SSD scan; ssd_chunked_ms times the model's plain "
                        "chunked path (models/ssm.py::ssd_chunked, cuBLAS "
                        "einsums in a loop over chunks), as a yardstick only",
        "ssd_chunked_ms": chunked_long,
        "alloc_peak_bytes": peak_long,
        "plain_ms": plain_req,
        "plain_shape_b_s_h_p_n_chunk": [B2, S2, H2, P2, N2, chunk2],
        "ms_at_plain_shape": ssd_req, "bound_ms_at_plain_shape": b_req,
        "ssd_chunked_ms_at_plain_shape": chunked_req,
        "alloc_peak_bytes_at_plain_shape": peak_req})
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
        # the bf16 kernel sums in one fixed order: back-to-back calls agree
        # to the bit
        first = gmm_ops.expert_ffn(x, wg, wu, wd, use_kernel=True)
        equal = torch.equal(first, gmm_ops.expert_ffn(x, wg, wu, wd,
                                                      use_kernel=True))
        assert equal, f"moe_gmm at C = {C}: two calls differ"
        del first
        at[name] = {"shape_ge_c_d_f": [E, C, d, f], "ms": ms,
                    "bound_ms": b, "bound_by": by, "three_bmm_ms": bmm_ms,
                    "two_calls_torch_equal": equal}
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
        "two_calls_torch_equal": all(a["two_calls_torch_equal"]
                                     for a in at.values()),
        "decode": at["decode"]}

    fa_extra = {}
    for name, reps in (("long", 2), ("request", 10)):
        B, S, H, K, hd, win = shapes["fa"][name]
        q, k, v = fa_inputs(B, S, H, K, hd, bf16, gen)
        fa_ms = cuda_time_ms(lambda: fa_ops.flash_attention(
            q, k, v, window=win, use_kernel=True), reps=reps)
        lib_ms, lib_call = sdpa_time_ms(q, k, v, win, reps=reps)
        b, by = bound(*fa_cost(B, S, H, K, hd, win))
        del q, k, v
        fa_extra[f"mixtral_{name}"] = {
            "shape_b_s_h_k_hd_window": [B, S, H, K, hd, win], "ms": fa_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "library_call": lib_call}
    return entry, fa_extra


def kernels_line(ops_mod, kernel_mod, launches_by_path, timing, max_abs_err,
                 model_entries):
    """Time sweep_scan on the main path's own buckets and print the
    kernels line: the kernel at the largest bucket beside its bounds,
    and kernel and plain version side by side (and compared) at the
    largest bucket the plain version can walk; then the model path's
    kernels (`model_kernel_entries`). The timing launches pass no
    counter (``stats``), so they are not counted in any path's launches."""
    def run(use_kernel, t):
        return ops_mod.sweep_scan(t["res"], t["dur"], t["lag"], t["deps"],
                                  n_resources=t["n_resources"],
                                  use_kernel=use_kernel)

    big, mid = timing["largest"], timing["plain"]
    C, N = big["res"].shape
    kernel_ms = cuda_time_ms(lambda: run(True, big), reps=3)
    # one candidate alone on the card: N dependent steps at the latency
    # of one step, the floor a sequential recurrence cannot go below
    one = {k: (v[:1].contiguous() if torch.is_tensor(v) else v)
           for k, v in big.items()}
    chain_ms = cuda_time_ms(lambda: run(True, one), reps=3)
    # the general walk, which the kernel takes for a candidate with any
    # negative or NaN dur or lag, at the same shape: every lag made
    # negative (a negative net_latency's buckets)
    neg = dict(big, lag=(big["lag"] - 1.0).contiguous())
    general_ms = cuda_time_ms(lambda: run(True, neg), reps=3)
    # the latency of one dependent step through a shared-memory store and
    # load (the source's probe: one thread, a chain that forwards nothing
    # in registers). The kernel's chain forwards the row before in
    # registers and skips that round trip, so this is a point of
    # comparison for chain_ns_per_step, not a lower bound under it
    probe_steps = 1 << 20
    chain_bound_ns = cuda_time_ms(lambda: kernel_mod.chain_probe(probe_steps),
                                  reps=3) * 1e6 / probe_steps
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
    bytes_ms = BYTES_PER_OPROW * C * N / PEAK_BYTES_PER_S * 1e3
    flops_ms = FLOPS_PER_OPROW * C * N / PEAK_F64_FLOPS * 1e3
    emit({"kernels": [{
        "name": "sweep_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/sweep_scan/csrc/sweep_scan.cu",
        "replaces": "src/repro/kernels/sweep_scan/kernel.py:95",
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max(max_abs_err, err),
        "shape_c_n_r": [C, N, big["n_resources"]],
        "ms": kernel_ms, "kernel_ms": kernel_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "chain_ms": chain_ms, "chain_ns_per_step": chain_ms * 1e6 / N,
        "chain_bound_ns": chain_bound_ns,
        "general_walk_ms": general_ms,
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
    from repro_torch.core import ref_sim, torch_sim
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
    # (K1 counts in its session's CacheStats, which each path resets; K2-K4
    # in a KernelCounts each model path makes for itself)
    scan_launches = {}
    scan_launches["main_path"], timing, warm = phase_main_path(core)
    scan_launches["backends_path"] = phase_backends_path(core, warm)
    scan_launches["advisor_path"] = phase_advisor_path(core, warm)
    del warm
    scan_launches["fixture_sweep"] = phase_fixture_sweep(core, torch_sim,
                                                         ref_sim)
    phase_exact_path(core)
    model_launches, model_shapes = phase_model_path(fa_ops, ssd_ops, gmm_ops)
    moe_launches, moe_shapes = phase_moe_path(fa_ops, ssd_ops, gmm_ops)
    scan_launches["train_path"] = phase_train_path()
    # K2 runs on both serving paths: its launches are the two counts
    by_path = {"model_path": model_launches["flash_attention"],
               "moe_path": moe_launches["flash_attention"]}
    model_launches["flash_attention"] = sum(by_path.values())
    model_entries = model_kernel_entries(fa_ops, ssd_ops,
                                         model_launches, model_shapes,
                                         model_worst)
    gmm_entry, fa_moe = moe_kernel_entries(fa_ops, gmm_ops, moe_launches,
                                           moe_shapes, model_worst)
    model_entries[0].update(fa_moe, launches_by_path=by_path)
    kernels_line(ops_mod, kernel_mod, scan_launches, timing, max_abs_err,
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
