"""Tests of the port that need a CUDA card and `nvcc`: they launch the
hand-written sweep-scan kernel, which has no CPU mode.

Every test here carries the ``gpu`` marker and decides inside the test
whether a card is present, skipping with the reason when it is not. The
file imports `repro_torch` only, so it runs on a machine that has
PyTorch with CUDA and nothing of the reference's stack:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: none. The recurrence is `max` and `+` in f64 in one order, so
the kernel is `torch.equal` to its plain version, and a sweep on the
card equals the same sweep on the CPU element for element.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch.kernels.sweep_scan import kernel as t_kernel
from repro_torch.kernels.sweep_scan import ops as t_ops

MAXD = 4
# (n_ops, n_cand, n_res, seed)
SHAPES = [(1, 1, 1, 0), (7, 3, 4, 1), (8, 2, 8, 2), (9, 5, 3, 3),
          (19, 4, 6, 4), (600, 4, 8, 9)]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


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


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_the_card():
    """The CUDA kernel itself, in both memory regimes (`chip_smoke.py`
    runs the same comparison at more and larger shapes)."""
    need_card()
    for n_ops, n_cand, n_res, seed in SHAPES:
        args = [torch.from_numpy(a).cuda()
                for a in random_bucket(n_ops, n_cand, n_res, seed)]
        mk_p, end_p = t_ops.sweep_scan(*args, n_resources=n_res,
                                       use_kernel=False)
        base = t_kernel.load().sweep_scan_base_smem_bytes(n_res)
        for cap in (t_kernel.MAX_SMEM_BYTES, base):
            before = t_ops.launch_count()
            mk_k, end_k = t_ops.sweep_scan(*args, n_resources=n_res,
                                           use_kernel=True,
                                           max_smem_bytes=cap)
            torch.cuda.synchronize()
            assert t_ops.launch_count() == before + 1
            assert torch.equal(mk_k, mk_p) and torch.equal(end_k, end_p)


@pytest.mark.gpu
def test_sweep_on_the_card_equals_sweep_on_the_cpu():
    """The slice end to end: the same faulted grid through a CUDA
    session (kernel) and a CPU session (plain version)."""
    need_card()
    cands = T.grid(n_nodes=[6], chunk_sizes=[T.MB], replications=(1, 2),
                   faults=(None, T.parse_faults("disk=0:8,kill=1@40")))

    def workflow_for(c):
        return TW.blast(c.n_app, n_queries=6, db_mb=8)

    with T.SweepSession() as gpu, T.SweepSession(device="cpu") as cpu:
        t_ops.reset_launch_count()
        eg = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=gpu)
        ec = T.explore(workflow_for, cands, T.PAPER_RAMDISK, verify_top_k=2,
                       session=cpu)
        assert gpu.device.type == "cuda"
        assert gpu.stats.kernel_buckets > 0
        assert gpu.stats.kernel_fallbacks == 0
        assert t_ops.launch_count() > 0
    assert [e.index for e in eg] == [e.index for e in ec]
    assert [e.scan_makespan for e in eg] == [e.scan_makespan for e in ec]
    assert [e.makespan for e in eg] == [e.makespan for e in ec]
