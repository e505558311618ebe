"""Tests of the port that need a CUDA card and `nvcc`: they launch the
hand-written kernels (sweep_scan, flash_attention, ssd), which have no
CPU mode.

Every test here carries the ``gpu`` marker and decides inside the test
whether a card is present, skipping with the reason when it is not. The
file imports `repro_torch` only, so it runs on a machine that has
PyTorch with CUDA and nothing of the reference's stack:

    python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance for sweep_scan: none. The recurrence is `max` and `+` in f64
in one order, so the kernel is `torch.equal` to its plain version, and a
sweep on the card equals the same sweep on the CPU element for element.
For flash_attention and ssd: the reference's `_tol` (f32 1e-5, bf16
2e-2), both sides computing in f32 in another order; the SSD state at
1e-4 / 5e-2 as the reference holds its own kernel.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import workloads as TW
from repro_torch import configs as TC
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.sweep_scan import kernel as t_kernel
from repro_torch.kernels.sweep_scan import ops as t_ops
from repro_torch.models import forward, init

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


# (B, S, H, K, hd, window): tests/test_kernels.py's rows, zamba2's
# request shape, and a ragged length (S not a multiple of the 64-row tile)
FA_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 128, 4, 4, 32, 0), (2, 256, 8, 2, 64, 64),
             (1, 512, 2, 1, 128, 128), (3, 192, 6, 3, 16, 0),
             (2, 512, 32, 32, 80, 0), (1, 100, 4, 2, 80, 7)]
# (B, S, H, P, N, chunk): tests/test_kernels.py's rows and zamba2's
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 16, 8, 64),
              (2, 96, 3, 8, 4, 32), (1, 64, 8, 64, 32, 64),
              (2, 512, 80, 64, 64, 256)]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain_version(dtype):
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, K, hd, win in FA_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
        want = fa_ops.flash_attention(q, k, v, window=win, use_kernel=False)
        before = fa_ops.launch_count()
        got = fa_ops.flash_attention(q, k, v, window=win, use_kernel=True)
        torch.cuda.synchronize()
        assert fa_ops.launch_count() == before + 1
        torch.testing.assert_close(got.float(), want.float(), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_equals_plain_version(dtype):
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for B, S, H, P, N, chunk in SSD_SHAPES:
        x = (randn(B, S, H, P) * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(randn(B, S, H))
        a = torch.exp(torch.rand(H, generator=g, device="cuda"))
        b, c = ((randn(B, S, N) * 0.5).to(dtype) for _ in "bc")
        y0, h0 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=False)
        before = ssd_ops.launch_count()
        y1, h1 = ssd_ops.ssd(x, dt, a, b, c, chunk=chunk, use_kernel=True)
        torch.cuda.synchronize()
        assert ssd_ops.launch_count() == before + 1
        torch.testing.assert_close(y1.float(), y0.float(), **tol(dtype))
        htol = dict(rtol=5e-2, atol=5e-2) if dtype == torch.bfloat16 \
            else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h1, h0, **htol)


@pytest.mark.gpu
def test_zamba2_forward_kernels_equal_plain_path_in_f32():
    """The reduced hybrid in f32 on the card: the kernel path (one K2
    launch per shared-block application, one K3 launch per Mamba2 layer)
    against the plain path."""
    need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TC.get("zamba2-2.7b").reduced().replace(dtype="float32")
    params = init(torch.Generator(device="cuda").manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda")
    plain = forward(params, toks, cfg, use_kernel=False)
    fa_ops.reset_launch_count()
    ssd_ops.reset_launch_count()
    fast = forward(params, toks, cfg, use_kernel=True)
    torch.cuda.synchronize()
    assert fa_ops.launch_count() == cfg.n_layers // cfg.shared_attn_every
    assert ssd_ops.launch_count() == cfg.n_layers
    torch.testing.assert_close(fast, plain, rtol=1e-4, atol=5e-4)
