"""The port's grouped expert-FFN package against the reference's.

On a CPU-only host the CUDA kernel cannot run, so what is compared here
is its plain PyTorch version (`repro_torch.kernels.moe_gmm`, the
function the kernel is held against on the card by `chip_smoke.py` and
by `tests/test_torch_gpu.py`): against the reference's Pallas kernel in
interpret mode and its `expert_ffn_ref` oracle, on the shape rows of
`tests/test_kernels.py`, from the same seeded NumPy inputs. Tolerances
are the reference's `_tol`: f32 1e-5 (both sides compute in f32, in
another order), bf16 2e-2 (the output is rounded to bf16 once). A row
with C = 136 (over 128 and no multiple of it, which the reference's
kernel refuses) is held against the oracle only. Also the wrapper's
checks and its launch counter.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import expert_ffn as j_expert_ffn
from repro.kernels.moe_gmm.ref import expert_ffn_ref as j_expert_ffn_ref

from repro_torch.kernels.counts import KernelCounts
from repro_torch.kernels.moe_gmm import kernel as t_kernel
from repro_torch.kernels.moe_gmm import ops as t_ops
from repro_torch.kernels.moe_gmm import ref as t_ref
from repro_torch.models.interop import tensor_from_numpy

# small tensors, one op at a time: the intra-op pool costs more than it
# gives and fights the other test workers for cores
torch.set_num_threads(1)

# (G, E, C, d, f, block_c, block_f): tests/test_kernels.py's rows
ROWS = [
    (1, 4, 64, 32, 64, 32, 32),
    (2, 2, 128, 64, 128, 64, 64),
    (1, 8, 32, 16, 48, 32, 16),
    (4, 2, 64, 128, 64, 16, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def inputs(G, E, C, d, f, seed, jdt):
    """Seeded inputs scaled as the reference's test draws them, rounded
    to the working dtype once on the JAX side and handed to both
    packages bit for bit."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((G * E, C, d)) * 0.3,
            rng.standard_normal((E, d, f)) * 0.1,
            rng.standard_normal((E, d, f)) * 0.1,
            rng.standard_normal((E, f, d)) * 0.1]
    j = [jnp.asarray(a.astype(np.float32)).astype(jdt) for a in arrs]
    t = [tensor_from_numpy(np.asarray(a), "cpu") for a in j]
    return j, t


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G,E,C,d,f,bc,bf", ROWS)
def test_plain_version_matches_reference_kernel_and_oracle(
        G, E, C, d, f, bc, bf, dtype):
    jdt, tdt = DTYPES[dtype]
    (jx, jwg, jwu, jwd), (tx, twg, twu, twd) = inputs(G, E, C, d, f,
                                                      C + d + f, jdt)
    counts = KernelCounts()
    out = t_ops.expert_ffn(tx, twg, twu, twd, use_kernel=True,
                           counts=counts)
    assert counts == KernelCounts()               # CPU tensors: plain version
    assert out.shape == (G * E, C, d) and out.dtype == tdt
    j_kernel = j_expert_ffn(jx, jwg, jwu, jwd, block_c=bc, block_f=bf)
    np.testing.assert_allclose(as_np(out), as_np(j_kernel), **tol(dtype))
    j_oracle = j_expert_ffn_ref(jx, jwg, jwu, jwd)
    np.testing.assert_allclose(as_np(out), as_np(j_oracle), **tol(dtype))
    np.testing.assert_array_equal(
        as_np(t_ref.expert_ffn_ref(tx, twg, twu, twd)), as_np(out))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_capacity_that_is_no_multiple_of_128_matches_the_oracle(dtype):
    """C = 136: the reference's kernel asserts C % block_c == 0 and
    refuses it; the port (and its kernel) takes any C."""
    jdt, _ = DTYPES[dtype]
    (jx, jwg, jwu, jwd), (tx, twg, twu, twd) = inputs(1, 4, 136, 32, 64, 5,
                                                      jdt)
    with pytest.raises(AssertionError):
        j_expert_ffn(jx, jwg, jwu, jwd, block_c=128, block_f=64)
    out = t_ops.expert_ffn(tx, twg, twu, twd, use_kernel=False)
    np.testing.assert_allclose(as_np(out),
                               as_np(j_expert_ffn_ref(jx, jwg, jwu, jwd)),
                               **tol(dtype))


def test_groups_share_expert_weights_by_index():
    """Group ge runs expert ge % E: with G = 3 dispatch groups holding
    the same tokens, the three outputs are equal."""
    _, (tx, twg, twu, twd) = inputs(1, 2, 16, 16, 24, 9, jnp.float32)
    x3 = tx.repeat(3, 1, 1)
    out = t_ops.expert_ffn(x3, twg, twu, twd, use_kernel=False)
    one = t_ops.expert_ffn(tx, twg, twu, twd, use_kernel=False)
    for g in range(3):
        torch.testing.assert_close(out[2 * g:2 * g + 2], one, rtol=0, atol=0)


def test_wrapper_checks():
    x = torch.zeros(4, 8, 16)
    wg = torch.zeros(2, 16, 24)
    wd = torch.zeros(2, 24, 16)
    with pytest.raises(TypeError):
        t_ops.expert_ffn(x.half(), wg.half(), wg.half(), wd.half(),
                         use_kernel=True)
    with pytest.raises(TypeError):
        t_ops.expert_ffn(x, wg.bfloat16(), wg, wd, use_kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.expert_ffn(x.transpose(0, 1).contiguous().transpose(0, 1), wg,
                         wg, wd, use_kernel=True)
    with pytest.raises(ValueError, match="wd"):
        t_ops.expert_ffn(x, wg, wg, wd.transpose(1, 2).contiguous(),
                         use_kernel=True)
    with pytest.raises(ValueError, match="% E"):
        t_ops.expert_ffn(torch.zeros(3, 8, 16), wg, wg, wd, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.moe_gmm_cuda(x, wg, wg, wd)


def test_plain_version_in_f64_is_the_exact_oracle():
    """Given f64 inputs the plain version computes in f64 (the card holds
    the f32 kernel against it); f32 inputs round to the same values."""
    _, (tx, twg, twu, twd) = inputs(1, 2, 16, 16, 24, 11, jnp.float32)
    exact = t_ref.expert_ffn_ref(*(t.double() for t in (tx, twg, twu, twd)))
    assert exact.dtype == torch.float64
    torch.testing.assert_close(t_ref.expert_ffn_ref(tx, twg, twu, twd),
                               exact.float(), rtol=1e-6, atol=1e-6)


def test_launch_counter_resets():
    """The launch counts are the caller's: a new `KernelCounts` (the
    reset) has every field at 0, and the kernel package keeps no counter
    of its own to reset."""
    assert dataclasses.asdict(KernelCounts()) == {
        "flash_attention": 0, "ssd": 0, "moe_gmm": 0}
    assert not hasattr(t_ops, "launch_count")
    assert not hasattr(t_ops, "reset_launch_count")
