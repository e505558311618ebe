"""The port's SSD package against the reference's.

On a CPU-only host the CUDA kernel cannot run, so what is compared here
is its plain PyTorch version (`repro_torch.kernels.ssd`, the sequential
recurrence the kernel is held against on the card by `chip_smoke.py` and
`tests/test_torch_gpu.py`): against the reference's Pallas kernel in
interpret mode and its `ssd_ref` oracle, on the shape rows of
`tests/test_kernels.py` plus zamba2's (P, N) = (64, 64), from the same
seeded NumPy inputs. Tolerances are the reference's: y at `_tol` (f32
1e-5, bf16 2e-2: y is rounded to bf16), the f32 state at 1e-4 (f32) and
5e-2 (bf16 inputs), as `tests/test_kernels.py` holds its own kernel.
Also the port's `ssd_chunked` / `ssd_step` (the model's plain paths),
the mask on the exponent, and the wrapper's checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_kernel as j_ssd_kernel
from repro.kernels.ssd.ops import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.models.ssm import ssd_chunked as j_ssd_chunked

from repro_torch.kernels.ssd import kernel as t_kernel
from repro_torch.kernels.ssd import ops as t_ops
from repro_torch.kernels.ssd import ref as t_ref
from repro_torch.models.interop import tensor_from_numpy
from repro_torch.models.ssm import ssd_chunked as t_ssd_chunked
from repro_torch.models.ssm import ssd_step as t_ssd_step

# small tensors, one op at a time: the intra-op pool costs more than it
# gives and fights the other test workers for cores
torch.set_num_threads(1)

# (B, S, H, P, N, chunk): tests/test_kernels.py's rows plus zamba2's
# head width and state (P = N = 64) at a short sequence
ROWS = [
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 16, 8, 64),
    (2, 96, 3, 8, 4, 32),
    (1, 64, 8, 64, 32, 64),     # single chunk
    (1, 128, 2, 64, 64, 64),    # zamba2's (P, N)
]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def inputs(B, S, H, P, N, seed, jdt=jnp.float32):
    """Seeded inputs as the reference's tests draw them (x, b, c scaled by
    0.5, dt = softplus(normal), a = exp(uniform[0, 1))), rounded to the
    working dtype once on the JAX side and handed over bit for bit."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, S, H, P)) * 0.5, jnp.float32)
    dt = jax.nn.softplus(jnp.asarray(rng.standard_normal((B, S, H)),
                                     jnp.float32))
    a = jnp.exp(jnp.asarray(rng.uniform(0.0, 1.0, (H,)), jnp.float32))
    b = jnp.asarray(rng.standard_normal((B, S, N)) * 0.5, jnp.float32)
    c = jnp.asarray(rng.standard_normal((B, S, N)) * 0.5, jnp.float32)
    j = (x.astype(jdt), dt, a, b.astype(jdt), c.astype(jdt))
    t = tuple(tensor_from_numpy(np.asarray(v), "cpu") for v in j)
    return j, t


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def y_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def h_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,P,N,chunk", ROWS)
def test_plain_version_matches_reference_kernel_and_oracle(B, S, H, P, N,
                                                           chunk, dtype):
    (jx, jdt_, ja, jb, jc), (tx, tdt, ta, tb, tc) = \
        inputs(B, S, H, P, N, S + P + N, DTYPES[dtype])
    before = t_ops.launch_count()
    y, h = t_ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, use_kernel=True)
    assert t_ops.launch_count() == before         # CPU tensors: plain version
    assert y.shape == (B, S, H, P) and y.dtype == tx.dtype
    assert h.shape == (B, H, N, P) and h.dtype == torch.float32
    jy, jh = j_ssd(jx, jdt_, ja, jb, jc, chunk=chunk)
    np.testing.assert_allclose(as_np(y), as_np(jy), **y_tol(dtype))
    np.testing.assert_allclose(as_np(h), as_np(jh), **h_tol(dtype))
    fy, fh = j_ssd_ref(
        jx.transpose(0, 2, 1, 3).reshape(B * H, S, P),
        jdt_.transpose(0, 2, 1).reshape(B * H, S), jnp.tile(ja, B),
        jnp.repeat(jb[:, None], H, 1).reshape(B * H, S, N),
        jnp.repeat(jc[:, None], H, 1).reshape(B * H, S, N))
    np.testing.assert_allclose(
        as_np(y), as_np(fy.reshape(B, H, S, P).transpose(0, 2, 1, 3)),
        **y_tol(dtype))
    np.testing.assert_allclose(as_np(h), as_np(fh.reshape(B, H, N, P)),
                               **h_tol(dtype))


@pytest.mark.parametrize("B,S,H,P,N,chunk", ROWS)
def test_ssd_chunked_matches_reference_and_oracle(B, S, H, P, N, chunk):
    """The model's plain chunked path, in f32: against the reference's
    `ssd_chunked` (1e-5 on y, 1e-4 on h: the same algorithm, summed in
    another order) and the port's sequential oracle (1e-4: exp(cum_t -
    cum_s) against a product of per-step decays)."""
    (jx, jdt_, ja, jb, jc), (tx, tdt, ta, tb, tc) = inputs(B, S, H, P, N, 5)
    y, h = t_ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk)
    jy, jh = j_ssd_chunked(jx, jdt_, ja, jb, jc, chunk=chunk)
    np.testing.assert_allclose(as_np(y), as_np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(as_np(h), as_np(jh), rtol=1e-4, atol=1e-4)
    py, ph = t_ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, use_kernel=False)
    np.testing.assert_allclose(as_np(y), as_np(py), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(as_np(h), as_np(ph), rtol=1e-4, atol=1e-4)


def test_ssd_chunking_invariance_and_initial_state():
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 128, 2, 16, 8, 9)
    y32, h32 = t_ssd_chunked(tx, tdt, ta, tb, tc, chunk=32)
    y128, h128 = t_ssd_chunked(tx, tdt, ta, tb, tc, chunk=128)
    torch.testing.assert_close(y32, y128, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h32, h128, rtol=1e-4, atol=1e-4)
    # the second half from the first half's state equals the whole
    _, h_half = t_ssd_chunked(tx[:, :64], tdt[:, :64], ta, tb[:, :64],
                              tc[:, :64], chunk=32)
    y2, h2 = t_ssd_chunked(tx[:, 64:], tdt[:, 64:], ta, tb[:, 64:],
                           tc[:, 64:], chunk=32, h0=h_half)
    torch.testing.assert_close(y2, y32[:, 64:], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h2, h32, rtol=1e-4, atol=1e-4)


def test_ssd_step_continues_the_chunked_scan():
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 65, 2, 8, 4, 13)
    S = 64
    y_full, _ = t_ssd_chunked(tx, tdt, ta, tb, tc, chunk=S + 1)
    _, h_prefix = t_ssd_chunked(tx[:, :S], tdt[:, :S], ta, tb[:, :S],
                                tc[:, :S], chunk=S)
    y_step, _ = t_ssd_step(tx[:, S], tdt[:, S], ta, tb[:, S], tc[:, S],
                           h_prefix)
    torch.testing.assert_close(y_step, y_full[:, S], rtol=1e-4, atol=1e-4)


def test_exponent_mask_keeps_strong_decay_finite():
    """Large dt * a makes cum_t - cum_s hugely positive above the
    diagonal; masking after exp would give inf * 0 = nan. The chunked
    path and the sequential oracle stay finite and agree."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 64, 2, 8, 4, 17)
    tdt = tdt * 40.0                      # cum reaches about -1e4 in a chunk
    y, h = t_ssd_chunked(tx, tdt, ta, tb, tc, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    py, ph = t_ops.ssd(tx, tdt, ta, tb, tc, chunk=64, use_kernel=True)
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-4)


def test_wrapper_checks():
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 96, 2, 8, 4, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ops.ssd(tx, tdt, ta, tb, tc, chunk=64, use_kernel=True)
    with pytest.raises(TypeError):
        t_ops.ssd(tx, tdt.double(), ta, tb, tc, chunk=32, use_kernel=True)
    with pytest.raises(TypeError):
        t_ops.ssd(tx, tdt, ta, tb.bfloat16(), tc, chunk=32, use_kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.ssd(tx.transpose(1, 2).contiguous().transpose(1, 2), tdt, ta,
                  tb, tc, chunk=32, use_kernel=True)
    with pytest.raises(ValueError):
        t_ops.ssd(tx, tdt, ta[:1].contiguous(), tb, tc, chunk=32,
                  use_kernel=True)
    with pytest.raises(ValueError):
        t_ops.ssd(tx, tdt, ta, tb[:, :48].contiguous(), tc, chunk=32,
                  use_kernel=True)


def test_kernel_entry_refuses_what_it_cannot_launch():
    """The launch path refuses an (N, P) without an instantiation, a
    chunk longer than one prefix-sum pass, and a CPU tensor, before it
    builds anything."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 64, 2, 8, 6, 1)
    with pytest.raises(ValueError, match="instantiation"):
        t_kernel.ssd_cuda(tx, tdt, ta, tb, tc, chunk=32)
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 512, 2, 8, 4, 1)
    with pytest.raises(ValueError, match="exceeds"):
        t_kernel.ssd_cuda(tx, tdt, ta, tb, tc, chunk=512)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.ssd_cuda(tx, tdt, ta, tb, tc, chunk=256)
    assert (64, 64) in t_kernel.SHAPES


# ---------------- the kernel's three stages, in plain PyTorch ------------------------

def bh_layout(jx, jdt_, ja, jb, jc):
    """Model layout -> the reference kernel's [B*H, ...] rows."""
    B, S, H, P = jx.shape
    N = jb.shape[-1]
    return (jx.transpose(0, 2, 1, 3).reshape(B * H, S, P),
            jdt_.transpose(0, 2, 1).reshape(B * H, S), jnp.tile(ja, B),
            jnp.repeat(jb[:, None], H, 1).reshape(B * H, S, N),
            jnp.repeat(jc[:, None], H, 1).reshape(B * H, S, N))


def from_bh(y, h, B, S, H, P, N):
    return (as_np(y).reshape(B, H, S, P).transpose(0, 2, 1, 3),
            as_np(h).reshape(B, H, N, P))


def zamba2_decay_inputs(B, S, H, P, N, seed):
    """zamba2's decay strength: A drawn in [1, 16] as its `ssm_alog` init
    draws it, dt = softplus(normal), so |cum| reaches the hundreds within
    a 64-step chunk and exp(cum_t - cum_s) spans the f32 range."""
    (jx, jdt_, _, jb, jc), (tx, tdt, _, tb, tc) = inputs(B, S, H, P, N, seed)
    a = np.random.default_rng(seed + 1).uniform(1.0, 16.0, (H,))
    ja = jnp.asarray(a, jnp.float32)
    return (jx, jdt_, ja, jb, jc), (tx, tdt, tensor_from_numpy(
        np.asarray(ja), "cpu"), tb, tc)


STAGED_ROWS = ROWS + [(1, 256, 2, 64, 64, 64)]   # the last: zamba2's decay


def staged_inputs(B, S, H, P, N, chunk, jdt=jnp.float32):
    if (B, S, H, P, N, chunk) == STAGED_ROWS[-1]:
        j, t = zamba2_decay_inputs(B, S, H, P, N, 21)
        if jdt != jnp.float32:
            j = (j[0].astype(jdt), j[1], j[2], j[3].astype(jdt),
                 j[4].astype(jdt))
            t = tuple(tensor_from_numpy(np.asarray(v), "cpu") for v in j)
        return j, t
    return inputs(B, S, H, P, N, 3 * S + N, jdt)


@pytest.mark.parametrize("B,S,H,P,N,chunk", STAGED_ROWS)
def test_staged_decomposition_matches_reference_in_f32(B, S, H, P, N, chunk):
    """chunk_state -> state_pass (h_in in place) -> chunk_scan, with the
    kernel's scratch layouts, against the reference's sequential oracle
    and its Pallas kernel in interpret mode, at 1e-5. At zamba2's decay
    strength the Pallas kernel, which sums cum in f32, is itself 2.7e-5
    (of |y| ~12) from its own oracle; there the stages, which sum cum in
    f64, are held at 1e-5 to the oracle and must be at least as close to
    it as the Pallas kernel is."""
    j, t = staged_inputs(B, S, H, P, N, chunk)
    y, h = t_ref.ssd_staged_ref(*t, chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    fy, fh = from_bh(*j_ssd_ref(*bh_layout(*j)), B, S, H, P, N)
    ky, kh = from_bh(*j_ssd_kernel(*bh_layout(*j), chunk=chunk,
                                   interpret=True), B, S, H, P, N)
    np.testing.assert_allclose(as_np(y), fy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(as_np(h), fh, rtol=1e-5, atol=1e-5)
    if (B, S, H, P, N, chunk) == STAGED_ROWS[-1]:
        for got, pallas, oracle in ((y, ky, fy), (h, kh, fh)):
            assert np.abs(as_np(got) - oracle).max() <= \
                np.abs(pallas - oracle).max()
    else:
        np.testing.assert_allclose(as_np(y), ky, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(as_np(h), kh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", STAGED_ROWS)
def test_staged_decomposition_with_bf16_rounding_points(B, S, H, P, N, chunk):
    """bf16 inputs with every rounding point of the bf16 kernel emulated
    (exp(seg - cum) xdt and h_in rounded to bf16 once each, the weights
    W dt as a bf16 pair): within `_tol`'s 2e-2 of the reference, the
    state within 5e-2."""
    j, t = staged_inputs(B, S, H, P, N, chunk, jnp.bfloat16)
    y, h = t_ref.ssd_staged_ref(*t, chunk=chunk, bf16_points=True)
    assert y.dtype == torch.bfloat16
    fy, fh = from_bh(*j_ssd_ref(*bh_layout(*j)), B, S, H, P, N)
    np.testing.assert_allclose(as_np(y), fy, **y_tol("bfloat16"))
    np.testing.assert_allclose(as_np(h), fh, **h_tol("bfloat16"))


def test_state_pass_writes_h_in_in_place():
    """h_in[0] = 0 and h_in[c + 1] = exp(seg_c) h_in[c] + s_c, written
    over s_c; the returned state is the one after the last chunk, and
    the carried states equal those of the chunked model path run up to
    each chunk boundary."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 128, 2, 16, 8, 31)
    s, eseg = t_ref.chunk_state_ref(tx, tdt, ta, tb, chunk=32)
    s_c = s.clone()
    h = t_ref.state_pass_ref(s, eseg)
    assert torch.equal(s[:, :, 0], torch.zeros_like(s[:, :, 0]))
    for ci in range(3):
        want = eseg[:, :, ci, None, None] * s[:, :, ci] + s_c[:, :, ci]
        torch.testing.assert_close(s[:, :, ci + 1], want)
        _, h_prefix = t_ssd_chunked(tx[:, :32 * (ci + 1)],
                                    tdt[:, :32 * (ci + 1)], ta,
                                    tb[:, :32 * (ci + 1)],
                                    tc[:, :32 * (ci + 1)], chunk=32)
        torch.testing.assert_close(s[:, :, ci + 1], h_prefix, rtol=1e-5,
                                   atol=1e-5)
    _, h_all = t_ssd_chunked(tx, tdt, ta, tb, tc, chunk=32)
    torch.testing.assert_close(h, h_all, rtol=1e-5, atol=1e-5)


def test_chunk_scan_masks_the_exponent():
    """At 40x the decay the deltas above the diagonal overflow exp; the
    chunk_scan stage never takes them and stays finite."""
    (_, _, _, _, _), (tx, tdt, ta, tb, tc) = inputs(1, 64, 2, 8, 4, 17)
    tdt = tdt * 40.0
    y, h = t_ref.ssd_staged_ref(tx, tdt, ta, tb, tc, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    py, ph = t_ops.ssd(tx, tdt, ta, tb, tc, chunk=64, use_kernel=False)
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-4)
