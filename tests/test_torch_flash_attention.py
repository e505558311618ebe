"""The port's flash-attention package against the reference's.

On a CPU-only host the CUDA kernel cannot run, so what is compared here
is its plain PyTorch version (`repro_torch.kernels.flash_attention`,
the function the kernel is held against on the card by `chip_smoke.py`
and by `tests/test_torch_gpu.py`): against the reference's Pallas kernel
in interpret mode and its `attention_ref` oracle, on the shape rows of
`tests/test_kernels.py` plus zamba2's head_dim 80, from the same seeded
NumPy inputs. Tolerances are the reference's `_tol`: f32 1e-5 (both
sides compute in f32, in another order), bf16 2e-2 (the output is
rounded to bf16, one ulp at |x| ~ 2 is 1.6e-2). Also the port's
`flash_mha` (the model's plain blocked path), and the wrapper's checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models.transformer import flash_mha as j_flash_mha

from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.models.interop import tensor_from_numpy
from repro_torch.models.transformer import flash_mha as t_flash_mha

# small tensors, one op at a time: the intra-op pool costs more than it
# gives and fights the other test workers for cores
torch.set_num_threads(1)

# (B, S, H, K, hd, window, block_q, block_kv): tests/test_kernels.py's
# rows (blocks are the reference kernel's; the port's kernel tiles by 64
# whatever they are) plus zamba2's head_dim 80 with H == K
ROWS = [
    (2, 256, 4, 2, 64, 0, 128, 128),
    (1, 128, 4, 4, 32, 0, 64, 32),
    (2, 256, 8, 2, 64, 64, 64, 64),      # sliding window
    (1, 512, 2, 1, 128, 128, 128, 128),  # MQA + window
    (3, 192, 6, 3, 16, 0, 64, 96),       # uneven-ish blocks
    (2, 128, 4, 4, 80, 0, 64, 64),       # zamba2's head_dim
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)


def qkv(B, S, H, K, hd, seed, jdt):
    """Seeded inputs, rounded to the working dtype once on the JAX side
    and handed to both packages bit for bit."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]
    j = [jnp.asarray(a).astype(jdt) for a in arrs]
    t = [tensor_from_numpy(np.asarray(a), "cpu") for a in j]
    return j, t


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,K,hd,win,bq,bkv", ROWS)
def test_plain_version_matches_reference_kernel_and_oracle(
        B, S, H, K, hd, win, bq, bkv, dtype):
    jdt, tdt = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = qkv(B, S, H, K, hd, S + hd, jdt)
    assert tq.dtype == tdt
    before = t_ops.launch_count()
    out = t_ops.flash_attention(tq, tk, tv, window=win, use_kernel=True)
    assert t_ops.launch_count() == before         # CPU tensors: plain version
    assert out.shape == (B, S, H, hd) and out.dtype == tdt
    j_kernel = j_flash(jq, jk, jv, window=win, block_q=bq, block_kv=bkv)
    np.testing.assert_allclose(as_np(out), as_np(j_kernel), **tol(dtype))
    fold = lambda x, n: x.transpose(0, 2, 1, 3).reshape(B * n, S, hd)
    j_oracle = j_attention_ref(fold(jq, H), fold(jk, K), fold(jv, K),
                               window=win).reshape(B, H, S, hd) \
        .transpose(0, 2, 1, 3)
    np.testing.assert_allclose(as_np(out), as_np(j_oracle), **tol(dtype))


@pytest.mark.parametrize("B,S,H,K,hd,win,qb", [
    (2, 256, 4, 2, 32, 0, 64),
    (1, 256, 8, 2, 64, 48, 128),         # sliding window, GQA
    (2, 128, 4, 4, 80, 0, 32),           # zamba2's head_dim
])
def test_flash_mha_matches_reference(B, S, H, K, hd, win, qb):
    """The model's plain blocked path, in f32: against the reference's
    `flash_mha` and the port's own materialised oracle (tolerance 1e-5:
    the same online softmax, summed in another order)."""
    (jq, jk, jv), (tq, tk, tv) = qkv(B, S, H, K, hd, 7, jnp.float32)
    got = t_flash_mha(tq, tk, tv, window=win, q_block=qb, kv_block=qb)
    want = j_flash_mha(jq, jk, jv, window=win, q_block=qb, kv_block=qb)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)
    plain = t_ops.flash_attention(tq, tk, tv, window=win, use_kernel=False)
    np.testing.assert_allclose(as_np(got), as_np(plain), rtol=1e-5, atol=1e-5)


def test_flash_mha_q_offset_matches_reference():
    """q positions offset against the keys (a chunk of queries after a
    prefix), as the reference allows."""
    (jq, jk, jv), (tq, tk, tv) = qkv(1, 64, 4, 2, 16, 3, jnp.float32)
    jq, tq = jq[:, :32], tq[:, :32].contiguous()
    got = t_flash_mha(tq, tk, tv, q_offset=32, q_block=16, kv_block=32)
    want = j_flash_mha(jq, jk, jv, q_offset=32, q_block=16, kv_block=32)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_of_a_tile_follow_the_reference():
    """With a window narrower than a tile, rows see tiles where every
    key is masked; the NEG_INF = -1e30 (not -inf) rule keeps them finite
    and the later valid tile wipes what they summed (corr = 0)."""
    (jq, jk, jv), (tq, tk, tv) = qkv(1, 256, 2, 1, 32, 11, jnp.float32)
    out = t_ops.flash_attention(tq, tk, tv, window=3, use_kernel=True)
    assert torch.isfinite(out).all()
    want = j_flash(jq, jk, jv, window=3, block_q=64, block_kv=64)
    np.testing.assert_allclose(as_np(out), as_np(want), rtol=1e-5, atol=1e-5)


def test_wrapper_checks():
    q = torch.zeros(1, 16, 4, 16)
    k = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="causal"):
        t_ops.flash_attention(q, k, k, causal=False, use_kernel=True)
    with pytest.raises(TypeError):
        t_ops.flash_attention(q.half(), k.half(), k.half(), use_kernel=True)
    with pytest.raises(TypeError):
        t_ops.flash_attention(q, k.bfloat16(), k, use_kernel=True)
    with pytest.raises(ValueError, match="contiguous"):
        t_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, k, use_kernel=True)
    with pytest.raises(ValueError, match="H % K"):
        t_ops.flash_attention(torch.zeros(1, 16, 3, 16), k, k, use_kernel=True)
    with pytest.raises(ValueError):
        t_ops.flash_attention(q, torch.zeros(1, 16, 2, 8),
                              torch.zeros(1, 16, 2, 8), use_kernel=True)
    with pytest.raises(ValueError, match="window"):
        t_ops.flash_attention(q, k, k, window=-1, use_kernel=True)


def test_kernel_entry_refuses_what_it_cannot_launch():
    """The launch path refuses a head_dim without an instantiation and a
    CPU tensor, before it builds anything."""
    k = torch.zeros(1, 16, 2, 48)
    with pytest.raises(ValueError, match="head_dim 48"):
        t_kernel.flash_attention_cuda(torch.zeros(1, 16, 4, 48), k, k)
    k = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.flash_attention_cuda(torch.zeros(1, 16, 4, 64), k, k)
    assert set(t_kernel.HEAD_DIMS) >= {16, 32, 64, 80, 128}
