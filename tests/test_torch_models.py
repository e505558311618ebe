"""The port's model serving path against the reference's.

Parameters come from `repro.models.init` and are carried over leaf for
leaf by `repro_torch.models.interop`; tokens come from a NumPy seed. The
port runs on the CPU, so ``use_kernel=True`` there takes the plain
versions of its two kernels (the kernels themselves are held against
those on the card by `chip_smoke.py` and `tests/test_torch_gpu.py`); the
reference runs with ``use_kernel`` False and True (Pallas interpret
mode) alike.

Tolerances, and why:
- f32 (``cfg.replace(dtype="float32")``, where the point is the
  algorithm): logits, caches and states within rtol 1e-4 / atol 5e-4 —
  the same arithmetic summed in another order (cumsum, matmuls, exp of
  chunked cum) through a few layers of activations up to |x| ~ 40.
- bf16 (the configs' default): bf16 rounds at other places in the two
  frameworks (XLA fuses and rounds elementwise chains differently from
  PyTorch's eager ops; rsqrt differs in the last f32 bit), and with the
  reference's init the activations reach the tens, where one bf16 ulp is
  0.125-0.25 and a flipped rounding of dt moves a whole SSM head. So no
  element-wise bound holds; what is held is that the mean absolute
  logit difference stays under `_tol`'s 2e-2, and that the port's bf16
  logits are no further from the f32 logits than the reference's own
  bf16 logits are (times 1.5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import forward as j_forward
from repro.models import init as j_init
from repro.models import init_decode_state as j_init_decode_state
from repro.models import layers as JL
from repro.models import model_defs as j_model_defs
from repro.models import n_params as j_n_params
from repro.train.step import make_serve_step as j_make_serve_step

from repro_torch import configs as TC
from repro_torch.models import cast_params, init, init_decode_state, model_defs
from repro_torch.models import forward as t_forward
from repro_torch.models import layers as TL
from repro_torch.models import n_params as t_n_params
from repro_torch.models.interop import (decode_state_from_numpy,
                                        params_from_numpy, tensor_from_numpy)
from repro_torch.train.step import make_prefill_step, make_serve_step

# small tensors, one op at a time: the intra-op pool costs more than it
# gives and fights the other test workers for cores
torch.set_num_threads(1)

SERVED = ["granite-3-2b", "mamba2-1.3b", "zamba2-2.7b"]
MOE = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
F32 = dict(rtol=1e-4, atol=5e-4)


def pair(name, **kw):
    """(reference config, port config), reduced and replaced alike."""
    return (JC.get(name).reduced().replace(**kw),
            TC.get(name).reduced().replace(**kw))


def carried_params(jcfg, seed=0):
    p = j_init(jax.random.PRNGKey(seed), jcfg)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def carried_state(js):
    """The reference's DecodeState handed over as NumPy arrays."""
    kv = None if js.kv is None else {k: np.asarray(v)
                                     for k, v in js.kv._asdict().items()}
    ssm = None if js.ssm is None else {k: np.asarray(v)
                                       for k, v in js.ssm._asdict().items()}
    return decode_state_from_numpy(kv, ssm, np.asarray(js.pos), device="cpu")


def assert_states_close(ts, js, **tol):
    assert ts.pos == int(js.pos)
    if js.kv is not None:
        assert ts.kv.length == int(js.kv.length)
        np.testing.assert_allclose(as_np(ts.kv.k), as_np(js.kv.k), **tol)
        np.testing.assert_allclose(as_np(ts.kv.v), as_np(js.kv.v), **tol)
    else:
        assert ts.kv is None
    if js.ssm is not None:
        np.testing.assert_allclose(as_np(ts.ssm.h), as_np(js.ssm.h), **tol)
        np.testing.assert_allclose(as_np(ts.ssm.conv), as_np(js.ssm.conv),
                                   **tol)
    else:
        assert ts.ssm is None


# ---------------- configs ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JC.ARCHS))
def test_configs_equal_field_for_field(name):
    j, t = JC.get(name), TC.get(name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert (j.d_inner, j.uses_attention, j.uses_moe, j.sub_quadratic,
            j.param_count(), j.active_param_count()) == \
        (t.d_inner, t.uses_attention, t.uses_moe, t.sub_quadratic,
         t.param_count(), t.active_param_count())
    assert [dataclasses.asdict(s) for s in JC.cells(j)] == \
        [dataclasses.asdict(s) for s in TC.cells(t)]
    if not t.uses_moe:
        assert t_n_params(t) == j_n_params(j)
    assert sorted(TC.ARCHS) == sorted(JC.ARCHS)


def test_zamba2_full_size_counts():
    cfg = TC.get("zamba2-2.7b")
    assert t_n_params(cfg) == 2_422_386_848
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.n_heads, cfg.head_dim,
            cfg.ssm_heads, cfg.ssm_state, cfg.d_inner // cfg.ssm_heads) == \
        (54, 2560, 32000, 32, 80, 80, 64, 64)


@pytest.mark.parametrize("name", MOE)
def test_moe_raises_not_implemented(name):
    cfg = TC.get(name).reduced()
    for fn in (lambda: model_defs(cfg), lambda: t_n_params(cfg),
               lambda: init(torch.Generator(), cfg, device="cpu"),
               lambda: init_decode_state(cfg, 1, 8, device="cpu"),
               lambda: t_forward({}, torch.zeros(1, 4, dtype=torch.long), cfg)):
        with pytest.raises(NotImplementedError, match="K4"):
            fn()


# ---------------- parameters and layers -------------------------------------------

def test_init_matches_the_reference_defs_and_distributions():
    jc, tc = pair("zamba2-2.7b")
    g = torch.Generator().manual_seed(0)
    tp = init(g, tc, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(tp) == shapes(j_model_defs(jc))
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(tp))
    ssm = tp["blocks"]["ssm"]
    assert ((ssm["dt_bias"] >= 1e-3 - 1e-9) & (ssm["dt_bias"] <= 1e-1 + 1e-9)).all()
    a = torch.exp(ssm["a_log"])
    assert ((a >= 1.0 - 1e-5) & (a <= 16.0 + 1e-4)).all()
    assert torch.equal(ssm["d_skip"], torch.ones_like(ssm["d_skip"]))
    w = tp["head"]
    assert abs(float(w.std()) * np.sqrt(w.shape[0]) - 1.0) < 0.05
    # same generator state, same draw
    again = init(torch.Generator().manual_seed(0), tc, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])
    with pytest.raises(ValueError, match="generator"):
        init(torch.Generator(), tc, device="meta")


@pytest.mark.parametrize("name,path", [
    ("granite-3-2b", ("blocks", "attn", "wq")),
    ("mamba2-1.3b", ("blocks", "ssm", "in_proj")),
    ("zamba2-2.7b", ("blocks", "ssm", "in_proj")),
    ("zamba2-2.7b", ("shared", "mlp", "wd")),
])
def test_init_scales_projections_by_their_input_width(name, path):
    # the stacking axes (layers; groups x layers in the hybrid) are not
    # the fan-in: std is 1/sqrt(the projection's own input width)
    cfg = TC.get(name).reduced()
    d = model_defs(cfg)
    p = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    for key in path:
        d, p = d[key], p[key]
    width = d.shape[[ax not in TL.STACKED_AXES for ax in d.logical].index(True)]
    assert TL.fan_in(d) == width
    assert abs(float(p.std()) * np.sqrt(width) - 1.0) < 0.05


def test_cast_params_semantics():
    _, tc = pair("zamba2-2.7b")
    p = init(torch.Generator().manual_seed(1), tc, device="cpu")
    c = cast_params(p, tc)
    assert c["embed"].dtype == torch.bfloat16
    # the rule reads the stacked tree, as the reference's does: a per-layer
    # vector stacked over layers is >= 2-D and goes to bf16 too, while the
    # shared block's norms and the final norm stay f32
    assert c["blocks"]["ssm"]["a_log"].dtype == torch.bfloat16
    assert c["shared"]["ln1"].dtype == torch.float32
    assert c["ln_f"].dtype == torch.float32
    again = cast_params(c, tc)                      # cast once, then free
    assert again["embed"].data_ptr() == c["embed"].data_ptr()


def test_elementary_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(as_np(TL.rms_norm(tx, tw)),
                               as_np(JL.rms_norm(jnp.asarray(x), w)),
                               rtol=1e-6, atol=1e-6)
    pos = np.arange(9)
    jc, js = JL.rope_tables(jnp.asarray(pos), 16, 1e6)
    tcos, tsin = TL.rope_tables(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(as_np(tcos), as_np(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(as_np(tsin), as_np(js), rtol=1e-5, atol=1e-5)
    q = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        as_np(TL.apply_rope(torch.from_numpy(q), tcos[None, :, None],
                            tsin[None, :, None])),
        as_np(JL.apply_rope(jnp.asarray(q), jc[None, :, None],
                            js[None, :, None])), rtol=1e-5, atol=1e-5)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) for _ in "gu")
    wd = rng.standard_normal((48, 32)).astype(np.float32)
    np.testing.assert_allclose(
        as_np(TL.swiglu(tx, *map(torch.from_numpy, (wg, wu, wd)))),
        as_np(JL.swiglu(jnp.asarray(x), wg, wu, wd)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_depthwise_conv_and_its_decode_state(dtype):
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 11, 24)), jnp.float32) \
        .astype(dtype)
    w = jnp.asarray(rng.standard_normal((24, 4)) * 0.5, jnp.float32)
    tx, tw = (tensor_from_numpy(np.asarray(v), "cpu") for v in (x, w))
    jy, _ = JL.causal_depthwise_conv(x, w)
    ty, _ = TL.causal_depthwise_conv(tx, tw)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(as_np(ty), as_np(jy), **tol)
    # decode: one step at a time from the carried state gives the same
    state_j = jnp.zeros((2, 3, 24), x.dtype)
    state_t = torch.zeros((2, 3, 24), dtype=tx.dtype)
    for s in range(4):
        yj, state_j = JL.causal_depthwise_conv(x[:, s:s + 1], w, state=state_j)
        yt, state_t = TL.causal_depthwise_conv(tx[:, s:s + 1], tw,
                                               state=state_t)
        np.testing.assert_allclose(as_np(yt), as_np(yj), **tol)
        np.testing.assert_allclose(as_np(state_t), as_np(state_j), rtol=0,
                                   atol=0)
        np.testing.assert_allclose(as_np(yt[:, 0]), as_np(ty[:, s]), **tol)


# ---------------- forward ---------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", SERVED)
def test_forward_logits_f32(name, use_kernel):
    jc, tc = pair(name, dtype="float32")
    jp, tp = carried_params(jc)
    toks = tokens(jc, 2, 64)
    want = j_forward(jp, jnp.asarray(toks), jc, use_kernel=use_kernel,
                     remat=False)
    got = make_prefill_step(tc, use_kernel=use_kernel)(
        tp, torch.from_numpy(toks).long())
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", SERVED)
def test_forward_logits_bf16(name, use_kernel):
    jc, tc = pair(name)
    jp, tp = carried_params(jc)
    toks = jnp.asarray(tokens(jc, 2, 64))
    want = as_np(j_forward(jp, toks, jc, use_kernel=use_kernel, remat=False))
    exact = as_np(j_forward(jp, toks, jc.replace(dtype="float32"),
                            remat=False))
    got_t = t_forward(tp, torch.tensor(np.asarray(toks)).long(), tc,
                      use_kernel=use_kernel)
    assert got_t.dtype == torch.bfloat16
    got = as_np(got_t)
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() < 2e-2
    assert np.abs(got - exact).max() <= 1.5 * np.abs(want - exact).max()


@pytest.mark.parametrize("name", ["musicgen-medium", "llava-next-34b"])
def test_stub_frontends_take_embeddings(name):
    jc, tc = pair(name, dtype="float32")
    jp, tp = carried_params(jc)
    emb = np.random.default_rng(5).standard_normal((2, 32, jc.d_model)) \
        .astype(np.float32)
    want = j_forward(jp, jnp.asarray(emb), jc, remat=False)
    got = t_forward(tp, torch.from_numpy(emb), tc)
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)


# ---------------- decode and serve ------------------------------------------------

@pytest.mark.parametrize("name", SERVED)
def test_decode_steps_logits_caches_and_states(name):
    """Four decode steps from a given (non-zero) state: logits, KV cache
    and SSM state after each, in f32."""
    jc, tc = pair(name, dtype="float32")
    jp, tp = carried_params(jc)
    js = j_init_decode_state(jc, 2, 16, dtype=jnp.float32)
    # start from a state the reference reached, not from zeros
    warm = tokens(jc, 2, 3, seed=1)
    jserve = jax.jit(j_make_serve_step(jc))
    for s in range(3):
        _, _, js = jserve(jp, js, jnp.asarray(warm[:, s]))
    ts = carried_state(js)
    assert_states_close(ts, js, rtol=0, atol=0)
    toks = tokens(jc, 2, 4, seed=2)
    for s in range(4):
        _, jl, js = jserve(jp, js, jnp.asarray(toks[:, s]))
        tl, ts = make_serve_step(tc)(tp, ts, torch.from_numpy(toks[:, s])
                                     .long())[1:]
        np.testing.assert_allclose(as_np(tl), as_np(jl), **F32)
        assert_states_close(ts, js, **F32)


@pytest.mark.parametrize("name", SERVED)
def test_serve_step_next_tokens(name):
    """Teacher-forced serve steps over a prompt, then greedy tokens, as
    `examples/serve_batch.py` serves: the next tokens are equal."""
    jc, tc = pair(name, dtype="float32")
    jp, tp = carried_params(jc)
    B, prompt, gen = 2, 6, 4
    prompts = tokens(jc, B, prompt, seed=3)
    jserve = jax.jit(j_make_serve_step(jc))
    tserve = make_serve_step(tc)
    js = j_init_decode_state(jc, B, prompt + gen, dtype=jnp.float32)
    ts = init_decode_state(tc, B, prompt + gen, dtype=torch.float32,
                           device="cpu")
    for s in range(prompt - 1):
        _, _, js = jserve(jp, js, jnp.asarray(prompts[:, s]))
        _, _, ts = tserve(tp, ts, torch.from_numpy(prompts[:, s]).long())
    jt, tt = jnp.asarray(prompts[:, -1]), torch.from_numpy(prompts[:, -1])
    for _ in range(gen):
        jt, jl, js = jserve(jp, js, jt)
        tt, tl, ts = tserve(tp, ts, tt.long())
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(as_np(tl), as_np(jl), **F32)
    assert ts.pos == int(js.pos) == prompt - 1 + gen


def test_sliding_window_ring_buffer_wraps_like_the_reference():
    """A windowed cache of 4 slots written 7 times: the slot is
    length % S_max and every live slot is attended (window=0 in
    decode_mha), as the reference does."""
    jc, tc = pair("granite-3-2b", dtype="float32", window=4)
    jp, tp = carried_params(jc)
    js = j_init_decode_state(jc, 1, 16, dtype=jnp.float32)
    ts = carried_state(js)
    assert ts.kv.k.shape[2] == 4
    toks = tokens(jc, 1, 7, seed=4)
    jserve = jax.jit(j_make_serve_step(jc))
    for s in range(7):
        _, jl, js = jserve(jp, js, jnp.asarray(toks[:, s]))
        tl, ts = make_serve_step(tc)(tp, ts, torch.from_numpy(toks[:, s])
                                     .long())[1:]
        np.testing.assert_allclose(as_np(tl), as_np(jl), **F32)
        assert_states_close(ts, js, **F32)


def test_full_cache_slot_saturates_at_the_last_row():
    """Without a window the slot is min(length, S_max - 1)."""
    jc, tc = pair("granite-3-2b", dtype="float32")
    jp, tp = carried_params(jc)
    js = j_init_decode_state(jc, 1, 3, dtype=jnp.float32)
    ts = carried_state(js)
    toks = tokens(jc, 1, 5, seed=5)
    jserve = jax.jit(j_make_serve_step(jc))
    for s in range(5):
        _, jl, js = jserve(jp, js, jnp.asarray(toks[:, s]))
        tl, ts = make_serve_step(tc)(tp, ts, torch.from_numpy(toks[:, s])
                                     .long())[1:]
        np.testing.assert_allclose(as_np(tl), as_np(jl), **F32)
    assert_states_close(ts, js, **F32)


@pytest.mark.parametrize("name", SERVED)
def test_decode_continues_prefill(name):
    """The port alone: teacher-forced decode steps give the prefill
    forward's logits position by position (f32)."""
    _, tc = pair(name, dtype="float32")
    tp = init(torch.Generator().manual_seed(2), tc, device="cpu")
    toks = torch.from_numpy(tokens(tc, 2, 8, seed=6)).long()
    full = t_forward(tp, toks, tc)
    st = init_decode_state(tc, 2, 8, dtype=torch.float32, device="cpu")
    serve = make_serve_step(tc)
    for s in range(8):
        nxt, logits, st = serve(tp, st, toks[:, s])
        torch.testing.assert_close(logits, full[:, s], rtol=1e-4, atol=5e-4)
        assert torch.equal(nxt, full[:, s].argmax(-1).to(torch.int32))


def test_argmax_takes_the_first_of_ties():
    logits = torch.zeros(3, 10, dtype=torch.bfloat16)
    logits[:, [2, 7]] = 1.0
    assert torch.argmax(logits, dim=-1).tolist() == [2, 2, 2]


def test_interop_keeps_bf16_bits():
    a = jnp.asarray(np.random.default_rng(6).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))
