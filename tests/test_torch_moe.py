"""The port's MoE layer (`repro_torch.models.moe`) against the
reference's (`repro.models.moe`), from the same seeded NumPy inputs.

- `capacity`: equal integers at many token counts.
- `route`: equal expert indices (exactly) and weights; with tied router
  columns the lower expert index comes first on both sides (inputs are
  small integers times powers of two, so the tied logits are equal to
  the bit whatever order the sums take).
- `moe_apply` in f32 at capacity_factor 0.5, so that tokens overflow
  their experts and are dropped: which ones depends on the flattened
  (token, choice) order exactly. Tolerance 1e-5: the same arithmetic
  summed in another order. With ``use_kernel`` False (three einsums on
  both sides) and True (the reference's Pallas kernel in interpret mode;
  the port's kernel wrapper, which takes its plain version on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import moe as JM

from repro_torch import configs as TC
from repro_torch.models import moe as TM

torch.set_num_threads(1)

NAMES = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]


def pair(name, reduced=True, **kw):
    j, t = JC.get(name), TC.get(name)
    if reduced:
        j, t = j.reduced(), t.reduced()
    return j.replace(**kw), t.replace(**kw)


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_capacity_equal(name, reduced):
    for cf in (1.25, 0.5, 2.0):
        jc, tc = pair(name, reduced, capacity_factor=cf)
        for T in list(range(1, 600, 7)) + [4096, 32768, 8 * 4096]:
            assert TM.capacity(tc, T) == JM.capacity(jc, T), (T, cf)
            assert TM.capacity(tc, T) % 8 == 0


def moe_params(cfg, seed, integer=False):
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if integer:
        router = rng.integers(-2, 3, (d, E)).astype(np.float32) / 4
    else:
        router = rng.standard_normal((d, E)).astype(np.float32) / np.sqrt(d)
    return {"router": router,
            "wg": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
            "wu": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32),
            "wd": (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)}


@pytest.mark.parametrize("name", NAMES)
def test_route_equal(name):
    jc, tc = pair(name)
    p = moe_params(tc, 1)
    x = np.random.default_rng(2).standard_normal((96, tc.d_model)) \
        .astype(np.float32)
    ji, jw, jaux = JM.route(jnp.asarray(p["router"]), jnp.asarray(x), jc)
    ti, tw, taux = TM.route(torch.from_numpy(p["router"]),
                            torch.from_numpy(x), tc)
    assert ti.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(as_np(tw), as_np(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_route_takes_the_lower_expert_first_among_ties(name):
    jc, tc = pair(name)
    p = moe_params(tc, 3, integer=True)
    r = p["router"]
    r[:, 2] = r[:, 1]                        # experts 1 and 2 always tie
    r[:, 3] = r[:, 0]                        # and 0 and 3
    x = np.random.default_rng(4).integers(-2, 3, (64, tc.d_model)) \
        .astype(np.float32)
    x[:8] = 0.0                              # all experts tie
    ji, jw, _ = JM.route(jnp.asarray(r), jnp.asarray(x), jc)
    ti, tw, _ = TM.route(torch.from_numpy(r), torch.from_numpy(x), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(as_np(tw), as_np(jw), rtol=1e-6, atol=1e-6)
    k = tc.top_k
    assert ti[:8].tolist() == [list(range(k))] * 8
    # wherever a tied pair is chosen together, the lower index leads
    for row in ti.tolist():
        for lo, hi in ((1, 2), (0, 3)):
            if lo in row and hi in row:
                assert row.index(lo) < row.index(hi)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_with_dropped_tokens_f32(name, use_kernel):
    jc, tc = pair(name, capacity_factor=0.5, dtype="float32")
    p = moe_params(tc, 5)
    B, S = 2, 32
    x = np.random.default_rng(6).standard_normal((B, S, tc.d_model)) \
        .astype(np.float32)
    # tokens do overflow: some expert is chosen more often than C
    ti, _, _ = TM.route(torch.from_numpy(p["router"]),
                        torch.from_numpy(x.reshape(B * S, -1)), tc)
    load = torch.bincount(ti.reshape(-1), minlength=tc.n_experts)
    assert int(load.max()) > TM.capacity(tc, B * S)
    want = JM.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jc, use_kernel=use_kernel)
    got = TM.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), tc, use_kernel=use_kernel)
    assert got.shape == (B, S, tc.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)
    # a token whose every choice was dropped comes out as zeros on both
    zero_rows = np.all(as_np(want) == 0.0, axis=-1)
    assert np.array_equal(np.all(as_np(got) == 0.0, axis=-1), zero_rows)
