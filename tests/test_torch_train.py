"""The port's training path against the reference's: `loss_fn` and its
gradients, rematerialisation, AdamW, `make_train_step` and the training
driver.

Parameters come from `repro.models.init` and are carried over by
`repro_torch.models.interop`; batches come from the reference's
`synth_batch` (NumPy). Everything runs in f32 compute
(``cfg.replace(dtype="float32")``), where the point is the algorithm:
bf16 rounds at other places in the two frameworks.

Tolerances, and why:
- loss: rtol 1e-5 — the same f32 sums over a few layers in another
  order;
- gradients: rtol 1e-4 and atol `GRAD_ATOL` x max |g| of the leaf. The
  backward sums the same products in another order, and an element that
  is a near-cancelling sum carries an absolute error of eps times its
  terms. Measured (port against reference, largest over the leaves of
  max |difference| / max |g|): dense 2.4e-5, moe 6.4e-5, hybrid 4.0e-5,
  ssm 4.0e-4. The reduced Mamba2 gradient is ill-conditioned: scaling
  its in_proj by 1 + 1e-9 moves the gradient by 2.3e-6 of max |g| in
  an f64 evaluation of the port, so f32 rounding of the activations
  alone moves it by ~1e-4. Hence 2e-4, and 1e-3 for ssm;
- AdamW on the same gradients: rtol 1e-6 (atol 1e-12 for elements that
  are 0) — elementwise f32 in the reference's order; only the global
  norm is a reduction in another order;
- a train step: loss rtol 1e-5, grad_norm rtol 1e-4; updated parameters
  within 1e-6 + 1e-3 x lr but for a share of at most 1e-3 of the
  elements, and every element within 1e-6 + 2 x (the sum of the steps'
  lr). Adam's first step is g / (|g| + eps), which turns a gradient
  difference of d into d / eps of the step: where a gradient element is
  within its f32 rounding of zero, its step may take either sign, and
  a step is never longer than lr. Measured at lr 1e-5: 1 of 102720
  elements past the first bound (by 1.3 x lr with accum 1, 1.2e-6 with
  accum 2).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.checkpoint import plan_checkpoint as j_plan_checkpoint
from repro.core import TPU_POD_STAGING as J_STAGING
from repro.data import synth_batch as j_synth_batch
from repro.models import init as j_init
from repro.models import loss_fn as j_loss_fn
from repro.models.config import ShapeConfig as JShape
from repro.optim import adamw as j_adamw
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as j_make_train_step

from repro_torch import configs as TC
from repro_torch.kernels.counts import KernelCounts
from repro_torch.models import loss_fn
from repro_torch.models.interop import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_map, tree_paths

torch.set_num_threads(1)

FAMILIES = {"dense": "granite-3-2b", "moe": "mixtral-8x22b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b"}
SHAPE = JShape("tiny", 32, 2, "train")
GRAD_ATOL = {"dense": 2e-4, "moe": 2e-4, "hybrid": 2e-4, "ssm": 1e-3}


def pair(name, **kw):
    kw.setdefault("dtype", "float32")
    return (JC.get(name).reduced().replace(**kw),
            TC.get(name).reduced().replace(**kw))


def carried(jcfg, seed=0):
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def batches(jcfg, seed=0, shape=SHAPE):
    """The reference's synthetic batch, with the mask cut at the end of
    row 1 (so the masked mean is exercised), in both packages' types."""
    b = j_synth_batch(jcfg, shape, np.random.default_rng(seed))
    b["mask"][1, -5:] = 0.0
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}


def port_paths(tree):
    return {p: v.detach().numpy() for p, v in tree_paths(tree)}


def port_grads(params, batch, cfg, remat=True):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = loss_fn(live, batch, cfg, remat=remat)
    paths = tree_paths(live)
    grads = torch.autograd.grad(loss, [v for _, v in paths])
    return loss.detach(), aux, {p: g.numpy() for (p, _), g in
                                zip(paths, grads)}


def assert_grads_close(got, want, family):
    assert sorted(got) == sorted(want)
    for k in want:
        atol = GRAD_ATOL[family] * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=k)


# ---------------- loss and gradients ------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grads_match_reference(family):
    jcfg, tcfg = pair(FAMILIES[family])
    jp, tp = carried(jcfg)
    jb, tb = batches(jcfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, jb, jcfg), has_aux=True))(jp)
    tl, taux, tg = port_grads(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 2 * 32 - 5
    np.testing.assert_allclose(float(taux["accuracy"]),
                               float(jaux["accuracy"]), atol=1e-6)
    assert_grads_close(tg, jax_paths(jg), family)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_gradients_equal_no_remat(family):
    """Rematerialisation recomputes the same ops in the same order: the
    gradients are equal to the bit, with layer bodies (dense) and group
    bodies (hybrid) checkpointed."""
    jcfg, tcfg = pair(FAMILIES[family])
    _, tp = carried(jcfg, seed=1)
    _, tb = batches(jcfg, seed=1)
    l1, _, g1 = port_grads(tp, tb, tcfg, remat=True)
    l0, _, g0 = port_grads(tp, tb, tcfg, remat=False)
    assert torch.equal(l1, l0)
    assert all(np.array_equal(g1[k], g0[k]) for k in g0)


def test_loss_default_mask_and_first_index_accuracy():
    """Without a mask every position counts; accuracy takes the first of
    equal logits, as the reference's argmax does."""
    jcfg, tcfg = pair("granite-3-2b")
    jp, tp = carried(jcfg)
    jb, tb = batches(jcfg)
    del jb["mask"], tb["mask"]
    jl, jaux = j_loss_fn(jp, jb, jcfg)
    tl, taux = loss_fn(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(taux["tokens"]) == 64.0
    zero = {k: torch.zeros_like(v) for k, v in tp.items()
            if not isinstance(v, dict)}
    flat = dict(tp, **zero)                         # every logit equal
    _, aux = loss_fn(flat, dict(tb, labels=torch.zeros_like(tb["labels"])),
                     tcfg)
    assert float(aux["accuracy"]) == 1.0


# ---------------- AdamW ---------------------------------------------------------------

def test_adamw_update_matches_reference_over_three_steps():
    """The same NumPy gradients fed to both optimisers, clipping active
    on every step (grad_clip below the gradients' norm), through the
    warmup into the cosine decay."""
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 6), "b": (6,), "blocks": {"k": (2, 3, 5)}}
    to_np = lambda s: jax.tree.map(
        lambda sh: rng.standard_normal(sh).astype(np.float32), s,
        is_leaf=lambda x: isinstance(x, tuple))
    p0 = to_np(shapes)
    cfg = dict(lr=1e-2, grad_clip=0.5, warmup_steps=2, total_steps=6,
               weight_decay=0.1)
    jc, tc = j_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.from_numpy, p0)
    js, ts = j_adamw.init(jp), adamw.init(tp)
    assert ts.count.dtype == torch.int32 and ts.count.dim() == 0
    for _ in range(3):
        g = to_np(shapes)
        jp, js, jm = j_adamw.update(jax.tree.map(jnp.asarray, g), js, jp, jc)
        tp, ts, tm = adamw.update(jax.tree.map(torch.from_numpy, g), ts, tp,
                                  tc)
        assert float(tm["grad_norm"]) > tc.grad_clip      # clipping active
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(ts.count) == int(js.count)
        for name, jt, tt in (("params", jp, tp), ("mu", js.mu, ts.mu),
                             ("nu", js.nu, ts.nu)):
            want, got = jax_paths(jt), port_paths(tt)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-12, err_msg=name + k)


def test_adamw_descends_quadratic_and_clips():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=100)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(60):
        params, state, _ = adamw.update({"w": 2 * params["w"]}, state,
                                        params, cfg)
    assert float(params["w"].abs().max()) < 0.2
    p = {"w": torch.zeros(4)}
    _, _, m = adamw.update({"w": torch.full((4,), 100.0)}, adamw.init(p), p,
                           adamw.AdamWConfig(lr=1e-3, grad_clip=1.0))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 50, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = adamw.schedule(adamw.AdamWConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    want = j_adamw.schedule(j_adamw.AdamWConfig(**cfg), jnp.asarray(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


# ---------------- the train step ------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    jcfg, tcfg = pair("granite-3-2b")
    jp, tp = carried(jcfg)
    jb, tb = batches(jcfg, shape=JShape("tiny", 32, 4, "train"))
    # a step of 1e-5 at most: where step 1 takes another sign for an
    # element (above), step 2's gradients move by no more than rounding
    opt = dict(lr=1e-5, warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_make_train_step(jcfg, j_adamw.AdamWConfig(**opt),
                                      accum=accum))
    counts = KernelCounts()
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**opt), accum=accum,
                            counts=counts)
    js = JTrainState(params=jp, opt=j_adamw.init(jp))
    ts = TrainState(params=tp, opt=adamw.init(tp))
    lr_sum = 0.0
    for _ in range(2):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert sorted(tm) == sorted(jm)
        assert all(v.dim() == 0 and not v.requires_grad for v in tm.values())
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        if accum == 1:
            assert float(tm["tokens"]) == float(jm["tokens"])
        lr = float(jm["lr"])
        lr_sum += lr
        np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
        want, got = jax_paths(js.params), port_paths(ts.params)
        diff = np.concatenate([np.abs(got[k] - want[k]).ravel()
                               for k in want])
        assert diff.max() <= 1e-6 + 2 * lr_sum, diff.max()
        assert np.mean(diff > 1e-6 + 1e-3 * lr) <= 1e-3, \
            int(np.sum(diff > 1e-6 + 1e-3 * lr))
    assert int(ts.opt.count) == 2
    assert counts == KernelCounts()          # the plain paths launch nothing


def test_train_step_with_kernels_raises():
    _, tcfg = pair("granite-3-2b")
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(tcfg, adamw.AdamWConfig(), use_kernel=True)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_smoke_loss_decreases(family):
    """Overfitting one batch lowers the loss, for every family (the
    reference's `test_archs.py::test_smoke_loss_decreases`, at 10 steps)."""
    jcfg, tcfg = pair(FAMILIES[family], dtype="bfloat16")
    _, tp = carried(jcfg)
    _, tb = batches(jcfg, shape=JShape("tiny", 64, 8, "train"))
    step = make_train_step(tcfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                   total_steps=60))
    state = TrainState(params=tp, opt=adamw.init(tp))
    losses = []
    for _ in range(10):
        state, m = step(state, tb)
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


# ---------------- the driver ------------------------------------------------------------

def test_train_driver_with_fault_injection(tmp_path):
    """`tests/test_runtime.py`'s driver test, on the port, plus the
    checkpoint plan against the reference's for the same state bytes."""
    from repro_torch.launch.train import train_loop
    rep = train_loop("granite-3-2b", steps=48, reduced=True,
                     ckpt_dir=str(tmp_path), ckpt_every=16, seq_len=32,
                     batch=8, fail_at=40, log_every=100, lr=5e-3,
                     device="cpu")
    assert rep["final_step"] == 48
    assert rep["loss_last"] < rep["loss_first"]
    assert (tmp_path / "manifest_00000048.json").exists()
    assert [r["step"] for r in rep["restores"]] == [32]
    assert [c["step"] for c in rep["checkpoints"]] == [16, 32, 48, 48]
    assert len(rep["losses"]) == 48 + 8           # steps 32..39 run twice
    jcfg = JC.get("granite-3-2b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    jstate = JTrainState(params=jp, opt=j_adamw.init(jp))
    j_bytes = sum(np.asarray(x).nbytes for x in jax.tree.leaves(jstate))
    assert rep["state_bytes"] == j_bytes
    want = j_plan_checkpoint(j_bytes, n_hosts=5, st=J_STAGING)
    got = rep["plan"]
    assert got.config.fingerprint() == want.config.fingerprint()
    assert got.local_placement == want.local_placement
    assert got.table == want.table
    np.testing.assert_allclose(got.predicted_write_s, want.predicted_write_s,
                               rtol=1e-12)
    np.testing.assert_allclose(got.predicted_restore_s,
                               want.predicted_restore_s, rtol=1e-12)
