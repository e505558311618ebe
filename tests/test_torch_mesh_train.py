"""The port's model, loss, train step and decode on a device mesh of four
ranks, held against the same port without a mesh.

Four spawned processes join a `gloo` process group and build a (2, 2)
mesh, axes ("data", "model") (`make_host_mesh(model=2)`). Parameters
come from one seed on every rank and are placed by `param_specs`
(`resharded_state`), the batch by `data_specs`, the decode caches by
`decode_state_specs`; every rank then runs the step on its shards and
the result, gathered whole, is compared with the step run on plain
tensors by the same rank. The reduced configs cross both sides of every
placement choice: dense and moe have one kv head (replicated kv heads;
a decode cache sharded along the sequence, attended flash-decode
style), the hybrid has four (kv heads and SSM heads split on "model");
moe splits its four experts (EP), moe_tp has three, which do not split,
so the expert FFN width does (TP).

Tolerance, f32 throughout: every compared tensor within 1e-5 x its
largest magnitude. The sharded run sums the same products over shards:
only the order differs. The parameters after a train step (lr 1e-5,
one warmup step, so every element whose gradient is not zero moves by
about lr) are held to the gate of `test_torch_train.py`: within
1e-6 + 1e-3 x lr but for a share of at most 1e-3 of the elements, and
every element within 1e-6 + 2 x lr. Adam's first step is
g / (|g| + eps): where a gradient element is within its rounding of
zero, its step may take either sign. A step that left the state as it
was, or dropped a microbatch, moves nearly every element off by ~lr.

The reference dispatches MoE tokens within each data-parallel group
(the batch rows of one data shard), with the capacity of the group's
tokens; the port does the same under a mesh. So the forward, loss and
gradients are held against the unsharded port run group by group (the
dispatch at the default capacity drops tokens). A train step splits its
batch into microbatches whose groups differ from the unsharded step's,
so for moe the train step runs at a capacity that holds every token,
where grouping cannot change a result.

The process group lives only in the spawned ranks; each rank is joined
with a timeout.
"""
import multiprocessing as mp
import socket
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
TIMEOUT_S = 300
FAMILIES = {"dense": "granite-3-2b", "moe": "mixtral-8x22b",
            "moe_tp": "mixtral-8x22b", "hybrid": "zamba2-2.7b"}
B, S, DECODE_STEPS = 4, 32, 3
TOL = 1e-5
STEP_OPT = dict(lr=1e-5, warmup_steps=1, total_steps=10)
PARAM_SHARE = 1e-3      # share of the elements allowed past 1e-6 + 1e-3 lr


def family_cfg(fam, *, no_drops=False):
    from repro_torch import configs as TC
    cfg = TC.get(FAMILIES[fam]).reduced().replace(dtype="float32")
    if fam == "moe_tp":
        cfg = cfg.replace(n_experts=3)
    if no_drops and cfg.uses_moe:
        # capacity = T: every token fits, whatever the grouping
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def rel_err(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _batch(cfg, seed):
    g = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(g.integers(0, cfg.vocab, (B, S))),
            "labels": torch.as_tensor(g.integers(0, cfg.vocab, (B, S))),
            "mask": torch.as_tensor((g.random((B, S)) > 0.2).astype(np.float32))}


def _params(cfg):
    from repro_torch.models import init
    return init(torch.Generator().manual_seed(0), cfg, device="cpu")


def _groups(fn, batch, dp):
    """``fn`` over the rows of each data shard, outputs concatenated."""
    rows = B // dp
    return torch.cat([fn({k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}) for i in range(dp)])


def _group_loss(params, batch, cfg, dp):
    """`loss_fn`'s loss with the forward run group by group."""
    from repro_torch.models import forward
    logits = _groups(lambda b: forward(params, b["tokens"], cfg, remat=False),
                     batch, dp)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, batch["labels"][..., None])[..., 0] - lse
    mask = batch["mask"]
    return logits, -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def check_family(fam, mesh):
    """{case: largest relative error} of the mesh run against no mesh."""
    from repro_torch.kernels.counts import KernelCounts
    from repro_torch.launch.elastic import resharded_state
    from repro_torch.models import decode_step, forward, init_decode_state
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import loss_fn
    from repro_torch.optim import adamw
    from repro_torch.parallel import (batch_axes, data_specs,
                                      decode_state_specs, param_specs,
                                      to_shardings)
    from repro_torch.parallel.sharding import distribute
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    out = {}
    dp = mesh.shape[0]
    cfg = family_cfg(fam)
    params = _params(cfg)
    pspec = lambda m: param_specs(cfg, m)
    dparams = resharded_state(params, None, mesh, pspec)
    shape = ShapeConfig("t", S, B, "train")
    dbatch = tree_map(distribute, _batch(cfg, 1),
                      to_shardings(data_specs(cfg, shape, mesh), mesh))
    batch = _batch(cfg, 1)

    # forward, then loss and its gradients
    got = forward(dparams, dbatch["tokens"], cfg, remat=False)
    want, want_loss = _group_loss(params, batch, cfg, dp)
    out["forward"] = rel_err(_full(got), want)
    # use_kernel=True: each kernel's wrapper runs inside `local_map` on the
    # rank's heads (experts); on CPU shards its plain version, uncounted
    counts = KernelCounts()
    got = forward(dparams, dbatch["tokens"], cfg, remat=False,
                  use_kernel=True, counts=counts)
    out["forward_kernels"] = rel_err(_full(got), want) + \
        (counts != KernelCounts())
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    _l, want_loss = _group_loss(live, batch, cfg, dp)
    want_g = torch.autograd.grad(want_loss, tree_leaves(live))
    dlive = tree_map(lambda p: p.detach().requires_grad_(), dparams)
    loss, _m = loss_fn(dlive, dbatch, cfg, remat=True)
    got_g = torch.autograd.grad(loss, tree_leaves(dlive))
    out["loss"] = rel_err(_full(loss), want_loss)
    out["grads"] = max(rel_err(_full(g), w) for g, w in zip(got_g, want_g))

    # one train step, accum 1 and 2
    tcfg = family_cfg(fam, no_drops=True)
    tparams = _params(tcfg)
    opt = adamw.AdamWConfig(**STEP_OPT)
    for accum in (1, 2):
        ref = TrainState(tree_map(torch.clone, tparams), adamw.init(tparams))
        state_spec = lambda m: TrainState(params=param_specs(tcfg, m),
                                          opt=adamw.OptState(
                                              mu=param_specs(tcfg, m),
                                              nu=param_specs(tcfg, m),
                                              count=()))
        dstate = resharded_state(ref, None, mesh, state_spec)
        ref, want_m = make_train_step(tcfg, opt, accum=accum)(ref, batch)
        dstate, got_m = make_train_step(tcfg, opt, accum=accum)(dstate, dbatch)
        out[f"step_accum{accum}_loss"] = rel_err(_full(got_m["loss"]),
                                                 want_m["loss"])
        out[f"step_accum{accum}_grad_norm"] = rel_err(
            _full(got_m["grad_norm"]), want_m["grad_norm"])
        # parameters: absolute, as Adam's first step may flip the sign of
        # an element whose gradient is within rounding of zero
        lr = float(want_m["lr"])
        diff = torch.cat([(_full(g) - w).abs().flatten() for g, w in
                          zip(tree_leaves(dstate.params),
                              tree_leaves(ref.params))])
        out[f"step_accum{accum}_params"] = {
            "lr": lr, "lr_got": float(_full(got_m["lr"])),
            "max": float(diff.max()),
            "share": float((diff > 1e-6 + 1e-3 * lr).double().mean())}

    # decode steps from an empty cache, caches placed by decode_state_specs
    # (one token per sequence and step: no expert overflows its capacity,
    # so the groups cannot matter)
    dshape = ShapeConfig("d", S, B, "decode")
    state = init_decode_state(cfg, B, S, dtype=torch.float32, device="cpu")
    dstate = tree_map(
        lambda x, s: distribute(x.clone(), s) if isinstance(x, torch.Tensor)
        else x, state, to_shardings(decode_state_specs(cfg, dshape, mesh), mesh))
    tok_shard = to_shardings({"t": (batch_axes(mesh),)}, mesh)["t"]
    errs = []
    for step in range(DECODE_STEPS):
        tok = batch["tokens"][:, step]
        want_l, state = decode_step(params, state, tok, cfg)
        got_l, dstate = decode_step(dparams, dstate, distribute(tok, tok_shard),
                                    cfg)
        errs.append(rel_err(_full(got_l), want_l))
    out["decode"] = max(errs)
    return out


def check_reshard(mesh_from, mesh_to):
    """A train state placed on ``mesh_from``, copied to the host and
    re-placed on ``mesh_to``: every leaf's whole value equal to the
    saved one, and each rank's shard equal to its slice."""
    from repro_torch.launch.elastic import resharded_state
    from repro_torch.optim import adamw
    from repro_torch.parallel import param_specs
    from repro_torch.train import TrainState
    from repro_torch.tree import tree_leaves, tree_map

    cfg = family_cfg("hybrid")
    params = _params(cfg)
    spec = lambda m: TrainState(params=param_specs(cfg, m), opt=adamw.OptState(
        mu=param_specs(cfg, m), nu=param_specs(cfg, m), count=()))
    opt = adamw.init(params)
    opt = opt._replace(mu=tree_map(lambda p: p * 0.5, params),
                       nu=tree_map(lambda p: p * p, params),
                       count=torch.tensor(7, dtype=torch.int32))
    state = TrainState(params, opt)
    placed = resharded_state(state, None, mesh_from, spec)
    host = tree_map(lambda x: x.full_tensor().numpy(), placed)
    again = resharded_state(host, mesh_from, mesh_to, spec)
    equal_full = all(torch.equal(a.full_tensor(), b) for a, b in
                     zip(tree_leaves(again), tree_leaves(state)))
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_of
    equal_local = True
    for a, b in zip(tree_leaves(again), tree_leaves(state)):
        shp, off = local_of(b.shape, a.device_mesh, a.placements)
        sl = tuple(slice(o, o + n) for o, n in zip(off, shp))
        equal_local &= torch.equal(a.to_local(), b[sl])
    return {"full": equal_full, "local": equal_local,
            "placements": [str(a.placements) for a in tree_leaves(again)][:3]}


def _rank_main(rank, port, queue):
    try:
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=WORLD)
        from repro_torch.launch.mesh import make_elastic_mesh, make_host_mesh
        mesh = make_host_mesh(model=2, device_type="cpu")
        res = {fam: check_family(fam, mesh) for fam in FAMILIES}
        res["reshard"] = check_reshard(
            make_elastic_mesh(2, data=1, model=2, device_type="cpu"), mesh)
        dist.destroy_process_group()
        queue.put((rank, res, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh_results():
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, res, err = queue.get(timeout=TIMEOUT_S)
            assert err is None, f"rank {rank}:\n{err}"
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return got


CASES = ["forward", "forward_kernels", "loss", "grads", "step_accum1_loss",
         "step_accum1_grad_norm", "step_accum1_params", "step_accum2_loss",
         "step_accum2_grad_norm", "step_accum2_params", "decode"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_mesh_run_matches_unsharded_port(mesh_results, fam, case):
    for rank, res in mesh_results.items():
        err = res[fam][case]
        if case.endswith("_params"):
            lr = err["lr"]
            assert lr == pytest.approx(STEP_OPT["lr"], rel=1e-6) and \
                err["lr_got"] == lr, (rank, err)   # lr in f32
            assert err["max"] <= 1e-6 + 2 * lr, (rank, fam, case, err)
            assert err["share"] <= PARAM_SHARE, (rank, fam, case, err)
        else:
            assert err <= TOL, (rank, fam, case, err)


def test_resharded_state_is_equal_to_the_saved_state(mesh_results):
    for rank, res in mesh_results.items():
        assert res["reshard"]["full"] and res["reshard"]["local"], \
            (rank, res["reshard"])
