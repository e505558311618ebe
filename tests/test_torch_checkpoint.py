"""The port's checkpoint store, checkpoint manager and elastic control
plane against the reference's.

The store's chunk maps (nodes, sha, size) are equal to the reference's
for the same bytes and config; a checkpoint written by either package
restores in the other with every array equal, the same step, and each
key written by the same writer (the greedy size balance over the same
flattening order). `np.savez` stamps zip times, so shard bytes (and
their sha) differ from run to run: the checks compare restored arrays
and key placement, not manifests. No tolerances: everything here is
exact.
"""
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import IntermediateStore as JStore
from repro.core import Placement as JPlacement
from repro.core import collocated_config as j_collocated
from repro.launch.elastic import ElasticTrainer as JElastic
from repro.launch.elastic import PodHealth as JHealth
from repro.launch.elastic import plan_degraded_mesh as j_plan_mesh
from repro.models import init as j_init
from repro.optim import adamw as j_adamw
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as j_make_train_step
from repro.data import synth_batch as j_synth_batch
from repro.models.config import ShapeConfig as JShape

from repro_torch.checkpoint import CheckpointManager, IntermediateStore
from repro_torch.core import Placement, collocated_config
from repro_torch.launch.elastic import ElasticTrainer, PodHealth, \
    plan_degraded_mesh
from repro_torch.models.interop import params_from_numpy, tensor_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import TrainState
from repro_torch.tree import tree_paths

STORE_CFGS = [dict(chunk_size=64 * 1024),
              dict(chunk_size=64 * 1024, replication=2),
              dict(chunk_size=16 * 1024, replication=3, stripe_width=2),
              dict(chunk_size=32 * 1024, stripe_width=1),
              dict(chunk_size=32 * 1024, placement="LOCAL")]


def configs(n_hosts, kw):
    kw = dict(kw)
    place = kw.pop("placement", None)
    j = j_collocated(n_hosts, **kw, **({"placement": JPlacement[place]}
                                       if place else {}))
    t = collocated_config(n_hosts, **kw, **({"placement": Placement[place]}
                                            if place else {}))
    return j, t


@pytest.fixture(scope="module")
def states():
    """A reference TrainState after one step (moments and count set) and
    the same state in the port's types."""
    cfg = JC.get("granite-3-2b").reduced()
    jp = j_init(jax.random.PRNGKey(2), cfg)
    js = JTrainState(params=jp, opt=j_adamw.init(jp))
    batch = j_synth_batch(cfg, JShape("t", 16, 4, "train"),
                          np.random.default_rng(0))
    js, _ = jax.jit(j_make_train_step(cfg, j_adamw.AdamWConfig()))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    ts = TrainState(
        params=params_from_numpy(to_np(js.params), device="cpu"),
        opt=adamw.OptState(mu=params_from_numpy(to_np(js.opt.mu), "cpu"),
                           nu=params_from_numpy(to_np(js.opt.nu), "cpu"),
                           count=tensor_from_numpy(js.opt.count, "cpu")))
    return js, ts


def jax_arrays(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}


def port_arrays(tree):
    return {p: v.detach().numpy() for p, v in tree_paths(tree)}


def writer_of_key(store, manifest):
    """{key: shard index} read back from the stored shards."""
    out = {}
    for w, entry in enumerate(manifest["entries"]):
        with np.load(io.BytesIO(store.read(entry))) as z:
            out.update({k: w for k in z.files})
    return out


# ---------------- the store -------------------------------------------------------

@pytest.mark.parametrize("kw", STORE_CFGS)
def test_store_chunk_maps_equal_reference(tmp_path, kw):
    """A sequence of files from several writers (the placement cursor
    advances across them) gets the same chunk maps in both stores."""
    jc, tc = configs(6, kw)
    js, ts = JStore(str(tmp_path / "j"), jc), IntermediateStore(
        str(tmp_path / "t"), tc)
    rng = np.random.default_rng(1)
    for i, size in enumerate([0, 1, 64 * 1024, 100_003, 300 * 1024, 7]):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        writer = 1 + i % 5
        je = js.write(f"d/f{i}", data, writer)
        te = ts.write(f"d/f{i}", data, writer)
        assert te == je
        assert ts.read(te) == data == js.read(je)


def test_store_replica_recovery_and_corruption(tmp_path):
    store = IntermediateStore(str(tmp_path / "s"),
                              collocated_config(5, chunk_size=64 * 1024,
                                                replication=2))
    data = os.urandom(300 * 1024)
    entry = store.write("f", data, writer_host=1)
    assert store.read(entry) == data
    dead = entry["chunks"][0]["nodes"][0]
    assert store.read(entry, lost_nodes=[dead]) == data
    with pytest.raises(IOError, match="unrecoverable"):
        store.read(entry, lost_nodes=entry["chunks"][0]["nodes"])
    for r, node in enumerate(entry["chunks"][0]["nodes"]):
        with open(store._chunk_path(node, "f", 0, r), "r+b") as f:
            f.write(b"XX")
    with pytest.raises(IOError, match="corrupt"):
        store.read(entry)


# ---------------- checkpoints across the packages -----------------------------------

@pytest.mark.parametrize("n_writers", [1, 3])
def test_reference_checkpoint_restores_in_port(tmp_path, states, n_writers):
    js, ts = states
    cfg = j_collocated(4, chunk_size=256 * 1024, replication=2)
    jm = JManager(root=str(tmp_path), store=JStore(str(tmp_path / "s"), cfg),
                  n_writers=n_writers)
    manifest = jm.save(js, 7)
    tm = CheckpointManager(root=str(tmp_path),
                           store=IntermediateStore(str(tmp_path / "s"),
                                                   collocated_config(
                                                       4, chunk_size=256 * 1024,
                                                       replication=2)),
                           n_writers=n_writers)
    like = TrainState(params=jax.tree.map(torch.zeros_like, ts.params),
                      opt=adamw.init(ts.params))
    restored, step = tm.restore(like, lost_nodes=[2])
    assert step == 7 == tm.latest_step()
    got, want = port_arrays(restored), jax_arrays(js)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k], want[k]), k
    assert restored.opt.count.dtype == torch.int32
    assert restored.opt.count.dim() == 0 and int(restored.opt.count) == 1
    # the port would have put every key on the same writer
    again = tm.save(ts, 8)
    assert writer_of_key(tm.store, again) == writer_of_key(jm.store, manifest)


@pytest.mark.parametrize("n_writers", [2, 4])
def test_port_checkpoint_restores_in_reference(tmp_path, states, n_writers):
    js, ts = states
    tm = CheckpointManager(root=str(tmp_path),
                           store=IntermediateStore(str(tmp_path / "s"),
                                                   collocated_config(5)),
                           n_writers=n_writers)
    manifest = tm.save(ts, 3)
    jm = JManager(root=str(tmp_path),
                  store=JStore(str(tmp_path / "s"), j_collocated(5)),
                  n_writers=n_writers)
    like = jax.tree.map(jnp.zeros_like, js)
    restored, step = jm.restore(like)
    assert step == 3
    got, want = jax_arrays(restored), port_arrays(ts)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert got[k].dtype == want[k].dtype
    assert writer_of_key(tm.store, manifest) == \
        writer_of_key(jm.store, jm.save(js, 4))


def test_restore_takes_structure_dtype_device_and_grad_from_like(tmp_path):
    params = {"w": torch.randn(3, 4), "b": torch.randn(5).bfloat16(),
              "blocks": {"k": torch.randn(2, 3)}}
    state = TrainState(params=params, opt=adamw.init(params))
    mgr = CheckpointManager(root=str(tmp_path),
                            store=IntermediateStore(str(tmp_path / "s"),
                                                    collocated_config(3)),
                            n_writers=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    mgr.save(state, 1)
    like = TrainState(
        params={k: (v.clone().requires_grad_() if k == "w" else v)
                for k, v in params.items()}, opt=state.opt)
    restored, step = mgr.restore(like)
    assert step == 1 and isinstance(restored, TrainState)
    assert isinstance(restored.opt, adamw.OptState)
    w = restored.params["w"]
    assert w.is_leaf and w.requires_grad and torch.equal(w.detach(),
                                                         params["w"])
    assert not restored.params["blocks"]["k"].requires_grad
    assert restored.params["b"].dtype == torch.bfloat16
    assert torch.equal(restored.params["b"], params["b"])
    assert w.data_ptr() != params["w"].data_ptr()      # a new tensor


def test_manifest_is_atomic(tmp_path, states):
    _, ts = states
    mgr = CheckpointManager(root=str(tmp_path),
                            store=IntermediateStore(str(tmp_path / "s"),
                                                    collocated_config(4)),
                            n_writers=2)
    mgr.save(ts, 1)
    with open(mgr._manifest_path(2) + ".tmp", "w") as f:
        f.write("{corrupt")
    assert mgr.latest_step() == 1


# ---------------- elastic control plane ----------------------------------------------

@pytest.mark.parametrize("n_pods,dead", [(2, [1]), (4, [0, 3]), (3, []),
                                         (4, [0, 1, 2, 3]), (1, [0])])
def test_degraded_mesh_decisions_equal_reference(n_pods, dead):
    jh, th = JHealth(n_pods=n_pods), PodHealth(n_pods=n_pods)
    for p in dead:
        jh.alive[p] = th.alive[p] = False
    assert dataclasses.asdict(plan_degraded_mesh(th)) == \
        dataclasses.asdict(j_plan_mesh(jh))
    assert th.to_fault_scenario(extra_nodes=[7]).fingerprint() == \
        jh.to_fault_scenario(extra_nodes=[7]).fingerprint()


def test_pod_health_sweep_equals_reference():
    jh, th = JHealth(n_pods=3, timeout_s=1.0), PodHealth(n_pods=3,
                                                        timeout_s=1.0)
    for h in (jh, th):
        for p in range(3):
            h.heartbeat(p, now=100.0)
        h.heartbeat(0, now=101.0)
    assert th.sweep(now=100.5) == jh.sweep(now=100.5) == []
    assert th.sweep(now=101.8) == jh.sweep(now=101.8) == [1, 2]
    assert th.n_alive == jh.n_alive == 1


def test_elastic_restore_after_pod_loss_equals_reference(tmp_path, states):
    js, ts = states
    jm = JManager(root=str(tmp_path / "j"),
                  store=JStore(str(tmp_path / "j" / "s"),
                               j_collocated(5, replication=2)),
                  n_writers=4)
    tm = CheckpointManager(root=str(tmp_path / "t"),
                           store=IntermediateStore(str(tmp_path / "t" / "s"),
                                                   collocated_config(
                                                       5, replication=2)),
                           n_writers=4)
    os.makedirs(jm.root, exist_ok=True)
    os.makedirs(tm.root, exist_ok=True)
    jm.save(js, 42)
    tm.save(ts, 42)
    je, te = JElastic(n_pods=2, checkpoint_manager=jm), \
        ElasticTrainer(n_pods=2, checkpoint_manager=tm)
    _, jstep, jd = je.on_failure(js, dead_pods=[1], lost_storage_nodes=[2, 4])
    restored, tstep, td = te.on_failure(ts, dead_pods=[1],
                                        lost_storage_nodes=[2, 4])
    assert tstep == jstep == 42
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    (jev,), (tev,) = je.events, te.events
    assert {k: v for k, v in tev.items() if k != "fault_scenario"} == \
        {k: v for k, v in jev.items() if k != "fault_scenario"}
    assert tev["fault_scenario"].fingerprint() == \
        jev["fault_scenario"].fingerprint()
    got, want = port_arrays(restored), port_arrays(ts)
    assert all(np.array_equal(got[k], want[k]) for k in want)
