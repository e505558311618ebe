"""The port's sharding rules (`repro_torch.parallel.sharding`) against the
reference's (`repro.parallel.sharding`), and the placements they become.

The spec functions read only the mesh's axis sizes, in both packages, so
they are compared on a stand-in mesh whose ``shape`` is a dict: the two
production meshes, (16, 16) and (2, 16, 16), and a small (2, 4). Every
spec of every architecture is equal, entry for entry (the reference's
`PartitionSpec` as a tuple; an entry of one axis name is that name, in
a 1-tuple or not, as JAX itself spells it either way). The bytes of
rank 0's shards of a step's state and inputs (`dryrun.argument_bytes`,
through DTensors on meta tensors over a fake process group) equal the
bytes of the shard shapes the reference's specs give the same arrays.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import configs as JC
from repro.models import init_decode_state as j_init_decode_state
from repro.models import model_defs as j_model_defs
from repro.models.layers import is_def as j_is_def
from repro.parallel import sharding as J

from repro_torch import configs as TC
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as T

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
ARCHS = sorted(JC.ARCHS)


def stand_in(sizes):
    return SimpleNamespace(shape=dict(sizes))


def canon(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def ref_tuples(tree):
    """The reference's spec tree with every `PartitionSpec` as a tuple."""
    return jax.tree.map(lambda s: canon(tuple(s)), tree,
                        is_leaf=lambda x: isinstance(x, P))


def canon_tree(tree):
    """The port's spec tree with every spec in `canon` form."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: canon_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return canon(tree)
    return type(tree)(*(canon_tree(v) for v in tree))


def port_tuples(tree):
    """The port's spec tree in the reference's containers' shape: dicts,
    and NamedTuples as plain tuples of their fields."""
    if tree is None or (isinstance(tree, tuple) and not hasattr(tree, "_fields")):
        return tree
    if isinstance(tree, dict):
        return {k: port_tuples(v) for k, v in tree.items()}
    return tuple(port_tuples(v) for v in tree)


def ref_nt(tree):
    if tree is None or (isinstance(tree, tuple) and not hasattr(tree, "_fields")):
        return tree
    if isinstance(tree, dict):
        return {k: ref_nt(v) for k, v in tree.items()}
    return tuple(ref_nt(v) for v in tree)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, mesh):
    ja, ta = JC.get(arch), TC.get(arch)
    m = stand_in(MESHES[mesh])
    assert T.logical_rules(ta, m) == J.logical_rules(ja, m)
    assert canon_tree(T.param_specs(ta, m)) == \
        ref_tuples(J.param_specs(ja, m))
    assert T.batch_axes(m) == J.batch_axes(m)
    for js in JC.cells(ja):
        ts = {s.name: s for s in TC.ALL_SHAPES}[js.name]
        assert canon_tree(T.data_specs(ta, ts, m)) == \
            ref_tuples(J.data_specs(ja, js, m))
        got = port_tuples(canon_tree(T.decode_state_specs(ta, ts, m)))
        want = ref_nt(ref_tuples(J.decode_state_specs(ja, js, m)))
        assert got == want, (js.name, got, want)


def test_fsdp_kicks_in_where_the_reference_says():
    """qwen2-72b's state exceeds the per-device threshold over 16 model
    shards, granite-3-2b's does not: a second dim of each 2-D weight then
    shards over "data"."""
    m = stand_in(MESHES["16x16"])
    big = T.param_specs(TC.get("qwen2-72b"), m)
    small = T.param_specs(TC.get("granite-3-2b"), m)
    assert "data" in big["blocks"]["mlp"]["wg"]
    assert "data" not in small["blocks"]["mlp"]["wg"]


# ---------------- placements ---------------------------------------------------------

def test_spec_to_placements():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 16, 16))
    assert T.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert T.placements((None, ("pod", "data", "model")), mesh) == \
        (Shard(1), Shard(1), Shard(1))
    assert T.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        T.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        T.placements(("model", "model"), mesh)
    one = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 4))
    assert T.placements((("data",), "model"), one) == (Replicate(), Shard(1))


def test_constraints_pass_plain_tensors_through():
    x = torch.ones(4, 8, 16)
    for f in (T.constrain_activations, T.constrain_decode_kv,
              T.constrain_logits, T.constrain_batch_dim, T.replicated):
        assert f(x) is x
    assert T.constrain_batch_dim({"a": x}, dim=1)["a"] is x
    assert T.replicate_like(x, torch.ones(2)) is x
    lg = torch.randn(2, 3, 10)
    lab = torch.tensor([[1, 9, 0], [4, 4, 2]])
    assert torch.equal(T.label_logit(lg, lab),
                       torch.gather(lg, -1, lab[..., None])[..., 0])
    assert torch.equal(T.first_argmax(lg), lg.argmax(-1))
    assert torch.equal(T.logsumexp_last(lg), torch.logsumexp(lg, dim=-1))
    assert torch.equal(T.softmax_last(lg), torch.softmax(lg, dim=-1))
    table = torch.randn(10, 4)
    assert torch.equal(T.embed_lookup(table, lab), table[lab])


def test_mesh_module_needs_a_process_group():
    """Importing `launch.mesh` touches no process group; building a mesh
    without one raises."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    assert not dist.is_initialized()
    for make in (mesh.make_production_mesh, mesh.make_host_mesh,
                 lambda **kw: mesh.make_elastic_mesh(2, **kw)):
        with pytest.raises(RuntimeError, match="process group"):
            make(device_type="cpu")


def test_mesh_of_the_wrong_world_size_raises():
    from repro_torch.launch import mesh
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="world size 256"):
            mesh.make_production_mesh(device_type="cpu")
        m = mesh.make_host_mesh(model=4, device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (2, 4)
        m = mesh.make_elastic_mesh(2, data=2, model=2, device_type="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model")


# ---------------- rank 0's argument bytes ----------------------------------------------

def _shard_bytes(shape, spec, sizes, itemsize) -> int:
    """Rank 0's shard of an array of ``shape`` under ``spec`` (each dim
    split over its axes in order, the first shard taking the ceiling)."""
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else entry
        for a in axes:
            dim = -(-dim // sizes[a])
        n *= dim
    return n * itemsize


def ref_argument_bytes(ja, js, sizes) -> int:
    """Rank 0's bytes of the step's arguments under the reference's specs:
    f32 parameters (and moments and a 0-d int32 count for training), the
    decode caches, and the batch the reference's dry run feeds."""
    m = stand_in(sizes)
    pspecs = J.param_specs(ja, m)
    defs = jax.tree.leaves(j_model_defs(ja), is_leaf=j_is_def)
    specs = jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(x, P))
    params = sum(_shard_bytes(d.shape, tuple(s), sizes, 4)
                 for d, s in zip(defs, specs))
    B, S = js.global_batch, js.seq_len
    stub = ja.frontend in ("audio", "vlm")
    if js.kind in ("train", "prefill"):
        ds = J.data_specs(ja, js, m)
        tok_key = "embeds" if stub else "tokens"
        batch = {tok_key: ((B, S, ja.d_model) if stub else (B, S),
                           2 if stub else 4)}
        if js.kind == "train":
            batch.update(labels=((B, S), 4), mask=((B, S), 4))
        inputs = sum(_shard_bytes(shp, tuple(ds[k]), sizes, isz)
                     for k, (shp, isz) in batch.items())
        if js.kind == "train":
            return 3 * params + 4 + inputs
        return params + inputs
    st = jax.eval_shape(lambda: j_init_decode_state(ja, B, S))
    dspecs = J.decode_state_specs(ja, js, m)
    leaves = jax.tree.leaves(st)
    sp = jax.tree.leaves(dspecs, is_leaf=lambda x: isinstance(x, P))
    cache = sum(_shard_bytes(x.shape, tuple(s), sizes, x.dtype.itemsize)
                for x, s in zip(leaves, sp) if x.ndim)   # not length, pos
    dp = int(np.prod([sizes[a] for a in J.batch_axes(m)]))
    bspec = J.batch_axes(m) if B % dp == 0 else None
    tok = _shard_bytes((B, ja.d_model) if stub else (B,), (bspec,), sizes,
                       2 if stub else 4)
    return params + cache + tok


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_reference_shards(arch):
    ja, ta = JC.get(arch), TC.get(arch)
    for name in ("16x16", "2x4"):
        sizes = MESHES[name]
        with dryrun.fake_world(int(np.prod(list(sizes.values())))):
            mesh = dryrun.make_elastic_mesh(1, data=sizes["data"],
                                            model=sizes["model"],
                                            device_type="cpu")
            for js in JC.cells(ja):
                ts = {s.name: s for s in TC.ALL_SHAPES}[js.name]
                assert dryrun.argument_bytes(ta, ts, mesh) == \
                    ref_argument_bytes(ja, js, sizes), (name, js.name)
