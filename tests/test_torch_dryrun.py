"""The port's dry run (`repro_torch.launch.dryrun`, `dryrun_meta`):
collective accounting on a DTensor program whose collectives are known,
the input stand-ins of every cell, the artifact's format and digest
against the reference's, the 2-vs-4-layer extrapolation against a
direct trace at full depth, and one cell per family through
``python -m repro_torch.launch.dryrun`` on a small fake mesh.

Every process group here is the in-process fake one (`fake_world`,
destroyed on exit) or lives in a subprocess with a timeout.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.launch import dryrun_meta as j_meta

from repro_torch import configs as TC
from repro_torch.launch import dryrun, dryrun_meta
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ShapeConfig

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def _meta(mesh, shape, placements):
    s = dryrun.NamedSharding(mesh, (), tuple(placements))
    return DTensor.from_local(
        torch.empty(dryrun.local_shape(shape, s), device="meta"), mesh,
        placements, run_check=False, shape=shape,
        stride=dryrun._contiguous(shape))


def test_collective_bytes_of_a_known_program():
    """On a (2, 4) mesh (rank 0, f32): an all-gather over "data" of an
    [8, 16] tensor (512 result bytes), an all-reduce of [4, 4] over
    "model" (64, twice on the wire), a shard-to-shard move on "model"
    (an all-to-all, [8, 2] result) and a reduce-scatter over "model"
    ([2, 4] result)."""
    with dryrun.fake_world(8):
        mesh = make_host_mesh(model=4)
        xs = [_meta(mesh, (8, 16), [Shard(0), Replicate()]),
              _meta(mesh, (4, 4), [Replicate(), Partial()]),
              _meta(mesh, (8, 8), [Replicate(), Shard(0)]),
              _meta(mesh, (8, 4), [Replicate(), Partial()])]
        with dryrun.StepTrace(xs) as tr:
            xs[0].redistribute(mesh, [Replicate(), Replicate()])
            xs[1].redistribute(mesh, [Replicate(), Replicate()])
            xs[2].redistribute(mesh, [Replicate(), Shard(1)])
            xs[3].redistribute(mesh, [Replicate(), Shard(0)])
    assert sorted(tr.collectives) == sorted([
        ("all-gather", 512), ("all-reduce", 64), ("all-to-all", 64),
        ("reduce-scatter", 32)])
    assert dryrun.collective_bytes(tr.collectives) == {
        "all-gather": 512.0, "all-reduce": 128.0, "all-to-all": 64.0,
        "reduce-scatter": 32.0, "total": 736.0}
    assert tr.flops == 0


def test_collective_bytes_weights_by_wire_factor():
    out = dryrun.collective_bytes([("all-reduce", 100), ("all-gather", 10),
                                   ("all-reduce", 1),
                                   ("collective-permute", 7)])
    assert out == {"all-reduce": 202.0, "all-gather": 10.0,
                   "collective-permute": 7.0, "total": 219.0}
    assert dryrun.collective_bytes([]) == {"total": 0}


def test_step_trace_peak_counts_live_temporaries_only():
    """The state handed in as known is no temporary; two live 4 KiB
    results are 8 KiB at the peak, a freed one no longer counts."""
    state = torch.zeros(1024, device="meta")
    with dryrun.StepTrace([state]) as tr:
        a = state + 1
        b = state * 2
        del a, b
        c = state - 1
    assert tr.peak_bytes == 8192
    assert tr.flops == 0 and tr.bytes_accessed == 3 * 8192
    del c


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_input_specs_cover_all_cells(arch):
    a = TC.get(arch)
    for shape in TC.cells(a):
        specs = dryrun.input_specs(a, shape)
        assert "tokens" in specs or "embeds" in specs
        for v in specs.values():
            assert isinstance(v, torch.Tensor) and v.device.type == "meta"
            assert v.shape[0] == shape.global_batch


def test_artifact_round_trip_and_staleness():
    cells = [{"arch": "granite-3-2b", "shape": "decode_32k"}]
    doc = json.loads(json.dumps(dryrun_meta.wrap_results(cells)))
    assert dryrun_meta.unwrap_results(doc) == (cells, "")
    # the reference's artifact (TPU roofs) is stale here, and the port's there
    got, why = dryrun_meta.unwrap_results(j_meta.wrap_results(cells))
    assert got is None and "digest" in why
    got, why = j_meta.unwrap_results(dryrun_meta.wrap_results(cells))
    assert got is None and "digest" in why
    assert dryrun_meta.dryrun_digest() != j_meta.dryrun_digest()
    assert dryrun_meta.FORMAT_VERSION == j_meta.FORMAT_VERSION
    assert dryrun_meta.WIRE_FACTOR == j_meta.WIRE_FACTOR
    assert dryrun_meta.unwrap_results(cells)[0] is None          # legacy
    bumped = dict(doc, meta=dict(doc["meta"], format_version=1))
    assert "format_version" in dryrun_meta.unwrap_results(bumped)[1]


def test_artifact_of_another_torch_minor_reads_as_stale(monkeypatch):
    """DTensor traces other collectives under another torch minor, so
    the digest holds major.minor: a patch or build tag leaves it, a new
    minor changes it."""
    cells = [{"arch": "granite-3-2b", "shape": "decode_32k"}]
    monkeypatch.setattr(dryrun_meta.torch, "__version__", "2.11.0+cu128")
    doc = dryrun_meta.wrap_results(cells)
    assert doc["meta"]["torch"] == "2.11"
    monkeypatch.setattr(dryrun_meta.torch, "__version__", "2.11.1")
    assert dryrun_meta.unwrap_results(doc) == (cells, "")
    monkeypatch.setattr(dryrun_meta.torch, "__version__", "2.13.0+cpu")
    got, why = dryrun_meta.unwrap_results(doc)
    assert got is None and "torch version" in why


def test_roofs_are_the_h100s():
    assert dryrun_meta.PEAK_FLOPS == 989e12
    assert dryrun_meta.HBM_BW == 3.35e12
    assert dryrun_meta.LINK_BW == 50e9
    assert 80e9 < dryrun_meta.HBM_BYTES < 86e9
    for tpu in (j_meta.PEAK_FLOPS, j_meta.HBM_BW, j_meta.HBM_BYTES):
        assert tpu not in (dryrun_meta.PEAK_FLOPS, dryrun_meta.HBM_BW,
                           dryrun_meta.HBM_BYTES, dryrun_meta.LINK_BW)


DELTA_CASES = [("granite-3-2b", "train"), ("granite-3-2b", "decode"),
               ("zamba2-2.7b", "prefill"), ("mixtral-8x22b", "train")]


@pytest.mark.parametrize("arch,kind", DELTA_CASES)
def test_delta_extrapolation_equals_a_full_depth_trace(arch, kind):
    """Collectives and FLOPs grow by the same amount a layer (a group),
    so the 2-vs-4 (1-vs-2) extrapolation to 6 layers equals a direct
    trace of 6; so do bytes accessed and the temporaries' peak for the
    dense and hybrid models. A MoE step's peak and bytes are not linear
    in depth to the byte (its dispatch buffers and remat interleave), and
    are not compared here."""
    cfg = TC.get(arch).reduced().replace(n_layers=6)
    shape = ShapeConfig("t", 64, 8, kind)
    with dryrun.fake_world(8):
        mesh = dryrun.make_elastic_mesh(1, data=2, model=4)
        d = dryrun.delta_costs(cfg, shape, mesh)
        accum = dryrun.train_accum(cfg, shape, mesh) if kind == "train" \
            else None
        tr = dryrun.lower_cell(cfg, shape, mesh, accum=accum)
    assert d["collective_bytes_per_device"] == \
        dryrun.collective_bytes(tr.collectives)["total"] > 0
    assert d["hlo_flops_extrap"] == tr.flops > 0
    if not cfg.uses_moe:
        assert d["hlo_bytes_extrap"] == tr.bytes_accessed
        assert d["temp_bytes_extrap"] == tr.peak_bytes > 0


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], capture_output=True, text=True,
                          timeout=TIMEOUT_S, env=env, cwd=ROOT)


CLI_CELLS = [("granite-3-2b", "decode_32k", ()),            # dense
             ("mixtral-8x22b", "decode_32k", ()),           # moe
             ("mamba2-1.3b", "decode_32k", ()),             # ssm
             ("zamba2-2.7b", "decode_32k", ()),             # hybrid
             ("musicgen-medium", "decode_32k", ()),         # audio
             ("llava-next-34b", "decode_32k", ()),          # vlm
             ("zamba2-2.7b", "prefill_32k", ("--kernels",)),
             ("mixtral-8x22b", "prefill_32k", ("--kernels",))]


@pytest.mark.parametrize("arch,shape,extra", CLI_CELLS)
def test_cli_cell_on_a_small_mesh(tmp_path, arch, shape, extra):
    out = tmp_path / "dr.json"
    r = _run_cli("--arch", arch, "--shape", shape, "--mesh", "2x4",
                 "--out", str(out), *extra)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    cells, stale = dryrun_meta.unwrap_results(json.loads(out.read_text()))
    assert not stale, stale
    (rep,) = cells
    assert "error" not in rep
    assert rep["chips"] == 8 and rep["mesh"] == "2x4"
    assert rep["arch"] == arch and rep["shape"] == shape
    assert rep["bytes_per_device"] > 0
    assert rep["bytes_per_device_bf16_est"] == rep["bytes_per_device"]
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["t_collective_s"] == rep["collective_bytes_per_device"] \
        / dryrun_meta.LINK_BW
