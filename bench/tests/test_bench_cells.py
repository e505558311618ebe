"""Cells added as data alone run end to end on the CPU; the f32 control
and the faults planted under the timed path come out not correct.

The tiny cells (`conftest.make_checkout`) reuse the real cells' drivers,
readers and limits, so a fault caught here is caught by the same check
at the cell's own size.
"""
from __future__ import annotations

import json

import pytest
import torch
from conftest import NEWJOBS, WHATIF

from bench.benchkit import cell
from repro_torch.kernels.sweep_scan import ops as sweep_scan_ops

SEED = 2**31 + 977


def _run(root, wl, trace=False, seconds=1.0, seed=SEED):
    return cell.run_cell(wl, seed, seconds, trace, root=root, device="cpu")


@pytest.mark.parametrize("wl", [NEWJOBS, WHATIF])
def test_data_only_cell_runs_and_is_correct(tiny_root, wl):
    out = _run(tiny_root, wl)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert "setup_s" in out["metrics"] and "predictions_per_s" in out["metrics"]
    assert out["metrics"]["predictions_per_s"]["value"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    json.dumps(out)


def test_traced_run_reads_program_spans(tiny_root):
    out = _run(tiny_root, NEWJOBS, trace=True)
    assert out["correct"] is True
    m = out["metrics"]
    assert set(m) == {"compile_share.newjobs", "host_prep_share.newjobs"}
    assert 0 < m["compile_share.newjobs"]["value"] < 100
    # no card, no device trace: its metrics are left out, never read as 0
    assert "device_idle_share" not in m
    assert out["device"]["window_s"] > 0
    assert "idle_gaps" in out["breakdown"]


def test_same_seed_sends_the_same_requests(tiny_root):
    from bench.benchkit import spec
    c = spec.load_cell(tiny_root, NEWJOBS)
    a = c.driver_module().Driver(c, SEED, torch.device("cpu"), None)
    b = c.driver_module().Driver(c, SEED, torch.device("cpu"), None)
    assert [a.request_params(k) for k in range(12)] == \
        [b.request_params(k) for k in range(12)]


def test_f32_control_is_not_correct(tiny_root, monkeypatch):
    """The program's f32 sweep (`REPRO_SIM_X64=0`) in place of its f64
    one: the makespans' gap to the reference exceeds the limit."""
    monkeypatch.setenv("REPRO_SIM_X64", "0")
    for wl in (NEWJOBS, WHATIF):
        out = _run(tiny_root, wl)
        assert out["correct"] is False
        assert out["checks"]["makespan_rel_gap"]["value"] > \
            out["checks"]["makespan_rel_gap"]["limit"]


def _unchanged(res, dur, lag, deps, **kw):
    """A step that returns its state as it was: nothing served."""
    C, N = res.shape
    return (torch.zeros(C, dtype=dur.dtype), torch.zeros(C, N, dtype=dur.dtype))


def _half_batch(real):
    def run(res, dur, lag, deps, **kw):
        mk, end = real(res, dur, lag, deps, **kw)
        C = mk.shape[0]
        if C >= 2:                     # half left out, the rest's mean
            mk = mk.clone()
            mk[C // 2:] = mk[:C // 2].mean()
        return mk, end
    return run


def _one_block(real):
    def run(res, dur, lag, deps, **kw):
        mk, end = real(res, dur, lag, deps, **kw)
        C = mk.shape[0]              # one block of profiles, mid-batch
        lo = C // 2
        mk = mk.clone()
        mk[lo:lo + max(C // 24, 1)] *= 1 + 1e-6
        return mk, end
    return run


def _altered(real):
    def run(res, dur, lag, deps, **kw):
        mk, end = real(res, dur, lag, deps, **kw)
        return mk * (1 + 1e-6), end
    return run


@pytest.mark.parametrize("wl,fault", [
    (NEWJOBS, "unchanged"), (NEWJOBS, "altered"), (NEWJOBS, "fan_out"),
    (WHATIF, "unchanged"), (WHATIF, "half_batch"), (WHATIF, "altered"),
    (WHATIF, "one_block")])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, wl, fault):
    real = sweep_scan_ops.sweep_scan
    if fault == "unchanged":
        monkeypatch.setattr(sweep_scan_ops, "sweep_scan", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(sweep_scan_ops, "sweep_scan", _half_batch(real))
    elif fault == "altered":
        monkeypatch.setattr(sweep_scan_ops, "sweep_scan", _altered(real))
    elif fault == "one_block":
        monkeypatch.setattr(sweep_scan_ops, "sweep_scan", _one_block(real))
    else:                  # each answer goes to the next question asked
        from repro_torch.serve import server
        sweep = server.AdvisorServer._run_sweep
        last = []

        def stale(self, req):
            last.append(sweep(self, req))
            return last[-2] if len(last) > 1 else last[-1]
        monkeypatch.setattr(server.AdvisorServer, "_run_sweep", stale)
    out = _run(tiny_root, wl)
    assert out["correct"] is False, out["checks"]
