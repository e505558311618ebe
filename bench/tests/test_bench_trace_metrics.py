"""The readers of the program's request-scoped spans: the advisor's queue
wait over its answer time (`serve_wait_share.newjobs`) and host compile's
time a micro-op (`compile_us_per_op.newjobs`), on hand-made spans and in
a traced CPU run of the tiny BLAST cell."""
from __future__ import annotations

import pytest
from conftest import NEWJOBS, ROOT

from bench.benchkit import cell
from bench.benchkit.cell import RunInfo
from bench.benchkit.spec import load_module
from repro_torch.obs.trace import Span

SEED = 2**31 + 4099


def reader(name):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                       name.replace(".", "_"))


def info(spans, window_s=10.0):
    return RunInfo(cell=None, setup_s=1.0, window_s=window_s, records=[],
                   program_spans=spans)


def span(name, start, dur, **meta):
    return Span(name, start, dur, meta=tuple(sorted(meta.items())))


def test_wait_share_sums_waits_of_requests_started_in_the_window():
    read = reader("serve_wait_share.newjobs").read
    spans = [
        span("serve.request", -1.0, 3.0, req=1),   # began in set-up: out
        span("serve.wait", -1.0, 2.0, req=1),
        span("serve.request", 0.5, 4.0, req=2),
        span("serve.wait", 0.5, 1.0, req=2),
        span("serve.sweep", 1.5, 3.0, req=2),
        span("serve.request", 2.0, 4.0, req=3),
        span("serve.wait", 2.0, 3.0, req=3),
        span("compile_dag", 2.0, 1.0, req=2, ops=10, tasks=3),
    ]
    assert read(info(spans)) == pytest.approx(100.0 * (1.0 + 3.0) / 8.0)
    # a request without a wait counts its time, with none of it waiting
    assert read(info(spans + [span("serve.request", 6.0, 2.0, req=4)])) == \
        pytest.approx(100.0 * 4.0 / 10.0)


def test_wait_share_reads_nothing_without_a_request_in_the_window():
    read = reader("serve_wait_share.newjobs").read
    assert read(info([])) is None
    assert read(info([span("serve.request", -3.0, 2.0, req=1),
                      span("serve.wait", -3.0, 1.0, req=1),
                      span("compile_grid", 0.5, 1.0)])) is None


def test_compile_rate_clips_spans_to_the_window():
    read = reader("compile_us_per_op.newjobs").read
    spans = [
        span("compile_dag", -1.0, 2.0, ops=1000, tasks=3),  # half inside
        span("compile_dag", 2.0, 3.0, ops=1_000_000, tasks=9),
        span("compile_dag", 9.0, 2.0, ops=4000, tasks=3),   # half inside
        span("compile_dag", 12.0, 1.0, ops=50, tasks=1),    # after: out
        span("compile_grid", 1.0, 5.0, candidates=3),
    ]
    secs = 1.0 + 3.0 + 1.0
    ops = 500 + 1_000_000 + 2000
    assert read(info(spans)) == pytest.approx(1e6 * secs / ops)
    assert read(info(spans[3:])) is None
    assert read(info([])) is None


def test_traced_tiny_cell_reports_both(tiny_root):
    out = cell.run_cell(NEWJOBS, SEED, 1.0, True, root=tiny_root,
                        device="cpu")
    assert out["correct"] is True, out["checks"]
    m = out["metrics"]
    assert 0.0 <= m["serve_wait_share.newjobs"]["value"] < 100.0
    assert m["serve_wait_share.newjobs"]["unit"] == "%"
    assert m["compile_us_per_op.newjobs"]["value"] > 0.0
    assert m["compile_us_per_op.newjobs"]["unit"] == "us/op"
    assert {"compile_share.newjobs", "host_prep_share.newjobs"} <= set(m)
    gaps = [name for name, _ in out["breakdown"]["idle_gaps"]]
    assert "compile_dag" in gaps
