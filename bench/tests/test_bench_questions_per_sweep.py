"""The reader of how many distinct questions the advisor sweeps in one
engine call (`questions_per_sweep.tenants`): on hand-made spans, on a
program that records no ``questions`` (the parent's), and in a traced
CPU run of the tiny warm-tenants cell."""
from __future__ import annotations

import pytest
from test_bench_faults_tenants import TENANTS, _run, info, reader, span
from test_bench_faults_tenants import root  # noqa: F401  (the fixture)

NAME = "questions_per_sweep.tenants"


def test_mean_over_sweeps_that_start_in_the_window():
    read = reader(NAME).read
    spans = [
        span("serve.sweep", -1.0, 2.0, req=1, questions=8, candidates=30),
        span("serve.sweep", 0.5, 1.0, req=2, questions=3, candidates=9),
        span("serve.sweep", 2.0, 1.0, req=5, questions=1, candidates=4),
        span("serve.sweep", 9.5, 1.0, req=9, questions=6, candidates=20),
        span("serve.sweep", 10.5, 1.0, req=12, questions=7, candidates=21),
        span("serve.wait", 0.5, 1.0, req=2),
    ]
    assert read(info(spans)) == pytest.approx((3 + 1 + 6) / 3)


def test_reads_nothing_where_no_sweep_counts_its_questions():
    read = reader(NAME).read
    assert read(info([])) is None
    assert read(info([span("serve.sweep", 1.0, 1.0, req=1, candidates=4,
                           group=1)])) is None


def test_traced_tenants_reads_the_questions_of_each_call(root):
    out = _run(root, TENANTS, trace=True)
    assert out["correct"] is True, out["checks"]
    assert 1.0 <= out["metrics"][NAME]["value"] <= 3.0   # 3 tenants
