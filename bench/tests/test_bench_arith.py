"""The harness's arithmetic on hand-made samples: draw rules, percentiles
over every request, rates over all the work and time, spreads, span
sums, the device trace's idle split and the scan's yardstick."""
from __future__ import annotations

import json
import statistics

import numpy as np
import pytest
from conftest import ROOT

from bench.benchkit import devtrace, stats, traffic, yardstick
from bench.benchkit.devtrace import Interval, TraceData
from bench.reference import scan as ref_scan

SEED = 3 * 2**31 + 5          # more than 32 bits hold


def test_permutation_never_repeats_and_follows_the_seed():
    a = traffic.Sequence({"permutation": [20, 400]}, SEED, "n_queries")
    b = traffic.Sequence({"permutation": [20, 400]}, SEED, "n_queries")
    c = traffic.Sequence({"permutation": [20, 400]}, SEED + 1, "n_queries")
    va = [a[k] for k in range(381)]
    assert sorted(va) == list(range(20, 401))
    assert va == [b[k] for k in range(381)]
    assert va != [c[k] for k in range(381)]
    with pytest.raises(IndexError):
        a[381]


def test_repeat_sends_one_order_for_every_seed():
    order = [7, 14, 2, 11, 17, 5]
    a = traffic.Sequence({"repeat": order}, SEED, "n_app")
    b = traffic.Sequence({"repeat": order}, SEED + 1, "n_app")
    assert [a[k] for k in range(15)] == [b[k] for k in range(15)] == \
        (order * 3)[:15]


def test_the_newjobs_mix_holds_each_size_once_a_block():
    mix = json.loads((ROOT / "bench" / "mixes" / "newjobs.json").read_text())
    assert sorted(mix["request"]["n_app"]["repeat"]) == list(range(1, 19))


def test_cycle_visits_every_deployment_once_a_block():
    s = traffic.Sequence({"cycle": [1] * 21}, SEED, "deployment")
    for b in range(3):
        assert sorted(s[k] for k in range(21 * b, 21 * b + 21)) == list(range(21))


def test_weighted_cycle_holds_each_value_its_weight_a_block():
    w = [2, 1, 0, 3]
    s = traffic.Sequence({"cycle": w}, SEED, "deployment")
    other = traffic.Sequence({"cycle": w}, SEED + 1, "deployment")
    v = [s[k] for k in range(18)]
    for b in range(3):
        assert sorted(v[6 * b:6 * b + 6]) == [0, 0, 1, 3, 3, 3]
    assert v != [other[k] for k in range(18)]


def test_profiles_lie_in_the_mix_ranges():
    mix = json.loads((ROOT / "bench" / "mixes" / "whatif.json").read_text())
    rules = mix["profiles"]["ranges"]
    assert set(rules) == set(ref_scan.PROFILE_KEYS)
    rng = traffic.request_stream(SEED, "profiles", 7)
    for key, rule in rules.items():
        v = traffic.sample(rule, rng, 4096)
        (kind, arg), = rule.items()
        if kind == "fixed":
            assert (v == arg).all()
        else:
            assert arg[0] <= v.min() and v.max() <= arg[1]
    a = traffic.sample(rules["storage"], traffic.request_stream(SEED, "p", 3), 8)
    b = traffic.sample(rules["storage"], traffic.request_stream(SEED, "p", 3), 8)
    assert np.array_equal(a, b)


def test_percentiles_are_over_every_request():
    lat = [float(x) for x in range(1, 101)]           # 1..100 s
    assert stats.percentile(lat, 50) == pytest.approx(50.5)
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    # the slowest requests move the tail and not the median
    slow = lat[:94] + [1000.0] * 6
    assert stats.percentile(slow, 50) == stats.percentile(lat, 50)
    assert stats.percentile(slow, 95) > 900


def test_rate_is_all_work_over_all_time():
    assert stats.rate(3 * 17, 34.0) == 1.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_and_its_robust_form():
    runs = [10.0, 10.2, 9.9, 10.1, 10.0, 13.0]
    q1, med, q3 = statistics.quantiles(runs, n=4)
    assert stats.spread(runs) == pytest.approx((q3 - q1) / med)
    assert stats.spread_without_farthest(runs) < stats.spread(runs)


def test_phase_sums_clip_to_the_window():
    from repro_torch.obs.trace import Span
    spans = [Span("compile_grid", -1.0, 2.0), Span("prep[8x4]", 2.0, 0.5),
             Span("sim[8x4x1]", 2.5, 0.25), Span("compile_grid", 9.5, 1.0)]
    s = stats.phase_sums(spans, 0.0, 10.0)
    assert s == pytest.approx({"compile_s": 1.5, "host_prep_s": 0.5,
                               "device_s": 0.25})


def test_idle_time_split_by_what_the_host_did():
    t = TraceData(window_s=10.0,
                  device=[Interval("k", 1.0, 1.0), Interval("k", 1.5, 1.0),
                          Interval("Memcpy HtoD", 6.0, 1.0)],
                  spans=[Interval("compile_grid", 3.0, 2.0),
                         Interval("simulate_batch", 5.0, 3.0),
                         Interval("prep[64x8]", 5.0, 0.5)],
                  host_ops=[Interval("aten::to", 8.0, 0.5)],
                  requests=[Interval("bench.request", 8.0, 1.0)])
    assert t.busy_s == pytest.approx(2.5)
    idle = dict(devtrace.idle_by_label(t))
    assert idle == pytest.approx({
        "host: harness, between requests": 1.0 + 0.5 + 1.0,   # 0-1, 2.5-3, 9-10
        "compile_grid": 2.0, "prep": 0.5, "simulate_batch": 1.5,
        "aten::to": 0.5, "host: in a request, outside torch ops": 0.5})
    assert sum(idle.values()) == pytest.approx(10.0 - t.busy_s)
    assert t.device_ops()[0] == ["k", 2.0]
    # inside the one request (8-9) nothing ran on the card
    assert t.idle_in_requests_s == pytest.approx(1.0)


def test_host_path_share_is_the_idle_time_inside_requests():
    from bench.benchkit.cell import RunInfo
    from bench.benchkit.spec import load_module
    reader = load_module(ROOT / "bench" / "metrics" / "host_path_share.whatif.py",
                         "host_path_share")
    t = TraceData(window_s=10.0,
                  device=[Interval("k", 0.5, 1.0), Interval("k", 4.0, 2.0)],
                  requests=[Interval("bench.request", 0.0, 3.0),
                            Interval("bench.request", 3.0, 4.0)])
    info = RunInfo(cell=None, setup_s=1.0, window_s=10.0, records=[], trace=t)
    # requests cover 0-7 s, the card 0.5-1.5 and 4-6 s: 4 s of host alone
    assert reader.read(info) == pytest.approx(40.0)
    info.trace = TraceData(window_s=10.0, device=t.device)
    assert reader.read(info) is None          # no annotated requests


def test_scan_work_counts_each_input_once():
    dag = {"res": np.zeros(5, np.int32),
           "deps": np.array([[-1] * 4, [0, -1, -1, -1], [0, 1, -1, -1],
                             [2, -1, -1, -1], [0, 1, 2, 3]], np.int32)}
    w = yardstick.scan_work(dag, profiles=10)
    assert w.rows == 50
    assert w.ops == (9 * 5 + 8) * 10
    assert w.bytes == 53 * 5 + 64 * 10
    assert w.bound_s == max(w.ops / yardstick.PEAK_F64_OPS_PER_S,
                            w.bytes / yardstick.PEAK_BYTES_PER_S)
    assert (w + w).rows == 100
    # at a cell's size (a DAG read once, thousands of profiles) the
    # operations bound the scan, not the bytes
    big = {"res": np.zeros(100_000, np.int32),
           "deps": np.full((100_000, 4), -1, np.int32)}
    assert yardstick.scan_work(big, profiles=3072).bound_by == "ops"
    # unfused f64 instructions: half the data sheet's FMA-counted rate
    assert yardstick.PEAK_F64_OPS_PER_S == 16.75e12
