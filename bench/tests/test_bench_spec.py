"""`BENCHMARK.json` against the rules a benchmark file keeps, and every file a
cell names found by name."""
from __future__ import annotations

import json

import pytest
from conftest import ROOT

from bench.benchkit import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str, limit: int = 200) -> bool:
    return 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 x 24 runs, 90 s x 2 a cell
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == CONFIG_KEYS
    for w in BENCH["workloads"]:
        assert set(w) == WORKLOAD_KEYS
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]] \
            + [w["config"] for w in BENCH["workloads"]]:
        assert spec.NAME_RE.match(n), n
    for c in BENCH["configs"]:
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert _line(c["source"]) and _line(c["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert _line(w["why"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
    for word in BENCH["command"]:
        assert _line(word)


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files(wl):
    cell = spec.load_cell(ROOT, wl)
    assert cell.workload["chips"] in (1, 4)
    assert cell.config_data["name"] == cell.config["name"]
    assert cell.driver_module().Driver
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert callable(cell.reader(m["name"]).read)
    for m in cell.end_to_end:
        assert callable(cell.reader(m["name"]).read)
    assert "failed_requests" in cell.limits["checks"]


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("bench/") and (ROOT / f).is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_four_chip_cells_within_the_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_per_layer_metric_workloads_report_what_it_moves():
    for m in BENCH["per_layer"]:
        for wl in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            cell = spec.load_cell(ROOT, wl)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
