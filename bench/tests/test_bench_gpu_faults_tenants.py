"""The bad-day and the warm-tenants cells on the card, at their own
sizes with a short window: the program's run is correct and its f32
control is not. Run on a machine with the card: ``python -m pytest -q -m
gpu bench/tests``."""
from __future__ import annotations

import pytest
import torch
from conftest import ROOT

from bench.benchkit import cell

CELLS = ["blast-s1-failures.faultjobs", "blast-s1.tenants"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("wl", CELLS)
def test_cell_is_correct_on_the_card(wl):
    _card()
    out = cell.run_cell(wl, 2**31 + 303, 8.0, False, root=ROOT)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("wl", CELLS)
def test_f32_control_fails_on_the_card(wl, monkeypatch):
    _card()
    monkeypatch.setenv("REPRO_SIM_X64", "0")
    out = cell.run_cell(wl, 2**31 + 404, 8.0, False, root=ROOT)
    assert out["correct"] is False, out["checks"]
