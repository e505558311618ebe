"""The command itself: no result without the cards a cell asks for, or
in a checkout that holds only `BENCHMARK.json` and `bench/`."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "blast-s1.newjobs",
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=str(cwd), capture_output=True, text=True, timeout=300, env=env)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
