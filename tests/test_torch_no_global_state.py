"""The port held to the reference's no-global-state rule.

`tools/check_no_global_state.py` (unchanged) fails on module-level
mutable containers and on `global` statements in the sweep stack. Here
it runs on the port's counterparts of its default roots — the sweep
stack, the sweep-scan kernel package, `obs`, `serve` — plus the top of
`repro_torch/kernels` (`build.py`, which every kernel launch loads its
library through, and `counts.py`), the other three kernel packages and
the training path (`models`, `train`, `optim`, `data`, `checkpoint`,
`launch`), and must exit 0: K1's launch count lives in the session's
`CacheStats`, K2-K4's in the `KernelCounts` their caller hands in, and
loaded libraries in a memoised function.
A copy of the kernel package with a module-level counter put back must
fail the same check, so the check is known to bite on these roots.
The multi-process module's shared fleet (`_POOLS`) and per-worker
globals (`_W`) pass only through the tool's allowlist, which names them
by file: the same registry in a file of another name fails.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "check_no_global_state.py"
PORT = ROOT / "src" / "repro_torch"
ROOTS = [PORT / "core" / "sweep", PORT / "kernels" / "sweep_scan",
         PORT / "kernels", PORT / "obs", PORT / "serve",
         PORT / "kernels" / "flash_attention", PORT / "kernels" / "ssd",
         PORT / "kernels" / "moe_gmm", PORT / "models", PORT / "train",
         PORT / "optim", PORT / "data", PORT / "checkpoint",
         PORT / "launch"]


def run_tool(*roots):
    return subprocess.run([sys.executable, str(TOOL), *map(str, roots)],
                          capture_output=True, text=True, timeout=120)


def test_port_roots_hold_no_global_state():
    for root in ROOTS:
        assert root.is_dir() and list(root.glob("*.py")), root
    out = run_tool(*ROOTS)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


@pytest.mark.parametrize("snippet,what", [
    ("_launches = 0\n\ndef bump():\n    global _launches\n    _launches += 1\n",
     "global _launches"),
    ("import threading\n_LIBS = {}\n_LOCK = threading.Lock()\n", "_LIBS"),
])
def test_the_check_bites_on_a_port_root(tmp_path, snippet, what):
    """Mutation check: the module state this port removed, put back into
    a copy of a port root, fails the unchanged tool."""
    copy = tmp_path / "sweep_scan"
    shutil.copytree(PORT / "kernels" / "sweep_scan", copy,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    ops = copy / "ops.py"
    ops.write_text(ops.read_text() + "\n" + snippet)
    out = run_tool(copy)
    assert out.returncode == 1
    assert what in out.stderr


def test_the_pool_registry_passes_only_under_its_own_file_name(tmp_path):
    """Mutation check: the sweep stack's `_POOLS = {}` is allowlisted as
    ``multiproc.py:_POOLS``; put in a copy of the root under another file
    name, it fails the unchanged tool."""
    copy = tmp_path / "sweep"
    shutil.copytree(PORT / "core" / "sweep", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert "_POOLS: Dict[int, ProcessPoolExecutor] = {}" in \
        (copy / "multiproc.py").read_text()
    assert run_tool(copy).returncode == 0
    (copy / "fleet.py").write_text(
        "from typing import Dict\n\n_POOLS: Dict[int, object] = {}\n")
    out = run_tool(copy)
    assert out.returncode == 1
    assert "fleet.py" in out.stderr and "_POOLS" in out.stderr
