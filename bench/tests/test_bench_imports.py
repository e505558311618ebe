"""The import guard: what the harness and the reference load.

No module the harness or the reference loads has ``jax`` or ``repro``
(the JAX package) as its top-level name, compared whole (``repro_torch``
is the port); the reference loads nothing of ``repro_torch`` either;
and no run opens a path under the JAX package's ``benchmarks/``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import textwrap

from conftest import NEWJOBS, ROOT, WHATIF

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _run_py(code: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_opens_nothing_under_benchmarks(tiny_root):
    out = _run_py(f"""
        import json, os, sys
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        opened = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
                mode = args[1] if isinstance(args[1], str) else ""
                flags = args[2] if isinstance(args[2], int) else 0
                writes = any(c in mode for c in "wax+") or flags & (
                    os.O_WRONLY | os.O_RDWR | os.O_CREAT)
                opened.append((os.fsdecode(args[0]), bool(writes)))
        sys.addaudithook(hook)
        from bench.benchkit import cell
        for wl in ({NEWJOBS!r}, {WHATIF!r}):
            for trace in (False, True):
                r = cell.run_cell(wl, 12345, 0.3, trace,
                                  root=__import__('pathlib').Path({str(tiny_root)!r}),
                                  device="cpu")
                assert r["correct"], r["checks"]
        tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
        print(json.dumps({{"tops": tops, "opened": opened}}))
        """)
    assert not FORBIDDEN.intersection(out["tops"])
    assert "repro_torch" in out["tops"]
    full = [(os.path.abspath(os.path.join(str(ROOT), p)), w)
            for p, w in out["opened"]]
    under = (str(ROOT / "benchmarks"), str(tiny_root / "benchmarks"))
    assert not [p for p, _ in full if p.startswith(under)]
    # a run writes inside its checkout (and the temporary directory) only
    allowed = (str(ROOT), str(tiny_root), tempfile.gettempdir(), os.devnull)
    assert not [p for p, w in full if w and not p.startswith(allowed)]


def test_the_reference_loads_numpy_only():
    out = _run_py(f"""
        import json, pkgutil, importlib, sys
        sys.path[:0] = [{str(ROOT)!r}]
        import bench.reference as ref
        for m in pkgutil.walk_packages(ref.__path__, "bench.reference."):
            importlib.import_module(m.name)
        print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
        """)
    assert not (FORBIDDEN | {"repro_torch", "torch"}).intersection(out)


def test_no_source_under_bench_names_the_jax_package():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|repro)(?:\.|\s|$)",
                     re.M)
    for path in (ROOT / "bench").rglob("*.py"):
        assert not pat.search(path.read_text()), path
