"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `bench/` and
the program (`src/repro_torch`). The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last); the
last lines of standard error give each checked number beside its limit.
Exits 2 without a result when the cards the cell asks for are missing, 3
when JAX or the JAX package was loaded, 4 when the program is missing.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths (the
# sweep kernel's own build lands in build/repro_torch, fixed by the program)
CACHE = ROOT / "build" / "bench-cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item"):                  # NumPy scalars
        return x.item()
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program: {ROOT / 'src' / 'repro_torch'} is missing",
              file=sys.stderr)
        return 4
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.benchkit import cell

    try:
        out = cell.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), root=ROOT, t_start=T_START)
    except cell.NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    except cell.ForbiddenModules as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 3
    out = _jsonable(out)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
