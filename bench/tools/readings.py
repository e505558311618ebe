"""Readings of a cell's correctness checks over many seeds, in one
process: the program as it runs, or its f32 control.

    python3 bench/tools/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 10 [--control] [--out build/bench-runs/readings.jsonl]

``--control`` runs the program's own lower-precision path
(``REPRO_SIM_X64=0``: the f32 sweep) in its place. Each seed prints one
JSON line with the checks' values, ``correct`` and the window's size;
these are the readings a limit is set from (PERF.md). Run on a machine
with the card.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.control:
        os.environ["REPRO_SIM_X64"] = "0"
    from bench.benchkit import cell
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = cell.run_cell(args.workload, seed, args.seconds, False, root=ROOT)
        line = json.dumps({
            "workload": args.workload, "seed": seed, "control": args.control,
            "correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "wall_s": time.perf_counter() - t,
            "memory_peak_bytes": out["device"]["memory_peak_bytes"],
            "checks": {k: v["value"] for k, v in out["checks"].items()}},
            default=lambda x: x.item())
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
