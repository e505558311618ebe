"""Sets of runs of one cell, each run a fresh process as the check makes
them, and the spread of each metric.

    python3 bench/tools/sets.py --workload <name> --seeds 1,2,3,4,5,6 \
        --sets 2 --seconds 51 --out build/bench-runs [--first] [--trace 1]

Every set runs the same seeds in order. ``--first`` makes one run more
before the sets, which builds what the checkout lacks (its set-up is
recorded apart). Result lines go to ``<out>/<workload>.jsonl``; the
summary gives, per metric, each set's median, its spread (Q3 - Q1 over
the median, `statistics.quantiles`), the spread without the run farthest
from the median, and five times the widest spread (the bound it asks).
``--summarize FILE`` prints the summary of lines already written.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from bench.benchkit.stats import spread, spread_without_farthest  # noqa: E402


def run_once(workload, seed, seconds, trace):
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=1300)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    try:
        out = json.loads(line)
    except json.JSONDecodeError:
        out = {"error": proc.stderr[-2000:]}
    out["_rc"] = proc.returncode
    out["_wall_s"] = time.perf_counter() - t
    out["_seed"] = seed
    return out


def summarize(lines):
    sets = {}
    for ln in lines:
        if ln.get("_set", -1) < 0:
            continue
        sets.setdefault(ln["_set"], []).append(ln)
    names = sorted({m for lns in sets.values() for ln in lns
                    for m in ln.get("metrics", {})})
    out = {"correct": [ln.get("correct") for lns in sets.values() for ln in lns],
           "metrics": {}}
    for m in names:
        per = {}
        for s, lns in sorted(sets.items()):
            vals = [ln["metrics"][m]["value"] for ln in lns if m in ln.get("metrics", {})]
            if len(vals) >= 3:
                per[s] = {"values": vals, "median": statistics.median(vals),
                          "spread": spread(vals),
                          "spread_wo_farthest": (spread_without_farthest(vals)
                                                 if len(vals) >= 4 else None)}
        widest = max((p["spread"] for p in per.values()), default=None)
        out["metrics"][m] = {"sets": per, "widest_spread": widest,
                             "five_times": None if widest is None else 5 * widest}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--first", action="store_true")
    ap.add_argument("--out", default="build/bench-runs")
    ap.add_argument("--summarize")
    args = ap.parse_args(argv)
    if args.summarize:
        lines = [json.loads(x) for x in Path(args.summarize).read_text().splitlines() if x]
        print(json.dumps(summarize(lines), indent=1))
        return 0
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{args.workload}.jsonl"
    seeds = [int(s) for s in args.seeds.split(",")]
    plan = ([(-1, seeds[0])] if args.first else []) + \
        [(s, seed) for s in range(args.sets) for seed in seeds]
    lines = []
    for set_no, seed in plan:
        out = run_once(args.workload, seed, args.seconds, args.trace)
        out["_set"] = set_no
        lines.append(out)
        with open(path, "a") as f:
            f.write(json.dumps(out) + "\n")
        print(json.dumps({k: out.get(k) for k in ("_set", "_seed", "_rc", "_wall_s", "correct")}
                         | {m: v["value"] for m, v in out.get("metrics", {}).items()}),
              flush=True)
    print(json.dumps(summarize(lines), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
