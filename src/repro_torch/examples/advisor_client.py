"""Multi-tenant advisor client: seeded query mix against a running
`repro_torch.examples.advisor_server` (or the reference's server: the
wire format is the same).

Each tenant replays a seeded schedule of recipes drawn from a small
pool, so different tenants keep asking structurally-equal questions —
watch ``group_size`` (coalesced into one sweep) and ``cached`` (served
from the results cache with zero compiles) in the output.

    python -m repro_torch.examples.advisor_server &
    python -m repro_torch.examples.advisor_client
        [--tenants 4] [--requests 3] [--seed 23] [--port 7081]
        [--device cuda|cpu]

The client computes nothing itself; ``--device`` is checked as every
entry point of the port checks it (``cuda``, the default, needs a card)
and names the host the server is expected to run its sweeps on.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np

from repro_torch.env import resolve_device

RECIPE_POOL = 4          # distinct (spec, seed) recipes tenants draw from


def make_query(recipe_seed: int, tenant: str) -> dict:
    return {"gen": {"family": "fan_out", "depth": 2, "width": 5,
                    "mean_mb": 4.0, "sigma": 0.6, "runtime_s": 0.25},
            "seed": recipe_seed,
            "grid": {"n_nodes": [9], "partitions": [[2, 6], [4, 4]],
                     "chunk_sizes": [524288, 1048576]},
            "verify_top_k": 2, "client": tenant}


async def tenant(cid: int, args, results: list):
    rng = np.random.default_rng(args.seed + cid)
    reader, writer = await asyncio.open_connection(args.host, args.port)
    for _ in range(args.requests):
        await asyncio.sleep(float(rng.uniform(0.0, 0.02)))
        q = make_query(int(rng.integers(0, RECIPE_POOL)), f"tenant{cid}")
        t0 = time.monotonic()
        writer.write((json.dumps(q) + "\n").encode())
        await writer.drain()
        resp = json.loads(await reader.readline())
        rtt = time.monotonic() - t0
        results.append((cid, q["seed"], resp, rtt))
    writer.close()
    await writer.wait_closed()


async def run(args) -> list:
    """Every tenant's requests; prints one line per answer and a
    summary, and returns the (tenant, recipe, response, rtt) rows."""
    results: list = []
    t0 = time.monotonic()
    await asyncio.gather(*(tenant(c, args, results)
                           for c in range(args.tenants)))
    wall = time.monotonic() - t0
    for cid, seed, resp, rtt in results:
        if not resp["ok"]:
            print(f"tenant{cid} recipe{seed}: ERROR {resp['error']}")
            continue
        b = resp["best"]
        print(f"tenant{cid} recipe{seed}: best n_storage={b['n_storage']} "
              f"chunk={b['chunk_size'] >> 10}KB -> {b['makespan']:.2f}s  "
              f"[cached={resp['cached']} group={resp['group_size']} "
              f"rtt={rtt * 1e3:.0f}ms]")
    ok = [r for _, _, r, _ in results if r["ok"]]
    shared = sum(1 for r in ok if r["cached"] or r["group_size"] > 1)
    print(f"{len(ok)}/{len(results)} answered in {wall:.2f}s "
          f"({len(ok) / max(wall, 1e-9):.1f} q/s); "
          f"{shared} served by a coalesced or cached sweep")
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7081)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--device", default="cuda",
                    help="checked as every entry point checks it (cuda, "
                         "or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
