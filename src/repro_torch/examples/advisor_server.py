"""Long-lived advisor server: `repro_torch.serve.AdvisorServer` behind a
tiny TCP JSON-lines front.

One JSON object per line, both directions:

    request   {"gen": {"family": "fan_out", "depth": 2, "width": 5},
               "seed": 3,
               "grid": {"n_nodes": [9], "partitions": [[2, 6], [4, 4]],
                        "chunk_sizes": [524288, 1048576]},
               "verify_top_k": 2, "timeout_s": 30.0, "client": "tenant0"}
    response  {"ok": true, "cached": false, "group_size": 3,
               "latency_s": 0.41, "best": {...}, "makespans": [...]}

Clients ship the *recipe* — generator spec + seed + grid knobs — not a
serialized workflow: `trace.generate` is deterministic in (spec, seed),
so two tenants asking about the same recipe reconstruct byte-identical
workflow fingerprints server-side and coalesce into ONE sweep, and a
repeat question is served from the results cache with zero compiles.
``--cache-dir`` persists the DAG cache so a restarted server warm-starts.
The server's sweeps run on ``--device``.

    python -m repro_torch.examples.advisor_server [--port 7081]
        [--cache-dir .advisor-cache] [--selftest] [--device cuda|cpu]

``--selftest`` serves one ephemeral-port session, runs two tenants
against it in-process, and exits (what CI or a quick smoke run wants);
the default runs until interrupted. Pair with
`repro_torch.examples.advisor_client`.
"""
from __future__ import annotations

import argparse
import asyncio
import json

from repro_torch.core import PAPER_RAMDISK, grid
from repro_torch.core.trace import GenSpec, generate_workflow, to_workflow
from repro_torch.env import resolve_device
from repro_torch.serve import AdvisorRequest, AdvisorServer, DeadlineExceeded


def parse_request(line: bytes) -> AdvisorRequest:
    msg = json.loads(line)
    wf = to_workflow(generate_workflow(GenSpec(**msg.get("gen", {})),
                                       int(msg.get("seed", 0))))
    g = msg.get("grid", {})
    cands = grid(n_nodes=g.get("n_nodes", [9]),
                 partitions=[tuple(p) for p in g["partitions"]]
                 if "partitions" in g else None,
                 chunk_sizes=g.get("chunk_sizes", [1 << 20]),
                 replications=g.get("replications", [1]))
    timeout = msg.get("timeout_s")
    return AdvisorRequest(workflow=wf, candidates=cands,
                          verify_top_k=int(msg.get("verify_top_k", 3)),
                          timeout_s=None if timeout is None
                          else float(timeout),
                          client=str(msg.get("client", "")))


def encode_response(resp) -> dict:
    c = resp.best.candidate
    return {"ok": True, "cached": resp.cached,
            "group_size": resp.group_size,
            "latency_s": round(resp.latency_s, 4),
            "best": {"n_nodes": c.n_nodes, "n_app": c.n_app,
                     "n_storage": c.n_storage, "chunk_size": c.chunk_size,
                     "replication": c.replication,
                     "makespan": float(resp.best.makespan)},
            "makespans": [float(m) for m in resp.makespans]}


def handler(srv: AdvisorServer):
    async def handle(reader, writer):
        while True:
            line = await reader.readline()
            if not line.strip():
                break
            try:
                resp = await srv.submit(parse_request(line))
                out = encode_response(resp)
            except DeadlineExceeded as e:
                out = {"ok": False, "error": str(e), "deadline": True}
            except Exception as e:            # bad recipe, closed server
                out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            writer.write((json.dumps(out) + "\n").encode())
            await writer.drain()
        writer.close()
        await writer.wait_closed()
    return handle


async def serve(args, ready=None):
    """Serve until interrupted (or, with ``args.selftest``, run the
    selftest and return). ``ready``, when given, is called with the
    bound port once the server listens."""
    async with AdvisorServer(PAPER_RAMDISK, cache_dir=args.cache_dir,
                             device=resolve_device(args.device)) as srv:
        tcp = await asyncio.start_server(handler(srv), args.host, args.port)
        port = tcp.sockets[0].getsockname()[1]
        print(f"advisor listening on {args.host}:{port} "
              f"(cache_dir={args.cache_dir})", flush=True)
        if ready is not None:
            ready(port)
        if args.selftest:
            await _selftest(port)
            print(f"selftest ok; stats: {srv.stats}")
        else:
            async with tcp:
                await tcp.serve_forever()
        tcp.close()
        await tcp.wait_closed()


async def _selftest(port: int) -> None:
    """Two tenants, same recipe: the second answer must arrive cached
    or coalesced — the server, not the tenants, dedupes the work."""
    recipe = {"gen": {"family": "fan_out", "depth": 2, "width": 5,
                      "mean_mb": 4.0, "sigma": 0.6, "runtime_s": 0.25},
              "seed": 1,
              "grid": {"n_nodes": [9], "partitions": [[2, 6], [4, 4]],
                       "chunk_sizes": [524288, 1048576]},
              "verify_top_k": 2}

    async def ask(tenant):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write((json.dumps({**recipe, "client": tenant})
                      + "\n").encode())
        await writer.drain()
        resp = json.loads(await reader.readline())
        writer.close()
        await writer.wait_closed()
        return resp

    first, second = await asyncio.gather(ask("tenant0"), ask("tenant1"))
    for r in (first, second):
        assert r["ok"], r
        print(f"  best: {r['best']} cached={r['cached']} "
              f"group_size={r['group_size']}")
    assert first["makespans"] == second["makespans"]
    assert any(r["cached"] or r["group_size"] > 1 for r in (first, second))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7081)
    ap.add_argument("--cache-dir", default=None,
                    help="persist the DAG cache (warm restarts)")
    ap.add_argument("--selftest", action="store_true",
                    help="serve one ephemeral session, query it, exit")
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run (cuda, or cpu)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)        # no card and no --device cpu: raise
    if args.selftest:
        args.port = 0
    asyncio.run(serve(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
