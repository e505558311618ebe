"""Drives `AdvisorServer.submit` warm: many tenants ask one advisor about
a BLAST job it already knows, each about one partition of the cluster
and a subset of that partition's candidates (`advisor_submit`'s driver
with another question).

The mix fixes the job (``request.n_queries``), the partitions
(``partitions``: app-node counts) and the candidates (chunk sizes times
stripe widths, a width only where the partition has that many storage
nodes). Set-up asks each partition's whole grid once, which compiles and
prepares every DAG the window will use. A question of the window is one
(partition, non-empty proper subset of its grid) pair: the mix's
``question`` rule draws its index among all such pairs, partitions in
the mix's order and, within one, subsets by their bit mask over the
grid's order (mask 1 .. 2^k - 2). So no window question equals a set-up
question, and a permutation asks none twice.

The check is `advisor_submit`'s on the subset asked.
"""
from __future__ import annotations

import importlib
import sys
import time
from typing import Dict, List, Tuple

from repro_torch.core import workloads
from repro_torch.core.sweep.search import grid
from repro_torch.core.sweep.session import SweepSession
from repro_torch.core.types import Placement
from repro_torch.serve import AdvisorRequest, AdvisorServer

from bench.drivers import advisor_submit
from bench.reference import compiler as ref_compiler
from bench.reference import scan as ref_scan


class Driver(advisor_submit.Driver):
    def __init__(self, cell, seed: int, device, tracer):
        super().__init__(cell, seed, device, tracer)
        cands = self.mix["candidates"]
        # (n_app, its grid's keys in the grid's order) a partition
        self.grids: List[Tuple[int, List[tuple]]] = []
        for n_app in self.mix["partitions"]:
            n_storage = self._n_storage(n_app)
            self.grids.append((n_app, [
                (n_app, n_storage, ck, sw) for ck in cands["chunk_sizes"]
                for sw in cands["stripe_widths"] if sw <= n_storage]))
        pairs = sum(2 ** len(keys) - 2 for _, keys in self.grids)
        rule = self.mix["request"]["question"]
        if rule.get("permutation") != [0, pairs - 1]:
            raise ValueError(f"the mix's question rule {rule} must be the "
                             f"permutation of [0, {pairs - 1}]: the "
                             f"partitions have {pairs} questions")

    def request_params(self, k: int) -> Dict[str, object]:
        q = self.params["question"][k]
        for n_app, keys in self.grids:
            n = 2 ** len(keys) - 2
            if q < n:
                mask = q + 1
                return {"n_app": n_app,
                        "n_queries": self.params["n_queries"][k],
                        "subset": tuple(i for i in range(len(keys))
                                        if mask >> i & 1)}
            q -= n
        raise IndexError(f"question {self.params['question'][k]} past the "
                         "mix's partitions")

    # -- the program's side ----------------------------------------------------
    def _question(self, p, client: int) -> AdvisorRequest:
        """``p["subset"]`` None asks the partition's whole grid."""
        wl = self.cfg["workflow"]
        n_app = p["n_app"]
        wf = getattr(workloads, wl["pattern"])(
            n_app, **dict(wl["args"], n_queries=p["n_queries"]))
        st_cfg = self.cfg["storage"]
        cands = grid([self.cfg["cluster"]["n_nodes"]],
                     partitions=[(n_app, self._n_storage(n_app))],
                     chunk_sizes=self.mix["candidates"]["chunk_sizes"],
                     stripe_widths=self.mix["candidates"]["stripe_widths"],
                     replications=(st_cfg["replication"],),
                     placements=(Placement(st_cfg["placement"]),))
        if p.get("subset") is not None:
            cands = [cands[i] for i in p["subset"]]
        return AdvisorRequest(workflow=wf, candidates=tuple(cands),
                              verify_top_k=self.mix["verify_top_k"],
                              objective=self.mix["objective"],
                              locality_aware=self.cfg["locality_aware"],
                              client=f"tenant{client}")

    async def setup(self) -> None:
        self.session = SweepSession(device=self.device, tracer=self.tracer)
        self.server = AdvisorServer(self.st, session=self.session)
        await self.server.start()
        n_queries = self.mix["request"]["n_queries"]["fixed"]
        for n_app, _ in self.grids:
            await self.server.submit(self._question(
                {"n_app": n_app, "n_queries": n_queries, "subset": None}, 0))

    # -- the check ---------------------------------------------------------------
    def _asked(self, p) -> List[tuple]:
        keys = dict(self.grids)[p["n_app"]]
        return [keys[i] for i in p["subset"]]

    def _reference(self, p) -> List[Tuple[tuple, float]]:
        """(candidate, makespan) of the subset asked, in the grid's order,
        by the reference."""
        wl = self.cfg["workflow"]
        n_app = p["n_app"]
        pattern = importlib.import_module(
            f"bench.reference.patterns.{wl['pattern']}")
        wf = pattern.build(n_app, **dict(wl["args"], n_queries=p["n_queries"]))
        st = self.cfg["service_times"]
        st_cfg = self.cfg["storage"]
        out = []
        for key in self._asked(p):
            _, n_storage, ck, sw = key
            dep = ref_compiler.partitioned(
                n_app, n_storage, chunk_size=ck, stripe_width=sw,
                replication=st_cfg["replication"],
                placement=st_cfg["placement"])
            dag = ref_compiler.compile_dag(
                wf, dep, locality_aware=self.cfg["locality_aware"])
            out.append((key, ref_scan.Dag(dag, st).makespan(st)))
        return out

    def check(self, records, rng) -> Dict[str, float]:
        """`advisor_submit`'s check, and its time on stderr."""
        t0 = time.perf_counter()
        out = super().check(records, rng)
        print(f"check: {self.mix['check']['answers']} answers against the "
              f"reference in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        return out
