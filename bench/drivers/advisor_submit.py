"""Drives `AdvisorServer.submit`: tenants ask the advisor to rank
storage candidates for a workflow.

Set-up builds one `SweepSession` on the card (no DAG disk cache: a
cache would turn a later run of the same seed warm) and a server on it
with its default results cache, and sends the mix's warm-up requests.
Each request of the window asks about one workflow of the
configuration's pattern, with the mix's parameters, against the
candidates of one partition of the cluster.

The check rebuilds each sampled request's workflow and deployments with
the plain reference, compiles and scans them there, and compares the
answer's makespans and ranking; every answer must name exactly the
candidates its request asked about.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.core import workloads
from repro_torch.core.sweep.search import grid
from repro_torch.core.sweep.session import SweepSession
from repro_torch.core.types import Placement, ServiceTimes
from repro_torch.serve import AdvisorRequest, AdvisorServer

from bench.benchkit.cell import sample_records
from bench.benchkit.traffic import Sequence
from bench.reference import compiler as ref_compiler
from bench.reference import scan as ref_scan


class Driver:
    def __init__(self, cell, seed: int, device, tracer):
        self.cfg = cell.config_data
        self.mix = cell.mix
        self.device = device
        self.tracer = tracer
        self.st = ServiceTimes(**self.cfg["service_times"])
        self.params = {name: Sequence(rule, seed, name)
                       for name, rule in self.mix["request"].items()}
        self.session = None
        self.server = None

    # -- the program's side ----------------------------------------------------
    def _question(self, p: Dict[str, int], client: int) -> AdvisorRequest:
        wl = self.cfg["workflow"]
        n_app = p["n_app"]
        args = dict(wl["args"], **{k: v for k, v in p.items() if k != "n_app"})
        wf = getattr(workloads, wl["pattern"])(n_app, **args)
        st_cfg = self.cfg["storage"]
        cands = grid([self.cfg["cluster"]["n_nodes"]],
                     partitions=[(n_app, self._n_storage(n_app))],
                     chunk_sizes=self.mix["candidates"]["chunk_sizes"],
                     stripe_widths=self.mix["candidates"]["stripe_widths"],
                     replications=(st_cfg["replication"],),
                     placements=(Placement(st_cfg["placement"]),))
        return AdvisorRequest(workflow=wf, candidates=tuple(cands),
                              verify_top_k=self.mix["verify_top_k"],
                              objective=self.mix["objective"],
                              locality_aware=self.cfg["locality_aware"],
                              client=f"tenant{client}")

    def _n_storage(self, n_app: int) -> int:
        return self.cfg["cluster"]["n_nodes"] - 1 - n_app

    async def setup(self) -> None:
        self.session = SweepSession(device=self.device, tracer=self.tracer)
        self.server = AdvisorServer(self.st, session=self.session)
        await self.server.start()
        for p in self.mix["warmup"]:
            await self.server.submit(self._question(p, 0))

    def request_params(self, k: int) -> Dict[str, int]:
        return {name: seq[k] for name, seq in self.params.items()}

    async def issue(self, k: int, client: int):
        p = self.request_params(k)
        resp = await self.server.submit(self._question(p, client))
        answer = tuple((e.candidate.n_app, e.candidate.n_storage,
                        e.candidate.chunk_size, e.candidate.stripe_width,
                        e.makespan) for e in resp.evaluations)
        return len(answer), (p, answer)

    async def close(self) -> None:
        await self.server.close()
        self.session.close()

    def release(self) -> None:
        self.server = self.session = None

    def work(self, records):
        return None

    # -- the check ---------------------------------------------------------------
    def _reference(self, p: Dict[str, int]) -> List[Tuple[tuple, float]]:
        """(candidate, makespan) in the grid's order, by the reference."""
        wl = self.cfg["workflow"]
        n_app = p["n_app"]
        args = dict(wl["args"], **{k: v for k, v in p.items() if k != "n_app"})
        pattern = importlib.import_module(
            f"bench.reference.patterns.{wl['pattern']}")
        wf = pattern.build(n_app, **args)
        st = self.cfg["service_times"]
        st_cfg = self.cfg["storage"]
        n_storage = self._n_storage(n_app)
        out = []
        for ck in self.mix["candidates"]["chunk_sizes"]:
            for sw in self.mix["candidates"]["stripe_widths"]:
                if sw > n_storage:
                    continue
                dep = ref_compiler.partitioned(
                    n_app, n_storage, chunk_size=ck, stripe_width=sw,
                    replication=st_cfg["replication"],
                    placement=st_cfg["placement"])
                dag = ref_compiler.compile_dag(
                    wf, dep, locality_aware=self.cfg["locality_aware"])
                out.append(((n_app, n_storage, ck, sw),
                            ref_scan.Dag(dag, st).makespan(st)))
        return out

    def check(self, records, rng) -> Dict[str, float]:
        """``wrong_answers``: answers whose candidates are not the
        request's; ``makespan_rel_gap``: the largest relative gap of a
        sampled answer's makespan to the reference's;
        ``rank_mismatches``: sampled answers ranked otherwise than the
        reference ranks them (stable, by makespan)."""
        wrong = 0
        for r in records:
            p, answer = r.answer
            wrong += sorted(a[:4] for a in answer) != sorted(self._asked(p))
        n = self.mix["check"]["answers"]
        longest_by = self.mix["check"]["longest_by"]
        pick = sample_records(records, n, rng,
                              key=lambda r: r.answer[0][longest_by])
        gap, ranks = 0.0, 0
        for r in pick:
            p, answer = r.answer
            ref = self._reference(p)
            want = dict(ref)
            for a in answer:
                m_ref = want.get(a[:4])
                if m_ref is None:          # counted in wrong_answers too
                    gap = max(gap, 1.0)
                    continue
                gap = max(gap, abs(a[4] - m_ref) / abs(m_ref))
            order = [c for c, _ in sorted(ref, key=lambda cm: cm[1])]
            ranks += [a[:4] for a in answer] != order
        return {"wrong_answers": wrong, "makespan_rel_gap": gap,
                "rank_mismatches": ranks}

    def _asked(self, p):
        n_app = p["n_app"]
        n_storage = self._n_storage(n_app)
        return [(n_app, n_storage, ck, sw)
                for ck in self.mix["candidates"]["chunk_sizes"]
                for sw in self.mix["candidates"]["stripe_widths"]
                if sw <= n_storage]

