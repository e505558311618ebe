"""Drives `AdvisorServer.submit` on a bad day: tenants ask the advisor to
rank storage candidates for a workflow, each candidate healthy and under
the configuration's faults (`advisor_submit`'s driver, with the fault
axis and the configuration's replication factors added to its grid).

The configuration's ``faults`` are rank-based, as the program's
`FaultScenario` is: ``degraded`` lists a storage rank's disk and its
factor, ``failures`` a storage rank lost after ``floor(n_app * a / b)``
task placements (``after_tasks_share`` ``[a, b]``), so the loss falls
inside each job whatever its partition.

The check rebuilds each sampled request's workflow and deployments with
the plain reference (`reference.faults` for the faulted candidates,
`reference.compiler` and `reference.scan` for the healthy ones) and
compares the answer's makespans, ranking and failed verdicts; every
answer must name exactly the candidates its request asked about.
"""
from __future__ import annotations

import importlib
import sys
import time
from typing import Dict, List, Tuple

from repro_torch.core import workloads
from repro_torch.core.faults import (DiskDegradation, FaultScenario,
                                     NodeFailure)
from repro_torch.core.sweep.search import grid
from repro_torch.core.types import Placement
from repro_torch.serve import AdvisorRequest

from bench.benchkit.cell import sample_records
from bench.drivers import advisor_submit
from bench.reference import compiler as ref_compiler
from bench.reference import faults as ref_faults
from bench.reference import scan as ref_scan


class Driver(advisor_submit.Driver):
    def __init__(self, cell, seed: int, device, tracer):
        super().__init__(cell, seed, device, tracer)
        self.replications = tuple(self.cfg["storage"]["replications"])

    # -- the scenario ----------------------------------------------------------
    def _ranks(self, n_app: int):
        """(storage rank, after_tasks) losses and {rank: factor} disks."""
        f = self.cfg["faults"]
        kills = [(x["rank"], n_app * x["after_tasks_share"][0]
                  // x["after_tasks_share"][1]) for x in f["failures"]]
        return kills, {x["rank"]: float(x["factor"]) for x in f["degraded"]}

    def scenario(self, n_app: int) -> FaultScenario:
        kills, disks = self._ranks(n_app)
        return FaultScenario(
            failures=tuple(NodeFailure(r, after_tasks=k) for r, k in kills),
            degraded=tuple(DiskDegradation(r, x) for r, x in disks.items()),
            name=f"bad-day@{n_app}")

    def _fits(self, n_app: int) -> bool:
        kills, disks = self._ranks(n_app)
        return max([r for r, _ in kills] + list(disks)) < self._n_storage(n_app)

    # -- the program's side ----------------------------------------------------
    def _question(self, p: Dict[str, int], client: int) -> AdvisorRequest:
        wl = self.cfg["workflow"]
        n_app = p["n_app"]
        args = dict(wl["args"], **{k: v for k, v in p.items() if k != "n_app"})
        wf = getattr(workloads, wl["pattern"])(n_app, **args)
        cands = grid([self.cfg["cluster"]["n_nodes"]],
                     partitions=[(n_app, self._n_storage(n_app))],
                     chunk_sizes=self.mix["candidates"]["chunk_sizes"],
                     stripe_widths=self.mix["candidates"]["stripe_widths"],
                     replications=self.replications,
                     placements=(Placement(self.cfg["storage"]["placement"]),),
                     faults=(None, self.scenario(n_app)))
        return AdvisorRequest(workflow=wf, candidates=tuple(cands),
                              verify_top_k=self.mix["verify_top_k"],
                              objective=self.mix["objective"],
                              locality_aware=self.cfg["locality_aware"],
                              client=f"tenant{client}")

    async def issue(self, k: int, client: int):
        p = self.request_params(k)
        resp = await self.server.submit(self._question(p, client))
        answer = tuple((c.n_app, c.n_storage, c.chunk_size, c.stripe_width,
                        c.replication, int(c.faults is not None), e.makespan)
                       for e in resp.evaluations for c in (e.candidate,))
        return len(answer), (p, answer)

    # -- the check ---------------------------------------------------------------
    def _asked(self, p) -> List[tuple]:
        n_app = p["n_app"]
        n_storage = self._n_storage(n_app)
        return [(n_app, n_storage, ck, sw, r, f)
                for ck in self.mix["candidates"]["chunk_sizes"]
                for sw in self.mix["candidates"]["stripe_widths"]
                if sw <= n_storage
                for r in self.replications if r <= n_storage
                for f in (0, 1) if not f or self._fits(n_app)]

    def _reference(self, p: Dict[str, int]) -> List[Tuple[tuple, float]]:
        """(candidate, makespan) in the grid's order, by the reference."""
        wl = self.cfg["workflow"]
        n_app = p["n_app"]
        args = dict(wl["args"], **{k: v for k, v in p.items() if k != "n_app"})
        pattern = importlib.import_module(
            f"bench.reference.patterns.{wl['pattern']}")
        wf = pattern.build(n_app, **args)
        st = self.cfg["service_times"]
        kills, disks = self._ranks(n_app)
        scen = {"kill": kills, "degraded": disks}
        out = []
        for key in self._asked(p):
            _, n_storage, ck, sw, r, f = key
            dep = ref_compiler.partitioned(
                n_app, n_storage, chunk_size=ck, stripe_width=sw,
                replication=r, placement=self.cfg["storage"]["placement"])
            la = self.cfg["locality_aware"]
            if f:
                dag = ref_faults.compile_dag(wf, dep, scen, locality_aware=la)
                out.append((key, ref_faults.Dag(dag, st).makespan(st)))
            else:
                dag = ref_compiler.compile_dag(wf, dep, locality_aware=la)
                out.append((key, ref_scan.Dag(dag, st).makespan(st)))
        return out

    def check(self, records, rng) -> Dict[str, float]:
        """`advisor_submit`'s checks on the replication and fault axes,
        and ``failed_mismatches``: sampled answers whose failed verdicts
        differ from the reference's on any candidate. Prints how the
        faulted candidates of every answer came out, by replication, and
        the check's own time."""
        t0 = time.perf_counter()
        wrong = 0
        tally: Dict[int, List[int]] = {}        # r -> [failed, asked]
        for r in records:
            p, answer = r.answer
            wrong += sorted(a[:-1] for a in answer) != sorted(self._asked(p))
            for a in answer:
                if a[5]:
                    t = tally.setdefault(a[4], [0, 0])
                    t[0] += ref_faults.failed(a[-1])
                    t[1] += 1
        print("faulted candidates failed: " + ", ".join(
            f"r {r} {t[0]} of {t[1]}" for r, t in sorted(tally.items())),
            file=sys.stderr)
        n = self.mix["check"]["answers"]
        longest_by = self.mix["check"]["longest_by"]
        pick = sample_records(records, n, rng,
                              key=lambda r: r.answer[0][longest_by])
        gap, ranks, verdicts = 0.0, 0, 0
        for r in pick:
            p, answer = r.answer
            ref = self._reference(p)
            want = dict(ref)
            for a in answer:
                m_ref = want.get(a[:-1])
                if m_ref is None:          # counted in wrong_answers too
                    gap = max(gap, 1.0)
                    continue
                gap = max(gap, abs(a[-1] - m_ref) / abs(m_ref))
            order = [c for c, _ in sorted(ref, key=lambda cm: cm[1])]
            ranks += [a[:-1] for a in answer] != order
            verdicts += (sorted((a[:-1], ref_faults.failed(a[-1]))
                                for a in answer)
                         != sorted((c, ref_faults.failed(m)) for c, m in ref))
        print(f"check: {len(pick)} answers against the reference in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return {"wrong_answers": wrong, "makespan_rel_gap": gap,
                "rank_mismatches": ranks, "failed_mismatches": verdicts}
