"""Drives `Predictor.what_if`: a designer asks how one deployment would
run on many hypothetical hardware profiles (PDSW'13 §2.1).

The configuration lists workflow patterns (each with its placement and
scheduling) and chunk sizes; their product is the set of deployments.
Set-up builds one `SweepSession` on the card with a `Predictor` per
scheduling policy on it, compiles every deployment's DAG into the
session's cache and asks one what-if question per deployment. Each
request of the window picks a deployment by the mix's rule and draws
the mix's number of profiles from its ranges; the answer is one makespan
per profile.

The check compiles each sampled request's deployment with the plain
reference, and scans a sample of its profiles there, all in one pass.
"""
from __future__ import annotations

import importlib
from typing import Dict

import numpy as np

from repro_torch.core import workloads
from repro_torch.core.predictor import Predictor
from repro_torch.core.sweep.session import SweepSession
from repro_torch.core.types import (Placement, ServiceTimes,
                                    collocated_config)

from bench.benchkit.cell import sample_records
from bench.benchkit.traffic import Sequence, request_stream, sample
from bench.benchkit.yardstick import NO_WORK, scan_work
from bench.reference import compiler as ref_compiler
from bench.reference import scan as ref_scan


class Driver:
    def __init__(self, cell, seed: int, device, tracer):
        self.cfg = cell.config_data
        self.mix = cell.mix
        self.seed = seed
        self.device = device
        self.st_ref = ServiceTimes(**self.cfg["service_times"])
        self.deployments = [(pat, ck) for pat in self.cfg["patterns"]
                            for ck in self.cfg["chunk_sizes"]]
        rule = self.mix["request"]["deployment"]
        if len(rule.get("cycle", self.deployments)) != len(self.deployments):
            raise ValueError("the mix weighs another number of deployments "
                             "than the configuration has")
        self.pick = Sequence(rule, seed, "deployment")
        self.n_profiles = int(self.mix["profiles"]["count"])
        self._ref_dags: Dict[int, dict] = {}
        self._ref_scans: Dict[int, ref_scan.Dag] = {}

    # -- the program's side ----------------------------------------------------
    def _port_deployment(self, pat: dict, chunk: int):
        wf = getattr(workloads, pat["pattern"])(**pat["args"])
        st = self.cfg["storage"]
        cfg = collocated_config(self.cfg["cluster"]["n_hosts"],
                                stripe_width=st["stripe_width"],
                                replication=st["replication"],
                                chunk_size=chunk,
                                placement=Placement(st["placement"]))
        return wf, cfg

    def profiles(self, k: int, stream: str = "profiles") -> np.ndarray:
        """Request ``k``'s profiles, ``[P, 7]`` in `PROFILE_KEYS` order."""
        rng = request_stream(self.seed, stream, k)
        rules = self.mix["profiles"]["ranges"]
        return np.stack([sample(rules[key], rng, self.n_profiles)
                         for key in ref_scan.PROFILE_KEYS], axis=1)

    async def setup(self) -> None:
        self.session = SweepSession(device=self.device)
        preds = {}
        self.port = []              # (workflow, config, predictor) a deployment
        self.n_ops = []
        for pat, ck in self.deployments:
            la = bool(pat["locality_aware"])
            if la not in preds:
                preds[la] = Predictor(self.st_ref, locality_aware=la,
                                      session=self.session)
            wf, cfg = self._port_deployment(pat, ck)
            ops = preds[la].compile(wf, cfg)
            self.port.append((wf, cfg, preds[la]))
            self.n_ops.append(ops.n_ops)
        for d in range(len(self.deployments)):
            self._ask(d, self.profiles(d, "warmup"))

    def _ask(self, d: int, vecs: np.ndarray) -> np.ndarray:
        wf, cfg, pred = self.port[d]
        return pred.what_if(wf, cfg, [ServiceTimes(*row) for row in vecs.tolist()])

    async def issue(self, k: int, client: int):
        d = self.pick[k]
        m = self._ask(d, self.profiles(k))
        return len(m), (d, m)

    async def close(self) -> None:
        self.session.close()

    def release(self) -> None:
        self.session = self.port = None

    # -- the yardstick and the check --------------------------------------------
    def _ref_dag(self, d: int) -> dict:
        if d not in self._ref_dags:
            pat, ck = self.deployments[d]
            build = importlib.import_module(
                f"bench.reference.patterns.{pat['pattern']}").build
            st = self.cfg["storage"]
            dep = ref_compiler.collocated(
                self.cfg["cluster"]["n_hosts"], chunk_size=ck,
                stripe_width=st["stripe_width"], replication=st["replication"],
                placement=st["placement"])
            self._ref_dags[d] = ref_compiler.compile_dag(
                build(**pat["args"]), dep, locality_aware=pat["locality_aware"])
        return self._ref_dags[d]

    def work(self, records):
        """The scan work of every request of the window."""
        total = NO_WORK
        for r in records:
            total = total + scan_work(self._ref_dag(self.pick[r.k]),
                                      self.n_profiles)
        return total

    def check(self, records, rng) -> Dict[str, float]:
        """``wrong_answers``: answers without one finite makespan per
        profile; ``makespan_rel_gap``: the largest relative gap to the
        reference's of the makespans of a sample of answers, at a
        sample of each one's profiles drawn from the seed (all of them
        where the mix asks as many)."""
        wrong = sum(len(r.answer[1]) != self.n_profiles
                    or not np.isfinite(r.answer[1]).all() for r in records)
        chk = self.mix["check"]
        pick = sample_records(records, chk["answers"], rng,
                              key=lambda r: self.n_ops[r.answer[0]])
        gap = 0.0
        for r in pick:
            d, m = r.answer
            if d not in self._ref_scans:
                self._ref_scans[d] = ref_scan.Dag(self._ref_dag(d),
                                                  self.cfg["service_times"])
            js = np.sort(rng.permutation(self.n_profiles)
                         [:chk["profiles_per_answer"]])
            ref = self._ref_scans[d].makespans(self.profiles(r.k)[js])
            got = np.full(len(js), np.nan)
            ok = js < len(m)
            got[ok] = np.asarray(m, dtype=np.float64)[js[ok]]
            g = np.abs(got - ref) / np.abs(ref)
            gap = max(gap, float(np.where(np.isfinite(g), g, 1.0).max()))
        return {"wrong_answers": wrong, "makespan_rel_gap": gap}
