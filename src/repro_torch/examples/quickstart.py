"""Quickstart: the paper's predictor in five minutes.

Identify the system, predict a workflow's turnaround under two storage
configurations, check the prediction against the emulated cluster, and
sweep a what-if hardware upgrade — the §2.1 requirements, end to end.
System identification and the emulated cluster run on the host; the
predictions run on ``--device``.

    python -m repro_torch.examples.quickstart [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core import (MB, Predictor, collocated_config, identify)
from repro_torch.core import workloads as W
from repro_torch.core.emulator import run_trials
from repro_torch.env import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the predictions run (cuda, or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. system identification (§2.5) against the emulated testbed
    print("== system identification ==")
    rep = identify()
    st = rep.service_times
    print(f"  net_remote : {1/st.net_remote/MB:8.1f} MB/s")
    print(f"  net_local  : {1/st.net_local/MB:8.1f} MB/s")
    print(f"  storage    : {1/st.storage/MB:8.1f} MB/s  (+{st.storage_req*1e3:.2f} ms/chunk)")
    print(f"  manager    : {st.manager*1e3:8.2f} ms/request")
    print(f"  ({rep.n_measurements}+ measurements, 95% CI +-5%)")

    # 2. predict: pipeline benchmark, DSS vs WASS (Fig. 4)
    print("\n== prediction: pipeline benchmark, 19 parallel pipelines ==")
    cfg = collocated_config(20)
    for label, wf_fn, la in [("DSS (striped)", lambda: W.pipeline(19), False),
                             ("WASS (local placement)",
                              lambda: W.pipeline(19, wass=True), True)]:
        pred = Predictor(st, locality_aware=la, device=dev).predict(wf_fn(),
                                                                   cfg)
        actual, std, _ = run_trials(wf_fn, cfg, trials=3, locality_aware=la)
        err = (pred.makespan - actual) / actual * 100
        print(f"  {label:24s} predicted {pred.makespan:7.2f}s | "
              f"actual {actual:7.2f}s +-{std:.2f} | err {err:+5.1f}%")

    # 3. what-if (§2.1): would SSDs help? (storage 10x faster)
    print("\n== what-if: upgrade storage nodes to SSD-class ==")
    pred = Predictor(st, device=dev)
    ssd = st.replace(storage=st.storage / 10, storage_req=st.storage_req / 3)
    base_t, ssd_t = pred.what_if(W.reduce_(19, wass=True), cfg, [st, ssd])
    print(f"  reduce/WASS: {base_t:.2f}s -> {ssd_t:.2f}s "
          f"({(1 - ssd_t/base_t)*100:.0f}% faster) — without buying hardware")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
