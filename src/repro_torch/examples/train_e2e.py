"""End-to-end training driver example: train a reduced granite-3-2b for a
few hundred steps with predictor-planned checkpointing and a mid-run
fault injection + restart, on ``--device``.

    python -m repro_torch.examples.train_e2e [--steps 300] [--device cpu]

A thin wrapper of `repro_torch.launch.train.train_loop` with the
reference script's settings; the full-width training path is driven by
chip_smoke.py.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.core import default_session
from repro_torch.env import resolve_device
from repro_torch.launch.train import train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--fail-at", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="where training runs (cuda, or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as ckpt:
        rep = train_loop(args.arch, steps=args.steps, reduced=True,
                         ckpt_dir=ckpt, ckpt_every=50, seq_len=128,
                         batch=8, fail_at=args.fail_at, lr=3e-3,
                         log_every=20, device=dev)
    print(f"\nloss {rep['loss_first']:.3f} -> {rep['loss_last']:.3f} "
          f"over {rep['final_step']} steps ({rep['wall_s']:.0f}s wall, "
          f"fault at step {args.fail_at} survived)")
    if dev.type == "cuda":
        # the planner ran on the default session (its sweeps on the card)
        s = default_session().stats
        print(f"[device: {dev}; sweep_scan kernel (the plan): "
              f"{s.kernel_launches} launches, {s.kernel_fallbacks} "
              f"fallbacks to the plain loop]")
    else:
        print(f"[device: {dev}]")
    assert rep["loss_last"] < rep["loss_first"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
