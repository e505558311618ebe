"""End-to-end training driver — the counterpart of `repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 200 --reduced --ckpt-dir /tmp/ckpt

Wires together every substrate: data pipeline (with straggler
mitigation), predictor-planned checkpointing over intermediate storage,
fault injection + restart, and the train step, on one device
(``device="cuda"`` by default; ``--device cpu`` runs the plain PyTorch
path on the host). ``--reduced`` (the default) runs the same code path
with the reduced config, ``--full`` with the published one
(`train_loop`'s ``n_layers`` cuts the depth of either).

The checkpoint plan is the paper's predictor at work: before any byte
is written, `plan_checkpoint` sweeps 27 storage configurations for this
job's checkpoint (its state bytes over ``n_shards`` writers), on the
card through the sweep_scan kernel.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import torch

from .. import configs as cfgs
from ..checkpoint import CheckpointManager, IntermediateStore, plan_checkpoint
from ..core import TPU_POD_STAGING
from ..data import DataPipeline, PipelineConfig
from ..env import DeviceLike, resolve_device
from ..models import init, n_params
from ..models.config import ShapeConfig
from ..optim import adamw
from ..train import TrainState, make_train_step
from ..tree import tree_leaves


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(arch_name: str, *, steps: int = 100, reduced: bool = True,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               seq_len: int = 128, batch: int = 8, n_shards: int = 4,
               fail_at: Optional[int] = None, seed: int = 0,
               log_every: int = 10, lr: float = 1e-3,
               n_layers: Optional[int] = None,
               device: DeviceLike = "cuda") -> dict:
    """Train ``arch_name`` for ``steps`` steps on ``device``; with
    ``ckpt_dir``, checkpoint every ``ckpt_every`` steps into a
    predictor-planned store and, at step ``fail_at``, drop the state and
    restart from the latest checkpoint. ``n_layers`` cuts the depth.

    Returns the reference's report (losses, wall_s, final_step,
    loss_first, loss_last) and, with ``ckpt_dir``: ``state_bytes``, the
    ``plan`` and its seconds, and each checkpoint write (step, seconds
    including the copy to the host, bytes) and restore (step, seconds)."""
    dev = resolve_device(device)
    arch = cfgs.get(arch_name)
    if reduced:
        arch = arch.reduced()
    if n_layers is not None:
        arch = arch.replace(n_layers=n_layers)
    shape = ShapeConfig("driver", seq_len, batch, "train")
    print(f"[train] {arch.name}: {n_params(arch)/1e6:.2f}M params, "
          f"{arch.n_layers} layers, {steps} steps of {batch}x{seq_len} "
          f"on {dev}")

    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 2),
                                total_steps=steps)
    step_fn = make_train_step(arch, opt_cfg)

    def fresh_state() -> TrainState:
        params = init(torch.Generator(device=dev).manual_seed(seed), arch,
                      device=dev)
        return TrainState(params=params, opt=adamw.init(params))

    state = fresh_state()
    report: dict = {}

    manager = None
    if ckpt_dir:
        # the paper's predictor chooses the intermediate-storage config
        # for this job's checkpoint I/O profile before any byte is written
        state_bytes = sum(x.numel() * x.element_size()
                          for x in tree_leaves(state))
        t0 = time.perf_counter()
        plan = plan_checkpoint(state_bytes, n_hosts=n_shards + 1,
                               st=TPU_POD_STAGING, device=dev)
        report.update(state_bytes=state_bytes, plan=plan,
                      plan_s=time.perf_counter() - t0, checkpoints=[],
                      restores=[])
        print(f"[ckpt] predictor-planned config: stripe={plan.config.stripe_width} "
              f"chunk={plan.config.chunk_size >> 20}MB repl={plan.config.replication} "
              f"local={plan.local_placement} "
              f"(predicted write {plan.predicted_write_s*1e3:.1f}ms, "
              f"restore {plan.predicted_restore_s*1e3:.1f}ms)")
        store = IntermediateStore(os.path.join(ckpt_dir, "store"), plan.config)
        manager = CheckpointManager(root=ckpt_dir, store=store,
                                    n_writers=n_shards)

    def save(st: TrainState, at: int) -> dict:
        _synchronize(dev)
        t0 = time.perf_counter()
        m = manager.save(st, at)
        report["checkpoints"].append({
            "step": at, "seconds": time.perf_counter() - t0,
            "bytes": sum(e["size"] for e in m["entries"])})
        return m

    def restore(like: TrainState):
        t0 = time.perf_counter()
        st, at = manager.restore(like)
        _synchronize(dev)
        report["restores"].append({"step": at,
                                   "seconds": time.perf_counter() - t0})
        return st, at

    pipe = DataPipeline(arch, shape, n_shards, seed=seed,
                        pipe_cfg=PipelineConfig())
    losses = []
    start_step = 0
    if manager is not None and manager.latest_step() is not None:
        state, start_step = restore(state)
        print(f"[ckpt] restored at step {start_step}")

    t0 = time.monotonic()
    i = start_step
    while i < steps:
        batch_np = pipe.next_batch()
        batch_dev = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_np.items()}
        if fail_at is not None and i == fail_at:
            # fault injection: simulate a node crash; restart from the
            # latest manifest-complete checkpoint
            print(f"[fault] injected failure at step {i}; restarting")
            if manager is None:
                raise ValueError("fault injection needs checkpointing "
                                 "(ckpt_dir)")
            state = None                    # the crashed process's state
            state, i = restore(fresh_state())
            fail_at = None
            continue
        state, metrics = step_fn(state, batch_dev)
        losses.append(float(metrics["loss"]))
        if i % log_every == 0:
            print(f"  step {i:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}")
        i += 1
        if manager is not None and i % ckpt_every == 0:
            m = save(state, i)
            print(f"[ckpt] step {i}: wrote {len(m['entries'])} shards "
                  f"in {m['wall_s']*1e3:.0f}ms")
    _synchronize(dev)
    wall = time.monotonic() - t0
    if manager is not None:
        save(state, i)
    report.update(losses=losses, wall_s=wall, final_step=i,
                  loss_first=losses[0] if losses else None,
                  loss_last=losses[-1] if losses else None)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rep = train_loop(args.arch, steps=args.steps, reduced=args.reduced,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     seq_len=args.seq_len, batch=args.batch,
                     fail_at=args.fail_at, lr=args.lr, device=args.device)
    print(f"[train] done: loss {rep['loss_first']:.4f} -> {rep['loss_last']:.4f} "
          f"in {rep['wall_s']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
