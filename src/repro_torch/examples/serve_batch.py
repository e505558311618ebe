"""Batched serving example: serve a batch of prompts on a reduced model
with the KV-cache serve step (teacher-forced over the prompt, then
greedy) — and let the paper's predictor size the intermediate-storage
layer that would hold the model shards for multi-replica serving (a
sweep through the sweep-scan kernel on ``--device``).

    python -m repro_torch.examples.serve_batch [--device cuda|cpu]

Reduced granite-3-2b with seeded random weights, as the reference script
serves it; the full-width serving paths are driven by chip_smoke.py.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfgs
from repro_torch.checkpoint import plan_checkpoint
from repro_torch.core import TPU_POD_STAGING, InlineBackend, SweepSession
from repro_torch.env import resolve_device
from repro_torch.models import init, init_decode_state, n_params
from repro_torch.train import make_serve_step
from repro_torch.tree import tree_leaves

ARCH = "granite-3-2b"
B, PROMPT_LEN, GEN_LEN = 8, 48, 32


def serve(arch, params, prompts: torch.Tensor, gen_len: int, dev):
    """Teacher-forced serve steps over ``prompts`` [B, P], then
    ``gen_len`` greedy ones, as the reference script runs them. Returns
    (tokens [B, gen_len + 1]: the prompt's last and the generated,
    the decode state, seconds)."""
    Bn, prompt_len = prompts.shape
    state = init_decode_state(arch, Bn, prompt_len + gen_len, device=dev)
    step = make_serve_step(arch)
    t0 = time.monotonic()
    for t in range(prompt_len - 1):
        _next, _logits, state = step(params, state, prompts[:, t])
    toks = [prompts[:, -1]]
    for _ in range(gen_len):
        nxt, _logits, state = step(params, state, toks[-1])
        toks.append(nxt)
    out = torch.stack([t.to(torch.int32) for t in toks], dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, state, time.monotonic() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the planner's sweep run "
                         "(cuda, or cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    arch = cfgs.get(ARCH).reduced()
    params = init(torch.Generator(device=dev).manual_seed(0), arch,
                  device=dev)
    print(f"serving {arch.name} ({n_params(arch)/1e6:.1f}M params), "
          f"batch={B}, prompt={PROMPT_LEN}, generate={GEN_LEN}")

    # deployment planning: how should the model-shard store be configured
    # so N serving replicas can pull weights fast (broadcast pattern)?
    bytes_total = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    with SweepSession(InlineBackend(), device=dev) as sess:
        plan = plan_checkpoint(bytes_total * 16, n_hosts=17,
                               st=TPU_POD_STAGING, min_replication=2,
                               session=sess)
        plan_stats = (sess.device, sess.stats.kernel_launches,
                      sess.stats.kernel_fallbacks)
    print(f"[advisor] shard store: stripe={plan.config.stripe_width} "
          f"chunk={plan.config.chunk_size>>20}MB repl={plan.config.replication} "
          f"-> predicted replica pull {plan.predicted_restore_s*1e3:.0f}ms")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, arch.vocab, (B, PROMPT_LEN)).astype(np.int64)).to(dev)
    out, state, dt = serve(arch, params, prompts, GEN_LEN, dev)
    steps = PROMPT_LEN - 1 + GEN_LEN
    print(f"generated {GEN_LEN} tokens/seq; {steps} serve steps in {dt:.2f}s "
          f"({B*steps/dt:.0f} tok/s on {dev})")
    print("sample continuation ids:", out[0, :12].cpu().numpy())
    print(f"[device: {plan_stats[0]}; sweep_scan kernel (the plan): "
          f"{plan_stats[1]} launches, {plan_stats[2]} fallbacks to the "
          f"plain loop]")
    assert bool((out >= 0).all()) and bool((out < arch.vocab).all())
    assert int(state.pos) == steps
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
