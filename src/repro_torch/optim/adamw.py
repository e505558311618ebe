"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule, in PyTorch: the counterpart of
`repro.optim.adamw`, in the same functional form (`init`, `schedule`,
`global_norm`, `update`) and the same expression order, so one step
rounds as the reference's does.

Not `torch.optim.AdamW`: its decay and epsilon placement round
differently, and its schedule is not the reference's.

`update` works in place: the moments and the parameters are written
into their own tensors (which saves a copy of every parameter, 10.5 GB
in f32 for granite-3-2b), and the returned tree and state share them.
``count`` is a 0-d int32 tensor on the parameters' device, and the
learning rate, the clip scale and the bias corrections are 0-d f32
tensors there, so a step never waits for the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: Any                # first moment, same tree as params, f32
    nu: Any                # second moment
    count: torch.Tensor    # [] int32


def init(params) -> OptState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params,
           cfg: AdamWConfig) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}). ``params``,
    ``state.mu`` and ``state.nu`` are updated in place and returned;
    ``grads`` are read only."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)

    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        pf = p.to(torch.float32)
        step.add_(cfg.weight_decay * pf)
        p.copy_(pf - lr * step)
    return params, OptState(mu=state.mu, nu=state.nu, count=count), \
        {"grad_norm": gnorm, "lr": lr}
