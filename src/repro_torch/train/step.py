"""Training and serving step functions — the counterpart of
`repro.train.step`.

The training step differentiates the plain paths only: the hand-written
kernels (flash_attention, ssd, moe_gmm) have no backward pass, in the
reference (where `jax.grad` cannot pass a `pallas_call` without a custom
VJP) as in the port, so `make_train_step(use_kernel=True)` raises.
The reference's `constrain_batch_dim` on the microbatches is a sharding
constraint that does nothing without a device mesh (ROADMAP Queue A
item 12), and the ``unroll`` switch has nothing to select here (the
layer loop is always a Python loop): both are left out.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..models import ArchConfig, DecodeState, decode_step, forward, loss_fn
from ..optim import adamw
from ..tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    use_kernel: bool = False, remat: bool = True,
                    accum: int = 1, counts=None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum`` > 1 splits the batch into microbatches along the leading
    axis, sums their f32 gradients and divides gradients and loss by
    ``accum``; the metrics are then {"loss"} and the optimiser's, as in
    the reference. The step updates ``state``'s tensors in place
    (`adamw.update`) and returns a state that shares them; metrics are
    0-d tensors on the parameters' device."""
    if use_kernel:
        raise ValueError(
            "make_train_step: use_kernel=True has no backward pass — the "
            "flash_attention, ssd and moe_gmm kernels are forward-only, in "
            "the reference and in the port; train with use_kernel=False")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(live, batch, cfg, remat=remat, counts=counts)
        grads = tree_unflatten(params,
                               torch.autograd.grad(loss, tree_leaves(live)))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if accum == 1:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            micros = [{k: v.reshape((accum, v.shape[0] // accum)
                                    + v.shape[1:])[i]
                       for k, v in batch.items()} for i in range(accum)]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            loss = 0.0
            for mb in micros:
                l, _m, g = grads_of(state.params, mb)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                loss = loss + l
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {"loss": loss}
        params, opt, opt_metrics = adamw.update(grads, state.opt,
                                                state.params, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return TrainState(params=params, opt=opt), metrics

    return train_step


def make_serve_step(cfg: ArchConfig, *, use_kernel: bool = False,
                    counts=None):
    """Returns serve_step(params, state, tokens) -> (next_tokens, logits, state).

    One decode step for a batch of sequences: greedy next token (the
    first index among equal logits, on the CPU and on the card).
    ``counts`` (a `kernels.counts.KernelCounts`) receives the kernel
    launches."""

    def serve_step(params, state: DecodeState, tokens: torch.Tensor):
        logits, new_state = decode_step(params, state, tokens, cfg,
                                        use_kernel=use_kernel, counts=counts)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, new_state

    return serve_step


def make_prefill_step(cfg: ArchConfig, *, use_kernel: bool = False,
                      counts=None):
    """Prefill forward over the full prompt (logits only; decode-cache
    population goes through repeated serve steps, as in the reference).
    No rematerialisation, as the reference's prefill step."""

    def prefill_step(params, tokens_or_embeds: torch.Tensor):
        return forward(params, tokens_or_embeds, cfg, use_kernel=use_kernel,
                       remat=False, counts=counts)

    return prefill_step
