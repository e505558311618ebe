"""Serving step functions — the counterpart of `repro.train.step` for
the serving path (`make_train_step` belongs to the training slice and is
not ported yet)."""
from __future__ import annotations

import torch

from ..models import ArchConfig, DecodeState, decode_step, forward


def make_serve_step(cfg: ArchConfig, *, use_kernel: bool = False):
    """Returns serve_step(params, state, tokens) -> (next_tokens, logits, state).

    One decode step for a batch of sequences: greedy next token (the
    first index among equal logits, on the CPU and on the card)."""

    def serve_step(params, state: DecodeState, tokens: torch.Tensor):
        logits, new_state = decode_step(params, state, tokens, cfg,
                                        use_kernel=use_kernel)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, new_state

    return serve_step


def make_prefill_step(cfg: ArchConfig, *, use_kernel: bool = False):
    """Prefill forward over the full prompt (logits only; decode-cache
    population goes through repeated serve steps, as in the reference)."""

    def prefill_step(params, tokens_or_embeds: torch.Tensor):
        return forward(params, tokens_or_embeds, cfg, use_kernel=use_kernel)

    return prefill_step
