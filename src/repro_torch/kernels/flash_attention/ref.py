"""Plain PyTorch version of the flash-attention kernel: direct
materialised softmax(QK^T)V with causal and sliding-window masking, the
counterpart of the reference's `attention_ref`. The kernel is held
against it on the card; the wrapper takes it for CPU tensors."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [BH, Sq, hd]; k, v: [BKV, Skv, hd]; GQA by repetition (q row
    ``b`` reads kv row ``b // G``)."""
    BH, Sq, hd = q.shape
    BKV, Skv, _ = k.shape
    G = BH // BKV
    f32 = torch.float32
    k = k.repeat_interleave(G, dim=0)
    v = v.repeat_interleave(G, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.to(f32), k.to(f32)) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, torch.tensor(NEG_INF, dtype=f32,
                                                device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.to(f32)).to(q.dtype)
