"""Plain PyTorch version of the grouped expert FFN kernel, the
counterpart of the reference's `expert_ffn_ref`: every product in f32,
the output cast to x's dtype. The kernel is held against it on the card;
the wrapper takes it for CPU tensors. Given f64 inputs it computes in
f64: at full width (sums of 6144 and 16384 terms) an f32 evaluation by
cuBLAS strays ~2e-5 from the exact result, above `_tol`'s 1e-5, so the
f32 kernel is held against this function evaluated in f64."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def expert_ffn_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor) -> torch.Tensor:
    """x: [GE, C, d]; wg, wu: [E, d, f]; wd: [E, f, d] -> [GE, C, d].
    Group ge uses expert ge % E."""
    GE, C, d = x.shape
    E = wg.shape[0]
    G = GE // E
    ct = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(G, E, C, d).to(ct)
    g = torch.einsum("gecd,edf->gecf", xg, wg.to(ct))
    u = torch.einsum("gecd,edf->gecf", xg, wu.to(ct))
    out = torch.einsum("gecf,efd->gecd", F.silu(g) * u, wd.to(ct))
    return out.reshape(GE, C, d).to(x.dtype)
