"""Plain PyTorch version of the SSD kernel: the literal sequential
recurrence h_t = exp(-dt_t a) h_{t-1} + dt_t b_t x_t ; y_t = c_t^T h_t,
the counterpart of the reference's `ssd_ref`. The kernel is held against
it on the card; the wrapper takes it for CPU tensors."""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor):
    """x: [BH, S, P]; dt: [BH, S]; a: [BH]; b, c: [BH, S, N].
    Returns (y [BH, S, P] in x's dtype, h_final [BH, N, P] f32)."""
    BH, S, P = x.shape
    N = b.shape[-1]
    f32 = torch.float32
    xf, dtf, af = x.to(f32), dt.to(f32), a.to(f32)
    bf, cf = b.to(f32), c.to(f32)
    h = torch.zeros((BH, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dtf[:, t, None, None]
        h = h * torch.exp(-dtf[:, t] * af)[:, None, None] \
            + dtt * bf[:, t, :, None] * xf[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], h))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), h
