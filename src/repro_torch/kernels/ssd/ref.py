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


# ---------------------------------------------------------------------------
# The kernel's three stages, transcribed in plain PyTorch with the kernel's
# scratch layouts (model layout in, as `ops.ssd` takes it). Nothing on a
# serving path calls these: the tests hold them against the reference, so
# that the decomposition the CUDA kernel implements is checked on the CPU.
# With ``bf16_points=True`` each operand is rounded to bf16 where the bf16
# kernel rounds it (see `csrc/ssd.cu`'s head note).

def _round_bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).float() if on else t


def _split_bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    """What a bf16 pair (hi, and the bf16 of the remainder) carries."""
    if not on:
        return t
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def chunk_cum(dt: torch.Tensor, a: torch.Tensor, L: int) -> torch.Tensor:
    """cum [B, H, nc, L] in f64: the prefix sums over each chunk of the
    per-step log decays -dt a (f32 products, summed in f64)."""
    B, S, H = dt.shape
    la = (-dt.float() * a.float()).double()
    return la.reshape(B, S // L, L, H).permute(0, 3, 1, 2).cumsum(-1)


def _xdt(x: torch.Tensor, dt: torch.Tensor, L: int) -> torch.Tensor:
    """x dt in f32 as [B, H, nc, L, P]."""
    B, S, H, P = x.shape
    xdt = x.float() * dt.float()[..., None]
    return xdt.reshape(B, S // L, L, H, P).permute(0, 3, 1, 2, 4)


def chunk_state_ref(x, dt, a, b, *, chunk: int, bf16_points: bool = False):
    """K3a: s [B, H, nc, N, P] f32 with s_c = sum_s b_s (exp(seg - cum_s)
    xdt_s)^T, and eseg [B, H, nc] = exp(seg) in f32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = min(chunk, S)
    cum = chunk_cum(dt, a, L)
    seg = cum[..., -1:]
    w = torch.exp((seg - cum).float())                     # [B, H, nc, L]
    xw = _round_bf16(_xdt(x, dt, L) * w[..., None], bf16_points)
    bb = b.float().reshape(B, S // L, L, N)
    s = torch.einsum("bcln,bhclp->bhcnp", bb, xw)
    return s.contiguous(), torch.exp(seg[..., 0].float())


def state_pass_ref(s: torch.Tensor, eseg: torch.Tensor) -> torch.Tensor:
    """K3b: walks the chunks in order, writes h_in[c] in place over s_c
    (h_in[0] = 0, h_in[c + 1] = exp(seg_c) h_in[c] + s_c) and returns
    h_final [B, H, N, P]."""
    h = torch.zeros_like(s[:, :, 0])
    for ci in range(s.shape[2]):
        v = s[:, :, ci].clone()
        s[:, :, ci] = h
        h = eseg[:, :, ci, None, None] * h + v
    return h


def chunk_scan_ref(x, dt, a, b, c, h_in, *, chunk: int,
                   bf16_points: bool = False) -> torch.Tensor:
    """K3c: y [B, S, H, P] in x's dtype from the chunks' carried states
    h_in [B, H, nc, N, P]: y_t = sum_{s<=t} (c_t . b_s) exp(cum_t - cum_s)
    dt_s x_s + exp(cum_t) (c_t . h_in), the mask on the exponent; dt
    rides on the weights W, which the bf16 kernel carries as a bf16 pair
    against x as it is."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = min(chunk, S)
    nc = S // L
    cum = chunk_cum(dt, a, L)                               # [B, H, nc, L]
    xs = x.float().reshape(B, nc, L, H, P).permute(0, 3, 1, 2, 4)
    dts = dt.float().reshape(B, nc, L, H).permute(0, 3, 1, 2)   # [B, H, nc, L]
    bb = b.float().reshape(B, nc, L, N)
    cc = c.float().reshape(B, nc, L, N)
    scores = torch.einsum("bctn,bcsn->bcts", cc, bb)       # [B, nc, L, L]
    delta = cum[..., :, None] - cum[..., None, :]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal, delta, -torch.inf)).float()
    w = _split_bf16(scores[:, None] * decay * dts[..., None, :], bf16_points)
    y = torch.einsum("bhcts,bhcsp->bhctp", w, xs)
    carried = torch.einsum("bctn,bhcnp->bhctp", cc,
                           _round_bf16(h_in.float(), bf16_points))
    y = y + torch.exp(cum).float()[..., None] * carried
    return y.permute(0, 2, 3, 1, 4).reshape(B, S, H, P).to(x.dtype)


def ssd_staged_ref(x, dt, a, b, c, *, chunk: int, bf16_points: bool = False):
    """The three stages in order, as one launch of the kernel runs them:
    (y [B, S, H, P] in x's dtype, h_final [B, H, N, P] f32)."""
    s, eseg = chunk_state_ref(x, dt, a, b, chunk=chunk,
                              bf16_points=bf16_points)
    h = state_pass_ref(s, eseg)
    y = chunk_scan_ref(x, dt, a, b, c, s, chunk=chunk, bf16_points=bf16_points)
    return y, h
