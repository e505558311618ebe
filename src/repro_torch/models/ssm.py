"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060], in
PyTorch — the counterpart of `repro.models.ssm`.

`ssd_chunked` is the plain chunked form the model takes with
``use_kernel=False``: within-chunk terms are attention-like products
with a decay mask; across chunks a small state [H, N, P] is carried by
a loop. With ``use_kernel=True`` prefill goes through the hand-written
CUDA kernel of `kernels.ssd`. Decode (`ssd_step`) runs no kernel, as in
the reference.

Notation (single SSM head): h_t = a_t * h_{t-1} + dt_t * B_t x_t,
y_t = C_t^T h_t, with a_t = exp(-dt_t * A). Heads share B_t/C_t
(n_groups = 1, as in Mamba2 defaults).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..env import DeviceLike, resolve_device
from .config import ArchConfig
from .layers import ParamDef, causal_depthwise_conv, rms_norm

CONV_K = 4


def ssm_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * N + H), ("embed", "ssm_in")),
        "conv_w": ParamDef((di + 2 * N, CONV_K), ("ssm_conv", None),
                           scale=0.5),
        "a_log": ParamDef((H,), ("ssm_heads",), init="ssm_alog"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="ssm_dt"),
        "d_skip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def ssm_block_defs(cfg: ArchConfig) -> Dict:
    return {"ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
            "ssm": ssm_defs(cfg)}


class SSMState(NamedTuple):
    h: torch.Tensor       # [B, H, N, P] inter-chunk state
    conv: torch.Tensor    # [B, CONV_K-1, di + 2N] conv tail


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: [B, S, H, P]; dt: [B, S, H]; a: [H] (positive decay
    rates); b, c: [B, S, N] shared across heads. Returns (y, h_final).

    One loop over chunks carries the [B, H, N, P] state and computes the
    within-chunk attention-like term; peak memory is the one-chunk decay
    tensor [B, L, L, H]. S % chunk == 0.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"ssd_chunked needs S % chunk == 0, got {(S, L)}")
    nc = S // L
    f32 = torch.float32

    xb = x.reshape(B, nc, L, H, P).to(f32)
    dtb = dt.reshape(B, nc, L, H).to(f32)
    bb = b.reshape(B, nc, L, N).to(f32)
    cb = c.reshape(B, nc, L, N).to(f32)
    a_f = a.to(f32)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    h = (torch.zeros((B, H, N, P), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    neg_inf = torch.tensor(-torch.inf, dtype=f32, device=x.device)

    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xb[:, ci], dtb[:, ci], bb[:, ci], cb[:, ci]
        la = -dtc * a_f[None, None]                           # [B,L,H], <= 0
        cum = torch.cumsum(la, dim=1)                         # [B,L,H]
        seg = cum[:, -1]                                      # [B,H]
        xdt = xc * dtc[..., None]
        # within-chunk: y[t] = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
        # (mask the EXPONENT: future entries have cum_t - cum_s > 0 and
        # would overflow exp)
        delta = cum[:, :, None] - cum[:, None, :]             # [B,Lt,Ls,H]
        delta = torch.where(causal[None, ..., None], delta, neg_inf)
        decay = torch.exp(delta)
        scores = torch.einsum("btn,bsn->bts", cc, bc)
        w = scores[..., None] * decay
        y = torch.einsum("btsh,bshp->bthp", w, xdt)
        # carried state contribution: C_t exp(cum_t) h_prev
        y = y + torch.einsum("btn,bth,bhnp->bthp", cc, torch.exp(cum), h)
        # state update: h <- h * exp(seg) + sum_s exp(seg - cum_s) B_s xdt_s
        to_end = torch.exp(seg[:, None] - cum)                # [B,L,H]
        s_c = torch.einsum("bsn,bsh,bshp->bhnp", bc, to_end, xdt)
        h = h * torch.exp(seg)[..., None, None] + s_c
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    return y.to(x.dtype), h


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x: [B,H,P]; dt: [B,H]; b,c: [B,N]; h: [B,H,N,P]."""
    f32 = torch.float32
    decay = torch.exp(-dt.to(f32) * a.to(f32)[None])             # [B,H]
    upd = torch.einsum("bn,bhp->bhnp", b.to(f32),
                       x.to(f32) * dt.to(f32)[..., None])
    h = h * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c.to(f32), h)
    return y.to(x.dtype), h


def ssm_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
              state: Optional[SSMState] = None, use_kernel: bool = False,
              counts=None) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Full Mamba2 mixer. x: [B, S, d]. Decode when state is not None (S==1)."""
    B, S, d = x.shape
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xin, bc, dt_raw = torch.split(zxbcdt, [di, di, 2 * N, H], dim=-1)

    conv_in = torch.cat([xin, bc], dim=-1)                        # [B,S,di+2N]
    if state is None:
        conv_out, _ = causal_depthwise_conv(conv_in, p["conv_w"])
        new_conv = None
    else:
        conv_out, new_conv = causal_depthwise_conv(conv_in, p["conv_w"],
                                                   state=state.conv)
    xs, b, c = torch.split(conv_out, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())       # [B,S,H]
    a = torch.exp(p["a_log"].float())                             # [H] positive
    xh = xs.reshape(B, S, H, P)

    if state is None:
        if use_kernel:
            from ..kernels.ssd import ops as ssd_ops
            y, _h = ssd_ops.ssd(xh.contiguous(), dt, a, b.contiguous(),
                                c.contiguous(), chunk=cfg.ssm_chunk,
                                use_kernel=True, counts=counts)
        else:
            y, _h = ssd_chunked(xh, dt, a, b, c, chunk=cfg.ssm_chunk)
        new_state = None
    else:
        y1, h = ssd_step(xh[:, 0], dt[:, 0], a, b[:, 0], c[:, 0], state.h)
        y = y1[:, None]
        new_state = SSMState(h=h, conv=new_conv)

    y = y + xh * p["d_skip"].float()[None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype), new_state


def init_ssm_state(cfg: ArchConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = "cuda") -> SSMState:
    dev = resolve_device(device)
    P = cfg.d_inner // cfg.ssm_heads
    return SSMState(
        h=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state, P),
                      dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, CONV_K - 1, cfg.d_inner + 2 * cfg.ssm_state),
                         dtype=dtype, device=dev))


def ssm_block_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                    state: Optional[SSMState] = None, use_kernel: bool = False,
                    counts=None):
    h, new_state = ssm_apply(p["ssm"], rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                             state=state, use_kernel=use_kernel, counts=counts)
    return x + h, new_state
