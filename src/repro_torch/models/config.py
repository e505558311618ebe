"""Architecture configuration — one dataclass covers all assigned families
(dense GQA / MoE / SSM / hybrid / audio / vlm backbones).

Data only, field for field the reference's `repro.models.config` (the
port keeps its own copy rather than importing it)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention (0 heads => attention-free)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    window: int = 0                # sliding-window attention (0 = full causal)
    # ffn
    d_ff: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0             # SSD value heads (d_inner / head_dim)
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (zamba2-style): one SHARED attention block applied every k layers
    shared_attn_every: int = 0
    # frontend stub: 'none' | 'audio' | 'vlm' — backbone consumes precomputed
    # frame/patch embeddings through input_specs() (assignment note)
    frontend: str = "none"
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and not self.n_kv_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.family == "ssm" or (self.family == "hybrid" and self.ssm_state):
            d_inner = self.ssm_expand * self.d_model
            if not self.ssm_heads:
                object.__setattr__(self, "ssm_heads", max(d_inner // 64, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def uses_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM state or bounded window)"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True                      # SSM state + (windowed) shared attn
        return self.window > 0               # SWA bounds the KV cache

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d + d                     # embed + final norm
        if not self.tie_embeddings:
            total += v * d
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            hd = self.head_dim
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d      # q, k, v, o
            if self.qkv_bias:
                per_layer += (self.n_heads + 2 * self.n_kv_heads) * hd
            per_layer += 2 * d               # two norms
            if self.uses_moe:
                per_layer += d * self.n_experts                    # router
                per_layer += self.n_experts * 3 * d * self.d_ff    # expert FFNs
            else:
                per_layer += 3 * d * self.d_ff
        elif self.family == "ssm":
            per_layer = self._ssm_layer_params()
        elif self.family == "hybrid":
            per_layer = self._ssm_layer_params() + 2 * d
        total += self.n_layers * per_layer
        if self.family == "hybrid" and self.shared_attn_every:
            hd = self.head_dim
            total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d
        return total

    def _ssm_layer_params(self) -> int:
        d, di, ns, nh = self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        # in_proj produces [z, x, B, C, dt]: 2*di + 2*ns + nh
        return d * (2 * di + 2 * ns + nh) + di * d + di + 2 * d + nh * 2

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts)."""
        if not self.uses_moe:
            return self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - inactive

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(n_layers=2, d_model=64, vocab=256, d_ff=128 if self.d_ff else 0)
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=max(1, 4 * self.n_kv_heads // max(self.n_heads, 1)),
                      head_dim=16)
        if self.uses_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_heads=4, ssm_chunk=32)
        if self.shared_attn_every:
            kw.update(shared_attn_every=2)
        if self.window:
            kw.update(window=32)
        return self.replace(name=self.name + "-smoke", **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
