"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6]. Frontend stub:
input_specs() provides precomputed patch embeddings."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    frontend="vlm",
)
