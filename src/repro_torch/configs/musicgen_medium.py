"""musicgen-medium [audio]: 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284].
Frontend stub: input_specs() provides precomputed frame embeddings."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab=2048, frontend="audio",
)
