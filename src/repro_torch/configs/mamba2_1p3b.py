"""mamba2-1.3b [ssm]: 48L d_model=2048 attention-free, vocab 50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
    vocab=50280, d_ff=0, ssm_state=128, ssm_expand=2, ssm_heads=64,
    ssm_chunk=256,
)
