"""zamba2-2.7b [hybrid]: 54L d_model=2560 Mamba2 backbone + ONE shared
attention block (32H kv=32, d_ff=10240) applied every 6 layers,
vocab=32000, ssm_state=64 [arXiv:2411.15242]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_heads=80, shared_attn_every=6,
)
