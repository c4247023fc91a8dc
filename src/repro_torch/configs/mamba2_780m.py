"""Mamba2-780M: 48L d1536 attention-free SSD, state=128, vocab 50280
(padded to 50432 for sharding; padded logits masked in loss).

[arXiv:2405.21060; unverified]  d_inner = 2*1536 = 3072, head_dim 64 ⇒ 48 SSM
heads; conv kernel 4; SSD (state-space duality) chunked path is the
production implementation and the Pallas kernel's target.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,               # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_groups=1,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
