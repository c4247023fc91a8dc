"""Hymba-1.5B: 32L d1600 25H (GQA kv=5) ff 5504, parallel attn+mamba heads,
ssm_state=16.

[arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base]  Hybrid-head: every block runs
attention heads and SSM heads in parallel on the same input and fuses
(averaged here; the paper's learned per-head β folded into projection
weights).  SWA 2048 on the attention heads (the paper's few global-attn
layers folded in — noted in DESIGN.md).  Meta-tokens folded into seq.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    window=2048,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=128,        # d_inner 3200 / 25 heads = 128 (heads tied to attn heads)
    ssm_conv=4,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    source="arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base",
)
