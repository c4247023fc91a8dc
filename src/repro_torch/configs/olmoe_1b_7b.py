"""OLMoE-1B-7B: 16L d2048 16H (kv=16) MoE 64 experts top-8, per-expert ff 1024.

[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924]  QK-norm enabled per the paper.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,              # per the assignment: MoE per-expert hidden dim
    vocab_size=50304,
    moe_num_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    qk_norm=True,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)
