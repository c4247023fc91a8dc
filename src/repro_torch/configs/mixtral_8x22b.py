"""Mixtral-8x22B: 56L d6144 48H (kv=8) MoE 8 experts top-2, expert ff 16384, SWA.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1]  Sliding window 4096
(mistral-family default) ⇒ sub-quadratic decode cache; long_500k cell runs.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=16384,
    window=4096,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=1000000.0,
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
)
