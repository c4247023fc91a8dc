"""OLMo-1B: 16L d2048 16H (kv=16) ff 8192, non-parametric LayerNorm.

[arXiv:2402.00838; hf:allenai/OLMo-1B]  SwiGLU-free: OLMo uses SwiGLU with
d_ff=8192 (the "mlp hidden size"); non-parametric LN per the paper.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_np",
    mlp="swiglu",
    rope_theta=10000.0,
    source="arXiv:2402.00838; hf:allenai/OLMo-1B",
)
