"""StarCoder2-15B: 40L d6144 48H (GQA kv=4) ff 24576, GELU MLP with bias,
sliding window 4096, RoPE, LayerNorm.

[arXiv:2402.19173; hf:bigcode/starcoder2-15b]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    window=4096,
    norm="layernorm",
    mlp="gelu_mlp",
    use_bias=True,
    rope_theta=100000.0,
    source="arXiv:2402.19173; hf:bigcode/starcoder2-15b",
)
