"""DeepSeek-67B: 95L d8192 64H (GQA kv=8) ff 22016, llama-arch.

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base]
RMSNorm + SwiGLU + RoPE, no biases.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
)
