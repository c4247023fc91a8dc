"""Llama-3.2-Vision-11B backbone: 40L d4096 32H (GQA kv=8) ff 14336,
vocab 128256, cross-attn image layers every 5th layer.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  The vision tower is a STUB
per the assignment: ``input_specs()`` provides 1601 precomputed patch
embeddings of width d_model; 8 cross-attention blocks attend to them.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    num_modal_tokens=1601,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
