"""Command-R 35B: 40L d8192 64H (GQA kv=8) ff 22528, vocab 256000, no-bias.

[hf:CohereForAI/c4ai-command-r-v01; unverified]  LayerNorm (Cohere-style),
full attention.  The 256k vocab exercises the vocab-sharded embedding +
chunked-CE path.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    mlp="swiglu",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=10000.0,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
