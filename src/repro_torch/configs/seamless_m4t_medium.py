"""SeamlessM4T-medium backbone: enc-dec, 12L per stack, d1024 16H ff 4096,
vocab 256206 (padded to 256256 for sharding; padded logits masked in loss).

[arXiv:2308.11596; hf:facebook/seamless-m4t-medium]  The modality frontend
(speech encoder frontend) is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings of width d_model.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,             # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    mlp="gelu_mlp",
    use_bias=True,
    rope_theta=10000.0,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
)
