"""Model configuration covering all assigned architecture families.

One frozen dataclass parameterizes: dense / MoE / SSM (Mamba-2 SSD) / hybrid
(parallel attn+SSM heads) / encoder-decoder / VLM (periodic cross-attention)
transformers.  Every arch in ``repro_torch.configs`` instantiates this (a copy of the
reference package's config, so the port imports nothing of it).
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int                        # dense-MLP hidden (0 if no MLP, e.g. mamba2)
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // n_heads

    # -- MoE ------------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    moe_capacity_factor: float = 1.25

    # -- attention --------------------------------------------------------------
    window: int = 0                  # sliding-window size (0 = full attention)
    rope_theta: float = 10000.0
    qk_norm: bool = False

    # -- SSM (Mamba-2 / SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # -- structure ----------------------------------------------------------------
    enc_layers: int = 0              # >0 → encoder-decoder (n_layers = decoder)
    cross_attn_period: int = 0       # vlm: one cross-attn layer every k layers
    num_modal_tokens: int = 0        # stubbed frontend sequence length
    norm: str = "rmsnorm"            # rmsnorm | layernorm | layernorm_np
    mlp: str = "swiglu"              # swiglu | gelu_mlp
    use_bias: bool = False
    tie_embeddings: bool = False

    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"          # activation/param compute dtype
    source: str = ""                 # provenance citation

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        if self.n_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding shards over
        any mesh axis ≤256 (MaxText-style padding; padded logits are masked
        in the loss).  Exact vocab stays in ``vocab_size``."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model if self.ssm_state else 0

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with O(1)-in-seq cache (SSM state or window)?"""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def cache_len(self, seq_len: int) -> int:
        """KV-cache length needed to decode with ``seq_len`` tokens of context."""
        return min(seq_len, self.window) if self.window else seq_len

    # ------------------------------------------------------- parameter counting
    def param_count(self) -> int:
        """Exact parameter count of the model as constructed in models/model.py."""
        from .layers import spec_leaves
        from .model import param_specs  # local import to avoid cycle

        return sum(int(math.prod(p.shape)) for p in spec_leaves(param_specs(self)))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        from .layers import spec_leaves
        from .model import param_specs

        expert, shared = 0, 0
        for leaf in spec_leaves(param_specs(self)):
            n = int(math.prod(leaf.shape))
            if "experts" in leaf.logical:
                expert += n
            else:
                shared += n
        if not self.is_moe:
            return expert + shared
        return shared + expert * self.moe_top_k // self.moe_num_experts

    # ------------------------------------------------------------------ reduced
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (shapes only)."""
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=max(2, min(4, self.n_heads)) if self.n_heads else 0,
            n_kv_heads=min(2, self.n_kv_heads) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            moe_num_experts=4 if self.is_moe else 0,
            moe_top_k=min(2, self.moe_top_k) if self.is_moe else 0,
            moe_d_ff=64 if self.is_moe else 0,
            window=16 if self.window else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            enc_layers=2 if self.enc_layers else 0,
            cross_attn_period=2 if self.cross_attn_period else 0,
            num_modal_tokens=8 if self.num_modal_tokens else 0,
            dtype="float32",
        )

    def validate(self) -> "ModelConfig":
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"), self.family
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA requires heads % kv_heads == 0"
        if self.is_moe:
            assert 0 < self.moe_top_k <= self.moe_num_experts
        if self.family == "ssm":
            assert self.ssm_state > 0 and self.ssm_d_inner % self.ssm_head_dim == 0
        if self.family == "hybrid":
            assert self.ssm_state > 0 and self.n_heads > 0
        if self.family == "encdec":
            assert self.enc_layers > 0
        if self.family == "vlm":
            assert self.cross_attn_period > 0 and self.n_layers % self.cross_attn_period == 0
        return self
