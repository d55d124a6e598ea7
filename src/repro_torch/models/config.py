"""Unified model configuration covering every assigned architecture family.

A copy of ``repro.models.config`` (data: the port imports nothing of
``repro``).  One dataclass; family-specific fields are ignored by other
families.  Exact full-size instances live in ``repro_torch.configs.<arch>``;
smoke tests use ``reduced()`` copies.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family = "dense"

    # transformer trunk
    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 8
    num_kv_heads: int = 8
    d_ff: int = 4096
    vocab_size: int = 32000
    head_dim: Optional[int] = None          # default d_model // num_heads
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131072

    # attention impl
    attn_block_q: int = 512                  # flash q-block
    attn_block_kv: int = 1024                # flash kv-block

    # MoE
    moe_num_experts: int = 0                 # 0 = dense FFN
    moe_top_k: int = 2
    moe_d_ff: int = 0                        # per-expert hidden (0 -> d_ff)
    moe_shared_experts: int = 0              # deepseek-style shared experts
    moe_capacity_factor: float = 1.25
    moe_every: int = 1                       # MoE FFN every k-th layer

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2 / hybrid)
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_every: int = 0                      # hybrid: 1 attn layer per period
    attn_index: int = 3                      # position of attn layer in period

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500                  # stub frame-embedding length

    # vlm
    num_patches: int = 0                     # stub patch-embedding count

    # numerics
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    logit_softcap: float = 0.0
    # sequence-chunked cross-entropy: never materialize (B, S, V) logits;
    # chunk of 0 disables (tiny smoke configs)
    loss_chunk: int = 512

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 2 * max(1, self.attn_every or 1)),
            d_model=256,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads // max(1, self.num_heads // 4))),
            d_ff=512,
            vocab_size=512,
            head_dim=64 if not self.use_mla else None,
            max_seq_len=512,
            attn_block_q=64,
            attn_block_kv=64,
            moe_num_experts=min(self.moe_num_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=128 if self.moe_num_experts else 0,
            moe_shared_experts=min(self.moe_shared_experts, 1),
            kv_lora_rank=64,
            q_lora_rank=96,
            qk_nope_head_dim=32,
            qk_rope_head_dim=16,
            v_head_dim=32,
            ssm_state=32,
            ssm_head_dim=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            num_patches=min(self.num_patches, 16),
            remat=False,
        )
        # keep hybrid period structure intact but small
        if self.attn_every:
            small["num_layers"] = 2 * self.attn_every
        small.update(overrides)
        return dataclasses.replace(self, **small)
