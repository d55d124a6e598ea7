"""Jamba-1.5-Large (398B) [arXiv:2403.19887; hf] — hybrid Mamba+attn 1:7, MoE.

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536,
MoE 16 experts top-2.  Period structure: 1 attention layer per 8 layers
(attn at period index 3 per the Jamba paper figure), MoE every 2nd layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    moe_num_experts=16, moe_top_k=2, moe_d_ff=24576, moe_every=2,
    attn_every=8, attn_index=3,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
