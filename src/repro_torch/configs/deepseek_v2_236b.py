"""DeepSeek-V2 (236B) [arXiv:2405.04434; hf] — MLA + fine-grained MoE.

60L, d_model=5120, 128 heads, MLA kv_lora_rank=512 (q_lora 1536,
qk_nope 128 + qk_rope 64, v_head 128), MoE: 2 shared + 160 routed top-6,
per-expert d_ff=1536, vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe_num_experts=160, moe_top_k=6, moe_d_ff=1536, moe_shared_experts=2,
)
