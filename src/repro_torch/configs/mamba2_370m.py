"""Mamba2-370M [arXiv:2405.21060; unverified] — SSD, attention-free.

48L, d_model=1024, ssm_state=128, vocab=50280.  d_inner = 2*d_model,
head_dim=64 -> 32 SSD heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
