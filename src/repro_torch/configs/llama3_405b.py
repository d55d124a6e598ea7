"""Llama-3.1-405B [arXiv:2407.21783; unverified].

126L, d_model=16384, 128 heads (GQA kv=8), d_ff=53248, vocab=128256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, num_heads=128, num_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
)
