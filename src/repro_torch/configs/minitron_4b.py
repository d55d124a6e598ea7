"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679; hf].

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=9216, vocab_size=256000, head_dim=128,
)
