"""InternVL2-1B [arXiv:2404.16821; hf] — VLM backbone.

LM trunk (Qwen2-0.5B-like): 24L, d_model=896, 14 heads (GQA kv=2),
d_ff=4864, vocab=151655.  InternViT frontend is a STUB: input_specs()
provides precomputed patch embeddings (assignment rule).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    num_patches=256,
)
