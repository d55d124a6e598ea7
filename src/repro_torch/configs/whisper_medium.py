"""Whisper-medium [arXiv:2212.04356; unverified] — encoder-decoder.

24L decoder + 24L encoder, d_model=1024, 16 heads (MHA), d_ff=4096,
vocab=51865.  Conv audio frontend is a STUB: input_specs() provides
precomputed frame embeddings (1500 frames).  Decode shapes use the
assigned 32k decoder-side lengths (exceeds Whisper's 448-token reality;
noted in DESIGN.md §6, still lowered).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=51865, head_dim=64,
    encoder_seq=1500,
)
