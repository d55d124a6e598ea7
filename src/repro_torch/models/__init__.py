"""The model families (dense, MoE, MLA, VLM, the mamba2 SSM, the jamba
hybrid, the whisper encoder-decoder) in eager PyTorch."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (chunked_cross_entropy, cross_entropy,
                                      decode_step, init_cache, init_params,
                                      prefill, train_forward)

__all__ = ["ModelConfig", "chunked_cross_entropy", "cross_entropy",
           "decode_step", "init_cache", "init_params", "prefill",
           "train_forward"]
