"""The dense decoder family in eager PyTorch."""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      prefill)

__all__ = ["ModelConfig", "decode_step", "init_cache", "init_params",
           "prefill"]
