"""Full-size model configurations (data; copies of ``repro.configs``).

``get_config(arch)`` returns the full-size ``ModelConfig`` of an
architecture: the decoder-only families (dense GQA, MoE, MLA, the VLM
backbone), the SSM (mamba2), the hybrid (jamba) and the encoder-decoder
(whisper).  Any other name raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

PORTED = ("granite_3_2b", "minitron_4b", "phi3_medium_14b", "llama3_405b",
          "olmoe_1b_7b", "deepseek_v2_236b", "internvl2_1b", "mamba2_370m",
          "jamba_1_5_large_398b", "whisper_medium")


def get_config(arch: str) -> ModelConfig:
    """``arch`` as ``olmoe-1b-7b``, ``olmoe_1b_7b`` or
    ``jamba-1.5-large-398b``."""
    name = arch.replace("-", "_").replace(".", "_")
    if name not in PORTED:
        raise NotImplementedError(f"architecture {arch!r} is not ported; "
                                  f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
