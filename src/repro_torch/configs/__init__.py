"""Full-size model configurations (data; copies of ``repro.configs``).

``get_config(arch)`` returns the full-size ``ModelConfig`` of an
architecture the port runs: the decoder-only families (dense GQA, MoE,
MLA, the VLM backbone).  The SSM, hybrid and encoder-decoder
architectures raise ``NotImplementedError`` naming the ROADMAP item that
ports them; any other name raises too.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import NOT_PORTED, ModelConfig

PORTED = ("granite_3_2b", "minitron_4b", "phi3_medium_14b", "llama3_405b",
          "olmoe_1b_7b", "deepseek_v2_236b", "internvl2_1b")
# the reference's other architectures, by family
OTHER = {"mamba2_370m": "ssm", "jamba_1_5_large_398b": "hybrid",
         "whisper_medium": "encdec"}


def get_config(arch: str) -> ModelConfig:
    """``arch`` as ``olmoe-1b-7b`` or ``olmoe_1b_7b``."""
    name = arch.replace("-", "_").replace(".", "_")
    if name in OTHER:
        raise NotImplementedError(f"architecture {arch!r} is not ported "
                                  f"yet: {NOT_PORTED[OTHER[name]]}")
    if name not in PORTED:
        raise NotImplementedError(f"architecture {arch!r} is not ported; "
                                  f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
