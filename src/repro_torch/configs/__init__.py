"""Full-size model configurations (data; copies of ``repro.configs``).

``get_config(arch)`` returns the full-size ``ModelConfig`` of an
architecture the port runs; any other name raises.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

PORTED = ("granite_3_2b",)


def get_config(arch: str) -> ModelConfig:
    """``arch`` as ``granite-3-2b`` or ``granite_3_2b``."""
    name = arch.replace("-", "_")
    if name not in PORTED:
        raise NotImplementedError(f"architecture {arch!r} is not ported; "
                                  f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
