"""Hand parameters across from the JAX package.

The port lays out its parameter dicts exactly like ``repro``'s pytrees
(layer-stacked, same keys), so the same weights feed both packages::

    tree = jax.tree_util.tree_map(np.asarray, repro_params)
    params = params_from_numpy(tree, device="cpu")
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same dicts of torch tensors on
    ``device`` (None = the CUDA card), values bit for bit."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, order="C", copy=True)).to(dev)

    return conv(tree)
