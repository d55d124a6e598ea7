"""Hand parameters across from the JAX package.

The port lays out its parameter dicts exactly like ``repro``'s pytrees
(layer-stacked, same keys), so the same weights feed both packages::

    tree = jax.tree_util.tree_map(np.asarray, repro_params)
    params = params_from_numpy(tree, device="cpu")
    state = opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, repro_opt_state), device="cpu")
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adamw import AdamWState


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dicts, tuples and lists of numpy arrays (the hybrid's
    ``params["layers"]`` is a tuple of per-index dicts) -> the same
    structure of torch tensors on ``device`` (None = the CUDA card), values
    bit for bit."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x, order="C", copy=True)).to(dev)

    return conv(tree)


def opt_state_from_numpy(state, device=None) -> AdamWState:
    """The reference's ``AdamWState`` ``(count, master_lo, m, v)``, its
    leaves as numpy arrays, -> the port's :class:`AdamWState` on
    ``device`` (None = the CUDA card), values bit for bit."""
    count, master_lo, m, v = state
    dev = resolve_device(device)
    return AdamWState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=dev),
        master_lo=params_from_numpy(master_lo, dev),
        m=params_from_numpy(m, dev), v=params_from_numpy(v, dev))
