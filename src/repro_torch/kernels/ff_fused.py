"""The FF RMSNorm statistic ``mean_sq`` as one CUDA kernel, and its plain
version.

Counterpart of ``repro.kernels.ff_fused.run_pallas`` on the ``mean_sq``
program ``(x*x).sum()`` (the TPU default for ``mean_sq``); the general
Program executor is not ported yet.  The kernel (``csrc/ff_mean_sq.cu``)
keeps the TPU kernel's 128 lanes and their fold order; the plain version
is the reference's CPU formulation ``ff_sum_blocked(x*x, block=128)``.
The two agree to <= 1 ulp of the f32 result (the reference's own bound
for the two orders), in practice to the bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import compensated
from repro_torch.kernels import build

Tensor = torch.Tensor

# ff_mean_sq_f32(x, out, rows, cols, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def mean_sq_plain(x: Tensor) -> Tensor:
    """Compensated mean of squares over the last axis, (..., C) -> (...)."""
    x = x.to(torch.float32)
    return (compensated.ff_sum_blocked(x * x, axis=-1, block=128).to_f32()
            / x.shape[-1])


def mean_sq(x: Tensor) -> Tensor:
    """Compensated mean of squares over the last axis of an f32 tensor.

    On a CUDA tensor: one launch of the CUDA kernel (raises if it cannot
    launch); on a CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return mean_sq_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"mean_sq: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"mean_sq kernel takes float32, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] < 1:
        raise ValueError(f"mean_sq needs a non-empty last axis, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("mean_sq kernel takes a contiguous tensor")
    cols = x.shape[-1]
    rows = x.numel() // cols
    if rows >= 2 ** 31:
        raise ValueError(f"mean_sq kernel takes < 2^31 rows, got {rows}")
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.entry("ff_mean_sq", "ff_mean_sq_f32", _ARGTYPES)(
            x.data_ptr(), out.data_ptr(), rows, cols,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ff_mean_sq kernel launch failed: CUDA error "
                           f"{err}")
    mean_sq.launches += 1
    return out


mean_sq.launches = 0   # kernel launches since the last reset
