"""The compensated row sum of ``repro.kernels.ff_reduce`` as a CUDA kernel
(``csrc/ff_rowsum.cu``), with its plain version.

``ff_rowsum(x)`` reduces each row of an f32 (R, C) tensor to an FF pair
with the TPU kernel's order: ``lane`` (s, c, cc) Neumaier cascades per
row, lane l taking columns l, l + lane, ... (Sum3 quality), folded
exactly, lane 0 first.  The reference clamps the lane count to the
row, ``lane = min(lane, bc, C)`` with ``bc = min(bc, C)``: a row shorter
than 128 has C lanes, and so here.  ``br`` and ``bc`` are the TPU tile;
beyond that clamp they change no bit, and the CUDA launch (one block of
``lane`` threads per row) does not depend on them.

On a CUDA tensor ``ff_rowsum`` launches the kernel (or raises); on a CPU
tensor it takes the plain version ``ff_rowsum_plain``
(``kernels.ref.ref_ff_rowsum`` at the clamped lane count): the kernel's
bits and the reference kernel's.  ``ff_rowsum.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_ff_rowsum

Tensor = torch.Tensor

MAX_LANES = 1024          # threads of one CUDA block
# ff_rowsum_f32(x, ld, hi, lo, rows, cols, lanes, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def lanes_for(C: int, bc: int = 512, lane: int = 128) -> int:
    """The reference kernel's lane count for rows of C columns."""
    if min(bc, lane) < 1:
        raise ValueError(f"ff_rowsum: bc={bc} and lane={lane} must be "
                         f"positive")
    return max(1, min(lane, bc, C))


def _check(x: Tensor) -> Tensor:
    x = x.to(torch.float32)
    if x.ndim != 2:
        raise ValueError(f"ff_rowsum takes (R, C), got {tuple(x.shape)}")
    return x


def ff_rowsum_plain(x: Tensor, *, br: int = 256, bc: int = 512,
                    lane: int = 128) -> Tuple[Tensor, Tensor]:
    """The kernel in PyTorch: ``ref_ff_rowsum`` at the clamped lane count.
    Returns (hi, lo), (R,) each."""
    x = _check(x)
    R, C = x.shape
    if C == 0:
        z = x.new_zeros((R,))
        return z, z.clone()
    return ref_ff_rowsum(x, lanes_for(C, bc, lane))


def ff_rowsum(x: Tensor, *, br: int = 256, bc: int = 512,
              lane: int = 128) -> Tuple[Tensor, Tensor]:
    """Compensated row sum of an f32 (R, C) tensor -> FF (hi, lo), (R,)
    each, bit for bit :func:`ff_rowsum_plain`.

    On a CUDA tensor: one launch (raises if it cannot launch); on a CPU
    tensor: the plain version."""
    if x.device.type == "cpu":
        return ff_rowsum_plain(x, br=br, bc=bc, lane=lane)
    if x.device.type != "cuda":
        raise RuntimeError(f"ff_rowsum: no kernel for device {x.device}")
    x = _check(x)
    R, C = x.shape
    lanes = lanes_for(C, bc, lane)
    if lanes > MAX_LANES:
        raise ValueError(f"ff_rowsum kernel takes at most {MAX_LANES} "
                         f"lanes, got {lanes}")
    if R >= 2 ** 31 or C >= 2 ** 31:
        raise ValueError(f"ff_rowsum kernel takes < 2^31 rows and columns, "
                         f"got {tuple(x.shape)}")
    if x.stride(1) != 1:
        x = x.contiguous()
    hi = torch.zeros((R,), dtype=torch.float32, device=x.device)
    lo = torch.zeros_like(hi)
    if R and C:
        with torch.cuda.device(x.device):
            err = build.entry("ff_rowsum", "ff_rowsum_f32", _ARGTYPES)(
                x.data_ptr(), x.stride(0), hi.data_ptr(), lo.data_ptr(), R,
                C, lanes, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"ff_rowsum kernel launch failed: CUDA error "
                               f"{err}")
        ff_rowsum.launches += 1
    return hi, lo


ff_rowsum.launches = 0   # kernel launches since the last reset
