"""The FF elementary functions of ``repro.kernels.ff_math`` as one CUDA
kernel (``csrc/ff_math.cu``), with its plain version.

``math_elementwise(op, *planes)`` runs one of the nine unary functions of
``ffmath.UNARY22`` (two planes in: hi, lo) or ``pow`` (four: a's hi and
lo, b's hi and lo) over broadcastable operands and returns the (hi, lo)
planes at the broadcast shape, with the strided-plane layout of
``kernels.ff_elementwise`` (a broadcast operand is never materialised).
``block`` is the TPU kernel's tile: validated, it changes no bit and
not the CUDA launch.

On CUDA tensors ``math_elementwise`` launches the kernel (or raises); on
CPU tensors it takes the plain version ``math_elementwise_plain``, the
``repro_torch.core.ffmath`` functions over the broadcast planes: the
kernel's bits and the reference kernel's.  ``math_elementwise.launches``
counts launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import ffmath
from repro_torch.kernels.ff_elementwise import (launch_planes, layout,
                                                operand_device)

Tensor = torch.Tensor

# deeper bodies than the arithmetic kernels: the TPU kernel's smaller tile
DEFAULT_BLOCK = (128, 512)

# the kernel's op codes (enum Op of csrc/ff_math.cu)
MATH_OPS = ("exp", "expm1", "log", "log1p", "tanh", "sigmoid", "erf",
            "gelu", "silu", "pow")


def _fn(op: str):
    if op not in MATH_OPS:
        raise KeyError(f"math op {op!r}; ops: {MATH_OPS}")
    if op == "pow":
        return ffmath.pow22, 4
    return ffmath.UNARY22[op], 2


def math_elementwise_plain(op: str, *arrays,
                           block: Tuple[int, int] = DEFAULT_BLOCK
                           ) -> Tuple[Tensor, Tensor]:
    """The kernel in PyTorch: the ffmath function over the operand planes
    expanded to (R, C), reshaped to the broadcast shape."""
    fn, n_in = _fn(op)
    planes, out_shape, R, C = layout(f"math_elementwise {op!r}", n_in,
                                     arrays, block, operand_device(arrays))
    rh, rl = fn(*(p.expand(R, C) for p in planes))
    return rh.reshape(out_shape), rl.reshape(out_shape)


def math_elementwise(op: str, *arrays,
                     block: Tuple[int, int] = DEFAULT_BLOCK
                     ) -> Tuple[Tensor, Tensor]:
    """Run an FF elementary function over broadcastable limb planes,
    returning (hi, lo) at the broadcast shape.

    On CUDA operands: one launch of ``csrc/ff_math.cu`` (raises if it
    cannot launch); on CPU operands: the plain version."""
    _fn(op)
    dev = operand_device(arrays)
    if dev.type == "cpu":
        return math_elementwise_plain(op, *arrays, block=block)
    if dev.type != "cuda":
        raise RuntimeError(f"math_elementwise: no kernel for device {dev}")
    planes, out_shape, R, C = layout(f"math_elementwise {op!r}",
                                     _fn(op)[1], arrays, block, dev)
    if R * C == 0:
        z = torch.empty(out_shape, dtype=torch.float32, device=dev)
        return z, z.clone()
    hi, lo = launch_planes("ff_math", MATH_OPS.index(op), planes, R, C, dev)
    math_elementwise.launches += 1
    return hi.reshape(out_shape), lo.reshape(out_shape)


math_elementwise.launches = 0   # kernel launches since the last reset
