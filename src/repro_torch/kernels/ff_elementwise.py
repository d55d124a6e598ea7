"""Operand flattening shared by the port's row and Program kernels
(counterpart of the helpers of ``repro.kernels.ff_elementwise``; the
``elementwise`` kernel itself is not ported yet).

A kernel sees each operand as a 2-D plane (rows, last axis).  An operand
that broadcasts keeps its degenerate extent (1 row, 1 column, or both):
the kernel reads it with a zero stride along that dimension.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor


def _to_2d(x: Tensor) -> Tensor:
    """Flatten to 2-D keeping the last axis (rank-0/1 become 1 x n)."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        return x.reshape(1, -1)
    return x.reshape(-1, x.shape[-1])


def _pad_to(x: Tensor, br: int, bc: int) -> Tensor:
    """Zero-pad a 2-D tensor up to multiples of (br, bc)."""
    r, c = x.shape
    pr, pc = (-r) % br, (-c) % bc
    if pr or pc:
        x = torch.nn.functional.pad(x, (0, pc, 0, pr))
    return x


def broadcast_planes(arrays: Sequence[Tensor]
                     ) -> Tuple[Tuple[Tensor, ...], Tuple[int, ...]]:
    """Flatten operands to 2-D against their common broadcast shape.

    Scalar, row and column operands keep their degenerate extent; an
    operand with a partial leading-dimension broadcast (e.g. (3, 8)
    against (4, 3, 8)) is expanded to the full shape first.  Returns the
    planes and the broadcast shape."""
    out_shape = tuple(torch.broadcast_shapes(*(a.shape for a in arrays)))
    if len(out_shape) == 0:
        out2 = (1, 1)
    elif len(out_shape) == 1:
        out2 = (1, out_shape[0])
    else:
        r = 1
        for d in out_shape[:-1]:
            r *= d
        out2 = (r, out_shape[-1])
    planes = []
    for a in arrays:
        a2 = _to_2d(a)
        # shapes right-align under broadcasting, so the flattened form is
        # usable iff each flat dim is the output's or a degenerate 1
        if a2.shape[0] not in (1, out2[0]) or a2.shape[1] not in (1, out2[1]):
            a2 = _to_2d(a.expand(out_shape))
        planes.append(a2)
    return tuple(planes), out_shape
