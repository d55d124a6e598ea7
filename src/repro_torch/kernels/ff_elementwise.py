"""The paper's elementwise FF operators as one CUDA kernel
(``csrc/ff_elementwise.cu``), with its plain version, and the operand
flattening shared by the port's elementwise, math, row and Program
kernels (counterpart of ``repro.kernels.ff_elementwise``).

``elementwise(op, *planes)`` runs Add22, Mul22, Div22 (four planes: a's
hi and lo, b's hi and lo), Sqrt22 (two), TwoSum or TwoProd (two f32
operands) over broadcastable operands and returns the (hi, lo) planes at
the broadcast shape.  A kernel sees each operand as a 2-D plane (rows,
last axis); an operand that broadcasts keeps its degenerate extent (1
row, 1 column, or both) and the kernel reads it with a zero stride along
that dimension, so it is never materialised.  ``block`` is the TPU
kernel's tile: it is validated (``pick_block``) but the CUDA launch does
not depend on it, and no block changes a bit.

On CUDA tensors ``elementwise`` launches the kernel (or raises); on CPU
tensors it takes the plain version ``elementwise_plain``, the same op
sequences from ``repro_torch.core`` over the broadcast planes: the
kernel's bits and the reference kernel's.  ``elementwise.launches``
counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF
from repro_torch.kernels import build

Tensor = torch.Tensor

DEFAULT_BLOCK = (256, 512)  # the TPU tile: 512 KiB per plane in VMEM

SUBLANE = 8     # f32 second-to-last TPU tile dim
LANE = 128      # last TPU tile dim


def _to_2d(x: Tensor) -> Tensor:
    """Flatten to 2-D keeping the last axis (rank-0/1 become 1 x n)."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        return x.reshape(1, -1)
    return x.reshape(-1, x.shape[-1])


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_block(rows: int, cols: int,
               block: Tuple[int, int] = DEFAULT_BLOCK) -> Tuple[int, int]:
    """The reference's tile for an (rows, cols) output: the requested
    block clamped to the padded extent, rows rounded up to the 8-sublane
    multiple and cols to the 128-lane multiple (a (3, 130) operand gets
    (8, 256))."""
    br, bc = (int(b) for b in block)
    if br < 1 or bc < 1:
        raise ValueError(f"block {tuple(block)} must be positive")
    br = min(_round_up(br, SUBLANE), _round_up(max(rows, 1), SUBLANE))
    bc = min(_round_up(bc, LANE), _round_up(max(cols, 1), LANE))
    return br, bc


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


# -- the strided-plane launch shared with kernels/ff_math.py ------------------

MAX_IN = 4


class _Planes(ctypes.Structure):
    """``struct Planes`` of csrc/ff_planes.cuh, field for field."""
    _fields_ = [("op", ctypes.c_int), ("n_in", ctypes.c_int),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
                ("inp", ctypes.c_void_p * MAX_IN),
                ("rs", ctypes.c_longlong * MAX_IN),
                ("cs", ctypes.c_longlong * MAX_IN),
                ("out_hi", ctypes.c_void_p), ("out_lo", ctypes.c_void_p)]


_CHECKED = set()


def operand_device(arrays: Sequence) -> torch.device:
    """The device of a call: the one non-CPU device among the tensor
    operands (a 0-d CPU tensor or a number rides along), else the CPU."""
    devs = {a.device for a in arrays if isinstance(a, Tensor)}
    other = devs - {torch.device("cpu")}
    if len(other) > 1:
        raise RuntimeError(f"operands on several devices: "
                           f"{sorted(map(str, devs))}")
    return other.pop() if other else torch.device("cpu")


def layout(what: str, n_in: int, arrays: Sequence, block,
           device: torch.device):
    """f32 operand planes on ``device`` against their broadcast shape:
    (planes, broadcast shape, R, C).  Validates the count and the block."""
    if len(arrays) != n_in:
        raise ValueError(f"{what} takes {n_in} planes, got {len(arrays)}")
    arrays = tuple(torch.as_tensor(a, dtype=torch.float32).to(device)
                   for a in arrays)
    planes, out_shape = broadcast_planes(arrays)
    R = max(p.shape[0] for p in planes)
    C = max(p.shape[1] for p in planes)
    pick_block(R, C, block)
    return planes, out_shape, R, C


def launch_planes(lib: str, op: int, planes: Sequence[Tensor],
                  R: int, C: int, device: torch.device
                  ) -> Tuple[Tensor, Tensor]:
    """One launch of an elementwise kernel of lib``lib`` over strided
    operand planes; returns the (R, C) hi and lo planes."""
    if lib not in _CHECKED:
        n = build.entry(lib, f"{lib}_planes_bytes", [])()
        if n != ctypes.sizeof(_Planes):
            raise RuntimeError(f"{lib}: the kernel's Planes is {n} bytes, "
                               f"the wrapper's {ctypes.sizeof(_Planes)}")
        _CHECKED.add(lib)
    hi = torch.empty((R, C), dtype=torch.float32, device=device)
    lo = torch.empty_like(hi)
    t = _Planes(op=op, n_in=len(planes), rows=R, cols=C,
                out_hi=hi.data_ptr(), out_lo=lo.data_ptr())
    for k, p in enumerate(planes):
        t.inp[k] = p.data_ptr()
        t.rs[k] = p.stride(0) if p.shape[0] != 1 else 0
        t.cs[k] = p.stride(1) if p.shape[1] != 1 else 0
    with torch.cuda.device(device):
        err = build.entry(lib, f"{lib}_f32",
                          [ctypes.POINTER(_Planes), ctypes.c_void_p])(
            ctypes.byref(t), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} kernel launch failed: CUDA error {err}")
    return hi, lo


# -- the flat streaming path (csrc/ff_stream.cuh) -----------------------------

STREAM_LIMIT = 1 << 30  # the streams' 32-bit index: fewer elements than this
VECTOR_ALIGN = 16       # bytes of a 16-byte access


class Plan(NamedTuple):
    """An elementwise launch: ``path`` "vector" (the flat loop, 16-byte
    accesses), "flat" (the flat loop, 4-byte accesses) or "strided";
    ``scalars`` has bit p set where operand p is a scalar (flat paths)."""
    path: str
    scalars: int = 0


def _plane_strides(p: Tensor) -> Tuple[int, int]:
    """The (row, column) element strides the kernel reads ``p`` through
    (0 along a degenerate extent), as ``launch_planes`` passes them."""
    return (p.stride(0) if p.shape[0] != 1 else 0,
            p.stride(1) if p.shape[1] != 1 else 0)


def elementwise_plan(planes: Sequence[Tensor], R: int, C: int,
                     outs: Sequence[Tensor] = ()) -> Plan:
    """The path of an elementwise launch over ``planes`` (2-D, from
    ``layout``) into the (R, C) planes ``outs``.  Flat where each plane is
    dense row-major at (R, C) (element (r, c) at r C + c) or a scalar, and
    R C < ``STREAM_LIMIT``: "vector" where every dense plane and every
    output starts on a 16-byte boundary, else "flat"; "strided"
    otherwise."""
    if R * C >= STREAM_LIMIT:
        return Plan("strided")
    scalars, aligned = 0, all(o.data_ptr() % VECTOR_ALIGN == 0
                              for o in outs)
    for k, p in enumerate(planes):
        rs, cs = _plane_strides(p)
        if (R == 1 or rs == C) and (C == 1 or cs == 1):
            aligned = aligned and p.data_ptr() % VECTOR_ALIGN == 0
        elif (R == 1 or rs == 0) and (C == 1 or cs == 0):
            scalars |= 1 << k
        else:
            return Plan("strided")
    return Plan("vector" if aligned else "flat", scalars)


def launch_flat(op: int, planes: Sequence[Tensor], plan: Plan,
                hi: Tensor, lo: Tensor) -> None:
    """One launch of the elementwise kernel's flat path (``plan``) over
    ``planes`` into the (R, C) planes ``hi`` and ``lo``."""
    if "ff_elementwise" not in _CHECKED:
        size = build.entry(
            "ff_elementwise", "ff_elementwise_planes_bytes", [])()
        if size != ctypes.sizeof(_Planes):
            raise RuntimeError(f"ff_elementwise: the kernel's Planes is "
                               f"{size} bytes, the wrapper's "
                               f"{ctypes.sizeof(_Planes)}")
        _CHECKED.add("ff_elementwise")
    R, C = hi.shape
    t = _Planes(op=op, n_in=len(planes), rows=R, cols=C,
                out_hi=hi.data_ptr(), out_lo=lo.data_ptr())
    for k, p in enumerate(planes):
        t.inp[k] = p.data_ptr()
        t.rs[k], t.cs[k] = _plane_strides(p)
    with torch.cuda.device(hi.device):
        err = build.entry("ff_elementwise", "ff_elementwise_flat_f32",
                          [ctypes.POINTER(_Planes), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p])(
            ctypes.byref(t), plan.scalars, int(plan.path == "vector"),
            torch.cuda.current_stream(hi.device).cuda_stream)
    if err:
        raise RuntimeError(f"ff_elementwise kernel launch failed: CUDA "
                           f"error {err}")


# -- the operators ------------------------------------------------------------

def _ff2(fn: Callable) -> Callable:
    def body(ah, al, bh, bl):
        r = fn(FF(ah, al), FF(bh, bl))
        return r.hi, r.lo
    return body


def _sqrt22(ah, al):
    r = core_ff.sqrt22(FF(ah, al))
    return r.hi, r.lo


# op -> (plain body over full planes, number of planes); the order is the
# kernel's op codes (enum Op of csrc/ff_elementwise.cu)
_OPS: Dict[str, Tuple[Callable, int]] = {
    "add22": (_ff2(core_ff.add22), 4),
    "mul22": (_ff2(core_ff.mul22), 4),
    "div22": (_ff2(core_ff.div22), 4),
    "sqrt22": (_sqrt22, 2),
    "two_prod": (T.two_prod, 2),
    "two_sum": (T.two_sum, 2),
}
EW_OPS = tuple(_OPS)


def _op(op: str) -> Tuple[Callable, int]:
    if op not in _OPS:
        raise KeyError(f"elementwise op {op!r}; ops: {EW_OPS}")
    return _OPS[op]


def elementwise_plain(op: str, *arrays,
                      block: Tuple[int, int] = DEFAULT_BLOCK
                      ) -> Tuple[Tensor, Tensor]:
    """The kernel in PyTorch: ``op`` over the operand planes expanded to
    (R, C), reshaped to the broadcast shape."""
    fn, n_in = _op(op)
    dev = operand_device(arrays)
    planes, out_shape, R, C = layout(f"elementwise {op!r}", n_in, arrays,
                                     block, dev)
    rh, rl = fn(*(p.expand(R, C) for p in planes))
    return rh.reshape(out_shape), rl.reshape(out_shape)


def elementwise(op: str, *arrays, block: Tuple[int, int] = DEFAULT_BLOCK
                ) -> Tuple[Tensor, Tensor]:
    """Run an elementwise FF operator over broadcastable operands,
    returning (hi, lo) at the broadcast shape.

    On CUDA operands: one launch of ``csrc/ff_elementwise.cu`` (raises if
    it cannot launch); on CPU operands: the plain version."""
    fn, n_in = _op(op)
    dev = operand_device(arrays)
    if dev.type == "cpu":
        return elementwise_plain(op, *arrays, block=block)
    if dev.type != "cuda":
        raise RuntimeError(f"elementwise: no kernel for device {dev}")
    planes, out_shape, R, C = layout(f"elementwise {op!r}", n_in, arrays,
                                     block, dev)
    if R * C == 0:
        z = torch.empty(out_shape, dtype=torch.float32, device=dev)
        return z, z.clone()
    plan = elementwise_plan(planes, R, C)
    if plan.path == "strided":
        hi, lo = launch_planes("ff_elementwise", EW_OPS.index(op), planes,
                               R, C, dev)
    else:
        hi = torch.empty((R, C), dtype=torch.float32, device=dev)
        lo = torch.empty_like(hi)
        plan = elementwise_plan(planes, R, C, (hi, lo))
        launch_flat(EW_OPS.index(op), planes, plan, hi, lo)
    elementwise.launches += 1
    elementwise.last_path = plan.path
    return hi.reshape(out_shape), lo.reshape(out_shape)


elementwise.launches = 0   # kernel launches since the last reset
elementwise.last_path = None   # the last launch's path (elementwise_plan)
