"""The reference's fused kernels (``repro.kernels.ff_fused``) as CUDA
kernels, each with its plain version.

The general Program executor and two dedicated programs of
``run_pallas``, and the two whole-row composites:

  * ``run_program``, one recorded ``ff.fusion`` Program in one launch
    (``csrc/ff_program.cu``): a fixed kernel that evaluates the Program's
    instruction tape per element, with each trailing row sum in the TPU
    kernel's 128-lane order.  Bit for bit its plain version
    ``run_program_plain``.
  * ``ff_softmax``, softmax or log-sum-exp over the last axis, with the
    f32 builtin exp or (``accurate``) ``exp22`` on an exact TwoSum shift
    (``csrc/ff_softmax.cu``); ``ff_norm_stats``, the compensated mean and
    centred variance (``csrc/ff_norm_stats.cu``).  Rows up to
    ``MAX_FUSED_COLS``; the plain versions fold in the same lane order.
    Both launch on ``row_plan``'s path: four warps a row; each row
    copied into shared memory by 16-byte ``cp.async`` where the rows
    allow it, else 4-byte, or, where the card holds every row at once,
    read there by the first pass (``ff_norm_stats``: read by each
    pass).
  * ``mean_sq``, the FF RMSNorm statistic ``(x*x).sum() / C``
    (``csrc/ff_mean_sq.cu``).  The kernel keeps the TPU kernel's 128
    lanes and their fold order; the plain version is the reference's CPU
    formulation ``ff_sum_blocked(x*x, block=128)``.  The two agree to
    <= 1 ulp of the f32 result (the reference's own bound for the two
    orders), in practice to the bit.
  * ``adamw_update``, the AdamW leaf update with an FF master weight
    (``csrc/ff_adamw.cu``).  Purely elementwise and correctly rounded op
    by op, so the kernel and the plain version (``_adamw_chain`` of
    ``repro.ff.dispatch``, same op order) agree bit for bit.  It streams
    the leaves with 16-byte accesses where ``adamw_plan`` finds them
    aligned.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import compensated, ffmath
from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF, sqrt_rn
from repro_torch.kernels import build
from repro_torch.kernels.ff_elementwise import (STREAM_LIMIT, VECTOR_ALIGN,
                                                _to_2d, broadcast_planes)
from repro_torch.kernels.ref import fold_lanes, lane_cascade

Tensor = torch.Tensor

LANE = 128                   # the TPU kernels' lane count, kept as an order
MAX_FUSED_COLS = 16384       # whole-row kernels beyond this -> jnp impls

# ff_mean_sq_f32(x, out, rows, cols, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def div_n(x: Tensor, n: int) -> Tensor:
    """``x / n`` as an IEEE f32 division.  PyTorch divides a CUDA tensor
    by a Python number as a multiply by the number's rounded reciprocal
    (the CPU divides); a divisor tensor keeps the division on both."""
    return x / torch.full_like(x, n)


def mean_sq_plain(x: Tensor) -> Tensor:
    """Compensated mean of squares over the last axis, (..., C) -> (...)."""
    x = x.to(torch.float32)
    return div_n(compensated.ff_sum_blocked(x * x, axis=-1,
                                            block=128).to_f32(), x.shape[-1])


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


# -- adamw_update: the FF-master-weight AdamW leaf update ---------------------

# ff_adamw_f32(g, m, v, w, wlo, scal, eps, wd, n, vector, stream)
_ADAMW_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def adamw_plan(leaves: Sequence[Tensor]) -> str:
    """The AdamW kernel's path over the leaves ``g, m, v, w, wlo``:
    "vector" (16-byte accesses, a 32-bit index) where all five start on a
    16-byte boundary and have fewer than ``STREAM_LIMIT`` elements, else
    "flat" (the 4-byte loop)."""
    if leaves[0].numel() < STREAM_LIMIT and all(
            t.data_ptr() % VECTOR_ALIGN == 0 for t in leaves):
        return "vector"
    return "flat"


def f32_scalar(x: float) -> float:
    """``x`` rounded to the nearest f32, as JAX rounds a weak-typed Python
    float in an f32 expression."""
    return float(torch.tensor(x, dtype=torch.float32))


def _scalar(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())


def adamw_chain(g: Tensor, m: Tensor, v: Tensor, w: Tensor, lr, b1, b2,
                bc1, bc2, eps: float, wd: float
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The moments and the f32 weight step ``(delta, m2, v2)`` of one AdamW
    leaf, in the reference's op order (``_adamw_chain``: the op order is
    bitwise-load-bearing, and ``(1.0 - b2) * g * g`` associates left),
    every op correctly rounded.  The scalars are 0-d f32 tensors on
    ``g``'s device; ``eps`` and ``wd`` are Python floats, rounded to f32."""
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    upd = (m2 / bc1) / (sqrt_rn(v2 / bc2) + f32_scalar(eps))
    upd = upd + f32_scalar(wd) * w
    return -lr * upd, m2, v2


def adamw_update_plain(g: Tensor, m: Tensor, v: Tensor, w: Tensor,
                       wlo: Tensor, lr, b1, b2, bc1, bc2, *, eps: float,
                       wd: float) -> None:
    """The AdamW leaf update with an FF master weight ``(w, wlo)``, in
    place: ``(w, wlo)`` become the master weight plus the step (Add212),
    ``m`` and ``v`` the new moments."""
    dev = g.device
    lr, b1, b2, bc1, bc2 = (_scalar(s, dev) for s in (lr, b1, b2, bc1, bc2))
    delta, m2, v2 = adamw_chain(g, m, v, w, lr, b1, b2, bc1, bc2, eps, wd)
    new = core_ff.add212(FF(w, wlo), delta)
    for dst, src in zip((w, wlo, m, v), (new.hi, new.lo, m2, v2)):
        dst.copy_(src)


def adamw_update(g: Tensor, m: Tensor, v: Tensor, w: Tensor, wlo: Tensor,
                 lr, b1, b2, bc1, bc2, *, eps: float, wd: float) -> None:
    """The AdamW leaf update with an FF master weight, in place, as
    :func:`adamw_update_plain` (same arguments, same bits).

    On CUDA tensors: one launch of the CUDA kernel, which raises if it
    cannot launch (five distinct contiguous f32 leaves of one shape on
    one device; the scalars are read on the device, with no host sync).
    On CPU tensors: the plain version."""
    if g.device.type == "cpu":
        return adamw_update_plain(g, m, v, w, wlo, lr, b1, b2, bc1, bc2,
                                  eps=eps, wd=wd)
    if g.device.type != "cuda":
        raise RuntimeError(f"adamw_update: no kernel for device {g.device}")
    for t in (g, m, v, w, wlo):
        if t.dtype != torch.float32:
            raise TypeError(f"adamw_update kernel takes float32, got "
                            f"{t.dtype}")
        if t.shape != g.shape or t.device != g.device:
            raise ValueError(f"adamw_update leaves disagree: "
                             f"{tuple(t.shape)} on {t.device} against "
                             f"{tuple(g.shape)} on {g.device}")
        if not t.is_contiguous():
            raise ValueError("adamw_update kernel takes contiguous leaves")
    scal = torch.stack([_scalar(s, g.device)
                        for s in (lr, b1, b2, bc1, bc2)])
    path = adamw_plan((g, m, v, w, wlo))
    with torch.cuda.device(g.device):
        err = build.entry("ff_adamw", "ff_adamw_f32", _ADAMW_ARGTYPES)(
            *(t.data_ptr() for t in (g, m, v, w, wlo, scal)),
            f32_scalar(eps), f32_scalar(wd), g.numel(),
            int(path == "vector"),
            torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"ff_adamw kernel launch failed: CUDA error "
                           f"{err}")
    adamw_update.launches += 1
    adamw_update.last_path = path


adamw_update.launches = 0   # kernel launches since the last reset
adamw_update.last_path = None   # the last launch's path (adamw_plan)


# -- the fixed 128-lane summation order ---------------------------------------

def _lane_cascade(val: Tensor, acc=None):
    """``ref.lane_cascade`` over the TPU kernels' 128 lanes."""
    return lane_cascade(val, acc, LANE)


def _fold_lanes(acc) -> FF:
    """``ref.fold_lanes`` as an FF per row."""
    return FF(*fold_lanes(acc))


def _rows(x: Tensor, what: str) -> Tuple[Tensor, Tuple[int, ...]]:
    """x as f32 (R, C) rows, C <= MAX_FUSED_COLS, and its shape."""
    x = x.to(torch.float32)
    x2 = _to_2d(x)
    if x2.shape[1] > MAX_FUSED_COLS:
        raise ValueError(f"{what}: row length {x2.shape[1]} exceeds "
                         f"MAX_FUSED_COLS ({MAX_FUSED_COLS}); use the jnp "
                         f"impl")
    return x2, x.shape


# -- the whole-row kernels' plan (csrc/ff_rows.cuh) ---------------------------

STREAM_COLS = 2048           # rows of up to this many columns may stream
REREAD_COLS = 8192           # ff_norm_stats' rows up to this may be re-read
# rows a block: two where one warp's fold for both saves a fold's issue
# (two folds a row, or long accurate passes), one in the fast modes,
# whose single fold's barrier would hold back the other row; the launch
# takes fewer where they do not fit in shared memory
ROWS_PER_BLOCK = {"norm_stats": 2, "softmax": 1, "logsumexp": 1,
                  "softmax accurate": 2, "logsumexp accurate": 2}
# enum Path of csrc/ff_rows.cuh
_PATH_CODES = {"staged scalar": 0, "staged": 1, "streamed": 2, "reread": 3}


class RowPlan(NamedTuple):
    """A whole-row launch: four warps a row, thread l TPU lane l.
    ``path``: how the row gets on chip: "staged" / "staged scalar"
    (copied into shared memory by cp.async, 16 / 4 bytes a copy: 4 where
    the row is ragged or starts off 16 bytes), "streamed" (read into it
    by the first pass) or "reread" (``norm_stats``: one block a row, read
    by each pass, the second from L1); ``rows_per_block``: rows a block
    asked for."""
    path: str
    rows_per_block: int


@functools.lru_cache(maxsize=1024)
def row_plan(rows: int, cols: int, offset: int, kind: str = "norm_stats",
             sms: int = 132, sm_threads: int = 2048) -> RowPlan:
    """The plan of a whole-row launch of ``kind`` (a key of
    ``ROWS_PER_BLOCK``) over (rows, cols) f32 rows whose first starts
    ``offset`` bytes past a 16-byte boundary, on a card of ``sms`` SMs of
    ``sm_threads`` threads.  Where the card's threads hold all the rows
    at once (one wave), ``norm_stats`` re-reads rows of up to
    ``REREAD_COLS`` columns if there are at least as many as SMs, and
    the other kernels stream rows of up to ``STREAM_COLS``: the first
    pass starts as its data arrives.  Other rows are staged, all of a
    row in flight at once (the most bytes in flight where an SM has one
    row or none), by 16-byte copies where ``cols % 4 == 0`` and
    ``offset == 0``, else 4-byte ones.  ``ROWS_PER_BLOCK[kind]`` rows a
    block, but no more than leave a block for each SM."""
    w = max(1, min(ROWS_PER_BLOCK[kind], rows // sms))
    one_wave = rows <= sms * (sm_threads // LANE)
    if kind == "norm_stats":
        if one_wave and sms <= rows and cols <= REREAD_COLS:
            return RowPlan("reread", 1)
    elif one_wave and cols <= STREAM_COLS:
        return RowPlan("streamed", w)
    if cols % 4 or offset % VECTOR_ALIGN:
        path = "staged scalar"
    else:
        path = "staged"
    return RowPlan(path, w)


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, int]:
    """(SMs, threads an SM) of CUDA device ``index``."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, getattr(
        p, "max_threads_per_multi_processor", 2048)


def _row_plan_of(x2: Tensor, kind: str) -> RowPlan:
    return row_plan(*x2.shape, x2.data_ptr() % VECTOR_ALIGN, kind,
                    *_card(x2.get_device()))


def row_walk(cols: int) -> List[List[Tuple[int, int]]]:
    """The kernels' walk of one row: for each of its 128 threads, the
    (lane, column) pairs of its lane cascade in the order it adds them
    (``each_col`` of ff_rows.cuh; every path)."""
    return [[(t, j) for j in range(t, cols, LANE)] for t in range(LANE)]


def _row_entry(name: str, fn: str, argtypes, x2: Tensor, outs, *extra):
    """Launch a whole-row kernel of lib``name`` on (R, C) f32 rows; raises
    on a launch error."""
    R, C = x2.shape
    if R >= 2 ** 31:
        raise ValueError(f"{name} kernel takes < 2^31 rows, got {R}")
    with torch.cuda.device(x2.device):
        err = build.entry(name, fn, argtypes)(
            x2.data_ptr(), *(o.data_ptr() for o in outs), R, C, *extra,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _kernel_rows(x: Tensor, what: str
                 ) -> Tuple[Tensor, Tuple[int, ...]]:
    """``x`` for a row kernel: a CUDA f32 tensor as contiguous (R, C) rows
    (a copy only for a strided view), and its shape."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, got {x.dtype}")
    return _rows(x.contiguous(), what)


# -- ff_softmax: softmax / log-sum-exp over the last axis ---------------------

_SOFTMAX_MODES = {"softmax": 0, "logsumexp": 1}
# ff_softmax_f32(x, out, rows, cols, mode, accurate, path, rows_per_block,
#                stream)
_SOFTMAX_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def _check_mode(mode: str) -> None:
    if mode not in _SOFTMAX_MODES:
        raise ValueError(f"ff_softmax mode {mode!r}; modes: "
                         f"{tuple(_SOFTMAX_MODES)}")


def ff_softmax_plain(x: Tensor, mode: str = "softmax",
                     accurate: bool = False) -> Tensor:
    """The reference's ``_softmax_kernel`` in PyTorch: row max; exp(x - m)
    (the f32 builtin), or ``exp22`` of TwoSum(x, -m) with both limb
    planes summed (``accurate``); the 128-lane compensated sum; then
    ``e / s`` or ``div22(e, s).hi`` (softmax, shape of x), ``m + log s``
    or ``add212(log22(s), m).hi`` (logsumexp, shape[:-1])."""
    _check_mode(mode)
    x2, shape = _rows(x, "ff_softmax")
    m = torch.amax(x2, dim=1, keepdim=True)
    if accurate:
        dh, dl = T.two_sum(x2, (-m).expand(x2.shape))
        eh, el = ffmath.exp22(dh, dl)
        f = _fold_lanes(_lane_cascade(el, _lane_cascade(eh)))
        if mode == "softmax":
            out = core_ff.div22(FF(eh, el), FF(f.hi[:, None],
                                               f.lo[:, None])).hi
        else:
            out = core_ff.add212(FF(*ffmath.log22(f.hi, f.lo)), m[:, 0]).hi
    else:
        e = torch.exp(x2 - m)
        fh = _fold_lanes(_lane_cascade(e)).hi
        if mode == "softmax":
            out = e / fh[:, None]
        else:
            out = m[:, 0] + torch.log(fh)
    return out.reshape(shape if mode == "softmax" else shape[:-1])


def ff_softmax(x: Tensor, mode: str = "softmax",
               accurate: bool = False) -> Tensor:
    """One-kernel compensated softmax / log-sum-exp over the last axis of
    an f32 tensor, as :func:`ff_softmax_plain` (bit for bit with
    ``accurate``; with the f32 builtin exp, to the card's ``expf``).

    On a CUDA tensor: one launch on ``row_plan``'s path (raises if it
    cannot launch); on a CPU tensor: the plain version.  Rows longer than
    ``MAX_FUSED_COLS`` raise ``ValueError``."""
    if x.device.type == "cpu":
        return ff_softmax_plain(x, mode, accurate)
    _check_mode(mode)
    x2, shape = _kernel_rows(x, "ff_softmax")
    R, C = x2.shape
    if mode == "softmax":
        out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    else:
        out = torch.empty((R,), dtype=torch.float32, device=x.device)
    if R and C:
        plan = _row_plan_of(x2, mode + (" accurate" if accurate else ""))
        _row_entry("ff_softmax", "ff_softmax_f32", _SOFTMAX_ARGTYPES, x2,
                   (out,), _SOFTMAX_MODES[mode], int(bool(accurate)),
                   _PATH_CODES[plan.path], plan.rows_per_block)
        ff_softmax.launches += 1
        ff_softmax.last_path = plan.path
    return out.reshape(shape if mode == "softmax" else shape[:-1])


ff_softmax.launches = 0   # kernel launches since the last reset
ff_softmax.last_path = None   # the last launch's path (row_plan)


# -- ff_norm_stats: LayerNorm statistics --------------------------------------

# ff_norm_stats_f32(x, mu, var, rows, cols, path, rows_per_block, stream)
_NORM_STATS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]


def ff_norm_stats_plain(x: Tensor) -> Tuple[Tensor, Tensor]:
    """The reference's ``_norm_stats_kernel`` in PyTorch: the 128-lane
    compensated row sum, ``mu = hi / C``, then the same sum of
    ``(x - mu)^2``, ``var = hi / C``.  Returns (mu, var), shape[:-1]."""
    x2, shape = _rows(x, "ff_norm_stats")
    C = x2.shape[1]
    mu = div_n(_fold_lanes(_lane_cascade(x2)).hi, C)
    d = x2 - mu[:, None]
    var = div_n(_fold_lanes(_lane_cascade(d * d)).hi, C)
    return mu.reshape(shape[:-1]), var.reshape(shape[:-1])


def ff_norm_stats(x: Tensor) -> Tuple[Tensor, Tensor]:
    """One-kernel compensated mean and centred variance over the last axis
    of an f32 tensor, bit for bit :func:`ff_norm_stats_plain`.

    On a CUDA tensor: one launch on ``row_plan``'s path (raises if it
    cannot launch); on a CPU tensor: the plain version.  Rows longer than
    ``MAX_FUSED_COLS`` raise ``ValueError``."""
    if x.device.type == "cpu":
        return ff_norm_stats_plain(x)
    x2, shape = _kernel_rows(x, "ff_norm_stats")
    R, C = x2.shape
    mu = torch.empty((R,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mu)
    if R and C:
        plan = _row_plan_of(x2, "norm_stats")
        _row_entry("ff_norm_stats", "ff_norm_stats_f32",
                   _NORM_STATS_ARGTYPES, x2, (mu, var),
                   _PATH_CODES[plan.path], plan.rows_per_block)
        ff_norm_stats.launches += 1
        ff_norm_stats.last_path = plan.path
    return mu.reshape(shape[:-1]), var.reshape(shape[:-1])


ff_norm_stats.launches = 0   # kernel launches since the last reset
ff_norm_stats.last_path = None   # the last launch's path (row_plan)


# -- run_program: the general ff.fusion Program executor ----------------------

# op codes of csrc/ff_program.cu (enum Op, same order)
PROGRAM_OPS = ("leaf_ff", "leaf_f32", "const", "fadd", "fsub", "fmul",
               "fdiv", "fneg", "fsqrt", "fexp", "flog", "add22", "add212",
               "mul22", "mul212", "div22", "sqrt22", "fma22", "neg22",
               "exp22", "log22", "tanh22", "sigmoid22", "lift", "hi", "lo",
               "pack", "rowsum")
MAX_INSTRS, MAX_PLANES, MAX_OUTS = 64, 32, 16  # the tape's capacity
_OUT_KINDS = {"f32": 0, "ff": 1, "red": 2}


class _Instr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int), ("a", ctypes.c_int * 3),
                ("imm", ctypes.c_float)]


class _Tape(ctypes.Structure):
    """``struct Tape`` of csrc/ff_program.cu, field for field."""
    _fields_ = [("n_instr", ctypes.c_int), ("n_out", ctypes.c_int),
                ("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
                ("ins", _Instr * MAX_INSTRS),
                ("plane", ctypes.c_void_p * MAX_PLANES),
                ("rs", ctypes.c_longlong * MAX_PLANES),
                ("cs", ctypes.c_longlong * MAX_PLANES),
                ("out_id", ctypes.c_int * MAX_OUTS),
                ("out_kind", ctypes.c_int * MAX_OUTS),
                ("red_width", ctypes.c_longlong * MAX_OUTS),
                ("out_hi", ctypes.c_void_p * MAX_OUTS),
                ("out_lo", ctypes.c_void_p * MAX_OUTS)]


# ff_program_f32(tape, stream); ff_program_tape_bytes()
_PROGRAM_ARGTYPES = [ctypes.POINTER(_Tape), ctypes.c_void_p]


def _unbroadcast(arr: Tensor, full_shape, nd) -> Tensor:
    """A value of true ND shape ``nd`` from its full-broadcast plane:
    along every dim the value broadcasts over, all slices are copies —
    take index 0."""
    if tuple(nd) == tuple(full_shape):
        return arr
    pad = len(full_shape) - len(nd)
    idx = tuple(
        slice(0, 1) if (1 if d < pad else nd[d - pad]) == 1 and size != 1
        else slice(None)
        for d, size in enumerate(full_shape))
    return arr[idx].reshape(nd)


def _program_layout(prog, operands: Sequence[Any], device: torch.device):
    """Flatten the operands to broadcastable 2-D planes.  Returns the
    planes, each leaf's plane indices, every value's ND shape, the
    broadcast shape and its (R, C)."""
    from repro_torch.ff import fusion
    raw: List[Tensor] = []
    leaf_planes: List[Tuple[int, ...]] = []
    for kind, x in zip(prog.leaf_kinds, fusion.leaf_values(operands,
                                                           device)):
        if kind == "ff":
            leaf_planes.append((len(raw), len(raw) + 1))
            raw += [x.hi.to(torch.float32), x.lo.to(torch.float32)]
        else:
            leaf_planes.append((len(raw),))
            raw.append(x)
    nd_shapes = fusion.infer_shapes(prog, [
        tuple((x.hi if isinstance(x, FF) else torch.as_tensor(x)).shape)
        for x in operands])
    planes, out_shape = broadcast_planes(raw)
    R = 1
    for d in out_shape[:-1]:
        R *= d
    C = out_shape[-1] if out_shape else 1
    return planes, leaf_planes, nd_shapes, out_shape, R, C


def _red_width(prog, nd_shapes, oid: int) -> int:
    """The width a rowsum output reduces: its value's own last dim (1 for
    a column-broadcast value), not the broadcast width."""
    vshape = nd_shapes[prog.instrs[oid].args[0]]
    return vshape[-1] if vshape else 1


def _program_outputs(prog, flat: Sequence, nd_shapes, out_shape, R, C):
    """Un-pad, un-broadcast and reshape the (R, C) / (R,) output planes."""
    outs: List[Any] = []
    lead = out_shape[:-1] if len(out_shape) else ()
    for oid, planes in zip(prog.out_ids, flat):
        nd = nd_shapes[oid]
        if prog.instrs[oid].op == "rowsum":
            outs.append(FF(*(_unbroadcast(p[:R].reshape(lead), lead, nd)
                             for p in planes)))
            continue
        vals = [_unbroadcast(p[:R, :C].reshape(out_shape), out_shape, nd)
                for p in planes]
        outs.append(FF(*vals) if len(vals) == 2 else vals[0])
    return outs


def run_program_plain(prog, operands: Sequence[Any]) -> List[Any]:
    """The Program kernel in PyTorch: every value over the broadcast
    planes through ``repro_torch.core`` ops, each rowsum in the 128-lane
    order, masked past its value's own width (the reference's
    ``run_pallas``).  Returns the outputs at their ``infer_shapes``
    shape."""
    from repro_torch.ff import fusion
    dev = fusion.operand_device(operands)
    planes, leaf_planes, nd_shapes, out_shape, R, C = _program_layout(
        prog, operands, dev)
    leaves = [FF(planes[ix[0]], planes[ix[1]]) if len(ix) == 2
              else planes[ix[0]] for ix in leaf_planes]
    env = fusion.eval_instrs(prog, leaves, lambda v: None, dev)
    full = lambda v: v.expand(R, C)        # noqa: E731
    flat = []
    for oid in prog.out_ids:
        ins = prog.instrs[oid]
        if ins.op == "rowsum":
            val = full(env[ins.args[0]])
            width = _red_width(prog, nd_shapes, oid)
            val = torch.where(torch.arange(C, device=val.device) < width,
                              val, 0.0)
            f = _fold_lanes(_lane_cascade(val))
            flat.append((f.hi, f.lo))
        elif ins.dtype == "ff":
            flat.append((full(env[oid].hi), full(env[oid].lo)))
        else:
            flat.append((full(env[oid]),))
    return _program_outputs(prog, flat, nd_shapes, out_shape, R, C)


def _check_tape_layout() -> None:
    """The kernel's ``struct Tape`` and :class:`_Tape` must agree."""
    n = build.entry("ff_program", "ff_program_tape_bytes", [])()
    if n != ctypes.sizeof(_Tape):
        raise RuntimeError(f"ff_program: the kernel's tape is {n} bytes, "
                           f"the wrapper's {ctypes.sizeof(_Tape)}")


def run_program(prog, operands: Sequence[Any]) -> List[Any]:
    """Run one ``ff.fusion`` Program as one kernel launch, as
    :func:`run_program_plain` (same arguments, same bits).

    On CUDA operands: one launch of ``csrc/ff_program.cu`` — elementwise
    over (R, C) without a rowsum, one block of 128 lanes per row with one
    — which raises if it cannot launch, or if the Program exceeds the
    tape (``MAX_INSTRS`` instructions, ``MAX_PLANES`` operand planes,
    ``MAX_OUTS`` outputs).  On CPU operands: the plain version."""
    from repro_torch.ff import fusion
    dev = fusion.operand_device(operands)
    if dev.type == "cpu":
        return run_program_plain(prog, operands)
    if dev.type != "cuda":
        raise RuntimeError(f"run_program: no kernel for device {dev}")
    planes, leaf_planes, nd_shapes, out_shape, R, C = _program_layout(
        prog, operands, dev)
    n_ins, n_out = len(prog.instrs), len(prog.out_ids)
    if n_ins > MAX_INSTRS or len(planes) > MAX_PLANES or n_out > MAX_OUTS:
        raise ValueError(
            f"run_program: {n_ins} instructions, {len(planes)} operand "
            f"planes, {n_out} outputs exceed the kernel's tape "
            f"({MAX_INSTRS}, {MAX_PLANES}, {MAX_OUTS})")
    if not hasattr(run_program, "_checked"):
        _check_tape_layout()
        run_program._checked = True
    tape = _Tape(n_instr=n_ins, n_out=n_out, rows=R, cols=C)
    for i, ins in enumerate(prog.instrs):
        args = (leaf_planes[int(ins.imm)] if ins.op.startswith("leaf_")
                else ins.args)
        tape.ins[i].op = PROGRAM_OPS.index(ins.op)
        for k, a in enumerate(args):
            tape.ins[i].a[k] = a
        tape.ins[i].imm = ins.imm if ins.op == "const" else 0.0
    for k, p in enumerate(planes):
        tape.plane[k] = p.data_ptr()
        tape.rs[k] = p.stride(0) if p.shape[0] != 1 else 0
        tape.cs[k] = p.stride(1) if p.shape[1] != 1 else 0
    flat = []
    for k, oid in enumerate(prog.out_ids):
        ins = prog.instrs[oid]
        kind = ("red" if ins.op == "rowsum" else ins.dtype)
        shape = (R,) if kind == "red" else (R, C)
        bufs = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                     for _ in range(1 if kind == "f32" else 2))
        tape.out_id[k] = oid
        tape.out_kind[k] = _OUT_KINDS[kind]
        tape.red_width[k] = (_red_width(prog, nd_shapes, oid)
                             if kind == "red" else 0)
        tape.out_hi[k] = bufs[0].data_ptr()
        tape.out_lo[k] = bufs[-1].data_ptr() if kind != "f32" else None
        flat.append(bufs)
    if R * C:
        with torch.cuda.device(dev):
            err = build.entry("ff_program", "ff_program_f32",
                              _PROGRAM_ARGTYPES)(
                ctypes.byref(tape), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"ff_program kernel launch failed: CUDA "
                               f"error {err}")
        run_program.launches += 1
    return _program_outputs(prog, flat, nd_shapes, out_shape, R, C)


run_program.launches = 0   # kernel launches since the last reset
