"""Lazy FF expression fusion: record a chain of elementwise FF ops, run it
as ONE kernel (counterpart of ``repro.ff.fusion``).

    import repro_torch.ff as ff

    @ff.fused
    def axpy(a, x, y):            # a: scalar, x/y: FF — classified per call
        return a * x + y          # Mul212 + Add22 in one kernel launch

    z = axpy(1.618, x, y)         # FF out; hi/lo read once, written once

``fused(fn)`` re-traces ``fn`` with :class:`FFExpr` stand-ins on every call
(cheap Python), producing a small straight-line :class:`Program`, which
runs on one of two executors, chosen by the operands' device:

  * **CUDA** (CUDA operands): ``repro_torch.kernels.ff_fused.run_program``,
    one launch of a fixed kernel that evaluates the Program's instruction
    tape per element (``csrc/ff_program.cu``), with the trailing row sums
    in the TPU kernel's 128-lane order.
  * **torch** (CPU operands): :func:`run_torch`, the same instruction list
    replayed through ``repro_torch.core`` ops — bitwise the op-by-op
    ``repro_torch.ff`` results (same algorithms, same order).

Supported ops, FF/f32 promotion and the trailing-``rowsum`` rule are the
reference's: ``+ - * /``, ``sqrt``, ``neg``, ``fma``, ``scale``,
``exp``/``log`` (FF nodes run ``exp22``/``log22`` and stay FF; f32 nodes
keep the f32 builtins), ``tanh``/``sigmoid`` (FF; f32 nodes are lifted),
``.hi``/``.lo``, ``pack``, and at most one trailing ``.sum()`` per output
(f32-valued nodes only).  A fused callable is a forward kernel with no
gradient, as in the reference (which has no rule for it): on either device
an operand that requires a gradient raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import compensated, ffmath
from repro_torch.core import ff as core_ff
from repro_torch.core.ff import FF

Tensor = torch.Tensor

# result planes per value dtype (the reference's VMEM budget unit)
_PLANES = {"ff": 2, "f32": 1}

# the FF transcendentals of repro_torch.core.ffmath usable in a chain
_DEEP_OPS = {"exp22", "log22", "tanh22", "sigmoid22"}
_DEEP_OP_PLANES = 8


class Instr(NamedTuple):
    op: str                  # e.g. "leaf_ff", "add22", "fmul", "rowsum", ...
    args: Tuple[int, ...]    # ids of input values
    imm: Optional[float]     # immediate (for "const"; leaf index for leaves)
    dtype: str               # "ff" | "f32"


class Program(NamedTuple):
    """A traced straight-line FF expression chain."""
    leaf_kinds: Tuple[str, ...]      # "ff" | "f32" | "scalar" per operand
    instrs: Tuple[Instr, ...]        # instr i produces value i
    out_ids: Tuple[int, ...]

    @property
    def reductions(self) -> Tuple[int, ...]:
        return tuple(i for i in self.out_ids
                     if self.instrs[i].op == "rowsum")

    def plane_count(self) -> int:
        """The reference's bound on simultaneously live full-size planes
        per block (its tile budget; kept so that the two packages' Programs
        compare equal): every instruction's result once, except rowsums,
        consts, scalar leaves and the hi/lo/pack views; ``lift`` counts
        its zero lo plane, a deep op 8 more."""
        n = 0
        for ins in self.instrs:
            op = ins.op
            if op in ("rowsum", "const", "hi", "lo", "pack"):
                continue
            if op in ("leaf_ff", "leaf_f32") \
                    and self.leaf_kinds[int(ins.imm)] == "scalar":
                continue
            n += 1 if op == "lift" else _PLANES[ins.dtype]
            if op in _DEEP_OPS:
                n += _DEEP_OP_PLANES
        return max(n, 1)


class _Trace:
    def __init__(self):
        self.instrs: List[Instr] = []

    def emit(self, op: str, args: Tuple[int, ...] = (),
             imm: Optional[float] = None, dtype: str = "f32") -> "FFExpr":
        self.instrs.append(Instr(op, args, imm, dtype))
        return FFExpr(self, len(self.instrs) - 1, dtype)


class FFExpr:
    """Tracer value inside a ``ff.fused`` function (FF- or f32-typed)."""

    __slots__ = ("_tr", "_id", "dtype")

    def __init__(self, tr: _Trace, vid: int, dtype: str):
        self._tr = tr
        self._id = vid
        self.dtype = dtype

    # -- limb views ----------------------------------------------------------
    @property
    def hi(self) -> "FFExpr":
        if self.dtype != "ff":
            return self
        return self._tr.emit("hi", (self._id,), dtype="f32")

    @property
    def lo(self) -> "FFExpr":
        if self.dtype != "ff":
            raise TypeError("f32 expression has no .lo limb")
        return self._tr.emit("lo", (self._id,), dtype="f32")

    def _node(self, x) -> "FFExpr":
        if isinstance(x, FFExpr):
            if x._tr is not self._tr:
                raise ValueError("mixing FFExpr values from different traces")
            return x
        try:
            return self._tr.emit("const", imm=float(x))
        except (TypeError, ValueError):
            raise TypeError(
                f"fused chains take FFExpr nodes or Python constants, got "
                f"{type(x).__name__}; pass dynamic values as operands of "
                f"the fused call") from None

    # -- arithmetic (promotion mirrors the dispatch's) -----------------------
    def __add__(self, other) -> "FFExpr":
        b = self._node(other)
        a = self
        if a.dtype == "ff" and b.dtype == "ff":
            return self._tr.emit("add22", (a._id, b._id), dtype="ff")
        if a.dtype == "ff":
            return self._tr.emit("add212", (a._id, b._id), dtype="ff")
        if b.dtype == "ff":
            return self._tr.emit("add212", (b._id, a._id), dtype="ff")
        return self._tr.emit("fadd", (a._id, b._id))

    __radd__ = __add__

    def __neg__(self) -> "FFExpr":
        op = "neg22" if self.dtype == "ff" else "fneg"
        return self._tr.emit(op, (self._id,), dtype=self.dtype)

    def __sub__(self, other) -> "FFExpr":
        b = self._node(other)
        if self.dtype == "f32" and b.dtype == "f32":
            return self._tr.emit("fsub", (self._id, b._id))
        return self + (-b)

    def __rsub__(self, other) -> "FFExpr":
        b = self._node(other)
        if self.dtype == "f32" and b.dtype == "f32":
            return self._tr.emit("fsub", (b._id, self._id))
        return b + (-self)

    def __mul__(self, other) -> "FFExpr":
        b = self._node(other)
        a = self
        if a.dtype == "ff" and b.dtype == "ff":
            return self._tr.emit("mul22", (a._id, b._id), dtype="ff")
        if a.dtype == "ff":
            return self._tr.emit("mul212", (a._id, b._id), dtype="ff")
        if b.dtype == "ff":
            return self._tr.emit("mul212", (b._id, a._id), dtype="ff")
        return self._tr.emit("fmul", (a._id, b._id))

    __rmul__ = __mul__

    def _lift(self) -> "FFExpr":
        if self.dtype == "ff":
            return self
        return self._tr.emit("lift", (self._id,), dtype="ff")

    def __truediv__(self, other) -> "FFExpr":
        b = self._node(other)
        if self.dtype == "ff" or b.dtype == "ff":
            a, b = self._lift(), b._lift()
            return self._tr.emit("div22", (a._id, b._id), dtype="ff")
        return self._tr.emit("fdiv", (self._id, b._id))

    def __rtruediv__(self, other) -> "FFExpr":
        return self._node(other).__truediv__(self)

    # -- trailing reduction --------------------------------------------------
    def sum(self) -> "FFExpr":
        """Compensated row sum over the LAST axis -> FF per row.  Must be
        returned directly (trailing); f32-valued nodes only."""
        if self.dtype == "ff":
            raise TypeError(
                "rowsum reduces f32-valued nodes (the op-by-op analogue "
                "ff.sum takes an f32 array); reduce .hi or restructure")
        return self._tr.emit("rowsum", (self._id,), dtype="ff")


# -- free-function helpers over tracer nodes ---------------------------------

def sqrt(x: FFExpr) -> FFExpr:
    op = "sqrt22" if x.dtype == "ff" else "fsqrt"
    return x._tr.emit(op, (x._id,), dtype=x.dtype)


def exp(x: FFExpr) -> FFExpr:
    """exp: FF nodes run ``exp22`` and stay FF; f32 nodes keep the f32
    builtin."""
    if x.dtype == "ff":
        return x._tr.emit("exp22", (x._id,), dtype="ff")
    return x._tr.emit("fexp", (x._id,))


def log(x: FFExpr) -> FFExpr:
    """log: FF nodes run ``log22``; f32 nodes keep the f32 builtin."""
    if x.dtype == "ff":
        return x._tr.emit("log22", (x._id,), dtype="ff")
    return x._tr.emit("flog", (x._id,))


def tanh(x: FFExpr) -> FFExpr:
    """FF tanh (``tanh22``); f32 nodes are lifted to FF first."""
    return x._tr.emit("tanh22", (x._lift()._id,), dtype="ff")


def sigmoid(x: FFExpr) -> FFExpr:
    """FF logistic sigmoid (``sigmoid22``); f32 nodes are lifted first."""
    return x._tr.emit("sigmoid22", (x._lift()._id,), dtype="ff")


def fma(a: FFExpr, b: FFExpr, c: FFExpr) -> FFExpr:
    """a*b + c with ONE renormalization (core fma22) when any node is FF."""
    tr = a._tr
    b, c = a._node(b), a._node(c)
    if a.dtype == b.dtype == c.dtype == "f32":
        return a * b + c
    a, b, c = a._lift(), b._lift(), c._lift()
    return tr.emit("fma22", (a._id, b._id, c._id), dtype="ff")


def scale(a: FFExpr, s) -> FFExpr:
    """a * s for an f32/scalar s (Mul212 when a is FF)."""
    return a * (a._node(s))


def pack(h: FFExpr, l: FFExpr) -> FFExpr:
    """Assemble an FF value from two f32 nodes (e.g. master hi/lo planes)."""
    if h.dtype != "f32" or l.dtype != "f32":
        raise TypeError("pack takes two f32 nodes")
    return h._tr.emit("pack", (h._id, l._id), dtype="ff")


def rowsum(x: FFExpr) -> FFExpr:
    return x.sum()


# ---------------------------------------------------------------------------
# tracing + execution
# ---------------------------------------------------------------------------

def _classify(x) -> str:
    if isinstance(x, FF):
        return "ff"
    return "scalar" if torch.as_tensor(x).shape == () else "f32"


def trace(fn: Callable, kinds: Sequence[str]) -> Tuple[Program, bool]:
    """Trace ``fn`` over leaves of the given kinds.  Returns the program
    and whether ``fn`` returned a tuple or list."""
    tr = _Trace()
    leaves = []
    for k, kind in enumerate(kinds):
        dtype = "ff" if kind == "ff" else "f32"
        leaves.append(tr.emit(f"leaf_{'ff' if kind == 'ff' else 'f32'}",
                              imm=float(k), dtype=dtype))
    out = fn(*leaves)
    flat = out if isinstance(out, (tuple, list)) else (out,)
    for o in flat:
        if not isinstance(o, FFExpr):
            raise TypeError(f"fused fn must return FFExpr nodes, got "
                            f"{type(o).__name__}")
        if o._tr is not tr:
            raise ValueError("fused fn returned a node from another trace")
    prog = Program(tuple(kinds), tuple(tr.instrs),
                   tuple(o._id for o in flat))
    # rowsum nodes must be trailing: nothing may consume them
    for ins in prog.instrs:
        for a in ins.args:
            if prog.instrs[a].op == "rowsum":
                raise ValueError("rowsum must be a trailing output, not an "
                                 "input to further ops")
    return prog, isinstance(out, (tuple, list))


def infer_shapes(prog: Program,
                 operand_shapes: Sequence[Tuple[int, ...]]
                 ) -> List[Tuple[int, ...]]:
    """Per-value ND broadcast shape given the call's operand shapes — the
    shapes :func:`run_torch` produces; the kernel executor uses them to
    extract each output from its full-broadcast planes."""
    shapes: List[Tuple[int, ...]] = []
    for ins in prog.instrs:
        op, args = ins.op, ins.args
        if op in ("leaf_ff", "leaf_f32"):
            s = tuple(operand_shapes[int(ins.imm)])
        elif op == "const":
            s = ()
        elif op == "rowsum":
            s = shapes[args[0]][:-1]
        elif len(args) == 1:
            s = shapes[args[0]]
        else:
            s = tuple(torch.broadcast_shapes(*(shapes[a] for a in args)))
        shapes.append(s)
    return shapes


def eval_instrs(prog: Program, leaves: Sequence[Any],
                rowsum: Callable[[Tensor], FF],
                device: torch.device) -> List[Any]:
    """Evaluate the program through ``repro_torch.core`` ops on the leaf
    values (FF or f32 tensors on ``device``); ``rowsum`` reduces a value's
    last axis.  Returns every value (FF or f32 tensor)."""
    env: List[Any] = []
    for ins in prog.instrs:
        op, args = ins.op, ins.args
        if op in ("leaf_ff", "leaf_f32"):
            v = leaves[int(ins.imm)]
        elif op == "const":
            v = torch.tensor(ins.imm, dtype=torch.float32, device=device)
        elif op == "fadd":
            v = env[args[0]] + env[args[1]]
        elif op == "fsub":
            v = env[args[0]] - env[args[1]]
        elif op == "fmul":
            v = env[args[0]] * env[args[1]]
        elif op == "fdiv":
            v = env[args[0]] / env[args[1]]
        elif op == "fneg":
            v = -env[args[0]]
        elif op == "fsqrt":
            v = core_ff.sqrt_rn(env[args[0]])
        elif op == "fexp":
            v = torch.exp(env[args[0]])
        elif op == "flog":
            v = torch.log(env[args[0]])
        elif op == "add22":
            v = core_ff.add22(env[args[0]], env[args[1]])
        elif op == "add212":
            v = core_ff.add212(env[args[0]], env[args[1]])
        elif op == "mul22":
            v = core_ff.mul22(env[args[0]], env[args[1]])
        elif op == "mul212":
            v = core_ff.mul212(env[args[0]], env[args[1]])
        elif op == "div22":
            v = core_ff.div22(env[args[0]], env[args[1]])
        elif op == "sqrt22":
            v = core_ff.sqrt22(env[args[0]])
        elif op == "fma22":
            v = core_ff.fma22(env[args[0]], env[args[1]], env[args[2]])
        elif op == "neg22":
            v = -env[args[0]]
        elif op in _DEEP_OPS:
            x = env[args[0]]
            v = FF(*getattr(ffmath, op)(x.hi, x.lo))
        elif op == "lift":
            x = env[args[0]]
            v = FF(x, torch.zeros_like(x))
        elif op == "hi":
            v = env[args[0]].hi
        elif op == "lo":
            v = env[args[0]].lo
        elif op == "pack":
            v = FF(env[args[0]], env[args[1]])
        elif op == "rowsum":
            v = rowsum(env[args[0]])
        else:                                          # pragma: no cover
            raise NotImplementedError(op)
        env.append(v)
    return env


def leaf_values(operands: Sequence[Any], device: torch.device
                ) -> List[Any]:
    """The operands as leaf values on ``device`` (see
    :func:`operand_device`): FF kept as FF, anything else an f32 tensor;
    a Python number or a 0-d CPU tensor is moved there."""
    return [FF(x.hi.to(device), x.lo.to(device)) if isinstance(x, FF)
            else torch.as_tensor(x, device=device).to(torch.float32)
            for x in operands]


def run_torch(prog: Program, operands: Sequence[Any]) -> List[Any]:
    """Replay the program through ``repro_torch.core`` ops — bitwise the
    op-by-op dispatch results; ``rowsum`` is ``ff_sum_blocked`` with
    block=128, as ``ff.sum(x, axis=-1, block=128)``."""
    dev = operand_device(operands)
    env = eval_instrs(prog, leaf_values(operands, dev), lambda v: (
        compensated.ff_sum_blocked(v, axis=-1, block=128)), dev)
    return [env[i] for i in prog.out_ids]


def operand_device(operands: Sequence[Any]) -> torch.device:
    """The device a call runs on: that of its tensor operands, a 0-d CPU
    tensor going with any device (as PyTorch takes a CPU scalar beside
    CUDA tensors); the CPU only when every tensor is there.  Raises on
    tensors of one or more dims on two devices."""
    devs = set()
    for x in operands:
        for t in (x.hi, x.lo) if isinstance(x, FF) else (x,):
            if isinstance(t, Tensor) and (t.dim() or t.device.type != "cpu"):
                devs.add(t.device)
    if len(devs) > 1:
        raise ValueError(f"ff.fused: operands on {sorted(map(str, devs))}")
    return devs.pop() if devs else torch.device("cpu")


class FusedFn:
    """A fused FF expression pipeline (see module docstring)."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self.__doc__ = fn.__doc__
        self.__name__ = getattr(fn, "__name__", "fused")

    def __call__(self, *operands):
        """Trace the wrapped fn over ``operands`` and run it fused.

        ``operands``: positional leaves — ``FF``, f32 tensor, or scalar;
        each is classified per call; one that requires a gradient raises.
        On CUDA operands: one launch of the Program kernel (raises if it
        cannot launch); on CPU operands: :func:`run_torch`.  Returns the
        wrapped fn's structure with FF for ff-typed nodes and rowsums,
        f32 tensors otherwise.  The kernel
        matches :func:`run_torch` bit for bit on elementwise chains and to
        the final rounding on rowsums (the lane order differs from
        ``ff_sum_blocked``'s fold)."""
        from repro_torch.kernels import ff_fused

        if torch.is_grad_enabled() and any(
                isinstance(t, Tensor) and t.requires_grad for x in operands
                for t in ((x.hi, x.lo) if isinstance(x, FF) else (x,))):
            raise NotImplementedError(
                f"ff.fused({self.__name__}) has no gradient (nor has the "
                f"reference's): call it on operands that need none")
        kinds = tuple(_classify(x) for x in operands)
        prog, multi = trace(self._fn, kinds)
        if operand_device(operands).type == "cpu":
            outs = run_torch(prog, operands)
        else:
            outs = ff_fused.run_program(prog, operands)
        return tuple(outs) if multi else outs[0]

    def program(self, *operands) -> Program:
        """The program this call signature would trace (introspection)."""
        return trace(self._fn, tuple(_classify(x) for x in operands))[0]


def fused(fn: Callable) -> FusedFn:
    """Decorator: compile an FF elementwise chain into one kernel.

    ``fn`` is a function over :class:`FFExpr` stand-ins using ``+ - * /``,
    :func:`sqrt`/:func:`exp`/:func:`log`/:func:`tanh`/:func:`sigmoid`/
    :func:`fma`/:func:`scale`/:func:`pack`, limb views ``.hi``/``.lo``,
    and at most one trailing ``.sum()`` row reduction per output.  Returns
    a :class:`FusedFn`: one kernel launch on the card, the bitwise
    op-by-op replay on the CPU.  Forward only: an operand that requires a
    gradient raises on either device."""
    return FusedFn(fn)
