"""Two programs of the reference's fused executor as CUDA kernels, each
with its plain version.

Counterparts of ``repro.kernels.ff_fused.run_pallas`` on the two programs
the TPU runs by default on the model paths; the general Program executor
is not ported yet.

  * ``mean_sq``, the FF RMSNorm statistic ``(x*x).sum() / C``
    (``csrc/ff_mean_sq.cu``).  The kernel keeps the TPU kernel's 128
    lanes and their fold order; the plain version is the reference's CPU
    formulation ``ff_sum_blocked(x*x, block=128)``.  The two agree to
    <= 1 ulp of the f32 result (the reference's own bound for the two
    orders), in practice to the bit.
  * ``adamw_update``, the AdamW leaf update with an FF master weight
    (``csrc/ff_adamw.cu``).  Purely elementwise and correctly rounded op
    by op, so the kernel and the plain version (``_adamw_chain`` of
    ``repro.ff.dispatch``, same op order) agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import compensated
from repro_torch.core import ff as core_ff
from repro_torch.core.ff import FF
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


# -- adamw_update: the FF-master-weight AdamW leaf update ---------------------

# ff_adamw_f32(g, m, v, w, wlo, scal, eps, wd, n, stream)
_ADAMW_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float] * 2
                   + [ctypes.c_longlong, ctypes.c_void_p])


def f32_scalar(x: float) -> float:
    """``x`` rounded to the nearest f32, as JAX rounds a weak-typed Python
    float in an f32 expression."""
    return float(torch.tensor(x, dtype=torch.float32))


def _scalar(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(())


def sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded f32 square root.  PyTorch's vectorised CPU
    ``sqrt`` is not (it is within ~0.5001 ulp); the f64 root of an f32
    rounds back to the correctly rounded f32 (53 >= 2*24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


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
    with torch.cuda.device(g.device):
        err = build.entry("ff_adamw", "ff_adamw_f32", _ADAMW_ARGTYPES)(
            *(t.data_ptr() for t in (g, m, v, w, wlo, scal)),
            f32_scalar(eps), f32_scalar(wd), g.numel(),
            torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"ff_adamw kernel launch failed: CUDA error "
                           f"{err}")
    adamw_update.launches += 1


adamw_update.launches = 0   # kernel launches since the last reset
