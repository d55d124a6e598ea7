"""The FF health probe's flag plane as one CUDA kernel
(``csrc/ff_guard.cu``), with its plain version (counterpart of
``repro.kernels.ff_guard``).

One pass over the (hi, lo) limb planes gives an f32 flag plane of the
same shape with codes 0..7: bit 0 a non-finite limb, bit 1 a
normalization violation (``|lo| > 2^-24 |hi|``, the multiplicative
surrogate for ``|lo| <= ulp(hi)/2``: exact for a power-of-two ``hi``,
within one binade elsewhere), bit 2 a subnormal ``lo`` (a flush-to-zero
hazard, not a violation).  NaN and Inf limbs set bit 0 only.

The subnormal test reads the exponent and mantissa bits of ``lo``, never
a float compare.  The normalization compare is IEEE on both devices: a
subnormal ``|lo|`` beside ``hi = 0`` (or a ``|hi|`` so small that the
bound underflows) sets bit 1, where the reference's XLA:CPU reads the
subnormal as zero and sets bit 2 alone (code 4 there, 6 here; ROADMAP,
caveats on the reference).

On CUDA tensors ``guard_flags`` launches the kernel (or raises); on CPU
tensors it takes the plain version ``guard_flags_plain``.
``guard_flags.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

#: |lo| <= HALF_ULP_SURROGATE * |hi| accepts every normalized pair and
#: flags anything at least 2x out of normalization (see module doc)
HALF_ULP_SURROGATE = 2.0 ** -24
#: smallest normal f32: anything smaller (and non-zero) is subnormal
MIN_NORMAL_F32 = 2.0 ** -126


def flag_planes(hi: Tensor, lo: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The three boolean violation planes of an FF limb pair:
    ``(nonfinite, unnormalized, denormal_lo)``.  NaN/Inf limbs count only
    as ``nonfinite``."""
    hi = torch.as_tensor(hi, dtype=torch.float32)
    lo = torch.as_tensor(lo, dtype=torch.float32)
    finite = torch.isfinite(hi) & torch.isfinite(lo)
    unnorm = finite & (lo.abs() > hi.abs() * HALF_ULP_SURROGATE)
    # the arithmetic shift of a negative lo fills ones above bit 31, which
    # the 0xFF mask drops
    bits = lo.view(torch.int32)
    denorm = finite & (((bits >> 23) & 0xFF) == 0) & ((bits & 0x7FFFFF) != 0)
    return ~finite, unnorm, denorm


def guard_flags_plain(hi: Tensor, lo: Tensor) -> Tensor:
    """The kernel in PyTorch: ``nonfinite + 2 unnormalized + 4
    denormal_lo`` as f32."""
    nf, un, dn = flag_planes(hi, lo)
    return (nf.to(torch.float32) + 2.0 * un.to(torch.float32)
            + 4.0 * dn.to(torch.float32))


def guard_flags(hi: Tensor, lo: Tensor, block=None) -> Tensor:
    """The flag plane (shape of ``hi``, f32 codes 0..7) of an FF limb pair.

    On CUDA tensors: one launch of ``csrc/ff_guard.cu`` (raises if it
    cannot launch); on CPU tensors: the plain version.  ``block`` (the
    TPU kernel's tile) is accepted for the reference's signature and does
    not change the launch."""
    hi = torch.as_tensor(hi, dtype=torch.float32)
    lo = torch.as_tensor(lo, dtype=torch.float32)
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError(f"guard_flags: hi {tuple(hi.shape)} on {hi.device}"
                         f", lo {tuple(lo.shape)} on {lo.device}")
    if hi.device.type == "cpu":
        return guard_flags_plain(hi, lo)
    if hi.device.type != "cuda":
        raise RuntimeError(f"guard_flags: no kernel for device {hi.device}")
    hi, lo = hi.contiguous(), lo.contiguous()
    out = torch.empty_like(hi)
    if hi.numel() == 0:
        return out
    with torch.cuda.device(hi.device):
        err = build.entry("ff_guard", "ff_guard_f32",
                          [ctypes.c_void_p] * 3
                          + [ctypes.c_longlong, ctypes.c_void_p])(
            hi.data_ptr(), lo.data_ptr(), out.data_ptr(), hi.numel(),
            torch.cuda.current_stream(hi.device).cuda_stream)
    if err:
        raise RuntimeError(f"ff_guard kernel launch failed: CUDA error {err}")
    guard_flags.launches += 1
    return out


guard_flags.launches = 0   # kernel launches since the last reset
