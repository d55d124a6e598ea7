"""The three FF matmul kernels of ``repro.kernels.ff_matmul`` as CUDA
kernels, each with its plain version.

  * ``ff_matmul`` (hybrid, ``csrc/ff_matmul.cu``): one f32 block product per
    K-block of ``bk``, folded into an FF accumulator (TwoSum, one add,
    Fast2Sum) in K order.  ``bk`` is part of the numerics.  The block
    product's own rounding has no reference bits (the TPU sums in 6-pass
    bf16, cuBLAS and the kernel each in their own order), so the kernel is
    held to the error contract against its plain version, and to the bit on
    operands whose block products are exact (small integers).
  * ``ff_matmul_ozaki`` (``csrc/ff_matmul.cu``): the Ozaki slice-pair
    accumulation.  Torch does what the reference does in jnp around its
    kernel: the pair table, the slices over the full K and, after the
    kernel, the K-doubled residual GEMM and the final fold.  Every pair
    block product is exact, so the kernel and its plain version agree to
    the bit.
  * ``ff_matmul_dot2`` (``csrc/ff_matmul_dot2.cu``): per-element TwoProd, a
    pairwise compensated tree over each ``vec``-wide slab and the
    (s, c, cc) cascade across K; the kernel and its plain version run the
    same op sequence and agree to the bit (``vec`` changes bits, ``bk``
    does not).

Each wrapper launches its kernel on CUDA tensors (or raises) and takes the
plain version on CPU tensors; ``<wrapper>.launches`` counts launches.
``bm``/``bn`` are the reference's tile arguments: they change no bits, and
the CUDA kernels' output tiles are fixed.  The kernels read the operands
through their strides, so transposed views are not copied.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch.core import ffmatmul
from repro_torch.core import transforms as T
from repro_torch.kernels import build
from repro_torch.kernels.ref import fold_block_products, ref_ff_matmul

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# ff_matmul_f32(a, sa0, sa1, b, sb0, sb1, hi, lo, M, N, K, bk, stream)
_HYBRID_ARGTYPES = [_P, _I64, _I64, _P, _I64, _I64, _P, _P,
                    _I32, _I32, _I32, _I32, _P]
# ff_matmul_ozaki_f32(as, bs, si, sj, npairs, hi, lo, M, N, K, bk, stream);
# si, sj: host arrays of the pair table, passed to the kernel by value
_OZAKI_ARGTYPES = [_P, _P, _P, _P, _I32, _P, _P, _I32, _I32, _I32, _I32, _P]
OZAKI_MAX_PAIRS = 256     # the kernel's pair table (csrc/ff_matmul.cu)
# ff_matmul_dot2_f32(a, sa0, sa1, b, sb0, sb1, hi, lo, M, N, K, vec, stream)
_DOT2_ARGTYPES = _HYBRID_ARGTYPES
DOT2_MAX_VEC = 8          # the CUDA kernel is compiled for vec = 1..8


def _cuda_operands(name: str, *xs: Tensor) -> None:
    """Raise unless every operand is an f32 tensor on one CUDA device."""
    dev = xs[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for x in xs:
        if x.device != dev:
            raise RuntimeError(f"{name}: operands on {dev} and {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {x.dtype}")


def _mkn(name: str, a: Tensor, b: Tensor) -> Tuple[int, int, int]:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if max(M, K, N) >= 2 ** 31:
        raise ValueError(f"{name} kernel takes dimensions < 2^31")
    return M, K, N


def _launch(lib: str, fn: str, argtypes: List, dev: torch.device,
            *args) -> None:
    with torch.cuda.device(dev):
        err = build.entry(lib, fn, argtypes)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


def _outputs(a: Tensor, M: int, N: int) -> Pair:
    hi = torch.empty((M, N), dtype=torch.float32, device=a.device)
    return hi, torch.empty_like(hi)


# -- hybrid --------------------------------------------------------------------

def ff_matmul_plain(a: Tensor, b: Tensor, *, bk: int = 512) -> Pair:
    """The hybrid kernel's arithmetic in torch: ``ref_ff_matmul``."""
    return ref_ff_matmul(a, b, bk=bk)


def ff_matmul(a: Tensor, b: Tensor, *, bm: int = 256, bn: int = 256,
              bk: int = 512) -> Pair:
    """FF (M, N) = a (M, K) @ b (K, N), hybrid: f32 block products per
    K-block of ``bk``, FF-accumulated.  Returns (hi, lo).

    On CUDA tensors: one launch of the CUDA kernel (raises if it cannot
    launch); on CPU tensors: the plain version."""
    if a.device.type == "cpu":
        return ff_matmul_plain(a, b, bk=bk)
    _cuda_operands("ff_matmul", a, b)
    M, K, N = _mkn("ff_matmul", a, b)
    if bk < 1:
        raise ValueError(f"ff_matmul: bk must be positive, got {bk}")
    hi, lo = _outputs(a, M, N)
    _launch("ff_matmul", "ff_matmul_f32", _HYBRID_ARGTYPES, a.device,
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            hi.data_ptr(), lo.data_ptr(), M, N, K, min(bk, max(K, 1)))
    ff_matmul.launches += 1
    return hi, lo


ff_matmul.launches = 0    # kernel launches since the last reset


# -- Ozaki ---------------------------------------------------------------------

def ozaki_pairs(n: int, max_order: int) -> List[Tuple[int, int]]:
    """The slice pairs the kernel accumulates, in its order: every (i, j)
    with ``i + j <= max_order``, sorted by (i + j, i)."""
    return sorted(((i, j) for i in range(n) for j in range(n)
                   if i + j <= max_order),
                  key=lambda q: (q[0] + q[1], q[0]))


def _ozaki(a: Tensor, b: Tensor, slices: int, beta: int, bk: int,
           accumulate) -> Pair:
    """The reference's wrapper around its Ozaki kernel: slice both
    operands over the full K, accumulate the kept slice pairs per K-block
    in FF (``accumulate``: the kernel or its plain version), then fold in
    the K-doubled residual GEMM ``[ra, a - ra] @ [b; rb]``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    M, K, N = _mkn("ff_matmul_ozaki", a, b)
    n, beta, bk, max_order = ffmatmul.ozaki_params(
        K, slices=slices, beta=beta, block_k=min(bk, max(K, 1)))
    pa, ra = ffmatmul.extract_slices(a, 1, n, beta)
    pb, rb = ffmatmul.extract_slices(b, 0, n, beta)
    oh, ol = accumulate(torch.stack(pa), torch.stack(pb),
                        ozaki_pairs(n, max_order), bk)
    res = torch.matmul(torch.cat([ra, a - ra], 1), torch.cat([b, rb], 0))
    sh, sl = T.two_sum(oh, res)
    return T.fast_two_sum(sh, sl + ol)


def ozaki_accumulate_plain(As: Tensor, Bs: Tensor,
                           pairs: List[Tuple[int, int]], bk: int) -> Pair:
    """The pair accumulation in torch: for each K-block, for each pair in
    table order, the exact slice-pair GEMM folded into the FF accumulator
    (``fold_block_products``, the hybrid plain version's fold)."""
    K = As.shape[2]
    return fold_block_products(
        (torch.matmul(As[i, :, k0:k0 + bk], Bs[j, k0:k0 + bk])
         for k0 in range(0, K, bk) for i, j in pairs),
        As.shape[1], Bs.shape[2], As.device)


def ozaki_accumulate(As: Tensor, Bs: Tensor, pairs: List[Tuple[int, int]],
                     bk: int) -> Pair:
    """The pair accumulation as one launch of the CUDA kernel.  ``As``:
    (n, M, K) and ``Bs``: (n, K, N) slices (made contiguous).  The pair
    table goes to the kernel by value, in its launch parameters."""
    _cuda_operands("ff_matmul_ozaki", As, Bs)
    As, Bs = As.contiguous(), Bs.contiguous()
    _, M, K = As.shape
    N = Bs.shape[2]
    _mkn("ff_matmul_ozaki", As[0], Bs[0])
    if not 0 < len(pairs) <= OZAKI_MAX_PAIRS or max(map(max, pairs)) > 255:
        raise ValueError(f"ff_matmul_ozaki kernel takes 1..{OZAKI_MAX_PAIRS}"
                         f" pairs of slices < 256, got {len(pairs)}")
    si, sj = ((ctypes.c_ubyte * len(pairs))(*col) for col in zip(*pairs))
    hi, lo = _outputs(As, M, N)
    _launch("ff_matmul", "ff_matmul_ozaki_f32", _OZAKI_ARGTYPES, As.device,
            As.data_ptr(), Bs.data_ptr(), ctypes.addressof(si),
            ctypes.addressof(sj), len(pairs), hi.data_ptr(), lo.data_ptr(),
            M, N, K, bk)
    ff_matmul_ozaki.launches += 1
    return hi, lo


def ff_matmul_ozaki_plain(a: Tensor, b: Tensor, *, slices: int = 0,
                          beta: int = 0, bk: int = 512) -> Pair:
    """The Ozaki kernel's wrapper with the pair accumulation in torch."""
    return _ozaki(a, b, slices, beta, bk, ozaki_accumulate_plain)


def ff_matmul_ozaki(a: Tensor, b: Tensor, *, slices: int = 0, beta: int = 0,
                    bm: int = 128, bn: int = 128, bk: int = 512) -> Pair:
    """Ozaki FF matmul: exact slice-pair block products FF-accumulated per
    K-block of ``bk`` (pairs with beta*(i+j) > 50 skipped), plus the f32
    residual GEMM.  Returns (hi, lo).

    On CUDA tensors the pair accumulation is one launch of the CUDA kernel
    (raises if it cannot launch); on CPU tensors the plain version."""
    if a.device.type == "cpu":
        return ff_matmul_ozaki_plain(a, b, slices=slices, beta=beta, bk=bk)
    _cuda_operands("ff_matmul_ozaki", a, b)
    return _ozaki(a, b, slices, beta, bk, ozaki_accumulate)


ff_matmul_ozaki.launches = 0


# -- Dot2 ----------------------------------------------------------------------

def dot2_vec(K: int, bk: int, vec: int) -> int:
    """The slab width the reference's kernel uses: ``vec`` lowered to the
    largest divisor of ``min(bk, K)`` (it changes bits; ``bk`` does not)."""
    bk = min(bk, K)
    vec = max(1, min(vec, bk))
    while bk % vec:
        vec -= 1
    return vec


def ff_matmul_dot2_plain(a: Tensor, b: Tensor, *, bk: int = 128,
                         vec: int = 8) -> Pair:
    """The Dot2 kernel's arithmetic in torch: ``matmul_dot2`` over slabs of
    the kernel's width."""
    r = ffmatmul.matmul_dot2(a, b, chunk=dot2_vec(a.shape[1], bk, vec))
    return r.hi, r.lo


def ff_matmul_dot2(a: Tensor, b: Tensor, *, bm: int = 128, bn: int = 128,
                   bk: int = 128, vec: int = 8) -> Pair:
    """Paper-faithful FF matmul: exact products (TwoProd), a pairwise
    compensated tree per ``vec``-wide slab, a TwoSum cascade across K.
    Returns (hi, lo).

    On CUDA tensors: one launch of the CUDA kernel (raises if it cannot
    launch, or if the slab is wider than ``DOT2_MAX_VEC``); on CPU tensors:
    the plain version."""
    if a.device.type == "cpu":
        return ff_matmul_dot2_plain(a, b, bk=bk, vec=vec)
    _cuda_operands("ff_matmul_dot2", a, b)
    M, K, N = _mkn("ff_matmul_dot2", a, b)
    v = dot2_vec(K, bk, vec)
    if v > DOT2_MAX_VEC:
        raise ValueError(f"ff_matmul_dot2 kernel takes vec <= "
                         f"{DOT2_MAX_VEC}, got {v}")
    hi, lo = _outputs(a, M, N)
    _launch("ff_matmul_dot2", "ff_matmul_dot2_f32", _DOT2_ARGTYPES, a.device,
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            hi.data_ptr(), lo.data_ptr(), M, N, K, v)
    ff_matmul_dot2.launches += 1
    return hi, lo


ff_matmul_dot2.launches = 0
