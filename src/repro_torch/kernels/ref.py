"""Oracles for the FF matmul and row-sum kernels (counterpart of
``repro.kernels.ref``): the same algorithms with no tiling, in the kernels'
K or lane order, so they agree with the kernels to the bits that order
decides.

``ref_ff_matmul`` is also the hybrid kernel's plain version
(``kernels.ff_matmul.ff_matmul_plain``), ``ref_ff_rowsum`` the row-sum
kernel's (``kernels.ff_reduce.ff_rowsum_plain``).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from repro_torch.core import transforms as T

Tensor = torch.Tensor


def fold_block_products(products: Iterable[Tensor], M: int, N: int,
                        device) -> Tuple[Tensor, Tensor]:
    """Fold f32 (M, N) block products, in order, into an FF accumulator
    from zero: TwoSum, one add, Fast2Sum each (the hybrid and Ozaki
    kernels' fold).  Returns (hi, lo)."""
    hi = torch.zeros((M, N), dtype=torch.float32, device=device)
    lo = torch.zeros_like(hi)
    for p in products:
        sh, sl = T.two_sum(hi, p)
        hi, lo = T.fast_two_sum(sh, sl + lo)
    return hi, lo


def ref_ff_matmul(a: Tensor, b: Tensor, bk: int = 512
                  ) -> Tuple[Tensor, Tensor]:
    """Oracle for the hybrid kernel: one f32 GEMM per K-block of ``bk``,
    each folded into the FF accumulator with TwoSum, one add and
    Fast2Sum, in K order.  Returns (hi, lo)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    M, K = a.shape
    N = b.shape[1]
    bk = min(bk, K)
    return fold_block_products(
        (torch.matmul(a[:, k0:k0 + bk], b[k0:k0 + bk])
         for k0 in range(0, K, bk)), M, N, a.device)


def ref_ff_matmul_dot2(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Oracle for the Dot2 kernel: per-element Mul12 and the Dot3
    (s, c, cc) cascade in K order, one rank-1 update at a time."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    M, K = a.shape
    N = b.shape[1]
    s = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    c, cc = torch.zeros_like(s), torch.zeros_like(s)
    for k in range(K):
        p, pe = T.two_prod(a[:, k, None], b[None, k, :])
        s, se = T.two_sum(s, p)
        c, ce = T.two_sum(c, se + pe)
        cc = cc + ce
    return T.fast_two_sum(s, c + cc)


def lane_cascade(val: Tensor, acc=None, lanes: int = 128):
    """Fold ``val`` (R, C) into ``lanes`` per-lane (s, c, cc) Neumaier
    accumulators, lane l taking columns l, l + lanes, ... in order (the
    reference's ``_lane_cascade``; zero padding past C adds nothing).
    ``acc``: accumulators to continue from.  Returns (s, c, cc), (R, lanes)
    each."""
    R, C = val.shape
    if C % lanes:
        val = torch.nn.functional.pad(val, (0, lanes - C % lanes))
    if acc is None:
        z = val.new_zeros((R, lanes))
        acc = (z, z, z)
    s, c, cc = acc
    for xt in val.reshape(R, -1, lanes).unbind(1):
        s, e = T.two_sum(s, xt)
        c, e2 = T.two_sum(c, e)
        cc = cc + e2
    return s, c, cc


def fold_lanes(acc) -> Tuple[Tensor, Tensor]:
    """Exact sequential fold of the lane accumulators, lane 0 first (the
    reference's ``_fold_lanes``): (R, lanes) x3 -> (hi, lo) per row."""
    s, c, cc = acc
    fh = fl = s.new_zeros(s.shape[0])
    for i in range(s.shape[1]):
        sh, sl = T.two_sum(fh, s[:, i])
        v = sl + (fl + c[:, i] + cc[:, i])
        fh, fl = T.fast_two_sum(sh, v)
    return fh, fl


def ref_ff_rowsum(x: Tensor, lane: int = 128) -> Tuple[Tensor, Tensor]:
    """Oracle for ff_rowsum: ``lane`` strided (s, c, cc) Neumaier cascades
    per row (at most C lanes), then the exact fold of the lanes, lane 0
    first.  Returns (hi, lo), (R,) each."""
    x = x.to(torch.float32)
    return fold_lanes(lane_cascade(x, lanes=min(lane, x.shape[1])))
