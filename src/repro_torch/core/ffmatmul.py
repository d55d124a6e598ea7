"""FF matrix multiplication in eager PyTorch (counterpart of
``repro.core.ffmatmul``; the algorithms and their op order are the
reference's).

* ``matmul_compensated`` — blocked K: each K-block is one f32 GEMM, the
  blocks are folded with Add22 (the hybrid scheme's formulation).
* ``matmul_split``       — Dekker-split operands: the three significant cross
  terms are exact-product GEMMs combined in FF.
* ``matmul_dot2``        — per-element Dot2 (two_prod and a pairwise
  compensated tree per K-slab, a Dot3 cascade across slabs).
* ``matmul_ozaki``       — exponent-aligned slices whose pair products and
  in-chunk sums are exact in f32 GEMMs (``ozaki_params``,
  ``extract_slices``), plus an f32 residual correction.
* ``matmul_f64``         — one float64 GEMM rounded to FF: the H100 has f64
  units, so this is a real device tier here.

All take f32 (M, K) x (K, N) tensors and return FF (M, N).  The f32 GEMMs
are ``torch.matmul`` with TF32 off (set when ``repro_torch`` is imported):
the reference leaves the same products to XLA, outside any kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import transforms as T
from repro_torch.core.ff import FF, add22

Tensor = torch.Tensor


def _dot_f32(a: Tensor, b: Tensor) -> Tensor:
    """IEEE f32 GEMM (TF32 is off process-wide in ``repro_torch``)."""
    return torch.matmul(a, b)


def _f32_operands(a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"FF matmul takes (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    return a, b


def _k_blocks(K: int, block_k: int):
    """The K ranges of ``ceil(K / block_k)`` blocks (the last may be
    short: the reference pads it with zeros, which adds nothing)."""
    return [(lo, min(lo + block_k, K)) for lo in range(0, K, block_k)]


def matmul_compensated(a: Tensor, b: Tensor, block_k: int = 512) -> FF:
    """Blocked-K FF-accumulated matmul: one f32 GEMM per K-block, folded
    with Add22 in K order.  A single block is ``FF(a @ b, 0)``, as in the
    reference (its fold with exact zeros is that pair)."""
    a, b = _f32_operands(a, b)
    M, K = a.shape
    N = b.shape[1]
    if K <= block_k:
        p = _dot_f32(a, b)
        return FF(p, torch.zeros_like(p))
    acc = FF.zeros((M, N), device=a.device)
    for lo, hi in _k_blocks(K, block_k):
        acc = add22(acc, FF.from_f32(_dot_f32(a[:, lo:hi], b[lo:hi])))
    return acc


def matmul_split(a: Tensor, b: Tensor, block_k: Optional[int] = 512) -> FF:
    """Split-operand FF matmul: a = a_hi + a_lo, b = b_hi + b_lo (12-bit
    Dekker halves), so the four cross-term GEMMs have exact products; they
    are combined with Add22, per K-block when ``block_k`` is set."""
    a, b = _f32_operands(a, b)
    M, K = a.shape
    N = b.shape[1]
    a_hi, a_lo = T.split(a)
    b_hi, b_lo = T.split(b)

    def partials(ah, al, bh, bl) -> FF:
        hh = _dot_f32(ah, bh)
        hl = _dot_f32(ah, bl)
        lh = _dot_f32(al, bh)
        ll = _dot_f32(al, bl)
        t = add22(FF.from_f32(hl), FF.from_f32(lh))
        t = add22(t, FF.from_f32(ll))
        return add22(FF.from_f32(hh), t)

    if block_k is None or block_k >= K:
        return partials(a_hi, a_lo, b_hi, b_lo)
    acc = FF.zeros((M, N), device=a.device)
    for lo, hi in _k_blocks(K, block_k):
        acc = add22(acc, partials(a_hi[:, lo:hi], a_lo[:, lo:hi],
                                  b_hi[lo:hi], b_lo[lo:hi]))
    return acc


def matmul_dot2(a: Tensor, b: Tensor, chunk: int = 32) -> FF:
    """Per-element Dot2 matmul (~2^-44 relative): each K-slab of ``chunk``
    products is formed exactly with two_prod and reduced with the pairwise
    compensated tree, the slab errors seeded with the product errors; the
    slabs feed an (s, c, cc) cascade.  A short last slab is padded with
    zeros, as the reference pads K (the tree's pairing depends on it).
    Live state is (M, chunk, N): for small, numerically critical
    products."""
    a, b = _f32_operands(a, b)
    M, K = a.shape
    N = b.shape[1]
    chunk = max(1, min(chunk, K))
    z = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    s, c, cc = z, z, z
    for lo, hi in _k_blocks(K, chunk):
        ai, bi = a[:, lo:hi], b[lo:hi]
        if hi - lo < chunk:
            ai = F.pad(ai, (0, chunk - (hi - lo)))
            bi = F.pad(bi, (0, 0, 0, chunk - (hi - lo)))
        p, pe = T.two_prod(ai[:, :, None], bi[None, :, :])    # (M, c, N)
        ps, pe = T.pairwise_sum_compensated(p, 1, T.sum_in_order(pe, 1))
        s, se = T.two_sum(s, ps)
        c, ce = T.two_sum(c, se + pe)
        cc = cc + ce
    rh, rl = T.fast_two_sum(s, c + cc)
    return FF(rh, rl)


# ---------------------------------------------------------------------------
# Ozaki scheme
# ---------------------------------------------------------------------------

def ozaki_params(K: int, slices: int = 0, beta: int = 0,
                 block_k: int = 0) -> Tuple[int, int, int, int]:
    """Slicing parameters ``(slices, beta, block_k, max_order)`` for the
    Ozaki matmul (the reference's heuristic, rule for rule).

    Exactness budget: a slice holds at most ``2^(beta-1)`` quanta, so a
    slice-pair product summed over a K-chunk of ``block_k`` terms stays
    below f32's exact-integer ceiling 2^24 iff
    ``2*beta + ceil(log2 block_k) <= 26``.  Defaults: ``block_k =
    min(K, 1024)``, the widest ``beta`` the budget admits, ``slices =
    ceil(24 / beta)`` (one more when coverage is under 27 bits and K <=
    512).  Pairs with ``beta*(i+j) > 50`` fall below FF precision and are
    skipped: ``max_order = 50 // beta``.
    """
    K = max(int(K), 1)
    bk = int(block_k) or min(K, 1024)
    bk = min(bk, K)
    t = math.ceil(math.log2(max(bk, 2)))
    beta = int(beta) or max(2, (26 - t) // 2)
    if 2 * beta + t > 26:
        raise ValueError(
            f"ozaki exactness budget violated: 2*beta + ceil(log2 block_k) "
            f"= {2 * beta + t} > 26 (beta={beta}, block_k={bk}); slice-pair "
            f"block sums would round inside the 'exact' GEMMs — lower beta "
            f"or block_k")
    n = int(slices)
    if not n:
        n = max(2, -(-24 // beta))
        if n * beta < 27 and K <= 512:
            n += 1                      # small-K margin slice
    max_order = max(1, 50 // beta)
    return n, beta, bk, max_order


def suggest_slices(a, b, block_k: int = 0) -> int:
    """Slice count for operands with a wide within-row (or within-column)
    exponent range: every ``beta`` bits of median spread beyond 4 costs
    one more slice (host-side; reads the values)."""
    a = np.asarray(torch.as_tensor(a).detach().cpu())
    b = np.asarray(torch.as_tensor(b).detach().cpu())
    K = a.shape[-1]
    n, beta, bk, _ = ozaki_params(K, block_k=block_k)

    def spread(x, axis):
        ax = np.abs(x)
        hi = ax.max(axis=axis)
        tiny = np.finfo(np.float32).tiny
        lo = np.where(ax > 0, ax, np.inf).min(axis=axis)
        s = np.log2(np.maximum(hi, tiny)) - np.log2(np.maximum(lo, tiny))
        s = s[np.isfinite(s)]
        return float(np.median(s)) if s.size else 0.0

    extra = max(0.0, max(spread(a, -1), spread(b, -2)) - 4.0)
    return min(n + int(math.ceil(extra / beta)), max(n, 50 // beta))


def _sigma(e: Tensor) -> Tensor:
    """Exactly ``1.5 * 2^e`` as f32 for integer ``e``, built from the
    exponent bits: 0 below the normal range (where XLA:CPU flushes) and
    inf above it."""
    e = e.to(torch.int32)
    v = (((e.clamp(-126, 127) + 127) << 23) | 0x400000).view(torch.float32)
    v = torch.where(e > 127, torch.full_like(v, math.inf), v)
    return torch.where(e < -126, torch.zeros_like(v), v)


def _ceil_log2(mu: Tensor) -> Tensor:
    """``ceil(log2 mu)`` as int32, exactly, for positive normal f32 ``mu``
    (from ``frexp``: mu = m * 2^e with m in [0.5, 1)); -1 for a zero."""
    m, e = torch.frexp(mu)
    return torch.where(m > 0.5, e, e - 1).to(torch.int32)


def slice_exponent(x: Tensor, axis: int) -> Tensor:
    """The slices' alignment ``ie = ceil(log2 max|x|)`` along ``axis``
    (kept as a dimension of size 1), int32, exactly (``_ceil_log2``)."""
    return _ceil_log2(torch.amax(x.abs(), dim=axis, keepdim=True))


def extract_slices(x: Tensor, axis: int, n: int, beta: int,
                   ie: Tensor = None) -> Tuple[List[Tensor], Tensor]:
    """``n`` exponent-aligned slices of at most ``beta`` bits each, plus
    the residual (the reference's ``extract_slices``, bit for bit on
    normal-range inputs).

    ``sigma_i = 1.5 * 2^(e + 24 - beta*(i+1))`` with ``e = ceil(log2
    max|x|)`` along ``axis``: ``(r + sigma) - sigma`` rounds r to the slice
    granularity, each slice is at most 2^(beta-1) quanta, and each
    ``r - w`` is exact.  The reference takes ``e`` from an f32 log2 and
    repairs it with an exact power-of-two compare; here it comes exactly
    from ``frexp``, and the powers of two from the exponent bits.  A zero
    row or column gives zero slices.  ``ie``: ``slice_exponent(x, axis)``,
    when the caller has it already.
    """
    if ie is None:
        ie = slice_exponent(x, axis)
    parts = []
    r = x
    for i in range(n):
        sigma = _sigma(ie + (24 - beta * (i + 1)))
        w = (r + sigma) - sigma
        parts.append(w)
        r = r - w
    return parts, r


def matmul_ozaki(a: Tensor, b: Tensor, slices: int = 0, *, beta: int = 0,
                 block_k: int = 0) -> FF:
    """Ozaki-scheme FF matmul (~2^-46 of |A||B|): slices aligned per
    (row, K-chunk) and (K-chunk, column); all pair products of all chunks
    as one batched GEMM of slices stacked along M and N, which is exact;
    two batched f32 residual GEMMs ``ra@b + a@rb`` (the ~2^-48 ``ra@rb``
    is dropped); every kept pair block and residual block folded with one
    pairwise compensated tree, then TwoSum."""
    a, b = _f32_operands(a, b)
    M, K = a.shape
    N = b.shape[1]
    n, beta, bk, max_order = ozaki_params(K, slices=slices, beta=beta,
                                          block_k=block_k)
    nc = -(-K // bk)
    pad = nc * bk - K
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    a3 = a.reshape(M, nc, bk).transpose(0, 1)             # (nc, M, bk)
    b3 = b.reshape(nc, bk, N)                             # (nc, bk, N)
    pa, ra3 = extract_slices(a3, 2, n, beta)
    pb, rb3 = extract_slices(b3, 1, n, beta)
    G = torch.bmm(torch.cat(pa, dim=1), torch.cat(pb, dim=2))
    G = G.reshape(nc, n, M, n, N)                         # exact pair blocks
    res1 = torch.bmm(ra3, b3)
    res2 = torch.bmm(a3, rb3)
    keep = [i * n + j for i in range(n) for j in range(n)
            if i + j <= max_order]
    blocks = G.permute(1, 3, 0, 2, 4).reshape(n * n, nc, M, N)[keep]
    blocks = torch.cat([blocks.reshape(-1, M, N), res1, res2], dim=0)
    s, e = T.pairwise_sum_compensated(blocks, 0)
    rh, rl = T.two_sum(s, e)
    return FF(rh, rl)


def matmul_f64(a: Tensor, b: Tensor) -> FF:
    """One float64 GEMM rounded to FF (~2^-48 relative): every f32 product
    is exact in f64 and the K sum rounds at 2^-53 per step.  The H100 has
    f64 units, so this is the accurate tier at hardware speed there, as on
    the CPU."""
    a, b = _f32_operands(a, b)
    r = torch.matmul(a.double(), b.double())
    hi = r.float()
    lo = (r - hi.double()).float()
    return FF(hi, lo)
