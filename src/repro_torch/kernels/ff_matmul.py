"""The three FF matmul kernels of ``repro.kernels.ff_matmul`` as CUDA
kernels, each with its plain version.

  * ``ff_matmul`` (hybrid, ``csrc/ff_matmul.cu``): one f32 block product per
    K-block of ``bk``, folded into an FF accumulator (TwoSum, one add,
    Fast2Sum) in K order.  ``bk`` is part of the numerics.  The block
    product's own rounding has no reference bits (the TPU sums in 6-pass
    bf16, cuBLAS and the kernel each in their own order), so the kernel is
    held to the error contract against its plain version, and to the bit on
    operands whose block products are exact (small integers).  Each block
    product is one FMA chain in k order, so the output tile and the split of
    the K-blocks (``hybrid_plan``) change no bits: the kernel is bit for bit
    its earlier design, kept as the check kernel
    ``ff_matmul_hybrid_check``.
  * ``ff_matmul_ozaki`` (``csrc/ff_matmul_ozaki.cu``): the Ozaki
    slice-pair accumulation on the fp16 tensor cores.  Torch does what the
    reference does in jnp around its kernel: the pair table, the slices over
    the full K and, after the kernel, the K-doubled residual GEMM and the
    final fold; ``ozaki_operands`` writes each slice as integers
    ``q = w 2^-g`` in fp16 (exact: ``|q| <= 2^(beta-1)``, beta <= 12) with
    its exponents ``g``, both K-major.  Every pair block product is exact,
    so the kernel and its plain version (``ozaki_accumulate_plain``, the
    f32 slices' GEMMs) agree to the bit wherever the products' quantum
    ``2^(ga + gb)`` is at least 2^-149.
  * ``ff_matmul_dot2`` (``csrc/ff_matmul_dot2.cu``): per-element TwoProd, a
    pairwise compensated tree over each ``vec``-wide slab and the
    (s, c, cc) cascade across K; the kernel and its plain version run the
    same op sequence and agree to the bit (``vec`` changes bits, ``bk``
    does not).

Each wrapper launches its kernel on CUDA tensors (or raises) and takes the
plain version on CPU tensors; ``<wrapper>.launches`` counts launches.
``bm``/``bn`` are the reference's tile arguments: they change no bits, and
the CUDA kernels' output tiles are fixed.  The hybrid and Dot2 kernels
read the operands through their strides, so transposed views are not
copied.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.core import ffmatmul
from repro_torch.core import transforms as T
from repro_torch.kernels import build
from repro_torch.kernels.ref import fold_block_products, ref_ff_matmul

Tensor = torch.Tensor
Pair = Tuple[Tensor, Tensor]

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# ff_matmul_f32(a, sa0, sa1, b, sb0, sb1, hi, lo, M, N, K, bk, splits, ws,
# stream)
_HYBRID_ARGTYPES = [_P, _I64, _I64, _P, _I64, _I64, _P, _P,
                    _I32, _I32, _I32, _I32, _I32, _P, _P]
# csrc/ff_matmul.cu's Shipped configuration: its output tile (rows,
# columns), the blocks that fit an SM, and those of a split (which leaves
# the FF accumulator's shared memory out)
HYBRID_TILE = (128, 64)
HYBRID_BLOCKS_PER_SM = 2
HYBRID_SPLIT_BLOCKS_PER_SM = 3
# ff_matmul_hybrid_check_f32(a, sa0, sa1, b, sb0, sb1, hi, lo, M, N, K, bk,
# stream): the earlier hybrid kernel (csrc/ff_matmul_hybrid_check.cu)
_CHECK_ARGTYPES = [_P, _I64, _I64, _P, _I64, _I64, _P, _P,
                   _I32, _I32, _I32, _I32, _P]
# ff_matmul_ozaki_f16(qa, qb, ga, gb, si, sj, npairs, hi, lo, n, M, N, K,
# Kp, Np, bk, bkp, stream); si, sj: host arrays of the pair table, passed
# to the kernel by value
_OZAKI_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I32, _P, _P] + [_I32] * 8 + [_P]
# csrc/ff_matmul_ozaki.cu's constants
OZAKI_MAX_PAIRS = 256     # the pair table
OZAKI_MAX_BETA = 12       # slices of <= 11-bit integers: exact in fp16
OZAKI_TILE_K = 64         # K per stage: each K-block padded to a multiple
OZAKI_TILE_N = 128        # output columns per block
# ff_matmul_dot2_f32(a, sa0, sa1, b, sb0, sb1, hi, lo, M, N, K, vec, stream)
_DOT2_ARGTYPES = _CHECK_ARGTYPES
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


def hybrid_plan(M: int, N: int, K: int, bk: int, sms: int) -> int:
    """The blocks over which the hybrid kernel splits each output tile's
    K-blocks, for an (M, K) x (K, N) product on a card of ``sms`` SMs.  The
    rule: none where the output tiles fill ``HYBRID_BLOCKS_PER_SM`` blocks on
    every SM; else as many as fit the card beside the tiles at
    ``HYBRID_SPLIT_BLOCKS_PER_SM`` an SM, at most one a K-block (each writes
    its block products to a workspace, which a second pass folds in K-block
    order).  It changes no bits."""
    tiles = -(-M // HYBRID_TILE[0]) * -(-N // HYBRID_TILE[1])
    if tiles >= HYBRID_BLOCKS_PER_SM * sms:
        return 1
    fit = HYBRID_SPLIT_BLOCKS_PER_SM * sms // tiles
    return max(1, min(-(-K // bk), fit))


def hybrid_launch(a: Tensor, b: Tensor, bk: int, splits: int) -> Pair:
    """One launch of the hybrid kernel with its K-blocks split over
    ``splits`` blocks a tile (``hybrid_plan``'s), on f32 CUDA operands; no
    launch count."""
    M, K, N = _mkn("ff_matmul", a, b)
    bk = min(bk, max(K, 1))
    hi, lo = _outputs(a, M, N)
    nkb = -(-K // bk)
    ws = (torch.empty((nkb, M, N), dtype=torch.float32, device=a.device)
          if splits > 1 and nkb > 1 else None)
    _launch("ff_matmul", "ff_matmul_f32", _HYBRID_ARGTYPES, a.device,
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1),
            hi.data_ptr(), lo.data_ptr(), M, N, K, bk,
            splits if ws is not None else 1,
            ws.data_ptr() if ws is not None else None)
    return hi, lo


def ff_matmul(a: Tensor, b: Tensor, *, bm: int = 256, bn: int = 256,
              bk: int = 512) -> Pair:
    """FF (M, N) = a (M, K) @ b (K, N), hybrid: f32 block products per
    K-block of ``bk``, FF-accumulated.  Returns (hi, lo).

    On CUDA tensors: the CUDA kernel with ``hybrid_plan``'s split, counted
    as one launch (raises if it cannot launch); on CPU tensors: the plain
    version."""
    if a.device.type == "cpu":
        return ff_matmul_plain(a, b, bk=bk)
    _cuda_operands("ff_matmul", a, b)
    M, K, N = _mkn("ff_matmul", a, b)
    if bk < 1:
        raise ValueError(f"ff_matmul: bk must be positive, got {bk}")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    out = hybrid_launch(a, b, bk, hybrid_plan(M, N, K, min(bk, max(K, 1)),
                                              sms))
    ff_matmul.launches += 1
    return out


ff_matmul.launches = 0    # kernel launches since the last reset


def ff_matmul_hybrid_check(a: Tensor, b: Tensor, *, bk: int = 512) -> Pair:
    """The earlier hybrid kernel (``csrc/ff_matmul_hybrid_check.cu``), which
    ``ff_matmul`` must match bit for bit: a check on the card, on no model
    path, with no launch count."""
    _cuda_operands("ff_matmul_hybrid_check", a, b)
    M, K, N = _mkn("ff_matmul_hybrid_check", a, b)
    if bk < 1:
        raise ValueError(f"ff_matmul_hybrid_check: bk must be positive, "
                         f"got {bk}")
    hi, lo = _outputs(a, M, N)
    _launch("ff_matmul_hybrid_check", "ff_matmul_hybrid_check_f32",
            _CHECK_ARGTYPES, a.device, a.data_ptr(), a.stride(0),
            a.stride(1), b.data_ptr(), b.stride(0), b.stride(1),
            hi.data_ptr(), lo.data_ptr(), M, N, K, min(bk, max(K, 1)))
    return hi, lo


# -- Ozaki ---------------------------------------------------------------------

def ozaki_pairs(n: int, max_order: int) -> List[Tuple[int, int]]:
    """The slice pairs the kernel accumulates, in its order: every (i, j)
    with ``i + j <= max_order``, sorted by (i + j, i)."""
    return sorted(((i, j) for i in range(n) for j in range(n)
                   if i + j <= max_order),
                  key=lambda q: (q[0] + q[1], q[0]))


def _ozaki_setup(a: Tensor, b: Tensor, slices: int, beta: int, bk: int):
    """f32 operands and the reference's slicing parameters for them:
    ``(a, b, n, beta, bk, pairs)``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    _, K, _ = _mkn("ff_matmul_ozaki", a, b)
    n, beta, bk, max_order = ffmatmul.ozaki_params(
        K, slices=slices, beta=beta, block_k=min(bk, max(K, 1)))
    return a, b, n, beta, bk, ozaki_pairs(n, max_order)


def _residual_fold(a: Tensor, b: Tensor, ra: Tensor, rb: Tensor,
                   oh: Tensor, ol: Tensor) -> Pair:
    """The reference's wrapper after its kernel: the K-doubled residual GEMM
    ``[ra, a - ra] @ [b; rb]`` folded into the pair accumulation (oh, ol)."""
    res = torch.matmul(torch.cat([ra, a - ra], 1), torch.cat([b, rb], 0))
    sh, sl = T.two_sum(oh, res)
    return T.fast_two_sum(sh, sl + ol)


def ozaki_accumulate_plain(As: Tensor, Bs: Tensor,
                           pairs: List[Tuple[int, int]], bk: int) -> Pair:
    """The pair accumulation in torch: for each K-block, for each pair in
    table order, the exact slice-pair GEMM of the f32 slices ``As`` (n, M,
    K) and ``Bs`` (n, K, N) folded into the FF accumulator
    (``fold_block_products``, the hybrid plain version's fold)."""
    K = As.shape[2]
    return fold_block_products(
        (torch.matmul(As[i, :, k0:k0 + bk], Bs[j, k0:k0 + bk])
         for k0 in range(0, K, bk) for i, j in pairs),
        As.shape[1], Bs.shape[2], As.device)


class OzakiOperands(NamedTuple):
    """The kernel's operands (``ozaki_operands``), both K-major.  Slice i
    of row m of A is ``qa[i, m, k'] 2^ga[i, m]``, of column c of B
    ``qb[i, c, k'] 2^gb[i, c]``, where K-block kb (K in ``[kb bk, kb bk +
    bk)``) lies at ``k' in [kb bkp, kb bkp + bk)``; zero elsewhere."""
    qa: Tensor      # (n, M, Kp) fp16 integers
    qb: Tensor      # (n, N, Kp) fp16 integers, B's slices transposed
    ga: Tensor      # (n, M) int32
    gb: Tensor      # (n, N) int32
    K: int
    bk: int
    bkp: int        # bk rounded up to OZAKI_TILE_K
    ra: Tensor      # the slicing's residuals, (M, K) and (K, N) f32
    rb: Tensor


def _pow2(e: Tensor) -> Tensor:
    """2^e as f32 for integer e in [-126, 127], from the exponent bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _integers(w: Tensor, g: Tensor) -> Tensor:
    """``w 2^-g`` in fp16: exact where ``w`` is a slice of at most 12 bits
    at quantum ``2^g`` (two normal powers of two; ``|g| <= 220``)."""
    h = (-g) >> 1
    return w.mul(_pow2(h)).mul_(_pow2(-g - h)).to(torch.float16)


def _k_layout(qs: List[Tensor], K: int, bk: int, bkp: int, cols: int,
              k_first: bool) -> Tensor:
    """Stack the slices (each (C, K), or (K, C) if ``k_first``) K-major:
    (n, cols, Kp), K-block kb at ``[kb bkp, kb bkp + bk)`` of a K of ``Kp``
    (the last block's end rounded up to 8), C padded to ``cols``, zero
    outside the slices."""
    nf = (K - 1) // bk                         # blocks before the last
    rem = K - nf * bk                          # the last block's length
    Kp = nf * bkp + (-(-rem // 8) * 8)
    C = qs[0].shape[1 if k_first else 0]
    padded = (Kp, cols) != (K, C) or (nf and bkp != bk)
    if not (padded or k_first):
        return torch.stack(qs)
    out = (torch.zeros if padded else torch.empty)(
        (len(qs), cols, Kp), dtype=torch.float16, device=qs[0].device)
    kview = out.transpose(1, 2)                               # (n, Kp, cols)
    for i, q in enumerate(qs):
        qk = q if k_first else q.T                            # (K, C)
        if nf:
            kview[i, :nf * bkp].view(nf, bkp, cols)[:, :bk, :C] = (
                qk[:nf * bk].reshape(nf, bk, C))
        kview[i, nf * bkp:nf * bkp + rem, :C] = qk[nf * bk:]
    return out


def ozaki_operands(a: Tensor, b: Tensor, n: int, beta: int,
                   bk: int) -> OzakiOperands:
    """The kernel's operands for ``a`` (M, K) @ ``b`` (K, N), f32: the
    ``n`` slices of ``extract_slices`` as fp16 integers ``q = w 2^-g`` with
    ``g = ie + 1 - beta (i + 1)`` (``ie`` from the same ``slice_exponent``
    call as the slices: exact, never an f32 log2), both K-major (B's
    slices transposed: (n, N, Kp)), K padded per K-block to a multiple of
    ``OZAKI_TILE_K`` and the last block to a multiple of 8 (TMA's 16-byte
    row strides), and the residuals."""
    M, K, N = _mkn("ff_matmul_ozaki", a, b)
    if not 1 <= beta <= OZAKI_MAX_BETA:
        raise ValueError(f"ff_matmul_ozaki kernel takes beta <= "
                         f"{OZAKI_MAX_BETA} (fp16 integers), got {beta}")
    ie_a = ffmatmul.slice_exponent(a, 1)                      # (M, 1)
    ie_b = ffmatmul.slice_exponent(b, 0)                      # (1, N)
    pa, ra = ffmatmul.extract_slices(a, 1, n, beta, ie=ie_a)
    pb, rb = ffmatmul.extract_slices(b, 0, n, beta, ie=ie_b)
    ga = [ie_a + (1 - beta * (i + 1)) for i in range(n)]
    gb = [ie_b + (1 - beta * (i + 1)) for i in range(n)]
    bkp = -(-bk // OZAKI_TILE_K) * OZAKI_TILE_K
    qa = _k_layout([_integers(w, g) for w, g in zip(pa, ga)], K, bk, bkp,
                   M, False)
    qb = _k_layout([_integers(w, g) for w, g in zip(pb, gb)], K, bk, bkp,
                   N, True)
    return OzakiOperands(qa, qb, torch.cat(ga, 1).T.contiguous(),
                         torch.cat(gb, 0).contiguous(), K, bk, bkp, ra, rb)


def ozaki_accumulate(ops: OzakiOperands,
                     pairs: List[Tuple[int, int]]) -> Pair:
    """The pair accumulation as one launch of the CUDA kernel on the
    operands of ``ozaki_operands``; the bits of ``ozaki_accumulate_plain``
    on their slices.  The pair table goes to the kernel by value."""
    qa, qb, ga, gb = ops.qa, ops.qb, ops.ga, ops.gb
    dev = qa.device
    if dev.type != "cuda":
        raise RuntimeError(f"ff_matmul_ozaki: no kernel for device {dev}")
    for x, dt in ((qa, torch.float16), (qb, torch.float16),
                  (ga, torch.int32), (gb, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise TypeError(f"ff_matmul_ozaki kernel takes contiguous {dt} "
                            f"on {dev}, got {x.dtype} on {x.device}")
    n, M, Kp = qa.shape
    Np, N = qb.shape[1], gb.shape[1]
    if (qb.shape[0], qb.shape[2]) != (n, Kp) or ga.shape != (n, M) \
            or gb.shape[0] != n:
        raise ValueError("ff_matmul_ozaki: operands of ozaki_operands "
                         "expected")
    if (not 0 < len(pairs) <= OZAKI_MAX_PAIRS
            or max(map(max, pairs)) >= n):
        raise ValueError(f"ff_matmul_ozaki kernel takes 1..{OZAKI_MAX_PAIRS}"
                         f" pairs of slices < {n}, got {len(pairs)}")
    si, sj = ((ctypes.c_ubyte * len(pairs))(*col) for col in zip(*pairs))
    hi, lo = _outputs(qa, M, N)
    _launch("ff_matmul_ozaki", "ff_matmul_ozaki_f16", _OZAKI_ARGTYPES, dev,
            qa.data_ptr(), qb.data_ptr(), ga.data_ptr(), gb.data_ptr(),
            ctypes.addressof(si), ctypes.addressof(sj), len(pairs),
            hi.data_ptr(), lo.data_ptr(), n, M, N, ops.K, Kp, Np, ops.bk,
            ops.bkp)
    ff_matmul_ozaki.launches += 1
    return hi, lo


def ff_matmul_ozaki_plain(a: Tensor, b: Tensor, *, slices: int = 0,
                          beta: int = 0, bk: int = 512) -> Pair:
    """The Ozaki kernel's wrapper with the pair accumulation in torch."""
    a, b, n, beta, bk, pairs = _ozaki_setup(a, b, slices, beta, bk)
    pa, ra = ffmatmul.extract_slices(a, 1, n, beta)
    pb, rb = ffmatmul.extract_slices(b, 0, n, beta)
    oh, ol = ozaki_accumulate_plain(torch.stack(pa), torch.stack(pb), pairs,
                                    bk)
    return _residual_fold(a, b, ra, rb, oh, ol)


def ff_matmul_ozaki(a: Tensor, b: Tensor, *, slices: int = 0, beta: int = 0,
                    bm: int = 128, bn: int = 128, bk: int = 512) -> Pair:
    """Ozaki FF matmul: exact slice-pair block products FF-accumulated per
    K-block of ``bk`` (pairs with beta*(i+j) > 50 skipped), plus the f32
    residual GEMM.  Returns (hi, lo).

    On CUDA tensors the pair accumulation is one launch of the CUDA kernel
    on ``ozaki_operands`` (raises if it cannot launch); on CPU tensors the
    plain version."""
    if a.device.type == "cpu":
        return ff_matmul_ozaki_plain(a, b, slices=slices, beta=beta, bk=bk)
    _cuda_operands("ff_matmul_ozaki", a, b)
    a, b, n, beta, bk, pairs = _ozaki_setup(a, b, slices, beta, bk)
    ops = ozaki_operands(a, b, n, beta, bk)
    oh, ol = ozaki_accumulate(ops, pairs)
    return _residual_fold(a, b, ops.ra, ops.rb, oh, ol)


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
