"""Flash attention tiers of the ``attention`` op (counterpart of
``repro.kernels.ff_attention``).

  fast   — the f32 online softmax (plain torch).
  ff     — the compensated recurrence in plain torch: FF scores (TwoProd
           products through ``ff_sum_blocked``, Mul212 scale), Add212
           max shift, exp22 weights, TwoSum-carried FF numerator and
           denominator, Div22 finish.  The reference's op sequence, so it
           returns the reference's ``ff`` tier bits on normal-range inputs.
  pallas — the one-kernel tier: on a CUDA tensor the hand-written kernel
           ``csrc/ff_attention.cu`` (the reference's Pallas kernel
           ``flash_attention_pallas`` translated); on a CPU tensor its
           plain version, ``flash_attention_ff``.
  f64    — ``attention_f64``: scores, softmax and ``p @ v`` in float64 on
           the tensors' device (the H100 has f64 units), the (Sq, Skv)
           score plane materialised; the dispatch guards its size.

All tiers take q (B, Sq, H, hd) and k, v (B, Skv, KV, hd) with H = KV * G
(GQA) and return (B, Sq, H, hd): q's dtype, or an FF pair of f32 planes
with ``return_ff=True``.  The accurate tiers hold the reference's
contract: <= 2^-40 relative to the per-row max of an f64 oracle.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import compensated, ffmath
from repro_torch.core import ff as core_ff
from repro_torch.core import transforms as T
from repro_torch.core.ff import FF
from repro_torch.kernels import build

Tensor = torch.Tensor

NEG_INF = -1e30
# the CUDA kernel's head-dim instances (csrc/ff_attention.cu: launch_hd);
# a head dim up to 64 runs the 64 instance, 128 and 192 their own
KERNEL_HEAD_DIMS = (64, 128, 192)


def _dims(q: Tensor, k: Tensor) -> Tuple[int, int, int, int, int, int]:
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {KV}")
    return B, Sq, H, hd, Skv, KV


def _resolve_scale(scale: Optional[float], hd: int) -> float:
    return (1.0 / math.sqrt(hd)) if scale is None else float(scale)


def _pad_seq(x: Tensor, p: int) -> Tensor:
    """Zero-pad axis 1 of a (B, S, X, hd) tensor by ``p`` rows."""
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, p)) if p else x


def _blocks(q, k, v, block_q, block_kv):
    """Pad to whole blocks; q -> (nq, B, KV, G, bq, hd), k/v -> (nkv, B,
    KV, bkv, hd) — the reference's layout."""
    B, Sq, H, hd, Skv, KV = _dims(q, k)
    G = H // KV
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    q = _pad_seq(q, (-Sq) % bq)
    k = _pad_seq(k, (-Skv) % bkv)
    v = _pad_seq(v, (-Skv) % bkv)
    nq, nkv = q.shape[1] // bq, k.shape[1] // bkv
    qb = q.reshape(B, nq, bq, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, nkv, bkv, KV, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nkv, bkv, KV, hd).permute(1, 0, 3, 2, 4)
    return qb, kb, vb, bq, bkv


def _mask(q_pos: Tensor, kv_pos: Tensor, Skv: int, causal: bool,
          kv_len: Optional[Tensor]) -> Tensor:
    """(B|1, 1, 1, bq, bkv) validity of each (q, k) pair."""
    mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else \
        torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    mask = (mask & (kv_pos < Skv)[None, :])[None, None, None]
    if kv_len is not None:
        rag = kv_pos[None, :] < kv_len[:, None]                 # (B, bkv)
        mask = mask & rag[:, None, None, None]
    return mask


def _assemble(blocks, B: int, Sq: int, H: int, hd: int) -> Tensor:
    """(nq, B, KV, G, bq, hd) blocks -> (B, Sq, H, hd)."""
    out = torch.stack(blocks)
    nq, bq = out.shape[0], out.shape[4]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * bq, H, hd)
    return out[:, :Sq]


# ===========================================================================
# fast tier: the f32 online softmax
# ===========================================================================

def flash_attention_fast(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, block_q: int = 128,
                         block_kv: int = 128, q_offset: int = 0,
                         kv_len: Optional[Tensor] = None,
                         scale: Optional[float] = None,
                         return_ff: bool = False):
    """Online-softmax blockwise attention with f32 accumulators."""
    B, Sq, H, hd, Skv, KV = _dims(q, k)
    qb, kb, vb, bq, bkv = _blocks(q, k, v, block_q, block_kv)
    sc = _resolve_scale(scale, hd)
    dev = q.device
    outs = []
    for iq in range(qb.shape[0]):
        qi32 = qb[iq].float() * sc
        q_pos = q_offset + iq * bq + torch.arange(bq, device=dev)
        shp = qi32.shape[:-1]
        m = torch.full(shp, NEG_INF, device=dev)
        l = torch.zeros(shp, device=dev)
        acc = torch.zeros(qi32.shape, device=dev)
        for jk in range(kb.shape[0]):
            kj, vj = kb[jk].float(), vb[jk].float()
            s = torch.einsum("bkgqd,bksd->bkgqs", qi32, kj)
            kv_pos = jk * bkv + torch.arange(bkv, device=dev)
            s = torch.where(_mask(q_pos, kv_pos, Skv, causal, kv_len), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vj)
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = _assemble(outs, B, Sq, H, hd)
    if return_ff:
        return FF(out, torch.zeros_like(out))
    return out.to(q.dtype)


# ===========================================================================
# ff tier: the compensated online recurrence (plain torch)
# ===========================================================================

def _ff_safe_den(den: FF) -> FF:
    """Guard a fully-masked row's zero denominator (1e-30, as the fast tier)
    without perturbing real denominators."""
    ok = den.hi > 1e-30
    return FF(torch.where(ok, den.hi, 1e-30), torch.where(ok, den.lo, 0.0))


def flash_attention_ff(q: Tensor, k: Tensor, v: Tensor, *,
                       causal: bool = True, block_q: int = 32,
                       block_kv: int = 128, q_offset: int = 0,
                       kv_len: Optional[Tensor] = None,
                       scale: Optional[float] = None, block: int = 128,
                       return_ff: bool = False):
    """Compensated online-softmax attention (accurate class, plain torch).

    ``kv_len``: optional (B,) per-row valid-key counts (ragged serving
    batches).  ``block``: the lane count of the ``ff_sum_blocked`` sums.
    ``return_ff=True`` keeps both limbs."""
    B, Sq, H, hd, Skv, KV = _dims(q, k)
    qb, kb, vb, bq, bkv = _blocks(q, k, v, block_q, block_kv)
    sc = _resolve_scale(scale, hd)
    dev = q.device
    ohs, ols = [], []
    for iq in range(qb.shape[0]):
        qi32 = qb[iq].float()                                # (B,KV,G,bq,hd)
        q_pos = q_offset + iq * bq + torch.arange(bq, device=dev)
        shp = qi32.shape[:-1]
        m = torch.full(shp, NEG_INF, device=dev)
        z1 = torch.zeros(shp, device=dev)
        z2 = torch.zeros(qi32.shape, device=dev)
        den, num = FF(z1, z1), FF(z2, z2)
        for jk in range(kb.shape[0]):
            kj, vj = kb[jk].float(), vb[jk].float()          # (B,KV,bkv,hd)
            # FF scores: TwoProd-exact products, compensated head-dim sum,
            # Mul212 scale
            pshape = shp + (bkv, hd)
            tph, tpl = T.two_prod(qi32[..., :, None, :].expand(pshape),
                                  kj[:, :, None, None].expand(pshape))
            s_ff = core_ff.add22_accurate(
                compensated.ff_sum_blocked(tph, axis=-1, block=block),
                compensated.ff_sum_blocked(tpl, axis=-1, block=block))
            s_ff = core_ff.mul212(s_ff, sc)                  # (B,KV,G,bq,bkv)
            kv_pos = jk * bkv + torch.arange(bkv, device=dev)
            full = _mask(q_pos, kv_pos, Skv, causal, kv_len).expand(
                s_ff.hi.shape)
            shi = torch.where(full, s_ff.hi, NEG_INF)
            slo = torch.where(full, s_ff.lo, 0.0)
            m_new = torch.maximum(m, shi.amax(dim=-1))
            # FF exponentials on the Add212-shifted FF argument
            d_ff = core_ff.add212(FF(shi, slo), -m_new[..., None])
            ph, plo = ffmath.exp22(d_ff.hi, d_ff.lo)
            ph = torch.where(full, ph, 0.0)
            plo = torch.where(full, plo, 0.0)
            # FF rescale factor alpha = exp(m - m_new), argument exact
            ah, al = T.two_sum(m, -m_new)
            alpha = FF(*ffmath.exp22(ah, al))
            bs = core_ff.add22_accurate(
                compensated.ff_sum_blocked(ph, axis=-1, block=block),
                compensated.ff_sum_blocked(plo, axis=-1, block=block))
            den = core_ff.add22(core_ff.mul22(den, alpha), bs)
            # numerator: TwoProd-exact hi-plane products, lo-plane products
            # in the residual sum
            vfull = vj[:, :, None, None].expand(ph.shape + (hd,))
            th, tl = T.two_prod(ph[..., None].expand(vfull.shape), vfull)
            tl = tl + plo[..., None] * vfull
            nb = core_ff.add22_accurate(
                compensated.ff_sum_blocked(th, axis=-2, block=block),
                compensated.ff_sum_blocked(tl, axis=-2, block=block))
            ab = FF(alpha.hi[..., None].expand(nb.shape),
                    alpha.lo[..., None].expand(nb.shape))
            num = core_ff.add22(core_ff.mul22(num, ab), nb)
            m = m_new
        den = _ff_safe_den(den)
        o = core_ff.div22(num, FF(den.hi[..., None].expand(num.shape),
                                  den.lo[..., None].expand(num.shape)))
        ohs.append(o.hi)
        ols.append(o.lo)
    hi = _assemble(ohs, B, Sq, H, hd)
    if return_ff:
        return FF(hi, _assemble(ols, B, Sq, H, hd))
    return hi.to(q.dtype)


# ===========================================================================
# f64 tier: materialised float64 scores
# ===========================================================================

def attention_f64(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  q_offset: int = 0, kv_len: Optional[Tensor] = None,
                  scale: Optional[float] = None, return_ff: bool = False):
    """Float64 softmax attention over the materialised (Sq, Skv) score
    plane (the reference's ``attention_f64``): the f32-rounded scale, the
    masked scores set to the f32 -1e30 (float64's exp takes it to an
    exact 0 against any real row max), the f64 result rounded to f32, or
    split into FF limbs with ``return_ff=True``."""
    B, Sq, H, hd, Skv, KV = _dims(q, k)
    G = H // KV
    f64 = torch.float64
    sc = torch.tensor(_resolve_scale(scale, hd), dtype=torch.float32)
    q64 = q.to(torch.float32).to(f64).reshape(B, Sq, KV, G, hd)
    k64 = k.to(torch.float32).to(f64)
    v64 = v.to(torch.float32).to(f64)
    s = torch.einsum("bqkgd,bskd->bkgqs", q64, k64) * sc.to(f64).item()
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else \
        torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    full = mask[None, None, None].expand(s.shape)
    if kv_len is not None:
        rag = kv_pos[None, :] < kv_len.to(q.device)[:, None]
        full = full & rag[:, None, None, None]
    neg = float(torch.tensor(NEG_INF, dtype=torch.float32))
    s = torch.where(full, s, neg)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bkgqs,bskd->bkgqd", p / p.sum(dim=-1, keepdim=True),
                     v64)
    hi = o.to(torch.float32)
    lo = (o - hi.to(f64)).to(torch.float32)

    def assemble(x):
        return x.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)

    if return_ff:
        return FF(assemble(hi), assemble(lo))
    return assemble(hi).to(q.dtype)


# ===========================================================================
# pallas tier: the one-kernel FF flash attention (CUDA)
# ===========================================================================

# ff_attention_fwd(q, k, v, out_hi, out_lo, is_bf16, B, Sq, Skv, H, KV, hd,
#                  causal, q_offset, scale, plan, hb_shift, stream)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# the kernel's tile configurations (csrc/ff_attention.cu: Big, Small): rows
# a block, threads a block, blocks an SM (__launch_bounds__)
CONFIGS = ((64, 256, 1), (16, 256, 2))
# each configuration's rows a thread (TR) in the score and p*v phases
CONFIG_TR = (4, 2)
# the kernel's grid.y: q tiles
KERNEL_MAX_Q_TILES = 65535
# an H100 SM's shared memory, and the most one block may take (bytes)
SMEM_PER_SM = 228 * 1024
SMEM_PER_BLOCK = 227 * 1024
KERNEL_BKV = 64                      # keys a K/V tile (kBKV)


def kernel_head_dim(hd: int) -> int:
    """The kernel instance (``HD``) that serves head dim ``hd``: 64 for
    1 <= hd <= 64, else hd itself where it is 128 or 192; any other hd
    raises ``ValueError``."""
    if 1 <= hd <= 64:
        return 64
    if hd in KERNEL_HEAD_DIMS:
        return hd
    raise ValueError(f"attention kernel takes head_dim <= 64, 128 or 192, "
                     f"got {hd}")


def smem_bytes(config: int, hd: int) -> int:
    """The shared memory of one block of configuration ``config`` at head
    dim ``hd`` (csrc/ff_attention.cu: smem_floats): the transposed q tile
    and K tile, the V tile and the two weight planes, in f32."""
    HD = kernel_head_dim(hd)
    rows, tr = CONFIGS[config][0], CONFIG_TR[config]
    qs, ks = rows + tr, KERNEL_BKV + 4
    return 4 * (HD * qs + HD * ks + KERNEL_BKV * HD + 2 * KERNEL_BKV * qs)


class Plan(NamedTuple):
    """One launch of the attention kernel: ``config`` indexes ``CONFIGS``,
    ``heads`` query heads of one KV head share a block's staged K/V tile,
    ``positions`` q positions a block (rows = heads x positions); the grid
    is (B * H / heads, q tiles), its y walked from the last q tile (the
    most keys under a causal mask) to the first."""
    config: int
    heads: int
    positions: int
    grid: Tuple[int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def plan_with(config: int, heads: int, B: int, Sq: int, H: int) -> Plan:
    """The launch of configuration ``config`` with ``heads`` query heads a
    block."""
    pos = CONFIGS[config][0] // heads
    return Plan(config, heads, pos, (B * H // heads, -(-Sq // pos)))


def attention_plan(B: int, Sq: int, H: int, KV: int,
                   sms: int = 132, hd: int = 64) -> Plan:
    """The tiles of one kernel launch: the largest configuration whose
    blocks occupy every one of the ``sms`` SMs, else the smallest (the
    most blocks).  A block serves the largest of 4, 2, 1 query heads that
    divides H / KV.  Raises ``ValueError`` for a head dim ``hd`` that no
    kernel instance takes (:func:`kernel_head_dim`)."""
    kernel_head_dim(hd)
    G = H // KV
    heads = 4 if G % 4 == 0 else 2 if G % 2 == 0 else 1
    for i in range(len(CONFIGS)):
        plan = plan_with(i, heads, B, Sq, H)
        if plan.blocks >= sms or i == len(CONFIGS) - 1:
            return plan
    raise AssertionError("unreachable")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_pallas(q: Tensor, k: Tensor, v: Tensor, *,
                           causal: bool = True, block_q: int = 32,
                           block_kv: int = 128, q_offset: int = 0,
                           scale: Optional[float] = None,
                           return_ff: bool = False):
    """FF flash attention as one kernel launch (static masks only: the
    dispatch routes a per-row ``kv_len`` to the ``ff`` tier).

    On a CUDA tensor: the CUDA kernel, which raises if it cannot launch
    (f32 or bf16 operands of one dtype, contiguous, hd <= 64, 128 or 192,
    at most ``KERNEL_MAX_Q_TILES`` q tiles).  Its tiles are its own
    (:func:`attention_plan`: 64-key K/V tiles, 64 or 16 rows a block);
    ``block_q``/``block_kv`` shape only the plain version.  On a CPU
    tensor: the plain version, :func:`flash_attention_ff`."""
    if q.device.type == "cpu":
        return flash_attention_ff(q, k, v, causal=causal, block_q=block_q,
                                  block_kv=block_kv, q_offset=q_offset,
                                  scale=scale, return_ff=return_ff)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_pallas: no kernel for device "
                           f"{q.device}")
    B, Sq, H, hd, Skv, KV = _dims(q, k)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or tuple(v.shape) != tuple(k.shape) \
            or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k, v")
    plan = attention_plan(B, Sq, H, KV, _sms(q.device.index
                                             if q.device.index is not None
                                             else torch.cuda.current_device()),
                          hd=hd)
    if plan.grid[1] > KERNEL_MAX_Q_TILES or plan.grid[0] >= 2 ** 31:
        raise ValueError(f"attention kernel takes at most "
                         f"{KERNEL_MAX_Q_TILES} q tiles and < 2^31 head "
                         f"groups, got grid {plan.grid}")
    oh = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    ol = torch.empty_like(oh)
    with torch.cuda.device(q.device):
        err = build.entry("ff_attention", "ff_attention_fwd", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), oh.data_ptr(),
            ol.data_ptr(), int(q.dtype == torch.bfloat16), B, Sq, Skv, H,
            KV, hd, int(causal), int(q_offset), _resolve_scale(scale, hd),
            plan.config, plan.heads.bit_length() - 1,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"ff_attention kernel launch failed: CUDA error "
                           f"{err}")
    flash_attention_pallas.launches += 1
    flash_attention_pallas.last_plan = plan
    if return_ff:
        return FF(oh, ol)
    return oh.to(q.dtype)


flash_attention_pallas.launches = 0   # kernel launches since the last reset
flash_attention_pallas.last_plan = None   # the last launch's Plan
