"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block
(counterpart of ``repro.models.mamba2``).

Chunked SSD: the intra-chunk terms are quadratic, attention-like einsums
over a chunk of ``Q = min(CHUNK, S)`` positions; the inter-chunk
recurrence carries the (B, H, P, N) state over the chunks in a Python
loop (the reference's ``lax.scan``).  Decode is one recurrent state
update a token.  A depthwise causal conv (width W = 4) runs over the x/B/C
projections, with a rolling (W - 1)-row window as the decode cache.

Under the policy's ``ff_math`` switch every decay exponential and the
softplus of ``dt`` go through ``ff.exp`` / ``ff.log1p`` (the ``ff_math``
CUDA kernel on the card under ``ff.use(exp="pallas", log1p="pallas")``):
7 calls a block in prefill, 4 in decode.  The builtin path is
``torch.exp`` and jax's softplus form.

The summation orders differ from the reference's: XLA's ``cumsum`` and
its three-operand einsums, and torch's, each sum in their own order, so
the port holds the reference to a relative tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

import repro_torch.ff as ff
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm

Tensor = torch.Tensor
Params = Dict[str, Any]

CHUNK = 256


def _exp(x: Tensor, ff_math: bool) -> Tensor:
    """exp for the SSD decay chains: the f32 builtin, or the FF exp rounded
    back to f32 (``ff_math``; exp(-inf) = (0, 0))."""
    if ff_math:
        return ff.to_f32(ff.exp(x))
    return torch.exp(x)


def _softplus(x: Tensor, ff_math: bool) -> Tensor:
    """dt = softplus(raw) in jax's form ``max(x, 0) + log1p(exp(-|x|))``
    (``F.softplus`` has a threshold branch and another formula), with the
    FF ``exp`` / ``log1p`` under ``ff_math``.

    The reference's two forms part at x = 0 exactly in their gradient:
    its builtin ``jax.nn.softplus`` has the derivative sigmoid(0) = 1/2
    there, its FF form 1/2 - 1/2 = 0 (jax's ``max`` splits a tie in
    halves, its ``abs`` has the derivative +1 at 0).  The port keeps both:
    ``torch.maximum`` splits a tie as jax's ``max`` (``clamp_min`` would
    pass it whole); the FF form takes -|x| as ``where(x >= 0, -x, x)``
    (jax's ``abs`` rule), the builtin form as ``-x.abs()`` (torch's rule:
    0 at 0)."""
    relu = torch.maximum(x, x.new_zeros(()))
    if ff_math:
        neg_abs = torch.where(x >= 0, -x, x)
        return relu + ff.to_f32(ff.log1p(ff.exp(neg_abs)))
    return relu + torch.log1p(torch.exp(-x.abs()))


def ssd_params(cfg: ModelConfig, dense, normal, full) -> Params:
    """One SSD mixer's weights, the reference's layout: ``dense(shape)``
    draws a matrix (normal / sqrt(shape[-2])), ``normal(shape)`` a
    standard normal, ``full(shape, value)`` a constant, each with any
    leading layer axis."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    H, N = cfg.ssm_heads, cfg.ssm_state
    conv_dim = di + 2 * N                 # x plus B and C (single group)
    return {
        "w_z": dense((d, di)),
        "w_x": dense((d, di)),
        "w_bc": dense((d, 2 * N)),
        "w_dt": dense((d, H)),
        "conv_w": normal((cfg.ssm_conv_width, conv_dim)) * 0.1,
        "conv_b": full((conv_dim,), 0.0),
        "A_log": full((H,), 0.0),
        "D": full((H,), 1.0),
        "dt_bias": full((H,), 0.0),
        "norm_w": full((di,), 1.0),
        "out_proj": dense((di, d)),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (W, C): Python's
    sum of the W taps in order, in x's dtype, then silu."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :].to(x.dtype)
              for i in range(W))
    return F.silu(out + b.to(x.dtype))


def _segsum(a: Tensor) -> Tensor:
    """L[i, j] = sum_{j < m <= i} a[m] for j <= i, -inf above the
    diagonal: (..., Q) -> (..., Q, Q)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(Q, device=a.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_scan(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
             state: Optional[Tensor] = None,
             ff_math: bool = False) -> Tuple[Tensor, Tensor]:
    """Chunked SSD.  x: (B, S, H, P); dt: (B, S, H) (after softplus); A:
    (H,) negative; Bm, Cm: (B, S, N) (one SSM group, broadcast over the
    heads); state: an optional initial (B, H, P, N).  S is zero-padded to
    a multiple of ``Q = min(CHUNK, S)``.  Returns (y (B, S, H, P), the
    final state)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(CHUNK, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    a_t = (dtc * A[None, None, None, :]).permute(0, 1, 3, 2)  # (B,nc,H,Q)
    a_cum = torch.cumsum(a_t, dim=-1)                    # within a chunk
    L = _exp(_segsum(a_t), ff_math)                      # (B,nc,H,Q,Q)
    xdt = xc * dtc[..., None]                            # (B,nc,Q,H,P)

    # 1) the intra-chunk (diagonal) term
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bcqk,bchqk,bckhp->bcqhp", scores, L, xdt)

    # 2) each chunk's final state: decay from position k to the chunk's end
    decay_end = _exp(a_cum[..., -1:] - a_cum, ff_math)   # (B,nc,H,Q)
    states = torch.einsum("bckn,bchk,bckhp->bchpn", Bc, decay_end, xdt)

    # 3) the inter-chunk recurrence; the state BEFORE each chunk is kept
    chunk_decay = _exp(a_cum[..., -1], ff_math)          # (B,nc,H)
    st = state if state is not None else torch.zeros(
        (Bsz, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # 4) the inter-chunk output: decay from the chunk's start to q
    decay_in = _exp(a_cum, ff_math)                      # (B,nc,H,Q)
    y_off = torch.einsum("bcqn,bchq,bchpn->bcqhp", Cc, decay_in, prev_states)

    y = (y_diag + y_off).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, st


def _projections(p: Params, x: Tensor, N: int):
    """z, x, B, C and raw dt of the mixer's input, in x's dtype."""
    dt_x = x.dtype
    z = x @ p["w_z"].to(dt_x)
    xin = x @ p["w_x"].to(dt_x)
    bc = x @ p["w_bc"].to(dt_x)
    dt_raw = x @ p["w_dt"].to(dt_x)
    return z, xin, bc[..., :N], bc[..., N:], dt_raw


def _gate_out(p: Params, y: Tensor, z: Tensor, cfg: ModelConfig) -> Tensor:
    """The gated RMSNorm (plain statistics, as the reference's) and the
    output projection."""
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


def ssd_block_apply(p: Params, x: Tensor, cfg: ModelConfig,
                    return_state: bool = False, ff_math: bool = False):
    """The whole mamba2 mixer: projections, conv, SSD, gated norm, output
    projection.  ``return_state=True`` also returns ``{"ssm": the final
    state, "conv": the last W - 1 conv inputs}`` (fewer rows where S <
    W - 1, as the reference's slice)."""
    B, S, _ = x.shape
    di, H, P, N = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    z, xin, Bm, Cm, dt_raw = _projections(p, x, N)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xin = conv_out[..., :di]
    Bm = conv_out[..., di:di + N]
    Cm = conv_out[..., di + N:]

    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None, :],
                   ff_math)
    A = -_exp(p["A_log"], ff_math)                       # (H,) negative
    xh = xin.reshape(B, S, H, P)
    y, final = ssd_scan(xh.to(torch.float32), dt, A, Bm.to(torch.float32),
                        Cm.to(torch.float32), ff_math=ff_math)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    out = _gate_out(p, y.reshape(B, S, di).to(x.dtype), z, cfg)
    if return_state:
        return out, {"ssm": final,
                     "conv": conv_in[:, -(cfg.ssm_conv_width - 1):, :]}
    return out


def ssd_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Params:
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                             cfg.ssm_d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }


def ssd_decode_step(p: Params, x: Tensor, cfg: ModelConfig, state: Params,
                    ff_math: bool = False) -> Tuple[Tensor, Params]:
    """One token's recurrent update, x: (B, 1, d).  The state's tensors
    are updated in place (the reference returns a new pytree); the same
    dict is returned."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"ssd_decode_step takes one position, got {S}")
    W = cfg.ssm_conv_width
    if state["conv"].shape[1] != W - 1:
        raise ValueError(
            f"ssd_decode_step takes a conv state of W - 1 = {W - 1} rows, "
            f"got {state['conv'].shape[1]} (a prompt shorter than the conv "
            f"window; the reference's decode step fails there too)")
    di, H, P, N = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    dt_x = x.dtype
    z, xin, Bm, Cm, dt_raw = _projections(p, x, N)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)                # (B,1,C)
    window = torch.cat([state["conv"].to(dt_x), conv_in], dim=1)  # (B,W,C)
    w = p["conv_w"].to(dt_x)
    conv_out = F.silu((window * w[None]).sum(dim=1, keepdim=True)
                      + p["conv_b"].to(dt_x))
    xin = conv_out[..., :di]
    Bm = conv_out[..., di:di + N].to(torch.float32)
    Cm = conv_out[..., di + N:].to(torch.float32)

    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None, :],
                   ff_math)[:, 0]                             # (B,H)
    A = -_exp(p["A_log"], ff_math)
    decay = _exp(dt * A[None, :], ff_math)                    # (B,H)
    xh = xin.reshape(B, H, P).to(torch.float32)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm[:, 0], xh)
    st = state["ssm"].to(torch.float32) * decay[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", st, Cm[:, 0])
    y = y + xh * p["D"][None, :, None]
    out = _gate_out(p, y.reshape(B, 1, di).to(dt_x), z, cfg)
    state["ssm"].copy_(st)
    state["conv"].copy_(window[:, 1:])
    return out, state
