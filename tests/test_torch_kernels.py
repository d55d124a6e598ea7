"""The plain versions of the port's two CUDA kernels against the reference.

  * ``mean_sq`` (kernel: csrc/ff_mean_sq.cu): the plain version is bitwise
    the reference's CPU formulation and its TPU kernel ``run_pallas`` run
    in interpret mode.
  * FF flash attention (kernel: csrc/ff_attention.cu): the plain version
    ``flash_attention_ff`` is within 2^-40 of a numpy f64 oracle and of the
    reference's ``ff`` tier and interpret-mode Pallas kernel.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
to these plain versions there).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ff import dispatch as ref_dispatch
from repro.kernels import ff_attention as ref_attn
from repro_torch import ff as port_ff_ns
from repro_torch.kernels import ff_attention as port_attn
from repro_torch.kernels import ff_fused as port_fused

TOL = 2.0 ** -40


@pytest.mark.parametrize("shape", [(4, 2048), (64, 2048), (3, 1000)])
def test_mean_sq_plain_bitwise_reference(shape):
    rng = np.random.default_rng(21)
    x = (rng.standard_normal(shape)
         * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)
    got = port_fused.mean_sq_plain(torch.from_numpy(x)).numpy()
    want_jnp = np.asarray(ref_dispatch._mean_sq_jnp(jnp.asarray(x)))
    want_tpu = np.asarray(ref_dispatch._mean_sq_fused(jnp.asarray(x),
                                                      interpret=True))
    assert np.array_equal(got.view(np.uint32), want_jnp.view(np.uint32))
    assert np.array_equal(got.view(np.uint32), want_tpu.view(np.uint32))


def _oracle(q, k, v, causal, kv_len=None):
    """numpy f64 attention with the f32-rounded 1/sqrt(hd) scale (as the
    reference's ``attention_f64``: an exact f64 scale is itself off by
    ~2^-26 relative to what the FF tiers compute)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    sc = float(np.float32(1.0 / np.sqrt(hd)))
    q64 = q.astype(np.float64).reshape(B, Sq, KV, G, hd)
    s = np.einsum("bqkgd,bskd->bkgqs", q64, k.astype(np.float64)) * sc
    mask = np.ones((B, 1, 1, Sq, Skv), bool)
    if causal:
        mask &= (np.arange(Skv)[None, :] <= np.arange(Sq)[:, None])
    if kv_len is not None:
        mask &= (np.arange(Skv)[None, :] < kv_len[:, None])[:, None, None,
                                                            None]
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    o = np.einsum("bkgqs,bskd->bkgqd", p / p.sum(-1, keepdims=True),
                  v.astype(np.float64))
    return o.transpose(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _rel_err(got, want):
    """Max error relative to the per-(batch, head) max of the reference."""
    den = np.abs(want).max(axis=(1, 3), keepdims=True)
    return float((np.abs(got - want) / den).max())


def _f64(pair):
    return np.asarray(pair.hi, np.float64) + np.asarray(pair.lo, np.float64)


CASES = {
    # name: (B, Sq, Skv, H, KV, hd, causal, kv_len)
    "causal_gqa": (1, 16, 16, 4, 2, 32, True, None),
    "long_noncausal": (2, 4, 256, 2, 1, 32, False, None),
    "ragged_kv_len": (3, 1, 96, 4, 2, 32, False, [17, 96, 41]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_ff_plain_vs_oracle_and_reference(case):
    B, Sq, Skv, H, KV, hd, causal, kv_len = CASES[case]
    rng = np.random.default_rng(22)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    got = _f64(port_attn.flash_attention_ff(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_ff=True,
        kv_len=None if kl is None else torch.from_numpy(kl)))
    assert _rel_err(got, _oracle(q, k, v, causal, kl)) <= TOL
    ref_ff = _f64(ref_attn.flash_attention_ff(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        return_ff=True, kv_len=None if kl is None else jnp.asarray(kl)))
    assert _rel_err(got, ref_ff) <= TOL
    if kl is None:                      # the TPU kernel has static masks
        ref_tpu = _f64(ref_attn.flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            interpret=True, return_ff=True))
        assert _rel_err(got, ref_tpu) <= TOL


def test_pallas_tier_routes_kv_len_to_ff_with_warning():
    """A per-row kv_len sends ``impl="pallas"`` to the ff tier (the
    kernel's masks are static), with the reference's warning."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 32))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 32))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 32))
                         .astype(np.float32))
    kl = torch.tensor([9, 40], dtype=torch.int32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = port_ff_ns.attention(q, k, v, causal=False, kv_len=kl,
                                   impl="pallas", return_ff=True)
    assert any("kv_len" in str(w.message) for w in rec)
    want = port_attn.flash_attention_ff(q, k, v, causal=False, kv_len=kl,
                                        return_ff=True)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_fast_tier(case):
    """The f32 online softmax (the default ``attention`` tier) agrees with
    the oracle and the reference's fast tier to f32 working precision."""
    B, Sq, Skv, H, KV, hd, causal, kv_len = CASES[case]
    rng = np.random.default_rng(24)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    got = port_attn.flash_attention_fast(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_len=None if kl is None else torch.from_numpy(kl)
    ).numpy().astype(np.float64)
    assert _rel_err(got, _oracle(q, k, v, causal, kl)) <= 1e-5
    want = np.asarray(ref_attn.flash_attention_fast(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=None if kl is None else jnp.asarray(kl)), np.float64)
    assert _rel_err(got, want) <= 1e-5


def test_decode_attention_fast_matches_reference():
    """The engine's per-row-length decode attention (default fast tier)."""
    from repro.models.layers import decode_attention as ref_decode
    from repro_torch.models.layers import decode_attention
    rng = np.random.default_rng(25)
    q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((3, 40, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((3, 40, 2, 32)).astype(np.float32)
    lens = np.asarray([5, 40, 23], np.int32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(lens))
    want = ref_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert _rel_err(got.numpy().astype(np.float64),
                    _oracle(q, kc, vc, False, lens)) <= 1e-5
