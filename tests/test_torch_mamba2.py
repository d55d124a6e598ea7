"""The SSM family against the reference on the CPU: ``models/mamba2.py``
(the chunked SSD scan, ``_segsum`` under the FF exp, the whole mixer with
its state, the decode step continuing a prefill, the short-prompt case)
and reduced mamba2-370m served whole (``test_torch_families.
check_serving``: prefill and decode logits, greedy tokens) under
``ff_reduce`` and under ``ff_math``.

Tolerances.  ``ssd_scan`` is held to 1e-4 of each output's largest
magnitude, not bit for bit: XLA's ``cumsum`` and three-operand einsums and
torch's sum in their own orders, and a chunk's cumulative decay reaches
~|Q dt A| ~ 10^2, where one f32 ulp of the exponent moves a decay by
~1e-5 relative (the measured gap is <= 2e-5).  The mixer's output and
state: the same bound.  Whole models: ``test_torch_families.ATOL``.  The
reference runs with ``ff.use(exp="jnp", log1p="jnp")`` (its CPU tuning
table may pick an f64 tier the installed JAX cannot run), the port with
``"pallas"`` (each kernel's plain version on a CPU tensor).  Inputs come
from ``np.random.default_rng``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
import test_torch_families as families
from repro.models import mamba2 as ref_m
from repro_torch.models import mamba2 as port_m
from repro_torch.models import model as port_model

RTOL_MAX = 1e-4
REF_USE = dict(exp="jnp", log1p="jnp", mean_sq="jnp")
PORT_USE = dict(exp="pallas", log1p="pallas")

one_thread = families.one_thread


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _scan_inputs(S, init, seed=3, B=2, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    st = rng.standard_normal((B, H, P, N)).astype(np.float32) if init \
        else None
    return x, dt, A, Bm, Cm, st


# (S, an initial state, ff_math): every S and state with the builtin exp;
# the FF exp on one chunk of S and on two chunks, the last padded
SCAN_CASES = [(S, init, False) for S in (40, 256, 300)
              for init in (False, True)] + [(40, False, True),
                                           (300, True, True)]


@pytest.mark.parametrize("S, init, ff_math", SCAN_CASES)
def test_ssd_scan_matches_reference(S, init, ff_math):
    """S < CHUNK (one chunk of S), S = CHUNK, S = 300 (two chunks, the
    last zero-padded): y and the final state, with and without an
    initial state, with the builtin and the FF exp."""
    x, dt, A, Bm, Cm, st = _scan_inputs(S, init)
    with ref_ff.use(**REF_USE):
        fn = jax.jit(lambda *a: ref_m.ssd_scan(*a, ff_math=ff_math))
        yr, fr = fn(x, dt, A, Bm, Cm, st) if init else fn(x, dt, A, Bm, Cm)
    T = torch.from_numpy
    with port_ff.use(**PORT_USE):
        yp, fp = port_m.ssd_scan(T(x), T(dt), T(A), T(Bm), T(Cm),
                                 None if st is None else T(st),
                                 ff_math=ff_math)
    assert yp.shape == (2, S, 3, 4) and fp.shape == (2, 3, 4, 8)
    assert _rel(yp, yr) <= RTOL_MAX
    assert _rel(fp, fr) <= RTOL_MAX


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_segsum_exp_is_zero_above_the_diagonal(impl):
    """``_segsum`` puts -inf above the diagonal; the FF exp gives (0, 0)
    there (both limbs, no NaN), and the decays below it match the
    reference's; arguments below -103 (f32 exp's underflow) come out 0
    or subnormal, never NaN."""
    rng = np.random.default_rng(7)
    a = (-np.exp(rng.standard_normal((2, 3, 16))) * 4).astype(np.float32)
    a[0, 0, 8:] = -60.0                    # a tail below -103 cumulatively
    seg = port_m._segsum(torch.from_numpy(a))
    upper = torch.triu(torch.ones(16, 16, dtype=torch.bool), 1)
    assert bool(torch.isneginf(seg[..., upper]).all())
    assert bool(torch.isfinite(seg[..., ~upper]).all())
    r = port_ff.exp(seg, impl=impl)
    assert bool((r.hi[..., upper] == 0).all())
    assert bool((r.lo[..., upper] == 0).all())
    assert not bool(torch.isnan(r.hi).any() or torch.isnan(r.lo).any())
    assert float(seg.min()) < -103 and float(r.hi[seg < -104].max()) == 0
    with ref_ff.use(**REF_USE):
        want = np.asarray(jax.jit(
            lambda t: ref_m._exp(ref_m._segsum(t), True))(a))
    got = port_m._exp(seg, True)
    assert bool((got[..., upper] == 0).all()) and (want[..., upper] == 0).all()
    assert _rel(got, want) <= RTOL_MAX


def _mixer(seed=11):
    """Reduced mamba2's first SSD mixer (f32 compute), the port's weights
    and the same as jax arrays."""
    _, pcfg = families.serve_configs("mamba2-370m",
                                     compute_dtype="float32")
    w = port_model.init_params(pcfg, torch.Generator().manual_seed(seed))
    p = port_model.layer(w["layers"], 0)["mixer"]
    # A_log, dt_bias and D away from their init so each enters the result
    g = torch.Generator().manual_seed(seed + 1)
    H = pcfg.ssm_heads
    p = dict(p, A_log=0.5 * torch.randn(H, generator=g),
             dt_bias=0.5 * torch.randn(H, generator=g),
             D=1 + 0.1 * torch.randn(H, generator=g))
    return pcfg, p, families.to_jax(p)


@pytest.mark.parametrize("ff_math", [False, True])
def test_ssd_block_apply_with_state_matches_reference(ff_math):
    pcfg, p, pj = _mixer()
    x = np.random.default_rng(5).standard_normal(
        (2, 20, pcfg.d_model)).astype(np.float32)
    with ref_ff.use(**REF_USE):
        ref_out, ref_st = jax.jit(lambda w, t: ref_m.ssd_block_apply(
            w, t, pcfg, return_state=True, ff_math=ff_math))(pj, x)
    with port_ff.use(**PORT_USE):
        out, st = port_m.ssd_block_apply(p, torch.from_numpy(x), pcfg,
                                         return_state=True, ff_math=ff_math)
    assert _rel(out, ref_out) <= RTOL_MAX
    assert _rel(st["ssm"], ref_st["ssm"]) <= RTOL_MAX
    assert st["conv"].shape == (2, pcfg.ssm_conv_width - 1,
                                pcfg.ssm_d_inner + 2 * pcfg.ssm_state)
    assert _rel(st["conv"], ref_st["conv"]) <= RTOL_MAX


@pytest.mark.parametrize("ff_math", [False, True])
def test_ssd_decode_step_continues_a_prefill(ff_math):
    """A prefill of 12 positions, then two decode steps: each step's
    output equals the 13th / 14th position of one 14-position pass (the
    recurrence is the scan's), and the reference's decode steps."""
    pcfg, p, pj = _mixer()
    x = np.random.default_rng(6).standard_normal(
        (2, 14, pcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    with port_ff.use(**PORT_USE):
        whole = port_m.ssd_block_apply(p, xt, pcfg, ff_math=ff_math)
        _, st = port_m.ssd_block_apply(p, xt[:, :12], pcfg,
                                       return_state=True, ff_math=ff_math)
        steps = []
        for i in (12, 13):
            o, st = port_m.ssd_decode_step(p, xt[:, i:i + 1], pcfg, st,
                                           ff_math=ff_math)
            steps.append(o)
    with ref_ff.use(**REF_USE):
        _, rst = jax.jit(lambda w, t: ref_m.ssd_block_apply(
            w, t, pcfg, return_state=True, ff_math=ff_math))(pj, x[:, :12])
        dec = jax.jit(lambda w, t, s: ref_m.ssd_decode_step(
            w, t, pcfg, s, ff_math=ff_math))
        ref_steps = []
        for i in (12, 13):
            o, rst = dec(pj, jnp.asarray(x[:, i:i + 1]), rst)
            ref_steps.append(o)
    for j, i in enumerate((12, 13)):
        assert _rel(steps[j], whole[:, i:i + 1]) <= RTOL_MAX
        assert _rel(steps[j], ref_steps[j]) <= RTOL_MAX
    assert _rel(st["ssm"], rst["ssm"]) <= RTOL_MAX
    assert _rel(st["conv"], rst["conv"]) <= RTOL_MAX


def test_short_prompt_state_as_reference_and_prefill_raises():
    """A prompt shorter than W - 1 = 3: the reference's mixer returns a
    conv state of S rows and its decode step then fails on it; the port's
    mixer returns the same short state, its prefill runs (the cache's
    conv state takes S rows, as the reference's) and a decode step after
    it raises ``ValueError`` naming the conv state."""
    pcfg, p, pj = _mixer()
    x = np.random.default_rng(8).standard_normal(
        (2, 2, pcfg.d_model)).astype(np.float32)
    _, rst = jax.jit(lambda w, t: ref_m.ssd_block_apply(
        w, t, pcfg, return_state=True))(pj, x)
    assert rst["conv"].shape[1] == 2
    with pytest.raises((TypeError, ValueError)):
        ref_m.ssd_decode_step(pj, jnp.asarray(x[:, :1]), pcfg, rst)
    _, st = port_m.ssd_block_apply(p, torch.from_numpy(x), pcfg,
                                   return_state=True)
    assert st["conv"].shape == tuple(rst["conv"].shape)
    assert _rel(st["conv"], rst["conv"]) <= RTOL_MAX
    w = port_model.init_params(pcfg, torch.Generator().manual_seed(0))
    cache = port_model.init_cache(pcfg, 2, 8, torch.float32, device="cpu")
    tokens = torch.zeros((2, 2), dtype=torch.long)
    logits, cache = port_model.prefill(w, {"tokens": tokens}, pcfg, cache)
    assert logits.shape == (2, pcfg.vocab_size)
    assert cache["layers"]["conv"].shape[2] == 2
    with pytest.raises(ValueError, match="conv state"):
        port_model.decode_step(w, tokens[:, :1], 2, cache, pcfg)


def test_short_prompt_prefill_matches_reference():
    families.check_short_prompt("mamba2-370m")


@pytest.mark.parametrize("pol", ["ff_reduce", "ff_math"])
def test_prefill_and_decode_logits_match_reference(pol):
    families.check_serving("mamba2-370m", pol, "logits")


@pytest.mark.parametrize("pol", ["ff_reduce", "ff_math"])
def test_greedy_generate_matches_reference(pol):
    families.check_serving("mamba2-370m", pol, "tokens")
