"""The port's training slice against the reference.

  * ``adamw_update_plain`` (the plain version of csrc/ff_adamw.cu) is
    bitwise the reference's ``ff.adamw_update``, both its op-by-op
    ``jnp`` impl and its TPU kernel ``run_pallas`` in interpret mode;
  * each ``torch.autograd.Function`` of ``repro_torch.ff.autodiff`` gives
    the gradient ``jax.grad`` gives through the reference op;
  * ``SyntheticLM`` batches are the reference's bit for bit;
  * a reduced granite-3-2b takes 3 ``make_train_step`` steps in both
    packages from the same weights and optimizer state under
    ``policy("ff_reduce", attention="pallas")``, and under it with
    ``ff_math=True`` (the FF silu gate, with ``silu="jnp"`` in both);
    ``Trainer.run`` and the launcher run end to end.

The reference runs with explicit non-f64 impls (its CPU defaults include
f64 tiers the installed JAX cannot run, and the CPU tuning table):
``ff.use(logsumexp="jnp", mean_sq="jnp", sum="blocked", add="jnp",
adamw_update="jnp")``.  Its attention tier ``"pallas"`` is the
interpret-mode Pallas kernel; the port's is its plain version on the CPU.

Tolerances (stated with each test): bitwise where both packages run the
same IEEE ops in the same order; otherwise the summation order of matrix
products and reductions (XLA's against PyTorch's) and the f32 builtins
(``exp``, ``cos``) differ by ulps, which Adam's normalised step can turn
into sign flips of near-zero gradient elements.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro.train.train_step import make_train_step as ref_make_train_step
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config as port_get_config
from repro_torch.core import ff as core_ff
from repro_torch.core import selfcheck
from repro_torch.core.ff import FF
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.interop import opt_state_from_numpy, params_from_numpy
from repro_torch.kernels import ff_fused
from repro_torch.optim import adamw as port_adamw
from repro_torch.train.train_step import make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_families import one_thread  # noqa: F401 (module fixture)

ROOT = Path(__file__).resolve().parents[1]
REF_PINS = dict(logsumexp="jnp", mean_sq="jnp", sum="blocked", add="jnp",
                adamw_update="jnp")
SCALARS = (1e-3, 0.9, 0.95, 0.1, 0.05)     # lr, b1, b2, bc1, bc2
EPS, WD = 1e-8, 0.1


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True))


# ---------------------------------------------------------------------------
# adamw_update: the plain version of the kernel, bitwise the reference
# ---------------------------------------------------------------------------

def _adamw_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    g, m, w = mk(), mk(0.1), mk()
    v = np.abs(mk(0.01))
    wlo = mk(1e-8)
    return g, m, v, w, wlo


def _ref_adamw(impl, leaves, jit):
    scal = tuple(jnp.float32(s) for s in SCALARS)
    extra = dict(interpret=True) if impl == "fused" else {}
    fn = lambda *a: ref_ff.adamw_update(  # noqa: E731
        *a, eps=EPS, wd=WD, impl=impl, **extra)
    out = (jax.jit(fn) if jit else fn)(*(jnp.asarray(x) for x in leaves),
                                      *scal)
    return [np.asarray(x) for x in (out[0].hi, out[0].lo, out[1], out[2])]


def _xla_rewritten(leaves):
    """The AdamW chain as XLA compiles it: its algebraic simplifier turns
    ``(m2 / bc1) / den`` into ``m2 / (bc1 * den)``, one rounding fewer,
    in any jitted chain and in the interpret-mode Pallas kernel."""
    g, m, v, w, wlo = (_t(x) for x in leaves)
    lr, b1, b2, bc1, bc2 = (torch.tensor(s) for s in SCALARS)
    m2 = b1 * m + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * g * g
    den = ff_fused.sqrt_rn(v2 / bc2) + ff_fused.f32_scalar(EPS)
    upd = m2 / (bc1 * den) + ff_fused.f32_scalar(WD) * w
    new = core_ff.add212(FF(w, wlo), -lr * upd)
    return [x.numpy() for x in (new.hi, new.lo, m2, v2)]


@pytest.mark.parametrize("shape", [(33, 257), (3, 17, 40)])
def test_adamw_update_plain_bitwise_reference(shape):
    """0 ulp on all four outputs against the reference's op-by-op ``jnp``
    impl (the chain in its written order, every op correctly rounded: what
    the TPU kernel and the CUDA kernel compute), and against its TPU
    kernel ``run_pallas`` in interpret mode once XLA's rewrite of the
    division (``_xla_rewritten``) is applied to the same chain: the two
    reference impls differ from each other by exactly that rewrite."""
    leaves = _adamw_inputs(shape, seed=51)
    g, m, v, w, wlo = (_t(x) for x in leaves)
    ff_fused.adamw_update_plain(g, m, v, w, wlo,
                                *(torch.tensor(s) for s in SCALARS),
                                eps=EPS, wd=WD)
    got = [x.numpy() for x in (w, wlo, m, v)]
    for want, port in ((_ref_adamw("jnp", leaves, jit=False), got),
                       (_ref_adamw("fused", leaves, jit=False),
                        _xla_rewritten(leaves)),
                       (_ref_adamw("jnp", leaves, jit=True),
                        _xla_rewritten(leaves))):
        for name, r, p in zip(("w", "wlo", "m", "v"), want, port):
            assert np.array_equal(_bits(r), _bits(p)), name


def test_adamw_update_in_place_and_dispatch():
    """The update writes ``w``, ``wlo``, ``m`` and ``v`` in place and reads
    only ``g``; on CPU tensors the dispatch default and the kernel wrapper
    take the plain version and launch nothing."""
    leaves = [_t(x) for x in _adamw_inputs((40, 24), seed=52)]
    scal = [torch.tensor(s) for s in SCALARS]
    n0 = ff_fused.adamw_update.launches
    assert port_ff.resolve_name("adamw_update", device="cpu") == "jnp"
    assert port_ff.resolve_name("adamw_update", device="cuda") == "fused"
    want = [x.clone() for x in leaves]
    ff_fused.adamw_update_plain(*want, *scal, eps=EPS, wd=WD)
    got = [x.clone() for x in leaves]
    port_ff.adamw_update(*got, *scal, eps=EPS, wd=WD, impl="fused")
    assert torch.equal(got[0], leaves[0])              # g is only read
    for i, name in ((3, "w"), (4, "wlo"), (1, "m"), (2, "v")):
        assert not torch.equal(got[i], leaves[i]), name
        assert torch.equal(got[i], want[i]), name
    assert ff_fused.adamw_update.launches == n0
    with pytest.raises(RuntimeError, match="no kernel"):
        ff_fused.adamw_update(*(torch.empty(4, device="meta")
                                for _ in range(5)), *scal, eps=EPS, wd=WD)


# ---------------------------------------------------------------------------
# the autograd Functions against jax.grad of the reference ops
# ---------------------------------------------------------------------------

def _port_grad(fn, *xs):
    ts = [_t(x).requires_grad_() for x in xs]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


def test_sum_grad_matches_reference():
    """Bitwise: the cotangent broadcast over the summed axis."""
    rng = np.random.default_rng(53)
    x = rng.standard_normal((5, 300)).astype(np.float32)
    wt = rng.standard_normal(5).astype(np.float32)
    with ref_ff.use(**REF_PINS):
        want = jax.grad(lambda a: jnp.sum(
            ref_ff.sum(a, axis=-1).to_f32() * wt))(jnp.asarray(x))
    (got,) = _port_grad(lambda a: (port_ff.sum(a, axis=-1).to_f32()
                                   * _t(wt)).sum(), x)
    assert np.array_equal(_bits(want), _bits(got))


def test_mean_sq_grad_matches_reference():
    """Bitwise: x * (2g / n) in both."""
    rng = np.random.default_rng(54)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    wt = rng.standard_normal(6).astype(np.float32)
    with ref_ff.use(**REF_PINS):
        want = jax.grad(lambda a: jnp.sum(ref_ff.mean_sq(a) * wt))(
            jnp.asarray(x))
    (got,) = _port_grad(lambda a: (port_ff.mean_sq(a) * _t(wt)).sum(), x)
    assert np.array_equal(_bits(want), _bits(got))


def test_logsumexp_grad_matches_reference():
    """Within 4 f32 ulps of the gradient's scale (g * exp(x - out): the
    f32 exp of XLA and of PyTorch differ by ulps)."""
    rng = np.random.default_rng(55)
    x = (rng.standard_normal((4, 700)) * 3).astype(np.float32)
    wt = rng.standard_normal(4).astype(np.float32)
    with ref_ff.use(**REF_PINS):
        want = np.asarray(jax.grad(lambda a: jnp.sum(
            ref_ff.logsumexp(a, axis=-1) * wt))(jnp.asarray(x)))
    (got,) = _port_grad(lambda a: (port_ff.logsumexp(a, axis=-1)
                                   * _t(wt)).sum(), x)
    assert np.abs(got - want).max() <= 4 * 2.0 ** -24 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grad_matches_reference(dtype):
    """The accurate tier's gradient is the fast recurrence's in both
    packages: within 1e-5 (f32) or 2e-2 (bf16 operands and gradients) of
    the largest gradient element; the two recurrences sum in different
    orders."""
    rng = np.random.default_rng(56)
    B, S, H, KV, hd = 2, 40, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    r = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(causal=True, block_q=16, block_kv=16, impl="pallas")
    with ref_ff.use(**REF_PINS):
        want = jax.grad(
            lambda a, b, c: jnp.sum(ref_ff.attention(a, b, c, **kw)
                                    .astype(jnp.float32) * r),
            argnums=(0, 1, 2))(*(jnp.asarray(t, jdt) for t in (q, k, v)))
    ts = [_t(t).to(tdt).requires_grad_() for t in (q, k, v)]
    (port_ff.attention(*ts, **kw).float() * _t(r)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip("qkv", want, ts):
        a = np.asarray(a.astype(jnp.float32))
        b = b.grad.float().numpy()
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), name


# ---------------------------------------------------------------------------
# data, optimizer pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host", [0, 1])
def test_synthetic_lm_batches_bitwise(host):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=6, seed=3)
    ref = RefSyntheticLM(RefDataConfig(**kw), host_id=host, num_hosts=2)
    port = SyntheticLM(DataConfig(**kw), host_id=host, num_hosts=2)
    for i in (0, 1, 17):
        a, b = ref.batch(i), port.batch(i)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])


@pytest.mark.parametrize("ff_master", [True, False])
def test_adamw_optimizer_steps_bitwise_reference(ff_master):
    """Three updates of a small parameter tree at a constant rate: the
    bias corrections (f32 powers of b1, b2 at counts 1-3) and every leaf
    update are the reference's bits, in both arms.  The reference runs op
    by op here: jitted, XLA rewrites its divisions (see
    ``_xla_rewritten``)."""
    rng = np.random.default_rng(57)
    tree = {"a": rng.standard_normal((7, 9)).astype(np.float32),
            "b": {"c": rng.standard_normal(13).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        tree) for _ in range(3)]
    ropt = ref_adamw.AdamW(learning_rate=3e-3, ff=ff_master)
    popt = port_adamw.AdamW(learning_rate=3e-3, ff=ff_master)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    rs = ropt.init(rp)
    pp = params_from_numpy(tree, device="cpu")
    ps = popt.init(pp)
    with ref_ff.use(**REF_PINS):
        for g in grads:
            rp, rs = ropt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 rs, rp)
            pp, ps = popt.update(params_from_numpy(g, device="cpu"), ps, pp)
    assert int(ps.count) == int(rs.count) == 3
    for ref_t, port_t in ((rp, pp), (rs.master_lo, ps.master_lo),
                          (rs.m, ps.m), (rs.v, ps.v)):
        for a, b in zip(jax.tree_util.tree_leaves(ref_t),
                        port_adamw.tree_leaves(port_t)):
            assert np.array_equal(_bits(a), _bits(b.numpy()))


def test_cosine_schedule_and_grad_norm_match_reference():
    """The schedule within base_lr * 2^-22: the f32 cos of XLA and of
    PyTorch may differ by an ulp (<= 2^-24 absolute), which moves the rate
    by <= 0.45 * base_lr * 2^-24, plus an ulp of each later rounding; the
    global norm, plain and FF-accumulated, within 1e-6 relative (per-leaf
    sums in different orders); clipping scales to ``max_norm``."""
    rs = ref_adamw.cosine_schedule(3e-4, 10, 50)
    ps = port_adamw.cosine_schedule(3e-4, 10, 50)
    for c in range(0, 60, 3):
        a = float(rs(jnp.int32(c)))
        b = float(ps(torch.tensor(c, dtype=torch.int32)))
        assert abs(a - b) <= 3e-4 * 2.0 ** -22, c
    rng = np.random.default_rng(58)
    tree = {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": {"c": (rng.standard_normal(500) * 1e-3).astype(np.float32)}}
    for ff_on in (False, True):
        with ref_ff.use(**REF_PINS):
            want = float(ref_adamw.global_grad_norm(
                jax.tree_util.tree_map(jnp.asarray, tree), ff=ff_on))
        got = float(port_adamw.global_grad_norm(
            params_from_numpy(tree, device="cpu"), ff=ff_on))
        assert abs(got - want) <= 1e-6 * want
    port_tree = params_from_numpy(tree, device="cpu")
    clipped, n = port_adamw.clip_by_global_norm(port_tree, 1.0, ff=True)
    assert clipped is port_tree and float(n) > 1.0
    assert abs(float(port_adamw.global_grad_norm(clipped)) - 1.0) <= 1e-5


# ---------------------------------------------------------------------------
# the training step end to end: reduced granite-3-2b in both packages
# ---------------------------------------------------------------------------

# (compute dtype, microbatches, loss_chunk or None, seq, rel tol on loss and
# grad norm, rel tol on m and v of the leaf's largest element, and the
# master weights: at most the fraction ``w_frac`` of the elements differ by
# more than ``w_tol`` * sum(lr); ff_math: the policy's FF silu gate)
STEP_CASES = {
    # f32: only the summation orders differ
    "f32": ("float32", 1, None, 32, 1e-5, 1e-5, 1e-3, 1e-3, False),
    # bf16 activations: the two frameworks round at other places, ~2^-8
    "bf16": ("bfloat16", 1, None, 32, 2e-3, 1e-1, 1e-1, 1e-2, False),
    # microbatches with the FF loss carry; the chunked CE over a padded
    # last chunk; remat through torch.utils.checkpoint
    "f32-mb2-chunked-remat": ("float32", 2, 24, 40, 1e-5, 1e-5, 1e-3, 1e-3,
                              False),
    # under ff_math: the gate is the FF silu in both (bitwise, with its FF
    # gradient); only the summation orders differ, as in "f32"
    "f32-ff_math": ("float32", 1, None, 32, 1e-5, 1e-5, 1e-3, 1e-3, True),
    # ... and its recompute under remat, microbatches, the chunked loss
    "f32-mb2-chunked-remat-ff_math": ("float32", 2, 24, 40, 1e-5, 1e-5,
                                      1e-3, 1e-3, True),
}
STEPS, LR, WARMUP = 3, 3e-4, 10


def _reduced(get_config, dtype, chunk, arch="granite-3-2b"):
    extra = dict(compute_dtype=dtype)
    if chunk is not None:
        extra.update(loss_chunk=chunk, remat=True)
    return get_config(arch).reduced(**extra)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_reference(case):
    steps_match_reference("granite-3-2b", case)


def steps_match_reference(arch, case, seq=None, port_init=False):
    """``STEP_CASES[case]`` on reduced ``arch`` (``seq`` overrides the
    case's sequence length; ``port_init`` draws the weights with the
    port's init, else the reference's).

    Loss, aux and grad norm at every step within ``tol``; the Adam moments
    within ``mv_tol`` of each leaf's largest element (they carry the
    gradients elementwise).  The FF master weights ``w + master_lo``
    (float64 sums of the limbs) within 2 * sum(lr) everywhere: an Adam
    step moves an element by ~lr at most, so a gradient element near 0
    whose sign the two packages' roundings flip can differ by 2 lr a
    step, and no more.  Such elements are few: all but the fraction
    ``w_frac`` lie within ``w_tol`` * sum(lr), where three steps move the
    median element by ~sum(lr) / 2, so an update that is skipped or wrong
    fails.  Under ``ff_math`` the reference pins ``silu="jnp"`` and the
    port runs its steps inside ``ff.use(silu="jnp")``."""
    (dtype, mb, chunk, case_seq, tol, mv_tol, w_tol, w_frac,
     ff_math) = STEP_CASES[case]
    seq = seq or case_seq
    rcfg = _reduced(ref_get_config, dtype, chunk,
                    arch.replace("-", "_").replace(".", "_"))
    pcfg = _reduced(port_get_config, dtype, chunk, arch)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if port_init:
        pparams = _port_init(pcfg)
        rparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                         pparams)
    else:
        rparams = ref_init_params(rcfg, jax.random.PRNGKey(0))
        pparams = params_from_numpy(as_np(rparams), device="cpu")
    ropt = ref_adamw.AdamW(
        learning_rate=ref_adamw.cosine_schedule(LR, WARMUP, STEPS))
    rstate = ropt.init(rparams)
    pstate = opt_state_from_numpy(as_np(rstate), device="cpu")
    popt = port_adamw.AdamW(
        learning_rate=port_adamw.cosine_schedule(LR, WARMUP, STEPS))
    data = SyntheticLM(DataConfig(vocab_size=rcfg.vocab_size, seq_len=seq,
                                  global_batch=4))
    batches = [data.batch(i) for i in range(STEPS)]

    pins = dict(silu="jnp") if ff_math else {}
    with ref_ff.policy("ff_reduce", attention="pallas", ff_math=ff_math), \
            ref_ff.use(**REF_PINS, **pins):
        rstep = jax.jit(ref_make_train_step(rcfg, None, ropt,
                                            microbatches=mb))
        ref_m = []
        for b in batches:
            rparams, rstate, m = rstep(
                rparams, rstate, {k: jnp.asarray(x) for k, x in b.items()})
            ref_m.append({k: float(x) for k, x in m.items()})
    with port_ff.policy("ff_reduce", attention="pallas", ff_math=ff_math):
        pstep = make_train_step(pcfg, None, popt, microbatches=mb)
    port_m = []
    with port_ff.use(**pins):
        for b in batches:
            pparams, pstate, m = pstep(
                pparams, pstate,
                {k: torch.from_numpy(x) for k, x in b.items()})
            port_m.append({k: float(x) for k, x in m.items()})

    for i, (a, b) in enumerate(zip(ref_m, port_m)):
        assert np.isfinite(b["loss"]) and np.isfinite(b["grad_norm"])
        for key in ("loss", "aux", "grad_norm"):
            assert abs(a[key] - b[key]) <= tol * abs(a[key]), (i, key)
        assert a["lr"] == b["lr"]
    assert int(pstate.count) == STEPS
    sched = port_adamw.cosine_schedule(LR, WARMUP, STEPS)
    bound = 2 * sum(float(sched(torch.tensor(c))) for c in
                    range(1, STEPS + 1))
    master = lambda w, lo: (np.asarray(w, np.float64)  # noqa: E731
                            + np.asarray(lo, np.float64))
    diff = np.concatenate([
        np.abs(master(a, alo) - master(b.numpy(), blo.numpy())).ravel()
        for a, alo, b, blo in zip(
            jax.tree_util.tree_leaves(rparams),
            jax.tree_util.tree_leaves(rstate.master_lo),
            port_adamw.tree_leaves(pparams),
            port_adamw.tree_leaves(pstate.master_lo))])
    assert diff.max() <= bound
    assert np.mean(diff > w_tol * bound / 2) <= w_frac
    for name in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(rstate, name)),
                        port_adamw.tree_leaves(getattr(pstate, name))):
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= mv_tol * np.abs(a).max()


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_ff_math_gate_grad_matches_reference(impl):
    """The gradient of the SwiGLU MLP under ``ff_math`` (the FF silu
    gate, its FF derivative s (1 + x (1 - s)) through the f32 boundary)
    with respect to the input and the three weights: within 1e-6 of each
    one's largest element against the reference with ``silu="jnp"`` (the
    gate's gradient is bitwise; the three products add in other orders),
    and bit for bit between the port's tiers (the kernel tier's backward
    runs sigmoid22 through ``math_elementwise``, its plain version
    here)."""
    from repro.models.layers import mlp_apply as ref_mlp
    from repro_torch.models.layers import mlp_apply
    rng = np.random.default_rng(59)
    p = {k: (rng.standard_normal(s) / 4).astype(np.float32) for k, s in
         (("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
    x = (rng.standard_normal((3, 5, 16)) * 2).astype(np.float32)
    r = rng.standard_normal((3, 5, 16)).astype(np.float32)
    with ref_ff.use(silu="jnp"):
        want = jax.grad(lambda w, a: jnp.sum(ref_mlp(w, a, ff_math=True) * r),
                        argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = {}
    for tier in ("jnp", impl):
        pt = {k: _t(v).requires_grad_() for k, v in p.items()}
        xt = _t(x).requires_grad_()
        with port_ff.use(silu=tier):
            (mlp_apply(pt, xt, ff_math=True) * _t(r)).sum().backward()
        got[tier] = {**{k: t.grad for k, t in pt.items()}, "x": xt.grad}
    for k in ("w_gate", "w_up", "w_down", "x"):
        a = np.asarray(want[1] if k == "x" else want[0][k])
        b = got[impl][k].numpy()
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), k
        assert torch.equal(got["jnp"][k], got[impl][k]), k


def test_remat_gives_the_same_step():
    """``cfg.remat`` recomputes each layer in the backward pass: the same
    losses, gradients and parameters, bit for bit; the eval step gives the
    training loss without gradients."""
    out = []
    for remat in (False, True):
        cfg = port_get_config("granite-3-2b").reduced(
            compute_dtype="float32", remat=remat)
        params = port_adamw.tree_map(
            lambda t: t.clone(), _port_init(cfg))
        opt = port_adamw.AdamW(learning_rate=1e-3)
        state = opt.init(params)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                      global_batch=2))
        with port_ff.policy("ff_reduce", attention="pallas"):
            step = make_train_step(cfg, None, opt)
            evals = make_eval_step(cfg)
        batch = {k: torch.from_numpy(x) for k, x in data.batch(0).items()}
        ev = evals(params, batch)
        params, state, m = step(params, state, batch)
        assert ev["loss"].requires_grad is False
        assert torch.equal(ev["loss"], m["loss"])
        out.append((m, params))
    (m0, p0), (m1, p1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for a, b in zip(port_adamw.tree_leaves(p0), port_adamw.tree_leaves(p1)):
        assert torch.equal(a, b)


def _port_init(cfg):
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator().manual_seed(0))


def test_trainer_mean_loss_matches_reference(tmp_path):
    """``Trainer.run``: the FF-accumulated mean loss within 1e-5 relative
    (f32 compute; the per-step losses match to that), the same step and
    straggler counts."""
    rcfg = _reduced(ref_get_config, "float32", None)
    pcfg = _reduced(port_get_config, "float32", None)
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(1))
    pparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, rparams),
                                device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=rcfg.vocab_size, seq_len=16,
                                  global_batch=2))
    tcfg = dict(total_steps=3, log_every=1)
    logs = []
    with ref_ff.policy("ff_reduce", attention="pallas"), \
            ref_ff.use(**REF_PINS):
        ropt = ref_adamw.AdamW(learning_rate=1e-3)
        rstep = jax.jit(ref_make_train_step(rcfg, None, ropt))
        want = RefTrainer(
            RefTrainerConfig(**tcfg), rstep, rparams, ropt.init(rparams),
            lambda i: {k: jnp.asarray(x) for k, x in data.batch(i).items()},
            log_fn=lambda s: None).run()
    with port_ff.policy("ff_reduce", attention="pallas"):
        popt = port_adamw.AdamW(learning_rate=1e-3)
        pstep = make_train_step(pcfg, None, popt)
    got = Trainer(
        TrainerConfig(**tcfg), pstep, pparams, popt.init(pparams),
        lambda i: {k: torch.from_numpy(x) for k, x in data.batch(i).items()},
        log_fn=logs.append).run()
    assert got["step"] == want["step"] == 3
    assert got["straggler_events"] == want["straggler_events"]
    assert abs(got["mean_loss"] - want["mean_loss"]) <= \
        1e-5 * abs(want["mean_loss"])
    assert abs(got["last_loss"] - want["last_loss"]) <= \
        1e-5 * abs(want["last_loss"])
    assert len(logs) == 3 and logs[-1].startswith("[trainer] step 3 loss")
    # a ckpt_dir with no checkpoint in it: nothing to resume from
    assert not Trainer(TrainerConfig(ckpt_dir=str(tmp_path)), pstep,
                       pparams, None, None).restore()


def test_launch_train_cpu_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "granite-3-2b", "--reduced", "--steps", "2", "--seq",
         "32", "--policy", "ff_reduce"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "[train] done: {'step': 2" in out.stdout


def test_selfcheck_passes_on_cpu_and_reports_failures(monkeypatch):
    assert selfcheck.check_eft_safe("cpu") == {
        "contraction": True, "tf32": True, "ftz": True}
    assert selfcheck.require_eft_safe(device="cpu")
    monkeypatch.setattr(selfcheck, "check_eft_safe", lambda device=None: {
        "contraction": True, "tf32": False, "ftz": True})
    with pytest.warns(RuntimeWarning, match="TF32"):
        assert not selfcheck.require_eft_safe(device="cpu")
    with pytest.raises(RuntimeError, match="TF32"):
        selfcheck.require_eft_safe(strict=True, device="cpu")
