"""Training of the SSM family against the reference on the CPU: reduced
mamba2-370m's ``train_forward`` loss and every gradient leaf under
``ff_reduce`` and under ``ff_math`` (the SSD's FF exp and log1p, through
their FF backward), the SSD scan's gradients over two chunks (S = 300 >
``CHUNK`` = 256: the chunk recurrence, the zero padding), the gradient
through ``_segsum``'s -inf triangle, softplus's gradient at its kink
x = 0, and three ``make_train_step`` steps against the reference's.

Tolerances (``test_torch_train_families``): losses within 1e-4, each
gradient leaf within 1e-4 of the leaf's largest |g|, ``ssd_scan``'s
gradients within 1e-4 of each one's largest element (the scan's sums run
in XLA's and torch's orders, ``tests/test_torch_mamba2.py``), the steps
at ``test_torch_train.STEP_CASES["f32"]``'s.  The reference runs with
``ff.use(exp="jnp", log1p="jnp")``, the port with ``"pallas"`` (each
kernel's plain version on a CPU tensor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
import test_torch_mamba2 as mamba2_tests
import test_torch_train as train_tests
import test_torch_train_families as tf
from repro.models import mamba2 as ref_m
from repro_torch.models import mamba2 as port_m

RTOL_MAX = mamba2_tests.RTOL_MAX

one_thread = tf.one_thread


@pytest.mark.parametrize("pol", ["ff_reduce", "ff_math"])
def test_train_forward_grads_match_reference(pol):
    tf.check_grads("mamba2-370m", pol)


@pytest.mark.parametrize("ff_math", [False, True])
def test_ssd_scan_grads_match_reference(ff_math):
    """S = 300 (two chunks, the last zero-padded) from an initial state:
    the gradients of y and the final state with respect to x, dt, A, B, C
    and the state, each finite and within 1e-4 of its largest element,
    with the builtin and the FF exp (whose backward runs through the -inf
    triangle of ``_segsum``)."""
    ins = mamba2_tests._scan_inputs(300, True, seed=13)
    rng = np.random.default_rng(14)
    ry = rng.standard_normal((2, 300, 3, 4)).astype(np.float32)
    rf = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)

    def ref_loss(*a):
        y, f = ref_m.ssd_scan(*a, ff_math=ff_math)
        return jnp.sum(y * ry) + jnp.sum(f * rf)

    with ref_ff.use(**mamba2_tests.REF_USE):
        want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(6))))(*ins)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    with port_ff.use(**mamba2_tests.PORT_USE):
        y, f = port_m.ssd_scan(*ts, ff_math=ff_math)
        ((y * torch.from_numpy(ry)).sum()
         + (f * torch.from_numpy(rf)).sum()).backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C", "state"), ts, want):
        assert bool(torch.isfinite(t.grad).all()), name
        assert mamba2_tests._rel(t.grad, w) <= RTOL_MAX, name


@pytest.mark.parametrize("ff_math, impl", [(False, "jnp"), (True, "jnp"),
                                           (True, "pallas")])
def test_segsum_backward_is_zero_above_the_diagonal(ff_math, impl):
    """exp(-inf) = 0 above ``_segsum``'s diagonal: the cotangent reaching
    the -inf entries is exactly 0 (the FF exp's backward multiplies by
    its (0, 0) output; torch's by exp(-inf)), so ``a``'s gradient is
    finite and, within 1e-4 of its largest element, jax's (whose ``where``
    drops those entries)."""
    rng = np.random.default_rng(15)
    a = (-np.exp(rng.standard_normal((2, 3, 16))) * 4).astype(np.float32)
    r = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    with ref_ff.use(exp="jnp"):
        want = jax.jit(jax.grad(lambda t: jnp.sum(
            ref_m._exp(ref_m._segsum(t), ff_math) * r)))(a)
    at = torch.from_numpy(a).requires_grad_()
    seg = port_m._segsum(at)
    seg.retain_grad()
    with port_ff.use(exp=impl):
        (port_m._exp(seg, ff_math) * torch.from_numpy(r)).sum().backward()
    upper = torch.triu(torch.ones(16, 16, dtype=torch.bool), 1)
    assert bool((seg.grad[..., upper] == 0).all())
    assert bool(torch.isfinite(at.grad).all())
    assert mamba2_tests._rel(at.grad, want) <= RTOL_MAX


@pytest.mark.parametrize("ff_math", [False, True])
def test_softplus_grad_at_the_kink_matches_reference(ff_math):
    """dt = softplus(x) at x = +-0 exactly, bit for bit: the reference's
    builtin ``jax.nn.softplus`` has the derivative sigmoid(0) = 1/2 there,
    its FF form max(x, 0) + log1p(exp(-|x|)) has 1/2 - 1/2 = 0 (jax's
    ``max`` splits a tie in halves, its ``abs`` has the derivative +1 at
    0), and the port gives each; elsewhere within 1e-6 relative (f32 exp
    and log1p of the two frameworks)."""
    x = np.array([0.0, -0.0, 1e-3, -1e-3, 0.5, -0.5, 3.0, -3.0, 20.0,
                  -20.0], np.float32)
    with ref_ff.use(exp="jnp", log1p="jnp"):
        want = np.asarray(jax.grad(lambda t: jnp.sum(
            ref_m._softplus(t, ff_math)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    with port_ff.use(exp="pallas", log1p="pallas"):
        port_m._softplus(xt, ff_math).sum().backward()
    got = xt.grad.numpy()
    kink = 0.0 if ff_math else 0.5
    assert got[0] == want[0] == kink and got[1] == want[1] == kink
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_steps_match_reference():
    """Three ``make_train_step`` steps (4 x 8 tokens) of reduced
    mamba2-370m from the port's weights, under ``policy("ff_reduce",
    attention="pallas")``, at ``STEP_CASES["f32"]``'s tolerances."""
    train_tests.steps_match_reference("mamba2-370m", "f32", seq=8,
                                      port_init=True)
