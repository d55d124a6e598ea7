"""Training of the MoE and MLA families against the reference on the CPU:
reduced olmoe-1b-7b (8 experts top-2) and deepseek-v2-236b (MLA's latent
and ``k_rope`` paths in the training branch, a shared expert) under
``ff_reduce``: ``train_forward``'s total, loss and aux and every
gradient leaf (``test_torch_train_families.check_grads``); ``moe_apply``'s
gradients where the capacity drops slots (a dropped slot passes no
gradient to its expert or its gate, as the reference's) with the aux
loss's compensated expert means (``ff_stats``); three
``make_train_step`` steps of olmoe against the reference's.

Tolerances: losses within 1e-4, each gradient leaf within 1e-4 of the
leaf's largest |g|, the steps at ``test_torch_train.STEP_CASES["f32"]``'s
(loss, aux and grad norm within 1e-5 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
import test_torch_moe as moe_tests
import test_torch_train as train_tests
import test_torch_train_families as tf
from repro.models import moe as ref_moe
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe as port_moe

one_thread = tf.one_thread


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_train_forward_grads_match_reference(arch):
    r = tf.check_grads(arch, "ff_reduce")
    for prefix in ("layers__ffn__router", "layers__ffn__w_gate"):
        assert all(np.abs(g).max() > 0 for g in tf.grads_of(r, prefix))
    if arch.startswith("deepseek"):
        for part in ("wkv_a", "kv_norm", "wk_b", "wv_b"):
            (g,) = tf.grads_of(r, f"layers__attn__{part}")
            assert np.abs(g).max() > 0, part


# (arch, B, S, capacity factor): a capacity factor of 0.5 drops slots
GRAD_APPLY = {"olmoe_drops": ("olmoe-1b-7b", 2, 12, 0.5),
              "shared_expert": ("deepseek-v2-236b", 2, 9, 1.25)}


@pytest.mark.parametrize("name", sorted(GRAD_APPLY))
def test_moe_apply_grads_match_reference(name):
    """The gradient of sum(out * r) + aux with respect to x and every
    weight, ``ff_stats=True``: within 1e-4 of each one's largest element
    (the stable top-k order, the slot-order combine, the drops and the
    compensated expert means as in the forward tests of
    tests/test_torch_moe.py)."""
    arch, B, S, cf = GRAD_APPLY[name]
    rcfg, pcfg = (dataclasses.replace(c, moe_capacity_factor=cf)
                  for c in moe_tests._cfgs(arch))
    ref_w = ref_moe.moe_params(jax.random.PRNGKey(7), rcfg)
    port_w = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_w),
                               device="cpu")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)

    def ref_loss(w, t):
        out, aux = ref_moe.moe_apply(w, t, rcfg, ff_stats=True)
        return jnp.sum(out * r) + aux

    with ref_ff.use(**moe_tests.REF_PINS):
        gw, gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
            ref_w, jnp.asarray(x))
    leaves = tf.tree_leaves(port_w)
    xt = torch.from_numpy(x).requires_grad_()
    for t in leaves:
        t.requires_grad_(True)
    out, aux = port_moe.moe_apply(port_w, xt, pcfg, ff_stats=True)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    pairs = list(zip(jax.tree_util.tree_leaves(gw), leaves)) + [(gx, xt)]
    for want, t in pairs:
        want = np.asarray(want)
        assert t.grad.shape == want.shape
        assert np.abs(t.grad.numpy() - want).max() <= \
            tf.GRAD_RTOL * np.abs(want).max()
    if cf < 1:
        logits = torch.from_numpy(x.reshape(B * S, -1)) @ port_w["router"]
        assert not bool(port_moe.route(torch.softmax(logits, -1),
                                       pcfg).keep.all())


def test_train_steps_match_reference():
    """Three ``make_train_step`` steps (4 x 8 tokens) of reduced
    olmoe-1b-7b from the port's weights, under ``policy("ff_reduce",
    attention="pallas")``, at ``STEP_CASES["f32"]``'s tolerances (the aux
    loss among them)."""
    train_tests.steps_match_reference("olmoe-1b-7b", "f32", seq=8,
                                      port_init=True)
