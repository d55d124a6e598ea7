"""Training of the enc-dec and VLM families against the reference on the
CPU, under ``ff_reduce`` (``test_torch_train_families.check_grads``:
losses within 1e-4, each gradient leaf within 1e-4 of its largest |g|):

  * reduced whisper-medium (2 encoder + 2 decoder layers, 64 seeded
    frames): the encoder's only way to the loss is the decoder's cross
    attention, whose K and V each layer computes from the encoder output,
    so every encoder leaf's gradient is held there;
  * reduced internvl2-1b (16 seeded patches before the text):
    ``patch_proj``'s gradient, with the loss over the text positions only
    (the patch positions' logits add nothing, as in the reference);
  * the accurate attention tier's backward with ``causal=False`` and more
    keys than queries (the cross attention's shape): the fast recurrence
    recomputed non-causally, within 1e-5 of the largest gradient element
    of ``jax.grad`` through the reference's (as
    ``tests/test_torch_train.py``'s causal case), and far from the causal
    gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
import test_torch_train_families as tf

one_thread = tf.one_thread


def test_whisper_grads_match_reference():
    r = tf.check_grads("whisper-medium", "ff_reduce")
    enc = tf.grads_of(r, "encoder__") + tf.grads_of(r, "enc_final_norm")
    assert len(enc) == 10 and all(np.abs(g).max() > 0 for g in enc)
    for w in ("wk", "wv", "wq"):
        (g,) = tf.grads_of(r, f"layers__xattn__{w}")
        assert np.abs(g).max() > 0, w


def test_internvl2_grads_match_reference():
    r = tf.check_grads("internvl2-1b", "ff_reduce")
    (g,) = tf.grads_of(r, "patch_proj")
    assert np.abs(g).max() > 0


@pytest.mark.parametrize("impl", ["ff", "pallas"])
def test_noncausal_attention_grad_matches_reference(impl):
    """q (2, 8, 4, 16) over k, v (2, 24, 2, 16), ``causal=False``: the
    port's accurate tiers (``"ff"``; ``"pallas"``, its kernel's plain
    version here) against ``jax.grad`` through the reference's ``"ff"``
    tier, within 1e-5 of each gradient's largest element; the causal
    gradient of the same inputs differs from it by more than 10%."""
    rng = np.random.default_rng(61)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    r = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    kw = dict(block_q=8, block_kv=8)
    want = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(ref_ff.attention(
            a, b, c, causal=False, impl="ff", **kw) * r),
        argnums=(0, 1, 2)))(q, k, v)

    def port(causal):
        ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
        (port_ff.attention(*ts, causal=causal, impl=impl, **kw)
         * torch.from_numpy(r)).sum().backward()
        return [t.grad.numpy() for t in ts]

    for name, a, b, c in zip("qkv", want, port(False), port(True)):
        a = np.asarray(a)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), name
        assert np.abs(a - c).max() > 0.1 * np.abs(a).max(), name
