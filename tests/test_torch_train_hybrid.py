"""Training of the hybrid family against the reference on the CPU:
reduced jamba-1.5-large-398b (one 8-layer period: attention at index 3,
MoE FFNs at the odd indices, SSD mixers elsewhere; its ``params
["layers"]`` a tuple of 8 per-index dicts) under ``ff_reduce``:
``train_forward``'s total, loss, summed MoE aux and every gradient leaf
(``test_torch_train_families.check_grads``: losses within 1e-4, each
leaf within 1e-4 of its largest |g|); the tuple tree through a checkpoint
bit for bit under the reference's leaf names; ``Trainer`` resumed after
a crash bit for bit the uninterrupted run.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_checkpoint as ckpt_tests
import test_torch_train_families as tf
from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.models import model as port_model
from repro_torch.optim import adamw as port_adamw

JAMBA = "jamba-1.5-large-398b"
deterministic = tf.deterministic
one_thread = tf.one_thread


def test_train_forward_grads_match_reference():
    """Every index of the period gets its gradient: the attention mixer,
    the SSD mixers, the MoE and MLP FFNs."""
    r = tf.check_grads(JAMBA, "ff_reduce")
    for i in range(8):
        grads = tf.grads_of(r, f"layers__i{i}__")
        assert grads and all(np.abs(g).max() > 0 for g in grads), i
    assert tf.grads_of(r, "layers__i3__mixer_attn__wq")
    assert tf.grads_of(r, "layers__i1__ffn_moe__router")


def test_checkpoint_round_trips_a_hybrid_tree(tmp_path):
    """Parameters and AdamW state of a hybrid (tuple) tree, filled from a
    seeded normal draw, save and load bit for bit, in their tuple
    structure, under the reference's leaf names (``jax.eval_shape`` of
    its ``init_params`` and ``AdamW.init``)."""
    cfg = tf.tiny_hybrid()
    params = port_model.init_params(cfg, torch.Generator().manual_seed(0))
    state = port_adamw.AdamW().init(params)
    tree = {"params": params, "opt": state}
    g = torch.Generator().manual_seed(1)
    for _, t in ckpt.flatten_with_names(tree):
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=g))
    state.count.fill_(5)
    ckpt.save(str(tmp_path), 5, tree)
    back, step, _ = ckpt.load(str(tmp_path), tree)
    assert step == 5 and isinstance(back["params"]["layers"], tuple)
    assert isinstance(back["opt"].m["layers"], tuple)
    got, want = ckpt.flatten_with_names(back), ckpt.flatten_with_names(tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        a, b = np.atleast_1d(a), np.atleast_1d(b.numpy())
        assert a.dtype == b.dtype, n
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), n

    def ref_tree(key):
        p = ref_model.init_params(tf.tiny_hybrid(ref_get_config), key)
        return {"params": p, "opt": ref_adamw.AdamW().init(p)}
    ref_names = [n for n, _ in ref_ckpt._flatten_with_paths(
        jax.eval_shape(ref_tree, jax.random.PRNGKey(0)))]
    assert [n for n, _ in want] == ref_names


def test_trainer_resume_of_a_hybrid_tree_bitwise(tmp_path, deterministic):
    """tests/test_torch_checkpoint.py's resume check on the hybrid: two
    steps, a crash, a new Trainer restores and takes step 3, bit for bit
    three uninterrupted steps; the checkpoint's leaf names the
    reference's."""
    ckpt_tests.check_trainer_resume(tmp_path, tf.tiny_hybrid(ref_get_config),
                                    tf.tiny_hybrid())
