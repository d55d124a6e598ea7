"""The hybrid family against the reference on the CPU: its parameter
tree (a tuple of ``attn_every`` per-index dicts, each leaf stacked over
the periods) handed across by ``interop.params_from_numpy`` bit for bit,
the port's ``init_params`` building the reference's layout for the
SSM, hybrid and enc-dec families, and reduced jamba-1.5-large-398b (one
8-layer period: attention at index 3, MoE FFNs at the odd indices, SSD
mixers elsewhere) served whole under ``ff_reduce`` (``test_torch_families.
check_serving``; tolerances there), also from a prompt shorter than the
conv window (``check_short_prompt``).  ``ff_math`` in the hybrid runs
only code whose ``ff_math`` cases live elsewhere: the SSD mixer's
(tests/test_torch_mamba2.py) and the experts' silu gate
(tests/test_torch_moe.py), so its case is left out (each case costs the
reference four traces and compiles).
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_families as families
from repro.models import model as ref_model
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as port_model

one_thread = families.one_thread


def _bits(t):
    return np.asarray(t).view(np.uint32)


def test_params_from_numpy_carries_the_hybrid_tuple():
    """The reference's hybrid tree (``jax.eval_shape`` of its
    ``init_params``: its tuple, keys and leaf shapes), its leaves drawn
    from a seeded normal, round-trips bit for bit."""
    rcfg, _ = families.serve_configs(
        "jamba-1.5-large-398b", d_model=64, d_ff=64, moe_d_ff=32,
        vocab_size=64, head_dim=16, ssm_state=8, ssm_head_dim=16)
    rng = np.random.default_rng(3)
    ref = jax.tree_util.tree_map(
        lambda t: rng.standard_normal(t.shape).astype(t.dtype),
        jax.eval_shape(lambda k: ref_model.init_params(rcfg, k),
                       jax.random.PRNGKey(3)))
    assert isinstance(ref["layers"], tuple) and len(ref["layers"]) == 8
    got = params_from_numpy(ref, device="cpu")
    assert isinstance(got["layers"], tuple) and len(got["layers"]) == 8
    flat_ref, tree_ref = jax.tree_util.tree_flatten(ref)
    flat_got, tree_got = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))
    assert tree_got == tree_ref
    for a, b in zip(flat_got, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("arch", families.SSM_HYBRID_ENCDEC)
def test_init_params_builds_the_reference_layout(arch):
    """The same tree (dicts, the hybrid's tuple), leaf shapes and dtypes
    as ``jax.eval_shape`` of the reference's ``init_params``."""
    rcfg, pcfg = families.serve_configs(arch)
    want = jax.eval_shape(lambda k: ref_model.init_params(rcfg, k),
                          jax.random.PRNGKey(0))
    got = port_model.init_params(pcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    assert jax.tree_util.tree_structure(shapes, is_leaf=lambda x:
                                        isinstance(x, tuple) and
                                        isinstance(x[0], tuple)) == \
        jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda x: isinstance(x, tuple)
        and isinstance(x[0], tuple)) == [
        (tuple(t.shape), str(t.dtype))
        for t in jax.tree_util.tree_leaves(want)]


def test_prefill_and_decode_logits_match_reference():
    families.check_serving("jamba-1.5-large-398b", "ff_reduce", "logits")


def test_greedy_generate_matches_reference():
    families.check_serving("jamba-1.5-large-398b", "ff_reduce", "tokens")


def test_short_prompt_prefill_matches_reference():
    families.check_short_prompt("jamba-1.5-large-398b")


def test_full_jamba_fits_no_card():
    """jamba-1.5-large-398b at full width (``jax.eval_shape`` of the
    reference's ``init_params``): 397,711,939,584 parameters, one 8-layer
    period 44,070,909,952 (88.1 GB in bf16, more than an 80 GB card
    holds) and the whole model more than four such cards: the port runs
    it reduced (one period)."""
    from repro.configs import get_config as ref_get_config
    cfg = ref_get_config("jamba_1_5_large_398b")
    shapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(t.shape)) for t in jax.tree_util.tree_leaves(shapes))
    periods = cfg.num_layers // cfg.attn_every
    per_period = sum(int(np.prod(t.shape)) for t in
                     jax.tree_util.tree_leaves(shapes["layers"])) // periods
    assert n == 397_711_939_584
    assert 2 * per_period > 80e9 and 2 * n > 4 * 80e9
    assert per_period == 44_070_909_952
