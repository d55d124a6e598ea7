"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU.

  * routing: the port's top-k experts, slot places and kept slots
    (``route``) equal the reference's formulation (``jax.lax.top_k``,
    stable ``argsort``, left ``searchsorted``) on the same router
    probabilities: a prefill whose capacity drops slots, a decode step
    (T = B rows) at olmoe-1b-7b's 64 experts top-8, where the capacity is
    one slot, and tied probabilities (the lower expert index first);
  * ``capacity`` is the reference's formula with Python's round;
  * ``moe_apply``: output and aux loss within f32 tolerance of the
    reference's on its own weights (``interop.params_from_numpy``), with
    and without ``ff_stats`` (the compensated expert means) and
    ``ff_math`` (the FF silu gate), the shared experts, and capacity
    drops in prefill and at decode.

  * olmoe-1b-7b reduced, whole, under the three policies of
    ``tests/test_torch_families.py`` (its checks and tolerances, run here
    to spread the reference's compiles over the test workers).

Tolerance: outputs rtol = atol = 2e-5 (f32 products in XLA's and
PyTorch's summation orders; the slot sum in slot order in both), aux
rtol 1e-6.  The reference runs with ``ff.use(sum="blocked",
silu="jnp")`` (its CPU tuning table picks other impls, some f64 tiers the
installed JAX cannot run); the port with ``silu="jnp"``.  Inputs come
from ``np.random.default_rng`` with fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import test_torch_families as families
import repro_torch.ff as port_ff
from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe as port_moe

REF_PINS = dict(sum="blocked", silu="jnp")

one_thread = families.one_thread


def _cfgs(arch="olmoe-1b-7b", **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (ref_get_config(arch).reduced(**kw),
            port_get_config(arch).reduced(**kw))


def _ref_route(probs: np.ndarray, k: int, E: int, cap: int):
    """The reference's routing lines (repro/models/moe.py) on ``probs``."""
    probs = jnp.asarray(probs)
    T = probs.shape[0]
    gate_vals, idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    e_idx = idx.reshape(T * k)
    order = jnp.argsort(e_idx, stable=True)
    sorted_e = e_idx[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E, dtype=e_idx.dtype))
    pos_sorted = jnp.arange(T * k, dtype=jnp.int32) - starts[sorted_e]
    pos_in_e = jnp.zeros((T * k,), jnp.int32).at[order].set(pos_sorted)
    return (np.asarray(gate_vals), np.asarray(idx), np.asarray(pos_in_e),
            np.asarray(pos_in_e < cap))


def _probs(T, E, seed, skew=0.0, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += skew                   # a favourite expert: drops
    if ties:                               # experts 2j and 2j + 1 equal
        logits[:, 1::2] = logits[:, 0::2]
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


ROUTES = {
    # name: (arch, T, seed, skew, ties)
    "prefill_drops": ("olmoe-1b-7b", 24, 1, 3.0, False),
    "decode_t_eq_b": (None, 4, 2, 0.0, False),     # olmoe at full size
    "tied_probs": ("olmoe-1b-7b", 12, 3, 0.0, True),
    "deepseek_prefill": ("deepseek-v2-236b", 16, 4, 0.0, False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routing_matches_reference(name):
    arch, T, seed, skew, ties = ROUTES[name]
    cfg = port_get_config("olmoe-1b-7b") if arch is None \
        else _cfgs(arch)[1]
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    probs = _probs(T, E, seed, skew, ties)
    got = port_moe.route(torch.from_numpy(probs), cfg)
    gates, idx, pos, keep = _ref_route(probs, k, E, got.cap)
    assert got.cap == ref_capacity(cfg, T)
    assert np.array_equal(got.idx.numpy(), idx)
    assert np.array_equal(got.pos_in_e.numpy(), pos)
    assert np.array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(got.gates.numpy(), gates, rtol=1e-6)
    if name in ("prefill_drops", "decode_t_eq_b"):
        assert not keep.all()              # the capacity drops slots
    if ties:                               # the lower index of a tie first
        assert np.any(probs[:, 0::2] == probs[:, 1::2])
        pairs = idx.reshape(T, k)
        for t in range(T):
            for a, b in zip(pairs[t], pairs[t][1:]):
                assert probs[t, a] > probs[t, b] or a < b


def ref_capacity(cfg, T):
    return int(max(1, round(cfg.moe_top_k * T * cfg.moe_capacity_factor
                            / cfg.moe_num_experts)))


@pytest.mark.parametrize("T", [1, 4, 5, 12, 20, 52, 100])
def test_capacity_is_the_reference_formula(T):
    """Python's round: k T cf / E = 2.5 -> 2 (olmoe's 64 experts top-8 at
    T = 16 gives exactly 2.5)."""
    cfg = port_get_config("olmoe-1b-7b")
    assert port_moe.capacity(cfg, T) == ref_capacity(cfg, T)
    assert port_moe.capacity(cfg, 16) == 2


@pytest.fixture(scope="module")
def moe_weights():
    """Reduced olmoe (8 experts top-2, hd 128) and deepseek-v2 (1 shared
    expert) MoE weights from the reference's init."""
    out = {}
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b"):
        rcfg, pcfg = _cfgs(arch)
        ref = ref_moe.moe_params(jax.random.PRNGKey(7), rcfg)
        tree = jax.tree_util.tree_map(np.asarray, ref)
        out[arch] = (rcfg, pcfg, ref, params_from_numpy(tree, device="cpu"))
    return out


APPLY = {
    # name: (arch, B, S, ff_stats, ff_math, capacity factor)
    "prefill": ("olmoe-1b-7b", 2, 12, False, False, 1.25),
    "prefill_drops_ff_stats": ("olmoe-1b-7b", 2, 12, True, False, 0.5),
    "decode_t_eq_b_ff_math": ("olmoe-1b-7b", 3, 1, False, True, 1.25),
    "shared_experts": ("deepseek-v2-236b", 2, 9, True, False, 1.25),
}


@pytest.mark.parametrize("name", sorted(APPLY))
def test_moe_apply_matches_reference(name, moe_weights):
    arch, B, S, ff_stats, ff_math, cf = APPLY[name]
    rcfg, pcfg, ref_w, port_w = moe_weights[arch]
    rcfg = dataclasses.replace(rcfg, moe_capacity_factor=cf)
    pcfg = dataclasses.replace(pcfg, moe_capacity_factor=cf)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    with ref_ff.use(**REF_PINS):
        want, want_aux = ref_moe.moe_apply(ref_w, jnp.asarray(x), rcfg,
                                           ff_stats=ff_stats,
                                           ff_math=ff_math)
    with port_ff.use(silu="jnp"):
        got, aux = port_moe.moe_apply(port_w, torch.from_numpy(x), pcfg,
                                      ff_stats=ff_stats, ff_math=ff_math)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if name in ("prefill_drops_ff_stats", "decode_t_eq_b_ff_math"):
        logits = torch.from_numpy(x.reshape(B * S, -1)) @ port_w["router"]
        r = port_moe.route(torch.softmax(logits, -1), pcfg)
        assert not bool(r.keep.all())


def test_moe_params_layout_matches_reference(moe_weights):
    """The port's init draws the reference's keys and shapes."""
    for arch, (rcfg, pcfg, ref_w, _) in moe_weights.items():
        g = torch.Generator().manual_seed(0)

        def dense(shape):
            return torch.randn(shape, generator=g)

        got = port_moe.moe_params(pcfg, dense)
        flat_ref = jax.tree_util.tree_flatten_with_path(ref_w)[0]
        assert sorted(jax.tree_util.keystr(p) for p, _ in flat_ref) == \
            sorted(jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_flatten_with_path(
                       jax.tree_util.tree_map(lambda t: 0, got))[0])
        for path, leaf in flat_ref:
            node = got
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, (arch, path)


@pytest.mark.parametrize("pol", sorted(families.POLICIES))
def test_olmoe_whole_model_matches_reference(pol):
    """olmoe-1b-7b reduced, whole: ``train_forward``'s total, loss and aux, the
    prefill and decode logits and ``greedy_generate``'s tokens against the
    reference under ``pol`` (tests/test_torch_families.py's checks and
    tolerances)."""
    families.check_whole_model("olmoe-1b-7b", pol)
