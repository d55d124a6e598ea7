"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the reference's ``repro.models.mla`` on the CPU, on the
reference's weights (reduced deepseek-v2: 4 heads, kv_lora 64, q_lora 96,
qk 32 + 16, v 32; f32).

  * ``mla_prefill``: output and the latent cache it writes, under the
    ``fast`` and ``ff`` attention tiers, and the ``pallas`` tier (the
    kernel's plain version here; the prefill's q and k are qk_nope +
    qk_rope wide, v zero-padded to it: the kernel's hd-192 instance at
    full size);
  * ``mla_decode``'s ``fast`` branch (the dense softmax) after a prefill;
  * ``mla_decode``'s accurate branch: the absorbed single-KV-head
    ``ff.attention`` call with ``kv_len`` (head dim kv_lora + rope), under
    ``pallas`` routed to the ``ff`` tier with the dispatch's warning, as
    the reference's; its FF output within 2^-40 of the reference's ``ff``
    tier on the same operands, and the layer's output after it.

  * deepseek-v2-236b reduced, whole, under the three policies of
    ``tests/test_torch_families.py`` (its checks and tolerances, run here
    to spread the reference's compiles over the test workers).

Tolerances: the layer outputs and caches rtol = atol = 2e-5 (f32 matrix
products and einsums in XLA's and PyTorch's summation orders, which
also keeps the ``fast`` branch from bit equality across the packages);
the attention call 2^-40 relative to each (batch, head)'s largest
output.  Inputs come from ``np.random.default_rng`` with fixed seeds.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import test_torch_families as families
import repro_torch.ff as port_ff
from repro.configs import get_config as ref_get_config
from repro.models import mla as ref_mla
from repro_torch.configs import get_config as port_get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import mla as port_mla

TOL = 2.0 ** -40
RTOL = ATOL = 2e-5
B, S, SMAX = 2, 7, 12
REF_CFG = ref_get_config("deepseek-v2-236b").reduced(compute_dtype="float32")
PORT_CFG = port_get_config("deepseek-v2-236b").reduced(
    compute_dtype="float32")

one_thread = families.one_thread


@pytest.fixture(scope="module")
def weights():
    ref = ref_mla.mla_params(jax.random.PRNGKey(3), REF_CFG)
    tree = jax.tree_util.tree_map(np.asarray, ref)
    return ref, params_from_numpy(tree, device="cpu")


def _x(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, REF_CFG.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


_PREFILLED = {}


def _prefilled(weights, impl):
    """Both packages' prefill of the same prompt: (ref out, ref cache, port
    out, port cache), computed once per impl; the caches are copies, free
    for a decode step to write."""
    if impl not in _PREFILLED:
        _PREFILLED[impl] = _prefill(weights, impl)
    ro, rc, po, pc = _PREFILLED[impl]
    return ro, dict(rc), po, {k: v.clone() for k, v in pc.items()}


def _prefill(weights, impl):
    ref_w, port_w = weights
    x = _x(S, 21)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    rc = ref_mla.mla_cache_init(REF_CFG, B, SMAX, jnp.float32)
    pc = port_mla.mla_cache_init(PORT_CFG, B, SMAX, torch.float32)
    with ref_ff.use(logsumexp="jnp"):
        ro, rc = ref_mla.mla_prefill(ref_w, jnp.asarray(x), REF_CFG,
                                     positions=jnp.asarray(pos), cache=rc,
                                     attn_impl=impl)
    po, pc = port_mla.mla_prefill(port_w, torch.from_numpy(x), PORT_CFG,
                                  positions=torch.from_numpy(pos.copy()),
                                  cache=pc, attn_impl=impl)
    return ro, rc, po, pc


@pytest.mark.parametrize("impl", ["fast", "ff", "pallas"])
def test_mla_prefill_matches_reference(weights, impl):
    ro, rc, po, pc = _prefilled(weights, impl)
    _close(po.numpy(), ro)
    for name in ("c_kv", "k_rope"):
        _close(pc[name].numpy(), rc[name])
        assert not pc[name][:, S:].any()


def _decoded(weights, impl):
    ref_w, port_w = weights
    ro, rc, po, pc = _prefilled(weights, "fast")
    x = _x(1, 22)
    with ref_ff.use(logsumexp="jnp"):
        rd, rc = ref_mla.mla_decode(ref_w, jnp.asarray(x), REF_CFG,
                                    pos=S, cache=rc, attn_impl=impl)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pd, pc = port_mla.mla_decode(port_w, torch.from_numpy(x), PORT_CFG,
                                     pos=S, cache=pc, attn_impl=impl)
    return rd, rc, pd, pc, caught


def test_mla_decode_fast_branch_matches_reference(weights):
    rd, rc, pd, pc, _ = _decoded(weights, "fast")
    _close(pd.numpy(), rd)
    for name in ("c_kv", "k_rope"):
        _close(pc[name].numpy(), rc[name])
    assert pc["c_kv"][:, S].any() and not pc["c_kv"][:, S + 1:].any()


@pytest.mark.parametrize("impl", ["ff", "pallas"])
def test_mla_decode_accurate_branch_matches_reference(weights, impl):
    rd, rc, pd, pc, caught = _decoded(weights, impl)
    _close(pd.numpy(), rd)
    # under pallas the per-row kv_len takes the ff tier, with a warning
    fell_back = [w for w in caught if "kv_len" in str(w.message)]
    assert bool(fell_back) == (impl == "pallas")


def test_absorbed_attention_call_within_2_40_of_reference():
    """The absorbed decode's attention: one shared KV head at head dim
    kv_lora + rope (80 here, 576 at full size), v the zero-padded latent,
    kv_len per row, the scale 1/sqrt(qk_nope + qk_rope); the port's
    ``ff.attention`` (``pallas``: the ``ff`` tier) against the
    reference's ``ff`` tier on the same operands."""
    r, dr, H = PORT_CFG.kv_lora_rank, PORT_CFG.qk_rope_head_dim, 4
    rng = np.random.default_rng(23)
    q = rng.standard_normal((B, 1, H, r + dr)).astype(np.float32)
    c = rng.standard_normal((B, SMAX, r)).astype(np.float32)
    k = np.concatenate(
        [c, rng.standard_normal((B, SMAX, dr)).astype(np.float32)],
        -1)[:, :, None]
    v = np.pad(c, ((0, 0), (0, 0), (0, dr)))[:, :, None]
    kv_len = np.asarray([S + 1, 3], np.int32)
    scale = 1.0 / np.sqrt(PORT_CFG.qk_nope_head_dim + dr)
    want = ref_ff.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, kv_len=jnp.asarray(kv_len),
                            scale=scale, impl="ff", return_ff=True)
    want = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = port_ff.attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False,
                                kv_len=torch.from_numpy(kv_len),
                                scale=scale, impl="pallas", return_ff=True)
    got = got.hi.double().numpy() + got.lo.double().numpy()
    den = np.abs(want).max(axis=(1, 3), keepdims=True)
    assert float((np.abs(got - want) / den).max()) <= TOL
    assert not got[..., r:].any()          # the padded latent's columns


def test_mla_params_layout_matches_reference(weights):
    ref_w, _ = weights
    g = torch.Generator().manual_seed(0)
    got = port_mla.mla_params(PORT_CFG, lambda s: torch.randn(s, generator=g),
                              lambda n: torch.ones(n))
    assert sorted(got) == sorted(ref_w)
    for name, leaf in ref_w.items():
        assert tuple(got[name].shape) == leaf.shape, name


@pytest.mark.parametrize("pol", ["baseline", "ff_reduce"])
def test_deepseek_v2_whole_model_matches_reference(pol):
    """deepseek-v2-236b reduced, whole: ``train_forward``'s total, loss and aux, the
    prefill and decode logits and ``greedy_generate``'s tokens against the
    reference under ``pol`` (tests/test_torch_families.py's checks and
    tolerances)."""
    families.check_whole_model("deepseek-v2-236b", pol)
