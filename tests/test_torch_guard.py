"""The port's guarded serving slice against the reference.

* the flag planes of ``kernels/ff_guard`` (``flag_planes`` and the plain
  version of the ``guard_flags`` kernel) bit for bit the reference's eager
  ``flag_planes`` and its interpret-mode Pallas kernel, on the adversarial
  limb classes; one class is a held divergence (see
  ``test_flags_subnormal_lo_beside_tiny_hi_diverge``);
* the ``guard_probe`` counts of both impls, ``health_mask`` and the
  ``assert_healthy`` taxonomy;
* the ``ff.guard`` scopes, ``protect`` and ``maybe_degrade``;
* ``PagedKVCache``'s audit on the same corrupt block tables;
* the guarded engine against the reference engine (the chaos tests'
  config, the reference under ``ff.use(logsumexp="jnp")``: its CPU default
  is an f64 tier the installed JAX cannot run): statuses, tokens and guard
  counts under NaN/Inf KV poison and block-table flips;
* the ``ff.add``/``sub``/``mul`` gradients bit for bit the reference's
  ``jax.grad``, and ``ff.fused`` raising on a gradient-requiring operand.

Inputs come from local numpy generators; every comparison is bitwise.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as rff
from repro.chaos import ChaosMonkey
from repro.core.ff import FF as RFF
from repro.ff import dispatch as rdispatch
from repro.ff.guard import protect as ref_protect
from repro.kernels.ff_guard import flag_planes as ref_flag_planes
from repro.kernels.ff_guard import guard_flags as ref_guard_flags
from repro.models import init_params as ref_init_params
from repro.models.config import ModelConfig as RefConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve.paged_kv import PagedKVCache as RefKV

import repro_torch.ff as ff
from repro_torch.core.ff import FF
from repro_torch.ff import dispatch
from repro_torch.ff.guard import (FFError, FFGuardWarning, FFNonFiniteError,
                                  FFNormalizationError, current_guard,
                                  protect, report_violation)
from repro_torch.ff.tuning import accuracy_class
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ff_guard
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.serve import (DEGRADED, FAILED, GUARD_STAT_KEYS, OK,
                               PagedKVCache, Request, ServeEngine)

F32 = np.float32
TINY_LO = F32(1e-40)                     # a subnormal f32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, F32))


def _bits(x):
    return np.asarray(x, F32).view(np.int32)


# --------------------------------------------------------------------------
# flag planes
# --------------------------------------------------------------------------

def _adversarial(shape, seed):
    """(hi, lo) of ``shape``: normal pairs around the 2^-24 surrogate, and
    the special classes written over the first lanes."""
    rng = np.random.default_rng(seed)
    hi = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
          ).astype(F32)
    lo = (hi * F32(2.0 ** -24) * rng.uniform(0, 2, shape)).astype(F32)
    h, l = hi.reshape(-1), lo.reshape(-1)
    one = F32(1.0)
    bound = F32(3.0) * F32(2.0 ** -24)       # |lo| == 2^-24 |hi|, hi = 3
    cases = [
        (np.nan, 0.0), (0.0, np.nan), (np.inf, 0.0), (0.0, -np.inf),
        (-np.inf, np.nan), (1.0, np.inf), (np.nan, TINY_LO),
        (one, TINY_LO), (one, -TINY_LO), (-2.0, TINY_LO),
        (0.0, 0.0), (0.0, -0.0), (-0.0, -0.0), (5.0, -0.0),
        (3.0, bound), (3.0, np.nextafter(bound, F32(np.inf))),
        (-3.0, -bound), (-3.0, -np.nextafter(bound, F32(np.inf))),
        (one, F32(2.0 ** -24)), (one, F32(2.0 ** -23)),
        # |hi| below 2^-102 (subnormal bound) with lo zero or normal
        (F32(2.0 ** -110), 0.0), (F32(2.0 ** -110), F32(2.0 ** -120)),
        (F32(2.0 ** -110), -0.0), (TINY_LO, 0.0), (0.0, 1e-3),
    ]
    for i, (a, b) in enumerate(cases):
        h[i], l[i] = a, b
    return hi, lo


SHAPES = [(3, 130), (8, 128), (2, 3, 40)]


@pytest.mark.parametrize("shape", SHAPES)
def test_flag_planes_match_reference(shape):
    hi, lo = _adversarial(shape, seed=sum(shape))
    want = [np.asarray(p) for p in ref_flag_planes(jnp.asarray(hi),
                                                   jnp.asarray(lo))]
    got = [p.numpy() for p in ff_guard.flag_planes(_t(hi), _t(lo))]
    for g, w in zip(got, want):
        assert g.shape == shape and np.array_equal(g, w)
    assert np.count_nonzero(want[0]) >= 7 and np.count_nonzero(want[1]) >= 3
    assert np.count_nonzero(want[2]) >= 3


@pytest.mark.parametrize("shape", SHAPES)
def test_guard_flags_plain_matches_reference_kernel(shape):
    """The plain version of the CUDA kernel (the CPU path of
    ``guard_flags``) against the reference's interpret-mode Pallas kernel
    and its eager planes packed into codes."""
    hi, lo = _adversarial(shape, seed=7 + sum(shape))
    want = np.asarray(ref_guard_flags(jnp.asarray(hi), jnp.asarray(lo),
                                      interpret=True))
    nf, un, dn = (np.asarray(p) for p in ref_flag_planes(jnp.asarray(hi),
                                                         jnp.asarray(lo)))
    assert np.array_equal(want, nf + 2.0 * un + 4.0 * dn)
    n0 = ff_guard.guard_flags.launches
    got = ff_guard.guard_flags(_t(hi), _t(lo)).numpy()
    assert ff_guard.guard_flags.launches == n0        # no launch on the CPU
    assert got.dtype == F32 and np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(
        got, ff_guard.guard_flags_plain(_t(hi), _t(lo)).numpy())
    assert set(np.unique(got)) <= {0.0, 1.0, 2.0, 4.0}


def test_flags_subnormal_lo_beside_tiny_hi_diverge():
    """The held divergence: ``hi = 0`` (or ``|hi| < 2^-102``, where
    ``|hi| * 2^-24`` underflows) with a subnormal ``lo``.  XLA:CPU reads
    the subnormal ``|lo|`` as zero in ``|lo| > 2^-24 |hi|``, so the
    reference gives code 4 (denormal only); the port compares in IEEE f32
    on both devices and gives 6 (unnormalized and denormal), the answer of
    the reference's own contract "hi = 0 => lo = 0" (ROADMAP, caveats on
    the reference)."""
    hi = np.asarray([0.0, -0.0, 2.0 ** -110, 2.0 ** -110], F32)
    lo = np.asarray([TINY_LO, -TINY_LO, TINY_LO, -TINY_LO], F32)
    ref = np.asarray(ref_guard_flags(jnp.asarray(hi), jnp.asarray(lo),
                                     interpret=True))
    ref_eager = [np.asarray(p) for p in ref_flag_planes(jnp.asarray(hi),
                                                        jnp.asarray(lo))]
    port = ff_guard.guard_flags(_t(hi), _t(lo)).numpy()
    assert ref.tolist() == [4.0] * 4
    assert ref_eager[1].tolist() == [False] * 4
    assert port.tolist() == [6.0] * 4


def test_guard_flags_wrapper_takes_plain_version_only_on_cpu():
    hi, lo = _adversarial((4, 33), seed=5)
    meta = torch.empty((4, 33), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ff_guard.guard_flags(meta, meta)
    with pytest.raises(ValueError):
        ff_guard.guard_flags(_t(hi), _t(lo[:2]))
    got = ff_guard.guard_flags(_t(hi), _t(lo), block=(8, 128))
    assert torch.equal(got, ff_guard.guard_flags_plain(_t(hi), _t(lo)))
    assert dispatch.resolve_name("guard_probe", device="cuda") == "jnp"
    with ff.use(guard_probe="pallas"):
        assert dispatch.resolve_name("guard_probe", device="cuda") \
            == "pallas"


# --------------------------------------------------------------------------
# counts and taxonomy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_probe_counts_match_reference(impl):
    hi, lo = _adversarial((8, 128), seed=11)
    ref = rff.guard_probe(jnp.asarray(hi), jnp.asarray(lo), impl=impl)
    got = ff.guard_probe(_t(hi), _t(lo), impl=impl)
    assert [int(x) for x in got] == [int(x) for x in ref]
    assert int(got.violations) == int(ref.violations)
    assert all(x.dtype == torch.int32 for x in got)
    # an FF operand and a plain tensor (finiteness only)
    got_ff = ff.guard_probe(FF(_t(hi), _t(lo)), impl=impl)
    assert [int(x) for x in got_ff] == [int(x) for x in ref]
    ref_hi = rff.guard_probe(jnp.asarray(hi), impl=impl)
    assert [int(x) for x in ff.guard_probe(_t(hi), impl=impl)] \
        == [int(x) for x in ref_hi]


def test_health_mask_and_assert_healthy_taxonomy():
    hi, lo = _adversarial((3, 130), seed=13)
    assert np.array_equal(
        ff.health_mask(_t(hi), _t(lo)).numpy(),
        np.asarray(rff.health_mask(jnp.asarray(hi), jnp.asarray(lo))))
    cases = [((np.asarray([1.0, 2.0], F32),), None),
             ((np.asarray([np.inf], F32),), "nonfinite"),
             ((np.asarray([1.0], F32), np.asarray([0.5], F32)),
              "unnormalized"),
             ((hi, lo), "nonfinite")]      # nonfinite before unnormalized
    for args, kind in cases:
        outcome = []
        for health, cast, base in ((rff.assert_healthy, jnp.asarray,
                                    rff.FFError),
                                   (ff.assert_healthy, _t, FFError)):
            try:
                health(*map(cast, args), op="matmul")
                outcome.append(None)
            except base as e:
                assert e.op == "matmul"
                outcome.append((e.kind, type(e).__name__))
        assert outcome[0] == outcome[1]
        assert (outcome[1] or (None,))[0] == kind
    with pytest.raises(FFNonFiniteError):
        ff.assert_healthy(_t([np.nan]))
    with pytest.raises(FFNormalizationError):
        ff.assert_healthy(_t([1.0]), _t([0.5]))


# --------------------------------------------------------------------------
# scopes, protect, maybe_degrade
# --------------------------------------------------------------------------

def test_guard_scope_stack_and_modes():
    assert current_guard().mode == "off"
    with ff.guard(mode="check") as g:
        assert current_guard() is g
        with ff.guard(mode="degrade"):
            assert current_guard().mode == "degrade"
        assert current_guard().mode == "check"
    assert current_guard().mode == "off"
    with pytest.raises(ValueError):
        ff.guard(mode="loud")


def _poisoned():
    return (np.asarray([1.0, np.inf, 2.0, 4.0], F32),
            np.asarray([0.0, 0.0, 0.0, 0.5], F32))


def test_check_mode_counts_without_changing_values():
    hi, lo = _poisoned()
    x = FF(_t(hi), _t(lo))
    with pytest.warns(FFGuardWarning):
        with ff.guard(mode="check") as g:
            y = protect("softmax", x)
    with pytest.warns(rff.FFGuardWarning):
        with rff.guard(mode="check") as rg:
            ref_protect("softmax", RFF(jnp.asarray(hi), jnp.asarray(lo)))
    assert y is x
    assert g.counters == rg.counters == {("softmax", "nonfinite"): 1,
                                         ("softmax", "unnormalized"): 1}
    assert not g.degraded


def test_degrade_repairs_and_reresolves_matmul():
    """A violation under ``degrade`` repairs the flagged lanes as the
    reference does, marks the op, and re-resolves it one class lower
    inside the scope only, with the source ``guard_degraded``."""
    hi, lo = _poisoned()
    before = dispatch.resolve_name("matmul", "ozaki")
    with pytest.warns(FFGuardWarning):
        with ff.guard(mode="degrade") as g:
            y = protect("matmul", FF(_t(hi), _t(lo)))
            inside = dispatch.resolve_name("matmul", "ozaki", "cpu",
                                           (8, 8, 8))
    with pytest.warns(rff.FFGuardWarning):
        with rff.guard(mode="degrade") as rg:
            ry = ref_protect("matmul", RFF(jnp.asarray(hi), jnp.asarray(lo)))
            ref_inside = rdispatch.resolve_name("matmul", "ozaki")
    assert np.array_equal(_bits(y.hi), _bits(ry.hi))
    assert np.array_equal(_bits(y.lo), _bits(ry.lo))
    assert y.hi.tolist() == [1.0, 0.0, 2.0, 4.0] and y.lo[3] == 0.0
    assert g.counters == rg.counters and g.degraded == rg.degraded \
        == {"matmul"}
    assert inside == ref_inside == "hybrid"
    assert accuracy_class("matmul", inside) == "fast"
    assert any(k[:3] == ("matmul", "hybrid", "guard_degraded")
               for k in dispatch.RESOLUTIONS)
    assert before == dispatch.resolve_name("matmul", "ozaki") == "ozaki"
    # check mode never degrades; an explicit report in degrade mode does
    with ff.guard(mode="degrade") as g2, pytest.warns(FFGuardWarning):
        report_violation("matmul", "nonfinite", 3)
        assert g2.counters[("matmul", "nonfinite")] == 3
        assert accuracy_class("matmul",
                              dispatch.resolve_name("matmul", None)) == "fast"


def test_off_mode_is_identity():
    x = FF(_t([np.nan, 1.0]), _t([0.0, 0.0]))
    assert protect("exp", x) is x
    with ff.guard(mode="off") as g:
        assert protect("exp", x) is x
    assert g.counters == {} and current_guard().counters == {}


def test_math_ops_route_through_guard():
    """``ff.log`` of [0.5, -1, 2] under ``degrade``: the NaN lane is
    counted and repaired and ``log`` is degraded, as in the reference
    (called with its explicit ``jnp`` impl: its default ff.math tier is
    the f64 one, which the installed JAX cannot run)."""
    x = np.asarray([0.5, -1.0, 2.0], F32)
    with pytest.warns(FFGuardWarning):
        with ff.guard(mode="degrade") as g:
            y = ff.log(_t(x))
    with pytest.warns(rff.FFGuardWarning):
        with rff.guard(mode="degrade") as rg:
            ry = rff.log(jnp.asarray(x), impl="jnp")
    assert np.isfinite(y.hi.numpy()).all()
    assert np.array_equal(_bits(y.hi), _bits(ry.hi))
    assert np.array_equal(_bits(y.lo), _bits(ry.lo))
    assert g.counters == rg.counters == {("log", "nonfinite"): 1}
    assert g.degraded == rg.degraded == {"log"}
    assert not np.isfinite(ff.log(_t(x)).hi.numpy()[1])   # outside: honest


# --------------------------------------------------------------------------
# the paging audit
# --------------------------------------------------------------------------

def _caches():
    kw = dict(num_pages=10, page_size=4, max_seqs=3, max_ctx=16)
    ref = RefKV(1, 1, 8, **kw)
    port = PagedKVCache(1, 1, 8, device="cpu", **kw)
    for kv in (ref, port):
        kv.alloc(0, 9)             # 3 pages
        kv.alloc(1, 5)             # 2 pages
    return ref, port


def _corrupt(kv, how):
    if how == "oob":
        kv.block_table[1, 1] = kv.num_pages + 3
    elif how == "free":
        kv.block_table[1, 0] = kv.free_pages[2]
    elif how == "dup":
        kv.block_table[1, 1] = kv.block_table[0, 2]
    elif how == "hole":
        kv.block_table[0, 1] = -1
    elif how == "free_list":
        kv.free_pages.append(kv.free_pages[0])
        kv.free_pages.append(kv.num_pages + 1)


@pytest.mark.parametrize("how", ["clean", "oob", "free", "dup", "hole",
                                 "free_list"])
def test_check_integrity_matches_reference(how):
    ref, port = _caches()
    _corrupt(ref, how)
    _corrupt(port, how)
    assert np.array_equal(ref.block_table, port.block_table)
    r_problems, r_bad = ref.check_integrity()
    problems, bad = port.check_integrity()
    assert problems == r_problems and bad == r_bad
    assert bool(problems) == (how != "clean")
    for slot in sorted(bad):
        ref.drop_slot(slot)
        port.drop_slot(slot)
    ref.rebuild_free_list()
    port.rebuild_free_list()
    assert np.array_equal(ref.block_table, port.block_table)
    assert np.array_equal(ref.seq_lens, port.seq_lens)
    assert port.free_pages == ref.free_pages
    if how != "free_list":
        assert port.check_integrity() == ([], set())


# --------------------------------------------------------------------------
# the guarded engine against the reference engine
# --------------------------------------------------------------------------

FIELDS = dict(name="chaos-test", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
              max_seq_len=64, compute_dtype="float32", remat=False)
REF_CFG, PORT_CFG = RefConfig(**FIELDS), PortConfig(**FIELDS)
ENGINE = dict(max_batch=2, page_size=4, max_ctx=32)
MAX_NEW = 6


@pytest.fixture(scope="module")
def weights():
    ref = ref_init_params(REF_CFG, jax.random.PRNGKey(0))
    return ref, params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                  device="cpu")


def _prompts(n):
    rng = np.random.default_rng(777)
    return [rng.integers(1, FIELDS["vocab_size"], size=int(s)).astype(
        np.int32) for s in rng.integers(6, 14, size=n)]


def _poison_port(kv, slot, kind, n, seed):
    """``ChaosMonkey(seed).corrupt_kv_limbs(kv, slot, kind=kind, n=n)`` on
    the port's cache: the same draws, so the same coordinates."""
    rng = np.random.default_rng(seed)
    live, ps = int(kv.seq_lens[slot]), kv.page_size
    coords = []
    for _ in range(n):
        base = ("k", "v")[rng.integers(2)]
        layer = int(rng.integers(kv.num_layers))
        pos = int(rng.integers(live))
        head = int(rng.integers(kv.num_kv_heads))
        dim = int(rng.integers(kv.head_dim))
        page = int(kv.block_table[slot, pos // ps])
        kv.planes[base][layer, page, pos % ps, head, dim] = float(kind)
        coords.append((layer, pos, head, dim))
    return coords


def _serve_both(weights, n, inject, guard="degrade", params=None):
    """Both engines serve ``n`` chaos prompts: one step, ``inject(ref_eng,
    port_eng)``, then run to the end."""
    ref_w, port_w = params or weights
    prompts = _prompts(n)
    with rff.use(logsumexp="jnp"), warnings.catch_warnings():
        warnings.simplefilter("ignore", rff.FFGuardWarning)
        ref = RefEngine(ref_w, REF_CFG, guard=guard, **ENGINE)
        for i, p in enumerate(prompts):
            ref.submit(RefRequest(uid=i, prompt=p, max_new=MAX_NEW))
        eng = ServeEngine(port_w, PORT_CFG, device="cpu", guard=guard,
                          **ENGINE)
        for i, p in enumerate(prompts):
            assert eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW)) \
                == "QUEUED"
        ref.step()
        eng.step()
        assert np.array_equal(ref.kv.block_table, eng.kv.block_table)
        assert ref.kv.free_pages == eng.kv.free_pages
        if inject is not None:
            inject(ref, eng)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FFGuardWarning)
            res = eng.run()
        ref_res = ref.run()
    return ref, ref_res, eng, res


def _assert_same(ref, ref_res, eng, res, keys=GUARD_STAT_KEYS):
    assert sorted(res) == sorted(ref_res)
    for uid, r in res.items():
        assert r.status == ref_res[uid].status, (uid, r.detail)
        assert r.detail == ref_res[uid].detail
        assert np.array_equal(r.tokens, ref_res[uid].tokens), uid
    for k in keys:
        assert eng.guard_stats[k] == ref.guard_stats[k], k


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_kv_poison_matches_reference(weights, kind):
    """NaN/Inf in 2 live K/V positions of slot 0 after one step: the rows'
    statuses, tokens and guard counts are the reference's.  Both rows end
    DEGRADED: slot 0 owns page 0, which row 1's unused block-table
    entries gather, and its masked probabilities (0) times a NaN ``v``
    are NaN (the reference's own leak, kept)."""
    def inject(ref, eng):
        coords = ChaosMonkey(seed=3).corrupt_kv_limbs(ref.kv, slot=0,
                                                      kind=kind, n=2)
        assert _poison_port(eng.kv, 0, kind, 2, seed=3) == coords
        nf = int(eng.probe_kv().nonfinite)
        assert nf == int(ref.probe_kv().nonfinite) == 2

    ref, ref_res, eng, res = _serve_both(weights, 2, inject)
    _assert_same(ref, ref_res, eng, res)
    assert eng.guard_stats["quarantined"] >= 1
    assert eng.guard_stats["flagged_rows"] >= 1
    if kind == "nan":
        assert [r.status for r in res.values()] == [DEGRADED, DEGRADED]
        assert eng.guard_stats["flagged_rows"] == 2


@pytest.mark.parametrize("mode", ["oob", "free", "dup"])
def test_block_table_flip_matches_reference(weights, mode):
    def inject(ref, eng):
        ChaosMonkey(seed=7).flip_block_table(ref.kv, slot=1, mode=mode)
        eng.kv.block_table[:] = ref.kv.block_table

    ref, ref_res, eng, res = _serve_both(weights, 2, inject)
    _assert_same(ref, ref_res, eng, res)
    assert eng.guard_stats["integrity_rebuilds"] == 1
    assert eng.kv.check_integrity() == ([], set())
    want = {"oob": [OK, DEGRADED], "free": [OK, DEGRADED],
            "dup": [DEGRADED, DEGRADED]}[mode]
    assert [res[u].status for u in (0, 1)] == want


def test_guard_off_does_not_probe(weights):
    def inject(ref, eng):
        ChaosMonkey(seed=3).corrupt_kv_limbs(ref.kv, slot=0, kind="nan", n=2)
        _poison_port(eng.kv, 0, "nan", 2, seed=3)

    ref, ref_res, eng, res = _serve_both(weights, 1, inject, guard="off")
    assert res[0].status == ref_res[0].status == OK
    assert eng.guard_stats == dict.fromkeys(GUARD_STAT_KEYS, 0)
    assert ref.guard_stats["quarantined"] == 0


def test_nonfinite_prefill_score_is_quarantined(weights):
    """A NaN final-norm weight makes every prefill score NaN: each request
    is quarantined at admission and, its fast-tier retry NaN too, ends
    FAILED with its tokens withheld, as in the reference."""
    ref_w, port_w = weights
    ref_bad = dict(ref_w, final_norm=ref_w["final_norm"].at[3].set(jnp.nan))
    port_bad = dict(port_w, final_norm=port_w["final_norm"].clone())
    port_bad["final_norm"][3] = float("nan")
    ref, ref_res, eng, res = _serve_both(weights, 2, None,
                                         params=(ref_bad, port_bad))
    _assert_same(ref, ref_res, eng, res)
    assert [r.status for r in res.values()] == [FAILED, FAILED]
    assert all(r.tokens.size == 0 and "prefill" in r.detail
               for r in res.values())
    assert eng.guard_stats["quarantined"] == 2
    assert eng.guard_stats["flagged_rows"] == 0


def test_engine_guard_inherits_the_ambient_scope(weights):
    _, port_w = weights
    assert ServeEngine(port_w, PORT_CFG, device="cpu").guard_mode == "off"
    with ff.guard(mode="degrade"):
        eng = ServeEngine(port_w, PORT_CFG, device="cpu", **ENGINE)
        assert ServeEngine(port_w, PORT_CFG, device="cpu",
                           guard="off").guard_mode == "off"
    assert eng.guard_mode == "degrade"
    with pytest.raises(ValueError):
        ServeEngine(port_w, PORT_CFG, device="cpu", guard="loud")


def test_healthy_check_mode_is_the_unguarded_run(weights):
    _, port_w = weights
    out = {}
    for guard in ("off", "check"):
        eng = ServeEngine(port_w, PORT_CFG, device="cpu", guard=guard,
                          **ENGINE)
        for i, p in enumerate(_prompts(3)):
            eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW))
        out[guard] = eng.run()
        assert eng.guard_stats == dict.fromkeys(GUARD_STAT_KEYS, 0)
        c = eng.probe_kv()
        assert (int(c.nonfinite), int(c.unnormalized)) == (0, 0)
    for uid, r in out["check"].items():
        assert r.status == OK
        assert np.array_equal(r.tokens, out["off"][uid].tokens)


# --------------------------------------------------------------------------
# the add / sub / mul gradients (ROADMAP fault 3.1) and ff.fused
# --------------------------------------------------------------------------

def _operand(kind, shape, rng):
    hi = rng.standard_normal(shape).astype(F32) * F32(3.0)
    if kind == "arr":
        return hi
    lo = (hi * F32(2.0 ** -25) * rng.uniform(-1, 1, shape)).astype(F32)
    return hi, lo


def _ref_arg(x):
    return RFF(jnp.asarray(x[0]), jnp.asarray(x[1])) \
        if isinstance(x, tuple) else jnp.asarray(x)


def _port_arg(x):
    if isinstance(x, tuple):
        return FF(_t(x[0]).requires_grad_(), _t(x[1]).requires_grad_())
    return _t(x).requires_grad_()


def _port_grads(x):
    if isinstance(x, FF):
        return [x.hi.grad.numpy(), x.lo.grad.numpy()]
    return [x.grad.numpy()]


def _ref_grads(g):
    return [np.asarray(g.hi), np.asarray(g.lo)] if isinstance(g, RFF) \
        else [np.asarray(g)]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("kinds", [("ff", "ff"), ("ff", "arr"),
                                   ("arr", "ff"), ("arr", "arr")])
@pytest.mark.parametrize("shapes", [((3, 5), (3, 5)), ((2, 5), (5,)),
                                    ((5,), (2, 1, 5))])
def test_binary_grads_match_reference(op, kinds, shapes):
    """``jax.grad`` of the reference and ``torch.autograd`` of the port
    give the same bits for both operands: the loss weighs the result's
    limbs by random factors, so the FF cotangent is normalised
    (``Add12``) before it reaches the operands.  Broadcast extents are 2
    (a sum of two is exact in any order)."""
    rng = np.random.default_rng(101)
    a = _operand(kinds[0], shapes[0], rng)
    b = _operand(kinds[1], shapes[1], rng)
    out = np.broadcast_shapes(shapes[0], shapes[1])
    w_hi = rng.standard_normal(out).astype(F32)
    w_lo = rng.standard_normal(out).astype(F32)

    def ref_loss(x, y):
        r = getattr(rff, op)(x, y, impl="jnp")
        return jnp.sum(r.hi * w_hi + r.lo * w_lo)

    ga, gb = jax.grad(ref_loss, argnums=(0, 1))(_ref_arg(a), _ref_arg(b))
    for impl in ("jnp", "pallas"):
        pa, pb = _port_arg(a), _port_arg(b)
        r = getattr(ff, op)(pa, pb, impl=impl)
        (r.hi * _t(w_hi) + r.lo * _t(w_lo)).sum().backward()
        for got, want in ((_port_grads(pa), _ref_grads(ga)),
                          (_port_grads(pb), _ref_grads(gb))):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                assert np.array_equal(_bits(g), _bits(w)), (impl, op)


@pytest.mark.parametrize("op", ["add", "mul"])
def test_fault_table_rows(op):
    """The ROADMAP fault 3.1 table: with ``(r.hi + r.lo).sum()``, an FF
    operand ``a`` and an f32 ``b``, d/d a.hi = 2 (add) or 2 b (mul) and
    d/d a.lo = 0, as in the reference; the traced EFT gave 1, 1 (b, b)."""
    rng = np.random.default_rng(5)
    a = _operand("ff", (4, 6), rng)
    b = _operand("arr", (4, 6), rng)
    pa, pb = _port_arg(a), _t(b)
    r = getattr(ff, op)(pa, pb)
    (r.hi + r.lo).sum().backward()
    want_hi = np.full((4, 6), 2.0, F32) if op == "add" else 2.0 * b
    assert np.array_equal(pa.hi.grad.numpy(), want_hi)
    assert np.array_equal(pa.lo.grad.numpy(), np.zeros((4, 6), F32))
    ga = jax.grad(lambda x: jnp.sum(
        (lambda r: r.hi + r.lo)(getattr(rff, op)(x, jnp.asarray(b),
                                                 impl="jnp"))))(_ref_arg(a))
    assert np.array_equal(np.asarray(ga.hi), want_hi)
    assert np.array_equal(np.asarray(ga.lo), np.zeros((4, 6), F32))


def test_no_grad_calls_keep_their_forward():
    """Without a gradient the calls run as before (no Function), and under
    a gradient the forward bits are the same."""
    rng = np.random.default_rng(9)
    a, b = _operand("ff", (3, 7), rng), _operand("ff", (3, 7), rng)
    plain = ff.mul(FF(_t(a[0]), _t(a[1])), FF(_t(b[0]), _t(b[1])))
    graded = ff.mul(_port_arg(a), _port_arg(b))
    assert plain.hi.grad_fn is None and graded.hi.grad_fn is not None
    assert torch.equal(plain.hi, graded.hi.detach())
    assert torch.equal(plain.lo, graded.lo.detach())


def test_fused_raises_on_gradient_operands():
    axpy = ff.fused(lambda a, x, y: a * x + y)
    x = FF(_t(np.ones(4)), _t(np.zeros(4)))
    y = _t(np.arange(4.0)).requires_grad_()
    with pytest.raises(NotImplementedError, match="gradient"):
        axpy(1.5, x, y)
    with torch.no_grad():
        z = axpy(1.5, x, y)
    assert z.hi.tolist() == [1.5, 2.5, 3.5, 4.5]
