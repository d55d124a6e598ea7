"""The port's engine made complete and durable, against the reference.

Both engines serve the config, weights (the reference's ``init_params``
through ``params_from_numpy``) and policy of ``tests/test_torch_serve.py``
(``policy("ff_reduce", attention="pallas")``; the reference with
``ff.use(logsumexp="jnp")``).  Held to the reference: ``reserve="prompt"``
with preemption (tokens, statuses, the ``preempted`` count), deadlines
(``TIMEOUT`` with the same partial tokens), ``sync_every`` (bitwise
``sync_every=1``), ``ff_bf16`` pages, the paged cache's ``grow`` and
state round trip.  Snapshots, restore, ``resume_engine`` and the journal
are in ``tests/test_torch_serve_restart.py``, which shares this file's
config and helpers.

Tolerances: tokens and statuses identical; f32 and FF scores within 1e-4
of the reference's (``tests/test_torch_serve.py``'s bound).  Local
generators only.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.models import init_params as ref_init_params
from repro.models.config import ModelConfig as RefConfig
from repro.serve import PagedKVCache as RefPagedKVCache
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.serve.paged_kv import ff_merge as ref_merge
from repro.serve.paged_kv import ff_split as ref_split
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.serve import (FAILED, OK, TIMEOUT, PagedKVCache, Request,
                               ServeEngine, ff_merge, ff_split)

FIELDS = dict(name="serve-test", family="dense", num_layers=2, d_model=128,
              num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
              max_seq_len=128, compute_dtype="float32", remat=False)
REF_CFG, PORT_CFG = RefConfig(**FIELDS), PortConfig(**FIELDS)
ENGINE = dict(max_batch=2, page_size=8, max_ctx=48)
LENS = (7, 12, 7, 19, 12)
MAX_NEW = 6
ATOL = 1e-4


def _prompts(lens=LENS, seed=31):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, FIELDS["vocab_size"], size=n).astype(np.int32)
            for n in lens]


def _reqs(prompts, max_new=MAX_NEW, **kw):
    """Request fields, one dict per prompt (uid = index)."""
    return [dict(uid=i, prompt=p, max_new=max_new, **kw)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def weights():
    ref = ref_init_params(REF_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, ref)
    return ref, params_from_numpy(tree, device="cpu")


@contextlib.contextmanager
def _ref_scope():
    with ref_ff.policy("ff_reduce", attention="pallas"), \
            ref_ff.use(logsumexp="jnp"):
        yield


def _ref_engine(ref_w, **kw):
    with _ref_scope():
        return RefEngine(ref_w, REF_CFG, **{**ENGINE, **kw})


def _ref_run(ref_w, reqs, hook=None, **kw):
    """The reference engine over ``reqs``; ``hook(eng)`` runs after
    submission.  Returns (engine, results)."""
    with _ref_scope():
        eng = RefEngine(ref_w, REF_CFG, **{**ENGINE, **kw})
        for r in reqs:
            eng.submit(RefRequest(**r))
        if hook is not None:
            hook(eng)
        return eng, eng.run()


def _port_engine(port_w, **kw):
    with port_ff.policy("ff_reduce", attention="pallas"):
        return ServeEngine(port_w, PORT_CFG, device="cpu",
                           **{**ENGINE, **kw})


def _port_run(port_w, reqs, hook=None, **kw):
    eng = _port_engine(port_w, **kw)
    for r in reqs:
        eng.submit(Request(**r))
    if hook is not None:
        hook(eng)
    return eng, eng.run()


def _assert_like_reference(res, ref_res):
    assert sorted(res) == sorted(ref_res)
    for uid, r in res.items():
        want = ref_res[uid]
        assert r.status == want.status, (uid, r.status, r.detail,
                                         want.status, want.detail)
        assert np.array_equal(r.tokens, want.tokens), uid
        np.testing.assert_allclose(r.logprobs, want.logprobs, atol=ATOL)
        np.testing.assert_allclose(r.logprobs_ff.sum(axis=1),
                                   want.logprobs_ff.sum(axis=1), atol=ATOL)


def _assert_bitwise(res, base):
    assert sorted(res) == sorted(base)
    for uid, r in res.items():
        assert r.status == base[uid].status, (uid, r.detail)
        assert np.array_equal(r.tokens, base[uid].tokens), uid
        assert np.array_equal(r.logprobs, base[uid].logprobs), uid
        assert np.array_equal(r.logprobs_ff, base[uid].logprobs_ff), uid


def _kv_tensors(rng, S, L=2, KV=2, hd=8):
    return {n: rng.standard_normal((L, S, KV, hd)).astype(np.float32)
            for n in ("k", "v")}


# --------------------------------------------------------------------------
# the paged cache: grow, ff_bf16 limbs, state round trip
# --------------------------------------------------------------------------

def test_paged_grow_failure_paths():
    """grow(): a dry pool raises without touching the bookkeeping; a jump
    of two pages is a structural error; over max_ctx is a ValueError."""
    kv = PagedKVCache(1, 1, 4, num_pages=3, page_size=4, max_seqs=2,
                      max_ctx=16, device="cpu")
    with pytest.raises(ValueError):
        kv.alloc(0, 17)
    kv.alloc(0, 10)                          # 3 pages: the pool is empty
    assert kv.grow(0, 12) is None            # same page: no allocation
    with pytest.raises(RuntimeError):
        kv.grow(0, 13)                       # a 4th page, the pool is dry
    assert int(kv.seq_lens[0]) == 12
    assert kv.check_integrity() == ([], set())
    kv2 = PagedKVCache(1, 1, 4, num_pages=6, page_size=4, max_seqs=1,
                       max_ctx=24, device="cpu")
    kv2.alloc(0, 2)
    assert kv2.grow(0, 5) == kv2.block_table[0, 1]   # one new page
    with pytest.raises(ValueError):
        kv2.grow(0, 13)                      # +2 pages in one call


def test_ff_bf16_pages_beat_single_bf16():
    """The double-bf16 limb pair carries ~2x the mantissa of one bf16."""
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    hi, lo = ff_split(x)
    err_ff = float((ff_merge(hi, lo) - x).abs().max())
    err_bf = float((hi.float() - x).abs().max())
    assert err_ff <= 2.0 ** -14 * float(x.abs().max())
    assert err_ff < err_bf / 16


@pytest.mark.parametrize("mode", ["bf16", "f32", "ff_bf16"])
def test_paged_state_roundtrip(mode):
    """to_state/from_state: numpy arrays, bitwise planes and bookkeeping
    (the limb planes under their shared block table); the state dict is
    the reference's, key for key and bit for bit, and each package
    rebuilds the other's."""
    rng = np.random.default_rng(42)
    t = _kv_tensors(rng, S=9)
    kv = PagedKVCache(2, 2, 8, num_pages=10, page_size=4, max_seqs=2,
                      max_ctx=32, kv_mode=mode, device="cpu")
    ref = RefPagedKVCache(2, 2, 8, num_pages=10, page_size=4, max_seqs=2,
                          max_ctx=32, kv_mode=mode)
    for c in (kv, ref):
        c.alloc(0, 3)
        c.free_slot(0)                       # a non-trivial free list
        c.alloc(1, 9)
    kv.write_prefill(1, {n: torch.from_numpy(x) for n, x in t.items()})
    ref.write_prefill(1, {n: jnp.asarray(x) for n, x in t.items()})
    state, ref_state = kv.to_state(), ref.to_state()
    assert all(isinstance(v, np.ndarray) for v in state.values())
    assert sorted(state) == sorted(ref_state)
    for k in state:
        assert state[k].dtype == ref_state[k].dtype, k
        assert np.array_equal(state[k], ref_state[k]), k
    for kv2 in (PagedKVCache.from_state(state, device="cpu"),
                PagedKVCache.from_state(ref_state, device="cpu")):
        assert kv2.kv_mode == mode and kv2.free_pages == kv.free_pages
        assert np.array_equal(kv2.block_table, kv.block_table)
        assert np.array_equal(kv2.seq_lens, kv.seq_lens)
        for name in kv.planes:
            assert torch.equal(kv2.planes[name], kv.planes[name]), name
    back = RefPagedKVCache.from_state(state).gather(1)
    got = kv.gather(1)
    for n in ("k", "v"):
        assert np.array_equal(got[n].float().numpy(),
                              np.asarray(back[n], np.float32))
    with pytest.raises(ValueError, match="geometry"):
        PagedKVCache.from_state(dict(state, geometry=np.zeros(3, np.int64)),
                                device="cpu")


def test_paged_roundtrip_ff_bf16_limbs_are_the_reference_split():
    """ff_bf16 gather merges the reference's limb split of the input."""
    rng = np.random.default_rng(43)
    t = _kv_tensors(rng, S=13)
    kv = PagedKVCache(2, 2, 8, num_pages=8, page_size=4, max_seqs=1,
                      max_ctx=16, kv_mode="ff_bf16", device="cpu")
    kv.alloc(0, 13)
    kv.write_prefill(0, {n: torch.from_numpy(x) for n, x in t.items()})
    back = kv.gather(0)
    for n in ("k", "v"):
        want = np.asarray(ref_merge(*ref_split(jnp.asarray(t[n]))))
        assert np.array_equal(back[n].numpy(), want)
    assert bool((kv.planes["k_lo"] != 0).any())


# --------------------------------------------------------------------------
# the engine: ff_bf16 pages, sync_every, deadlines, preemption
# --------------------------------------------------------------------------

def test_ff_bf16_engine_matches_reference(weights):
    ref_w, port_w = weights
    reqs = _reqs(_prompts())
    _, ref_res = _ref_run(ref_w, reqs, kv_mode="ff_bf16")
    eng, res = _port_run(port_w, reqs, kv_mode="ff_bf16")
    _assert_like_reference(res, ref_res)
    assert all(r.status == OK for r in res.values())
    assert bool((eng.kv.planes["v_lo"] != 0).any())
    counts = [int(c) for c in eng.probe_kv()]
    assert counts[:2] == [0, 0]


@pytest.mark.parametrize("reserve", ["trajectory", "prompt"])
def test_engine_batched_sync_parity(weights, reserve):
    """sync_every=4 is token for token and score for score (bitwise)
    sync_every=1: the next input token stays on the device.  Both are the
    reference's tokens."""
    ref_w, port_w = weights
    reqs = _reqs(_prompts(), max_new=7)
    _, ref_res = _ref_run(ref_w, reqs, reserve=reserve)
    results = {}
    for n in (1, 4):
        eng, results[n] = _port_run(port_w, reqs, sync_every=n,
                                    reserve=reserve)
        assert eng.sync_every == n
    _assert_bitwise(results[4], results[1])
    _assert_like_reference(results[4], ref_res)


def test_engine_eos_forces_per_step_sync(weights):
    _, port_w = weights
    eng = _port_engine(port_w, eos_id=3, sync_every=8)
    assert eng.sync_every == 1
    with pytest.raises(ValueError, match="sync_every"):
        _port_engine(port_w, sync_every=0)
    with pytest.raises(ValueError, match="reserve"):
        _port_engine(port_w, reserve="lazy")


@pytest.mark.parametrize("sync_every", [1, 4])
def test_deadline_steps_timeout(weights, sync_every):
    """A running request retires TIMEOUT keeping its partial tokens; one
    queued behind a busy batch expires with none; both as the
    reference."""
    ref_w, port_w = weights
    p = _prompts((9, 12), seed=44)
    reqs = [dict(uid=0, prompt=p[0], max_new=8, deadline_steps=3),
            dict(uid=1, prompt=p[1], max_new=8, deadline_steps=2)]
    kw = dict(max_batch=1, sync_every=sync_every)
    _, ref_res = _ref_run(ref_w, reqs, **kw)
    _, res = _port_run(port_w, reqs, **kw)
    _assert_like_reference(res, ref_res)
    assert res[0].status == TIMEOUT and 0 < len(res[0].tokens) < 8
    assert res[1].status == TIMEOUT and len(res[1].tokens) == 0
    assert "queued" in res[1].detail and "mid-decode" in res[0].detail
    assert res[0].detail == ref_res[0].detail
    _, full = _port_run(port_w, [dict(uid=0, prompt=p[0], max_new=8)],
                        max_batch=1)
    n = len(res[0].tokens)
    assert np.array_equal(res[0].tokens, full[0].tokens[:n])
    assert np.array_equal(res[0].logprobs_ff, full[0].logprobs_ff[:n])


def test_deadline_s_wallclock(weights):
    """A generous wall-clock deadline changes nothing; one already past
    expires while queued; status() follows a request's life."""
    _, port_w = weights
    p = _prompts((9,), seed=45)[0]
    eng = _port_engine(port_w, max_batch=1)
    eng.submit(Request(uid=0, prompt=p, max_new=4, deadline_s=3600.0))
    eng.submit(Request(uid=1, prompt=p, max_new=4, deadline_s=0.0))
    assert eng.status(0) == eng.status(1) == "QUEUED"
    eng.step()
    assert eng.status(0) == "RUNNING" and eng.status(1) == TIMEOUT
    assert "queued" in eng.results[1].detail
    res = eng.run()
    assert res[0].status == OK and len(res[0].tokens) == 4
    with pytest.raises(KeyError):
        eng.status(7)


@pytest.mark.parametrize("sync_every", [1, 4])
def test_pool_exhaustion_preempts_youngest(weights, sync_every):
    """reserve="prompt" on an undersized pool: the youngest row is
    preempted and replayed; every request ends OK with the reference's
    tokens and the reference's preemption count, and the preempted run is
    bit for bit the one on a full pool."""
    ref_w, port_w = weights
    reqs = _reqs(_prompts((7, 8, 7), seed=46), max_new=8)
    kw = dict(max_batch=3, page_size=4, max_ctx=32, num_pages=8,
              reserve="prompt", sync_every=sync_every)
    ref_eng, ref_res = _ref_run(ref_w, reqs, **kw)
    eng, res = _port_run(port_w, reqs, **kw)
    _assert_like_reference(res, ref_res)
    assert all(r.status == OK for r in res.values())
    assert eng.guard_stats["preempted"] == ref_eng.guard_stats["preempted"]
    assert eng.guard_stats["preempted"] >= 1
    assert eng.kv.check_integrity() == ([], set())
    assert sorted(eng.kv.free_pages) == list(range(8))
    _, full = _port_run(port_w, reqs, **{**kw, "num_pages": None})
    _assert_bitwise(res, full)


def test_stolen_pool_fails_unschedulable(weights):
    """A pool emptied by hand with an empty engine retires the head
    FAILED ("unschedulable"), as the reference under ChaosMonkey's
    exhaust_pool; with the pages back the request serves OK."""
    ref_w, port_w = weights
    p = _prompts((9,), seed=47)[0]
    results = {}
    for name, eng in (("port", _port_engine(port_w, max_batch=1,
                                             reserve="prompt")),
                      ("ref", _ref_engine(ref_w, max_batch=1,
                                          reserve="prompt"))):
        stolen, eng.kv.free_pages = eng.kv.free_pages, []
        eng.submit((Request if name == "port" else RefRequest)(
            uid=0, prompt=p, max_new=4))
        with _ref_scope():
            res = eng.run()
        assert res[0].status == FAILED and "unschedulable" in res[0].detail
        eng.kv.free_pages = stolen
        eng.submit((Request if name == "port" else RefRequest)(
            uid=1, prompt=p, max_new=4))
        with _ref_scope():
            results[name] = eng.run()
    _assert_like_reference(results["port"], results["ref"])
    assert results["port"][1].status == OK


def test_one_trajectory_pool_failure(weights):
    """Pages taken mid-decode from a lone row: growth cannot preempt
    anyone, so the row retires FAILED ("page pool too small for one
    trajectory") with its tokens, as in the reference."""
    ref_w, port_w = weights
    p = _prompts((8,), seed=48)[0]
    out = {}
    for name, eng in (("port", _port_engine(port_w, max_batch=1,
                                             page_size=4, max_ctx=32,
                                             reserve="prompt")),
                      ("ref", _ref_engine(ref_w, max_batch=1, page_size=4,
                                          max_ctx=32, reserve="prompt"))):
        eng.submit((Request if name == "port" else RefRequest)(
            uid=0, prompt=p, max_new=6))
        with _ref_scope():
            eng.step()                       # admit + the first step
            eng.kv.free_pages = []
            out[name] = eng.run()
    _assert_like_reference(out["port"], out["ref"])
    assert out["port"][0].status == FAILED
    assert "one trajectory" in out["port"][0].detail
    assert len(out["port"][0].tokens) > 0
