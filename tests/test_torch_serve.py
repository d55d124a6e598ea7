"""The port's serving slice end to end against the reference.

Both engines serve the same weights (the reference's ``init_params``,
handed across with ``params_from_numpy``) under
``policy("ff_reduce", attention="pallas")``: the compensated RMSNorm
statistic in every norm, the one-kernel FF attention in prefill, the FF
attention tier in decode, and both token scores.  The port runs on the CPU
(plain versions of its kernels); the reference runs with the non-f64
logsumexp (``ff.use(logsumexp="jnp")``: its CPU default is an f64 tier the
installed JAX cannot run).

Tolerances: tokens identical; f32 logprobs and FF scores within 1e-4 (the
reference's own bound for batched-matmul ulp noise, test_serving.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.models import init_params as ref_init_params
from repro.models.config import ModelConfig as RefConfig
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro.train.serve_step import token_logprob_ff as ref_logprob_ff
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.serve import OK, REJECTED, Request, ServeEngine
from repro_torch.train.serve_step import greedy_generate, token_logprob_ff

FIELDS = dict(name="serve-test", family="dense", num_layers=2, d_model=128,
              num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
              max_seq_len=128, compute_dtype="float32", remat=False)
REF_CFG, PORT_CFG = RefConfig(**FIELDS), PortConfig(**FIELDS)
ENGINE = dict(max_batch=2, page_size=8, max_ctx=48)
LENS = (7, 12, 7, 19, 12)            # 3 distinct lengths: 3 prefill traces
MAX_NEW = 6


def _prompts():
    rng = np.random.default_rng(31)
    return [rng.integers(1, FIELDS["vocab_size"], size=n).astype(np.int32)
            for n in LENS]


@pytest.fixture(scope="module")
def weights():
    ref = ref_init_params(REF_CFG, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, ref)
    return ref, params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def served(weights):
    """Five mixed-length requests through max_batch=2 (joins and
    evictions) in both engines."""
    ref_w, port_w = weights
    with ref_ff.policy("ff_reduce", attention="pallas"), \
            ref_ff.use(logsumexp="jnp"):
        ref = RefEngine(ref_w, REF_CFG, **ENGINE)
        for i, p in enumerate(_prompts()):
            ref.submit(RefRequest(uid=i, prompt=p, max_new=MAX_NEW))
        ref_res = ref.run()
    with port_ff.policy("ff_reduce", attention="pallas"):
        eng = ServeEngine(port_w, PORT_CFG, device="cpu", **ENGINE)
    for i, p in enumerate(_prompts()):
        assert eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW)) \
            == "QUEUED"
    return ref_res, eng.run()


def test_engine_statuses_and_shapes(served):
    ref_res, res = served
    assert sorted(res) == sorted(ref_res) == list(range(len(LENS)))
    for uid, r in res.items():
        assert r.status == OK and ref_res[uid].status == "OK"
        assert r.tokens.shape == (MAX_NEW,) and r.prompt_len == LENS[uid]
        assert r.logprobs_ff.shape == (MAX_NEW, 2)
        assert np.all(np.isfinite(r.logprobs_ff))


def test_engine_tokens_match_reference(served):
    ref_res, res = served
    for uid, r in res.items():
        assert np.array_equal(r.tokens, ref_res[uid].tokens), uid


def test_engine_scores_match_reference(served):
    ref_res, res = served
    for uid, r in res.items():
        np.testing.assert_allclose(r.logprobs, ref_res[uid].logprobs,
                                   atol=1e-4)
        np.testing.assert_allclose(r.logprobs_ff.sum(axis=1),
                                   ref_res[uid].logprobs_ff.sum(axis=1),
                                   atol=1e-4)
        # and the FF pair agrees with its own f32 tier
        np.testing.assert_allclose(r.logprobs_ff.sum(axis=1), r.logprobs,
                                   atol=1e-4)


def test_greedy_generate_matches_engine(weights, served):
    """The sequential baseline (contiguous cache, ``decode_step``) is
    token-for-token the engine, the reference's own serving invariant."""
    _, port_w = weights
    _, res = served
    uid = 1
    prompt = torch.from_numpy(_prompts()[uid][None]).long()
    with port_ff.policy("ff_reduce", attention="pallas"):
        got, got_lp = greedy_generate(port_w, PORT_CFG, prompt, MAX_NEW,
                                      cache_len=32, return_logprobs=True)
    assert np.array_equal(got[0].numpy(), res[uid].tokens)
    np.testing.assert_allclose(got_lp[0].numpy(), res[uid].logprobs,
                               atol=1e-4)


def test_engine_rejects_impossible_requests(weights):
    _, port_w = weights
    eng = ServeEngine(port_w, PORT_CFG, device="cpu", max_queue=1,
                      **ENGINE)
    prompt = np.ones(10, np.int32)
    assert eng.submit(Request(uid=0, prompt=prompt, max_new=39)) \
        == REJECTED                                  # over max_ctx
    assert eng.submit(Request(uid=1, prompt=prompt, max_new=2)) == "QUEUED"
    assert eng.submit(Request(uid=2, prompt=prompt, max_new=2)) \
        == REJECTED                                  # queue bound
    small = ServeEngine(port_w, PORT_CFG, device="cpu", num_pages=2,
                        **ENGINE)
    assert small.submit(Request(uid=3, prompt=prompt, max_new=8)) \
        == REJECTED                                  # larger than the pool
    assert "max_ctx" in eng.results[0].detail
    assert eng.run()[1].status == OK


def test_token_logprob_ff_bitwise_and_oracle():
    """On identical logits the FF score is the reference's bits, and within
    2^-40 of the f64 log-softmax."""
    rng = np.random.default_rng(32)
    logits = (rng.standard_normal((4, 4096)) * 8.0).astype(np.float32)
    tok = logits.argmax(-1).astype(np.int32)
    got = token_logprob_ff(torch.from_numpy(logits), torch.from_numpy(tok))
    want = ref_logprob_ff(jnp.asarray(logits), jnp.asarray(tok))
    for g, w in ((got.hi, want.hi), (got.lo, want.lo)):
        assert np.array_equal(g.numpy().view(np.uint32),
                              np.asarray(w).view(np.uint32))
    lg = logits.astype(np.float64)
    m = lg.max(-1, keepdims=True)
    ref = lg[np.arange(4), tok] - (np.log(np.exp(lg - m).sum(-1)) + m[:, 0])
    val = got.hi.double().numpy() + got.lo.double().numpy()
    assert float(np.max(np.abs(val - ref) / np.abs(ref).clip(1e-30))) \
        <= 2.0 ** -40


@pytest.mark.parametrize("mode", ["bf16", "f32", "ff_bf16"])
def test_paged_roundtrip_bitwise(mode):
    """write_prefill -> gather is bitwise the storage cast of the input
    (in ff_bf16 mode the merge of its limb split, the reference's)."""
    from repro.serve.paged_kv import ff_merge as ref_merge
    from repro.serve.paged_kv import ff_split as ref_split
    from repro_torch.serve import PagedKVCache
    rng = np.random.default_rng(33)
    tensors = {n: torch.from_numpy(rng.standard_normal((2, 21, 2, 8))
                                   .astype(np.float32)) for n in ("k", "v")}
    kv = PagedKVCache(2, 2, 8, num_pages=12, page_size=4, max_seqs=2,
                      max_ctx=32, kv_mode=mode, device="cpu")
    kv.alloc(1, 21)
    kv.write_prefill(1, tensors)
    back = kv.gather(1)
    for n in ("k", "v"):
        if mode == "ff_bf16":
            want = torch.from_numpy(np.asarray(ref_merge(
                *ref_split(jnp.asarray(tensors[n].numpy())))))
        else:
            want = tensors[n].to(torch.bfloat16 if mode == "bf16"
                                 else torch.float32)
        assert torch.equal(back[n], want)
    kv.free_slot(1)
    assert sorted(kv.free_pages) == list(range(12))


def test_ff_split_merge_bitwise_reference():
    from repro.serve.paged_kv import ff_merge as ref_merge
    from repro.serve.paged_kv import ff_split as ref_split
    from repro_torch.serve import ff_merge, ff_split
    rng = np.random.default_rng(34)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    hi, lo = ff_split(torch.from_numpy(x))
    rhi, rlo = ref_split(jnp.asarray(x))
    for a, b in ((hi, rhi), (lo, rlo)):
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b, np.float32))
    assert np.array_equal(ff_merge(hi, lo).numpy(),
                          np.asarray(ref_merge(rhi, rlo)))


def test_engine_eos_retires_rows(weights, served):
    """With ``eos_id`` a row retires right after emitting it: its tokens
    are the no-EOS run's up to and including the first EOS."""
    _, port_w = weights
    _, res = served
    eos = int(res[0].tokens[2])
    with port_ff.policy("ff_reduce", attention="pallas"):
        eng = ServeEngine(port_w, PORT_CFG, device="cpu", eos_id=eos,
                          **ENGINE)
    for i, p in enumerate(_prompts()):
        eng.submit(Request(uid=i, prompt=p, max_new=MAX_NEW))
    got = eng.run()
    for uid, r in got.items():
        full = res[uid].tokens
        hits = np.nonzero(full == eos)[0]
        n = int(hits[0]) + 1 if hits.size else MAX_NEW
        assert r.status == OK and np.array_equal(r.tokens, full[:n]), uid
