"""The decoder-only families beyond dense GQA, whole models, against the
reference on the CPU: olmoe-1b-7b (MoE, MHA at head dim 128),
deepseek-v2-236b (MLA + MoE with a shared expert), internvl2-1b (the VLM
backbone: projected patches before the text) and phi3-medium-14b (dense,
G = 4 at head dim 128), each ``cfg.reduced(compute_dtype="float32")``
(head_dim 128 kept where the family has it), on the same random weights
(the port's init, handed to the reference as jax arrays).

For each architecture and policy: ``train_forward``'s total, loss and
aux; the prefill's last-position logits; each decode step's logits along
the reference's greedy path; and ``greedy_generate``'s tokens.  Policies:
``baseline`` (f32 statistics, the fast attention tier), ``ff_reduce``
with ``attention="ff"`` (compensated norms and loss, the FF attention
tier; the MoE aux's compensated expert means) and the same with
``ff_math=True`` (the FF silu gate): olmoe under all three, deepseek-v2
under the first two, internvl2 and phi3 under ``ff_reduce`` (``CASES``
says why).  The
engine's paged path stays dense-only: a MoE, MLA, SSM, hybrid or enc-dec
config raises the reference's ``UnsupportedModelError``.
``check_serving`` holds the SSM, hybrid and enc-dec families' serving
path to the reference, ``check_short_prompt`` their prompts shorter than
the conv window (tests/test_torch_mamba2.py, test_torch_hybrid.py,
test_torch_encdec.py run them); the training of every family is held in
tests/test_torch_train_*.py.

Tolerances: tokens identical; logits, losses and aux within atol 1e-4
(``tests/test_torch_serve.py``'s bound: f32 matrix products in XLA's and
PyTorch's summation orders).  The logits are read with an f32 KV cache in
both packages: a bf16 cache rounds the packages' f32 ulp differences to a
bf16 ulp (2^-9 relative) wherever a value lies near a bf16 rounding
boundary, which moves decode logits by up to ~1e-3 here.
``greedy_generate`` runs with its default bf16 cache.  The reference runs with
``ff.use(logsumexp="jnp", mean_sq="jnp", sum="blocked", silu="jnp")``
(its CPU tuning table picks f64 tiers the installed JAX cannot run); the
port with ``silu="jnp"``.  Inputs come from ``np.random.default_rng``.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.train.serve_step import make_decode_step as ref_decode_step
from repro.train.serve_step import greedy_generate as ref_greedy
from repro.train.serve_step import make_prefill_step as ref_prefill_step
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.configs import get_config as port_get_config
from repro_torch.models import model as port_model
from repro_torch.serve import ServeEngine, UnsupportedModelError
from repro_torch.train.serve_step import greedy_generate

REF_PINS = dict(logsumexp="jnp", mean_sq="jnp", sum="blocked", silu="jnp")
ATOL = 1e-4
B, S, MAX_NEW = 2, 8, 3
POLICIES = {"baseline": dict(), "ff_reduce": dict(attention="ff"),
            "ff_math": dict(attention="ff", ff_math=True)}
# olmoe's cases (all three policies) and deepseek-v2's (baseline: MLA's
# fast decode branch; ff_reduce: its absorbed ff branch) run in
# tests/test_torch_moe.py and tests/test_torch_mla.py (check_whole_model),
# which spreads the reference's compiles over the test workers.  Each case
# costs the reference three traces and compiles (~8 s on one core), so
# the policies that run no code of their own are left out: ff_math is the
# silu gate (olmoe's experts here; the dense MLP's in test_torch_train.py),
# and the VLM's patches pass through every policy alike.
CASES = [("internvl2-1b", "ff_reduce"), ("phi3-medium-14b", "ff_reduce")]


# the SSM, hybrid and enc-dec families (reduced; jamba cut to one 8-layer
# period, its attention at index 3 and its MoE FFNs at the odd indices)
SSM_HYBRID_ENCDEC = ("mamba2-370m", "jamba-1.5-large-398b", "whisper-medium")
SERVE_REF_PINS = dict(REF_PINS, exp="jnp", log1p="jnp")
SERVE_PORT_PINS = dict(exp="pallas", log1p="pallas", silu="pallas")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread in the modules that take this fixture (this
    one and those that import it): their tensors are small, and under the
    suite's six workers torch's thread pools oversubscribe the cores (a
    case ran 10-20x slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_configs(arch, **kw):
    """The reference's and the port's reduced config of ``arch``."""
    if arch.startswith("jamba"):
        kw["num_layers"] = 8
    name = arch.replace("-", "_").replace(".", "_")
    return ref_get_config(name).reduced(**kw), \
        port_get_config(arch).reduced(**kw)


def _serve_inputs(cfg, rng):
    """A (B, S) prompt, and for ``encdec`` (B, encoder_seq, d) frames from
    a seeded normal draw (zero frames would make every encoder row
    equal): numpy."""
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, extra


@functools.lru_cache(maxsize=None)
def serve_run(arch, pol):
    """One serving case in both packages, on the port's weights, at f32
    compute with an f32 cache and at the config's bf16 compute with its
    default bf16 cache: the reference's greedy path (jitted prefill and
    decode steps, each step's logits kept), the port's logits along the
    reference's tokens, and the port's own ``greedy_generate`` tokens.
    At f32 the reference runs ``attention="ff"`` (the tier the port's
    ``"pallas"`` takes on a CPU tensor; its own Pallas kernel runs in
    interpret mode in its tests), the port ``attention="pallas"``; both
    with ``ff.use(exp=, log1p=, silu=...)``, each kernel's plain version
    here.  The bf16 runs (the casts, the bf16 conv, the caches) take the
    ``fast`` attention tier in both packages: the FF tiers' agreement is
    the f32 runs', and the reference compiles its FF tier in seconds a
    call site."""
    level = dict(ff_math=True) if pol == "ff_math" else {}
    out = {}
    for dtype, ref_attn, port_attn in (("float32", "ff", "pallas"),
                                       ("bfloat16", "fast", "fast")):
        rcfg, pcfg = serve_configs(arch, compute_dtype=dtype)
        pw = port_model.init_params(pcfg, torch.Generator().manual_seed(5))
        rw = to_jax(pw)
        toks, extra = _serve_inputs(rcfg, np.random.default_rng(43))
        extra_r = {k: jnp.asarray(v) for k, v in extra.items()}
        extra_p = {k: torch.from_numpy(v) for k, v in extra.items()}
        prompt_p = torch.from_numpy(toks).long()
        cache_len = S + MAX_NEW
        with ref_ff.policy("ff_reduce", attention=ref_attn, **level), \
                ref_ff.use(**SERVE_REF_PINS):
            pf = jax.jit(ref_prefill_step(rcfg))
            dc = jax.jit(ref_decode_step(rcfg))
            cache = ref_model.init_cache(rcfg, B, cache_len,
                                         getattr(jnp, dtype))
            logits, cache = pf(rw, {"tokens": jnp.asarray(toks), **extra_r},
                               cache)
            ref_logits = [np.asarray(logits.astype(jnp.float32))]
            ref_toks = [np.asarray(jnp.argmax(logits, -1))]
            for t in range(MAX_NEW - 1):
                logits, cache = dc(rw, jnp.asarray(ref_toks[-1][:, None],
                                                   jnp.int32),
                                   jnp.int32(S + t), cache)
                ref_logits.append(np.asarray(logits.astype(jnp.float32)))
                ref_toks.append(np.asarray(jnp.argmax(logits, -1)))
        with port_ff.policy("ff_reduce", attention=port_attn, **level), \
                port_ff.use(**SERVE_PORT_PINS), warnings.catch_warnings():
            warnings.simplefilter("ignore")          # decode: kv_len -> ff
            cache = port_model.init_cache(pcfg, B, cache_len,
                                          getattr(torch, dtype),
                                          device="cpu")
            logits, cache = port_model.prefill(
                pw, {"tokens": prompt_p, **extra_p}, pcfg, cache)
            got = [logits.float().numpy()]
            for t in range(MAX_NEW - 1):
                tok = torch.from_numpy(ref_toks[t][:, None]).long()
                logits, cache = port_model.decode_step(pw, tok, S + t,
                                                       cache, pcfg)
                got.append(logits.float().numpy())
            tokens = None if dtype == "float32" else greedy_generate(
                pw, pcfg, prompt_p, MAX_NEW, cache_len,
                extra_inputs=extra_p or None).numpy()
        out[dtype] = dict(ref_logits=ref_logits, logits=got,
                          ref_tokens=np.stack(ref_toks, 1), tokens=tokens)
    out["vocab"] = pcfg.vocab_size
    return out


def check_serving(arch, pol, what):
    """``what``: "logits": the f32 run's prefill and decode logits within
    ATOL.  "tokens": the bf16 run's ``greedy_generate`` tokens equal the
    reference's, each row up to a step where the reference's top-2
    margin lies within the packages' bf16 logit gap along the same prefix
    (XLA keeps bf16 intermediates at f32 inside a fusion, torch rounds
    each op: a near-tie may go either way, and the rows differ after it;
    the gap and margin are the measured ones, the step is reported)."""
    r = serve_run(arch, pol)
    if what == "logits":
        f32 = r["float32"]
        assert len(f32["logits"]) == len(f32["ref_logits"]) == MAX_NEW
        for got, want in zip(f32["logits"], f32["ref_logits"]):
            assert got.shape == (B, r["vocab"])
            np.testing.assert_allclose(got, want, atol=ATOL)
        return
    bf = r["bfloat16"]
    assert bf["tokens"].shape == bf["ref_tokens"].shape == (B, MAX_NEW)
    for row in range(B):
        diff = np.nonzero(bf["tokens"][row] != bf["ref_tokens"][row])[0]
        if not diff.size:
            continue
        t = int(diff[0])
        want = bf["ref_logits"][t][row]
        top2 = np.sort(want)[-2:]
        gap = float(np.abs(bf["logits"][t][row] - want).max())
        assert top2[1] - top2[0] <= gap, (
            f"{arch} {pol} row {row} step {t}: tokens differ where the "
            f"reference's top-2 margin {top2[1] - top2[0]} exceeds the "
            f"bf16 logit gap {gap}")
        warnings.warn(f"{arch} {pol} row {row}: greedy tokens part at "
                      f"step {t}, a near-tie (reference top-2 margin "
                      f"{top2[1] - top2[0]:.4f} <= bf16 gap {gap:.4f})")


def check_short_prompt(arch):
    """A 2-token prompt, shorter than the conv window (W - 1 = 3), in the
    ssm or hybrid family, f32 compute under ``ff_reduce`` on the config's
    default bf16 cache: the prefill's logits within ATOL of the
    reference's, and ``greedy_generate(max_new=1)``'s tokens the
    reference's (its greedy loop with one token is that jitted prefill
    and an argmax, ``repro/train/serve_step.py``: the argmax of the same
    logits, one compile); each mixer's conv state of 2 rows; a decode
    step after it raises, where the reference's fails
    (tests/test_torch_mamba2.py)."""
    rcfg, pcfg = serve_configs(arch, compute_dtype="float32")
    pw = port_model.init_params(pcfg, torch.Generator().manual_seed(5))
    toks = np.random.default_rng(44).integers(
        0, rcfg.vocab_size, (B, 2)).astype(np.int32)
    with ref_ff.policy("ff_reduce", attention="ff"), \
            ref_ff.use(**SERVE_REF_PINS):
        want, _ = jax.jit(ref_prefill_step(rcfg))(
            to_jax(pw), {"tokens": jnp.asarray(toks)},
            ref_model.init_cache(rcfg, B, 8))
    prompt = torch.from_numpy(toks).long()
    with port_ff.policy("ff_reduce", attention="pallas"), \
            port_ff.use(**SERVE_PORT_PINS):
        cache = port_model.init_cache(pcfg, B, 8, device="cpu")
        got, cache = port_model.prefill(pw, {"tokens": prompt}, pcfg, cache)
        tokens = greedy_generate(pw, pcfg, prompt, 1, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert np.array_equal(tokens.numpy()[:, 0],
                              np.asarray(jnp.argmax(want, -1)))
        convs = [t for n, t in flatten_with_names(cache) if
                 n.endswith("conv")]
        assert convs and all(t.shape[2] == 2 for t in convs)
        with pytest.raises(ValueError, match="conv state"):
            port_model.decode_step(pw, tokens, 2, cache, pcfg)


def _configs(arch):
    kw = dict(compute_dtype="float32")
    full = ref_get_config(arch)
    if not full.use_mla and full.resolved_head_dim == 128:
        kw["head_dim"] = 128
    return ref_get_config(arch).reduced(**kw), \
        port_get_config(arch).reduced(**kw)


def _policy(pkg, name):
    level = "baseline" if name == "baseline" else "ff_reduce"
    return pkg.policy(level, **POLICIES[name])


@pytest.fixture(scope="module")
def runs():
    """Each case run once in both packages (lazily, per case)."""
    cache = {}

    def get(arch, pol):
        if (arch, pol) not in cache:
            cache[(arch, pol)] = _run(arch, pol)
        return cache[(arch, pol)]
    return get


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The port's random weights (its init lays them out as the
    reference's pytree) and the same values as jax arrays."""
    _, pcfg = _configs(arch)
    port_w = port_model.init_params(pcfg, torch.Generator().manual_seed(5))

    return to_jax(port_w), port_w


def to_jax(tree):
    """Nested dicts and tuples of CPU tensors -> the same of jax arrays."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _run(arch, pol):
    rcfg, pcfg = _configs(arch)
    ref_w, port_w = _weights(arch)
    rng = np.random.default_rng(41)
    toks = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    tgts = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    pb = {"tokens": torch.from_numpy(toks).long(),
          "targets": torch.from_numpy(tgts).long()}
    extra_r = extra_p = None
    if rcfg.family == "vlm":
        pa = rng.standard_normal((B, rcfg.num_patches, rcfg.d_model)) \
            .astype(np.float32)
        extra_r, extra_p = {"patches": jnp.asarray(pa)}, \
            {"patches": torch.from_numpy(pa)}
        rb.update(extra_r)
        pb.update(extra_p)
    cache_len = S + MAX_NEW + rcfg.num_patches
    out = {"cfg": pcfg}
    with _policy(ref_ff, pol), ref_ff.use(**REF_PINS):
        total, m = jax.jit(lambda w, b: ref_model.train_forward(
            w, b, rcfg))(ref_w, rb)
        out["ref_train"] = (float(total), float(m["loss"]), float(m["aux"]))
        # the reference's greedy path, its logits kept
        pf = jax.jit(ref_prefill_step(rcfg))
        dc = jax.jit(ref_decode_step(rcfg))
        cache = ref_model.init_cache(rcfg, B, cache_len, jnp.float32)
        logits, cache = pf(ref_w, {"tokens": rb["tokens"], **(extra_r or {})},
                           cache)
        ref_logits, ref_toks = [np.asarray(logits)], [np.argmax(logits, -1)]
        pos0 = S + (rcfg.num_patches if rcfg.family == "vlm" else 0)
        for t in range(MAX_NEW - 1):
            logits, cache = dc(ref_w, jnp.asarray(ref_toks[-1][:, None],
                                                  jnp.int32),
                               jnp.int32(pos0 + t), cache)
            ref_logits.append(np.asarray(logits))
            ref_toks.append(np.argmax(logits, -1))
    out["ref_logits"], out["ref_tokens"] = ref_logits, np.stack(ref_toks, 1)
    with _policy(port_ff, pol), port_ff.use(silu="jnp"):
        total, m = port_model.train_forward(port_w, pb, pcfg)
        out["train"] = (float(total), float(m["loss"]), float(m["aux"]))
        # the port's logits along the reference's tokens
        cache = port_model.init_cache(pcfg, B, cache_len, torch.float32,
                                      device="cpu")
        logits, cache = port_model.prefill(
            port_w, {"tokens": pb["tokens"], **(extra_p or {})}, pcfg, cache)
        got = [logits.numpy()]
        for t in range(MAX_NEW - 1):
            tok = torch.from_numpy(out["ref_tokens"][:, t][:, None]).long()
            logits, cache = port_model.decode_step(port_w, tok, pos0 + t,
                                                   cache, pcfg)
            got.append(logits.numpy())
        out["logits"] = got
        out["tokens"] = greedy_generate(port_w, pcfg, pb["tokens"], MAX_NEW,
                                        cache_len,
                                        extra_inputs=extra_p).numpy()
    return out


def check_train(r):
    np.testing.assert_allclose(r["train"], r["ref_train"], atol=ATOL)
    if r["cfg"].moe_num_experts:
        assert r["train"][2] > 0           # the load-balance loss counts
        np.testing.assert_allclose(r["train"][0],
                                   r["train"][1] + 0.01 * r["train"][2],
                                   rtol=1e-6)
    else:
        assert r["train"][2] == 0 and r["train"][0] == r["train"][1]


def check_logits(r):
    assert len(r["logits"]) == len(r["ref_logits"]) == MAX_NEW
    for got, want in zip(r["logits"], r["ref_logits"]):
        assert got.shape == (B, r["cfg"].vocab_size)
        np.testing.assert_allclose(got, want, atol=ATOL)


def check_tokens(r):
    assert r["tokens"].shape == (B, MAX_NEW)
    assert np.array_equal(r["tokens"], r["ref_tokens"])


def check_whole_model(arch, pol):
    """All of one case's checks, on one run."""
    r = _run(arch, pol)
    check_train(r)
    check_logits(r)
    check_tokens(r)


@pytest.mark.parametrize("arch, pol", CASES)
def test_train_forward_matches_reference(runs, arch, pol):
    check_train(runs(arch, pol))


@pytest.mark.parametrize("arch, pol", CASES)
def test_prefill_and_decode_logits_match_reference(runs, arch, pol):
    check_logits(runs(arch, pol))


@pytest.mark.parametrize("arch, pol", CASES)
def test_greedy_generate_matches_reference(runs, arch, pol):
    check_tokens(runs(arch, pol))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_engine_refuses_moe_and_mla(arch):
    _, pcfg = _configs(arch)
    params = port_model.init_params(pcfg, torch.Generator().manual_seed(0))
    with pytest.raises(UnsupportedModelError):
        ServeEngine(params, pcfg, device="cpu", max_batch=2, page_size=8,
                    max_ctx=32)


@pytest.mark.parametrize("arch", SSM_HYBRID_ENCDEC)
def test_engine_refuses_the_ssm_hybrid_and_encdec_families(arch):
    """The paged engine raises the reference's UnsupportedModelError for
    mamba2, jamba and whisper (their training: tests/test_torch_train_*.py)."""
    _, pcfg = serve_configs(arch)
    params = port_model.init_params(pcfg, torch.Generator().manual_seed(0))
    with pytest.raises(UnsupportedModelError):
        ServeEngine(params, pcfg, device="cpu", max_batch=2, page_size=8,
                    max_ctx=32)


def test_interleaved_moe_stack_raises_as_reference():
    _, pcfg = _configs("olmoe-1b-7b")
    import dataclasses
    bad = dataclasses.replace(pcfg, moe_every=2)
    with pytest.raises(ValueError, match="interleaved"):
        port_model.init_params(bad, torch.Generator().manual_seed(0))


def test_configs_are_the_references_data():
    """Each ported configuration is the reference's, field for field."""
    import dataclasses
    from repro_torch.configs import PORTED
    for name in PORTED:
        port = port_get_config(name)
        assert dataclasses.asdict(port) == \
            dataclasses.asdict(ref_get_config(name)), name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-1b",
                                  "mamba2-370m", "whisper-medium"])
def test_serve_launcher_takes_the_new_architectures(arch):
    """``launch.serve --arch`` runs a MoE, the VLM, the SSM and the
    enc-dec config through ``greedy_generate`` (zero patches for the VLM,
    zero frames for the enc-dec, as the reference's; the hybrid takes the
    SSM's path, and its reduced 16 layers cost a CPU ~15 s); with
    ``--engine`` each stops with ``UnsupportedModelError``;
    ``launch.train`` trains the MoE and the SSM a step and stops, as the
    reference's launcher, with ``KeyError`` on the VLM's patches and the
    enc-dec's frames (its batches hold tokens and targets only;
    tests/test_torch_train_families.py runs the reference's)."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--max-new", "3"]
    out = launch_serve.main(args)
    assert out["tokens"].shape == (2, 3)
    assert np.isfinite(out["logprobs"]).all()
    with pytest.raises(UnsupportedModelError):
        launch_serve.main(args + ["--engine"])
    train = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "1",
             "--seq", "8", "--batch", "2"]
    missing = {"vlm": "patches", "encdec": "frames"}.get(
        port_get_config(arch).family)
    if missing:
        with pytest.raises(KeyError, match=missing):
            launch_train.main(train)
    else:
        out = launch_train.main(train)
        assert out["step"] == 1 and np.isfinite(out["last_loss"])
