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
engine's paged path stays dense-only: a MoE or MLA config raises the
reference's ``UnsupportedModelError``; the SSM, hybrid and enc-dec
families raise ``NotImplementedError`` naming their ROADMAP item.

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
from repro.train.serve_step import make_prefill_step as ref_prefill_step
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

    def to_jax(tree):
        return {k: to_jax(v) if isinstance(v, dict)
                else jnp.asarray(v.numpy()) for k, v in tree.items()}
    return to_jax(port_w), port_w


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


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba_1_5_large_398b",
                                  "whisper-medium"])
def test_other_families_name_their_roadmap_item(arch):
    cfg = ref_get_config(arch).reduced()
    port_cfg = port_model.ModelConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    with pytest.raises(NotImplementedError, match="ROADMAP.md .* item 7"):
        port_model.init_params(port_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md .* item 7"):
        port_model.check_supported(port_cfg)


def test_interleaved_moe_stack_raises_as_reference():
    _, pcfg = _configs("olmoe-1b-7b")
    import dataclasses
    bad = dataclasses.replace(pcfg, moe_every=2)
    with pytest.raises(ValueError, match="interleaved"):
        port_model.init_params(bad, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b",
                                  "internvl2-1b"])
def test_training_of_the_new_families_waits(arch):
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import make_train_step
    _, pcfg = _configs(arch)
    with pytest.raises(NotImplementedError, match="item 7"):
        make_train_step(pcfg, optimizer=AdamW())


def test_configs_are_the_references_data():
    """Each ported configuration is the reference's, field for field."""
    import dataclasses
    from repro_torch.configs import PORTED
    for name in PORTED:
        port = port_get_config(name)
        assert dataclasses.asdict(port) == \
            dataclasses.asdict(ref_get_config(name)), name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "internvl2-1b"])
def test_serve_launcher_takes_the_new_architectures(arch):
    """``launch.serve --arch`` runs a MoE and the VLM config through
    ``greedy_generate`` (zero patches for the VLM); with ``--engine`` a
    MoE config stops with ``UnsupportedModelError``; ``launch.train``
    stops on it with ``NotImplementedError``."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--max-new", "3"]
    out = launch_serve.main(args)
    assert out["tokens"].shape == (2, 3)
    assert np.isfinite(out["logprobs"]).all()
    if arch == "olmoe-1b-7b":
        with pytest.raises(UnsupportedModelError):
            launch_serve.main(args + ["--engine"])
    with pytest.raises(NotImplementedError, match="item 7"):
        launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "1"])
