"""Training of the non-dense families (MoE, MLA, VLM, SSM, hybrid,
enc-dec) against the reference on the CPU: the shared gradient check and
the port-only cases.

``grad_run(arch, pol)`` takes ``train_forward``'s loss, aux and every
gradient leaf from one ``jax.jit(jax.value_and_grad(...))`` of the
reference and one ``torch.autograd.grad`` of the port, on the same
weights (the port's init, handed across as jax arrays) and batch, each
config ``reduced(compute_dtype="float32")`` (jamba cut to one 8-layer
period, as ``test_torch_families.serve_configs``; no remat: the port's
``torch.utils.checkpoint`` per layer, hybrid period, encoder and decoder
layer is held bit for bit to no remat below).  Policies: ``ff_reduce``
with the reference's ``attention="ff"`` and the port's ``"pallas"`` (each
kernel's plain version on a CPU tensor; the backward of both is the fast
f32 recurrence recomputed; whisper's ``ATTENTION`` says why it takes the
fast tier), and ``ff_math`` (the FF exp / log1p of the SSD, the FF silu
gates).  The cases are spread over
tests/test_torch_train_ssm.py, _moe.py, _hybrid.py and _encdec.py: a
reference compile takes 2-15 s, and ``--dist loadfile`` keeps a file on
one worker.

Tolerances: losses and aux within ``test_torch_families.ATOL`` (1e-4);
each gradient leaf within ``GRAD_RTOL`` = 1e-4 of that leaf's largest
|g| (f32 products and reductions in XLA's and PyTorch's orders; measured
<= 7.5e-6 over the six families); ``ssd_scan``-level cases at 1e-4 of
the largest output or gradient.  The reference runs with
``test_torch_families.SERVE_REF_PINS`` (explicit non-f64 impls), the
port with ``SERVE_PORT_PINS``.  Inputs come from
``np.random.default_rng``.

Here: the tree walks over the hybrid's tuple (jax's leaf order), remat
bit for bit against no remat in each new stack, ``check_supported``,
and ``launch.train`` against the reference's launcher (it trains and
resumes MoE, MLA, SSM and hybrid configs; its batches hold tokens and
targets only, so both launchers stop with ``KeyError`` on the VLM and
the enc-dec).
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
import repro_torch.ff as port_ff
import test_torch_families as families
from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro_torch.checkpoint.checkpoint import (available_steps,
                                               flatten_with_names)
from repro_torch.configs import get_config as port_get_config
from repro_torch.models import model as port_model
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ATOL = families.ATOL
GRAD_RTOL = 1e-4
B, S = 2, 8
POLICIES = {"ff_reduce": {}, "ff_math": dict(ff_math=True)}
one_thread = families.one_thread

# each case's attention tiers (reference, port); whisper's three attention
# sites take the fast tier in both: the reference's "ff" tier would add
# ~10 s of tracing and compiling, and the accurate tiers' non-causal
# backward is held in tests/test_torch_train_encdec.py
ATTENTION = {"whisper-medium": ("fast", "fast")}


def configs(arch):
    """The reference's reduced f32 config of ``arch`` and the port's."""
    return families.serve_configs(arch, compute_dtype="float32")


def batch(cfg, seed=41):
    """tokens and targets (B, S), and the VLM's patches or the enc-dec's
    frames from a seeded normal draw: numpy."""
    rng = np.random.default_rng(seed)
    out = {n: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for n in ("tokens", "targets")}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def to_torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def port_grads(params, b, cfg, **policy):
    """``train_forward``'s (total, metrics) and the gradient of every leaf
    (``tree_leaves`` order) under ``ff.policy("ff_reduce", **policy)``
    and the port's pins."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with port_ff.policy("ff_reduce", **policy), \
                port_ff.use(**families.SERVE_PORT_PINS):
            total, m = port_model.train_forward(params, b, cfg)
            grads = torch.autograd.grad(total, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return total.detach(), {k: v.detach() for k, v in m.items()}, grads


@functools.lru_cache(maxsize=None)
def grad_run(arch, pol):
    """One case in both packages: {"ref" | "port": (total, loss, aux,
    [gradient leaves as numpy]), "names": the leaves' names}."""
    rcfg, pcfg = configs(arch)
    pw = port_model.init_params(pcfg, torch.Generator().manual_seed(5))
    rw = families.to_jax(pw)
    b = batch(pcfg)
    ref_attn, port_attn = ATTENTION.get(arch, ("ff", "pallas"))
    with ref_ff.policy("ff_reduce", attention=ref_attn, **POLICIES[pol]), \
            ref_ff.use(**families.SERVE_REF_PINS):
        (total, m), g = jax.jit(jax.value_and_grad(
            lambda w, x: ref_model.train_forward(w, x, rcfg),
            has_aux=True))(rw, {k: jnp.asarray(v) for k, v in b.items()})
    ref = (float(total), float(m["loss"]), float(m["aux"]),
           [np.asarray(t) for t in jax.tree_util.tree_leaves(g)])
    total, m, grads = port_grads(pw, to_torch(b), pcfg, attention=port_attn,
                                 **POLICIES[pol])
    port = (float(total), float(m["loss"]), float(m["aux"]),
            [t.numpy() for t in grads])
    return {"ref": ref, "port": port, "cfg": pcfg,
            "names": [n for n, _ in flatten_with_names(pw)]}


def check_grads(arch, pol):
    """Loss, aux and total within ATOL; each leaf's gradient finite and
    within GRAD_RTOL of that leaf's largest |g|.  Returns the run."""
    r = grad_run(arch, pol)
    ref, port = r["ref"], r["port"]
    np.testing.assert_allclose(port[:3], ref[:3], atol=ATOL)
    if r["cfg"].moe_num_experts:
        assert port[2] > 0                 # the load-balance loss counts
    else:
        assert port[2] == 0 and port[0] == port[1]
    assert len(port[3]) == len(ref[3]) == len(r["names"])
    for name, got, want in zip(r["names"], port[3], ref[3]):
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, (
            name, float(np.abs(got - want).max()), float(scale))
    return r


def grads_of(r, prefix):
    """The port's gradients of the leaves whose names start with
    ``prefix``."""
    return [g for n, g in zip(r["names"], r["port"][3])
            if n.startswith(prefix)]


# --------------------------------------------------------------------------
# tree walks over the hybrid's tuple
# --------------------------------------------------------------------------

def tiny_hybrid(get_config=port_get_config):
    """A small hybrid config (the port's, or the reference's with
    ``ref_get_config``): one 8-layer period at narrow widths."""
    return get_config("jamba_1_5_large_398b").reduced(
        num_layers=8, d_model=64, d_ff=64, moe_d_ff=32, vocab_size=64,
        head_dim=16, ssm_state=8, ssm_head_dim=16, compute_dtype="float32")


def test_tree_walks_follow_jax_leaf_order():
    """``tree_leaves`` (the optimizer's, the grad norm's and the
    checkpoints' order) is jax's on the hybrid tree (dict keys sorted,
    tuple items by index), ``tree_map`` keeps the tuple, ``layer`` and
    ``unstack_layers`` give each period's tuple of per-index dicts, and
    ``tree_unflatten`` (the train step's) rebuilds the tree from its
    leaves."""
    cfg = tiny_hybrid()
    cfg = dataclasses.replace(cfg, num_layers=16)      # two periods
    p = port_model.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = tree_leaves(p)
    ids = [id(t) for t in leaves]
    assert ids == [id(t) for t in jax.tree_util.tree_leaves(p)]
    assert isinstance(tree_map(lambda t: t, p)["layers"], tuple)
    back = tree_unflatten(p, iter(leaves))
    assert [id(t) for t in tree_leaves(back)] == ids
    assert isinstance(back["layers"], tuple)
    periods = port_model.unstack_layers(p["layers"], 2)
    for i, per in enumerate(periods):
        assert isinstance(per, tuple) and len(per) == cfg.attn_every
        for a, b in zip(tree_leaves(per),
                        tree_leaves(port_model.layer(p["layers"], i))):
            assert torch.equal(a, b)


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test: the embedding's
    backward sums repeated tokens in a thread-dependent order on the CPU
    otherwise."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b",
                                  "whisper-medium", "deepseek-v2-236b"])
def test_remat_gives_the_same_gradients(arch, deterministic):
    """``cfg.remat`` (a checkpoint per layer, per hybrid period, per
    encoder and decoder layer) recomputes the same values: loss and every
    gradient bit for bit against no remat, at narrow widths."""
    kw = dict(d_model=64, d_ff=64, moe_d_ff=32, vocab_size=64,
              ssm_state=8, ssm_head_dim=16, encoder_seq=12,
              compute_dtype="float32")
    if arch != "deepseek-v2-236b":
        kw["head_dim"] = 16
    if arch.startswith("jamba"):
        kw["num_layers"] = 8
    cfg = port_get_config(arch).reduced(**kw)
    p = port_model.init_params(cfg, torch.Generator().manual_seed(0))
    b = to_torch(batch(cfg))
    out = [port_grads(p, b, dataclasses.replace(cfg, remat=remat),
                      attention="pallas") for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][2], out[1][2]):
        assert torch.equal(a, c)


def test_check_supported_refuses_only_interleaved_moe():
    """Every family trains: ``check_supported`` (called by ``init_params``,
    ``train_forward`` and the serving entry points) raises only the
    reference's ``ValueError`` for an interleaved dense/MoE stack outside
    the hybrid family, which keeps ``moe_every = 2``."""
    from repro_torch.configs import PORTED
    for name in PORTED:
        port_model.check_supported(port_get_config(name).reduced())
    olmoe = port_get_config("olmoe-1b-7b").reduced()
    with pytest.raises(ValueError, match="interleaved"):
        port_model.check_supported(dataclasses.replace(olmoe, moe_every=2))
    assert port_get_config("jamba-1.5-large-398b").moe_every == 2


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LAUNCH = ["--reduced", "--device", "cpu", "--seq", "8", "--batch", "2",
          "--policy", "ff_reduce"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
def test_launch_train_trains_and_resumes(arch, tmp_path, capsys):
    """``launch.train --arch`` on an SSM, an MLA + MoE and the hybrid
    config: a step checkpointed, then a second after resuming from it."""
    from repro_torch.launch import train
    args = ["--arch", arch, *LAUNCH, "--ckpt-dir", str(tmp_path)]
    first = train.main(args + ["--steps", "1"])
    assert first["step"] == 1 and np.isfinite(first["last_loss"])
    assert available_steps(str(tmp_path)) == [1]
    out = train.main(args + ["--steps", "2"])
    assert out["step"] == 2 and np.isfinite(out["last_loss"])
    assert "[trainer] resumed from step 1" in capsys.readouterr().out
    assert available_steps(str(tmp_path)) == [1, 2]


@pytest.mark.parametrize("arch, key", [("internvl2-1b", "patches"),
                                       ("whisper-medium", "frames")])
def test_launch_train_stops_as_the_reference(arch, key, monkeypatch):
    """The reference's launcher feeds ``SyntheticLM`` batches (tokens and
    targets only): on the VLM and the enc-dec its first step raises
    ``KeyError`` for the missing input, at trace time.  The port's
    launcher stops with the same ``KeyError``."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", ["train", "--arch",
                                      arch.replace("-", "_"), "--reduced",
                                      "--seq", "8", "--batch", "2",
                                      "--steps", "1"])
    with pytest.raises(KeyError) as ref_err:
        ref_train.main()
    with pytest.raises(KeyError) as err:
        train.main(["--arch", arch, *LAUNCH, "--steps", "1"])
    assert err.value.args == ref_err.value.args == (key,)
