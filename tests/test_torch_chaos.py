"""The port's ``chaos`` tier against the reference's ``repro.chaos``.

  * the injectors: ``repro_torch.chaos.ChaosMonkey(seed)`` makes the
    reference's draws, so on the same state it poisons the same
    coordinates with the same bits, flips the same block-table entry to
    the same page, steals the same pages and writes the same bytes (the
    tuning sidecars, the torn leaf, the flipped checkpoint bit, the stale
    manifest);
  * the fault classes of the reference's ``tests/test_chaos.py``: port
    and reference engines (the chaos config, the same weights, the
    reference under ``ff.use(logsumexp="jnp")``: its CPU default is an
    f64 tier the installed JAX cannot run), each poisoned by its own
    package's injector with the same seed, give the same statuses,
    details, tokens and ``guard_stats``; the port's ``OK`` rows are its
    healthy ``greedy_generate``, its ``DEGRADED`` rows the fast tier's,
    its ``FAILED`` rows withheld; after each restart-tier corruption both
    loaders pick the same checkpoint generation (or both refuse);
  * ``python -m repro_torch.chaos --device cpu`` exits 0;
  * ``python -m repro_torch.chaos.restart``'s ``run_scenario`` on the CPU
    (a child process SIGKILLed mid-decode, the resume bit for bit the
    uninterrupted run) for ``bf16``.

Local generators only; every comparison is exact.
"""

import dataclasses
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.ff as ref_ff
from repro.chaos import ChaosMonkey as RefMonkey
from repro.checkpoint import checkpoint as ref_ckpt
from repro.models import init_params as ref_init_params
from repro.models.config import ModelConfig as RefConfig
from repro.serve import PagedKVCache as RefKV
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine

from repro_torch.chaos import ChaosMonkey
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.ff.scope import resolve_policy
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.serve import (DEGRADED, FAILED, GUARD_STAT_KEYS, OK,
                               STATUSES, PagedKVCache, Request, ServeEngine)
from repro_torch.train.serve_step import greedy_generate

FIELDS = dict(name="chaos-test", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
              max_seq_len=64, compute_dtype="float32", remat=False)
REF_CFG, PORT_CFG = RefConfig(**FIELDS), PortConfig(**FIELDS)


@pytest.fixture(scope="module")
def weights():
    ref = ref_init_params(REF_CFG, jax.random.PRNGKey(0))
    return ref, params_from_numpy(jax.tree_util.tree_map(np.asarray, ref),
                                  device="cpu")


def _bits(plane) -> np.ndarray:
    """A KV plane's bits, from either package."""
    if isinstance(plane, torch.Tensor):
        t = plane.cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t.view(torch.int32)).numpy().view(np.uint8)
    a = np.asarray(plane)
    return a.view(np.uint8)


def _caches(kv_mode):
    """Both packages' caches with the same pages allocated and the same
    live lengths (3 slots, two pages left free)."""
    kw = dict(num_pages=11, page_size=4, max_seqs=3, max_ctx=16,
              kv_mode=kv_mode)
    ref, port = RefKV(2, 2, 8, **kw), PagedKVCache(2, 2, 8, device="cpu",
                                                   **kw)
    for slot, n in ((0, 11), (1, 7), (2, 13)):
        ref.alloc(slot, n)
        port.alloc(slot, n)
    assert np.array_equal(ref.block_table, port.block_table)
    assert ref.free_pages == port.free_pages
    return ref, port


# --------------------------------------------------------------------------
# the injectors' draws and bytes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_mode", ["bf16", "f32", "ff_bf16"])
@pytest.mark.parametrize("kind", ["nan", "inf", "denormal_lo"])
def test_corrupt_kv_limbs_matches_reference(kv_mode, kind):
    ref, port = _caches(kv_mode)
    for seed, kw in ((3, {}), (4, {"base": "v", "limb": "hi"})):
        want = RefMonkey(seed).corrupt_kv_limbs(ref, 1, kind=kind, n=5, **kw)
        got = ChaosMonkey(seed).corrupt_kv_limbs(port, 1, kind=kind, n=5,
                                                 **kw)
        assert got == want
    assert sorted(port.planes) == sorted(ref.planes)
    for name in port.planes:
        assert np.array_equal(_bits(port.planes[name]),
                              _bits(ref.planes[name])), name
    with pytest.raises(ValueError, match="kind"):
        ChaosMonkey(0).corrupt_kv_limbs(port, 0, kind="zero")
    port.seq_lens[0] = 0
    with pytest.raises(ValueError, match="no live"):
        ChaosMonkey(0).corrupt_kv_limbs(port, 0)


@pytest.mark.parametrize("mode", ["oob", "dup", "free"])
def test_flip_block_table_matches_reference(mode):
    ref, port = _caches("bf16")
    for seed in (7, 8, 9):
        want = RefMonkey(seed).flip_block_table(ref, 2, mode=mode)
        got = ChaosMonkey(seed).flip_block_table(port, 2, mode=mode)
        assert got == want
        assert np.array_equal(port.block_table, ref.block_table)
    with pytest.raises(ValueError, match="mode"):
        ChaosMonkey(0).flip_block_table(port, 0, mode="swap")


def test_exhaust_pool_matches_reference():
    ref, port = _caches("f32")
    before = list(port.free_pages)
    for keep in (0, 1):
        with RefMonkey(1).exhaust_pool(ref, keep=keep) as want, \
                ChaosMonkey(1).exhaust_pool(port, keep=keep) as got:
            assert got == want and len(port.free_pages) == keep
            assert not port.can_alloc(5)
        assert port.free_pages == ref.free_pages == before


def _tree_bytes(d):
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def _gens(d, steps=(1, 2, 3)):
    rng = np.random.default_rng(781)
    for s in steps:
        ckpt.save(str(d), s, {"w": rng.standard_normal(200).astype(
            np.float32), "ids": np.arange(s * 4, dtype=np.int32)},
            extra={"tag": s})


@pytest.mark.parametrize("fault", ["tear", "flip", "stale", "tune"])
def test_file_corruptions_write_the_reference_bytes(fault, tmp_path):
    """Each file injector writes, with the same seed on the same files,
    the reference's bytes."""
    a, b = tmp_path / "port", tmp_path / "ref"
    _gens(a)
    shutil.copytree(a, b)
    for seed in (5, 6):
        if fault == "tear":
            got = ChaosMonkey(seed).tear_checkpoint_tmp(str(a), step=90 + seed)
            want = RefMonkey(seed).tear_checkpoint_tmp(str(b), step=90 + seed)
        elif fault == "flip":
            got = ChaosMonkey(seed).flip_checkpoint_bit(str(a))
            want = RefMonkey(seed).flip_checkpoint_bit(str(b))
            assert got == want
        elif fault == "stale":
            got = ChaosMonkey(seed).stale_manifest(str(a), step=seed - 3)
            want = RefMonkey(seed).stale_manifest(str(b), step=seed - 3)
        else:
            for mode in ("truncate", "garbage", "wrong_types"):
                got = ChaosMonkey(seed).mangle_tune_json(
                    str(a / f"tune_{mode}.json"), mode=mode)
                want = RefMonkey(seed).mangle_tune_json(
                    str(b / f"tune_{mode}.json"), mode=mode)
        assert os.path.relpath(got, a) == os.path.relpath(want, b)
    assert _tree_bytes(a) == _tree_bytes(b)
    with pytest.raises(ValueError, match="no checkpoint"):
        ChaosMonkey(0).flip_checkpoint_bit(str(tmp_path / "empty"))


@pytest.mark.parametrize("fault", ["tear", "flip_newest", "flip_twice",
                                   "stale_newest", "stale_all"])
def test_loaders_pick_the_same_generation(fault, tmp_path):
    """After each restart-tier corruption, applied by each package's
    injector to its own copy, both loaders land on the same generation
    with the same arrays, or both refuse with CheckpointError."""
    a, b = tmp_path / "port", tmp_path / "ref"
    _gens(a)
    shutil.copytree(a, b)
    for d, monkey in ((a, ChaosMonkey(12)), (b, RefMonkey(12))):
        if fault == "tear":
            monkey.tear_checkpoint_tmp(str(d))
        elif fault.startswith("flip"):
            monkey.flip_checkpoint_bit(str(d))
            if fault == "flip_twice":
                monkey.flip_checkpoint_bit(str(d), step=2)
        elif fault == "stale_newest":
            monkey.stale_manifest(str(d))
        else:
            for s in (1, 2, 3):
                monkey.stale_manifest(str(d), step=s)
    out = {}
    for name, d, lib in (("port", a, ckpt), ("ref", b, ref_ckpt)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                arrays, step, extra = lib.load_dict(str(d))
                out[name] = (step, extra["tag"],
                             {k: np.asarray(v).tobytes()
                              for k, v in arrays.items()})
            except lib.CheckpointError:
                out[name] = "refused"
        out[name + "_warned"] = len(caught) > 0
    assert out["port"] == out["ref"]
    assert out["port_warned"] == out["ref_warned"] == (fault != "tear")
    want = {"tear": 3, "flip_newest": 2, "flip_twice": 1, "stale_newest": 2,
            "stale_all": None}[fault]
    assert (out["port"] == "refused") if want is None \
        else out["port"][0] == want
    assert not any(n.endswith(".tmp") for n in os.listdir(a))


# --------------------------------------------------------------------------
# the fault classes: port engine vs reference engine
# --------------------------------------------------------------------------

def _prompts(n, seed=777, lo=6, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, FIELDS["vocab_size"], size=int(s)).astype(
        np.int32) for s in rng.integers(lo, hi, size=n)]


def _port_baseline(port_w, prompt, max_new, fast=False):
    pol = dataclasses.replace(resolve_policy(None), attention="fast",
                              ff_math=False) if fast else None
    return greedy_generate(port_w, PORT_CFG, torch.as_tensor(
        prompt[None], dtype=torch.long), max_new, cache_len=48,
        policy=pol)[0].numpy()


# name -> (engine knobs, prompts (n, lo, hi), max_new, the fault: a
# function (engine, monkey) run after one step, or "alloc" / "deadlines"
# / "rejects" for the submit-time classes)
SCENARIOS = {
    "nan": (dict(guard="degrade"), (2,), 6,
            lambda e, m: m.corrupt_kv_limbs(e.kv, 0, kind="nan", n=2)),
    "inf": (dict(guard="degrade"), (2,), 6,
            lambda e, m: m.corrupt_kv_limbs(e.kv, 0, kind="inf", n=2)),
    "guard_off": (dict(max_batch=1, guard="off"), (1,), 6,
                  lambda e, m: m.corrupt_kv_limbs(e.kv, 0, kind="nan", n=2)),
    "denormal_lo": (dict(max_batch=1, kv_mode="ff_bf16", guard="degrade"),
                    (1,), 4,
                    lambda e, m: m.corrupt_kv_limbs(
                        e.kv, 0, kind="denormal_lo", n=3, base="k",
                        limb="lo")),
    "oob": (dict(guard="degrade"), (2,), 6,
            lambda e, m: m.flip_block_table(e.kv, 1, mode="oob")),
    "free": (dict(guard="degrade"), (2,), 6,
             lambda e, m: m.flip_block_table(e.kv, 1, mode="free")),
    "dup": (dict(guard="degrade"), (2,), 6,
            lambda e, m: m.flip_block_table(e.kv, 1, mode="dup")),
    "preempt": (dict(max_batch=3, num_pages=8, reserve="prompt"),
                (3, 7, 9), 8, None),
    "alloc": (dict(max_batch=1, reserve="prompt"), (1,), 4, "alloc"),
    "deadlines": (dict(max_batch=1), (2,), 8, "deadlines"),
    "rejects": (dict(max_batch=1, num_pages=4, max_queue=1), (1, 8, 9), 4,
                "rejects"),
}


def _serve(make_engine, mk_req, monkey, knobs, prompts, max_new, fault):
    eng = make_engine(knobs)
    if fault == "alloc":
        with monkey.exhaust_pool(eng.kv):
            eng.submit(mk_req(uid=0, prompt=prompts[0], max_new=max_new))
            eng.run()
        eng.submit(mk_req(uid=1, prompt=prompts[0], max_new=max_new))
        return eng, eng.run()
    if fault == "deadlines":
        eng.submit(mk_req(uid=0, prompt=prompts[0], max_new=max_new,
                          deadline_steps=3))
        eng.submit(mk_req(uid=1, prompt=prompts[1], max_new=max_new,
                          deadline_steps=2))
        eng.submit(mk_req(uid=2, prompt=prompts[1], max_new=max_new,
                          deadline_steps=0))
        return eng, eng.run()
    if fault == "rejects":
        for uid, n in ((0, 64), (1, 20), (2, max_new), (3, max_new)):
            eng.submit(mk_req(uid=uid, prompt=prompts[0], max_new=n))
        return eng, eng.run()
    for i, p in enumerate(prompts):
        eng.submit(mk_req(uid=i, prompt=p, max_new=max_new))
    if fault is not None:
        eng.step()
        fault(eng, monkey)
    return eng, eng.run()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fault_class_matches_reference(weights, name):
    ref_w, port_w = weights
    knobs, shape, max_new, fault = SCENARIOS[name]
    knobs = {**dict(max_batch=2, page_size=4, max_ctx=32), **knobs}
    prompts = _prompts(*shape)
    with ref_ff.use(logsumexp="jnp"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref, ref_res = _serve(
            lambda kw: RefEngine(ref_w, REF_CFG, **kw), RefRequest,
            RefMonkey(11), knobs, prompts, max_new, fault)
        eng, res = _serve(
            lambda kw: ServeEngine(port_w, PORT_CFG, device="cpu", **kw),
            Request, ChaosMonkey(11), knobs, prompts, max_new, fault)
    assert sorted(res) == sorted(ref_res)
    for uid, r in res.items():
        want = ref_res[uid]
        assert (r.status, r.detail) == (want.status, want.detail), uid
        assert np.array_equal(r.tokens, want.tokens), uid
        assert r.status in STATUSES
        if r.status in (OK, DEGRADED) and name not in ("guard_off",
                                                       "deadlines"):
            p = prompts[0] if name in ("alloc", "rejects") else prompts[uid]
            assert np.array_equal(r.tokens, _port_baseline(
                port_w, p, max_new, fast=r.status == DEGRADED)), uid
        if r.status == FAILED:
            assert r.tokens.size == 0
    for k in GUARD_STAT_KEYS:
        assert eng.guard_stats[k] == ref.guard_stats[k], k
    assert eng.kv.check_integrity() == ([], set())
    statuses = [res[u].status for u in sorted(res)]
    expect = {"nan": [DEGRADED, DEGRADED], "oob": [OK, DEGRADED],
              "free": [OK, DEGRADED], "dup": [DEGRADED, DEGRADED],
              "guard_off": [OK], "preempt": [OK, OK, OK],
              "alloc": [FAILED, OK],
              "deadlines": ["TIMEOUT", "TIMEOUT", "TIMEOUT"],
              "rejects": ["REJECTED", "REJECTED", OK, "REJECTED"]}
    if name in expect:
        assert statuses == expect[name]
    if name == "preempt":
        assert eng.guard_stats["preempted"] >= 1
    if name in ("oob", "free", "dup"):
        assert eng.guard_stats["integrity_rebuilds"] >= 1


# --------------------------------------------------------------------------
# the smokes
# --------------------------------------------------------------------------

def test_chaos_smoke_on_cpu(capsys):
    from repro_torch.chaos.__main__ import main
    report = {}
    assert main(["--device", "cpu"], report=report) == 0
    out = capsys.readouterr().out
    assert "chaos smoke: all checks passed" in out and "[FAIL]" not in out
    assert report["healthy"] and all(
        s == OK for s, _ in report["healthy"].values())
    assert any(s == DEGRADED for s, _ in report["poison nan"].values())


def test_restart_chaos_kill_and_resume_on_cpu(tmp_path):
    from repro_torch.chaos.restart import run_scenario
    rep = run_scenario(str(tmp_path / "bf16"), "bf16", device="cpu",
                       timeout_s=120.0)
    assert rep["statuses"] == {0: OK, 1: OK, 2: OK}
    assert rep["killed_at_snaps"] >= 2 and rep["resumed_from_step"] >= 4
    assert not (tmp_path / "bf16" / "done").exists()
