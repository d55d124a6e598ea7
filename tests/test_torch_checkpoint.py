"""The port's checkpoints, trainer resume and launchers, against the
reference.

  * ``repro_torch.checkpoint`` is ``repro.checkpoint``'s format: the same
    tree written by both packages gives the same manifest (leaf names,
    shapes, dtypes, CRC32s), and each package loads the other's files, a
    bf16 leaf included; the reference's verification ladder (bit flip,
    stale schema, torn ``.tmp``, everything corrupt, a missing directory,
    async write errors) holds, the faults injected by the reference's
    ``ChaosMonkey`` into the port's files;
  * ``Trainer`` resume: 2 steps, a crash, a restored third step is bit for
    bit 3 uninterrupted steps, and the ``{"params", "opt"}`` leaf names are
    the reference's;
  * ``launch/train.py --ckpt-dir`` and ``launch/serve.py`` on the CPU, the
    flags that wait for other ROADMAP items refused.

Local generators only.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.ff as port_ff
from repro.chaos.inject import ChaosMonkey
from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import (AsyncCheckpointer,
                                    CheckpointCorruptionWarning,
                                    CheckpointError, available_steps,
                                    latest_step, load, load_dict, save)
from repro_torch.checkpoint.checkpoint import flatten_with_names
from repro_torch.configs import get_config as port_get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import init_params
from repro_torch.optim import adamw as port_adamw
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def _bits(x) -> np.ndarray:
    """A bf16 leaf's bits, from either package's loaded form."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


# --------------------------------------------------------------------------
# the verification ladder
# --------------------------------------------------------------------------

def _write_gens(d, steps=(1, 2, 3)):
    rng = np.random.default_rng(781)
    trees = {}
    for s in steps:
        trees[s] = {"w": torch.from_numpy(
                        rng.standard_normal(16).astype(np.float32)),
                    "ids": np.arange(s * 4, dtype=np.int32)}
        save(str(d), s, trees[s], extra={"tag": s})
    return trees


def _same_tree(arrays, tree):
    for k, v in tree.items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v))


def test_checkpoint_roundtrip_with_extra(tmp_path):
    trees = _write_gens(tmp_path)
    arrays, step, extra = load_dict(str(tmp_path))
    assert step == 3 and extra["tag"] == 3
    _same_tree(arrays, trees[3])
    assert available_steps(str(tmp_path)) == [1, 2, 3]
    got, step, _ = load(str(tmp_path), trees[2], step=2)
    assert step == 2 and sorted(got) == ["ids", "w"]
    _same_tree(got, trees[2])
    with pytest.raises(ValueError, match="ckpt"):
        load(str(tmp_path), {"w": torch.zeros(3), "ids": trees[3]["ids"]})
    with pytest.raises(KeyError, match="missing"):
        load(str(tmp_path), {"other": torch.zeros(3)})


def test_keep_last_three_generations(tmp_path):
    _write_gens(tmp_path, steps=(1, 2, 3, 4, 5))
    assert available_steps(str(tmp_path)) == [3, 4, 5]


def test_crc_bit_flip_falls_back_warned(tmp_path):
    """One flipped payload bit in the newest generation: the CRC catches
    it and the load falls back, warned, to the previous generation."""
    trees = _write_gens(tmp_path)
    ChaosMonkey(7).flip_checkpoint_bit(str(tmp_path))
    with pytest.warns(CheckpointCorruptionWarning):
        arrays, step, extra = load_dict(str(tmp_path))
    assert step == 2 and extra["tag"] == 2
    _same_tree(arrays, trees[2])


def test_stale_manifest_schema_falls_back_warned(tmp_path):
    _write_gens(tmp_path)
    ChaosMonkey(8).stale_manifest(str(tmp_path), version=1)
    with pytest.warns(CheckpointCorruptionWarning):
        _, step, _ = load_dict(str(tmp_path))
    assert step == 2


def test_torn_tmp_skipped_and_garbage_collected(tmp_path):
    _write_gens(tmp_path)
    torn = ChaosMonkey(9).tear_checkpoint_tmp(str(tmp_path), step=99)
    assert available_steps(str(tmp_path)) == [1, 2, 3]
    assert not os.path.exists(torn)
    assert latest_step(str(tmp_path)) == 3


def test_every_generation_corrupt_raises(tmp_path):
    _write_gens(tmp_path)
    mk = ChaosMonkey(10)
    for s in (1, 2, 3):
        mk.flip_checkpoint_bit(str(tmp_path), step=s)
    with pytest.warns(CheckpointCorruptionWarning):
        with pytest.raises(CheckpointError):
            load_dict(str(tmp_path))


def test_missing_directory_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_dict(str(tmp_path / "nope"))
    assert latest_step(str(tmp_path / "nope")) is None


def test_async_checkpointer_poll_surfaces_write_error(tmp_path):
    """A failing write surfaces through poll(), and through wait()."""
    for reap in ("poll", "wait"):
        d = tmp_path / reap
        ac = AsyncCheckpointer(str(d))
        (d / "step_00000001.tmp").write_text("in the way")
        ac.save(1, {"a": torch.zeros(4)})
        if reap == "wait":
            with pytest.raises(OSError):
                ac.wait()
            continue
        err = None
        for _ in range(500):
            err = ac.poll()
            if err is not None:
                break
            time.sleep(0.01)
        assert err is not None and ac.poll() is None


def test_async_checkpointer_copies_before_in_place_update(tmp_path):
    """The tree is copied to the host on the call: an in-place update
    right after it (the port's optimizer) does not reach the file."""
    ac = AsyncCheckpointer(str(tmp_path))
    w = torch.arange(6, dtype=torch.float32)
    ac.save(5, {"a": w}, extra={"k": 1})
    w.add_(100.0)
    ac.wait()
    arrays, step, extra = load_dict(str(tmp_path))
    assert step == 5 and extra["k"] == 1
    np.testing.assert_array_equal(arrays["a"], np.arange(6, dtype=np.float32))


# --------------------------------------------------------------------------
# the files across the packages
# --------------------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(792)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    ids = np.arange(7, dtype=np.int32)
    bf = rng.standard_normal(6).astype(np.float32)
    state = [np.int32(4), {"w": w * 3}, {"w": w * 4}, {"w": w * 5}]
    ref = {"w": jnp.asarray(w), "nested": {"ids": jnp.asarray(ids),
                                           "bf": jnp.asarray(bf,
                                                             jnp.bfloat16)},
           "lst": [jnp.asarray(w * 2), (jnp.asarray(ids),)],
           "opt": ref_adamw.AdamWState(*(jax.tree_util.tree_map(
               jnp.asarray, s) for s in state))}
    port = {"w": torch.from_numpy(w),
            "nested": {"ids": torch.from_numpy(ids),
                       "bf": torch.from_numpy(bf).to(torch.bfloat16)},
            "lst": [torch.from_numpy(w * 2), (torch.from_numpy(ids),)],
            "opt": port_adamw.AdamWState(
                count=torch.tensor(4, dtype=torch.int32),
                master_lo={"w": torch.from_numpy(w * 3)},
                m={"w": torch.from_numpy(w * 4)},
                v={"w": torch.from_numpy(w * 5)})}
    return ref, port


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_files_cross_packages(tmp_path, writer):
    """The same tree written by both packages: equal manifests (names,
    shapes, dtypes with "bfloat16" for the bf16 leaf, CRC32s); the
    writer's files load in the other package with equal arrays."""
    ref_tree, port_tree = _trees()
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(rd, 7, ref_tree, extra={"by": "ref"})
    save(pd, 7, port_tree, extra={"by": "port"})
    mr, mp = _manifest(rd, 7), _manifest(pd, 7)
    assert mr["format"] == mp["format"] == 2
    assert mr["leaves"] == mp["leaves"]
    names = [leaf["name"] for leaf in mp["leaves"]]
    assert names == [n for n, _ in flatten_with_names(port_tree)]
    assert "nested__bf" in names and "lst__i1__i0" in names \
        and "opt__master_lo__w" in names
    assert {leaf["name"]: leaf["dtype"] for leaf in mp["leaves"]}[
        "nested__bf"] == "bfloat16"
    if writer == "ref":
        got, step, extra = load_dict(rd)
        want, _, _ = ref_ckpt.load_dict(rd)
    else:
        want, step, extra = ref_ckpt.load_dict(pd)
        got, _, _ = load_dict(pd)
    assert step == 7 and extra["by"] == writer and sorted(got) == \
        sorted(want)
    assert isinstance(got["nested__bf"], torch.Tensor)
    assert got["nested__bf"].dtype == torch.bfloat16
    for name in got:
        if name == "nested__bf":
            assert np.array_equal(_bits(got[name]), _bits(want[name]))
        else:
            assert got[name].dtype == np.asarray(want[name]).dtype
            assert np.array_equal(got[name], np.asarray(want[name])), name
    back, _, _ = load(rd if writer == "ref" else pd, port_tree)
    assert isinstance(back["opt"], port_adamw.AdamWState)
    assert isinstance(back["lst"][1], tuple)
    assert np.array_equal(back["opt"].m["w"], port_tree["opt"].m["w"])


# --------------------------------------------------------------------------
# trainer resume
# --------------------------------------------------------------------------

def _trainer(tmp, steps=3, every=2, seed=0, fault=None, cfg=None):
    cfg = cfg or port_get_config("granite-3-2b").reduced(
        compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    opt = port_adamw.AdamW(learning_rate=port_adamw.cosine_schedule(
        3e-4, 10, steps))
    with port_ff.policy("ff_reduce", attention="pallas"):
        step_fn = make_train_step(cfg, None, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2))
    return Trainer(
        TrainerConfig(total_steps=steps, ckpt_every=every,
                      ckpt_dir=None if tmp is None else str(tmp),
                      log_every=100),
        step_fn, params, opt.init(params),
        lambda i: {k: torch.from_numpy(x) for k, x in data.batch(i).items()},
        fault_hook=fault, log_fn=lambda s: None)


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test: the embedding's
    backward (``index_put_`` with accumulation) sums repeated tokens in a
    thread-dependent order on the CPU otherwise, so two uninterrupted runs
    already differ in their last bits."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_trainer_resume_bitwise(tmp_path, deterministic):
    check_trainer_resume(tmp_path, ref_get_config("granite-3-2b").reduced(
        compute_dtype="float32"))


def check_trainer_resume(tmp_path, ref_cfg, cfg=None):
    """Crash at step 2 (after the checkpoint there), a new Trainer
    restores and takes step 3: parameters, optimizer state and the last
    loss bit for bit 3 uninterrupted steps.  The checkpoint's leaf names
    are the reference's for the same tree (``ref_cfg``'s; ``cfg`` is the
    port's, granite-3-2b reduced by default)."""
    want = _trainer(None, cfg=cfg)
    want_out = want.run()

    class Boom(RuntimeError):
        pass

    def fault(step):
        if step == 2:
            raise Boom()

    t1 = _trainer(tmp_path, fault=fault, cfg=cfg)
    with pytest.raises(Boom):
        t1.run()
    t1.ckpt.wait()
    assert latest_step(str(tmp_path)) == 2
    t2 = _trainer(tmp_path, seed=1, cfg=cfg)   # other weights: overwritten
    assert t2.restore() and t2.step == 2
    out = t2.run()
    assert out["step"] == 3 and out["last_loss"] == want_out["last_loss"]
    for a, b in ((t2.params, want.params), (t2.opt_state, want.opt_state)):
        la, lb = flatten_with_names(a), flatten_with_names(b)
        assert [n for n, _ in la] == [n for n, _ in lb]
        for (n, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), n
    assert latest_step(str(tmp_path)) == 3
    # the reference's leaf names for {"params", "opt"}

    def ref_tree(key):
        params = ref_init_params(ref_cfg, key)
        return {"params": params, "opt": ref_adamw.AdamW().init(params)}
    ref_names = [n for n, _ in ref_ckpt._flatten_with_paths(
        jax.eval_shape(ref_tree, jax.random.PRNGKey(0)))]
    names = [leaf["name"] for leaf in _manifest(str(tmp_path), 3)["leaves"]]
    assert names == ref_names
    assert not _trainer(None, cfg=cfg).restore()


def test_launch_train_ckpt_dir_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "granite-3-2b", "--reduced", "--seq", "16", "--batch",
            "2", "--policy", "ff_reduce", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    assert train.main(args + ["--steps", "2"])["step"] == 2
    assert available_steps(str(tmp_path)) == [1, 2]   # every steps // 3
    out = train.main(args + ["--steps", "3", "--ckpt-every", "3"])
    assert out["step"] == 3
    assert "[trainer] resumed from step 2" in capsys.readouterr().out
    assert available_steps(str(tmp_path)) == [1, 2, 3]


# --------------------------------------------------------------------------
# launch/serve.py
# --------------------------------------------------------------------------

SERVE = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
         "--batch", "3", "--prompt-len", "16", "--max-new", "4"]


def test_launch_serve_engine_snapshot_and_resume(tmp_path):
    from repro_torch.launch import serve
    plain = serve.main(SERVE)
    assert plain["tokens"].shape == (3, 4)
    assert np.isfinite(plain["logprobs"]).all()
    res = serve.main(SERVE + ["--engine"])
    assert sorted(res) == [0, 1, 2]
    assert all(r.status == "OK" and len(r.tokens) == 4
               for r in res.values())
    snap = str(tmp_path / "snap")
    got = serve.main(SERVE + ["--engine", "--kv-mode", "ff_bf16",
                              "--snapshot-dir", snap, "--snapshot-every",
                              "2"])
    assert os.path.getsize(os.path.join(snap, "wal.jsonl")) == 0
    assert available_steps(snap)
    back = serve.main(SERVE + ["--engine", "--kv-mode", "ff_bf16",
                               "--snapshot-dir", snap, "--resume"])
    for uid, r in got.items():
        assert back[uid].status == r.status
        assert np.array_equal(back[uid].tokens, r.tokens)
        assert np.array_equal(back[uid].logprobs_ff, r.logprobs_ff)


@pytest.mark.parametrize("flag,item", [
    (["--mesh"], "item 8"), (["--metrics-port", "9100"], "item 5"),
    (["--metrics-json", "m.json"], "item 5"),
    (["--trace-out", "t.json"], "item 5")])
def test_launch_serve_refuses_unported_flags(flag, item, capsys):
    """``--mesh`` waits for item 8 and stops naming it; the obs flags
    (item 5) are ported and, as in the reference, stop only without
    ``--engine`` (their runs: ``tests/test_torch_launch_obs.py``)."""
    from repro_torch.launch import serve
    ported = item == "item 5"
    with pytest.raises(SystemExit) as e:
        serve.main(SERVE + ([] if ported else ["--engine"]) + flag)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err
    assert ("require --engine" if ported else item) in err


def test_launch_serve_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-3-2b", "--reduced", "--engine"])
    with pytest.raises(SystemExit):
        serve.main(SERVE + ["--resume"])        # --resume needs a dir
