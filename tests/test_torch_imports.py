"""The port stands alone and never falls back silently.

  * importing every ``repro_torch`` module loads neither JAX nor ``repro``;
  * entry points default to the CUDA card and raise without one;
  * kernel wrappers take their plain version only for CPU tensors, and the
    dispatch picks the kernel impl by default for CUDA tensors;
  * ``chip_smoke.py`` exits non-zero with no result off the card and
    outside a checkout.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.ff import dispatch
from repro_torch.kernels import build, ff_attention, ff_fused
from repro_torch.models.config import ModelConfig
from repro_torch.serve import ServeEngine, resume_engine

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
new = {"repro_torch.core.ffmatmul", "repro_torch.kernels.ff_matmul",
       "repro_torch.kernels.ref", "repro_torch.benchmarks.table_ffmatmul",
       "repro_torch.ff.fusion", "repro_torch.ff.tuning",
       "repro_torch.kernels.ff_elementwise",
       "repro_torch.benchmarks.table_elementwise",
       "repro_torch.kernels.ff_reduce", "repro_torch.kernels.ff_math",
       "repro_torch.ff.math", "repro_torch.ff.guard",
       "repro_torch.kernels.ff_guard", "repro_torch.checkpoint",
       "repro_torch.checkpoint.checkpoint", "repro_torch.serve.journal",
       "repro_torch.launch.serve", "repro_torch.obs",
       "repro_torch.obs.registry", "repro_torch.obs.trace",
       "repro_torch.obs.profiling", "repro_torch.obs.__main__",
       "repro_torch.chaos", "repro_torch.chaos.inject",
       "repro_torch.chaos.__main__", "repro_torch.chaos.restart",
       "repro_torch.models.moe", "repro_torch.models.mla",
       "repro_torch.configs.olmoe_1b_7b",
       "repro_torch.configs.deepseek_v2_236b",
       "repro_torch.configs.internvl2_1b", "repro_torch.configs.minitron_4b",
       "repro_torch.configs.phi3_medium_14b",
       "repro_torch.configs.llama3_405b"}
assert new <= set(names), sorted(new - set(names))
print(len(names), bad)
"""


def test_import_every_module_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


_IMPORT_OBS = """
import sys
import repro_torch.obs
import repro_torch.obs.__main__
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             or m.startswith("repro_torch.ff"))
print(bad)
"""


def test_obs_imports_without_ff():
    """``repro_torch.obs`` never imports ``repro_torch.ff`` (dispatch,
    guard and tuning import it, lazily) nor JAX or the reference."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_OBS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_new_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                        tmp_path):
    """The obs and chaos smokes and the restart chaos default to the card
    and raise without one."""
    from repro_torch.chaos import __main__ as chaos_main
    from repro_torch.chaos import restart
    from repro_torch.obs import __main__ as obs_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: obs_main.main([]), lambda: chaos_main.main([]),
                 lambda: restart.run_scenario(str(tmp_path)),
                 lambda: restart.main(["--modes", "bf16"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not os.listdir(tmp_path)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(name="t", num_layers=1, d_model=64, num_heads=2,
                      num_kv_heads=1, d_ff=64, vocab_size=32)
    params = {"final_norm": torch.ones(64)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resume_engine(params, cfg, "no-snapshot-here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_take_plain_version_only_on_cpu():
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((3, 300)).astype(np.float32))
    n0 = ff_fused.mean_sq.launches
    assert torch.equal(ff_fused.mean_sq(x), ff_fused.mean_sq_plain(x))
    q = torch.from_numpy(rng.standard_normal((1, 5, 2, 8))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 5, 1, 8))
                         .astype(np.float32))
    got = ff_attention.flash_attention_pallas(q, k, k, return_ff=True)
    want = ff_attention.flash_attention_ff(q, k, k, return_ff=True)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
    assert ff_fused.mean_sq.launches == n0        # nothing was launched
    meta = torch.empty((2, 8), device="meta")     # neither CPU nor CUDA
    with pytest.raises(RuntimeError, match="no kernel"):
        ff_fused.mean_sq(meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        ff_attention.flash_attention_pallas(
            torch.empty((1, 2, 2, 8), device="meta"),
            torch.empty((1, 2, 1, 8), device="meta"),
            torch.empty((1, 2, 1, 8), device="meta"))


def test_operator_and_math_wrappers_take_plain_version_only_on_cpu():
    """elementwise, ff_rowsum and math_elementwise take their plain
    versions for CPU tensors (no launch) and raise on any other non-CUDA
    device; the dispatch reaches them only by name or a tuned winner."""
    from repro_torch.kernels import ff_elementwise, ff_math, ff_reduce
    rng = np.random.default_rng(43)
    x = torch.from_numpy(rng.standard_normal((3, 130)).astype(np.float32))
    calls = [
        (ff_elementwise.elementwise, ff_elementwise.elementwise_plain,
         ("div22", x, x * 1e-8, x.abs() + 1, x * 0)),
        (ff_reduce.ff_rowsum, ff_reduce.ff_rowsum_plain, (x,)),
        (ff_math.math_elementwise, ff_math.math_elementwise_plain,
         ("erf", x, x * 1e-8)),
    ]
    for wrapper, plain, args in calls:
        n0 = wrapper.launches
        got, want = wrapper(*args), plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert wrapper.launches == n0
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with pytest.raises(RuntimeError, match="no kernel"):
            wrapper(*meta)
    for op in ("add", "mul", "div", "sqrt", "exp", "silu", "pow"):
        assert dispatch.resolve_name(op, device="cuda") == "jnp"
    assert dispatch.resolve_name("sum", device="cuda") == "blocked"
    assert dispatch.resolve_name("silu", "pallas", "cuda") == "pallas"
    assert dispatch.resolve_name("sum", "pallas_rowsum",
                                 "cuda") == "pallas_rowsum"


def test_dispatch_defaults_and_resolution_order():
    assert dispatch.resolve_name("mean_sq", device="cuda") == "fused"
    assert dispatch.resolve_name("mean_sq", device="cpu") == "jnp"
    assert dispatch.resolve_name("attention", device="cuda") == "fast"
    with repro_torch.ff.use(mean_sq="jnp"):
        assert dispatch.resolve_name("mean_sq", device="cuda") == "jnp"
        assert dispatch.resolve_name("mean_sq", "fused", "cuda") == "fused"
    assert dispatch.resolve_name("attention", "f64") == "f64"
    with pytest.raises(KeyError, match="available"):
        dispatch.resolve_name("attention", "ozaki")
    with repro_torch.ff.policy("ff_reduce", attention="pallas") as p:
        assert p.ff_reductions and p.attention == "pallas"
        assert repro_torch.ff.resolve_policy(None) is p


def test_matmul_benchmark_needs_cuda_unless_cpu_is_asked(monkeypatch,
                                                         capsys):
    from repro_torch.benchmarks import table_ffmatmul
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_ffmatmul.main(["--mn", "4", "--ks", "16"])
    rows = table_ffmatmul.main(["--mn", "4", "--ks", "16", "--reps", "1",
                                "--device", "cpu"])
    assert [r["path"] for r in rows] == [
        "naive", *table_ffmatmul.IMPLS, "dispatch_default"]
    assert rows[-1]["resolved_impl"] == "hybrid"
    assert all(r["device"] == "cpu" for r in rows)
    assert "dispatch_default" in capsys.readouterr().out


def test_elementwise_benchmark_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.benchmarks import table_elementwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table_elementwise.main(["--shapes", "2x8", "--chains", "axpy"])
    rows = table_elementwise.main(["--shapes", "2x8", "--chains", "axpy",
                                   "--reps", "1", "--rounds", "1",
                                   "--device", "cpu"])
    assert [(r["chain"], r["device"]) for r in rows] == [("axpy", "cpu")]


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises (no silent fallback) and writes
    nothing into the checkout."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")   # hide any card
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_training_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The launcher, the device self-check and the optimizer-state
    hand-over default to the card and raise without one."""
    from repro_torch.core import selfcheck
    from repro_torch.interop import opt_state_from_numpy
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "granite-3-2b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        selfcheck.check_eft_safe()
    state = (np.int32(0), {"w": np.zeros(3, np.float32)},
             {"w": np.zeros(3, np.float32)}, {"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opt_state_from_numpy(state)
    assert int(opt_state_from_numpy(state, device="cpu").count) == 0


def test_training_dispatch_defaults():
    """The training path's ops resolve to the reference's defaults, with
    the AdamW kernel the default on the card."""
    assert dispatch.resolve_name("sum", device="cuda") == "blocked"
    assert dispatch.resolve_name("add", device="cuda") == "jnp"
    assert dispatch.resolve_name("adamw_update", device="cuda") == "fused"
    assert dispatch.resolve_name("adamw_update", device="cpu") == "jnp"
    with repro_torch.ff.use(adamw_update="jnp"):
        assert dispatch.resolve_name("adamw_update", device="cuda") == "jnp"


def test_get_config_names_the_ported_architectures():
    from repro_torch.configs import PORTED, get_config
    assert get_config("granite-3-2b") is get_config("granite_3_2b")
    for name in PORTED:
        cfg = get_config(name)
        assert get_config(cfg.name) is cfg
        assert cfg.name.replace(".", "_").replace("-", "_") == name
    with pytest.raises(NotImplementedError, match="granite_3_2b"):
        get_config("no-such-model")
    # every family of the reference, the SSM, hybrid and encoder-decoder
    # ones among them
    assert {get_config(n).family for n in PORTED} == {
        "dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
    assert get_config("jamba-1.5-large-398b").family == "hybrid"
