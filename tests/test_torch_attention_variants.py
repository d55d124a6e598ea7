"""``benchmarks/attention_variants.py``'s records, on the CPU.

Each variant's text edits apply once to a copy of ``csrc/`` and change it;
the shipped sources carry none of them; the plan variants fix the tile
configuration or the heads a block and leave the grid covering every row;
the labels and the ``-Xptxas -v`` parser read the kernel's instances; the
cases and the float64 oracle agree with the test suite's numpy oracle on a
small input (the oracle with ``q_offset``, which ``chip_smoke.py`` uses).
The variants themselves build and run only on the card.
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import attention_variants as av
from repro_torch.kernels import build
from repro_torch.kernels import ff_attention as fa


@pytest.mark.parametrize("name", sorted(av.VARIANTS))
def test_variant_edits_apply_once_to_a_copy(name, tmp_path):
    """Each edit occurs once in the shipped source, and the edited copy
    differs from it by that edit alone."""
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC, d)
    var = av.VARIANTS[name]
    av.apply_edits(d, var.edits, name)
    for fname, old, new in var.edits:
        shipped = (build.CSRC / fname).read_text()
        assert shipped.count(old) == 1 and old != new
        assert new not in shipped
        assert (d / fname).read_text() == shipped.replace(old, new)
    untouched = {f for f, _o, _n in var.edits}
    for p in build.CSRC.iterdir():
        if p.suffix in (".cu", ".cuh") and p.name not in untouched:
            assert (d / p.name).read_text() == p.read_text()
    assert bool(var.edits) or var.config is not None \
        or var.heads is not None or name == "shipped"


def test_edits_refuse_a_missing_text(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC, d)
    with pytest.raises(RuntimeError):
        av.apply_edits(d, ((av.SOURCE, "no such text", "x"),), "bad")


def test_config_edit_reads_the_shipped_configurations():
    for name in ("Big", "Small"):
        ((fname, old, new),) = av.config_edit(name, 7)
        assert fname == av.SOURCE and old.startswith(f"using {name} = ")
        assert new.endswith(", 7>;")
    with pytest.raises(RuntimeError):
        av.config_edit("Mid", 1)


@pytest.mark.parametrize("name", sorted(
    n for n, v in av.VARIANTS.items() if v.config is not None
    or v.heads is not None))
def test_plan_variants_cover_the_rows(name):
    var = av.VARIANTS[name]
    plan_of = av.forced_plan(var.config, var.heads)
    for B, Sq, H, KV in ((1, 64, 32, 8), (4, 128, 32, 8), (2, 1024, 32, 8),
                         (1, 37, 4, 2), (1, 70, 6, 2)):
        p = plan_of(B, Sq, H, KV)
        own = fa.attention_plan(B, Sq, H, KV)
        assert p.config == (own.config if var.config is None
                            else var.config)
        assert p.heads == (own.heads if var.heads is None else var.heads)
        assert (H // KV) % p.heads == 0
        assert p.heads * p.positions == fa.CONFIGS[p.config][0]
        assert p.grid == (B * H // p.heads, -(-Sq // p.positions))


def test_entry_signature_matches_the_wrapper():
    assert len(av.entry_signature(build.CSRC)) == len(fa._ARGTYPES)


def test_instance_labels_and_ptxas_info():
    big = ("_ZN12_GLOBAL__N_119ff_attention_kernelINS_6ConfigILi64ELi4ELi4E"
           "Li1EEE13__nv_bfloat16EEvPKT0_S6_S6_PfS7_iiiiiiifii")
    small = ("_ZN12_GLOBAL__N_119ff_attention_kernelINS_6ConfigILi16ELi2ELi2"
             "ELi2EEEfEEvPKT0_S5_S5_PfS6_iiiiiiifii")
    assert av.instance_label(big) == "Config<64,4,4,1> bf16"
    assert av.instance_label(small) == "Config<16,2,2,2> f32"
    assert av.instance_label("_Z3fooPf") is None
    log = (f"ptxas info    : Compiling entry function '{big}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 231 registers\n"
           f"ptxas info    : Compiling entry function '{small}' for "
           "'sm_90a'\n    8 bytes stack frame, 4 bytes spill stores, 4 "
           "bytes spill loads\nptxas info    : Used 94 registers\n")
    assert av.ptxas_info(log) == {
        "Config<64,4,4,1> bf16": {"registers": 231, "spill_bytes": 0,
                                  "stack_bytes": 0},
        "Config<16,2,2,2> f32": {"registers": 94, "spill_bytes": 8,
                                 "stack_bytes": 8}}


def test_cases_cover_the_design_edges():
    cases = {c.what: c for c in av.CASES}
    assert len(cases) == len(av.CASES)
    for what, (B, S, H, KV, hd) in av.SHAPES.items():
        c = cases[what]
        assert (c.B, c.Sq, c.Skv, c.H, c.KV, c.hd, c.causal, c.bf16) == (
            B, S, S, H, KV, hd, True, True)
    assert any(c.q_offset > 0 and c.Sq < c.Skv for c in av.CASES)
    assert {c.H // c.KV for c in av.CASES} >= {1, 3, 4, 8}
    assert {c.bf16 for c in av.CASES} == {True, False}
    assert any(c.spread > 1 and not c.bf16 for c in av.CASES)
    assert any(c.Sq % 4 and c.Skv % 64 for c in av.CASES)


@pytest.mark.parametrize("causal, q_offset", [(True, 0), (True, 9),
                                              (False, 0)])
def test_oracle_matches_numpy(causal, q_offset):
    """The benchmark's (and chip_smoke's) float64 oracle on the CPU against
    a numpy softmax with the key <= q_offset + row mask."""
    rng = np.random.default_rng(254)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 14, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 14, 2, 16)).astype(np.float32)
    got = av.oracle(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal, q_offset).numpy()
    sc = float(np.float32(1 / 4))
    want = np.zeros_like(got)
    for b in range(2):
        for h in range(4):
            s = q[b, :, h].astype(np.float64) @ k[b, :, h // 2].T * sc
            if causal:
                s[np.arange(14)[None, :] > q_offset
                  + np.arange(5)[:, None]] = -np.inf
            p = np.exp(s - s.max(-1, keepdims=True))
            want[b, :, h] = (p / p.sum(-1, keepdims=True)) @ v[b, :, h // 2]
    assert np.allclose(got, want, rtol=1e-13, atol=1e-13)
    assert av.rel_err(torch.from_numpy(want), torch.from_numpy(want)) == 0


def test_plain_version_on_a_case_within_the_contract():
    """references() holds the plain version to the oracle (here on the
    CPU, on the smallest cases)."""
    g = torch.Generator().manual_seed(3)
    small = [c for c in av.CASES if c.B * c.Sq * c.Skv * c.H <= 40000]
    assert small
    for case, q, k, v, want, plain in av.references(
            small, g, device="cpu"):
        assert av.rel_err(plain, want) <= av.TOL
        assert plain.shape == want.shape


@pytest.mark.parametrize("causal, q_offset", [(False, 0), (True, 0),
                                              (True, 37)])
def test_plain_rows_do_not_depend_on_block_q(causal, q_offset):
    """``references`` runs the plain version at PLAIN_BLOCK_Q rows a
    block on its widest cases: each row's bits are those of the default
    tiling."""
    assert [c.what for c in av.CASES if c.Sq * c.Skv
            > av.PLAIN_WIDE_PAIRS] == ["whisper encoder, non-causal"]
    g = torch.Generator().manual_seed(9)
    q = torch.randn((1, 40, 1, 16), generator=g)
    k = torch.randn((1, 64, 1, 16), generator=g)
    v = torch.randn((1, 64, 1, 16), generator=g)
    want = fa.flash_attention_ff(q, k, v, causal=causal, q_offset=q_offset,
                                 return_ff=True)
    got = fa.flash_attention_ff(q, k, v, causal=causal, q_offset=q_offset,
                                block_q=av.PLAIN_BLOCK_Q, return_ff=True)
    assert torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)
