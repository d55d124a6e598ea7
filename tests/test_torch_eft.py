"""Parity of the port's EFT / FF core with the reference, bit for bit.

Same inputs (normal-range, made with numpy from a seed) through
``repro.core`` and ``repro_torch.core``: the EFTs, the FF operators,
``ff_sum_blocked`` and ``exp22``/``log22`` must return identical bits.
Inputs stay normal: XLA:CPU flushes subnormals and torch does not.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compensated as ref_comp
from repro.core import ff as ref_ff
from repro.core import ffmath as ref_math
from repro.core import transforms as ref_T
from repro_torch.core import compensated as port_comp
from repro_torch.core import ff as port_ff
from repro_torch.core import ffmath as port_math
from repro_torch.core import transforms as port_T

N = 20000


def _vec(rng, n, lo=-5, hi=5):
    """Well-scaled f32 vector (no subnormals), as conftest.f32_vec."""
    return (rng.standard_normal(n)
            * 10.0 ** rng.uniform(lo, hi, n)).astype(np.float32)


def _ffpair(rng, n, lo=-5, hi=5):
    """Normalized FF pairs: the f32 split of random f64 values."""
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(lo, hi, n)
    h = x.astype(np.float32)
    return h, (x - h.astype(np.float64)).astype(np.float32)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.asarray(a, np.float32).view(np.uint32)


def _same(ref, port):
    ref = ref if isinstance(ref, tuple) else (ref,)
    port = port if isinstance(port, tuple) else (port,)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        rb, pb = _bits(r), _bits(p)
        assert np.array_equal(rb, pb), \
            f"{int((rb != pb).sum())} of {rb.size} results differ"


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "split",
                                  "two_prod", "two_diff"])
def test_eft_bitwise(name):
    rng = np.random.default_rng(11)
    a, b = _vec(rng, N), _vec(rng, N)
    if name == "fast_two_sum":          # its precondition |a| >= |b|
        a, b = np.where(np.abs(a) >= np.abs(b), a, b), \
            np.where(np.abs(a) >= np.abs(b), b, a)
    ref_fn, port_fn = getattr(ref_T, name), getattr(port_T, name)
    if name == "split":
        _same(ref_fn(jnp.asarray(a)), port_fn(torch.from_numpy(a)))
    else:
        _same(ref_fn(jnp.asarray(a), jnp.asarray(b)),
              port_fn(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("name", ["add22", "add22_accurate", "add212",
                                  "mul22", "mul212", "div22"])
def test_ff_ops_bitwise(name):
    rng = np.random.default_rng(12)
    ah, al = _ffpair(rng, N)
    bh, bl = _ffpair(rng, N)
    ra = ref_ff.FF(jnp.asarray(ah), jnp.asarray(al))
    pa = port_ff.FF(torch.from_numpy(ah), torch.from_numpy(al))
    if name in ("add212", "mul212"):
        rb, pb = jnp.asarray(bh), torch.from_numpy(bh)
    else:
        rb = ref_ff.FF(jnp.asarray(bh), jnp.asarray(bl))
        pb = port_ff.FF(torch.from_numpy(bh), torch.from_numpy(bl))
    r = getattr(ref_ff, name)(ra, rb)
    p = getattr(port_ff, name)(pa, pb)
    _same((r.hi, r.lo), (p.hi, p.lo))
    assert np.array_equal(_bits(port_ff.to_f32(p)), _bits(r.to_f32()))


@pytest.mark.parametrize("shape,axis,block", [((4, 2048), -1, 128),
                                              ((3, 1000), -1, 128),
                                              ((700, 5), 0, 256)])
def test_ff_sum_blocked_bitwise(shape, axis, block):
    rng = np.random.default_rng(13)
    x = _vec(rng, int(np.prod(shape)), -3, 3).reshape(shape)
    r = ref_comp.ff_sum_blocked(jnp.asarray(x), axis=axis, block=block)
    p = port_comp.ff_sum_blocked(torch.from_numpy(x), axis=axis, block=block)
    _same((r.hi, r.lo), (p.hi, p.lo))


def test_exp22_bitwise():
    """FF exp on FF arguments in [-60, 60] (beyond, the lo limb turns
    subnormal and the flush-to-zero difference decides the bits)."""
    rng = np.random.default_rng(14)
    x = rng.uniform(-60.0, 60.0, N)
    xh = x.astype(np.float32)
    xl = ((x - xh) * rng.uniform(0, 1, N)).astype(np.float32)
    r = ref_math.exp22(jnp.asarray(xh), jnp.asarray(xl))
    p = port_math.exp22(torch.from_numpy(xh), torch.from_numpy(xl))
    _same(r, p)


def test_log22_bitwise():
    rng = np.random.default_rng(15)
    xh, xl = _ffpair(rng, N, -20, 20)
    xh, xl = np.abs(xh), np.where(xh < 0, -xl, xl)
    r = ref_math.log22(jnp.asarray(xh), jnp.asarray(xl))
    p = port_math.log22(torch.from_numpy(xh), torch.from_numpy(xl))
    _same(r, p)


def test_cuda_exp22_constants_match_port():
    """The kernels' exp22 constants (hex floats in csrc/ff_eft.cuh) are the
    f32 roundings of the port's Python constants."""
    src = (Path(port_math.__file__).parents[1] / "csrc" / "ff_eft.cuh"
           ).read_text()
    body = src[src.index("ff2 exp22("):]

    def floats(name):
        m = re.search(name + r"(?:\[6\])? = \{?([^;}]*)\}?;", body)
        return [float.fromhex(t.strip().rstrip("f"))
                for t in m.group(1).split(",")]

    f32 = lambda xs: [float(np.float32(x)) for x in xs]
    assert floats("INV_LN2") == f32([port_math._INV_LN2])
    assert floats("L1") == f32([port_math._EXP_L1])
    assert floats("L2") == f32([port_math._EXP_L2])
    assert floats("L3") == f32([port_math._EXP_L3])
    assert floats("W_F32") == f32(port_math._EXP_W_F32)
    assert floats("W_H") == f32([c[0] for c in port_math._EXP_W_FF])
    assert floats("W_L") == f32([c[1] for c in port_math._EXP_W_FF])
