"""The Dot2 FF matmul's plain version (``kernels.ff_matmul.
ff_matmul_dot2_plain``, the arithmetic of ``csrc/ff_matmul_dot2.cu``)
against the reference's kernel on the CPU.

  * Bit for bit the reference's ``ff_matmul_dot2`` in interpret mode at
    every slab width the kernel is compiled for (``dot2_vec`` gives
    vec = K for K = 1..7, 1 for K = 11, 3 for 9, 7 for 14, 8 for 300),
    with M and N off the kernel's 64 x 64 block tile (1, 63, 65, 257 x 1,
    5, 129), on cancellation-heavy operands: exponents spread over
    2^+-30 (products and their errors stay normal, so XLA:CPU's flush of
    subnormals decides nothing) and shared by pairs of K entries, A's
    signs alternating along K, and signed zeros.  Transposed views give
    the same bits, and the result stays within the Dot2 bound of float64
    (u |E| + 2 K^2 u^2 S).
  * ``dot2_vec`` against the reference's slab rule.

The CUDA kernel runs only on the card: ``chip_smoke.py`` holds it bit for
bit to this plain version there on the same cases (with exponents over
2^+-40).  Inputs come from local numpy generators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ff_matmul as ref_kernels
from repro_torch.kernels import ff_matmul as km

U = 2.0 ** -24
# K: every slab width; (M, N): off the block tile
SLAB_K = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 11: 1, 9: 3, 14: 7,
          300: 8}
M_EDGES, N_EDGES = (1, 63, 65, 257), (1, 5, 129)
MN = [(m, n) for m in M_EDGES for n in N_EDGES]
CASES = ([(MN[i % len(MN)][0], k, MN[i % len(MN)][1])
          for i, k in enumerate(SLAB_K)]
         + [(m, 300, n) for m, n in MN] + [(m, 14, n) for m, n in MN])


def _operands(mkn, seed):
    """A (M, K), B (K, N): |N(0,1)| + 0.5 times 2^e with e uniform in
    [-30, 30] and shared by each pair of K entries (2i, 2i + 1), A's sign
    alternating along K and B's at random (so pairs of products of like
    size cancel), and about 1 in 16 entries a zero of either sign."""
    M, K, N = mkn
    rng = np.random.default_rng(seed)

    def one(shape, kaxis):
        e = rng.integers(-30, 31, shape)
        e = np.take(e, (np.arange(shape[kaxis]) // 2) * 2, axis=kaxis)
        x = (np.abs(rng.standard_normal(shape)) + 0.5) * np.exp2(e)
        if kaxis == 1:
            x = x * (1 - 2 * (np.arange(shape[1]) % 2))[None, :]
        else:
            x = x * np.where(rng.random(shape) < 0.5, -1.0, 1.0)
        zero = rng.integers(0, 16, shape) == 0
        x[zero] = np.where(rng.random(int(zero.sum())) < 0.5, -0.0, 0.0)
        return x.astype(np.float32)
    return one((M, K), 1), one((K, N), 0)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("K,vec", sorted(SLAB_K.items()))
def test_dot2_vec_is_the_reference_slab(K, vec):
    """The reference's rule: vec = 8 lowered to the largest divisor of
    min(bk, K), bk = 128."""
    assert km.dot2_vec(K, 128, 8) == vec
    bk = min(128, K)
    assert vec == max(v for v in range(1, 9) if bk % v == 0)


@pytest.mark.parametrize("mkn", CASES, ids=[f"{m}x{k}x{n}"
                                            for m, k, n in CASES])
def test_dot2_plain_bitwise_reference_on_edges(mkn):
    M, K, N = mkn
    A, B = _operands(mkn, seed=K * 1000 + M * 10 + N)
    want = ref_kernels.ff_matmul_dot2(jnp.asarray(A), jnp.asarray(B),
                                      interpret=True)
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    got = km.ff_matmul_dot2(a, b)                      # CPU: plain
    assert km.dot2_vec(K, 128, 8) == SLAB_K[K]
    for w, g in zip(want, got):
        assert np.array_equal(_bits(w), _bits(g.numpy()))
    # transposed views, as the backward pass hands them over
    gt = km.ff_matmul_dot2(a.T.contiguous().T, b.T.contiguous().T)
    for g, t in zip(got, gt):
        assert np.array_equal(_bits(g.numpy()), _bits(t.numpy()))
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    E, S = A64 @ B64, np.abs(A64) @ np.abs(B64)
    v = got[0].double().numpy() + got[1].double().numpy()
    assert np.all(np.abs(v - E) <= U * np.abs(E) + 2 * K * K * U * U * S)
