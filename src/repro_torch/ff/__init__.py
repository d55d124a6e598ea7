"""``repro_torch.ff``: the port's public FF namespace (counterpart of
``repro.ff``).

    import repro_torch.ff as ff
    with ff.policy("ff_reduce", attention="pallas"):
        ...                                  # models read the scope
    ff.mean_sq(x)                            # fused CUDA kernel on the card
    s = ff.sum(x)                            # compensated sum -> FF
    s = ff.sum(x, axis=-1, impl="pallas_rowsum")   # the row-sum kernel
    m = ff.mean(x, axis=-1)                  # compensated mean -> FF
    d = ff.dot(a, b)                         # TwoProd + Dot3 cascade -> FF
    z = ff.div(a, b, impl="pallas")          # Div22, one CUDA kernel
    y = ff.silu(x)                           # FF elementary function
    ff.tune("silu", shapes=[(512, 8192)])    # time the impls, cache winners
    ff.adamw_update(g, m, v, w, wlo, lr, b1, b2, bc1, bc2, eps=1e-8,
                    wd=0.1)                  # one kernel, in place
    p = ff.softmax(x)                        # one kernel (rows <= 16384)
    mu, var = ff.norm_stats(x)               # one kernel, x read once
    axpy = ff.fused(lambda a, x, y: a * x + y)
    z = axpy(1.618, x, y)                    # one Program kernel
    C = ff.matmul(A, B)                      # hybrid CUDA kernel -> FF
    with ff.policy("ff_full", matmul="ozaki"):
        C = ff.matmul(A, B)

    with ff.guard(mode="degrade") as g:      # count, repair, degrade
        y = ff.log(x)
    ff.guard_probe(x, impl="pallas")         # GuardCounts, one CUDA kernel

Every op the reference differentiates carries its reference gradient
(:mod:`repro_torch.ff.autodiff`): ``add``, ``sub``, ``mul``, ``div``,
``sqrt``, ``two_sum``, ``two_prod``, ``sum``, ``mean``, ``dot``,
``logsumexp``, ``softmax``, ``mean_sq``, ``norm_stats``, ``matmul``,
``attention`` (``kv_len`` too) and the ten ``ff.math`` functions.
``adamw_update`` (an optimizer step) and ``fused`` carry none; ``fused``
raises on an input that requires a gradient.
"""

from repro_torch.core.ff import FF, normalize, tree_from_f32, tree_to_f32
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff import fusion, math, tuning
from repro_torch.ff.dispatch import (adamw_update, add, attention, div,
                                     dot, impls, logsumexp, matmul, mean,
                                     mean_sq, mul, norm_stats, ops,
                                     resolve_name, resolve_opts, softmax,
                                     sqrt, sub, sum, two_prod, two_sum)
from repro_torch.ff.fusion import fused
from repro_torch.ff.guard import (FFError, FFGuardWarning, FFNonFiniteError,
                                  FFNormalizationError, FFResourceError,
                                  FFTuneWarning, GuardCounts, assert_healthy,
                                  current_guard, guard, guard_probe,
                                  health_mask)
from repro_torch.ff.math import (erf, exp, expm1, gelu, log, log1p, pow,
                                 sigmoid, silu, tanh)
from repro_torch.ff.scope import current_policy, policy, resolve_policy, use
from repro_torch.ff.tuning import tune


def to_f32(x):
    """An FF value rounded to f32 (its hi limb); a tensor passes through."""
    return x.to_f32() if isinstance(x, FF) else x


__all__ = ["FF", "FFError", "FFGuardWarning", "FFNonFiniteError",
           "FFNormalizationError", "FFResourceError", "FFTuneWarning",
           "GuardCounts", "PrecisionPolicy", "adamw_update", "add",
           "assert_healthy", "attention", "current_guard", "current_policy",
           "div", "dot", "erf", "exp", "expm1", "fused", "fusion", "gelu",
           "guard", "guard_probe", "health_mask", "impls", "log",
           "log1p", "logsumexp", "math", "matmul", "mean", "mean_sq", "mul",
           "normalize", "norm_stats", "ops", "policy", "pow", "resolve_name",
           "resolve_opts", "resolve_policy", "sigmoid", "silu", "softmax",
           "sqrt", "sub", "sum", "tanh", "to_f32", "tree_from_f32",
           "tree_to_f32", "tune", "tuning", "two_prod", "two_sum", "use"]
