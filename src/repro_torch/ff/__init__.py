"""``repro_torch.ff``: the port's public FF namespace (counterpart of
``repro.ff``, with the ops of the serving and training paths).

    import repro_torch.ff as ff
    with ff.policy("ff_reduce", attention="pallas"):
        ...                                  # models read the scope
    ff.mean_sq(x)                            # fused CUDA kernel on the card
    s = ff.sum(x)                            # compensated sum -> FF
    ff.adamw_update(g, m, v, w, wlo, lr, b1, b2, bc1, bc2, eps=1e-8,
                    wd=0.1)                  # one kernel, in place
    p = ff.softmax(x)                        # one kernel (rows <= 16384)
    mu, var = ff.norm_stats(x)               # one kernel, x read once
    axpy = ff.fused(lambda a, x, y: a * x + y)
    z = axpy(1.618, x, y)                    # one Program kernel
    C = ff.matmul(A, B)                      # hybrid CUDA kernel -> FF
    C = ff.matmul(A, B, impl="dot2")         # paper-faithful
    with ff.policy("ff_full", matmul="ozaki"):
        C = ff.matmul(A, B)

``sum``, ``logsumexp``, ``mean_sq``, ``matmul`` and ``attention`` carry
their reference gradients (:mod:`repro_torch.ff.autodiff`); ``softmax``
and ``norm_stats`` are forward only, ``add``, ``mul`` and ``fused`` have
no gradient.
"""

from repro_torch.core.ff import FF
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff import fusion
from repro_torch.ff.dispatch import (adamw_update, add, attention, impls,
                                     logsumexp, matmul, mean_sq, mul,
                                     norm_stats, ops, resolve_name, softmax,
                                     sum)
from repro_torch.ff.fusion import fused
from repro_torch.ff.scope import current_policy, policy, resolve_policy, use

__all__ = ["FF", "PrecisionPolicy", "adamw_update", "add", "attention",
           "current_policy", "fused", "fusion", "impls", "logsumexp",
           "matmul", "mean_sq", "mul", "norm_stats", "ops", "policy",
           "resolve_name", "resolve_policy", "softmax", "sum", "use"]
