"""``repro_torch.ff``: the port's public FF namespace (counterpart of
``repro.ff``, with the ops of the serving path).

    import repro_torch.ff as ff
    with ff.policy("ff_reduce", attention="pallas"):
        ...                                  # models read the scope
    ff.mean_sq(x)                            # fused CUDA kernel on the card
"""

from repro_torch.core.ff import FF
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.ff.dispatch import (attention, impls, logsumexp, mean_sq,
                                     ops, resolve_name)
from repro_torch.ff.scope import current_policy, policy, resolve_policy, use

__all__ = ["FF", "PrecisionPolicy", "attention", "current_policy", "impls",
           "logsumexp", "mean_sq", "ops", "policy", "resolve_name",
           "resolve_policy", "use"]
