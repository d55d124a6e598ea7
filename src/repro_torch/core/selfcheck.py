"""EFT-safety self-check on the target device (counterpart of
``repro.core.selfcheck``).

The EFTs need every f32 operation rounded once, as IEEE prescribes.  Three
device settings break that silently, and each gets a probe here:

  * **contraction**: ``s + a*b`` fused into one FMA changes ``fl(a*b)``
    against its other uses (the reference's hazard on XLA:CPU).  Eager
    PyTorch runs each op as its own kernel; the probe holds the device's
    TwoSum-of-a-product to numpy's float32, one rounding per op;
  * **TF32**: an f32 matrix product on the tensor cores' TF32 keeps ~10
    significand bits; the probe needs all 24;
  * **flush to zero**: a subnormal result flushed to 0 (the EFTs'
    exactness excludes the subnormal band, but a flushing device also
    breaks the reference's bound near it).

``check_eft_safe(device)`` returns the probes' verdicts;
``require_eft_safe`` warns (or raises, ``strict=True``) with the remedy.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device

_REMEDY = {
    "contraction": "mul+add is contracted into FMA: never use fused torch "
                   "ops (addcmul, addmm, lerp) in EFT code, and build CUDA "
                   "kernels with --fmad=false or __fadd_rn/__fmul_rn",
    "tf32": "f32 matrix products run in TF32: set torch.backends.cuda."
            "matmul.allow_tf32 = False (importing repro_torch does)",
    "ftz": "subnormal f32 results are flushed to zero on this device",
}


def _probe(s, a, b):
    """The reference's probe: TwoSum of ``s`` and the product ``a x b``."""
    p = a[:, None] * b[None, :]
    s2 = s + p
    bb = s2 - s
    return s2, (p - bb) + (s - (s2 - bb))


def check_eft_safe(device=None) -> Dict[str, bool]:
    """Run the probes on ``device`` (None: the CUDA card); each value is
    True when the device passes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    s = rng.standard_normal((8, 16)).astype(np.float32)
    a = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = _probe(s, a, b)
    got = _probe(*(torch.from_numpy(x).to(dev) for x in (s, a, b)))
    contraction = all(np.array_equal(g.cpu().numpy(), w)
                      for g, w in zip(got, want))

    # (1 + 2^-20) I @ ones: exact in f32, 1.0 once the factor is TF32
    n = 64
    eye = torch.eye(n, dtype=torch.float32, device=dev) * (1.0 + 2.0 ** -20)
    prod = eye @ torch.ones((n, n), dtype=torch.float32, device=dev)
    tf32 = bool((prod == 1.0 + 2.0 ** -20).all())

    tiny = torch.tensor([2.0 ** -126], dtype=torch.float32, device=dev)
    ftz = float((tiny * 0.5)[0]) == 2.0 ** -127

    return {"contraction": contraction, "tf32": tf32, "ftz": ftz}


def require_eft_safe(strict: bool = False, device=None) -> bool:
    """True when every probe passes; otherwise warns with the remedies
    (raises with ``strict=True``)."""
    checks = check_eft_safe(device)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        msg = ("float-float EFTs are unsafe on this device: "
               + "; ".join(_REMEDY[k] for k in bad))
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return not bad
