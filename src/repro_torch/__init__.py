"""repro_torch: the PyTorch/CUDA port of ``repro`` (float-float operators).

It imports ``torch`` and nothing of ``repro`` or JAX.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.

Matrix products here must be IEEE f32 where they are f32: the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` when it is imported (both are
process-wide PyTorch settings; TF32 keeps ~10 significand bits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises when there is none (the port never falls back to the CPU
    silently: pass ``device="cpu"`` to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
