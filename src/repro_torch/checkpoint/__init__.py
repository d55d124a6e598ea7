"""Atomic, async, checksummed checkpoints (counterpart of
``repro.checkpoint``; the same files).

See :mod:`repro_torch.checkpoint.checkpoint` for the format (per-step
directories of ``.npy`` leaves and a CRC32'd, schema-versioned manifest)
and the verified-load fallback ladder.
"""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    FORMAT, AsyncCheckpointer, CheckpointCorruptionWarning, CheckpointError,
    available_steps, latest_step, load, load_dict, save,
)
