"""``repro_torch.chaos`` — deterministic fault injection for the port's
serving tier (counterpart of ``repro.chaos``).

The contract under test: with the guard on, the engine ends every
submitted request with a documented status (``OK`` / ``TIMEOUT`` /
``REJECTED`` / ``DEGRADED`` / ``FAILED``, no unhandled exception) and
never returns wrong tokens silently: an ``OK`` request is token for token
the healthy run, a ``DEGRADED`` one the fast-tier ``greedy_generate``,
and what the guard could not save is withheld as ``FAILED``.

Faults (all on :class:`~repro_torch.chaos.inject.ChaosMonkey`, seed
driven, the reference's draws):

  * ``corrupt_kv_limbs``: NaN / Inf / subnormal-lo poison in live paged
    K/V positions;
  * ``flip_block_table``: out-of-range, duplicated or free-list page ids;
  * ``exhaust_pool``: free pages stolen for a scope (allocation failure,
    preemption pressure);
  * ``mangle_tune_json``: truncated, garbage or wrongly typed tuning
    sidecars;
  * deadlines are plain data: ``Request(deadline_steps=0)``;
  * the restart tier: ``tear_checkpoint_tmp`` (a crash mid-save),
    ``flip_checkpoint_bit`` (bit-rot the CRC must catch) and
    ``stale_manifest`` (a foreign or downgraded writer) against the
    engine's snapshot store.

``python -m repro_torch.chaos`` runs the guarded-serving smoke over every
fault class; ``python -m repro_torch.chaos.restart`` SIGKILLs a serving
child process mid-decode and holds the warm restart
(:func:`repro_torch.serve.resume_engine`) to the uninterrupted run.  Both
run on the CUDA card unless given ``--device cpu``.
"""

from repro_torch.chaos.inject import ChaosMonkey  # noqa: F401
