"""Seed-driven fault injectors for the paged FF serving stack (counterpart
of ``repro.chaos.inject``).

Every injector draws from one ``numpy`` generator seeded at construction,
so a chaos scenario is a pure function of ``(seed, call sequence)``:
rerunning a failing test replays the same poison in the same limb.  The
draws are the reference's, one for one (the same ``rng.integers`` calls
with the same bounds in the same order), so one seed poisons the same
``(layer, position, head, dim)``, flips the same block-table entry to
the same page and writes the same bytes in both packages.  Injectors
mutate real engine state (the torch KV planes in place, on the engine's
device; the numpy block table; files on disk); nothing is mocked, so the
recovery paths exercised are the production ones.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.serve.paged_kv import PagedKVCache

#: poison values per corruption kind; "denormal_lo" is the flush-to-zero
#: hazard (a legal-magnitude subnormal), not an invariant violation
_POISON = {"nan": float("nan"), "inf": float("inf"), "denormal_lo": 2.0 ** -130}


class ChaosMonkey:
    """Deterministic fault injector (one ``numpy`` RNG, seeded once)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    # -- numeric poison ----------------------------------------------------

    def corrupt_kv_limbs(self, kv: PagedKVCache, slot: int, *,
                         kind: str = "nan", n: int = 1,
                         base: Optional[str] = None,
                         limb: str = "lo") -> List[Tuple[int, int, int, int]]:
        """Write ``kind`` poison into ``n`` live cached positions of
        ``slot`` (positions below ``seq_lens[slot]``, the ones decode
        reads; stale page contents are legal scratch).  In ``ff_bf16``
        mode the poison lands in the ``limb`` plane ("hi" | "lo"),
        elsewhere in the single k/v plane; each write is in place, on the
        cache's device.  Returns the poisoned ``(layer, position, head,
        dim)`` coordinates."""
        if kind not in _POISON:
            raise ValueError(f"kind {kind!r}: choose from {tuple(_POISON)}")
        live = int(kv.seq_lens[slot])
        if live <= 0:
            raise ValueError(f"slot {slot} holds no live sequence")
        ps = kv.page_size
        coords = []
        for _ in range(n):
            b = base or ("k", "v")[self.rng.integers(2)]
            plane = f"{b}_{limb}" if kv.kv_mode == "ff_bf16" else b
            layer = int(self.rng.integers(kv.num_layers))
            pos = int(self.rng.integers(live))
            head = int(self.rng.integers(kv.num_kv_heads))
            dim = int(self.rng.integers(kv.head_dim))
            page = int(kv.block_table[slot, pos // ps])
            kv.planes[plane][layer, page, pos % ps, head, dim] = \
                _POISON[kind]
            coords.append((layer, pos, head, dim))
        return coords

    # -- paging metadata corruption ----------------------------------------

    def flip_block_table(self, kv: PagedKVCache, slot: int, *,
                         mode: str = "oob") -> str:
        """Corrupt one live block-table entry of ``slot``: ``"oob"`` (a
        page id past the pool), ``"dup"`` (another live slot's page: both
        rows now share storage) or ``"free"`` (a page on the free list:
        decode and a future allocation now race).  Returns a description
        of the flip."""
        live = kv.pages_for(int(kv.seq_lens[slot]))
        if live <= 0:
            raise ValueError(f"slot {slot} holds no live pages")
        idx = int(self.rng.integers(live))
        old = int(kv.block_table[slot, idx])
        if mode == "oob":
            new = kv.num_pages + int(self.rng.integers(1, 9))
        elif mode == "dup":
            victims = [
                int(p)
                for s in range(kv.max_seqs) if s != slot
                for p in kv.block_table[s][
                    :kv.pages_for(int(kv.seq_lens[s]))]
                if int(p) >= 0]
            if not victims:
                raise ValueError("no other live slot to alias")
            new = victims[int(self.rng.integers(len(victims)))]
        elif mode == "free":
            if not kv.free_pages:
                raise ValueError("free list is empty")
            new = int(kv.free_pages[
                int(self.rng.integers(len(kv.free_pages)))])
        else:
            raise ValueError(f"mode {mode!r}: 'oob' | 'dup' | 'free'")
        kv.block_table[slot, idx] = new
        return f"slot {slot} entry {idx}: page {old} -> {new} ({mode})"

    # -- resource pressure -------------------------------------------------

    @contextlib.contextmanager
    def exhaust_pool(self, kv: PagedKVCache, keep: int = 0):
        """Steal all but ``keep`` free pages for the scope's duration
        (forced allocation failure / preemption pressure), restoring them
        on exit.  Yields the stolen page ids."""
        stolen = []
        while len(kv.free_pages) > keep:
            stolen.append(kv.free_pages.pop())
        try:
            yield stolen
        finally:
            kv.free_pages.extend(reversed(stolen))

    # -- checkpoint / restart corruption -----------------------------------

    def tear_checkpoint_tmp(self, directory: str, *, step: int = 99) -> str:
        """A crash mid-save: a ``step_XXXXXXXX.tmp`` directory holding a
        partial leaf and no manifest, what a SIGKILL during
        :func:`repro_torch.checkpoint.save` leaves.  The read path must
        skip and garbage-collect it.  Returns the tmp path."""
        path = os.path.join(directory, f"step_{step:08d}.tmp")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "torn_leaf.npy"), "wb") as f:
            f.write(b"\x93NUMPY" + bytes(
                self.rng.integers(0, 256, size=40, dtype=np.uint8)))
        return path

    def flip_checkpoint_bit(self, directory: str, *,
                            step: Optional[int] = None) -> str:
        """Flip one random bit in one ``.npy`` leaf of the (latest)
        retained generation: bit-rot.  The CRC32 check must catch it and
        fall back to the previous generation.  Returns a description."""
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            raise ValueError(f"no checkpoint generation under {directory}")
        path = os.path.join(directory, f"step_{step:08d}")
        leaves = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if not leaves:
            raise ValueError(f"{path} holds no leaves")
        leaf = leaves[int(self.rng.integers(len(leaves)))]
        fpath = os.path.join(path, leaf)
        size = os.path.getsize(fpath)
        # skip the ~128-byte npy header: flip payload data, the case a
        # CRC (not the npy parser) must catch
        lo = min(128, size - 1)
        byte = int(self.rng.integers(lo, size))
        bit = int(self.rng.integers(8))
        with open(fpath, "r+b") as f:
            f.seek(byte)
            old = f.read(1)[0]
            f.seek(byte)
            f.write(bytes([old ^ (1 << bit)]))
        return f"step {step} leaf {leaf}: bit {bit} of byte {byte} flipped"

    def stale_manifest(self, directory: str, *,
                       step: Optional[int] = None, version: int = 1) -> str:
        """Rewrite the (latest) generation's manifest with a stale schema
        ``version``: the restart-after-downgrade / foreign-writer case.
        The loader must treat it as unverifiable and fall back.  Returns
        the manifest path."""
        if step is None:
            step = ckpt.latest_step(directory)
        if step is None:
            raise ValueError(f"no checkpoint generation under {directory}")
        mpath = os.path.join(directory, f"step_{step:08d}", "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["format"] = version
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        return mpath

    # -- sidecar corruption ------------------------------------------------

    def mangle_tune_json(self, path: str, *, mode: str = "truncate") -> str:
        """Write a corrupted tuning sidecar at ``path``: ``"truncate"`` (a
        valid payload cut mid-record: killed during the write),
        ``"garbage"`` (non-JSON bytes) or ``"wrong_types"`` (valid JSON,
        wrong structure: one salvageable op entry, one list where a dict
        belongs).  Returns ``path``."""
        good = {
            "meta": {"backend": "cpu", "format": 1},
            "table": {
                "cpu/add": {"16x16": {"fast": {
                    "impl": "jnp", "opts": {}, "us": 1.0}}},
                "cpu/matmul": {"256x256": {"accurate": {
                    "impl": "ozaki", "opts": {}, "us": 42.0}}},
            },
        }
        if mode == "truncate":
            text = json.dumps(good, indent=2)
            cut = int(len(text) * 0.6)
            payload = text[:cut].encode()
        elif mode == "garbage":
            payload = bytes(self.rng.integers(0, 256, size=64, dtype=np.uint8))
        elif mode == "wrong_types":
            bad = dict(good)
            bad["table"] = {
                "cpu/add": good["table"]["cpu/add"],     # salvageable
                "cpu/matmul": ["not", "a", "dict"],      # dropped
                "cpu/softmax": {"64x64": "not-a-record"},
            }
            payload = json.dumps(bad).encode()
        else:
            raise ValueError(
                f"mode {mode!r}: 'truncate' | 'garbage' | 'wrong_types'")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(payload)
        return path
