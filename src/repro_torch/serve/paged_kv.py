"""Paged KV cache: fixed-size pages, one block table for every plane
(counterpart of ``repro.serve.paged_kv``; kv_modes "bf16", "f32" and
"ff_bf16").

KV lives in ``(L, num_pages, page_size, KV, hd)`` device tensors
("planes"), updated in place; the block table, lengths and free list are
host-side numpy, as in the reference, and so is their audit
(:meth:`PagedKVCache.check_integrity`, ``drop_slot``,
``rebuild_free_list``).

In ``kv_mode="ff_bf16"`` each of k/v is stored as a double-bf16 limb pair
(``hi = bf16(x)``, ``lo = bf16(x - hi)``: planes ``k_hi``, ``k_lo``,
``v_hi``, ``v_lo``) under the one block table, so the limbs of a value
always move together.  :meth:`PagedKVCache.to_state` /
:meth:`PagedKVCache.from_state` round-trip the cache through a dict of
numpy arrays, bf16 planes as their uint16 bits (the reference's layout).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import bf16_bits, bf16_from_bits

Tensor = torch.Tensor

#: plane names per kv_mode (all planes share the block table)
_MODE_PLANES = {"bf16": ("k", "v"), "f32": ("k", "v"),
                "ff_bf16": ("k_hi", "k_lo", "v_hi", "v_lo")}
_MODE_DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32,
               "ff_bf16": torch.bfloat16}


def ff_split(x: Tensor, dtype=torch.bfloat16):
    """Split an f32 tensor into (hi, lo) storage limbs: ``hi = round(x)``,
    ``lo = round(x - hi)``."""
    xf = x.to(torch.float32)
    hi = xf.to(dtype)
    lo = (xf - hi.to(torch.float32)).to(dtype)
    return hi, lo


def ff_merge(hi: Tensor, lo: Tensor) -> Tensor:
    """Rebuild the f32 value from storage limbs (exact sum in f32)."""
    return hi.to(torch.float32) + lo.to(torch.float32)


class PagedKVCache:
    """Fixed-pool paged KV store for ``max_seqs`` concurrent sequences.

    The block table is numpy ``(max_seqs, max_pages)`` int32 with ``-1``
    marking unallocated entries."""

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, *,
                 num_pages: int, page_size: int = 16, max_seqs: int = 8,
                 max_ctx: int = 512, kv_mode: str = "bf16", device=None):
        if kv_mode not in _MODE_PLANES:
            raise ValueError(f"unknown kv_mode {kv_mode!r}; choose from "
                             f"{tuple(_MODE_PLANES)}")
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.max_pages = -(-max_ctx // page_size)   # pages per sequence row
        self.kv_mode = kv_mode
        self.device = resolve_device(device)
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
        self.planes: Dict[str, Tensor] = {
            name: torch.zeros(shape, dtype=_MODE_DTYPE[kv_mode],
                              device=self.device)
            for name in _MODE_PLANES[kv_mode]}
        self.block_table = np.full((max_seqs, self.max_pages), -1, np.int32)
        self.seq_lens = np.zeros((max_seqs,), np.int32)
        self.free_pages: List[int] = list(range(num_pages - 1, -1, -1))

    # -- allocation --------------------------------------------------------

    def pages_for(self, length: int) -> int:
        return -(-length // self.page_size)

    def can_alloc(self, length: int) -> bool:
        return len(self.free_pages) >= self.pages_for(length)

    def alloc(self, slot: int, length: int) -> List[int]:
        """Allocate pages for ``length`` tokens in ``slot``; returns the
        page ids (also recorded in the block table)."""
        need = self.pages_for(length)
        if need > self.max_pages:
            raise ValueError(f"length {length} exceeds max_ctx "
                             f"({self.max_pages * self.page_size})")
        if need > len(self.free_pages):
            raise RuntimeError("paged KV pool exhausted")
        if self.seq_lens[slot] or (self.block_table[slot] >= 0).any():
            raise RuntimeError(f"slot {slot} already holds a sequence")
        ids = [self.free_pages.pop() for _ in range(need)]
        self.block_table[slot, :need] = ids
        self.seq_lens[slot] = length
        return ids

    def grow(self, slot: int, new_length: int) -> Optional[int]:
        """Extend ``slot`` to ``new_length`` tokens, allocating at most one
        new page (decode adds one token a step).  Returns the new page id,
        or None when the last page still has room.  An empty pool raises
        before ``seq_lens`` changes, so the engine can preempt a row and
        try again."""
        have = self.pages_for(int(self.seq_lens[slot]))
        need = self.pages_for(new_length)
        if need <= have:
            self.seq_lens[slot] = new_length
            return None
        if need - have != 1:
            raise ValueError("grow() extends by at most one page")
        if not self.free_pages:
            raise RuntimeError("paged KV pool exhausted")
        pid = self.free_pages.pop()
        self.block_table[slot, have] = pid
        self.seq_lens[slot] = new_length
        return pid

    def check_integrity(self) -> Tuple[List[str], Set[int]]:
        """Audit the host-side paging metadata (block table and free list).

        Returns ``(problems, bad_slots)``: readable descriptions, and the
        slots whose page lists can no longer be trusted (a page id out of
        range, a page shared by two slots or with the free list, or a hole
        below the live length).  A numpy scan of ``max_seqs * max_pages``
        entries; the serve engine runs it per step under a guard and
        decides what to do with the verdict."""
        problems: List[str] = []
        bad: Set[int] = set()
        free = [int(p) for p in self.free_pages]
        free_set = set(free)
        if len(free_set) != len(free):
            problems.append("free list contains duplicate page ids")
        if any(not 0 <= p < self.num_pages for p in free_set):
            problems.append("free list contains out-of-range page ids")
        owner: Dict[int, int] = {}
        for slot in range(self.max_seqs):
            row = self.block_table[slot]
            for pid in row:
                pid = int(pid)
                if pid == -1:
                    continue
                if not 0 <= pid < self.num_pages:
                    problems.append(f"slot {slot}: page id {pid} out of "
                                    f"range [0, {self.num_pages})")
                    bad.add(slot)
                    continue
                if pid in free_set:
                    problems.append(f"slot {slot}: page {pid} is also on "
                                    f"the free list")
                    bad.add(slot)
                if pid in owner:
                    problems.append(f"page {pid} referenced by slots "
                                    f"{owner[pid]} and {slot}")
                    bad.add(slot)
                    bad.add(owner[pid])
                else:
                    owner[pid] = slot
            live = self.pages_for(int(self.seq_lens[slot]))
            if live and (row[:live] < 0).any():
                problems.append(f"slot {slot}: missing page below live "
                                f"length {int(self.seq_lens[slot])}")
                bad.add(slot)
        return problems, bad

    def rebuild_free_list(self) -> None:
        """Recompute the free list as every in-range page the block table
        does not reference (the recovery after :meth:`check_integrity`
        found corruption and the untrusted rows were cleared)."""
        used = {int(p) for p in self.block_table.ravel()
                if 0 <= int(p) < self.num_pages}
        self.free_pages = [p for p in range(self.num_pages - 1, -1, -1)
                           if p not in used]

    def drop_slot(self, slot: int) -> None:
        """Clear a slot's row WITHOUT returning its pages to the free list
        (its page ids are untrusted): follow with
        :meth:`rebuild_free_list` once every bad row is cleared."""
        self.block_table[slot] = -1
        self.seq_lens[slot] = 0

    def free_slot(self, slot: int) -> None:
        """Evict a sequence: return its pages to the free list (contents
        stay; masked reads never see them)."""
        for pid in self.block_table[slot]:
            if pid >= 0:
                self.free_pages.append(int(pid))
        self.block_table[slot] = -1
        self.seq_lens[slot] = 0

    # -- data movement -----------------------------------------------------

    def write_prefill(self, slot: int, tensors: Dict[str, Tensor]) -> None:
        """Write per-layer contiguous K/V (``{"k": (L, S, KV, hd), "v":
        ...}``) into this slot's pages; in ``ff_bf16`` mode split into
        limbs here, both limbs into the same pages."""
        S = int(tensors["k"].shape[1])
        if S != int(self.seq_lens[slot]):
            raise ValueError("prefill length != allocated length")
        npg = self.pages_for(S)
        ids = torch.as_tensor(self.block_table[slot, :npg], dtype=torch.long,
                              device=self.device)
        pad = npg * self.page_size - S
        for base in ("k", "v"):
            x = torch.nn.functional.pad(tensors[base],
                                        (0, 0, 0, 0, 0, pad))
            paged = x.reshape(x.shape[0], npg, self.page_size,
                              self.num_kv_heads, self.head_dim)
            if self.kv_mode == "ff_bf16":
                hi, lo = ff_split(paged)
                self.planes[f"{base}_hi"][:, ids] = hi
                self.planes[f"{base}_lo"][:, ids] = lo
            else:
                self.planes[base][:, ids] = paged.to(self.planes[base].dtype)

    def gather(self, slot: int) -> Dict[str, Tensor]:
        """Contiguous read-back of a slot ({"k": (L, S, KV, hd), ...}; f32
        in ``ff_bf16`` mode, the storage dtype otherwise)."""
        S = int(self.seq_lens[slot])
        npg = self.pages_for(S)
        ids = torch.as_tensor(self.block_table[slot, :npg], dtype=torch.long,
                              device=self.device)
        out = {}
        for base in ("k", "v"):
            if self.kv_mode == "ff_bf16":
                paged = ff_merge(self.planes[f"{base}_hi"][:, ids],
                                 self.planes[f"{base}_lo"][:, ids])
            else:
                paged = self.planes[base][:, ids]
            out[base] = paged.reshape(self.num_layers, npg * self.page_size,
                                      self.num_kv_heads,
                                      self.head_dim)[:, :S]
        return out

    # -- serialization -----------------------------------------------------

    def to_state(self) -> Dict[str, np.ndarray]:
        """The whole cache as a flat dict of numpy arrays (the reference's
        keys): the paging metadata, the geometry, the mode, and each plane
        (bf16 planes as uint16 bits)."""
        state: Dict[str, np.ndarray] = {
            "block_table": self.block_table.copy(),
            "seq_lens": self.seq_lens.copy(),
            "free_pages": np.asarray(self.free_pages, np.int32),
            "geometry": np.asarray(
                [self.num_layers, self.num_kv_heads, self.head_dim,
                 self.num_pages, self.page_size, self.max_seqs,
                 self.max_pages * self.page_size], np.int64),
            "kv_mode": np.frombuffer(
                self.kv_mode.encode().ljust(8, b"\0"), np.uint8).copy(),
        }
        for name, plane in self.planes.items():
            if plane.dtype == torch.bfloat16:
                state[f"plane_{name}"] = bf16_bits(plane)
            else:
                state[f"plane_{name}"] = plane.detach().to(
                    "cpu", copy=True).numpy()
        return state

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray],
                   device=None) -> "PagedKVCache":
        """Rebuild a cache from :meth:`to_state` output (or the
        reference's) on ``device`` (None = the CUDA card).  Checks the
        structure: a missing key, a malformed geometry or a plane whose
        shape disagrees with it raises ``ValueError``.  A bf16 plane may
        come as uint16 bits or as a bf16 tensor."""
        for key in ("geometry", "kv_mode", "block_table", "seq_lens",
                    "free_pages"):
            if key not in state:
                raise ValueError(f"KV state missing required key {key!r}")
        geom = np.asarray(state["geometry"]).ravel()
        if geom.shape[0] != 7:
            raise ValueError(f"KV state geometry has {geom.shape[0]} "
                             f"entries; expected 7")
        L, KV, hd, NP, ps, ms, mc = (int(v) for v in geom)
        mode = bytes(np.asarray(state["kv_mode"], np.uint8)) \
            .rstrip(b"\0").decode()
        if mode not in _MODE_PLANES:
            raise ValueError(f"KV state names unknown kv_mode {mode!r}")
        want_shape = (L, NP, ps, KV, hd)
        for name in _MODE_PLANES[mode]:
            key = f"plane_{name}"
            if key not in state:
                raise ValueError(f"KV state missing plane {key!r} for "
                                 f"kv_mode {mode!r}")
            got = tuple(state[key].shape)
            if got != want_shape:
                raise ValueError(f"KV state plane {key!r} shape {got} != "
                                 f"geometry {want_shape}")
        self = cls(L, KV, hd, num_pages=NP, page_size=ps, max_seqs=ms,
                   max_ctx=mc, kv_mode=mode, device=device)
        self.block_table = np.asarray(state["block_table"], np.int32).copy()
        self.seq_lens = np.asarray(state["seq_lens"], np.int32).copy()
        self.free_pages = [int(p) for p in np.asarray(state["free_pages"])]
        for name in _MODE_PLANES[mode]:
            arr = state[f"plane_{name}"]
            if _MODE_DTYPE[mode] == torch.bfloat16:
                t = bf16_from_bits(arr)
            else:
                t = torch.from_numpy(np.array(arr, np.float32))
            self.planes[name].copy_(t)
        return self
