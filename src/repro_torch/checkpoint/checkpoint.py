"""Atomic, async, checksummed checkpoints (counterpart of
``repro.checkpoint.checkpoint``; the same on-disk format, so either package
reads the other's files).

Format (schema ``FORMAT``): one directory per step, ``step_XXXXXXXX``, of
flat ``.npy`` leaves and a JSON manifest (``format``, ``step``, each
leaf's name, shape, dtype and CRC32 of its stored bytes, and ``extra``).
Writes go to ``<dir>.tmp`` and then ``os.rename``: a crash mid-save never
corrupts the latest checkpoint, and the ``.tmp`` it leaves behind is
skipped and removed by the next read.  The last 3 generations are kept.

Leaf names follow the reference's pytree flattening: dict keys sorted and
joined by ``__``, dataclass and NamedTuple fields by name, list and tuple
items ``i{n}``; a bare leaf is ``leaf``.  Tensors are copied to the host
when they are saved.  bf16 is written as its uint16 bits with ``"dtype":
"bfloat16"`` in the manifest; on load such a leaf comes back as a CPU
``torch.bfloat16`` tensor (numpy has no bf16), every other leaf as a
numpy array.

Integrity: :func:`load` and :func:`load_dict` check the schema and every
CRC32.  On any mismatch (a flipped bit, a truncated or missing leaf, a
stale schema) they warn (:class:`CheckpointCorruptionWarning`) and fall
back to the previous retained generation; only when none verifies do they
raise :class:`CheckpointError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "__"

#: manifest schema version (the reference's); a manifest with any other
#: version counts as corrupt and falls into the generation ladder
FORMAT = 2


class CheckpointError(RuntimeError):
    """No retained checkpoint generation verified (or an explicit step was
    asked for and nothing at or below it loads)."""


class CheckpointCorruptionWarning(UserWarning):
    """A checkpoint generation failed verification and was skipped."""


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(name part, child) pairs of a container in the reference's pytree
    order, or None for a leaf.  None values hold no leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, (list, tuple)):
        return [(f"i{i}", x) for i, x in enumerate(node)]
    return None


def flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """``[(name, leaf), ...]`` in the reference's leaf order and names."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((SEP.join(path) or "leaf", node))
            return
        for part, child in kids:
            walk(child, path + [part])

    walk(tree, [])
    return out


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bits as a host uint16 array (a copy)."""
    return t.detach().view(torch.int16).to("cpu", copy=True).numpy() \
        .view(np.uint16)


def bf16_from_bits(a) -> torch.Tensor:
    """A CPU bf16 tensor from uint16 bits (a numpy array), or ``a`` itself
    when it is a bf16 tensor already."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array written to disk (a host copy) and its manifest
    dtype."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return bf16_bits(leaf), "bfloat16"
        arr = leaf.detach().to("cpu", copy=True).numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _host_leaves(tree) -> List[Tuple[str, np.ndarray, str]]:
    return [(name, *_host(leaf)) for name, leaf in flatten_with_names(tree)]


def _write(directory: str, step: int, leaves, extra: Optional[Dict]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"format": FORMAT, "step": step, "leaves": [],
                "extra": extra or {}}
    for name, stored, dtype in leaves:
        np.save(os.path.join(tmp, name + ".npy"), stored)
        manifest["leaves"].append({"name": name, "shape": list(stored.shape),
                                   "dtype": dtype, "crc32": _crc(stored)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # keep the last 3: the ladder load() walks down
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for old in ckpts[:-3]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    return final


def save(directory: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Synchronous atomic save (tmp dir + rename).  Returns the final
    path."""
    return _write(directory, step, _host_leaves(tree), extra)


class AsyncCheckpointer:
    """Copy to the host on the call, write on a thread.  At most one write
    in flight: a new save waits for the previous one.

    Write errors are never lost: :meth:`wait` raises them and :meth:`poll`
    returns them (the serve engine polls every scheduler iteration)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        self.wait()
        leaves = _host_leaves(tree)     # the caller may update in place

        def work():
            try:
                _write(self.directory, step, leaves, extra)
            except BaseException as e:  # raised again by poll()/wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def poll(self) -> Optional[BaseException]:
        """Non-blocking: reap a finished write and return (and clear) its
        error, if any; None while a write is in flight or after a good
        one."""
        if self._thread is not None:
            if self._thread.is_alive():
                return None
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            return err
        return None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _gc_tmp(directory: str) -> None:
    """Remove ``step_*.tmp`` directories a crash mid-save left behind.
    Called from the read paths, which run before any writer starts."""
    for d in os.listdir(directory):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def available_steps(directory: str) -> List[int]:
    """Ascending steps of the retained generations (``.tmp`` directories
    are skipped and removed)."""
    if not os.path.isdir(directory):
        return []
    _gc_tmp(directory)
    steps = []
    for d in os.listdir(directory):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            steps.append(int(d.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return sorted(set(steps))


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return max(steps) if steps else None


def _read_verified(path: str) -> Tuple[Dict[str, Any], Dict]:
    """Read one generation, checking the schema and every leaf's CRC32.
    Raises :class:`CheckpointError` on any mismatch."""
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(f"{path}: manifest unreadable "
                              f"({type(e).__name__}: {e})")
    fmt = manifest.get("format") if isinstance(manifest, dict) else None
    if fmt != FORMAT:
        raise CheckpointError(f"{path}: manifest schema {fmt!r} != "
                              f"supported {FORMAT} (stale or foreign "
                              f"checkpoint)")
    arrays: Dict[str, Any] = {}
    for leaf in manifest["leaves"]:
        name = leaf["name"]
        try:
            a = np.load(os.path.join(path, name + ".npy"))
        except Exception as e:       # missing, truncated, garbled header
            raise CheckpointError(f"{path}: leaf {name!r} unreadable "
                                  f"({type(e).__name__}: {e})")
        want_crc = leaf.get("crc32")
        if want_crc is None or _crc(a) != want_crc:
            raise CheckpointError(f"{path}: leaf {name!r} failed its CRC32 "
                                  f"check (bit-rot or torn write)")
        if tuple(a.shape) != tuple(leaf["shape"]):
            raise CheckpointError(f"{path}: leaf {name!r} shape "
                                  f"{tuple(a.shape)} != manifest "
                                  f"{tuple(leaf['shape'])}")
        if leaf["dtype"] == "bfloat16":
            a = bf16_from_bits(a)
        arrays[name] = a
    return arrays, manifest


def load_dict(directory: str, step: Optional[int] = None
              ) -> Tuple[Dict[str, Any], int, Dict]:
    """Load the newest verified generation as ``{leaf_name: array}``
    (``step``: the newest at or below it).  A generation that fails
    verification is warned about (:class:`CheckpointCorruptionWarning`)
    and the previous one is tried.  Raises :class:`FileNotFoundError`
    when there is no generation, :class:`CheckpointError` when none
    verifies.  Returns ``(arrays, step, extra)``."""
    steps = available_steps(directory)
    if step is not None:
        steps = [s for s in steps if s <= step]
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}"
                                + (f" at or below step {step}"
                                   if step is not None else ""))
    last_err: Optional[CheckpointError] = None
    for s in reversed(steps):
        path = os.path.join(directory, f"step_{s:08d}")
        try:
            arrays, manifest = _read_verified(path)
        except CheckpointError as e:
            warnings.warn(
                f"checkpoint generation step_{s:08d} failed verification "
                f"({e}); falling back to the previous retained generation",
                CheckpointCorruptionWarning, stacklevel=2)
            last_err = e
            continue
        return arrays, s, manifest.get("extra", {})
    raise CheckpointError(
        f"no retained checkpoint generation under {directory} verifies; "
        f"last error: {last_err}")


def _rebuild(like, leaves):
    """A tree shaped like ``like`` whose leaves are taken, in order, from
    the iterator ``leaves``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    new = [_rebuild(child, leaves) for _, child in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*new)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: v for f, v in zip(dataclasses.fields(like), new)})
    return type(like)(new)


def load(directory: str, tree_like, step: Optional[int] = None
         ) -> Tuple[Any, int, Dict]:
    """The newest verified generation in the structure of ``tree_like``
    (verification and fallback as in :func:`load_dict`).  A leaf missing
    from the checkpoint raises ``KeyError``; a shape other than
    ``tree_like``'s ``ValueError``.  Returns ``(tree, step, extra)``."""
    arrays, step, extra = load_dict(directory, step)
    out = []
    for name, like in flatten_with_names(tree_like):
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        a = arrays[name]
        want = tuple(like.shape) if hasattr(like, "shape") \
            else tuple(np.shape(like))
        if tuple(a.shape) != want:
            raise ValueError(f"leaf {name}: ckpt {tuple(a.shape)} != "
                             f"expected {want}")
        out.append(a)
    return _rebuild(tree_like, iter(out)), step, extra
