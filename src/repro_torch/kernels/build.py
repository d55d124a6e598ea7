"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``build/kernels-<hash>/lib<name>.so`` at the root
of the checkout), loaded with ``ctypes``.  The build happens at first use,
keyed by a hash of every source and of the flags, so an edited source is
rebuilt and an unchanged one is not.  All sources compile at once, one
``nvcc`` each.  The package builds only inside a checkout of the
repository: an installed copy has no checkout to build into.

Flags: ``sm_90a``, no fast math, no mul+add contraction (``--fmad=false``),
no flush-to-zero, IEEE division and square root — the EFTs need every
f32 op correctly rounded.  ``-Xptxas -v`` writes each kernel's registers,
shared memory and spills to ``lib<name>.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ROOT = Path(__file__).resolve().parents[3]
SOURCES = ("ff_mean_sq", "ff_attention", "ff_adamw", "ff_matmul",
           "ff_matmul_ozaki", "ff_matmul_dot2", "ff_softmax",
           "ff_norm_stats", "ff_program", "ff_elementwise", "ff_rowsum",
           "ff_math", "ff_guard", "ff_math_paths",
           "ff_matmul_hybrid_check")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "--fmad=false", "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}


def build_dir() -> Path:
    """``build/kernels-<hash of the sources and flags>`` in the checkout."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return ROOT / "build" / f"kernels-{h.hexdigest()[:16]}"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def build_all() -> Path:
    """Compile every source not yet built, all at once; returns the build
    directory.  Raises with the compiler's output when a build fails."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    if not (ROOT / "pyproject.toml").is_file():
        raise RuntimeError(f"{ROOT} is not a checkout of the repository: "
                           f"the kernels build into its build/ directory")
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        # written aside and renamed when complete: a library that exists
        # is a finished build, even if another process is building too
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"lib{name}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")   # atomic for readers
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def entry(name: str, fn: str, argtypes: Sequence) -> Callable[..., int]:
    """The C entry point ``fn`` of ``lib<name>.so`` (built first if needed)
    with its argument types set; every entry point returns a CUDA error
    code (0 on success)."""
    key = (name, fn)
    if key not in _ENTRIES:
        f = getattr(ctypes.CDLL(str(build_all() / f"lib{name}.so")), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _ENTRIES[key] = f
    return _ENTRIES[key]
