"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface (``<name>_launch``), loaded with ctypes; pointers and the
stream travel as ``c_void_p``.  Flags: ``sm_90a`` (Hopper), ``-O3`` and
``--fmad=false`` without fast math, so products and quotients round as in
the plain PyTorch versions and the JAX reference.

Libraries go to ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``) and are rebuilt when a source or header is newer.  Building
happens on first use, or up front with :func:`build` (one ``nvcc`` process
per source, all started together).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("tile_trace", "dense_hit")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine "
                       "with the CUDA toolkit")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return so.stat().st_mtime < newest


def build(names: Iterable[str] = KERNELS, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels (all started together); returns each
    build's compiler output (ptxas register and shared-memory report).
    Raises RuntimeError with the compiler's output when a build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device: Optional["torch.device"] = None) -> int:  # noqa: F821
    import torch

    return torch.cuda.current_stream(device).cuda_stream
