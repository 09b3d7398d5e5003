"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, under ``build/kernels/`` at the repository root
(listed in ``.gitignore``).  A library is rebuilt when its source is newer.  Nothing is compiled at
import time: the first wrapper call on a CUDA tensor builds and loads.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_REPO_ROOT = Path(__file__).resolve().parents[3]
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "kernels"


def nvcc() -> str:
    """The ``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _lib_path(source: Path) -> Path:
    return build_dir() / f"lib{source.stem}.so"


def compile_command(source: Path) -> List[str]:
    return [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(_lib_path(source)),
            str(source)]


def start_builds(sources: Sequence[Path]) -> List[subprocess.Popen]:
    """Start one ``nvcc`` per stale source, all at once; returns the
    processes (``finish_builds`` waits for them)."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        lib = _lib_path(src)
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            continue
        procs.append(subprocess.Popen(
            compile_command(src), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_builds(procs: Sequence[subprocess.Popen]) -> str:
    """Wait for every build; raise with the compiler's output on failure.
    Returns the compilers' combined output (register and spill report)."""
    logs = []
    for p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}")
    return "\n".join(logs)


def load(source: Path) -> ctypes.CDLL:
    """Build (if stale) and load the library of one CUDA source."""
    key = str(source)
    with _LOCK:
        if key not in _LOADED:
            finish_builds(start_builds([source]))
            _LOADED[key] = ctypes.CDLL(str(_lib_path(source)))
        return _LOADED[key]
