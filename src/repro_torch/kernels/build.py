"""Build the port's CUDA sources into shared libraries at first use.

Each kernel source ``src/repro_torch/csrc/<name>.cu`` exposes a plain C
entry point.  :func:`build` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/<name>-<hash>.so`` under the repository
root, keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  All missing libraries of one call
compile in parallel, one ``nvcc`` per source.  :func:`load` opens a built
library with ``ctypes``.

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit, where only the kernels' plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once.

    Returns name → library path.  The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``<lib>.log``.  Raises
    if any compile fails, after every started ``nvcc`` has exited.
    """
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                    tmp, p)
    failed = []
    for n, (proc, tmp, p) in procs.items():
        log, _ = proc.communicate()
        p.with_name(p.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, p)  # atomic: a concurrent process never loads a partial file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of one kernel source, compiled first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
