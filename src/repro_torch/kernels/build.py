"""Build the port's CUDA sources into shared libraries at first use.

Each kernel source ``src/repro_torch/csrc/<name>.cu`` exposes a plain C
entry point.  :func:`build` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/<hw>/<sw>/<name>-<hash>.so`` under the
repository root: the port's persistent cache, namespaced by this process's
hardware and software fingerprints
(:func:`repro_torch.core.compilecache.persistent_cache_dir`) and keyed by
a hash of the source, the flags and ``nvcc --version``, so an edited
source or another compiler rebuilds and an unchanged one is reused.  All
missing libraries of one call compile in parallel, one ``nvcc`` per
source.  :func:`load` opens a built library with ``ctypes``.
:func:`set_root` moves the cache of this process to another root (a
fresh interpreter of the cold/warm benchmark builds into a root of its
own, so it never reads or writes the shared one).

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit, where only the kernels' plain versions run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Sequence

from ..core.compilecache import persistent_cache_dir

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "build_dir", "set_root", "library_path", "build",
           "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LOADED: Dict[str, ctypes.CDLL] = {}
_root: Path = BUILD_ROOT


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    """``nvcc --version``, part of every library's hash."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=60,
                          check=True).stdout


def build_dir() -> Path:
    """``<root>/<hw>/<sw>``, the root :data:`BUILD_ROOT` (``build/kernels``)
    unless :func:`set_root` gave another: libraries built under other
    hardware or software coordinates are never loaded."""
    return persistent_cache_dir(_root)


def set_root(root: Any) -> Path:
    """Build into and load from ``root`` from now on in this process;
    returns the previous root.  Libraries already loaded stay loaded."""
    global _root
    old, _root = _root, Path(root)
    return old


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = src.read_bytes() + " ".join(NVCC_FLAGS).encode() + nvcc_version().encode()
    return build_dir() / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once.

    Returns name → library path.  The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``<lib>.log``, with the
    source's ``nvcc`` wall time on its last line (``nvcc wall <s> s``).
    Raises if any compile fails, after every started ``nvcc`` has exited.
    """
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        log = p.with_name(p.name + ".log").open("w")
        procs[n] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                                     stdout=log, stderr=subprocess.STDOUT),
                    log, tmp, p, time.perf_counter())
    failed = []
    while procs:
        for n, (proc, log, tmp, p, t0) in list(procs.items()):
            if proc.poll() is None:
                continue
            log.write(f"nvcc wall {time.perf_counter() - t0:.1f} s\n")
            log.close()
            del procs[n]
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exited {proc.returncode}\n"
                              + p.with_name(p.name + ".log").read_text())
                continue
            os.replace(tmp, p)  # atomic: a concurrent process never loads a partial file
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of one kernel source, compiled first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build([name])[name]))
    return lib
