"""Checkpointing: atomic, durable, async, resumable.

The port of ``repro/runtime/checkpoint.py`` over trees of torch tensors.
Layout:  ``<root>/step_<k:08d>/arrays.npz + manifest.json``, written to a
``.tmp`` sibling then ``os.replace``\\ d — a reader never sees a partial
checkpoint.  Durability is real, not claimed: every file and the directory
entries are fsynced before the rename is allowed to stand, and replacing an
existing step dir goes through a rename-aside (``.old_step_*``) so a crash
at any instruction boundary leaves either the new or the old checkpoint
intact, never neither.  Orphaned staging dirs from dead writers are swept
by GC (pid liveness via ``os.kill(pid, 0)``).

Keys are the leaves' paths joined by ``"/"`` (:mod:`repro_torch.tree`).
npz holds no bfloat16, and neither numpy nor this package has
``ml_dtypes``: a bf16 leaf is stored as its bits, ``uint16``, under
``key + "::bf16"`` (``tensor.view(torch.int16)``), as the reference stores
it.

``AsyncCheckpointer`` copies the state to host memory synchronously inside
``save`` (the train step updates its tensors in place, so the copy must be
taken before the next step runs) and does the serialization and fsync on
a worker thread, so the train loop blocks only for the device-to-host
copy.  Restore puts every leaf on the template leaf's device and dtype.
When no explicit step is requested, restore falls back step by step past
torn or corrupt checkpoints to the newest loadable one.

The checkpoint policy is the smart component ``torch_train_checkpoint``:
interval, async-vs-blocking mode and retention, resolved per state-size
context (``repro_torch.bench.fault_tolerance`` measures the tradeoff).
The reference's resharding on restore (``shardings=``) has no counterpart:
the port runs on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Categorical, Int
from ..tree import leaves_with_paths, tree_map_with_path

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "sweep_stale",
           "AsyncCheckpointer", "ckpt_settings", "workload_signature", "state_kb"]

_BF16 = "::bf16"


@tunable_component(
    name="torch_train_checkpoint",
    tunables=(
        Int("ckpt_every", default=50, low=1, high=1000, log=True),
        Categorical("mode", default="async", choices=("async", "blocking")),
        Int("max_to_keep", default=3, low=1, high=16, log=True),
    ),
    metrics=(MetricSpec("blocked_ms", "d"), MetricSpec("recovery_ms", "d"),
             MetricSpec("overhead_ms", "d")),
)
class CheckpointSettings:
    pass


ckpt_settings = CheckpointSettings()


def workload_signature(state_kb: int) -> str:
    """Checkpoint cost scales with state size; bucket it like serve capacity."""
    return f"kb{bucket_pow2(max(1, int(state_kb)))}"


def state_kb(tree: Any) -> int:
    """The bytes of every tensor leaf, in KiB (the signature's input)."""
    return sum(t.numel() * t.element_size() for _, t in leaves_with_paths(tree)) // 1024


def _to_host(t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(key suffix, an owned numpy copy of the tensor)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in leaves_with_paths(tree):
        suffix, arr = _to_host(torch.as_tensor(leaf))
        flat[key + suffix] = arr
    return flat


def _unflatten_key(flat: Dict[str, np.ndarray], key: str) -> torch.Tensor:
    if key in flat:
        return torch.from_numpy(flat[key])
    bits = flat[key + _BF16]
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _fsync_path(p: Path) -> None:
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _staging_pid(name: str) -> Optional[int]:
    # ".tmp_step_00000012_4242" / ".old_step_00000012_4242" -> 4242
    try:
        return int(name.rsplit("_", 1)[1])
    except (IndexError, ValueError):
        return None


def _staging_step(name: str) -> Optional[int]:
    try:
        return int(name.split("_")[2])
    except (IndexError, ValueError):
        return None


def _repair(root_p: Path) -> None:
    """Promote ``.old_step_*`` dirs orphaned by a writer that died between
    rename-aside and commit: the previously-good checkpoint comes back as
    ``step_<k>`` instead of being lost."""
    if not root_p.exists():
        return
    for d in root_p.glob(".old_step_*"):
        pid = _staging_pid(d.name)
        step = _staging_step(d.name)
        if step is None or (pid is not None and pid != os.getpid() and _pid_alive(pid)):
            continue
        if pid is not None and pid == os.getpid():
            continue  # in-flight rename-aside by THIS process
        final = root_p / f"step_{step:08d}"
        if not final.exists():
            try:
                os.replace(d, final)
            except OSError:
                pass


def sweep_stale(root: str) -> int:
    """Remove staging dirs (``.tmp_step_*``, ``.old_step_*``) left by dead
    writers.  Orphaned ``.old`` dirs are repaired (promoted) first.  Returns
    the number of dirs removed."""
    root_p = Path(root)
    if not root_p.exists():
        return 0
    _repair(root_p)
    removed = 0
    for d in list(root_p.glob(".tmp_step_*")) + list(root_p.glob(".old_step_*")):
        pid = _staging_pid(d.name)
        if pid is not None and (pid == os.getpid() or _pid_alive(pid)):
            continue
        shutil.rmtree(d, ignore_errors=True)
        removed += 1
    return removed


def _write(root: str, step: int, flat: Dict[str, np.ndarray], extra: Optional[Dict],
           durable: bool) -> Path:
    """tmp → fsync → rename-aside → replace → fsync parent → drop."""
    root_p = Path(root)
    final = root_p / f"step_{step:08d}"
    tmp = root_p / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(flat),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if durable:
        # contents must be on disk BEFORE the rename makes them visible,
        # else a crash can surface a fully-named but empty checkpoint
        _fsync_path(tmp / "arrays.npz")
        _fsync_path(tmp / "manifest.json")
        _fsync_path(tmp)
    old = root_p / f".old_step_{step:08d}_{os.getpid()}"
    if final.exists():
        # rename ASIDE, never rmtree-then-replace: a crash in that window
        # would leave NO checkpoint for this step
        if old.exists():
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(tmp, final)
    if durable:
        _fsync_path(root_p)  # persist the directory entry itself
    if old.exists():
        shutil.rmtree(old, ignore_errors=True)
    return final


def save_checkpoint(root: str, step: int, tree: Any, extra: Optional[Dict] = None,
                    durable: bool = True) -> Path:
    return _write(root, step, _flatten(tree), extra, durable)


def _steps(p: Path):
    return sorted(int(d.name.split("_")[1]) for d in p.iterdir()
                  if d.is_dir() and d.name.startswith("step_"))


def latest_step(root: str) -> Optional[int]:
    p = Path(root)
    if not p.exists():
        return None
    _repair(p)
    steps = _steps(p)
    return steps[-1] if steps else None


def _load_step(root: str, step: int, template: Any) -> Tuple[Any, Dict]:
    d = Path(root) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}

    def load(key: str, leaf: Any) -> torch.Tensor:
        leaf = torch.as_tensor(leaf)
        return _unflatten_key(flat, key).to(device=leaf.device, dtype=leaf.dtype)

    return tree_map_with_path(load, template), manifest


def restore_checkpoint(root: str, template: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template``: every leaf takes the
    template leaf's device and dtype.

    With ``step=None`` a torn or corrupt newest checkpoint is skipped and the
    next-older step restored instead (chaos injection corrupts checkpoints on
    purpose; restore must degrade, not die)."""
    if step is not None:
        return _load_step(root, step, template)
    newest = latest_step(root)
    if newest is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    candidates = sorted(_steps(Path(root)), reverse=True)
    last_err: Optional[BaseException] = None
    for s in candidates:
        try:
            return _load_step(root, s, template)
        except Exception as e:  # torn npz / truncated manifest / missing key
            last_err = e
    raise FileNotFoundError(
        f"no loadable checkpoint under {root} "
        f"(tried steps {candidates}): {last_err}") from last_err


class AsyncCheckpointer:
    """Non-blocking saves with bounded retention and crash-safe atomicity.

    ``counters`` tracks the train-loop-visible cost: ``saves``, cumulative
    ``blocked_s`` (time the caller spent inside :meth:`save`), and the stale
    staging dirs swept — the raw material for the checkpoint-overhead metric.
    """

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = root
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.counters: Dict[str, float] = {"saves": 0, "blocked_s": 0.0, "swept": 0}

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        t0 = time.perf_counter()
        self.wait()  # one in-flight save at a time
        # An owning host copy, taken now: the train step updates parameters
        # and moments in place, and the writer thread outlives this call.
        flat = _flatten(tree)

        def work():
            try:
                _write(self.root, step, flat, extra, durable=True)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._err = e

        if blocking:
            work()
            self.counters["saves"] += 1
            self.counters["blocked_s"] += time.perf_counter() - t0
            self._raise()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            self.counters["saves"] += 1
            self.counters["blocked_s"] += time.perf_counter() - t0

    def _gc(self) -> None:
        p = Path(self.root)
        self.counters["swept"] += sweep_stale(self.root)
        for s in _steps(p)[: -self.max_to_keep]:
            shutil.rmtree(p / f"step_{s:08d}", ignore_errors=True)

    def _raise(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()
