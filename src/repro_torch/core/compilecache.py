"""Context-keyed step registry, the captured programs it runs on the card, and
the namespace of the built-kernel cache.

The port of the registry half of ``repro/core/compilecache.py``.  JAX's
``jit`` traces a function once per input shape and replays the compiled
program; the port's counterpart is a CUDA graph (``torch.cuda.CUDAGraph``)
captured once per input-shape class and replayed.  Three pieces:

  * :func:`cached_step` is the process-local registry: a step memoized by an
    explicit ``(key, context)``, NOT by the identity of ``fn`` (callers pass
    fresh lambdas and partials), with hits, misses, build seconds and
    entries in :func:`cache_counters`.  ``context`` must fully determine
    the computation, closure contents included.  Calling a
    :class:`CachedStep` runs its body eagerly; the autotune candidates of
    :mod:`repro_torch.launch.microbench` are timed that way.
  * :class:`Graphs` runs steps on static buffers.  It belongs to one owner
    (a server) at a time and holds that owner's graphs and their memory
    pool.  :meth:`Graphs.bind` ties a step to the tensors it reads and
    writes; on the card (``capture=True``) the first call of a bound step
    runs its body once for real (the warm-up, on a side stream), then
    captures it; every later call replays the graph.  A graph is bound to
    the buffers it was captured on: binding the same key and shape class to
    other buffers raises.  Two LIVE owners with the same context therefore
    share the registry's step but never its graphs: each captures its own.
    With ``capture=False`` (the CPU, and the eager path on the card) the
    same body runs through the same static buffers on every call.  A
    capture or replay that fails raises; nothing falls back to eager.
  * :func:`hand_over` and :func:`take_over` pass a finished owner's state
    (its :class:`Graphs` and the static buffers they are bound to) to the
    next owner of the same model and context, as the reference's servers
    share their compiled steps in process: a server built after another of
    the same params and context replays the programs the first captured
    instead of capturing its own.  A state is taken by one owner at a time
    (:func:`take_over` removes it), so two live owners never share buffers.
    :func:`drop_handed_over` frees what nobody took (the pool holds the
    params the graphs read).
  * :func:`persistent_cache_dir` namespaces the port's persistent cache,
    the built kernel libraries (``repro_torch.kernels.build``), by this
    process's hardware and software fingerprints, as the reference does
    for its XLA cache.

Launch counts under replay: a replay runs no Python, so the kernel
wrappers' ``launches`` counters (flash attention, SSD, RMSNorm) would not
move.  A bound step records each counter's increase while its graph is
captured and adds it at every replay; the warm-up is a real execution and
counts as one.

Settings resolve at capture.  A kernel reads its tuned tiles through
``settings_for`` when its wrapper is called, which for a graph is the
warm-up and the capture; a later promotion does not reach a graph that
exists, only graphs captured after it.  The reference behaves the same
way: ``cached_jit``'s context holds no store generation.

The reference's ``xla_runtime`` pseudo-component and its flag helpers have
no torch meaning and are not ported; nothing here reads the environment.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import hashlib
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from .configstore import hardware_fingerprint, sw_fingerprint

__all__ = ["CachedStep", "Graphs", "BoundStep", "cached_step", "cache_counters", "step_counts",
           "clear_registry", "config_signature", "persistent_cache_dir", "launch_counters",
           "model_identity", "hand_over", "take_over", "drop_handed_over", "HANDED_MAX"]

_SANITIZE = re.compile(r"[^A-Za-z0-9._-]+")


def _sanitize(s: str) -> str:
    """Fingerprint → path component (``cuda:NVIDIA H100:x1`` → ``cuda-NVIDIA-H100-x1``)."""
    return _SANITIZE.sub("-", s).strip("-") or "unknown"


def persistent_cache_dir(root: Any) -> Path:
    """``root`` namespaced by the config store's hardware × software
    coordinates: what was built under other coordinates is never reused."""
    return Path(root) / _sanitize(hardware_fingerprint()) / _sanitize(sw_fingerprint())


def config_signature(obj: Any) -> str:
    """Stable short signature of a config object (dataclasses field-hashed,
    everything else by repr) — the cfg-identity part of a step's context.
    Two configs with equal signatures must compute the same step."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        body = repr(sorted(dataclasses.asdict(obj).items()))
        name = getattr(obj, "name", type(obj).__name__)
    else:
        body, name = repr(obj), type(obj).__name__
    return f"{name}:{hashlib.sha1(body.encode()).hexdigest()[:16]}"


# =============================================================================
# The registry
# =============================================================================
_LOCK = threading.Lock()
_REGISTRY: Dict[Tuple[str, Hashable], "CachedStep"] = {}
_COUNTERS = {"hits": 0, "misses": 0, "build_seconds": 0.0, "captures": 0, "replays": 0}
_BY_KEY: Dict[str, Dict[str, int]] = {}      # bound-step key -> runs, captures, replays


class CachedStep:
    """A step body memoized in the registry.  Calling it runs the body
    eagerly; its first call's wall time is build time, as the reference
    counts a jitted step's first call."""

    __slots__ = ("fn", "key", "context", "_first")

    def __init__(self, fn: Callable, key: str, context: Hashable):
        self.fn, self.key, self.context = fn, key, context
        self._first = True

    def __call__(self, *args: Any) -> Any:
        if not self._first:
            return self.fn(*args)
        t0 = time.perf_counter()
        out = self.fn(*args)
        with _LOCK:
            _COUNTERS["build_seconds"] += time.perf_counter() - t0
        self._first = False
        return out

    def __repr__(self) -> str:
        return f"CachedStep({self.key!r}, {self.context!r})"


def cached_step(fn: Callable, *, key: str, context: Hashable = None) -> CachedStep:
    """The registry's step for ``(key, context)``: the first ``fn`` built
    under them wins, and every later call with the same key and context
    gets that step back (a hit), whatever ``fn`` it passes."""
    registry_key = (key, context)
    with _LOCK:
        entry = _REGISTRY.get(registry_key)
        if entry is not None:
            _COUNTERS["hits"] += 1
            return entry
        _COUNTERS["misses"] += 1
        return _REGISTRY.setdefault(registry_key, CachedStep(fn, key, context))


def cache_counters() -> Dict[str, float]:
    """Hits, misses, build seconds, live entries, graph captures and replays."""
    with _LOCK:
        return {**_COUNTERS, "entries": float(len(_REGISTRY))}


def step_counts() -> Dict[str, Dict[str, int]]:
    """Per bound-step key, over every owner: ``runs`` (executions: eager
    calls, warm-ups and replays), ``captures`` and ``replays``."""
    with _LOCK:
        return {k: dict(v) for k, v in _BY_KEY.items()}


def clear_registry() -> None:
    """Drop every memoized step and every handed-over state, and zero the
    counters (tests)."""
    with _LOCK:
        _REGISTRY.clear()
        _BY_KEY.clear()
        _HANDED.clear()
        _COUNTERS.update(hits=0, misses=0, build_seconds=0.0, captures=0, replays=0)


# =============================================================================
# Hand-over: programs and buffers that outlive their owner
# =============================================================================
HANDED_MAX = 8                   # states kept for later owners; the oldest goes first
_HANDED: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()


def model_identity(params: Any) -> Tuple:
    """The identity of a model's parameters as a graph sees them: the tree
    object and the address of every leaf (a graph reads its weights at the
    addresses it was captured on)."""
    return (id(params), tuple(x.data_ptr() for x in _leaves(params)
                              if isinstance(x, torch.Tensor)))


def hand_over(key: Hashable, state: Any) -> None:
    """Offer a finished owner's ``state`` to the next owner of ``key`` (the
    model's identity and the owner's context).  One state per key: a later
    one replaces it.  At most :data:`HANDED_MAX` keys are kept."""
    with _LOCK:
        dropped = [_HANDED.pop(key, None)]
        _HANDED[key] = state
        while len(_HANDED) > HANDED_MAX:
            dropped.append(_HANDED.popitem(last=False)[1])
    del dropped                      # freed outside the lock


def take_over(key: Hashable) -> Optional[Any]:
    """The state handed over under ``key``, removed from the pool (one owner
    at a time), or None."""
    with _LOCK:
        return _HANDED.pop(key, None)


def drop_handed_over() -> int:
    """Free every handed-over state nobody took; returns how many."""
    with _LOCK:
        dropped = list(_HANDED.values())
        _HANDED.clear()
    return len(dropped)


def _count(key: str, **add: float) -> None:
    with _LOCK:
        by_key = _BY_KEY.setdefault(key, {"runs": 0, "captures": 0, "replays": 0})
        for name, n in add.items():
            if name in by_key:
                by_key[name] += int(n)
            if name in _COUNTERS:
                _COUNTERS[name] += n


# =============================================================================
# Steps on static buffers
# =============================================================================
def launch_counters() -> Tuple[Callable, ...]:
    """The kernel wrappers whose ``launches`` attribute counts their launches."""
    from ..kernels.flash_attention import kernel as fa
    from ..kernels.rmsnorm import kernel as rms
    from ..kernels.ssd import kernel as ssd
    return fa.flash_attention, ssd.ssd, rms.rmsnorm


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _shape_class(leaves: List[Any]) -> Tuple:
    return tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else repr(x)
                 for x in leaves)


def _binding(leaves: List[Any]) -> Tuple:
    return tuple(x.data_ptr() if isinstance(x, torch.Tensor) else id(x) for x in leaves)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One capture stream per device: capture cannot use the default stream,
    and each new stream would get a cuBLAS workspace of its own."""
    return torch.cuda.Stream(device)


def _tensor_device(args: Tuple) -> torch.device:
    return next(x.device for x in _leaves(args) if isinstance(x, torch.Tensor))


def _warm_up(fn: Callable, args: Tuple) -> None:
    """Run ``fn(*args)`` once for real on the capture stream, so lazy
    library set-up (cuBLAS workspaces, kernel builds, ``cudaFuncSetAttribute``)
    happens there and outside any capture."""
    device = _tensor_device(args)
    side, current = _side_stream(device), torch.cuda.current_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(*args)
    current.wait_stream(side)
    torch.cuda.synchronize(device)


def _capture(fn: Callable, args: Tuple, pool: Any) -> "torch.cuda.CUDAGraph":
    """Capture ``fn(*args)`` into a new graph in ``pool``; nothing runs.
    A replay goes to the caller's current stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(_side_stream(_tensor_device(args))):
        graph.capture_begin(pool=pool)
        try:
            fn(*args)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass                     # the capture was invalidated; the body's error says why
            raise
        graph.capture_end()
    return graph


def _new_pool() -> Any:
    return torch.cuda.graph_pool_handle()


class BoundStep:
    """A step tied to its static arguments; call it with none.  It holds no
    reference to its owner, so an owner is freed by reference counting,
    graphs and buffers with it, never later by the cycle collector (which
    could run a graph's destructor inside another graph's capture)."""

    def __init__(self, key: str, fn: Callable, args: Tuple, binding: Tuple, capture: bool,
                 pool: Any):
        self.key, self.fn, self.args, self.binding = key, fn, args, binding
        self.capture, self.pool = capture, pool
        self.graph: Any = None
        self.deltas: Tuple[int, ...] = ()
        self.replays = 0
        self.failed: Optional[str] = None

    def __call__(self) -> None:
        if not self.capture:
            self.fn(*self.args)
            _count(self.key, runs=1)
            return
        if self.failed is not None:
            raise RuntimeError(f"{self.key}: its capture failed earlier ({self.failed}); "
                               "a graph step never falls back to eager")
        if self.graph is None:
            self._build()
            return
        try:
            self.graph.replay()
        except RuntimeError as e:
            self.failed = f"replay: {e}"
            raise
        for wrapper, n in zip(launch_counters(), self.deltas):
            wrapper.launches += n
        self.replays += 1
        _count(self.key, runs=1, replays=1)

    def _build(self) -> None:
        """The warm-up (this call's real execution), then the capture; the
        kernel counters' increase during the capture is what each replay adds."""
        wrappers = launch_counters()
        t0 = time.perf_counter()
        try:
            _warm_up(self.fn, self.args)
            before = [w.launches for w in wrappers]
            collecting = gc.isenabled()
            gc.disable()                 # no destructor of another graph inside this capture
            try:
                self.graph = _capture(self.fn, self.args, self.pool)
            finally:
                if collecting:
                    gc.enable()
        except Exception as e:
            self.failed = f"{type(e).__name__}: {e}"
            raise RuntimeError(f"{self.key}: CUDA graph warm-up or capture failed") from e
        self.deltas = tuple(w.launches - b for w, b in zip(wrappers, before))
        _count(self.key, runs=1, captures=1, build_seconds=time.perf_counter() - t0)


class Graphs:
    """The static-buffer steps of one owner at a time.

    ``capture=True`` runs each bound step as a CUDA graph (the card only);
    ``capture=False`` runs its body eagerly.  All graphs share one memory
    pool, safe because a step returns nothing and writes its results into
    its static buffers, so no graph keeps memory the next one may reuse,
    and one owner's steps run one at a time on one stream.  ``captures``
    and ``replays`` count per key."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.pool = _new_pool() if capture else None
        self.bound: Dict[Tuple[str, Hashable, Tuple], BoundStep] = {}

    def _tally(self, count: Callable[[BoundStep], int]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (key, _, _), step in self.bound.items():
            if count(step):
                out[key] = out.get(key, 0) + count(step)
        return out

    @property
    def captures(self) -> Dict[str, int]:
        return self._tally(lambda step: int(step.graph is not None))

    @property
    def replays(self) -> Dict[str, int]:
        return self._tally(lambda step: step.replays)

    def bind(self, key: str, fn: Callable, *args: Any, variant: Hashable = None) -> BoundStep:
        """``fn(*args)`` as a step of this owner, memoized by ``key``,
        ``variant`` and the args' shape class.  ``variant`` names what the
        shapes do not show (a kernel, a constant of the program), so two
        programs of one key may share a shape class, or even buffers; counts
        stay per ``key``.  ``fn`` writes its results into ``args`` and
        returns nothing.  The same key, variant and shape class on other
        buffers raise: a graph never replays against buffers it was not
        captured on."""
        leaves = _leaves(args)
        shape_class, binding = _shape_class(leaves), _binding(leaves)
        memo = (key, variant, shape_class)
        step = self.bound.get(memo)
        if step is None:
            step = self.bound[memo] = BoundStep(key, fn, args, binding, self.capture, self.pool)
        elif step.binding != binding:
            raise ValueError(f"{key}: already bound to other buffers of this shape class; "
                             "a graph replays only on the buffers it was captured on")
        return step
