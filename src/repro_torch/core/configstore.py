"""Context-keyed store of optimized configurations — tuned settings that
survive the process and are resolved per instance, per workload.

The port of ``repro/core/configstore.py``, with this process's own
coordinates:

  * a :class:`Context` keys a tuned configuration by ``component × workload
    signature × hardware fingerprint × software version``;
    :func:`hardware_fingerprint` / :func:`sw_fingerprint` name the CUDA
    device × count and the torch / CUDA / Python versions, so a tune taken on
    the H100 is filed under the H100 (the reference's versions ask jax);
  * :class:`ConfigStore` persists one JSON file per component under
    ``results/configstore/`` of the repository (the reference's entry format,
    file lock and atomic write) and resolves lookups through the fallback
    chain: exact context → same workload on relaxed hardware/software → a
    component-wide ``"*"`` workload → ``None``;
  * :meth:`ConfigStore.promote` is the validated write path behind the
    RPI envelope and the :func:`repro_torch.core.stats.compare` gate;
  * :func:`resolve_settings` is the per-call hot path of every component's
    ``settings_for``: override → explicit → stored entry → defaults, through
    an ``lru_cache`` keyed on (store token, store generation, context), so a
    serving prefill pays a dict lookup, not a file read.

**One deliberate deviation from the reference.** A stored entry whose
hardware *platform* (the ``cpu:`` or ``cuda:`` prefix of its fingerprint)
differs from the query's never matches, neither in :meth:`resolve_entry`
nor in :meth:`nearest_entry`; hardware differences within one platform
still only lower the rank.  The reference rewrites an impl that cannot run
on its device (a ``pallas`` tune resolved off the TPU runs jnp); the port's
``impl="kernel"`` on a CUDA tensor launches the kernel or raises, and a
CPU-tuned ``impl`` on the card would run the plain version.  So an entry
tuned on a CPU must never reach the card, nor a card's entry a CPU process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import sys
import tempfile
import time

try:
    import fcntl
except ImportError:  # non-POSIX: writers fall back to atomic-rename only
    fcntl = None  # type: ignore[assignment]
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Context", "ConfigStore", "bucket_pow2", "context_for", "platform_of",
    "hardware_fingerprint", "sw_fingerprint", "workload_distance",
    "default_store", "set_default_store", "resolve_settings", "invalidate_cache",
    "set_override", "clear_override", "DEFAULT_ROOT",
]

WILDCARD = "*"
DEFAULT_ROOT = Path(__file__).resolve().parents[3] / "results" / "configstore"


def bucket_pow2(n: int) -> int:
    """Round up to a power of two (floor 1) — workload-signature bucketing.

    Call shapes bucket so that e.g. ``s=500`` and ``s=512`` share one tuned
    entry while ``s=512`` and ``s=4096`` do not.
    """
    return 1 << max(0, (int(n) - 1).bit_length())


@functools.lru_cache(maxsize=1)
def hardware_fingerprint() -> str:
    """``cuda:<device name>:x<count>`` of this process's GPUs, or the host's
    CPU architecture when no GPU is visible."""
    import platform

    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0).replace(" ", "_")
        return f"cuda:{kind}:x{torch.cuda.device_count()}"
    return f"cpu:{platform.machine()}:x1"


@functools.lru_cache(maxsize=1)
def sw_fingerprint() -> str:
    """Library + interpreter versions a tuned config was produced under."""
    import torch

    cuda = torch.version.cuda or "none"
    return f"torch-{torch.__version__}/cuda-{cuda}/py-{sys.version_info.major}.{sys.version_info.minor}"


def platform_of(hardware: str) -> str:
    """The platform prefix of a hardware fingerprint (``cuda``, ``cpu``), or
    ``"*"`` for a wildcard."""
    return WILDCARD if hardware == WILDCARD else hardware.split(":", 1)[0]


@dataclasses.dataclass(frozen=True)
class Context:
    """Full coordinates of one tuned configuration."""

    component: str
    workload: str = WILDCARD
    hardware: str = WILDCARD
    sw: str = WILDCARD

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "Context":
        return cls(**d)


def context_for(component: str, workload: str = WILDCARD) -> Context:
    """A concrete Context for *this* process's hardware/software."""
    return Context(component, workload, hardware_fingerprint(), sw_fingerprint())


def _same_platform(entry_hw: str, query_hw: str) -> bool:
    pe, pq = platform_of(entry_hw), platform_of(query_hw)
    return pe == WILDCARD or pq == WILDCARD or pe == pq


def _match_rank(entry_ctx: Dict[str, str], query: Context) -> Optional[Tuple[int, int, int]]:
    """Specificity of an entry for a query, or None if incompatible.

    The workload must match exactly, or the entry must be component-wide
    (``"*"``); a ``"*"`` query never picks up a shape-specific entry.  An
    entry of another hardware platform never matches (the deviation in the
    module docstring); within the platform, hardware and software matches
    add rank but never disqualify.  Rank orders workload > hardware > sw.
    """
    wl = entry_ctx.get("workload", WILDCARD)
    if wl != query.workload and wl != WILDCARD:
        return None
    hw = entry_ctx.get("hardware", WILDCARD)
    if not _same_platform(hw, query.hardware):
        return None
    return (
        int(wl == query.workload),
        int(hw == query.hardware),
        int(entry_ctx.get("sw", WILDCARD) == query.sw),
    )


_SIG_FIELD = re.compile(r"([a-zA-Z_]+?)(\d+)")
_SIG_SHAPE = re.compile(r"(?:[a-zA-Z_]+\d+)+")


def _sig_fields(workload: str) -> Dict[str, int]:
    """Numeric fields of a bucketed workload signature.

    ``b2q512k512d64`` → ``{b: 2, q: 512, k: 512, d: 64}``.  Only strings
    that are entirely (name, number) pairs parse; anything else (and the
    wildcard) parses empty, so :func:`workload_distance` never reads name
    digits as shape fields.
    """
    if workload == WILDCARD or _SIG_SHAPE.fullmatch(workload) is None:
        return {}
    return {m.group(1): int(m.group(2)) for m in _SIG_FIELD.finditer(workload)}


def workload_distance(a: str, b: str) -> float:
    """How far apart two workload signatures are, in bucket steps.

    0.0 for identical signatures; for two signatures of one family (the same
    field names) the summed |log2| gap of their numeric fields; different
    families (or unparseable signatures) are infinitely far apart.
    """
    if a == b:
        return 0.0
    fa, fb = _sig_fields(a), _sig_fields(b)
    if not fa or not fb or set(fa) != set(fb):
        return math.inf
    return sum(abs(math.log2(max(fa[k], 1)) - math.log2(max(fb[k], 1))) for k in fa)


_STORE_TOKENS = itertools.count(1)


class ConfigStore:
    """Persistent, context-keyed store of optimized configurations.

    Layout: ``<root>/<component>.json`` holding ``{"component": ...,
    "entries": [{"context": {...}, "settings": {...}, "provenance": {...}}]}``.
    Writes are atomic (tmp file + rename) under an exclusive file lock, so a
    concurrent reader never sees a torn file and two writers merge.
    ``generation`` bumps on every in-process mutation and is part of the
    resolver cache key.
    """

    def __init__(self, root: Any = DEFAULT_ROOT):
        self.root = Path(root)
        self.token = next(_STORE_TOKENS)  # distinguishes stores in the resolver cache
        self.generation = 0
        self._cache: Dict[str, List[Dict[str, Any]]] = {}
        self._overrides: Dict[Tuple[str, str], Dict[str, Any]] = {}

    # -- file layer -----------------------------------------------------------
    def _path(self, component: str) -> Path:
        return self.root / f"{component}.json"

    def _entries(self, component: str) -> List[Dict[str, Any]]:
        if component not in self._cache:
            p = self._path(component)
            entries: List[Dict[str, Any]] = []
            if p.exists():
                # A corrupted file degrades to the defaults tier rather than
                # failing the caller: resolution is an optimization layer.
                try:
                    doc = json.loads(p.read_text())
                    entries = doc.get("entries", []) if isinstance(doc, dict) else []
                except (json.JSONDecodeError, OSError) as e:
                    print(f"[configstore] ignoring unreadable {p}: {e}")
            self._cache[component] = entries
        return self._cache[component]

    def _write(self, component: str, entries: List[Dict[str, Any]]) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        doc = json.dumps({"component": component, "entries": entries}, indent=1)
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=f".{component}.")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(doc)
            os.replace(tmp, self._path(component))
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        self._cache[component] = entries
        self.generation += 1

    def invalidate(self, component: Optional[str] = None) -> None:
        """Drop the in-memory entry cache (picks up other processes' writes)."""
        if component is None:
            self._cache.clear()
        else:
            self._cache.pop(component, None)
        self.generation += 1

    # -- write paths ----------------------------------------------------------
    def put(self, context: Context, settings: Dict[str, Any],
            provenance: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Unconditional write; replaces the entry with the identical context.
        The read-modify-write runs under an exclusive file lock with the
        on-disk entries re-read inside it."""
        prov = dict(provenance or {})
        prov.setdefault("updated", time.time())
        entry = {"context": context.to_dict(), "settings": dict(settings), "provenance": prov}
        ctx_d = context.to_dict()
        self.root.mkdir(parents=True, exist_ok=True)
        with contextlib.ExitStack() as stack:
            if fcntl is not None:
                lf = stack.enter_context(open(self.root / f".{context.component}.lock", "w"))
                fcntl.flock(lf, fcntl.LOCK_EX)
            self._cache.pop(context.component, None)  # re-read disk under the lock
            entries = [e for e in self._entries(context.component) if e["context"] != ctx_d]
            entries.append(entry)
            self._write(context.component, entries)
        return entry

    def promote(self, context: Context, settings: Dict[str, Any], *,
                rpi: Any = None, metrics: Optional[Dict[str, float]] = None,
                baseline: Optional[List[float]] = None,
                samples: Optional[List[float]] = None,
                mode: str = "min", tolerance: float = 0.05, alpha: float = 0.05,
                provenance: Optional[Dict[str, Any]] = None) -> bool:
        """Validated write behind two optional gates:

          * ``rpi`` + ``metrics`` — the envelope check
            (:meth:`repro_torch.core.rpi.RPI.check`): a metric outside its
            bounds, or missing, rejects;
          * ``baseline`` + ``samples`` — the :func:`stats.compare` gate: the
            config is rejected only on a statistically significant
            regression beyond ``tolerance``; samples too few for the test to
            reach ``alpha`` never reject.  The comparator's verdict is
            recorded in provenance.

        Returns True on promotion; on rejection the store is untouched."""
        if rpi is not None and not rpi.check(metrics or {}):
            return False
        prov = dict(provenance or {})
        if baseline is not None and samples is not None:
            from . import stats  # local: stats imports nothing from here

            cmp = stats.compare(baseline, samples, alpha=alpha,
                                min_effect=tolerance, mode=mode)
            verdict = cmp.verdict
            if verdict != "noise" and cmp.p_value is None:
                verdict = "insufficient_data"  # evidence-free shift: no veto
            elif verdict == "regressed":
                return False
            prov.setdefault("gate", {"verdict": verdict,
                                     "effect": cmp.effect,
                                     "p_value": cmp.p_value})
        self.put(context, settings, prov)
        return True

    # -- read paths -----------------------------------------------------------
    def resolve_entry(self, query: Context) -> Optional[Dict[str, Any]]:
        """Best-matching entry via the fallback chain, or None."""
        best: Optional[Dict[str, Any]] = None
        best_key: Tuple = ()
        for e in self._entries(query.component):
            rank = _match_rank(e["context"], query)
            if rank is None:
                continue
            key = (*rank, e.get("provenance", {}).get("updated", 0.0))
            if best is None or key > best_key:
                best, best_key = e, key
        return best

    def resolve(self, query: Context) -> Optional[Dict[str, Any]]:
        e = self.resolve_entry(query)
        return dict(e["settings"]) if e is not None else None

    def nearest_entry(self, query: Context, *,
                      max_distance: float = math.inf,
                      ) -> Optional[Tuple[Dict[str, Any], float]]:
        """Best warm-start source for a context: ``(entry, workload_distance)``.

        The fallback chain first (distance 0); when it misses, among the
        component's entries of the query's platform the one whose signature
        is the fewest bucket steps away wins, hardware/software match and
        recency breaking ties.  None when nothing is within ``max_distance``.
        """
        hit = self.resolve_entry(query)
        if hit is not None:
            return hit, 0.0
        best: Optional[Dict[str, Any]] = None
        best_key: Tuple = ()
        best_dist = math.inf
        for e in self._entries(query.component):
            ctx = e["context"]
            if not _same_platform(ctx.get("hardware", WILDCARD), query.hardware):
                continue
            dist = workload_distance(ctx.get("workload", WILDCARD), query.workload)
            if not math.isfinite(dist) or dist > max_distance:
                continue
            key = (-dist,
                   int(ctx.get("hardware", WILDCARD) == query.hardware),
                   int(ctx.get("sw", WILDCARD) == query.sw),
                   e.get("provenance", {}).get("updated", 0.0))
            if best is None or key > best_key:
                best, best_key, best_dist = e, key, dist
        return (best, best_dist) if best is not None else None

    # -- in-process override tier ---------------------------------------------
    def set_override(self, component: str, workload: str, kv: Dict[str, Any]) -> None:
        self._overrides.setdefault((component, workload), {}).update(kv)
        self.generation += 1

    def get_override(self, component: str, workload: str) -> Optional[Dict[str, Any]]:
        ov = self._overrides.get((component, workload))
        return dict(ov) if ov is not None else None

    def clear_override(self, component: str, workload: str) -> None:
        if self._overrides.pop((component, workload), None) is not None:
            self.generation += 1

    def contexts(self) -> List[Tuple[str, str]]:
        """(component, workload) pairs with any stored or overridden state."""
        out: List[Tuple[str, str]] = []
        if self.root.exists():
            for p in sorted(self.root.glob("*.json")):
                comp = p.stem
                for e in self._entries(comp):
                    pair = (comp, e["context"].get("workload", WILDCARD))
                    if pair not in out:
                        out.append(pair)
        for pair in self._overrides:
            if pair not in out:
                out.append(pair)
        return out


# -- process-default store + cached resolver (the per-call hot path) ----------
_DEFAULT: Optional[ConfigStore] = None


def default_store() -> ConfigStore:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ConfigStore()
    return _DEFAULT


def set_default_store(store: Optional[ConfigStore]) -> Optional[ConfigStore]:
    """Swap the process-default store (tests / embedding); returns the old one."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, store
    _cached_lookup.cache_clear()
    return old


def invalidate_cache() -> None:
    """Drop resolver + store caches — call after another process wrote."""
    if _DEFAULT is not None:
        _DEFAULT.invalidate()
    _cached_lookup.cache_clear()


def set_override(component: str, workload: str, kv: Dict[str, Any]) -> None:
    """Pin values for one (component, workload) in the default store's
    in-process override tier: the operator's hand on the dial, never
    persisted."""
    default_store().set_override(component, workload, kv)


def clear_override(component: str, workload: str) -> None:
    default_store().clear_override(component, workload)


@functools.lru_cache(maxsize=4096)
def _cached_lookup(token: int, generation: int, component: str, workload: str,
                   hardware: str, sw: str,
                   ) -> Optional[Tuple[Tuple[Tuple[str, Any], ...], Tuple[Tuple[str, Any], ...]]]:
    """The memoized store lookup: (stored-entry items, override items), keyed
    on (store token, generation) so any write, override or invalidate
    misses; hashable item tuples, so a caller cannot corrupt a cache hit."""
    store = default_store()
    entry = store.resolve(Context(component, workload, hardware, sw))
    override = store.get_override(component, workload)
    if entry is None and override is None:
        return None
    return (tuple((entry or {}).items()), tuple((override or {}).items()))


def resolve_settings(component: str, workload: str = WILDCARD,
                     defaults: Optional[Dict[str, Any]] = None,
                     explicit: Optional[Dict[str, Any]] = None,
                     hardware: Optional[str] = None,
                     sw: Optional[str] = None,
                     space: Any = None) -> Dict[str, Any]:
    """Settings for a (component, workload) context, on this process's
    hardware/software unless ``hardware``/``sw`` pin other coordinates.
    Tiers, strongest first:

      1. the in-process override for exactly this context (:func:`set_override`);
      2. ``explicit`` — values set on the component instance this process;
      3. the stored entry (fallback chain);
      4. ``defaults`` — the declared tunable defaults.

    A stored entry is written by another process or version and is not
    trusted: with ``space`` (the component's :class:`TunableSpace`) its
    unknown keys and out-of-domain values drop, so the lower tiers show
    through.  Overrides are not filtered: the caller validates them.
    """
    store = default_store()
    res = _cached_lookup(store.token, store.generation, component, workload,
                         hardware or hardware_fingerprint(), sw or sw_fingerprint())
    merged = dict(defaults or {})
    if res is not None:
        merged.update(_sanitized(res[0], space))
    merged.update(explicit or {})
    if res is not None:
        merged.update(res[1])
    return merged


def _sanitized(items: Tuple[Tuple[str, Any], ...], space: Any) -> Dict[str, Any]:
    if space is None:
        return dict(items)
    out = {}
    for k, v in items:
        if k not in space:
            continue
        try:
            out[k] = space[k].validate(v)
        except (TypeError, ValueError):
            continue
    return out
