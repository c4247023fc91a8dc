"""Paper-faithful demo components: a tunable hash table and a spinlock model.

The port's copy of ``repro/core/smartcomponents.py`` (numpy only), under
the port's component names ``torch_hashtable`` and ``torch_spinlock``.  The
``demo`` campaign grid runs them: a deterministic objective on which the
port's :class:`~repro_torch.core.campaign.Campaign` is held against the
reference's.  The reference's notes follow.

The paper's evaluation (§3) tunes (a) hash tables inside SQL Server
(OpenRowSet / BufferManager instances) and (b) spinlock max-spin, showing the
optimum is workload-dependent.  These components reproduce those experiments
on this container so EXPERIMENTS.md can validate the paper's claims C1–C6
before the JAX-framework tuning (the "beyond paper" part) begins.

* :class:`TunableHashTable` — a real open-addressing table (numpy, round-
  vectorized probing) with tunable bucket count / probing policy / load
  factor.  Latency is actually measured; collisions and memory are app
  metrics; /proc counters supply the OS-counter context (paper Fig. 4).
* :class:`SpinLock` — a deterministic discrete-event model of N threads
  contending on a lock with a tunable max-spin-before-park.  A timing model
  (rather than real threads) is used because the container has one core, so
  real contention cannot be exhibited; the model keeps the paper's Fig. 5
  shape (optimum shifts with critical-section length) and is deterministic,
  which the test suite exploits.  Documented in DESIGN.md §2.
"""
from __future__ import annotations

import heapq
import time
from typing import Any, Dict, Tuple

import numpy as np

from .registry import MetricSpec, tunable_component
from .tunable import Categorical, Int

__all__ = ["TunableHashTable", "SpinLock", "hashtable_workload", "spinlock_workload"]


# =============================================================================
# Hash table
# =============================================================================
_EMPTY = np.int64(-1)


@tunable_component(
    name="torch_hashtable",
    tunables=(
        Int("log2_buckets", default=12, low=8, high=22, description="table size = 2^log2_buckets"),
        Categorical("probe", default="linear", choices=("linear", "quadratic", "double"), description="probing policy"),
        Int("probe_stride", default=1, low=1, high=64, description="linear-probe stride (cache-line tradeoff)"),
    ),
    metrics=(
        MetricSpec("time_us", "d", "measured batch latency"),
        MetricSpec("collisions", "q", "extra probe rounds summed over keys"),
        MetricSpec("memory_bytes", "q", "table footprint"),
        MetricSpec("load_factor_ppm", "q", "occupancy in parts-per-million"),
    ),
)
class TunableHashTable:
    """Open-addressing int64 hash set with round-vectorized batch ops."""

    def __init__(self) -> None:
        self._alloc()

    def _alloc(self) -> None:
        self.n = 1 << self.settings["log2_buckets"]
        self.slots = np.full(self.n, _EMPTY, dtype=np.int64)
        self.count = 0

    def apply_and_rebuild(self, updates: Dict[str, Any]) -> None:
        """Structural settings require a rebuild (the paper's 'costly re-init' class)."""
        self.apply_settings(updates)  # type: ignore[attr-defined]
        self._alloc()

    # -- hashing ---------------------------------------------------------------
    def _h1(self, keys: np.ndarray) -> np.ndarray:
        x = keys.astype(np.uint64)
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
        x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
        return (x ^ (x >> np.uint64(33))) & np.uint64(self.n - 1)

    def _h2(self, keys: np.ndarray) -> np.ndarray:
        x = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
        return ((x >> np.uint64(17)) | np.uint64(1)) & np.uint64(self.n - 1)

    def _step(self, base: np.ndarray, keys: np.ndarray, i: int) -> np.ndarray:
        mode = self.settings["probe"]
        if mode == "linear":
            off = np.uint64(i * self.settings["probe_stride"])
            return (base + off) & np.uint64(self.n - 1)
        if mode == "quadratic":
            return (base + np.uint64((i * i + i) // 2)) & np.uint64(self.n - 1)
        return (base + np.uint64(i) * self._h2(keys)) & np.uint64(self.n - 1)

    # -- batch ops ---------------------------------------------------------------
    def insert(self, keys: np.ndarray, max_rounds: int = 512) -> int:
        """Insert a batch; returns total collision rounds."""
        keys = np.asarray(keys, dtype=np.int64)
        base = self._h1(keys)
        active = np.arange(len(keys))
        collisions = 0
        for i in range(max_rounds):
            if len(active) == 0:
                break
            slots_i = self._step(base[active], keys[active], i).astype(np.int64)
            cur = self.slots[slots_i]
            free = cur == _EMPTY
            dup = cur == keys[active]
            # First-writer-wins within a round: dedupe slot indices.
            if free.any():
                slot_sel = slots_i[free]
                key_sel = keys[active][free]
                uniq, first = np.unique(slot_sel, return_index=True)
                self.slots[uniq] = key_sel[first]
                self.count += len(uniq)
                placed_mask = np.zeros(len(active), dtype=bool)
                placed_idx = np.flatnonzero(free)[first]
                placed_mask[placed_idx] = True
            else:
                placed_mask = np.zeros(len(active), dtype=bool)
            done = placed_mask | dup
            collisions += int((~done).sum())
            active = active[~done]
        return collisions

    def lookup(self, keys: np.ndarray, max_rounds: int = 512) -> Tuple[np.ndarray, int]:
        keys = np.asarray(keys, dtype=np.int64)
        base = self._h1(keys)
        found = np.zeros(len(keys), dtype=bool)
        missing = np.zeros(len(keys), dtype=bool)
        active = np.arange(len(keys))
        collisions = 0
        for i in range(max_rounds):
            if len(active) == 0:
                break
            slots_i = self._step(base[active], keys[active], i).astype(np.int64)
            cur = self.slots[slots_i]
            hit = cur == keys[active]
            empty = cur == _EMPTY
            found[active[hit]] = True
            missing[active[empty]] = True
            keep = ~(hit | empty)
            collisions += int(keep.sum())
            active = active[keep]
        return found, collisions

    @property
    def memory_bytes(self) -> int:
        return int(self.slots.nbytes)

    @property
    def load_factor(self) -> float:
        return self.count / self.n


def hashtable_workload(
    table: TunableHashTable,
    n_keys: int = 20000,
    lookup_ratio: float = 4.0,
    skew: float = 0.0,
    seed: int = 0,
) -> Dict[str, float]:
    """Insert+lookup driver; returns the component's metric dict.

    ``skew`` > 0 draws lookup keys zipf-ish (hot keys), changing the surface
    shape — the paper's workload-dependence claim (C2).
    """
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 1 << 62, size=n_keys, dtype=np.int64)
    n_lookup = int(n_keys * lookup_ratio)
    if skew > 0:
        ranks = rng.zipf(1.0 + skew, size=n_lookup) % n_keys
        lookup_keys = keys[ranks]
    else:
        lookup_keys = keys[rng.integers(0, n_keys, size=n_lookup)]
    t0 = time.perf_counter()
    c1 = table.insert(keys)
    _, c2 = table.lookup(lookup_keys)
    dt = time.perf_counter() - t0
    return {
        "time_us": dt * 1e6,
        "collisions": c1 + c2,
        "memory_bytes": table.memory_bytes,
        "load_factor_ppm": int(table.load_factor * 1e6),
    }


# =============================================================================
# Spinlock
# =============================================================================
@tunable_component(
    name="torch_spinlock",
    tunables=(
        Int("max_spin", default=100, low=1, high=100000, log=True, description="spins before parking"),
    ),
    metrics=(
        MetricSpec("throughput_ops_s", "d"),
        MetricSpec("wasted_spin_ns", "q"),
        MetricSpec("parks", "q"),
    ),
)
class SpinLock:
    """Deterministic contention model: spin up to max_spin, then park."""

    SPIN_NS = 12.0       # cost of one pause-loop iteration
    PARK_NS = 4500.0     # context-switch out
    WAKE_NS = 6000.0     # wake-up latency after release

    def simulate(
        self,
        hold_ns: np.ndarray,
        think_ns: np.ndarray,
        n_ops: int = 4000,
        seed: int = 0,
    ) -> Dict[str, float]:
        """Event simulation of T threads; returns metric dict.

        hold_ns/think_ns: per-thread critical-section and outside-work times.
        """
        rng = np.random.default_rng(seed)
        T = len(hold_ns)
        max_spin_ns = self.settings["max_spin"] * self.SPIN_NS
        free_at = 0.0
        wasted = 0.0
        parks = 0
        done = 0
        # (ready_time, tiebreak, thread)
        heap = [(float(rng.exponential(think_ns[t]) + 1e-9), t, t) for t in range(T)]
        heapq.heapify(heap)
        tb = T
        t_end = 0.0
        while done < n_ops:
            ready, _, th = heapq.heappop(heap)
            wait = max(0.0, free_at - ready)
            if wait <= max_spin_ns:
                acquire = max(ready, free_at)
                wasted += wait
            else:
                parks += 1
                wasted += max_spin_ns
                acquire = max(ready + max_spin_ns + self.PARK_NS, free_at + self.WAKE_NS)
            hold = float(hold_ns[th] * rng.uniform(0.8, 1.2))
            free_at = acquire + hold
            done += 1
            t_end = free_at
            nxt = free_at + float(rng.exponential(think_ns[th]) + 1e-9)
            tb += 1
            heapq.heappush(heap, (nxt, tb, th))
        return {
            "throughput_ops_s": done / max(t_end, 1e-9) * 1e9,
            "wasted_spin_ns": int(wasted),
            "parks": parks,
        }


def spinlock_workload(lock: SpinLock, heavy_ops: int, n_threads: int = 8, seed: int = 0) -> Dict[str, float]:
    """Paper Fig. 5 workload: N-1 light threads + one heavy thread.

    ``heavy_ops`` scales the heavy thread's critical-section length.
    """
    hold = np.full(n_threads, 250.0)
    hold[0] = 250.0 * heavy_ops
    think = np.full(n_threads, 2000.0)
    return lock.simulate(hold, think, seed=seed)
