"""Deterministic synthetic data pipeline: corpus → packing → sharded batches.

The port of ``repro/data/pipeline.py`` (numpy, so a near copy: the same
seed gives the same tokens in both packages).  Its component is
``torch_data_pipeline``.

Built to the same contract a real corpus loader would satisfy:
  * deterministic given (seed, step) — resumable from a checkpointed step
    with zero drift (the batch at step k is a pure function of (seed, k));
  * document packing: variable-length "documents" are packed into fixed
    seq_len windows with -1 label masking across document boundaries;
  * shard-aware: each host slices its own rows of the global batch
    (``host_slice``), matching the dry-run's batch sharding.

``PrefetchingBatcher`` overlaps packing with the train step: a declared
smart component (``torch_data_pipeline``) whose prefetch depth and pack
parallelism are tunables resolved per-context — the right depth depends on
step time vs. pack time, which is exactly what a campaign measures.  The
prefetched stream is bit-identical to the synchronous one (same pure
``batch_at``), so resume determinism is preserved by construction.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.configstore import bucket_pow2
from ..core.registry import MetricSpec, tunable_component
from ..core.tunable import Int

__all__ = ["SyntheticCorpus", "PackedBatcher", "PrefetchingBatcher",
           "pipeline_settings", "workload_signature"]


@tunable_component(
    name="torch_data_pipeline",
    tunables=(
        Int("prefetch_depth", default=2, low=0, high=16),
        Int("pack_workers", default=2, low=1, high=16, log=True),
    ),
    metrics=(MetricSpec("batch_ms", "d"), MetricSpec("stall_ms", "d")),
)
class PipelineSettings:
    pass


pipeline_settings = PipelineSettings()


def workload_signature(global_batch: int, seq_len: int) -> str:
    return f"b{bucket_pow2(max(1, global_batch))}s{bucket_pow2(max(1, seq_len))}"


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    """Zipfian token "documents" with deterministic per-doc RNG."""

    vocab_size: int
    seed: int = 0
    mean_len: int = 512

    def document(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, doc_id]))
        n = max(8, int(rng.exponential(self.mean_len)))
        # Zipf-ish over the vocab, clipped; 0 reserved as BOS
        toks = rng.zipf(1.3, size=n).astype(np.int64)
        toks = np.clip(toks, 1, self.vocab_size - 1).astype(np.int32)
        toks[0] = 0
        return toks


class PackedBatcher:
    """Packs documents into (tokens, labels) windows of ``seq_len``.

    labels[i] = tokens[i+1] within a document; -1 at document boundaries and
    padding.  ``batch_at(step)`` is stateless — the resume contract.
    """

    def __init__(self, corpus: SyntheticCorpus, global_batch: int, seq_len: int,
                 host_slice: Optional[Tuple[int, int]] = None):
        self.corpus = corpus
        self.global_batch = global_batch
        self.seq_len = seq_len
        lo, hi = host_slice or (0, global_batch)
        if not 0 <= lo < hi <= global_batch:
            raise ValueError(f"host_slice {host_slice} outside the global batch {global_batch}")
        self.host_lo, self.host_hi = lo, hi

    def _row(self, row_id: int) -> Tuple[np.ndarray, np.ndarray]:
        s = self.seq_len
        toks = np.full((s,), 0, np.int32)
        labs = np.full((s,), -1, np.int32)
        pos = 0
        doc_id = row_id * 131071  # disjoint doc streams per row
        while pos < s:
            doc = self.corpus.document(doc_id)
            doc_id += 1
            take = min(len(doc), s - pos)
            toks[pos : pos + take] = doc[:take]
            if take > 1:
                labs[pos : pos + take - 1] = doc[1:take]
            pos += take
        return toks, labs

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rows = range(self.host_lo, self.host_hi)
        n = len(rows)
        toks = np.empty((n, self.seq_len), np.int32)
        labs = np.empty((n, self.seq_len), np.int32)
        for i, r in enumerate(rows):
            toks[i], labs[i] = self._row(step * self.global_batch + r)
        return {"tokens": toks, "labels": labs}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchingBatcher:
    """Wraps a :class:`PackedBatcher` with look-ahead packing on a worker pool.

    ``batch_at(step)`` returns exactly what the inner batcher would (bit
    identity is a tested invariant), but rows are packed by ``pack_workers``
    threads and up to ``prefetch_depth`` future steps are packed ahead of the
    consumer.  ``counters`` records stall time (consumer blocked on a batch
    that was not ready) — the raw signal the tuner optimizes away.
    """

    def __init__(self, inner: PackedBatcher,
                 settings: Optional[Dict[str, object]] = None):
        self.inner = inner
        wl = workload_signature(inner.global_batch, inner.seq_len)
        s = pipeline_settings.settings_for(wl)
        o = dict(settings or {})
        self.prefetch_depth = int(o.get("prefetch_depth", s["prefetch_depth"]))
        self.pack_workers = int(o.get("pack_workers", s["pack_workers"]))
        self._pool = ThreadPoolExecutor(max_workers=self.pack_workers,
                                        thread_name_prefix="pack")
        # step -> list of (row_offset, future) chunk futures
        self._pending: Dict[int, List[Tuple[int, Future]]] = {}
        self.counters: Dict[str, float] = {"stall_s": 0.0, "hits": 0, "misses": 0}

    def _schedule(self, step: int) -> None:
        if step in self._pending:
            return
        rows = list(range(self.inner.host_lo, self.inner.host_hi))
        per = max(1, (len(rows) + self.pack_workers - 1) // self.pack_workers)
        chunks = []
        for off in range(0, len(rows), per):
            sub = rows[off : off + per]
            chunks.append((off, self._pool.submit(self._pack_rows, step, sub)))
        self._pending[step] = chunks

    def _pack_rows(self, step: int, rows: List[int]) -> Tuple[np.ndarray, np.ndarray]:
        s = self.inner.seq_len
        toks = np.empty((len(rows), s), np.int32)
        labs = np.empty((len(rows), s), np.int32)
        for i, r in enumerate(rows):
            toks[i], labs[i] = self.inner._row(step * self.inner.global_batch + r)
        return toks, labs

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        ready = step in self._pending and all(f.done() for _, f in self._pending[step])
        self._schedule(step)
        for ahead in range(1, self.prefetch_depth + 1):
            self._schedule(step + ahead)
        # drop look-behind work a resumed consumer will never ask for
        for k in [k for k in self._pending if k < step]:
            for _, f in self._pending.pop(k):
                f.cancel()
        self.counters["hits" if ready else "misses"] += 1
        t0 = time.perf_counter()
        chunks = self._pending.pop(step)
        n = self.inner.host_hi - self.inner.host_lo
        toks = np.empty((n, self.inner.seq_len), np.int32)
        labs = np.empty((n, self.inner.seq_len), np.int32)
        for off, f in chunks:
            t, l = f.result()
            toks[off : off + len(t)] = t
            labs[off : off + len(l)] = l
        if not ready:
            self.counters["stall_s"] += time.perf_counter() - t0
        return {"tokens": toks, "labels": labs}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def close(self) -> None:
        for chunks in self._pending.values():
            for _, f in chunks:
                f.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=False)
