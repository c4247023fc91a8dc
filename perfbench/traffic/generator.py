"""The one generator of every traffic mix; a mix is a JSON file of parameters
beside this module (``<mix>.json``).

Serving mixes (``"kind": "serve"``) are a resized copy of
``repro_torch/runtime/traffic.py``: ``heavy_tail``'s lognormal lengths (there
prompts of median 8 tokens from a vocabulary of 250; here the file's
median, spread and clip, ids uniform over ``token_low .. vocab − 1``) and
``replay``'s open loop, which stamps each request with its *scheduled*
arrival.  Every seed replays the same schedule: each block of ``block``
consecutive requests holds the same ``block`` quantiles of the length
distributions (and, open loop, of the exponential gaps, scaled so that a
block's mean gap is exactly 1 / rate), in an order drawn from the mix's own
``order_seed``; the token ids are the seed's own.  Arrivals are thus a
stratified replay, not Poisson draws: no burst outlasts a block.  (Drawn from the run's
seed, the order moved a 40 s window's p95 time to first token by 15% and
its tokens/s by 2.5% between seeds, where two runs of one seed agreed
within 2% and 0.6%.)

Training mixes (``"kind": "lm_batches"``) give step ``i`` a batch of
``batch`` rows of ``seq + 1`` ids drawn on the card from the seed and the
step (rows all differ), split into tokens and next-token labels.
"""
from __future__ import annotations

import hashlib
import math
from statistics import NormalDist
from typing import Any, Dict, List, Tuple

import numpy as np


def _seed(seed: int, *stream: Any) -> int:
    key = ":".join(str(s) for s in (seed,) + stream)
    return int(hashlib.sha256(key.encode()).hexdigest()[:15], 16)


def bucket_pow2(n: int) -> int:
    """``n`` rounded up to a power of two (the server's width buckets)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def prompt_width(n: int, capacity: int) -> int:
    """The width a prompt of ``n`` tokens is padded to: its last
    ``capacity // 2`` tokens kept, rounded up to a power of two, at least 2
    (the server's scheduler contract)."""
    return max(2, bucket_pow2(min(n, max(2, capacity // 2))))


def lognormal_quantiles(dist: Dict[str, float], n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of a lognormal (``median``, ``sigma``), clipped
    to ``min`` .. ``max`` and rounded to whole tokens."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of an exponential gap, scaled to mean 1 / rate."""
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    return g / g.mean() / rate


class ServeMix:
    """Requests of a serving mix for one seed: ``request(i)`` → (prompt ids,
    output budget), ``arrival(i)`` → scheduled seconds from the start (open
    loop)."""

    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int):
        if mix["kind"] != "serve":
            raise ValueError(f"not a serving mix: {mix['kind']!r}")
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.block = int(mix["block"])
        self.loop = mix["loop"]
        self._prompt_q = lognormal_quantiles(mix["prompt"], self.block)
        self._output_q = lognormal_quantiles(mix["output"], self.block)
        self._blocks: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._times: List[float] = [0.0]

    def _block(self, b: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if b not in self._blocks:
            rng = np.random.default_rng(_seed(self.mix["order_seed"], "block", b))
            gaps = (exponential_gaps(self.mix["rate_per_s"], self.block)
                    if self.loop == "open" else np.zeros(self.block))
            self._blocks[b] = (rng.permutation(self._prompt_q), rng.permutation(self._output_q),
                               rng.permutation(gaps))
        return self._blocks[b]

    def request(self, i: int) -> Tuple[np.ndarray, int]:
        prompts, outputs, _ = self._block(i // self.block)
        j = i % self.block
        rng = np.random.default_rng(_seed(self.seed, "tokens", i))
        ids = rng.integers(self.mix["token_low"], self.vocab, size=int(prompts[j]))
        return ids.astype(np.int32), int(outputs[j])

    def arrival(self, i: int) -> float:
        """Scheduled arrival of request ``i``: the sum of the gaps before it
        (the first gap precedes request 0)."""
        while len(self._times) <= i + 1:
            k = len(self._times) - 1
            self._times.append(self._times[-1] + float(self._block(k // self.block)[2][k % self.block]))
        return self._times[i + 1]

    def widths(self, capacity: int) -> List[int]:
        """Every prompt width the mix can give the server."""
        lo, hi = self.mix["prompt"]["min"], self.mix["prompt"]["max"]
        return sorted({prompt_width(n, capacity) for n in
                       [lo, hi] + [1 << k for k in range(1, 31) if lo <= 1 << k <= hi]})


class LMBatches:
    """Training batches of a ``lm_batches`` mix for one seed."""

    def __init__(self, mix: Dict[str, Any], vocab: int, seed: int):
        if mix["kind"] != "lm_batches":
            raise ValueError(f"not a training mix: {mix['kind']!r}")
        self.batch, self.seq = int(mix["batch"]), int(mix["seq"])
        self.low, self.vocab, self.seed = int(mix["token_low"]), vocab, seed

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def batch_at(self, step: int, device) -> Dict[str, Any]:
        """{"tokens", "labels"} of step ``step`` (0-based), (batch, seq) each."""
        import torch

        gen = torch.Generator(device=device)
        gen.manual_seed(_seed(self.seed, "batch", step))
        ids = torch.randint(self.low, self.vocab, (self.batch, self.seq + 1), generator=gen,
                            device=device)
        return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def check_mix(mix: Dict[str, Any]) -> None:
    """Raise if a serving mix's lengths cannot be served as stated."""
    for part in ("prompt", "output"):
        d = mix[part]
        if not (1 <= d["min"] <= d["median"] <= d["max"]) or d["sigma"] < 0:
            raise ValueError(f"{part}: need 1 <= min <= median <= max and sigma >= 0; got {d}")
    if mix["loop"] not in ("open", "closed"):
        raise ValueError(f"loop must be open or closed; got {mix['loop']!r}")
    if mix["loop"] == "open" and not (mix["rate_per_s"] > 0 and math.isfinite(mix["rate_per_s"])):
        raise ValueError("an open loop needs a positive rate_per_s")
