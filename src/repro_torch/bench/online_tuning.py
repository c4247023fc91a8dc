"""Online-tuning benchmark: shadow/canary tuning recovers a traffic-mix shift.

The twin of the reference's ``benchmarks/online_tuning.py`` on the port's
server and :class:`~repro_torch.runtime.online.OnlineTuner`.  A server whose
``torch_serve_batching`` config was tuned during a long-completion era
(``sync_interval=16`` amortizes the per-window host sync over requests that
decode for dozens of steps) keeps serving after the mix flips to short chat
turns.  Now every two-token request holds its slot for a full 16-step decode
window, and a freed slot cannot be backfilled until the next sync boundary.
The online tuner runs shadow/canary search against the live post-shift
traffic and promotes a tighter sync cadence through the config store.

Three phases, all seeded, as in the reference:

  1. **adapt** — the tuner wraps a live server on the post-shift traffic;
     canaries run as interleaved champion/challenger windows until a
     challenger promotes (or the canary budget is spent).
  2. **resolve** — the tuned config is read back through
     :func:`repro_torch.core.config.resolve`, as a fresh server would.
  3. **measure** — frozen-vs-tuned serving of the same post-shift arrivals,
     interleaved (``stats.measure_interleaved``); the claim is a
     ``stats.compare`` verdict (mode=max on tokens/s).

Added: the served ``model`` (at full width on the card, reduced on the
CPU: :func:`.load_model`), the ``device``, the canary ``budget`` and
``windows_per_eval``.  The tuner's journal and config store live in a
per-run scratch directory.  :func:`make_tuner` and :func:`adapt` are the
adapt phase on its own, for a caller that brings its own server.

    PYTHONPATH=src python -m repro_torch.bench.online_tuning --quick --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core import config, stats
from ..core.configstore import ConfigStore, set_default_store
from ..core.registry import get_component
from ..runtime import traffic
from ..runtime.online import OnlineTuner
from ..runtime.serve_loop import COMPONENT, BatchedServer, workload_signature
from . import BENCH_ROOT, load_model

CAPACITY = 128
SCENARIO_SEED = 19
# Replayed post-shift slices are replicated so each timed run is long enough
# that scheduler effects dominate OS jitter.
REPLICATE = 4
# Long-completion-era config: with requests decoding for dozens of steps, a
# 16-step window amortizes the host sync — optimal then, structurally
# wasteful after the mix shifts to two-token turns.
SETTINGS_STALE = dict(max_batch=4, admission=4, prefill_chunk=64,
                      sync_interval=16, max_new_tokens=64)
# The online search slice: one shape-free knob, the one the shift mistunes.
ONLINE_KNOBS = ("sync_interval",)


def _server(params, cfg, settings: Dict[str, int], device) -> BatchedServer:
    return BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                         settings=dict(settings), device=device)


def split_arrivals(seed: int, quick: bool):
    """The drifting mix, split at the shift: pre = long completions (the era
    the stale config was tuned in), post = short chat turns, replicated."""
    n = 16 if quick else 24
    arr = traffic.drifting(seed + SCENARIO_SEED, n=n, shift=0.5,
                           long_budget=32 if quick else 40)
    k = n // 2
    return arr[:k], arr[k:] * REPLICATE


def make_tuner(server: BatchedServer, store: ConfigStore, journal_root: Any, *, budget: int,
               windows_per_eval: int, seed: int, tuner_id: Optional[str] = None) -> OnlineTuner:
    """The benchmark's tuner on ``server``: ``rs`` over
    :data:`ONLINE_KNOBS`, max tokens/s.  Canary alpha is lax on purpose: a
    canary is cheap to revert and a winner still has to clear the store's
    gate against the champion's live baseline.  More windows per eval keep
    one drain-tail window (few live slots) from deciding a canary.  A
    ``tuner_id`` already in ``journal_root`` resumes that tuner."""
    return OnlineTuner(server, store=store, journal_root=journal_root, tuner_id=tuner_id,
                       space=get_component(COMPONENT).space.subset(ONLINE_KNOBS),
                       optimizer="rs", budget=budget, windows_per_eval=windows_per_eval,
                       objective="tokens_per_s", mode="max", alpha=0.1, seed=seed)


def adapt(tuner: OnlineTuner, post: List[traffic.Arrival]) -> int:
    """Phase 1: replay the post-shift slice through the tuner until a
    challenger promotes or the canary budget is spent, at most 4 × budget
    replays.  Returns the number of replays."""
    replays = 0
    while tuner.promotions == 0 and not (tuner._exhausted and tuner._canary is None):
        traffic.replay(tuner, post, speed=0.0)
        replays += 1
        if replays >= 4 * tuner.budget:
            break
    return replays


def run(quick: bool = False, seed: int = 7, *, model: str = "olmo-1b", device: Any = "cuda",
        budget: Optional[int] = None, windows_per_eval: int = 6,
        out_dir: Any = BENCH_ROOT) -> Dict[str, Any]:
    """Adapt, resolve, measure; write ``online_tuning.json`` under
    ``out_dir`` and return the same dict."""
    params, cfg = load_model(model, device=device, seed=seed)
    pre, post = split_arrivals(seed, quick)
    budget = budget if budget is not None else (8 if quick else 12)
    reps = 6 if quick else 9
    wl = workload_signature(cfg.family, CAPACITY)

    t0 = time.time()
    traffic.replay(_server(params, cfg, SETTINGS_STALE, device), post[:4])  # warm-up

    with tempfile.TemporaryDirectory(prefix="torch_online_tuning_") as tmp:
        scratch = Path(tmp)
        store = ConfigStore(root=scratch / "store")

        # -- phase 1: adapt -------------------------------------------------
        tuner = make_tuner(_server(params, cfg, SETTINGS_STALE, device), store,
                           scratch / "journal", budget=budget,
                           windows_per_eval=windows_per_eval, seed=seed)
        adapt_replays = adapt(tuner, post)
        transitions = [r["kind"] for r in tuner.journal.rows()]

        # -- phase 2: resolve through the facade ----------------------------
        prev = set_default_store(store)
        try:
            resolved = config.resolve(COMPONENT, wl)
        finally:
            set_default_store(prev)
    tuned = {**SETTINGS_STALE, **{k: int(resolved[k]) for k in ONLINE_KNOBS}}

    # -- phase 3: measure frozen vs tuned on the post-shift traffic ---------
    frozen_srv = _server(params, cfg, SETTINGS_STALE, device)
    tuned_srv = _server(params, cfg, tuned, device)
    totals: Dict[str, set] = {"frozen": set(), "tuned": set()}

    def _replay(side: str, server: BatchedServer) -> float:
        m = traffic.replay(server, post, speed=0.0)
        totals[side].add(m["total_tokens"])
        return m["tokens_per_s"]

    frozen_tok, tuned_tok = stats.measure_interleaved(
        lambda: _replay("frozen", frozen_srv),
        lambda: _replay("tuned", tuned_srv), reps=reps)
    # same offered work on both sides, or the throughput A/B is bogus
    if totals["frozen"] != totals["tuned"] or len(totals["frozen"]) != 1:
        raise AssertionError(f"frozen and tuned served different token totals: {totals}")

    verdict = stats.compare(frozen_tok, tuned_tok, mode="max", seed=seed)
    res: Dict[str, Any] = {
        "quick": quick, "seed": seed, "reps": reps, "model": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "device": str(device), "capacity": CAPACITY, "workload": wl,
        "stale": dict(SETTINGS_STALE), "tuned": tuned,
        "n_pre": len(pre), "n_post": len(post),
        "adapt": {"replays": adapt_replays, "budget": budget,
                  "windows_per_eval": windows_per_eval,
                  "promotions": tuner.promotions, "rollbacks": tuner.rollbacks,
                  "champion": tuner.champion, "transitions": transitions},
        "frozen_tokens_per_s": frozen_tok, "tuned_tokens_per_s": tuned_tok,
        "total_tokens": next(iter(totals["frozen"])),
        "verdict": verdict.to_dict(), "wall_s": time.time() - t0,
    }

    print(f"  adapt: {tuner.promotions} promoted / {tuner.rollbacks} rolled back "
          f"over {adapt_replays} replays → champion {tuner.champion}")
    print(f"  frozen {stats.median(frozen_tok):8.1f} tok/s │ "
          f"online-tuned {stats.median(tuned_tok):8.1f} tok/s")
    print(f"  online-tuned vs frozen verdict: {verdict.describe()}")

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "online_tuning.json").write_text(json.dumps(res, indent=1))
    return res


def bench(quick: bool = False, seed: int = 7, **run_kw: Any) -> list:
    """Runner protocol: the online-tuned side's raw tokens/s samples are the
    tracked series; the frozen side and the adapt phase ride the meta."""
    from ..core.baseline import BenchRecord

    res = run(quick=quick, seed=seed, **run_kw)
    return [BenchRecord.for_component(
        "online_tuning", "post_shift_tokens_per_s", res["tuned_tokens_per_s"],
        COMPONENT, res["workload"], mode="max", unit="tok/s",
        frozen_tokens_per_s=stats.median(res["frozen_tokens_per_s"]),
        vs_frozen=res["verdict"], promotions=res["adapt"]["promotions"],
        rollbacks=res["adapt"]["rollbacks"])]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--model", default="olmo-1b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--budget", type=int, default=None, help="canaries (default 8 quick, 12)")
    ap.add_argument("--windows-per-eval", type=int, default=6)
    ap.add_argument("--out-dir", default=str(BENCH_ROOT))
    args = ap.parse_args(argv)
    res = run(quick=args.quick, seed=args.seed, model=args.model, device=args.device,
              budget=args.budget,
              windows_per_eval=args.windows_per_eval, out_dir=args.out_dir)
    # the claim is a verdict AND a real adaptation: without a promotion,
    # "tuned" is the stale config and any improvement is an accident
    ok = res["verdict"]["verdict"] == "improved" and res["adapt"]["promotions"] >= 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
