"""Online shadow/canary tuning on the live serve path.

The port of ``repro/runtime/online.py``.  :class:`OnlineTuner` wraps a
continuous-mode :class:`~.serve_loop.BatchedServer` and interposes at sync
boundaries only (it is a drop-in server for :func:`~.traffic.replay` — same
``submit``/``step``/``drain``/``run`` surface):

  * The server's windowed telemetry (``tokens_per_s``, ``p50_latency_s``,
    ``queue_depth`` — one record per sync interval, see
    ``BatchedServer._emit_rolling``) streams into an
    :class:`~repro_torch.core.agent.AgentMux` session built by
    :func:`~repro_torch.core.agent.make_session` over the hot-swappable slice
    of the ``torch_serve_batching`` space.
  * Each optimizer proposal deploys as a **canary**: serve windows alternate
    champion (A) / challenger (B), so drift in offered load lands on both
    sides, and :class:`~repro_torch.core.stats.StreamingAB` turns the window
    pairs into a sequential verdict.
  * ``improved`` → the challenger promotes through
    :func:`~repro_torch.core.agent.promote_session_report` →
    ``ConfigStore.promote`` with the champion's live A-window samples as the
    gate baseline, and becomes the new champion.
  * ``regressed`` → **automatic rollback**: the canary aborts on its first
    proving pair and the champion config is re-applied before the next step,
    i.e. last-known-good is restored within one sync interval.
  * ``noise`` → the champion is retained.

Every transition is journaled append-only and schema-versioned
(:class:`OnlineJournal`: O_APPEND single-line writes, readers skip torn and
future-schema rows).  A killed server resumes exactly: the journal replays
into the champion, the canary sequence number, the remaining canary budget
and a warm-start prior for the optimizer; an orphaned in-flight canary is
rolled back on resume.

Two changes from the reference: the tuner tunes ``torch_serve_batching``,
and its journals live under :data:`ONLINE_ROOT` (the repository's
``results/torch/online/``) with tuner ids ``torch-online-<workload>``, so a
port tuner never resumes the reference's journal for the same workload
string.

Config changes ride :meth:`BatchedServer.apply_config`, which accepts only
shape-free scheduler knobs, so the serve engine's bit-identity and
one-``_host_fetch``-per-interval invariants hold with the tuner in the loop.
On the card a window's tokens/s covers device work: the server reads the
clock after the sync's host fetch, which waits for the device.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..core import stats
from ..core.agent import AgentMux, make_session, promote_session_report
from ..core.codegen import pack_telemetry
from ..core.configstore import default_store
from ..core.registry import get_component
from ..core.stats import StreamingAB
from ..core.tunable import TunableSpace
from .serve_loop import COMPONENT, HOT_SWAP_KNOBS

__all__ = ["OnlineTuner", "OnlineJournal", "ONLINE_SCHEMA_VERSION",
           "DEFAULT_ONLINE_KNOBS", "ONLINE_ROOT", "COMPONENT"]

ONLINE_SCHEMA_VERSION = 1
ONLINE_ROOT = Path(__file__).resolve().parents[3] / "results" / "torch" / "online"

# Default online search slice: the scheduler knobs a live server can absorb
# at a sync boundary without a rebuild (max_batch is shape-baked — offline
# campaigns own it).
DEFAULT_ONLINE_KNOBS = ("admission", "prefill_chunk", "sync_interval")


class OnlineJournal:
    """Append-only, schema-versioned log of online-tuning transitions.

    One JSONL per tuner id under :data:`ONLINE_ROOT`; kinds are
    ``canary_start``, ``canary_verdict``, ``promote``, ``rollback``.  Same
    durability contract as ``CampaignJournal``: O_APPEND single-line writes,
    readers skip torn and unknown-schema rows so a newer writer can never
    brick an older resume.
    """

    def __init__(self, tuner_id: str, root: Any = ONLINE_ROOT):
        self.tuner_id = tuner_id
        self.path = Path(root) / f"{tuner_id}.jsonl"

    def append(self, kind: str, **fields: Any) -> Dict[str, Any]:
        row = {"schema": ONLINE_SCHEMA_VERSION, "kind": kind,
               "tuner": self.tuner_id, "timestamp": time.time(), **fields}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, (json.dumps(row) + "\n").encode())
        finally:
            os.close(fd)
        return row

    def rows(self) -> List[Dict[str, Any]]:
        if not self.path.exists():
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a killed writer: skip, don't brick
                if isinstance(row, dict) and row.get("schema") == ONLINE_SCHEMA_VERSION:
                    out.append(row)
        return out


class OnlineTuner:
    """Shadow/canary tuner wrapped around a live continuous-batching server.

    Drive it exactly like the server it wraps — ``submit``/``step``/``drain``
    /``run``/``begin_run``/``finish_run`` all work, and
    :func:`repro_torch.runtime.traffic.replay` accepts it directly.  All tuning
    happens inside :meth:`step`, between the server's sync boundaries.

    ``budget`` counts canaries (optimizer evaluations); each canary costs
    ``windows_per_eval`` interleaved (champion, challenger) window pairs
    unless a regression aborts it early.  ``objective`` is one of the
    declared ``torch_serve_batching`` metrics (``mode`` orients it: throughput is
    ``"max"``, latency would be ``"min"``).  ``space`` restricts the search —
    it must be a subset of :data:`~.serve_loop.HOT_SWAP_KNOBS`.

    Passing the ``tuner_id`` of a previous (killed) run resumes it from the
    journal: champion restored, canary numbering and remaining budget
    continue, optimizer warm-started from the journaled verdicts.
    """

    def __init__(self, server: Any, *, store: Any = None,
                 tuner_id: Optional[str] = None, journal_root: Any = ONLINE_ROOT,
                 space: Optional[TunableSpace] = None, optimizer: str = "rs",
                 budget: int = 8, windows_per_eval: int = 4,
                 objective: str = "tokens_per_s", mode: str = "max",
                 alpha: float = 0.05, min_effect: float = 0.05, seed: int = 0):
        if server.mode != "continuous":
            raise ValueError("OnlineTuner requires a continuous-mode server "
                             "(gang mode has no sync boundaries to swap at)")
        self.server = server
        self.store = store if store is not None else default_store()
        self.meta = get_component(COMPONENT)
        space = space if space is not None else self.meta.space.subset(DEFAULT_ONLINE_KNOBS)
        bad = [n for n in space.names if n not in HOT_SWAP_KNOBS]
        if bad:
            raise ValueError(f"online space includes non-hot-swappable knobs {bad}; "
                             f"allowed: {list(HOT_SWAP_KNOBS)}")
        self.space = space
        self.objective = objective
        self.mode = mode
        self.alpha = alpha
        self.min_effect = min_effect
        self.windows_per_eval = max(1, int(windows_per_eval))
        self.budget = max(1, int(budget))
        self.tuner_id = tuner_id or f"torch-online-{server.workload}"
        self.journal = OnlineJournal(self.tuner_id, root=journal_root)

        names = space.names
        self.champion: Dict[str, int] = {k: int(server.current_config()[k])
                                         for k in names}
        champion, prior, seq, n_verdicts, orphan = self._replay()
        if champion is not None:
            self.champion = {k: int(v) for k, v in champion.items() if k in names}
        if orphan is not None:
            # killed mid-canary: last-known-good is the champion — record the
            # rollback the dying process never got to write
            self.journal.append("rollback", seq=orphan.get("seq", seq),
                                restored=self.champion, reason="resume_orphaned_canary")
        self._canary_seq = seq
        self._exhausted = n_verdicts >= self.budget
        session = make_session(
            self.meta, objective, workload=server.workload, space=space,
            mode=mode, optimizer=optimizer, budget=max(1, self.budget - n_verdicts),
            samples_per_config=self.windows_per_eval, seed=seed,
            prior=prior or None)
        self.mux = AgentMux([session])
        self.core = next(iter(self.mux.cores.values()))
        self.report: Optional[Dict[str, Any]] = None
        self.promotions = 0
        self.rollbacks = 0
        self._canary: Optional[Dict[str, Any]] = None
        self._next_challenger: Optional[Dict[str, Any]] = None
        self.server.apply_config(self.champion)
        if not self._exhausted:
            self._dispatch(self.mux.start_commands())

    # ------------------------------------------------------- journal resume
    def _replay(self) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]],
                               int, int, Optional[Dict[str, Any]]]:
        champion: Optional[Dict[str, Any]] = None
        prior: List[Dict[str, Any]] = []
        seq = n_verdicts = 0
        orphan: Optional[Dict[str, Any]] = None
        for row in self.journal.rows():
            kind = row.get("kind")
            if kind == "canary_start":
                seq = max(seq, int(row.get("seq", 0)))
                orphan = row
            elif kind == "canary_verdict":
                orphan = None
                n_verdicts += 1
                v = row.get("verdict") or {}
                if "candidate_location" in v and row.get("challenger"):
                    prior.append({"config": row["challenger"],
                                  "value": float(v["candidate_location"])})
            elif kind in ("promote", "rollback"):
                orphan = None
                if kind == "promote" and row.get("settings"):
                    champion = row["settings"]
        return champion, prior, seq, n_verdicts, orphan

    # ---------------------------------------------------------- serve proxy
    def __getattr__(self, name: str) -> Any:
        return getattr(self.server, name)

    def step(self) -> List[Any]:
        syncs_before = self.server.decode_syncs
        self._apply_for_next_window()
        finished = self.server.step()
        if self.server.decode_syncs > syncs_before and self.server.last_window:
            self._on_window(self.server.last_window)
        return finished

    def begin_run(self, max_new_tokens: Optional[int] = None) -> None:
        # An interleaved window pair must never straddle runs: the last
        # window of a drained run (starved slots, cratered tok/s) paired
        # with the first window of a freshly filled queue would read as a
        # spurious challenger win.  Drop the dangling champion sample.
        c = self._canary
        if c is not None and c["phase"] == "B":
            c["phase"] = "A"
        self.server.begin_run(max_new_tokens)

    def drain(self) -> None:
        while self.server.queue or self.server.live_slots:
            self.step()

    def run(self, max_new_tokens: Optional[int] = None) -> Dict[str, float]:
        self.begin_run(max_new_tokens)
        self.drain()
        return self.server.finish_run()

    # --------------------------------------------------------- state machine
    def _apply_for_next_window(self) -> None:
        if self._canary is None and self._next_challenger is not None \
                and not self._exhausted:
            self._canary_seq += 1
            self._canary = {
                "seq": self._canary_seq,
                "challenger": dict(self._next_challenger),
                "phase": "A",
                "a_pending": 0.0,
                "ab": StreamingAB(mode=self.mode, alpha=self.alpha,
                                  min_effect=self.min_effect, min_pairs=1,
                                  max_pairs=self.windows_per_eval),
            }
            self._next_challenger = None
            self.journal.append("canary_start", seq=self._canary_seq,
                                challenger=self._canary["challenger"],
                                champion=self.champion,
                                windows=self.windows_per_eval)
        if self._canary is None:
            cfg = self.champion
        elif self._canary["phase"] == "A":
            cfg = self.champion
        else:
            cfg = {**self.champion, **self._canary["challenger"]}
        self.server.apply_config(cfg)

    def _on_window(self, m: Dict[str, float]) -> None:
        c = self._canary
        if c is None:
            return
        v = float(m[self.objective])
        if c["phase"] == "A":
            c["a_pending"] = v
            c["phase"] = "B"
            return
        c["phase"] = "A"
        cmp_ = c["ab"].add_pair(c["a_pending"], v)
        # stream the challenger's live window to the agent session; on an
        # early abort, the remaining protocol samples are backfilled with the
        # regressed window so the optimizer is told what was measured
        payloads = [self._pack(m)]
        aborted = cmp_.verdict == "regressed"
        if aborted:
            payloads += [self._pack(m)] * (self.windows_per_eval - c["ab"].pairs)
        self._dispatch(self.mux.observe_batch(payloads))
        if aborted or c["ab"].pairs >= self.windows_per_eval:
            self._finalize(cmp_)

    def _finalize(self, cmp_: stats.Comparison) -> None:
        c, self._canary = self._canary, None
        assert c is not None
        self.journal.append("canary_verdict", seq=c["seq"],
                            challenger=c["challenger"], verdict=cmp_.to_dict())
        if cmp_.verdict == "improved":
            if self._promote(c):  # a gate veto journals its own rollback
                self.champion = {**self.champion, **c["challenger"]}
                self.promotions += 1
                self.journal.append("promote", seq=c["seq"], settings=self.champion)
        elif cmp_.verdict == "regressed":
            self.rollbacks += 1
            self.journal.append("rollback", seq=c["seq"], restored=self.champion,
                                reason="regressed")
        # noise: the champion was never displaced — the verdict row is the record.
        # Re-applying the champion here restores last-known-good BEFORE the next
        # decode window, i.e. rollback lands within one sync interval.
        self.server.apply_config(self.champion)

    def _promote(self, c: Dict[str, Any]) -> bool:
        """Promote a winning canary through the one promotion path, with the
        champion's live interleaved samples as the gate baseline."""
        ab: StreamingAB = c["ab"]
        best = stats.median(ab.candidate)
        msg = {
            "type": "session_report",
            "component": self.meta.name,
            "instance": self.core.session.instance_id,
            "best_config": c["challenger"],
            "best_value": -best if self.mode == "max" else best,
            "evaluations": ab.pairs,
            "objective": self.objective,
            "mode": self.mode,
            "budget": self.core.session.budget,
            "context": self.core.session.context,
            "provenance": {"source": "online", "tuner": self.tuner_id,
                           "canary": c["seq"], "windows": ab.pairs},
        }
        ok = promote_session_report(self.store, msg, baseline=ab.baseline,
                                    samples=ab.candidate,
                                    tolerance=self.min_effect, alpha=self.alpha)
        if not ok:
            self.journal.append("rollback", seq=c["seq"], restored=self.champion,
                                reason="gate_rejected")
            self.rollbacks += 1
        return ok

    # ------------------------------------------------------------- plumbing
    def _pack(self, m: Dict[str, float]) -> bytes:
        return pack_telemetry(self.meta, self.core.session.instance_id, m)

    def _dispatch(self, msgs: List[bytes]) -> None:
        for raw in msgs:
            msg = json.loads(raw.decode())
            if msg["type"] == "config_update" and not self.core.done:
                self._next_challenger = msg["settings"]
            elif msg["type"] == "session_report":
                self.report = msg
        if self.core.done:
            # park command = budget exhausted: no further canaries; the
            # champion (already promoted when it won) keeps serving
            self._exhausted = True
            self._next_challenger = None
