"""Fleet tuning campaigns: drive a component × workload grid to completion.

The port of ``repro/core/campaign.py``.  A :class:`Campaign` takes a
declarative grid of :class:`CampaignCell`\\ s and drives them all:

  * **One mux, one round at a time** — every cell is a
    :class:`~repro_torch.core.agent.TuningSession` behind one
    :class:`~repro_torch.core.agent.AgentMux`; each round measures every
    pending proposal and feeds the batch to ``observe_batch``.
  * **Warm-start transfer** — a new cell seeds its optimizer with the
    observations of the nearest stored context
    (:meth:`ConfigStore.nearest_entry`, which never crosses a hardware
    platform).  Priors never count as evaluations.
  * **Resumable journal** — every evaluation and cell completion appends to
    ``results/campaign/<id>.jsonl`` (append-only, schema-versioned); a
    campaign resumed under the same id skips completed cells exactly, with
    no re-measurement.
  * **Gated promotion** — each finished cell's best enters the
    :class:`ConfigStore` behind the ``stats.compare`` gate against the
    cell's default-config baseline, with campaign provenance and its top
    observations (what future cells warm-start from).

Two additions to the reference:

  * ``pin`` on a cell fixes some tunables (the ``kernels`` grid pins
    ``impl="kernel"`` on the card): the session searches the rest of the
    space, every measured and promoted config carries the pinned values,
    and a proposal that contradicts a pin raises.  Off unless a cell
    declares one.
  * A timed measure gets a gate that can decide.  The reference gates the
    start-of-cell baseline against the best's own history samples, often a
    single one, for which ``compare`` computes no p-value and judges by
    effect size alone.  When the cell's two baseline samples differ (the
    measure is noisy, as a timing is), the default config and the best
    are measured :data:`GATE_REPS` times each, interleaved, after the
    session, and those samples feed the gate.  A deterministic measure
    (equal baseline samples, as the demo components give) keeps the
    reference's gate, so the parity tests hold the port's promotions to
    the reference's; interleaved repeats of a constant would only make the
    median permutation test blind (p ≈ 0.6 on tied samples).

The driver is deterministic given the cells' seeds and a deterministic
``measure``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import stats
from .agent import AgentMux, TuningSession, make_session
from .codegen import pack_telemetry
from .configstore import ConfigStore, Context, context_for, default_store
from .registry import get_component

__all__ = ["CampaignCell", "CellResult", "CampaignJournal", "Campaign",
           "evals_to_reach", "CAMPAIGN_SCHEMA_VERSION", "CAMPAIGN_ROOT"]

CAMPAIGN_SCHEMA_VERSION = 1
CAMPAIGN_ROOT = Path(__file__).resolve().parents[3] / "results" / "campaign"
# How many of a finished session's observations ride along in provenance as
# warm-start fuel for future cells (best-first).
N_TRANSFER_OBSERVATIONS = 8
# Default-config measurements journaled at each cell's start: the gate's A
# side when they agree, the sign of a noisy measure when they differ.
BASELINE_REPS = 2
# Interleaved default/best measurements that feed a noisy measure's gate.
GATE_REPS = 8


@dataclasses.dataclass(frozen=True)
class CampaignCell:
    """One grid cell: tune ``component`` under ``workload``.

    ``cell_id`` (``component@workload``) keys the journal.  ``pin`` holds
    (tunable, value) pairs the cell does not search.
    """

    component: str
    workload: str
    objective: str
    mode: str = "min"
    optimizer: str = "bo"
    budget: int = 16
    samples_per_config: int = 1
    seed: int = 0
    pin: Tuple[Tuple[str, Any], ...] = ()

    @property
    def cell_id(self) -> str:
        return f"{self.component}@{self.workload}"

    def context(self) -> Context:
        return context_for(self.component, self.workload)

    def with_pin(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """``config`` with the pinned values; raises if it contradicts one."""
        out = dict(config)
        for k, v in self.pin:
            if k in out and out[k] != v:
                raise ValueError(f"{self.cell_id}: proposal {k}={out[k]!r} contradicts the "
                                 f"pinned {k}={v!r}")
            out[k] = v
        return out

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["pin"] = dict(self.pin)
        return d


@dataclasses.dataclass
class CellResult:
    """Outcome of one cell — live-run or reconstructed from the journal."""

    cell: CampaignCell
    best_config: Dict[str, Any]
    best_value: float                   # raw objective (mode applied back)
    values: List[float]                 # raw objective per evaluation, in order
    evaluations: int
    promoted: bool
    warm_start: Optional[Dict[str, Any]] = None  # {source_workload, distance, n_prior}
    resumed: bool = False               # reconstructed from the journal, not re-run
    baseline: Optional[List[float]] = None       # default-config samples
    gate: Optional[Dict[str, Any]] = None        # the comparator's verdict

    def evals_to_reach(self, target: float, tol: float = 0.05) -> Optional[int]:
        return evals_to_reach(self.values, target, mode=self.cell.mode, tol=tol)


def evals_to_reach(values: Sequence[float], target: float, *,
                   mode: str = "min", tol: float = 0.05) -> Optional[int]:
    """1-based index of the first evaluation within relative ``tol`` of
    ``target``, or None if the trace never gets there."""
    slack = tol * max(abs(target), 1e-12)
    for i, v in enumerate(values):
        good = v <= target + slack if mode == "min" else v >= target - slack
        if good:
            return i + 1
    return None


class CampaignJournal:
    """Append-only, schema-versioned campaign event log (one JSONL per id).

    O_APPEND single-line writes; readers skip torn lines and lines of an
    unknown schema version, so a newer writer cannot brick an older resume.
    """

    def __init__(self, campaign_id: str, root: Any = CAMPAIGN_ROOT):
        self.campaign_id = campaign_id
        self.path = Path(root) / f"{campaign_id}.jsonl"

    def append(self, kind: str, **fields: Any) -> Dict[str, Any]:
        row = {"schema": CAMPAIGN_SCHEMA_VERSION, "kind": kind,
               "campaign": self.campaign_id, "timestamp": time.time(), **fields}
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
                if isinstance(row, dict) and row.get("schema") == CAMPAIGN_SCHEMA_VERSION:
                    out.append(row)
        return out

    def completed(self) -> Dict[str, Dict[str, Any]]:
        """cell_id → its ``cell_done`` row (the resume skip-list)."""
        return {r["cell_id"]: r for r in self.rows() if r.get("kind") == "cell_done"}


class Campaign:
    """Drive a grid of cells to completion through one AgentMux.

    ``measure(cell, settings) -> {metric: value}`` runs one evaluation of
    ``settings`` under the cell's workload and returns the component's full
    metric dict.  ``store`` defaults to the process default ConfigStore;
    ``warm_start=False`` forces cold starts.  :data:`BASELINE_REPS`
    default-config measurements per cell are journaled at the cell's start;
    which samples feed the gate is set out in the module docstring.
    ``rpi_lookup(component, workload) -> RPI | None`` adds the envelope
    gate: a cell's best objective outside its RPI's bounds is not promoted.
    """

    def __init__(
        self,
        cells: Sequence[CampaignCell],
        measure: Callable[[CampaignCell, Dict[str, Any]], Dict[str, float]],
        *,
        campaign_id: Optional[str] = None,
        store: Optional[ConfigStore] = None,
        journal_root: Any = CAMPAIGN_ROOT,
        warm_start: bool = True,
        rpi_lookup: Optional[Callable[[str, str], Any]] = None,
    ):
        ids = [c.cell_id for c in cells]
        if len(set(ids)) != len(ids):
            dupes = sorted({i for i in ids if ids.count(i) > 1})
            raise ValueError(f"duplicate campaign cells {dupes}")
        self.cells = list(cells)
        self.measure = measure
        self.campaign_id = campaign_id or f"campaign-{os.getpid()}-{int(time.time())}"
        self.store = store if store is not None else default_store()
        self.journal = CampaignJournal(self.campaign_id, root=journal_root)
        self.warm_start = warm_start
        self.rpi_lookup = rpi_lookup
        self.measure_calls = 0

    @staticmethod
    def _defaults(cell: CampaignCell) -> Dict[str, Any]:
        """The default config the gate compares against: the declared
        defaults with the cell's pinned values."""
        return {**get_component(cell.component).space.defaults(), **dict(cell.pin)}

    def _measure(self, cell: CampaignCell, config: Dict[str, Any]) -> Dict[str, float]:
        self.measure_calls += 1
        return self.measure(cell, cell.with_pin(config))

    # -- warm start -----------------------------------------------------------
    def _prior_for(self, cell: CampaignCell) -> Tuple[Optional[List[Dict[str, Any]]],
                                                      Optional[Dict[str, Any]]]:
        """(session prior, warm_start info) from the nearest stored context:
        the source's recorded observations, or its settings and best
        objective as one prior point.  Pinned keys are dropped: the session
        does not search them."""
        if not self.warm_start:
            return None, None
        found = self.store.nearest_entry(cell.context())
        if found is None:
            return None, None
        entry, dist = found
        prov = entry.get("provenance", {})
        obs = [o for o in prov.get("observations", [])
               if isinstance(o, dict) and "config" in o and "value" in o]
        if not obs and prov.get("best_objective") is not None:
            obs = [{"config": entry["settings"], "value": prov["best_objective"]}]
        if not obs:
            return None, None
        pinned = dict(cell.pin)
        obs = [{"config": {k: v for k, v in o["config"].items() if k not in pinned},
                "value": o["value"]} for o in obs]
        info = {"source_workload": entry["context"].get("workload"),
                "distance": dist, "n_prior": len(obs)}
        return obs, info

    # -- promotion ------------------------------------------------------------
    def _promote(self, cell: CampaignCell, core: Any, baseline: List[float],
                 warm_info: Optional[Dict[str, Any]]) -> Tuple[bool, Optional[Dict[str, Any]],
                                                               List[float]]:
        """Gate and persist the cell's best; returns (promoted, gate, the
        default-config samples the gate compared against)."""
        best = core.opt.best
        sign = -1.0 if cell.mode == "max" else 1.0
        best_raw = sign * best.value
        best_config = cell.with_pin(best.config)
        ranked = sorted(core.opt.history, key=lambda o: o.value)
        observations = [{"config": cell.with_pin(o.config), "value": sign * o.value}
                        for o in ranked[:N_TRANSFER_OBSERVATIONS]]
        if len(set(baseline)) > 1:      # a noisy measure: interleaved samples
            defaults = self._defaults(cell)
            baseline, best_samples = [], []
            for _ in range(GATE_REPS):
                baseline.append(float(self._measure(cell, defaults)[cell.objective]))
                best_samples.append(float(self._measure(cell, best_config)[cell.objective]))
        else:
            best_samples = [sign * o.value for o in core.opt.history
                            if o.config == best.config] or [best_raw]
        gate = None
        if baseline:
            cmp = stats.compare(baseline, best_samples, mode=cell.mode)
            gate = {"verdict": cmp.verdict, "effect": cmp.effect, "p_value": cmp.p_value,
                    "baseline": baseline, "samples": best_samples}
        provenance = {
            "campaign": self.campaign_id,
            "cell": cell.cell_id,
            "budget": cell.budget,
            "evaluations": core.evaluations,
            "objective": cell.objective,
            "best_objective": best_raw,
            "warm_start": warm_info,
            "observations": observations,
        }
        rpi = self.rpi_lookup(cell.component, cell.workload) if self.rpi_lookup else None
        promoted = self.store.promote(
            cell.context(), best_config,
            rpi=rpi, metrics={cell.objective: best_raw},
            baseline=baseline or None, samples=best_samples if baseline else None,
            mode=cell.mode, provenance=provenance)
        return promoted, gate, baseline

    # -- resume ---------------------------------------------------------------
    def _resumed_results(self) -> Dict[str, CellResult]:
        out: Dict[str, CellResult] = {}
        by_id = {c.cell_id: c for c in self.cells}
        for cell_id, row in self.journal.completed().items():
            cell = by_id.get(cell_id)
            if cell is None:
                continue  # journal knows cells this grid no longer names
            out[cell_id] = CellResult(
                cell=cell, best_config=row["best_config"],
                best_value=row["best_value"], values=list(row.get("values", [])),
                evaluations=row.get("evaluations", len(row.get("values", []))),
                promoted=bool(row.get("promoted")),
                warm_start=row.get("warm_start"), resumed=True,
                baseline=row.get("baseline"), gate=row.get("gate"))
        return out

    # -- drive ----------------------------------------------------------------
    def run(self) -> Dict[str, CellResult]:
        results = self._resumed_results()
        todo = [c for c in self.cells if c.cell_id not in results]
        self.journal.append("campaign_start", cells=len(self.cells),
                            resumed=len(results), grid=[c.to_dict() for c in todo])
        if not todo:
            return results

        # One session per cell behind one mux; instance ids per component
        # keep the (component_id, instance_id) demux keys unique.
        sessions: List[TuningSession] = []
        by_key: Dict[Tuple[int, int], CampaignCell] = {}
        warm: Dict[str, Optional[Dict[str, Any]]] = {}
        baselines: Dict[str, List[float]] = {}
        next_iid: Dict[str, int] = {}
        for cell in todo:
            meta = get_component(cell.component)
            iid = next_iid.get(cell.component, 0)
            next_iid[cell.component] = iid + 1
            prior, info = self._prior_for(cell)
            warm[cell.cell_id] = info
            pinned = dict(cell.pin)
            space = (meta.space.subset([n for n in meta.space.names if n not in pinned])
                     if pinned else None)
            session = make_session(
                meta, cell.objective, workload=cell.workload, space=space,
                mode=cell.mode, optimizer=cell.optimizer, budget=cell.budget,
                samples_per_config=cell.samples_per_config, seed=cell.seed,
                instance_id=iid, prior=prior)
            sessions.append(session)
            by_key[(meta.component_id, iid)] = cell
            # Default-config baseline: the gate's A side (or the sign of a
            # noisy measure) and the "was tuning worth it" anchor, journaled.
            defaults = self._defaults(cell)
            base = [float(self._measure(cell, defaults)[cell.objective])
                    for _ in range(BASELINE_REPS)]
            baselines[cell.cell_id] = base
            self.journal.append("cell_start", cell_id=cell.cell_id,
                                cell=cell.to_dict(), warm_start=info,
                                baseline=base)

        mux = AgentMux(sessions)
        metas = {c.component: get_component(c.component) for c in todo}
        traces: Dict[str, List[float]] = {c.cell_id: [] for c in todo}
        pending: Dict[Tuple[int, int], Dict[str, Any]] = {}

        def handle(raw: bytes) -> None:
            msg = json.loads(raw.decode())
            if msg["type"] == "config_update":
                meta = metas[msg["component"]]
                pending[(meta.component_id, msg["instance"])] = msg["settings"]
            elif msg["type"] == "session_report":
                meta = metas[msg["component"]]
                key = (meta.component_id, msg["instance"])
                cell = by_key[key]
                core = mux.cores[key]
                promoted, gate, base = self._promote(cell, core, baselines[cell.cell_id],
                                                     warm[cell.cell_id])
                sign = -1.0 if cell.mode == "max" else 1.0
                result = CellResult(
                    cell=cell, best_config=cell.with_pin(core.opt.best.config),
                    best_value=sign * core.opt.best.value,
                    values=traces[cell.cell_id], evaluations=core.evaluations,
                    promoted=promoted, warm_start=warm[cell.cell_id],
                    baseline=base, gate=gate)
                results[cell.cell_id] = result
                self.journal.append(
                    "cell_done", cell_id=cell.cell_id,
                    best_config=result.best_config, best_value=result.best_value,
                    values=result.values, evaluations=result.evaluations,
                    promoted=promoted, warm_start=warm[cell.cell_id],
                    baseline=base, gate=gate)

        for cmd in mux.start_commands():
            handle(cmd)
        while not mux.done:
            # One round: measure every pending proposal, then feed the batch.
            round_payloads: List[bytes] = []
            for key, core in mux.cores.items():
                cfg = pending.pop(key, None)
                if cfg is None or core.done:
                    continue
                cell = by_key[key]
                samples = []
                for _ in range(cell.samples_per_config):
                    metrics = self._measure(cell, cfg)
                    samples.append(float(metrics[cell.objective]))
                    self.journal.append("eval", cell_id=cell.cell_id,
                                        config=cell.with_pin(cfg), value=samples[-1])
                    round_payloads.append(pack_telemetry(
                        metas[cell.component], key[1], metrics))
                # One trace point per evaluation: the mean the optimizer is told.
                traces[cell.cell_id].append(sum(samples) / len(samples))
            if not round_payloads:
                break  # every live session is mid-ask: cannot make progress
            for out in mux.observe_batch(round_payloads):
                handle(out)
        for rep in mux.final_reports():
            handle(rep)
        self.journal.append("campaign_done", cells=len(results),
                            promoted=sum(r.promoted for r in results.values()))
        return results
