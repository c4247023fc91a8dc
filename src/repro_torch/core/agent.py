"""The MLOS agent's in-process core: tuning sessions, their ask/tell logic,
and the multiplexer that drives many of them behind one telemetry stream.

The port of the in-process half of ``repro/core/agent.py``:

  * :class:`TuningSession` — everything the agent needs to tune one
    component instance (JSON-serializable), built by :func:`make_session`;
  * :class:`AgentCore` — one session: consume packed telemetry, aggregate
    per-config samples, step the optimizer, emit config-update commands;
  * :class:`AgentMux` — N cores routed by the ``(component_id,
    instance_id)`` header of each record (:mod:`.codegen`);
  * :func:`drive_session` and :func:`promote_session_report` — the
    single-session driver and the promote half of tune → validate → persist.

Wire protocol (JSON commands, packed structs on telemetry):
``config_update`` {component, instance, settings} and ``session_report``
{component, instance, best_config, best_value, evaluations, objective,
mode, budget, context}.

The spawned agent daemon over shared memory (``AgentProcess``,
``AgentClient``, ``agent_main`` and ``core/channel.py``) is not ported
yet.  Every optimizer here asks on its own (the reference's batched jax
ask has no counterpart).
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .optimizers import make_optimizer
from .registry import ComponentMeta
from .tunable import TunableSpace

__all__ = ["TuningSession", "make_session", "AgentCore", "AgentMux", "drive_session",
           "promote_session_report"]

_HEADER = struct.Struct("<II")  # (component_id, instance_id) telemetry prefix


@dataclasses.dataclass
class TuningSession:
    """Everything the agent needs to tune one component *instance*.

    ``context`` is the config-store coordinate of what is tuned; it comes
    back on the ``session_report`` and keys where the best config persists.
    ``prior`` warm-starts the session with ``{"config", "value"}``
    observations of a related context (raw objective; ``mode`` is applied
    on injection); priors seed the surrogate only and never count as
    evaluations.
    """

    component: str
    component_id: int
    metric_fmt: str  # struct fmt of telemetry payloads
    metric_names: List[str]
    space_json: List[Dict[str, Any]]
    objective: str
    instance_id: int = 0
    mode: str = "min"  # 'min' | 'max'
    optimizer: str = "bo"
    samples_per_config: int = 1
    budget: int = 50
    seed: int = 0
    context: Optional[Dict[str, str]] = None
    prior: Optional[List[Dict[str, Any]]] = None


def make_session(component: Union[str, ComponentMeta], objective: str, *,
                 workload: Optional[str] = "*",
                 space: Optional[TunableSpace] = None,
                 mode: str = "min",
                 optimizer: str = "bo",
                 budget: int = 50,
                 samples_per_config: int = 1,
                 seed: int = 0,
                 instance_id: int = 0,
                 context: Optional[Dict[str, str]] = None,
                 prior: Optional[List[Dict[str, Any]]] = None) -> TuningSession:
    """The one session factory (campaign cells, driver loops).

    ``component`` is a registered name (or its :class:`ComponentMeta`): the
    session speaks its packed telemetry schema and searches its declared
    space, or ``space`` where given (a subset: a cell's pinned tunables are
    not searched).  The session is tagged with ``context_for(component,
    workload)`` unless ``context`` is given; ``workload=None`` leaves it
    untagged.  (The reference's direct sessions over unregistered names are
    not ported.)
    """
    if isinstance(component, ComponentMeta):
        meta = component
    else:
        from .registry import get_component

        meta = get_component(str(component))
    fmt = "<II" + "".join(m.fmt for m in meta.metrics)
    names = [m.name for m in meta.metrics]
    name, cid = meta.name, meta.component_id
    sp = space if space is not None else meta.space
    if objective not in names:
        raise ValueError(f"{name}: objective {objective!r} is not a declared metric {names}")
    if context is None and workload is not None:
        from .configstore import context_for

        context = context_for(name, workload).to_dict()
    return TuningSession(
        component=name, component_id=cid, metric_fmt=fmt, metric_names=names,
        space_json=sp.to_json(), objective=objective, instance_id=instance_id,
        mode=mode, optimizer=optimizer, samples_per_config=samples_per_config,
        budget=budget, seed=seed, context=context, prior=prior)


class AgentCore:
    """Deterministic agent logic for one session: telemetry in, commands out."""

    def __init__(self, session: TuningSession):
        self.session = session
        self.space = TunableSpace.from_json(session.space_json)
        self.opt = make_optimizer(session.optimizer, self.space, seed=session.seed)
        self.prior_injected = 0
        if session.prior:
            # Raw objective values flip into the internal minimized
            # convention exactly as observe() does for telemetry.
            sign = -1.0 if session.mode == "max" else 1.0
            self.prior_injected = self.opt.inject_prior(
                [(p["config"], sign * float(p["value"])) for p in session.prior])
        self.payload_size = struct.calcsize(session.metric_fmt)
        self._pending_cfg: Optional[Dict[str, Any]] = None
        self._samples: List[float] = []
        self.evaluations = 0
        self.done = False

    # -- protocol ------------------------------------------------------------
    @property
    def key(self) -> Tuple[int, int]:
        """The telemetry demux key of this session."""
        return (self.session.component_id, self.session.instance_id)

    def start_command(self) -> bytes:
        """First command: put the system on the optimizer's first proposal."""
        self._pending_cfg = self.opt.ask()
        return self._command(self._pending_cfg)

    def _command(self, cfg: Dict[str, Any]) -> bytes:
        msg = {
            "type": "config_update",
            "component": self.session.component,
            "instance": self.session.instance_id,
            "settings": cfg,
        }
        return json.dumps(msg).encode()

    def observe(self, payload: bytes) -> Optional[bytes]:
        """Feed one telemetry record; maybe emit the next config-update."""
        kind, out = self._ingest(payload)
        if kind == "ask":
            return self.resolve_ask(self.opt.ask())
        return out

    def _ingest(self, payload: bytes) -> Tuple[str, Optional[bytes]]:
        """Tell-side of :meth:`observe`: consume one record WITHOUT asking.

        Returns ``("none", None)`` (not ours / more samples needed),
        ``("park", cmd)`` (budget exhausted: park on the best config), or
        ``("ask", None)`` (the session needs its next proposal).  While an
        ask is deferred ``_pending_cfg`` is None, so stray records for this
        instance are dropped.
        """
        if self.done or self._pending_cfg is None:
            return "none", None
        vals = struct.unpack(self.session.metric_fmt, payload)
        if (vals[0], vals[1]) != self.key:
            return "none", None  # not ours
        metrics = dict(zip(self.session.metric_names, vals[2:]))
        v = float(metrics[self.session.objective])
        if self.session.mode == "max":
            v = -v
        self._samples.append(v)
        if len(self._samples) < self.session.samples_per_config:
            return "none", None
        value = sum(self._samples) / len(self._samples)
        self._samples = []
        self.opt.tell(self._pending_cfg, value)
        self.evaluations += 1
        if self.evaluations >= self.session.budget:
            self.done = True
            best = self.opt.best
            assert best is not None
            self._pending_cfg = None
            return "park", self._command(best.config)
        self._pending_cfg = None
        return "ask", None

    def resolve_ask(self, cfg: Dict[str, Any]) -> bytes:
        """Install a proposed config as the pending one and emit its
        config-update command."""
        self._pending_cfg = cfg
        return self._command(cfg)

    def session_report(self) -> Optional[bytes]:
        """Final per-session summary (None before any tell): what the host
        needs to promote the best config into the config store."""
        best = self.opt.best
        if best is None:
            return None
        return json.dumps(
            {
                "type": "session_report",
                "component": self.session.component,
                "instance": self.session.instance_id,
                "best_config": best.config,
                "best_value": best.value,
                "evaluations": self.evaluations,
                "objective": self.session.objective,
                "mode": self.session.mode,
                "budget": self.session.budget,
                "context": self.session.context,
            }
        ).encode()


class AgentMux:
    """N concurrent :class:`AgentCore` sessions behind one telemetry stream.

    Records are routed by their ``(component_id, instance_id)`` header; each
    session steps its own optimizer.  Records for unknown instances, and
    malformed ones, are counted (``unrouted``) and dropped.
    """

    def __init__(self, sessions: Sequence[TuningSession]):
        self.cores: Dict[Tuple[int, int], AgentCore] = {}
        for s in sessions:
            core = AgentCore(s)
            if core.key in self.cores:
                raise ValueError(f"duplicate session key {core.key} ({s.component})")
            self.cores[core.key] = core
        self._reported: set = set()
        self.unrouted = 0

    @property
    def done(self) -> bool:
        return all(c.done for c in self.cores.values())

    def start_commands(self) -> List[bytes]:
        return [c.start_command() for c in self.cores.values()]

    def _route(self, payload: bytes) -> Optional[AgentCore]:
        if len(payload) < _HEADER.size:
            self.unrouted += 1
            return None
        core = self.cores.get(_HEADER.unpack_from(payload, 0))
        if core is None or len(payload) != core.payload_size:
            self.unrouted += 1
            return None
        return core

    def _maybe_report(self, core: AgentCore, out: List[bytes]) -> None:
        if core.done and core.key not in self._reported:
            rep = core.session_report()
            if rep is not None:
                self._reported.add(core.key)
                out.append(rep)

    def observe(self, payload: bytes) -> List[bytes]:
        """Route one record; returns messages to push (commands + reports)."""
        core = self._route(payload)
        if core is None:
            return []
        out: List[bytes] = []
        cmd = core.observe(payload)
        if cmd is not None:
            out.append(cmd)
        self._maybe_report(core, out)
        return out

    def observe_batch(self, payloads: Sequence[bytes]) -> List[bytes]:
        """Route a batch of records; every session that finished a config
        asks for its next proposal at the end of the batch (results equal
        the serial :meth:`observe` loop: each optimizer owns its rng)."""
        out: List[bytes] = []
        need: List[AgentCore] = []
        for payload in payloads:
            core = self._route(payload)
            if core is None:
                continue
            if core in need:
                # A second completed config for one instance in one batch:
                # resolve the deferred ask now to keep tell→ask order.
                need.remove(core)
                out.append(core.resolve_ask(core.opt.ask()))
            kind, msg = core._ingest(payload)
            if msg is not None:
                out.append(msg)
            if kind == "ask":
                need.append(core)
            self._maybe_report(core, out)
        for core in need:
            out.append(core.resolve_ask(core.opt.ask()))
        return out

    def final_reports(self) -> List[bytes]:
        """Best-so-far reports for sessions not yet reported (early stop)."""
        out: List[bytes] = []
        for key, core in self.cores.items():
            if key in self._reported:
                continue
            rep = core.session_report()
            if rep is not None:
                self._reported.add(key)
                out.append(rep)
        return out


def drive_session(session: TuningSession, measure: Any) -> AgentCore:
    """Drive ONE session to completion in-process through the packed
    telemetry protocol.  ``measure(settings)`` applies the proposed
    settings and returns the component's metric dict."""
    core = AgentCore(session)
    fmt = struct.Struct(session.metric_fmt)
    cmd = json.loads(core.start_command().decode())
    while not core.done:
        metrics = measure(cmd["settings"])
        payload = fmt.pack(session.component_id, session.instance_id,
                           *[metrics[n] for n in session.metric_names])
        nxt = core.observe(payload)
        if nxt is not None:
            cmd = json.loads(nxt.decode())
    return core


def promote_session_report(store: Any, msg: Dict[str, Any], *,
                           baseline: Optional[Sequence[float]] = None,
                           samples: Optional[Sequence[float]] = None,
                           tolerance: float = 0.05, alpha: float = 0.05) -> bool:
    """Persist a finished session's best config into the config store.

    The session's context keys the entry; ``baseline``/``samples`` (the
    :func:`stats.compare` gate, oriented by the report's ``mode``) gate it;
    provenance (budget,
    evaluations, best objective and ``msg["provenance"]``) rides along.
    Returns False when the report carries no context or a gate rejects.
    """
    from .configstore import Context

    if not msg.get("context"):
        return False
    ctx = Context.from_dict(msg["context"])
    # Internal values are minimized; recover the raw objective for the gate.
    best_objective = -msg["best_value"] if msg.get("mode") == "max" else msg["best_value"]
    objective = msg.get("objective", "objective")
    provenance = {
        "budget": msg.get("budget"),
        "evaluations": msg.get("evaluations"),
        "objective": objective,
        "best_objective": best_objective,
        **(msg.get("provenance") or {}),
    }
    return store.promote(ctx, msg["best_config"],
                         baseline=list(baseline) if baseline else None,
                         samples=list(samples) if samples else None,
                         mode=msg.get("mode", "min"), tolerance=tolerance,
                         alpha=alpha, provenance=provenance)
