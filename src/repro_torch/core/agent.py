"""The MLOS agent: tuning sessions, their ask/tell logic, the multiplexer
that drives many of them behind one telemetry stream, and the side-car
daemon that runs that multiplexer in its own process.

The port of ``repro/core/agent.py``:

  * :class:`TuningSession` — everything the agent needs to tune one
    component instance (JSON-serializable), built by :func:`make_session`;
  * :class:`AgentCore` — one session: consume packed telemetry, aggregate
    per-config samples, step the optimizer, emit config-update commands;
  * :class:`AgentMux` — N cores routed by the ``(component_id,
    instance_id)`` header of each record (:mod:`.codegen`);
  * :func:`agent_main` / :class:`AgentProcess` — the mux in a separate OS
    process attached to the shared-memory :class:`~.channel.MlosChannel`
    (the paper's side-car), telemetry drained in batches per poll;
  * :class:`AgentClient` and :class:`TrackedInstance` — the host side:
    apply config updates to live instances, collect session reports and
    promote them into a config store;
  * :func:`drive_session` and :func:`promote_session_report` — the
    single-session driver and the promote half of tune → validate → persist.

Wire protocol (JSON commands, packed structs on telemetry):
``config_update`` {component, instance, settings} and ``session_report``
{component, instance, best_config, best_value, evaluations, objective,
mode, budget, context}.

The daemon starts with the ``spawn`` context, never ``fork``: the host
holds a CUDA context and threads that a forked child must not inherit.
The spawned interpreter imports this module, the channel, the optimizers
(numpy, scipy) and the tunable space, and nothing that imports torch, so
with the default numpy backend it never touches the card.  With the
optimizer defaults ``{"backend": "torch", "device": "cuda"}`` its BO
sessions build the torch GP engine, which imports torch there and prices
the whole mux on the card in one batched ask per poll.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import struct
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .channel import MlosChannel
from .optimizers import make_optimizer, optimizer_defaults, set_optimizer_defaults
from .registry import ComponentMeta
from .tunable import TunableSpace

__all__ = ["TuningSession", "make_session", "AgentCore", "AgentMux", "AgentProcess",
           "AgentClient", "TrackedInstance", "agent_main", "drive_session",
           "promote_session_report"]

_CONTROL_STOP = b"\x00STOP"
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


def sessions_to_json(sessions: Iterable[TuningSession]) -> str:
    return json.dumps([dataclasses.asdict(s) for s in sessions])


def sessions_from_json(s: str) -> List[TuningSession]:
    """Parse one session or a list of sessions."""
    obj = json.loads(s)
    if isinstance(obj, dict):
        obj = [obj]
    return [TuningSession(**d) for d in obj]


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

    def ask(self) -> Dict[str, Any]:
        """The configuration to run next (the best once the budget is spent),
        for a driver that observes values directly."""
        if self._pending_cfg is None and not self.done:
            self._pending_cfg = self.opt.ask()
        return dict(self._pending_cfg or (self.opt.best.config if self.opt.best else {}))

    def observe_value(self, config: Dict[str, Any], value: float) -> Dict[str, Any]:
        """Direct observation (bypasses the packed-telemetry protocol): tell
        ``value`` for ``config``; returns the next configuration to run."""
        if self.done:
            return self.ask()
        v = -float(value) if self.session.mode == "max" else float(value)
        self.opt.tell(config, v)
        self.evaluations += 1
        if self.evaluations >= self.session.budget:
            self.done = True
            self._pending_cfg = None
            return dict(self.opt.best.config)
        self._pending_cfg = self.opt.ask()
        return dict(self._pending_cfg)

    @property
    def best(self):
        return self.opt.best

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
        asks for its next proposal at the end of the batch, all in one
        batched ask.  With torch-backed BO sessions the whole mux's suggest
        sweep is one program per signature
        (:class:`~.optimizers.engine.BatchedBayesOpt`); other optimizers ask
        one by one.  Results equal the serial :meth:`observe` loop: asks are
        deferred only to the end of the batch, and each optimizer owns its
        rng."""
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
        if any(getattr(c.opt, "backend", None) == "torch" for c in need):
            from .optimizers.engine import batched_ask  # deferred: torch is heavy

            cfgs = batched_ask([c.opt for c in need])
        else:
            cfgs = [c.opt.ask() for c in need]
        for core, cfg in zip(need, cfgs):
            out.append(core.resolve_ask(cfg))
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


def agent_main(
    telemetry_name: str,
    control_name: str,
    sessions_json: str,
    poll_s: float = 0.0005,
    drain_batch: int = 256,
    optimizer_defaults_json: Optional[str] = None,
) -> None:
    """Entry point of the agent process: one mux over the duplex channel.

    Each idle poll sleeps once and then drains up to ``drain_batch`` records
    in one pass.  ``optimizer_defaults_json`` replays the host's
    process-wide optimizer defaults into this freshly spawned interpreter.
    On exit (every session done, or the host's STOP record) the remaining
    sessions' best-so-far reports go out."""
    if optimizer_defaults_json:
        set_optimizer_defaults(**json.loads(optimizer_defaults_json))
    chan = MlosChannel.attach(telemetry_name, control_name)
    mux = AgentMux(sessions_from_json(sessions_json))
    try:
        for cmd in mux.start_commands():
            chan.control.push(cmd)
        stopped = False
        while not mux.done and not stopped:
            batch = chan.telemetry.drain(limit=drain_batch)
            if not batch:
                time.sleep(poll_s)
                continue
            if _CONTROL_STOP in batch:
                stopped = True
                batch = batch[: batch.index(_CONTROL_STOP)]
            for msg in mux.observe_batch(batch):
                chan.control.push(msg)
        for rep in mux.final_reports():
            chan.control.push(rep)
    finally:
        chan.telemetry.close()
        chan.control.close()


class AgentProcess:
    """Host-side handle that launches and stops the (multi-session) agent
    daemon over ``channel``.  Started with the ``spawn`` context (see the
    module docstring); the host's optimizer defaults are snapshotted into
    the child, whose fresh interpreter would otherwise read the module's."""

    def __init__(self, channel: MlosChannel,
                 sessions: Union[TuningSession, Sequence[TuningSession]]):
        self.channel = channel
        if isinstance(sessions, TuningSession):
            sessions = [sessions]
        self.sessions = list(sessions)
        tele, ctrl = channel.names
        ctx = multiprocessing.get_context("spawn")
        self.proc = ctx.Process(
            target=agent_main,
            args=(tele, ctrl, sessions_to_json(self.sessions)),
            kwargs={"optimizer_defaults_json": json.dumps(optimizer_defaults())},
            daemon=True,
        )

    def start(self) -> "AgentProcess":
        self.proc.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Ask the daemon to stop (a STOP record on telemetry), then join;
        a daemon that does not exit in ``timeout`` is terminated."""
        self.channel.telemetry.push(_CONTROL_STOP)
        self.proc.join(timeout)
        if self.proc.is_alive():  # pragma: no cover
            self.proc.terminate()
            self.proc.join(timeout)


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
                           rpi: Any = None, run: Any = None,
                           baseline: Optional[Sequence[float]] = None,
                           samples: Optional[Sequence[float]] = None,
                           tolerance: float = 0.05, alpha: float = 0.05) -> bool:
    """Persist a finished session's best config into the config store.

    The session's context keys the entry; ``rpi`` (an
    :class:`~repro_torch.core.rpi.RPI`, when given) gates the promotion on
    its bounds over the report's objective (the only metric a report
    carries: bounds on other metrics are dropped, or they would veto every
    promotion as missing); ``baseline``/``samples`` (the
    :func:`stats.compare` gate, oriented by the report's ``mode``) gate it
    too.  Provenance (the ``run``'s id, budget, evaluations, best objective
    and ``msg["provenance"]``) rides along, and the tracked ``run`` logs
    the objective, a ``promoted``/``rejected_rpi`` tag and, on promotion,
    the config.  Returns False when the report carries no context or a
    gate rejects.
    """
    from .configstore import Context

    if not msg.get("context"):
        return False
    ctx = Context.from_dict(msg["context"])
    # Internal values are minimized; recover the raw objective for the gate.
    best_objective = -msg["best_value"] if msg.get("mode") == "max" else msg["best_value"]
    objective = msg.get("objective", "objective")
    metrics = {objective: best_objective}
    if rpi is not None:
        bounds = tuple(b for b in rpi.bounds if b.metric in metrics)
        rpi = dataclasses.replace(rpi, bounds=bounds) if bounds else None
    provenance = {
        "run_id": getattr(run, "run_id", None),
        "budget": msg.get("budget"),
        "evaluations": msg.get("evaluations"),
        "objective": objective,
        "best_objective": best_objective,
        **(msg.get("provenance") or {}),
    }
    ok = store.promote(ctx, msg["best_config"], rpi=rpi, metrics=metrics,
                       baseline=list(baseline) if baseline else None,
                       samples=list(samples) if samples else None,
                       mode=msg.get("mode", "min"), tolerance=tolerance,
                       alpha=alpha, provenance=provenance)
    if run is not None:
        run.log_metric(f"{ctx.component}@{ctx.workload}/{objective}", best_objective)
        run.set_tags({f"{ctx.component}@{ctx.workload}":
                      "promoted" if ok else "rejected_rpi"})
        if ok:
            run.log_params({f"{ctx.component}@{ctx.workload}": msg["best_config"]})
    return ok


class TrackedInstance:
    """Host-side wrapper for a multiplexed drive loop: remembers that a
    config landed (``dirty``) so the driver knows this instance needs a
    fresh measurement and telemetry emit.  Register it with
    :class:`AgentClient` in place of the bare component."""

    def __init__(self, instance: Any, rebuild: bool = True):
        self.instance = instance
        self._rebuild = rebuild and hasattr(instance, "apply_and_rebuild")
        self.dirty = False

    def apply_settings(self, settings: Dict[str, Any]) -> None:
        if self._rebuild:
            self.instance.apply_and_rebuild(settings)
        else:
            self.instance.apply_settings(settings)
        self.dirty = True


class AgentClient:
    """System side: applies agent commands to live component instances.

    Instances are keyed by ``(component_name, instance_id)``, so one client
    can host many instances of a component, each driven by its own session.
    With a ``store``, session reports that carry a context are promoted
    into it as they arrive (:func:`promote_session_report`), gated per
    context by ``rpi_lookup(component, workload) -> RPI | None`` and
    tracked against ``run`` when given; ``promotions`` records each
    attempt as ``(context_dict, promoted?)``.
    """

    def __init__(self, channel: MlosChannel, store: Any = None,
                 rpi_lookup: Any = None, run: Any = None):
        self.channel = channel
        self.store = store
        self.rpi_lookup = rpi_lookup
        self.run = run
        self._instances: Dict[Tuple[str, int], Any] = {}
        self.reports: List[Dict[str, Any]] = []
        self.promotions: List[Tuple[Dict[str, str], bool]] = []

    def register(self, name: str, instance: Any, instance_id: int = 0) -> None:
        self._instances[(name, instance_id)] = instance

    def report_for(self, name: str, instance_id: int = 0) -> Optional[Dict[str, Any]]:
        for rep in self.reports:
            if rep["component"] == name and rep.get("instance", 0) == instance_id:
                return rep
        return None

    def poll(self, wait_s: float = 0.0, deadline_s: float = 1.0) -> int:
        """Apply pending config updates; with ``wait_s`` block (sleeping
        ``wait_s`` between looks, at most ``deadline_s``) until one arrives.
        Returns how many updates were applied."""
        applied = 0
        t0 = time.perf_counter()
        while True:
            payload = self.channel.control.pop()
            if payload is None:
                if wait_s and applied == 0 and time.perf_counter() - t0 < deadline_s:
                    time.sleep(wait_s)
                    continue
                return applied
            msg = json.loads(payload.decode())
            if msg["type"] == "config_update":
                inst = self._instances.get((msg["component"], msg.get("instance", 0)))
                if inst is not None:
                    inst.apply_settings(msg["settings"])
                    applied += 1
            elif msg["type"] == "session_report":
                self.reports.append(msg)
                if self.store is not None and msg.get("context"):
                    ctx = msg["context"]
                    rpi = (self.rpi_lookup(ctx["component"], ctx["workload"])
                           if self.rpi_lookup else None)
                    ok = promote_session_report(self.store, msg, rpi=rpi, run=self.run)
                    self.promotions.append((ctx, ok))
