"""The paper's full deployment: a side-car agent process tunes the attention op
from live telemetry over the shared-memory channel.

The twin of the reference's ``examples/autotune_kernels.py`` (the paper's
Figure 2).  This process runs the "system": the port's attention op
(``torch_flash_attention``) at B2 S512 H8 K4 D64 in float32, each proposal
built through the step registry
(:func:`repro_torch.launch.microbench.candidate`) and timed by
:func:`~repro_torch.launch.microbench.median_time_us` (device-held on the
card, the host's wall clock on the CPU), and a
:class:`~repro_torch.core.telemetry.TelemetryEmitter`.  A SEPARATE agent
process (:class:`~repro_torch.core.agent.AgentProcess`, started with the
``spawn`` context: this process holds CUDA, which a fork must never clone)
hosts the optimizer (BO, Matérn-3/2, 12 configs), reads the telemetry off
the shared-memory ring and pushes config updates back over the control
ring; the :class:`~repro_torch.core.agent.AgentClient` applies them to the
registered settings holder.  The search covers ``impl`` (on the card
``kernel`` launches the Hopper kernel; on the CPU it runs its plain
version) and the tiles.  The holder is this example's own
:class:`~repro_torch.kernels.flash_attention.ops.AttentionKernelSettings`,
so the process-wide attention settings stay as they were.

    PYTHONPATH=src python -m repro_torch.examples.autotune_kernels             # on the card
    PYTHONPATH=src python -m repro_torch.examples.autotune_kernels --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..bench import require_device
from ..core.agent import AgentClient, AgentProcess, make_session
from ..core.channel import MlosChannel
from ..core.registry import get_component
from ..core.telemetry import TelemetryEmitter
from ..kernels.flash_attention import ops as attn_ops
from ..launch.microbench import candidate, median_time_us

COMPONENT = "torch_flash_attention"
SHAPE = dict(b=2, s=512, h=8, k=4, d=64)
BUDGET = 12


def inputs(device: torch.device):
    """float32 q, k, v drawn with numpy from seed 0."""
    b, s, h, k, d = SHAPE.values()
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(device)
                 for shp in ((b, s, h, d), (b, s, k, d), (b, s, k, d)))


def measure(settings: Dict[str, Any], args) -> float:
    """Median µs of the op at ``settings`` on ``args``."""
    b, s, _, _, d = SHAPE.values()
    fn = candidate(
        COMPONENT,
        lambda q, kk, vv: attn_ops.flash_attention(
            q, kk, vv, impl=settings["impl"], block_q=settings["block_q"],
            block_kv=settings["block_kv"]),
        settings, attn_ops.workload_signature(b, s, s, d))
    return median_time_us(fn, *args)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    qkv = inputs(device)

    meta = get_component(COMPONENT)
    holder = attn_ops.AttentionKernelSettings()
    session = make_session(meta, "time_us", optimizer="bo_matern32", budget=BUDGET)
    channel = MlosChannel.create()
    agent = AgentProcess(channel, session).start()
    try:
        client = AgentClient(channel)
        client.register(COMPONENT, holder)
        emitter = TelemetryEmitter(meta, channel)
        # wait for the agent's first proposal (a spawned interpreter takes a
        # second or more to come up; a bare poll would return at once)
        if client.poll(wait_s=0.002, deadline_s=60.0) != 1:
            raise RuntimeError("the agent's first proposal did not arrive")
        print(f"autotuning {COMPONENT} over {BUDGET} configs on {device} (the agent "
              f"runs in process {agent.proc.pid}, telemetry over the shared-memory ring)")
        base = measure(meta.space.defaults(), qkv)
        trace = []
        t0 = time.perf_counter()
        while client.report_for(COMPONENT) is None:
            s = holder.settings_for("*")
            t = measure(s, qkv)
            trace.append({"config": dict(s), "time_us": t})
            print(f"  [{len(trace) - 1:2d}] impl={s['impl']:<13s} bq={s['block_q']:<5d} "
                  f"bkv={s['block_kv']:<5d} → {t:9.1f} us")
            emitter.emit({"time_us": t})
            # the next proposal, or the report that ends the session
            while not client.poll(wait_s=0.002, deadline_s=0.25) and \
                    client.report_for(COMPONENT) is None:
                if time.perf_counter() - t0 > 600.0:
                    raise RuntimeError("the agent sent no proposal or report within 600 s")
        agent.proc.join(60.0)
        exitcode = agent.proc.exitcode
    finally:
        if agent.proc.is_alive():
            agent.stop()
        channel.close()
    report = client.report_for(COMPONENT)
    final = holder.settings_for("*")
    best = measure(final, qkv)
    print(f"default: {base:.1f} us → tuned: {best:.1f} us "
          f"({100 * (base - best) / base:.1f}% faster)  settings={final}; the agent's report: "
          f"best {report['best_config']} after {report['evaluations']} evaluations; "
          f"agent exit code {exitcode}")
    return {"default_us": base, "tuned_us": best, "settings": final, "trace": trace,
            "report": report, "agent_exitcode": exitcode, "device": str(device)}


if __name__ == "__main__":
    main()
