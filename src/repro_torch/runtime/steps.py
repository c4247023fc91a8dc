"""The train step: compute cast, microbatched gradients, AdamW, LR schedule.

The port of ``repro/runtime/steps.py``.  The server runs prefill and decode
through its own captured steps (:mod:`.serve_loop`); the plain bodies
:func:`make_prefill_step` and :func:`make_decode_step` are the reference's,
and are what the dry-run traces (:mod:`repro_torch.launch.specs`).
:func:`make_train_step` assembles the loss's gradients (with microbatch
accumulation in float32), the ``warmup_cosine`` schedule scaled by a live
``lr_scale``, and AdamW.  :func:`train_step_for` is the step as the
registry holds it (:func:`repro_torch.core.compilecache.cached_step`, key
``train.step``), keyed as the reference keys its jitted step: the config's
signature, the hyperparameters baked into the step and the microbatch
count.  The step runs eagerly; ``lr_scale`` is an argument of every call,
so the MLOS agent retunes it live without a rebuild.  Its phases are spans
(:func:`repro_torch.core.telemetry.span`): ``train.forward`` (the compute
cast and the loss) and ``train.backward`` (the gradient, added into the
float32 accumulators with microbatches) once a microbatch, then
``train.optimizer`` (the schedule and AdamW, clip included).

State = ``{"params": tree, "opt": {"m", "v", "count"}, "step": 0-d int32
tensor}``, parameters in the compute dtype and float32 moments
(:func:`train_state_specs`).  The step updates ``params``, ``m`` and ``v``
IN PLACE (the reference returns a new state; a full-width state is 13 GB
here, and one copy of it is enough) and returns the state with its new
``count`` and ``step``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from ..core.telemetry import span
from ..models import model as M
from ..models.config import ModelConfig
from ..models.layers import P, dtype_of
from ..optim.adamw import adamw_init, adamw_update
from ..optim.schedules import warmup_cosine
from ..parallel import sharding as shd
from ..tree import leaves, tree_map

__all__ = ["cast_for_compute", "train_state_specs", "TrainHyper", "make_train_step",
           "train_step_for", "init_train_state", "make_prefill_step", "make_decode_step"]


def _spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """The P tree of the port's parameters (one dict per layer)."""
    return M.unstack_blocks(M.param_specs(cfg), cfg)


def cast_for_compute(params: Any, cfg: ModelConfig) -> Any:
    """Every leaf in the compute dtype, a leaf pinned by its spec (the SSM's
    float32 ``A_log``, ``dt_bias``) in its pin.  A leaf already in its
    dtype is returned as it is, so gradients reach it.  Each cast keeps its
    master's layout (in a sharded program the FSDP gathers then move the
    compute dtype)."""
    dt = dtype_of(cfg)
    return tree_map(lambda p, x: shd.constrain(x.to(p.with_dtype(dt)), p.logical),
                    _spec_tree(cfg), params)


def train_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """P-spec tree of the full train state, in the reference's stacked
    layout: parameters in the compute dtype, float32 Adam moments, int32
    counters."""
    ps = M.param_specs(cfg)

    def f32(tree: Any) -> Any:
        if isinstance(tree, P):
            return P(tree.shape, tree.logical, tree.init, tree.scale, "float32")
        return {k: f32(v) for k, v in tree.items()}

    return {"params": ps,
            "opt": {"m": f32(ps), "v": f32(ps),
                    "count": P((), (), "zeros", dtype="int32")},
            "step": P((), (), "zeros", dtype="int32")}


class TrainHyper:
    """Hyperparameters baked into a train step (the reference's class-a
    constants); ``lr_scale`` is not one of them: it is passed per call."""

    def __init__(self, base_lr: float = 3e-4, warmup: int = 100, total: int = 10000,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
        self.base_lr, self.warmup, self.total = base_lr, warmup, total
        self.weight_decay, self.clip_norm = weight_decay, clip_norm

    def key(self) -> tuple:
        return (self.base_lr, self.warmup, self.total, self.weight_decay, self.clip_norm)


def _value_and_grad(cfg: ModelConfig, params: Any, batch: Dict[str, torch.Tensor],
                    into: Any = None):
    """(loss, parts, grads in the parameters' dtypes), in a ``train.forward``
    and a ``train.backward`` span; with ``into`` (float32 accumulators of
    the parameters' tree) the gradients are added to it in the backward,
    and ``into`` is returned as the grads."""
    dev = batch["tokens"].device
    with torch.enable_grad():
        with span("train.forward", dev):
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, parts = M.loss_fn(cast_for_compute(live, cfg), cfg, batch)
        with span("train.backward", dev):
            grads = torch.autograd.grad(loss, leaves(live))
            if into is not None:
                for acc, g in zip(leaves(into), grads):
                    acc.add_(g)
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            into if into is not None else tree_map(lambda _: next(it), params))


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A float32 accumulator of ``p``'s shape (of a DTensor, its layout)."""
    if shd.is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_train_step(cfg: ModelConfig, hyper: Optional[TrainHyper] = None, *,
                    microbatches: int = 1) -> Callable:
    """Returns ``train_step(state, batch, lr_scale=1.0) -> (state, metrics)``.

    ``batch`` = {"tokens": (B, S), "labels": (B, S)} integer tensors on the
    state's device, and ``"modal"`` (B, S_src, d) for the encoder-decoder
    and VLM families (the reference's batch; microbatches split it along B
    with the tokens).  ``metrics`` are 0-d tensors: loss, lr, grad_norm, ce
    and aux (the MoE balance loss, summed over the layers).  With
    ``microbatches`` > 1 the batch is split along B and the gradients are
    summed in float32 and averaged, as in the reference, which then
    reports ce = the mean loss and aux = 0; a MoE layer's capacity is then
    computed per microbatch."""
    hyper = hyper or TrainHyper()

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   lr_scale: Union[float, torch.Tensor] = 1.0):
        params = state["params"]
        if microbatches == 1:
            loss, parts, grads = _value_and_grad(cfg, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
            grads = tree_map(_zeros_f32, params)
            lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(microbatches):
                mb = {k: shd.row_block(v, i, microbatches) for k, v in batch.items()}
                l, _, _ = _value_and_grad(cfg, params, mb, into=grads)
                lsum = lsum + l
        with span("train.optimizer", batch["tokens"].device):
            if microbatches > 1:
                grads = tree_map(lambda g: g / microbatches, grads)
                loss = lsum / microbatches
                parts = {"ce": loss,
                         "aux": torch.zeros((), dtype=torch.float32, device=loss.device)}
            lr = warmup_cosine(state["step"], hyper.base_lr, hyper.warmup, hyper.total)
            lr = lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=lr.device)
            params, opt, ostats = adamw_update(grads, state["opt"], params, lr=lr,
                                               weight_decay=hyper.weight_decay,
                                               clip_norm=hyper.clip_norm)
            step = state["step"] + 1
        metrics = {"loss": loss, "lr": lr, **ostats, **parts}
        return {"params": params, "opt": opt, "step": step}, metrics

    return train_step


def train_step_for(cfg: ModelConfig, hyper: Optional[TrainHyper] = None, *,
                   microbatches: int = 1) -> Callable:
    """The train step through the step registry: one step per (config
    signature, hyperparameters, microbatches), shared by every loop of the
    process — restarts, benchmark children, many loops."""
    from ..core.compilecache import cached_step, config_signature

    hyper = hyper or TrainHyper()
    return cached_step(make_train_step(cfg, hyper, microbatches=microbatches),
                       key="train.step",
                       context=(config_signature(cfg), hyper.key(), microbatches))


def make_prefill_step(cfg: ModelConfig, cache_capacity: int) -> Callable:
    """The reference's plain prefill step: ``prefill_step(params, batch) ->
    {"logits", "caches", "pos"}``, ``batch`` = {"tokens" (B, S)[, "modal"]}.
    The server runs the same model function through its captured steps
    (:mod:`.serve_loop`); this body is what the dry-run traces."""
    def prefill_step(params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        logits, caches, pos = M.prefill(params, cfg, batch["tokens"], cache_capacity,
                                        batch.get("modal"))
        return {"logits": logits, "caches": caches, "pos": pos}

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """The reference's plain decode step: ``decode_step(params, state) ->
    {"token", "caches", "pos", "logits"}``, ``state`` = {"token" (B,),
    "caches", "pos" (B,)}: one greedy token a row; the caches are updated in
    place.  ``pos`` is per row, as the continuous server keeps it."""
    def decode_step(params: Dict[str, Any], state: Dict[str, Any]):
        logits, caches = M.decode_step(params, cfg, state["token"], state["caches"],
                                       state["pos"])
        # a sharded program's vocab-parallel logits are gathered for the argmax
        whole = shd.constrain(logits, ("batch", None))
        token = torch.argmax(whole, dim=-1).to(state["token"].dtype)
        return {"token": token, "caches": caches, "pos": state["pos"] + 1, "logits": logits}

    return decode_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Parameters drawn from ``generator`` (which must live on ``device``) in
    the compute dtype, zero moments, step 0."""
    params = M.init_params(cfg, generator, device=device)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}
