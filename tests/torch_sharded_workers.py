"""Worker processes for tests/test_torch_sharded_run.py (a helper module, not
a test file): each of the 8 spawned ranks joins a gloo process group on
localhost, builds the (data 2, model 4) ``DeviceMesh``, places the cases'
tensors by the sharding rules and runs the port's sharded programs on
them; rank 0 saves what came out, every DTensor gathered whole."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

SHAPE = (("data", 2), ("model", 4))
WORLD = 8


def _whole(tree: Any) -> Any:
    """Every DTensor of ``tree`` gathered to the whole tensor."""
    from repro_torch.parallel import sharding as shd

    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_whole(v) for v in tree]
    if shd.is_dtensor(tree):
        return tree.full_tensor()
    return tree


def train_specs(cfg) -> Dict[str, Any]:
    """The spec tree of the port's (unstacked) train state."""
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S

    ss = S.train_state_specs(cfg)
    ss["params"] = M.unstack_blocks(ss["params"], cfg)
    ss["opt"]["m"] = M.unstack_blocks(ss["opt"]["m"], cfg)
    ss["opt"]["v"] = M.unstack_blocks(ss["opt"]["v"], cfg)
    return ss


def batch_specs(b: int, s: int, labels: bool = True) -> Dict[str, Any]:
    from repro_torch.models.layers import P

    out = {"tokens": P((b, s), ("batch", "seq"), "zeros", dtype="int64")}
    if labels:
        out["labels"] = P((b, s), ("batch", "seq"), "zeros", dtype="int64")
    return out


def _train(case, dm, mesh):
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime import steps as S

    cfg, rules = case["cfg"], shd.train_rules()
    state = shd.distribute(case["state"], train_specs(cfg), rules, dm)
    batch = shd.distribute(case["batch"], batch_specs(*case["batch"]["tokens"].shape), rules, dm)
    step = S.make_train_step(cfg, S.TrainHyper(**case["hyper"]),
                             microbatches=case.get("microbatches", 1))
    with shd.use_rules(mesh, rules, dm):
        _, _, grads = S._value_and_grad(cfg, state["params"], batch)
    losses = []
    for _ in range(case["steps"]):
        with shd.use_rules(mesh, rules, dm):
            state, metrics = step(state, batch, 1.0)
        losses.append(float(_whole(metrics["loss"])))
    return {"losses": losses, "params": _whole(state["params"]), "grads": _whole(grads),
            "layout": str(state["params"]["blocks"][0]["mlp"]["wo"].placements)}


def _loss(case, dm, mesh):
    from repro_torch.launch.dryrun import _temp_settings
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as shd

    cfg, rules = case["cfg"], shd.serve_rules()
    params = shd.distribute(case["params"], M.unstack_blocks(M.param_specs(cfg), cfg), rules, dm)
    batch = shd.distribute(case["batch"], batch_specs(*case["batch"]["tokens"].shape), rules, dm)
    with _temp_settings(case.get("settings", {})), shd.use_rules(mesh, rules, dm), \
            torch.no_grad():
        loss, _ = M.loss_fn(params, cfg, batch)
    return {"loss": float(_whole(loss)), "ce": float(_whole(_["ce"]))}


def _serve(case, dm, mesh):
    from repro_torch.launch.dryrun import _temp_settings
    from repro_torch.models import model as M
    from repro_torch.models.layers import P
    from repro_torch.parallel import sharding as shd

    cfg, rules = case["cfg"], shd.serve_rules()
    params = shd.distribute(case["params"], M.unstack_blocks(M.param_specs(cfg), cfg), rules, dm)
    toks = shd.distribute({"tokens": case["tokens"]},
                          batch_specs(*case["tokens"].shape, labels=False), rules, dm)["tokens"]
    modal = case.get("modal")
    if modal is not None:
        modal = shd.distribute(modal, P(tuple(modal.shape), ("batch", "seq", "d_model")), rules,
                               dm)
    out = {"logits": []}
    with _temp_settings(case.get("settings", {})), shd.use_rules(mesh, rules, dm), \
            torch.no_grad():
        logits, caches, pos = M.prefill(params, cfg, toks, case["capacity"], modal)
        out["logits"].append(_whole(logits))
        first = caches[0]["inner"][0] if "inner" in caches[0] else caches[0]
        out["cache_layout"] = {k: str(v.placements) for k, v in first.items() if k != "ssm"}
        tok = torch.argmax(logits.full_tensor(), -1)
        for i in range(case["decode_steps"]):
            tok_d = shd.distribute(tok, P((tok.shape[0],), ("batch",), "zeros", dtype="int64"),
                                   rules, dm)
            logits, caches = M.decode_step(params, cfg, tok_d, caches, pos + i)
            out["logits"].append(_whole(logits))
            tok = torch.argmax(out["logits"][-1], -1)
    return out


def _place(case, dm, mesh):
    """Every leaf of each config's params, train state and caches, placed by
    its rules and gathered back: (largest difference, local shapes that
    disagree with ``local_shape``)."""
    from repro_torch.models import model as M
    from repro_torch.models.layers import spec_leaves
    from repro_torch.parallel import sharding as shd

    worst, wrong, n = 0.0, [], 0
    gen = torch.Generator().manual_seed(case["seed"])
    for cfg in case["cfgs"]:
        trees = [(train_specs(cfg), shd.train_rules()),
                 (M.unstack_blocks(M.param_specs(cfg), cfg), shd.serve_rules()),
                 (M.cache_specs(cfg, 4, 16, enc_len=16), shd.serve_rules())]
        for spec, rules in trees:
            for p in spec_leaves(spec):
                t = torch.randn(p.shape, generator=gen) if p.shape else torch.randn((), generator=gen)
                d = shd.distribute(t, p, rules, dm)
                n += 1
                if tuple(d.to_local().shape) != shd.local_shape(p, rules, mesh):
                    wrong.append((cfg.name, p.shape, p.logical))
                worst = max(worst, float((d.full_tensor() - t).abs().max()) if t.numel() else 0.0)
    return {"max_diff": worst, "wrong_local_shapes": wrong, "leaves": n}


def _moe_layer(case, dm, mesh):
    """One MoE layer on a drawn (B, S, d) input, its weights placed by the
    serve rules."""
    from repro_torch.launch.dryrun import _temp_settings
    from repro_torch.models import moe
    from repro_torch.models.layers import P
    from repro_torch.parallel import sharding as shd

    cfg, rules = case["cfg"], shd.serve_rules()
    w = shd.distribute(case["params"], moe.moe_params(cfg), rules, dm)
    x = shd.distribute(case["x"], P(tuple(case["x"].shape), ("batch", "seq", "d_model")),
                       rules, dm)
    with _temp_settings(case.get("settings", {})), shd.use_rules(mesh, rules, dm), \
            torch.no_grad():
        y, aux = moe.apply_moe(w, x, cfg)
    return {"y": _whole(y), "aux": float(_whole(aux))}


KINDS = {"train": _train, "loss": _loss, "serve": _serve, "place": _place,
         "moe_layer": _moe_layer}


def run(rank: int, port: int, in_path: str, out_path: str) -> None:
    from repro_torch.launch.mesh import Mesh, device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = Mesh("gloo", SHAPE)
        dm = device_mesh(mesh, "cpu")
        cases = torch.load(in_path, weights_only=False)
        out = {name: KINDS[case["kind"]](case, dm, mesh) for name, case in cases.items()}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw).validate()
