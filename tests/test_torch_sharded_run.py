"""The port's sharded programs run for real: 8 gloo ranks on this CPU.

One spawn of 8 ranks (``tests/torch_sharded_workers.py``) on a (data 2,
model 4) ``DeviceMesh`` runs every case below in float32, each rank on its
shards, and rank 0 gathers the results whole.  They are held to the port's
one-device results on the same inputs (rtol 1e-5: the shards' partial sums
add in another order) and, for the dense train step, Mixtral's decode and
the GQA case, to the reference's one-device results within ``tests/test_kernels.py``'s
f32 tolerances (``_tol``, 2e-5, for the train losses; ``_grid_tol`` with
headroom 5, 1e-4, for logits after a model's layers):

  * a reduced olmo-1b train step, twice: finite, decreasing loss, the
    gradients of every leaf (FSDP gathers and reduce-scatters, TP);
  * reduced olmoe through the ``local_map`` MoE: with no dropped token
    (capacity factor 4) its cross-entropy equals one device's; at the
    default factor the loss is within the reference's 0.1 bound of one
    device's (each rank's capacity is of its own tokens, and ``aux`` is
    averaged over the ranks, as the reference's ``pmean``); on the
    reference test's own input (every token the same) it equals the
    reference's (2, 4) run within 1e-4;
  * reduced mixtral: prefill and 3 decode steps on its windowed ring cache,
    sequence-sharded over ``model`` (the distributed flash-decode);
  * GQA with K/V replicated (reduced olmo-1b: 2 KV heads on a model axis of
    4), prefill and decode;
  * the fallbacks: hymba with 5 heads (sequence-parallel attention) and 2
    SSM heads (the SSD on a slice of the head dim), served and trained;
    mamba2 on its heads; the cross-attention of seamless (a sequence-sharded
    cross cache) and of the VLM (a head-dim-sharded one, gathered);
  * every leaf of every arch's params, train state and caches placed by its
    rules and gathered back to itself.

Inputs are drawn with numpy from crc32 seeds; the reference initializes the
params, loaded through ``convert.py``.  Each rank runs torch on one thread.
"""
from __future__ import annotations

import copy
import dataclasses
import multiprocessing
import os
import socket
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_workers as workers
import torch_xattn as X
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime import steps as JS
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.launch.dryrun import _temp_settings
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.runtime import steps as S
from repro_torch.tree import leaves
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
F32 = dict(rtol=2e-5, atol=2e-5)          # tests/test_kernels.py's _tol(float32)
# tests/test_kernels.py's _grid_tol(float32, headroom=5): 170·eps covers one
# kernel's reduction chain, a model stacks a few (the one-device parity tests
# hold logits at 1e-4, tests/test_torch_model.py)
MODEL_F32 = dict(rtol=5 * 170 * float(np.finfo(np.float32).eps),
                 atol=5 * 170 * float(np.finfo(np.float32).eps))
HYPER = dict(base_lr=1e-2, warmup=1, total=100)
NO_DROP = {"torch_moe_dispatch": {"capacity_factor": 4.0}}


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _key(name):
    return jax.random.PRNGKey(zlib.crc32(name.encode()) % (1 << 31))


def _tokens(tag, shape, vocab):
    return torch.from_numpy(_rng("tokens", tag).integers(0, vocab, shape)).long()


def _pair(name, **kw):
    """(the port's config, the reference's, params drawn by the reference);
    the cross-attending families' params perturbed as their parity tests do
    (``tests/torch_xattn.py``: out of float32's chaotic regime)."""
    cfg = dataclasses.replace(get_config(name).reduced(), **kw).validate()
    jcfg = dataclasses.replace(jget_config(name).reduced(), **kw).validate()
    jp = jax.device_get(JM.init_params(_key(name + repr(sorted(kw.items()))), jcfg))
    if cfg.family in ("encdec", "vlm"):
        jp = X.perturbed(jp, name)
    return cfg, jcfg, jp, params_from_reference(jp, cfg, device="cpu")


def _one_device_serve(cfg, params, toks, cap, steps, modal=None, settings=None):
    with _temp_settings(settings or {}), torch.no_grad():
        logits, caches, pos = M.prefill(params, cfg, toks, cap, modal)
        out = [logits]
        for i in range(steps):
            logits, caches = M.decode_step(params, cfg, torch.argmax(logits, -1), caches,
                                           pos + i)
            out.append(logits)
    return out


def _reference_serve(jcfg, jp, toks, cap, steps):
    logits, caches, pos = JM.prefill(jp, jcfg, jnp.asarray(toks.numpy(), jnp.int32), cap)
    out = [np.asarray(logits)]
    for i in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, caches = JM.decode_step(jp, jcfg, tok, caches, pos + i)
        out.append(np.asarray(logits))
    return out


def _reference_moe_on_a_mesh(cfg_kw, x):
    """The reference's MoE on its own (2, 4) mesh, in a subprocess with 8 host
    devices, every expert slot kept (capacity factor 4): its test's loss
    (every token 3, the serve rules), and the largest difference between its
    MoE layer on ``x`` there and on one device.  Started now; the function
    returned gives the two numbers when the subprocess ends."""
    np.save(x_path := Path(os.environ.get("TMPDIR", "/tmp")) / f"moe_x_{os.getpid()}.npy", x)
    prog = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import get_config
from repro.launch import tuning
from repro.models import model as M, moe
from repro.parallel import sharding as shd
inst = tuning.SINGLETONS["moe_dispatch"]
inst.settings = {{**inst.settings, "capacity_factor": 4.0}}
cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), **{cfg_kw!r}).validate()
params = M.init_params(jax.random.PRNGKey(0), cfg)
batch = {{"tokens": jnp.zeros((8, 16), jnp.int32) + 3, "labels": jnp.ones((8, 16), jnp.int32)}}
mesh = make_mesh((2, 4), ("data", "model"))
def f(p, b):
    with shd.use_rules(mesh, shd.serve_rules()):
        return M.loss_fn(p, cfg, b)[0]
def g(p, x):
    with shd.use_rules(mesh, shd.serve_rules()):
        return moe.apply_moe(p, x, cfg)[0]
x = jnp.asarray(np.load({str(x_path)!r}))
lp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
diff = jnp.abs(jax.jit(g)(lp, x) - moe.apply_moe(lp, x, cfg, strategy="gather")[0]).max()
print("LOSS", float(jax.jit(f)(params, batch)), "LAYER", float(diff))
"""
    proc = subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})

    def result():
        """(the loss, the layer's largest difference), once the run ends."""
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            x_path.unlink(missing_ok=True)
        assert proc.returncode == 0, err[-2000:]
        words = out.split()
        return float(words[words.index("LOSS") + 1]), float(words[words.index("LAYER") + 1])

    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the cases, what the 8 ranks returned, the one-device and reference
    results)."""
    with one_thread():
        return _runs(tmp_path_factory.mktemp("sharded"))


def _runs(tmp):
    cases, want, ref = {}, {}, {}
    # dense train: the reference's state, two steps on one batch
    kw = dict(n_heads=4, n_kv_heads=4, head_dim=16)
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), **kw).validate()
    jcfg = dataclasses.replace(jget_config("olmo-1b").reduced(), **kw).validate()
    jst = JS.init_train_state(_key("olmo-train"), jcfg)
    jst["step"] = jnp.asarray(5, jnp.int32)
    toks, labels = _tokens("train", (8, 32), 256), _tokens("labels", (8, 32), 256)
    labels[:3, -5:] = -1                              # padded tails, uneven over the data axis
    state = train_state_from_reference(jax.device_get(jst), cfg, device="cpu")
    batch = {"tokens": toks, "labels": labels}
    cases["train"] = dict(kind="train", cfg=cfg, state=copy.deepcopy(state), batch=batch,
                          hyper=HYPER, steps=2)
    step = S.make_train_step(cfg, S.TrainHyper(**HYPER))
    _, _, grads = S._value_and_grad(cfg, state["params"], batch)
    losses, st = [], copy.deepcopy(state)
    for _ in range(2):
        st, m = step(st, batch, 1.0)
        losses.append(float(m["loss"]))
    want["train"] = {"losses": losses, "grads": grads}
    jstep = jax.jit(JS.make_train_step(jcfg, JS.TrainHyper(**HYPER)))
    jb = {"tokens": jnp.asarray(toks.numpy(), jnp.int32),
          "labels": jnp.asarray(labels.numpy(), jnp.int32)}
    ref["train"] = []
    for _ in range(2):
        jst, jm = jstep(jst, jb, 1.0)
        ref["train"].append(float(jm["loss"]))

    # MoE: the reference test's config, on its input and on drawn tokens
    moe_kw = dict(moe_num_experts=8, moe_top_k=2)
    mcfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), **moe_kw).validate()
    mcfg_j = dataclasses.replace(jget_config("olmoe-1b-7b").reduced(), **moe_kw).validate()
    mp = params_from_reference(jax.device_get(JM.init_params(jax.random.PRNGKey(0), mcfg_j)),
                               mcfg, device="cpu")
    same = {"tokens": torch.full((8, 16), 3, dtype=torch.long),
            "labels": torch.ones((8, 16), dtype=torch.long)}
    drawn = {"tokens": _tokens("moe", (8, 16), 256), "labels": _tokens("moe-l", (8, 16), 256)}
    x = _rng("moe-x").standard_normal((8, 16, mcfg.d_model)).astype(np.float32)
    layer = {k: v for k, v in mp["blocks"][0]["moe"].items()}
    cases["moe_same"] = dict(kind="loss", cfg=mcfg, params=mp, batch=same, settings=NO_DROP)
    cases["moe"] = dict(kind="loss", cfg=mcfg, params=mp, batch=drawn)
    cases["moe_no_drop"] = dict(kind="loss", cfg=mcfg, params=mp, batch=drawn, settings=NO_DROP)
    cases["moe_layer"] = dict(kind="moe_layer", cfg=mcfg, params=layer, x=torch.from_numpy(x),
                              settings=NO_DROP)
    with torch.no_grad():
        want["moe"] = float(M.loss_fn(mp, mcfg, drawn)[0])
        with _temp_settings(NO_DROP):
            want["moe_no_drop"] = float(M.loss_fn(mp, mcfg, drawn)[1]["ce"])
            want["moe_layer"] = moe.apply_moe(layer, torch.from_numpy(x), mcfg,
                                              strategy="gather")[0]
    reference_mesh_run = _reference_moe_on_a_mesh(moe_kw, x)     # beside what follows

    # serving: each case's prefill and decode logits
    serve = {"mixtral": ("mixtral-8x22b", {}, (2, 24), 64, 3, NO_DROP),
             "gqa": ("olmo-1b", {}, (8, 16), 32, 2, None),
             "hymba": ("hymba-1.5b", dict(n_heads=5, n_kv_heads=5, ssm_head_dim=64), (8, 16),
                       32, 2, None),
             "mamba": ("mamba2-780m", {}, (8, 16), 32, 2, None),
             "seamless": ("seamless-m4t-medium", {}, (8, 16), 32, 2, None),
             "vlm": ("llama-3.2-vision-11b", {}, (8, 16), 32, 2, None)}
    for name, (arch, kw, shape, cap, steps, settings) in serve.items():
        cfg, jcfg, jp, tp = _pair(arch, **kw)
        toks = _tokens(name, shape, cfg.vocab_size)
        modal = None
        if cfg.family in ("encdec", "vlm"):
            n = shape[1] if cfg.family == "encdec" else cfg.num_modal_tokens
            modal = torch.from_numpy(_rng("modal", name).standard_normal(
                (shape[0], n, cfg.d_model)).astype(np.float32))
        cases[name] = dict(kind="serve", cfg=cfg, params=tp, tokens=toks, capacity=cap,
                           decode_steps=steps, modal=modal, settings=settings or {})
        want[name] = _one_device_serve(cfg, tp, toks, cap, steps, modal, settings)
        if name in ("mixtral", "gqa"):
            with _reference_settings(settings):
                ref[name] = _reference_serve(jcfg, jp, toks, cap, steps)
    # the fallbacks trained: sequence-parallel attention, the SSM's head-dim split
    hcfg = cases["hymba"]["cfg"]
    hstate = {"params": cases["hymba"]["params"],
              "opt": {"m": _zeros(cases["hymba"]["params"]),
                      "v": _zeros(cases["hymba"]["params"]),
                      "count": torch.tensor(0, dtype=torch.int32)},
              "step": torch.tensor(5, dtype=torch.int32)}
    hb = {"tokens": _tokens("hymba-train", (8, 16), 256),
          "labels": _tokens("hymba-train-l", (8, 16), 256)}
    cases["hymba_train"] = dict(kind="train", cfg=hcfg, state=copy.deepcopy(hstate), batch=hb,
                                hyper=HYPER, steps=1)
    want["hymba_train"] = {"grads": S._value_and_grad(hcfg, hstate["params"], hb)[2]}
    cases["place"] = dict(kind="place", seed=7,
                          cfgs=[get_config(a).reduced().validate() for a in ALL_ARCHS])

    inp, out = tmp / "cases.pt", tmp / "out.pt"
    torch.save(cases, inp)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=workers.run, args=(r, port, str(inp), str(out)))
             for r in range(workers.WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ref["moe_same"], ref["moe_layer_diff"] = reference_mesh_run()
    return cases, torch.load(out, weights_only=False), want, ref


def _zeros(tree):
    return [_zeros(v) for v in tree] if isinstance(tree, list) else \
        {k: _zeros(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        torch.zeros_like(tree, dtype=torch.float32)


class _reference_settings:
    """The reference's MoE capacity factor for a block (its tunable singleton)."""

    def __init__(self, settings):
        from repro.launch import tuning

        self.inst = tuning.SINGLETONS["moe_dispatch"]
        self.cf = (settings or {}).get("torch_moe_dispatch", {}).get("capacity_factor")

    def __enter__(self):
        self.saved = dict(self.inst.settings)
        if self.cf:
            self.inst.settings = {**self.saved, "capacity_factor": self.cf}

    def __exit__(self, *exc):
        self.inst.settings = self.saved


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **tol)


# ------------------------------------------------------------------- tests
def test_a_dense_train_step_matches_one_device_and_the_reference(runs):
    _, got, want, ref = runs
    losses = got["train"]["losses"]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    _close(losses, want["train"]["losses"], rtol=RTOL)
    _close(losses, ref["train"], **F32)
    for g, w in zip(leaves(got["train"]["grads"]), leaves(want["train"]["grads"])):
        _close(g, w, rtol=RTOL, atol=RTOL * float(w.abs().max()))
    # FSDP (d_model on data) + TP (d_ff on model): the MLP's out-projection
    assert got["train"]["layout"] == "(Shard(dim=1), Shard(dim=0))"


def test_the_local_map_moe_matches_one_device_and_the_references_mesh_run(runs):
    _, got, want, ref = runs
    assert abs(got["moe_same"]["loss"] - ref["moe_same"]) < 1e-4
    assert abs(got["moe"]["loss"] - want["moe"]) < 0.1        # the reference's bound
    _close(got["moe_no_drop"]["ce"], want["moe_no_drop"], rtol=RTOL)
    y = want["moe_layer"]
    _close(got["moe_layer"]["y"], y, rtol=RTOL, atol=RTOL * float(y.abs().max()))


def test_the_references_mesh_moe_sums_other_tokens_ff_shards(runs):
    """The reference's shard_map keeps the sequence on ``model`` while the
    expert ff is split over ``model`` too, so its psum adds the ff shards of
    different tokens (ROADMAP, faults): on drawn inputs its layer is off by
    most of the output's scale, where the port's equals one device's."""
    _, _, want, ref = runs
    assert ref["moe_layer_diff"] > 0.25 * float(want["moe_layer"].abs().max())


@pytest.mark.parametrize("name", ["mixtral", "gqa", "hymba", "mamba", "seamless", "vlm"])
def test_sharded_serving_matches_one_device(runs, name):
    cases, got, want, ref = runs
    logits = got[name]["logits"]
    assert len(logits) == cases[name]["decode_steps"] + 1
    for g, w in zip(logits, want[name]):
        _close(g, w, rtol=RTOL, atol=RTOL * float(w.abs().max()))
    if name in ref:
        for g, w in zip(logits, ref[name]):
            _close(g, w, **MODEL_F32)


def test_the_decode_caches_stay_sequence_sharded(runs):
    _, got, _, _ = runs
    # batch on data, the (ring) cache's slots on model: never gathered
    for name in ("mixtral", "gqa", "hymba"):
        assert got[name]["cache_layout"]["k"] == "(Shard(dim=0), Shard(dim=1))", name
    assert got["seamless"]["cache_layout"]["xk"] == "(Shard(dim=0), Shard(dim=1))"


def test_the_fallbacks_train_to_one_devices_gradients(runs):
    _, got, want, _ = runs
    for g, w in zip(leaves(got["hymba_train"]["grads"]), leaves(want["hymba_train"]["grads"])):
        _close(g, w, rtol=RTOL, atol=RTOL * max(float(w.abs().max()), 1e-6))


def test_every_placed_leaf_reassembles_to_the_whole(runs):
    _, got, _, _ = runs
    place = got["place"]
    assert place["leaves"] > 500 and place["wrong_local_shapes"] == []
    assert place["max_diff"] == 0.0
