"""The hybrid and VLM families trained as ``chip_smoke.py`` trains them on the
card, rehearsed on the CPU at reduced size: the train-hybrid phase (one step,
a checkpoint, a resumed step bit-equal to the state stepped on in memory),
the train-vlm phase (two runs, the same bits), the launch reckoning of the
kernels' autograd Functions for both families, the train-grad phase's
cover of every kernel shape the full-width train phases launch, the
dryrun-check path at ``decode_32k``, and reduced hymba-1.5b's
``run_training`` trajectory, killed and resumed, against the reference's.

Tolerances, float32 on the CPU.  The Functions' counting test: the same
plain arithmetic on both sides, so the loss is equal and the gradients
agree within tests/test_kernels.py's float32 grid tolerance (170·eps).
The trajectory: 8 compounded steps within 8 x the step tolerance of
tests/test_torch_train.py (4·170·eps relative on the loss, lr and
gradient norm); the resumed steps equal the killed run's to the bit.
Inputs are drawn with numpy from ``zlib.crc32`` seeds."""
from __future__ import annotations

import importlib.util
import inspect
import math
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.runtime import steps as JS
from repro.runtime import train_loop as jtrain_loop
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_reference
from repro_torch.core import compilecache, configstore
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import shapes
from repro_torch.models import model as M
from repro_torch.models.transformer import stack_workload
from repro_torch.runtime import steps as S
from repro_torch.runtime import train_loop
from repro_torch.tree import leaves, tree_map
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
EPS = float(np.finfo(np.float32).eps)
GRID = dict(rtol=170 * EPS, atol=170 * EPS)
STEP_REL = 4 * 170 * EPS
NAMES = ("hymba-1.5b", "llama-3.2-vision-11b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def no_handed_over_state():
    yield
    compilecache.drop_handed_over()


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


# ------------------------------------------------------------- the two phases
def test_the_train_hybrid_phase_on_cpu(chip_smoke):
    """train-hybrid's body on reduced hymba-1.5b past its window: the first
    run takes step 0 and checkpoints, the second resumes at step 1, and its
    step is the bits of the first run's state stepped on in memory (the
    phase raises otherwise); no kernel launches on the CPU."""
    cfg = get_config("hymba-1.5b").reduced()
    b, s = 2, 32
    assert s > cfg.window and chip_smoke.HYBRID_TRAIN[1] > get_config("hymba-1.5b").window
    out = chip_smoke.phase_train_hybrid("cpu", "cpu", cfg=cfg, batch=b, seq=s)
    first, second = out["runs"]
    assert [r["step"] for r in first["rows"]] == [0]
    assert [r["step"] for r in second["rows"]] == [1]
    assert first["ckpt"]["saves"] == 1 and second["ckpt"]["saves"] == 1
    assert [r["step"] for r in out["continued"]] == [1]
    assert out["continued"][0]["loss"] == second["rows"][0]["loss"]
    assert all(math.isfinite(r["loss"]) for r in first["rows"] + second["rows"])
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}


def test_the_train_vlm_phase_on_cpu(chip_smoke):
    """train-vlm's body on the reduced VLM cut to one group: both runs give
    the same bits (the phase raises otherwise), the modal tokens ride in
    every batch; the full-width cut is 5 layers, 2.183 B params, and 6
    attention calls a step."""
    out = chip_smoke.phase_train_vlm("cpu", "cpu", cfg=get_config("llama-3.2-vision-11b").reduced(),
                                     batch=2, seq=16, steps=2)
    a, b = (run["rows"] for run in out["runs"])
    assert [(r["loss"], r["grad_norm"]) for r in a] == [(r["loss"], r["grad_norm"]) for r in b]
    assert out["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    small = chip_smoke.vlm_train_cfg(get_config("llama-3.2-vision-11b").reduced())
    assert small.n_layers == small.cross_attn_period
    full = chip_smoke.vlm_train_cfg()
    assert full.n_layers == full.cross_attn_period == 5 and full.d_model == 4096
    assert round(full.param_count() / 1e9, 3) == 2.183
    assert chip_smoke.attention_passes(full) == 5 + 1
    assert chip_smoke._expected_launches(full, 2) == {"flash_attention": 12, "ssd": 0,
                                                      "rmsnorm": 0}


def test_the_hybrid_step_grad_phase_on_cpu(chip_smoke):
    """The 2-layer float32 whole-step check on reduced hymba: one depth, one
    dtype, the SSD pinned with the attention (on the CPU both paths are the
    plain one, so they agree exactly)."""
    out = chip_smoke.phase_train_step_grad_hybrid("cpu", "cpu", cfg=get_config("hymba-1.5b")
                                                  .reduced(), batch=2, seq=32)
    assert set(out) == {"float32 2 layers"}
    row = out["float32 2 layers"]
    assert row["grad_norm_rel"] == 0.0 and row["worst_leaf_rel"] == 0.0
    assert row["tol"] == list(chip_smoke.STEP_GRAD_TOL["float32"])


def test_train_flops_count_the_window(chip_smoke):
    """The MFU numerator counts the keys a windowed causal mask keeps: at
    seq 4096 and window 2048, 1536 a query on average, not 2048."""
    cfg = get_config("hymba-1.5b")
    b, s = chip_smoke.HYBRID_TRAIN
    keys = sum(min(t + 1, cfg.window) for t in range(s)) / s
    want = 6.0 * cfg.active_param_count() * b * s + 12.0 * cfg.n_heads * cfg.hd \
        * cfg.n_layers * b * s * keys
    assert chip_smoke.train_flops(cfg, b, s) == pytest.approx(want, rel=1e-3)


def test_an_overflowing_gradient_norm_zeroes_the_update_as_in_the_reference():
    """hymba-1.5b's seed-0 gradient at full depth is ~1e20 (on the card), so
    the float32 sum of squares of ``global_norm`` overflows.  Both packages'
    AdamW then report an +inf norm, clip by a factor of 0 and leave the
    moments at zero and the parameters at their weight decay alone: the
    train-hybrid phase's +inf norm is the reference's arithmetic, not a
    fault of the port."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw

    rng = _rng("overflow")
    shapes_ = [(64, 8), (8,), (3, 5, 7)]
    grads = [rng.standard_normal(sh).astype(np.float32) for sh in shapes_]
    grads[0] *= np.float32(1e19)                  # a square passes float32's 3.4e38
    params = [rng.standard_normal(sh).astype(np.float32) for sh in shapes_]
    lr = 1e-3
    jp, jst, jm = jadamw.adamw_update([jnp.asarray(g) for g in grads],
                                      jadamw.adamw_init([jnp.asarray(p) for p in params]),
                                      [jnp.asarray(p) for p in params], lr=jnp.float32(lr))
    tp = [torch.from_numpy(p.copy()) for p in params]
    tp, tst, tm = adamw.adamw_update([torch.from_numpy(g) for g in grads], adamw.adamw_init(tp),
                                     tp, lr=lr)
    assert math.isinf(float(jm["grad_norm"])) and math.isinf(float(tm["grad_norm"]))
    for got, want, p in zip(tp, jp, params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRID)
        np.testing.assert_allclose(got.numpy(), p * (1 - lr * 0.1), **GRID)
    for leaf in leaves(tst["m"]) + leaves(tst["v"]):
        assert not leaf.any()


def test_the_norm_by_depth_diagnostic_on_cpu(chip_smoke):
    """The diagnostic that measured hymba's norm against depth on the card,
    at reduced size: a row per cut depth and one at full depth in float32,
    the float64 sum beside the step's float32 ``global_norm``, no
    non-finite element."""
    cfg = get_config("hymba-1.5b").reduced()
    out = chip_smoke.hybrid_norm_by_depth("cpu", "cpu", cfg=cfg, batch=2, seq=32, depths=(1,))
    assert set(out) == {"float32 1 layers", f"float32 {cfg.n_layers} layers"}
    for row in out.values():
        assert row["non_finite"] == 0 and math.isfinite(row["loss"])
        assert row["global_norm"] == pytest.approx(row["norm_f64"], rel=1e-5)
        assert 0 < row["max_abs"] <= row["norm_f64"]


def test_the_norm_overflow_check(chip_smoke):
    """train-hybrid's finiteness check: an +inf norm passes only with a
    final state to hold, and only when every leaf of it is finite; a NaN
    norm or a non-finite leaf fails."""
    rows = [{"step": 0, "loss": 10.8, "grad_norm": math.inf}]
    state = {"params": {"w": torch.ones(3)}, "step": torch.tensor(1)}
    chip_smoke._check_finite(rows, state)
    with pytest.raises(AssertionError, match="non-finite loss or gradient norm"):
        chip_smoke._check_finite(rows)
    with pytest.raises(AssertionError, match="non-finite loss or gradient norm"):
        chip_smoke._check_finite([{**rows[0], "grad_norm": math.nan}], state)
    with pytest.raises(AssertionError, match="non-finite state leaves"):
        chip_smoke._check_finite(rows, {"params": {"w": torch.tensor([1.0, math.nan])}})


# ---------------------------------------- the Functions' launch reckoning
def _batch(cfg, b=4, s=32):
    rng = _rng("batch", cfg.name)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        batch["modal"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_modal_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_the_functions_launch_as_the_train_phases_reckon(monkeypatch, chip_smoke, name, remat):
    """The model's attention and SSD calls routed through the kernels'
    Functions (launches monkeypatched to the plain forward, counted as the
    wrappers count): a train step gives the plain path's loss and
    gradients, and each kernel launches what chip_smoke holds the card to,
    ``_expected_launches(cfg, _remat_factor(...))``: hymba 2 layers x both
    kernels, the VLM its layers plus a cross block a group, each x (1 + the
    recompute ``remat`` implies)."""
    cfg = get_config(name).reduced().validate()
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    batch = _batch(cfg)
    b, s = batch["tokens"].shape

    def grads():
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        it = iter(live)
        loss, _ = M.loss_fn(tree_map(lambda _: next(it), params), cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, live)

    wl = stack_workload(cfg.family, b, s, cfg.n_layers)
    configstore.set_override("torch_layer_stack", wl, {"remat": remat})
    try:
        want_loss, want = grads()
        counts = {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}

        def attn(q, k, v, causal, window, q_offset, bq, bkv, scale):
            counts["flash_attention"] += 1
            return attn_ref.naive_attention(q, k, v, causal=causal, window=window,
                                            q_offset=q_offset, scale=scale)

        def ssd(x, dt, A, B_, C, D, chunk, rs):
            counts["ssd"] += 1
            out = ssd_ref.ssd_chunked(x, dt, A, B_, C, D, chunk=ssd_ref.align_chunk(
                chunk, x.shape[1]), return_state=True)
            return out if rs else (out[0], None)

        monkeypatch.setattr(fa_kernel, "_launch", attn)
        monkeypatch.setattr(ssd_kernel, "_launch", ssd)
        monkeypatch.setattr(attn_ops.kernel, "flash_attention",
                            lambda q, k, v, causal, window, q_offset, block_q, block_kv:
                            fa_kernel.FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                                             block_q, block_kv, None))
        monkeypatch.setattr(ssd_ops.kernel, "ssd",
                            lambda x, dt, A, B_, C, D, chunk, init_state, return_state:
                            ssd_kernel.SsdFn.apply(x, dt, A, B_, C, D, chunk, return_state))
        got_loss, got = grads()
        factor = chip_smoke._remat_factor(cfg, b, s)
    finally:
        configstore.clear_override("torch_layer_stack", wl)
    assert float(got_loss) == float(want_loss)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **GRID)
    assert factor == (1 if remat == "none" else 2)
    assert counts == chip_smoke._expected_launches(cfg, factor)
    assert counts["flash_attention"] == factor * (
        cfg.n_layers + (cfg.n_layers // cfg.cross_attn_period if cfg.family == "vlm" else 0))
    assert counts["ssd"] == (factor * cfg.n_layers if cfg.family == "hybrid" else 0)


# ------------------------------------- train-grad covers every train shape
def _train_phases(chip_smoke):
    """(full config name, batch, seq, modal frames a row, depth cut) of each
    full-width train phase, as ``chip_smoke.main`` runs it."""
    train = inspect.signature(chip_smoke.phase_train).parameters
    moe = inspect.signature(chip_smoke.phase_train_moe).parameters
    vlm = chip_smoke.vlm_train_cfg()
    return [
        ("olmo-1b", train["batch"].default, train["seq"].default, 0),        # train
        ("mamba2-780m", 4, 1024, 0),                                         # train-ssm
        ("olmoe-1b-7b", moe["batch"].default, moe["seq"].default, 0),       # train-moe
        ("seamless-m4t-medium", *chip_smoke.XATTN_TRAIN, chip_smoke.XATTN_TRAIN[1]),
        ("hymba-1.5b", *chip_smoke.HYBRID_TRAIN, 0),                          # train-hybrid
        (vlm.name, *chip_smoke.VLM_TRAIN, vlm.num_modal_tokens),             # train-vlm
    ]


def test_train_grad_holds_every_kernel_shape_of_the_train_phases(chip_smoke, monkeypatch):
    """Every attention and SSD call a full-width train phase makes, recorded
    on the CPU: each phase's reduced config runs a forward at one row of the
    phase's sequence (and its frames), and every call's shape is widened to
    the full config's heads, head dims, window, state and groups and to the
    phase's batch.  Each must be in ``TRAIN_GRAD_SHAPES``, where the
    train-grad phase holds the kernel's Function to its plain version, and
    every entry there must be one a phase launches."""
    seen_attn, seen_ssd = [], []
    real_attn, real_ssd = attn_ops.flash_attention, ssd_ops.ssd

    def spy_attn(q, k, v, **kw):
        seen_attn.append((q.shape[1], k.shape[1], kw["window"], kw["q_offset"], kw["causal"]))
        return real_attn(q, k, v, **kw)

    def spy_ssd(x, dt, A, B_, C, D=None, **kw):
        seen_ssd.append(x.shape[1])
        return real_ssd(x, dt, A, B_, C, D, **kw)

    monkeypatch.setattr(attn_ops, "flash_attention", spy_attn)
    monkeypatch.setattr(ssd_ops, "ssd", spy_ssd)
    wanted = set()
    for name, b, s, frames in _train_phases(chip_smoke):
        seen_attn.clear()
        seen_ssd.clear()
        full, small = get_config(name), get_config(name).reduced()
        params = M.init_params(small, torch.Generator().manual_seed(0), device="cpu")
        modal = (torch.zeros((1, frames, small.d_model)) if frames else None)
        with torch.no_grad():
            M.forward(params, small, torch.zeros((1, s), dtype=torch.long), modal)
        assert seen_attn or seen_ssd, name
        wanted |= {(b, sq, sk, full.n_heads, full.n_kv_heads, full.hd,
                    full.window if w else 0, o, c) for sq, sk, w, o, c in seen_attn}
        wanted |= {(b, ss, full.ssm_heads, full.ssm_head_dim, full.ssm_state, full.ssm_groups)
                   for ss in seen_ssd}
    have = set(chip_smoke.TRAIN_GRAD_SHAPES.values())
    assert wanted <= have, sorted(wanted - have)
    assert have <= wanted, sorted(have - wanted)
    kinds = {chip_smoke.grad_kind(n): len(c) for n, c in chip_smoke.TRAIN_GRAD_SHAPES.items()}
    assert kinds == {"attention": 9, "ssd": 6}
    assert chip_smoke.TRAIN_GRAD_SHAPES["hymba-1.5b attention"] == (2, 4096, 4096, 25, 5, 64,
                                                                    2048, 0, True)
    assert chip_smoke.TRAIN_GRAD_SHAPES["hymba-1.5b ssd"] == (2, 4096, 25, 128, 16, 1)
    assert chip_smoke.TRAIN_GRAD_SHAPES["llama-3.2-vision-11b cross attention"] == (
        4, 2048, 1601, 32, 8, 128, 0, 0, False)


# ----------------------------------------------- dryrun-check at decode_32k
@pytest.mark.parametrize("arch", ["starcoder2-15b", "hymba-1.5b", "mamba2-780m"])
def test_the_dryrun_check_path_at_decode_32k_on_cpu(chip_smoke, arch):
    """dryrun-check's body at the real ``decode_32k`` shape (batch 128,
    context 32768) on the reduced config: the record is made, an eager
    decode step runs (nothing is measured on the CPU), and the phase's
    reckoning of params and decode state is the record's argument bytes
    less the step's integer inputs."""
    assert arch in chip_smoke.DRYRUN_CHECK_ARCHS and "decode_32k" in chip_smoke.DRYRUN_CHECK_SHAPES
    shape = shapes.SHAPES["decode_32k"]
    assert (shape.global_batch, shape.seq_len) == (128, 32768)
    cfg = get_config(arch).reduced()
    out = chip_smoke.dryrun_check_path("cpu", arch, cfg=cfg, shape=shape)
    rec = out["record"]
    assert rec["status"] == "ok" and set(out) == {"record"}
    rk = chip_smoke.cell_reckoning(cfg, shape.global_batch, shape.seq_len)
    inputs = rec["memory"]["argument_size_in_bytes"] - rk["total"]
    assert 0 <= inputs <= 3 * 8 * shape.global_batch
    assert rec["per_device_bytes"] >= rec["memory"]["argument_size_in_bytes"]


def test_the_full_decode_32k_reckonings(chip_smoke):
    """The three cells' params and decode state at full size, from specs:
    starcoder2-15b's 4096-slot ring cache at batch 128 is 42.9 GB beside
    31.9 GB of params; hymba's ring of 2048 slots and float32 SSD state
    11.7 GB; mamba2's SSD state 9.8 GB."""
    got = {a: chip_smoke.cell_reckoning(get_config(a), 128, 32768) for a in
           chip_smoke.DRYRUN_CHECK_ARCHS}
    sc = get_config("starcoder2-15b")
    assert got["starcoder2-15b"]["cache"] == sc.n_layers * 2 * 128 * 4096 * sc.n_kv_heads \
        * sc.hd * 2
    assert round(got["starcoder2-15b"]["total"] / 1e9, 1) == 74.9
    m2 = get_config("mamba2-780m")
    ssd_state = m2.n_layers * 128 * m2.ssm_heads * m2.ssm_head_dim * m2.ssm_state * 4
    assert ssd_state < got["mamba2-780m"]["cache"] < 1.02 * ssd_state
    assert round(got["hymba-1.5b"]["total"] / 1e9, 1) == 14.9


# ------------------------------- run_training: the reference's trajectory
class _Killed(Exception):
    pass


def _reference_state(name, jcfg):
    """The reference's initial state with drawn moments (mid-training
    values, as tests/test_torch_train.py draws them), at step 0."""
    st = JS.init_train_state(jax.random.PRNGKey(zlib.crc32(name.encode()) % (1 << 31)), jcfg)
    rng = _rng("moments", name)
    st["opt"]["m"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0.0, 1e-2, x.shape), jnp.float32), st["opt"]["m"])
    st["opt"]["v"] = jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(1e-4, 1e-3, x.shape), jnp.float32), st["opt"]["v"])
    st["opt"]["count"] = jnp.asarray(0, jnp.int32)
    st["step"] = jnp.asarray(0, jnp.int32)
    return st


def test_hybrid_run_training_killed_and_resumed_matches_reference(monkeypatch, tmp_path):
    """8 steps of reduced hymba-1.5b (seq 32 past its window of 16) through
    the reference's ``run_training``, and through the port's twice: a first
    run killed after step 4 (an exception out of ``on_step``, blocking
    checkpoints every 3 steps, so the newest is step 2's), then a second
    run on the same directory to step 8, which resumes at step 3.  Both
    packages start from one state (the reference's params with drawn
    moments; both inits are monkeypatched to return it).  The resumed
    steps 3 and 4 are the killed run's bits; the stitched trajectory's
    losses, lrs and gradient norms are the reference's within 8 x the step
    tolerance."""
    jcfg = jget_config("hymba-1.5b").reduced().validate()
    tcfg = get_config("hymba-1.5b").reduced().validate()
    assert 32 > tcfg.window
    init = _reference_state("hybrid-trajectory", jcfg)
    host = jax.device_get(init)
    monkeypatch.setattr(jtrain_loop, "init_train_state", lambda key, cfg: init)
    monkeypatch.setattr(train_loop, "init_train_state",
                        lambda cfg, gen, device: train_state_from_reference(host, cfg, device))
    hyper = dict(base_lr=1e-3, warmup=2, total=50)
    kw = dict(n_steps=8, global_batch=2, seq_len=32, seed=0)
    want = jtrain_loop.run_training(jcfg, hyper=JS.TrainHyper(**hyper), **kw)

    def kill_after_step_4(step, metrics):
        if step == 4:
            raise _Killed(step)

    port = dict(hyper=S.TrainHyper(**hyper), ckpt_dir=str(tmp_path), ckpt_every=3,
                ckpt_overrides={"mode": "blocking"}, device="cpu", **kw)
    killed = []
    with pytest.raises(_Killed):
        train_loop.run_training(tcfg, on_step=lambda s, m: (killed.append((s, m)),
                                                            kill_after_step_4(s, m)), **port)
    assert [s for s, _ in killed] == [0, 1, 2, 3, 4]
    resumed = []
    got = train_loop.run_training(tcfg, on_step=lambda s, m: resumed.append((s, m)), **port)
    assert [s for s, _ in resumed] == [3, 4, 5, 6, 7]
    for (s, a), (_, b) in zip(killed[3:], resumed[:2]):
        assert (a["loss"], a["grad_norm"], a["lr"]) == (b["loss"], b["grad_norm"], b["lr"]), s
    history = [m for _, m in killed[:3]] + got["history"]
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in history],
                                   [h[key] for h in want["history"]],
                                   rtol=8 * STEP_REL, err_msg=key)
