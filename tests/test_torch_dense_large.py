"""The two largest dense configs, Command-R-35B (tied 256k head, bias-free
LayerNorm) and DeepSeek-67B (RMSNorm, untied head), against the reference,
the per-layer parameter draw, and ``chip_smoke.py``'s serve-dense-large
phase rehearsed on the CPU.

The port's server on reduced command-r-35b and deepseek-67b (params from the
reference's init through ``convert.py``, float32) must give the reference
server's greedy streams exactly, at sync intervals 1 and 4.  The full-width
spec trees (DeepSeek cut to the 20 layers served on the card) equal the
reference's in shapes, axes, schemes and dtypes; nothing full-size is drawn
here.  ``init_leaf`` draws a stacked leaf one layer at a time into the leaf,
allocated once, through one reused float32 buffer: each layer is the
out-of-place formula applied to that layer's own draw, and no float32
tensor larger than one layer is made.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import types
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime.serve_loop import BatchedServer as JServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core import compilecache
from repro_torch.models import model as M
from repro_torch.models.layers import P, init_leaf, layer_axes, spec_leaves
from repro_torch.runtime.serve_loop import BatchedServer
from repro_torch.tree import leaves_with_paths
from torch_threads import one_thread

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["command-r-35b", "deepseek-67b"]
CAPACITY = 64
GB = 1e9


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


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jcfg, cfg = jget_config(name).reduced().validate(), get_config(name).reduced().validate()
    jparams = JM.init_params(jax.random.PRNGKey(zlib.crc32(name.encode()) % (1 << 31)), jcfg)
    return name, params_from_reference(jax.device_get(jparams), cfg, device="cpu"), cfg, \
        jparams, jcfg


def _prompts(name, n):
    rng = np.random.default_rng(zlib.crc32(f"dense-large {name}".encode()))
    return [rng.integers(2, 250, size=int(k)).astype(np.int32)
            for k in rng.integers(2, 40, size=n)]


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("interval", [1, 4])
def test_the_server_gives_the_reference_servers_streams(pair, interval):
    name, params, cfg, jparams, jcfg = pair
    assert cfg.tie_embeddings == (name == "command-r-35b")
    assert cfg.norm == ("layernorm" if name == "command-r-35b" else "rmsnorm")
    settings = {"max_batch": 3, "admission": 2, "prefill_chunk": 16, "sync_interval": interval}
    prompts = _prompts(name, 7)
    srv = BatchedServer(params, cfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                        settings=settings, device="cpu")
    ref = JServer(jparams, jcfg, capacity=CAPACITY, eos_id=-1, mode="continuous",
                  settings=settings)
    for p in prompts:
        srv.submit(p)
        ref.submit(p)
    srv.run(max_new_tokens=12)
    ref.run(max_new_tokens=12)
    got = {r.rid: list(r.tokens) for r in srv.results.values()}
    want = {r.rid: list(r.tokens) for r in ref.results.values()}
    assert len(got) == len(prompts) and all(len(s) == 12 for s in got.values())
    assert got == want


def _spec_rows(tree, dtype):
    return {path: (p.shape, p.logical, p.init, p.scale, str(p.with_dtype(dtype)).split(".")[-1])
            for path, p in leaves_with_paths(tree)}


@pytest.mark.parametrize("name,layers", [("deepseek-67b", 20), ("command-r-35b", 40)])
def test_the_full_width_specs_are_the_references(name, layers):
    """The served trees at full width (DeepSeek cut as on the card): spec
    trees only, nothing drawn."""
    cfg = dataclasses.replace(get_config(name), n_layers=layers).validate()
    jcfg = dataclasses.replace(jget_config(name), n_layers=layers).validate()
    mine = _spec_rows(M.param_specs(cfg), cfg.dtype)
    assert mine == _spec_rows(JM.param_specs(jcfg), jcfg.dtype)
    assert len([p for p in mine if p.startswith("blocks")]) > 0
    assert cfg.param_count() == jcfg.param_count()


def test_the_reckoning_of_the_two_served_models(chip_smoke):
    cr = chip_smoke.reckoning(chip_smoke.dense_large_cfg("command-r-35b"), 8192)
    ds = chip_smoke.reckoning(chip_smoke.dense_large_cfg("deepseek-67b"), 8192)
    assert round(cr["params"] / GB, 2) == 60.57 and round(cr["cache"] / GB, 2) == 10.74
    assert round(ds["params"] / GB, 2) == 31.04 and round(ds["cache"] / GB, 2) == 5.37
    assert cr["slice"] == 4 * 8192 * 22528 and ds["slice"] == 4 * 8192 * 22016
    assert cr["draw_limit"] == pytest.approx((cr["params"] + cr["slice"]) * 1.01)
    assert chip_smoke.dense_large_cfg("deepseek-67b").n_layers == 20
    assert chip_smoke.dense_large_cfg("command-r-35b") == get_config("command-r-35b")


# ------------------------------------------------------------- per-layer draw
def _std(p):
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    return p.scale / math.sqrt(max(fan_in, 1)) if p.init == "normal" else 0.02


STACKED = [P((3, 8, 24), ("layers", "d_model", "d_ff"), scale=0.7),
           P((4, 5, 7), ("layers", "d_model", "heads")),            # a layer of 35: not x16
           P((2, 3, 6, 10), ("layers", "layers", "d_model", "d_ff")),
           P((3, 40, 16), ("layers", "vocab", "d_model"), "embed")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", STACKED, ids=repr)
def test_each_layer_is_its_own_draw(p, dtype):
    k = layer_axes(p)
    got = init_leaf(torch.Generator().manual_seed(11), p, dtype, torch.device("cpu"))
    assert got.dtype == dtype and got.shape == p.shape
    gen = torch.Generator().manual_seed(11)
    for layer in got.view(-1, *p.shape[k:]):
        x = torch.randn(p.shape[k:], generator=gen, dtype=torch.float32)
        assert torch.equal(layer, (x * _std(p)).to(dtype))


class _Allocations(TorchDispatchMode):
    """Records every op's outputs (dtype, element count) and the allocations."""

    def __init__(self):
        super().__init__()
        self.outputs, self.empties = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.empties += func.overloadpacket is torch.ops.aten.empty
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.outputs.append((t.dtype, t.numel()))
        return out


@pytest.mark.parametrize("p", STACKED[:3], ids=repr)
def test_no_float32_tensor_outgrows_a_layer(p):
    k = layer_axes(p)
    layer = math.prod(p.shape[k:])
    gen = torch.Generator().manual_seed(3)
    with _Allocations() as seen:
        got = init_leaf(gen, p, torch.bfloat16, torch.device("cpu"))
    assert got.dtype == torch.bfloat16
    assert max(n for dt, n in seen.outputs if dt == torch.float32) == layer
    assert seen.empties == 2                    # the leaf, then one float32 buffer


def test_the_served_leaves_are_drawn_a_layer_at_a_time(chip_smoke):
    """Every normal leaf of the served trees' stacks has one layer axis; the
    largest float32 slice is Command-R's MLP layer, 0.74 GB."""
    for name in NAMES:
        specs = M.param_specs(chip_smoke.dense_large_cfg(name))
        stacked = [p for p in spec_leaves(specs["blocks"])]
        assert stacked and all(layer_axes(p) == 1 for p in stacked)
        assert layer_axes(specs["embed"]) == 0
    r = chip_smoke.reckoning(chip_smoke.dense_large_cfg("command-r-35b"), 8192)
    assert round(r["slice"] / GB, 2) == 0.74


# ------------------------------------------------------ chip_smoke rehearsals
def test_the_kernels_phase_checks_every_serve_dense_large_prefill(chip_smoke):
    checked = {case[:8] for case in chip_smoke.ATTN_CASES if case[8]}
    server = types.SimpleNamespace(capacity=chip_smoke.DENSE_LARGE_CAPACITY)
    for name, widths in chip_smoke.DENSE_LARGE_WIDTHS.items():
        cfg = chip_smoke.dense_large_cfg(name)
        for w in widths:
            assert (1, w, w, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window, 0) in checked
            assert BatchedServer._width_of(server, w) == w
        assert BatchedServer._width_of(server, max(widths) // 2 + 1) == max(widths) == 4096
    assert sorted(chip_smoke.DENSE_LARGE_WIDTHS["command-r-35b"]) == [
        *(2 ** k for k in range(1, 11)), 4096]


def test_the_timing_phase_times_command_rs_widest_prefill(chip_smoke):
    cfg = get_config("command-r-35b")
    b, s, h, kh, d, window = chip_smoke.ATTN_TIMED["command-r-35b prefill"]
    assert (b, h, kh, d, window) == (1, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0)
    assert s == max(chip_smoke.DENSE_LARGE_WIDTHS["command-r-35b"]) > chip_smoke.PLAIN_ROWS
    ms, by = chip_smoke.attention_bound_ms(b, s, h, kh, d, 2, chip_smoke.PEAK_BF16_FLOPS)
    assert by == "operations"
    flops = 4 * d * h * s * (s + 1) / 2                  # ~275 GFLOP: S(S+1)/2 pairs a head
    assert ms == pytest.approx(1e3 * flops / chip_smoke.PEAK_BF16_FLOPS)
    assert 0.27 < ms < 0.29


def test_the_plain_version_in_blocks_of_rows_is_the_whole(chip_smoke):
    from repro_torch.kernels.flash_attention import ref

    q, k, v = chip_smoke._qkv((1, 40, 40, 4, 2, 16, 0, 0, True), torch.float32, "cpu", seed=2)
    whole = ref.naive_attention(q, k, v, causal=True)
    assert torch.allclose(chip_smoke._plain_attention(ref, q, k, v, 0, 0, rows=16), whole,
                          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_the_serve_dense_large_phase_on_cpu(chip_smoke, name, monkeypatch):
    """The phase's reckoning, draw and serve at reduced size, then its
    graphs phase with one cache at a time: the graph path first, on the
    state the serve handed over, freed before the eager path."""
    cfg = get_config(name).reduced()
    widths = [2, 4, 8, 32]
    serve = chip_smoke.phase_serve_dense_large("cpu", "cpu", name, cfg=cfg, widths=widths,
                                               capacity=CAPACITY)
    assert serve["launches"] == {"flash_attention": 0, "ssd": 0, "rmsnorm": 0}
    assert sorted(set(serve["widths"])) == widths and serve["metrics"]["completed"] == 4
    assert len(compilecache._HANDED) == 1             # the serve's server handed over

    seen = []
    real = chip_smoke.serve_main_path

    def serve_path(device, cfg, *, step=None, **kw):
        seen.append((step, len(compilecache._HANDED)))
        return real(device, cfg, step="eager", **kw)    # no graphs on the CPU

    monkeypatch.setattr(chip_smoke, "serve_main_path", serve_path)
    monkeypatch.setattr(chip_smoke, "decode_step_timing",
                        lambda srv: {"events_ms": 0.0, "host_ms": 0.0})
    out = chip_smoke.phase_graphs("cpu", "cpu", {name: serve}, label="graphs-dense-large",
                                  one_cache=True)
    assert seen == [("graph", 1), ("eager", 0)] and not compilecache._HANDED
    assert set(out[name]) == {"graph", "eager"}


def test_a_draw_that_outgrows_its_reckoning_fails(chip_smoke, monkeypatch):
    cfg = get_config("deepseek-67b").reduced()
    real = chip_smoke.draw_params
    monkeypatch.setattr(chip_smoke, "draw_params",
                        lambda device, cfg: (lambda p, peak, held, s: (p, 2 * peak, held, s))(
                            *real(device, cfg)))
    with pytest.raises(AssertionError, match="peaked"):
        chip_smoke.phase_serve_dense_large("cpu", "cpu", "deepseek-67b", cfg=cfg, widths=[2],
                                           capacity=CAPACITY)


def test_the_train_phase_runs_once_without_a_resume(chip_smoke, tmp_path):
    cfg = get_config("olmo-1b").reduced()
    out = chip_smoke.train_main_path("cpu", cfg, batch=2, seq=32, steps=2, resume_to=None,
                                     ckpt_every=1, ckpt_dir=tmp_path)
    assert [[r["step"] for r in run["rows"]] for run in out["runs"]] == [[0, 1]]
    assert out["runs"][0]["ckpt"]["saves"] == 2 and out["continued"] == []
