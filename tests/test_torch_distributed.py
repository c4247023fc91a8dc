"""The port's collectives, gradient compression and elastic re-planning
(``repro_torch.parallel.collectives``, ``repro_torch.optim.compress``,
``repro_torch.runtime.elastic``).

The ring and psum matmuls and ``compressed_psum`` run on a real
``torch.distributed`` group: 2 and 4 ranks spawned on this CPU over gloo
on localhost (tests/torch_dist_workers.py), held to the dense product in
float32 (rtol 1e-5: the shards are summed in another order) and to the sum
of the dequantized shards (exactly: the same operations in rank order).  The
int8 round trip and the error-feedback tree are bit-equal to the
reference's on seeded inputs (``torch.round`` and ``jnp.round`` both round
half to even).  The elastic factorization equals the reference's, and a
reshard of a state onto 8 ranks reassembles to the state.
"""
from __future__ import annotations

import math
import multiprocessing
import socket
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.optim import compress as jcompress
from repro.runtime import elastic as jelastic
from repro_torch.launch.mesh import MESHES
from repro_torch.models.layers import P
from repro_torch.optim import compress
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import elastic

RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """Every rank's results, from ``world`` spawned processes."""
    world = request.param
    out = tmp_path_factory.mktemp(f"world{world}")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=workers.run, args=(r, world, port, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return world, [torch.load(out / f"rank{r}.pt") for r in range(world)]


def test_ring_allgather_matmul_matches_dense(ranks):
    world, res = ranks
    x, w, _, _, _ = workers.inputs(world)
    want = x @ w
    for r, got in enumerate(res):
        cols = want[:, :, r * workers.N:(r + 1) * workers.N]
        assert got["ring"].shape == cols.shape
        np.testing.assert_allclose(got["ring"].numpy(), cols.numpy(), rtol=RTOL, atol=RTOL)


def test_psum_matmul_matches_dense(ranks):
    world, res = ranks
    _, _, xk, wk, _ = workers.inputs(world)
    want = (xk @ wk).numpy()
    for got in res:
        np.testing.assert_allclose(got["psum"].numpy(), want, rtol=RTOL, atol=RTOL)


def test_compressed_psum_is_the_sum_of_the_dequantized_shards(ranks):
    world, res = ranks
    g = workers.inputs(world)[4]
    want = torch.zeros_like(g[0])
    for gr in g:
        want += compress.dequantize_int8(*compress.quantize_int8(gr))
    for got in res:
        assert torch.equal(got["compressed"], want)
    assert (want - sum(g)).abs().max() <= sum(gr.abs().max() / 127 for gr in g)


def test_a_device_mesh_is_built_over_the_process_group(ranks):
    world, res = ranks
    assert all(r["mesh"] == ((1, world), ("data", "model")) for r in res)


def test_a_device_mesh_needs_a_process_group_of_its_size():
    from repro_torch.launch.mesh import device_mesh

    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(MESHES["single"], "cpu")


def test_a_world_of_one_is_the_plain_product():
    x, w, xk, wk, g = workers.inputs(1)
    assert collectives.world() == (0, 1)
    assert torch.equal(collectives.ring_allgather_matmul(x, w), x @ w)
    assert torch.equal(collectives.psum_matmul(xk, wk), xk @ wk)
    assert torch.equal(compress.compressed_psum(g[0]),
                       compress.dequantize_int8(*compress.quantize_int8(g[0])))


# ------------------------------------------------------- against the reference
def _draw(tag, shape):
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "bf16"])
def test_quantize_int8_is_bit_equal_to_the_references(case):
    x = _draw(f"quant/{case}", (64, 33))
    if case == "ties":   # max 127 makes the scale exactly 1: halves round to even
        x = np.array([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -126.5], np.float32)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if case == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = compress.quantize_int8(tx)
    jq, js = jcompress.quantize_int8(jx)
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.float32 and s.item() == float(js)
    np.testing.assert_array_equal(compress.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcompress.dequantize_int8(jq, js)))
    if case == "ties":
        assert q.tolist() == [127, 2, 4, -2, 0, 0, 2, -126]


def test_ef_compress_tree_is_bit_equal_to_the_references():
    grads = {"a": _draw("ef/a", (16, 8)), "b": {"c": _draw("ef/c", (5,)),
                                                "d": _draw("ef/d", (3, 4, 2))}}
    err = {"a": _draw("ef/ea", (16, 8)) * 1e-3,
           "b": {"c": _draw("ef/ec", (5,)) * 1e-3, "d": np.zeros((3, 4, 2), np.float32)}}

    def tmap(fn, t):
        return {k: tmap(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)

    dec, new_err, bits = compress.ef_compress_tree(tmap(torch.from_numpy, grads),
                                                   tmap(torch.from_numpy, err))
    jdec, jerr, jbits = jcompress.ef_compress_tree(tmap(jnp.asarray, grads),
                                                   tmap(jnp.asarray, err))
    assert bits == jbits == (16 * 8 + 5 + 24) * 8
    for path in (("a",), ("b", "c"), ("b", "d")):
        got, want, ge, we = dec, jdec, new_err, jerr
        for k in path:
            got, want, ge, we = got[k], want[k], ge[k], we[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


def test_usable_factorization_equals_the_references():
    for n in range(1, 65):
        for prefer in (1, 2, 4, 8, 16, 32):
            assert elastic.usable_factorization(n, prefer) == \
                jelastic.usable_factorization(n, prefer), (n, prefer)


def test_replan_mesh_keeps_the_model_axis_near_the_old_one():
    m = elastic.replan_mesh(24, prefer_model=16)
    assert m.shape == (("data", 2), ("model", 12)) and m.size == 24
    assert elastic.replan_mesh(1).shape == (("data", 1), ("model", 1))
    coords = [elastic.rank_coords(m, r) for r in range(m.size)]
    assert coords[0] == {"data": 0, "model": 0} and coords[13] == {"data": 1, "model": 1}
    assert len({tuple(sorted(c.items())) for c in coords}) == 24
    with pytest.raises(ValueError):
        elastic.rank_coords(m, 24)


def _state():
    specs = {"w": P((16, 32), ("d_model", "d_ff")),
             "e": P((8, 16, 64), ("experts", "d_model", "expert_ff")),
             "blocks": [{"k": P((4, 8, 2, 16), ("batch", "cache_seq", "kv_heads", "head_dim"))}],
             "scale": P((16,), ("d_model",))}
    state = {"w": torch.arange(16 * 32.0).reshape(16, 32),
             "e": torch.arange(8 * 16 * 64.0).reshape(8, 16, 64),
             "blocks": [{"k": torch.arange(4 * 8 * 2 * 16.0).reshape(4, 8, 2, 16)}],
             "scale": torch.arange(16.0)}
    return specs, state


def test_reshard_round_trip_on_eight_ranks():
    """Every rank's shard under the train rules on (data 2, model 4), put
    back at its offsets, covers each leaf exactly once and equals it."""
    specs, state = _state()
    mesh = elastic.replan_mesh(8, prefer_model=4)
    rules = shd.train_rules()
    shards = [elastic.reshard_state(state, specs, rules, mesh, rank=r) for r in range(8)]

    def rebuild(path):
        p, full = specs, state
        for k in path:
            p, full = p[k], full[k]
        out = torch.full_like(full, float("nan"))
        hits = torch.zeros_like(full)
        spec = shd.spec_for(p, rules, mesh)
        for r, sh in enumerate(shards):
            leaf = sh
            for k in path:
                leaf = leaf[k]
            assert tuple(leaf.shape) == shd.local_shape(p, rules, mesh)
            coords = elastic.rank_coords(mesh, r)
            idx = []
            for dim, entry in enumerate(spec):
                axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
                i = 0
                for a in axes:
                    i = i * mesh.sizes[a] + coords[a]
                idx.append(slice(i * leaf.shape[dim], (i + 1) * leaf.shape[dim]))
            out[tuple(idx)] = leaf
            hits[tuple(idx)] += 1
        parts = math.prod(n for n in (math.prod(mesh.sizes[a] for a in
                                                (() if e is None else (e,) if isinstance(e, str)
                                                 else e)) for e in spec))
        assert torch.equal(out, full) and (hits == 8 / parts).all()

    assert shd.spec_for(specs["w"], rules, mesh) == ("data", "model")
    for path in (("w",), ("e",), ("blocks", 0, "k"), ("scale",)):
        rebuild(path)


def test_reshard_on_one_card_is_the_whole_leaf_on_the_device():
    specs, state = _state()
    out = elastic.reshard_state(state, specs, shd.serve_rules(), MESHES["one"], device="cpu")
    assert all(torch.equal(out[k], state[k]) for k in ("w", "e", "scale"))
    assert torch.equal(out["blocks"][0]["k"], state["blocks"][0]["k"])
