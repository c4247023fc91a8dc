"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``).

``spec_for`` must resolve the same mesh axes as the reference's on the
production meshes (data 16 × model 16, and pod 2 × data 16 × model 16),
exactly, for every leaf of every architecture's parameters, train state and
decode caches, under the train and the serve rules.  The reference resolves
on ``AbstractMesh`` (no devices); the port on its axis-size tables.  The
port holds caches one dict per layer where the reference stacks them on
leading ``layers`` axes, which no rule shards: a per-layer leaf's spec is
the reference's less those axes.  Then copies of tests/test_sharding.py's
cases on the port's meshes.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro.compat import abstract_mesh
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.parallel import sharding as jshd
from repro.runtime import steps as jsteps
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.launch.mesh import MESHES
from repro_torch.models import model as M
from repro_torch.models.layers import P
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import steps

J_MESHES = {"single": abstract_mesh((16, 16), ("data", "model")),
            "multi": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
RULES = {"train": (shd.train_rules, jshd.train_rules),
         "serve": (shd.serve_rules, jshd.serve_rules)}


def _ref_leaves(tree, prefix=""):
    """path → reference P (dict keys joined by "/")."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _port_leaves(tree, prefix="", depth=0):
    """(path, list depth, P): list items (the port's per-layer dicts) are
    entered without a path component; ``depth`` counts them."""
    if isinstance(tree, P):
        yield prefix, depth, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{prefix}/{k}" if prefix else k, depth)
    else:
        for v in tree:
            yield from _port_leaves(v, prefix, depth + 1)


def _compare(port_tree, ref_tree, which, mesh_name):
    rules, jrules = (f(mesh_name == "multi") for f in RULES[which])
    ref = _ref_leaves(ref_tree)
    seen = set()
    for path, depth, p in _port_leaves(port_tree):
        r = ref[path]
        seen.add(path)
        assert tuple(r.shape[depth:]) == p.shape and tuple(r.logical[depth:]) == p.logical, path
        want = tuple(jshd.spec_for(r, jrules, J_MESHES[mesh_name]))
        want = want + (None,) * (len(r.shape) - len(want))
        assert all(a is None for a in want[:depth]), (path, want)
        assert shd.spec_for(p, rules, MESHES[mesh_name]) == want[depth:], (path, which)
    assert seen == set(ref)


def test_the_archs_are_the_references():
    assert ALL_ARCHS == J_ARCHS


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("which", ["train", "serve"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_for_equals_the_references_on_every_leaf(arch, which, mesh_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    _compare(M.param_specs(cfg), JM.param_specs(jcfg), which, mesh_name)
    _compare(steps.train_state_specs(cfg), jsteps.train_state_specs(jcfg), which, mesh_name)
    for batch, context in ((128, 32768), (1, 524288)):
        _compare(M.cache_specs(cfg, batch, context, enc_len=context),
                 JM.cache_specs(jcfg, batch, context, enc_len=context), which, mesh_name)


def test_local_shapes_divide_the_leaf_and_reassemble_it():
    """One device's shard times the mesh axes it is split over is the leaf."""
    mesh = MESHES["single"]
    for arch in ("deepseek-67b", "mixtral-8x22b", "hymba-1.5b"):
        cfg = get_config(arch)
        for p in (p for _, _, p in _port_leaves(M.param_specs(cfg))):
            spec = shd.spec_for(p, shd.train_rules(), mesh)
            local = shd.local_shape(p, shd.train_rules(), mesh)
            for dim, entry, n in zip(p.shape, spec, local):
                axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
                assert n * math.prod(mesh.sizes[a] for a in axes) == dim
            itemsize = 4 if p.dtype == "float32" else 2
            assert shd.local_bytes(p, shd.train_rules(), mesh, torch.bfloat16) == (
                math.prod(local) * itemsize)


def test_nothing_shards_on_one_card():
    cfg = get_config("deepseek-67b")
    specs = M.param_specs(cfg)
    assert all(s == (None,) * len(p.shape) for _, _, p in _port_leaves(specs)
               for s in [shd.spec_for(p, shd.train_rules(), MESHES["one"])])
    total = shd.tree_local_bytes(specs, shd.serve_rules(), MESHES["one"], torch.bfloat16)
    assert total == 2 * cfg.param_count()


# ------------------------------------------------ tests/test_sharding.py's cases
def spec(p, rules, mesh=MESHES["single"]):
    return shd.spec_for(p, rules, mesh)


def test_train_fsdp_tp_basic():
    r = shd.train_rules()
    wq = P((8192, 64, 128), ("d_model", "heads", "head_dim"))
    assert spec(wq, r) == ("data", "model", None)


def test_kv_heads_fall_back_to_head_dim_tp():
    r = shd.train_rules()
    wk = P((8192, 8, 128), ("d_model", "kv_heads", "head_dim"))
    # 8 kv heads % 16 != 0 → kv_heads replicate, head_dim picks up the TP axis
    assert spec(wk, r) == ("data", None, "model")


def test_conflict_one_axis_per_tensor():
    r = shd.serve_rules()
    # expert weights: expert_ff takes (model,data) combined; experts can't reuse
    w = P((8, 6144, 16384), ("experts", "d_model", "expert_ff"))
    assert spec(w, r) == (None, None, ("model", "data"))


def test_experts_divisible_takes_model_first():
    r = shd.serve_rules()
    w = P((64, 2048, 1024), ("experts", "d_model", "expert_ff"))
    s = spec(w, r)
    assert s[0] == "model"
    assert s[2] in ("data", None)  # model taken by experts


def test_batch_one_not_sharded():
    r = shd.serve_rules()
    cache = P((1, 4096, 8, 128), ("batch", "cache_seq", "kv_heads", "head_dim"))
    assert spec(cache, r) == (None, "model", None, None)


def test_multipod_batch_combined_axes():
    r = shd.train_rules(multi_pod=True)
    tok = P((256, 4096), ("batch", "seq"))
    assert spec(tok, r, MESHES["multi"]) == (("pod", "data"), "model")


def test_decode_cache_seq_sharded_heads_replicated():
    r = shd.serve_rules()
    cfg = get_config("deepseek-67b")
    cache = P((128, 32768, cfg.n_kv_heads, cfg.hd),
              ("batch", "cache_seq", "kv_heads", "head_dim"))
    assert spec(cache, r) == ("data", "model", None, None)


@pytest.mark.parametrize("arch", ["deepseek-67b", "olmoe-1b-7b", "mixtral-8x22b",
                                  "mamba2-780m", "seamless-m4t-medium"])
def test_every_param_leaf_resolves(arch):
    cfg = get_config(arch)
    rules = shd.train_rules()
    sizes = MESHES["single"].sizes
    for _, _, leaf in _port_leaves(M.param_specs(cfg)):
        s = shd.spec_for(leaf, rules, MESHES["single"])
        for dim, ax in zip(leaf.shape, s):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            assert dim % math.prod(sizes[a] for a in axes) == 0, (leaf, s)


def test_constrain_identity_without_context():
    x = torch.ones((4, 4))
    assert shd.constrain(x, ("batch", "seq")) is x  # no mesh/rules active → passthrough


def test_constrain_is_the_identity_on_one_card_and_checks_the_axes():
    x = torch.ones((4, 4))
    with shd.use_rules(MESHES["one"], shd.serve_rules()):
        assert shd.active_rules()[0] is MESHES["one"]
        assert shd.constrain(x, ("batch", "seq")) is x
        with pytest.raises(ValueError, match="logical axes"):
            shd.constrain(x, ("batch",))
    assert shd.active_rules() == (None, None)


def test_vocab_padding_makes_embeddings_shardable():
    for arch in ("seamless-m4t-medium", "mamba2-780m"):
        cfg = get_config(arch)
        assert cfg.padded_vocab % 256 == 0
        assert cfg.padded_vocab >= cfg.vocab_size
        emb = P((cfg.padded_vocab, cfg.d_model), ("vocab", "d_model"))
        assert spec(emb, shd.serve_rules())[0] == "model"


def test_tree_shardings_maps_every_leaf():
    cfg = get_config("olmo-1b")
    specs = M.param_specs(cfg)
    out = shd.tree_shardings(specs, shd.train_rules(), MESHES["single"])
    assert out["embed"] == spec(specs["embed"], shd.train_rules())
    assert out["blocks"]["attn"]["wq"] == spec(specs["blocks"]["attn"]["wq"], shd.train_rules())
