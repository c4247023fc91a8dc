"""Helpers of the encoder-decoder and VLM parity tests (no tests here):
seeded draws, the port's per-layer trees restacked into the reference's
layout, and the comparison at a tensor's scale."""
import zlib

import jax
import numpy as np
import torch

TOL = dict(rtol=1e-4, atol=1e-4)
WEIGHT_SCALE = 0.3


def rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def perturbed(tree, tag):
    """A reference param tree, as numpy, made to act everywhere and kept out
    of the chaotic regime: every constant leaf (zero biases, unit scales)
    plus seeded noise, and every weight matrix but the embedding times
    ``WEIGHT_SCALE``.  At the reduced configs' own init the hidden states
    and caches reach O(20) and each package's float32 rounding is amplified
    to ~1e-3 by the second cross-attending layer (both packages alike: at
    ``WEIGHT_SCALE`` they agree to ~1e-6 on logits and gradients)."""
    r = rng("perturb", tag)

    def draw(path, x):
        x = np.asarray(x)
        if np.ptp(x) == 0:
            return x + r.normal(0.0, 0.1, x.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return x * np.float32(WEIGHT_SCALE) if x.ndim >= 2 and "embed" not in name else x

    return jax.tree_util.tree_map_with_path(draw, tree)


def tokens(tag, b, s, vocab=250):
    return rng(tag).integers(0, vocab, size=(b, s)).astype(np.int32)


def frames(tag, b, n, d=64):
    return rng("frames", tag).standard_normal((b, n, d)).astype(np.float32)


def to_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def to_t(x, dtype=torch.long):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _stack(items):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def restack(tree):
    """The port's per-layer lists → the reference's stacked layout."""
    if isinstance(tree, list):
        return _stack([restack(v) for v in tree])
    if isinstance(tree, dict):
        return {k: restack(v) for k, v in tree.items()}
    return to_np(tree)


def close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), err_msg=err_msg, **(tol or TOL))


def trees_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            trees_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    close(got, want, err_msg=path, **tol)


def grads_close(got, want, norm_rel):
    """Gradient leaves by path within 1e-4 relative and 1e-4 of the largest
    leaf's magnitude absolute (a leaf whose exact gradient is 0, as the
    cross keys' bias, holds rounding noise); the norm within ``norm_rel``."""
    assert set(got) == set(want)
    top = max(float(np.abs(to_np(w)).max()) for w in want.values())
    for path in want:
        close(got[path], want[path], err_msg=path, rtol=1e-4, atol=1e-4 * top)
    norm = lambda gs: float(np.sqrt(sum(float((to_np(g) ** 2).sum()) for g in gs)))
    assert abs(norm(got.values()) - norm(want.values())) <= norm_rel * norm(want.values())


def specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), tuple(tree.logical), tree.init, tree.scale)}


def streams(server):
    return {r.rid: list(r.tokens) for r in server.results.values()}


def prompts(tag, n, lo=1, hi=30):
    r = rng(tag)
    return [r.integers(2, 250, size=int(k)).astype(np.int32) for k in r.integers(lo, hi, n)]
