"""The port's optimizers against the JAX package's (``repro.optim``).

``sgd`` (plain, momentum, nesterov), ``adamw`` and ``clip_by_global_norm``
run five steps on the same fp32 and bf16 parameter trees (nested dicts and
a list, numpy from a seed) with the same gradients: fp32 leaves and moments
at rtol 1e-6 (atol 1e-6 of the leaf's max|want|), bf16 leaves equal after
the cast to bf16; moments fp32 and ``count`` int32 on both sides. The clip
is compared on its own each step, and then both updates take JAX's clipped
gradients: XLA and PyTorch sum the global norm in another order, and the
scale's last bit would reach the moments whose terms cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as opt

SHAPES = {"w": (8, 16), "blk": {"b": (16,), "layers": [(4, 4), (3,)]}, "scale": ()}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
RTOL = 1e-6


def _tree(rng, scale=1.0):
    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        if isinstance(s, list):
            return [draw(v) for v in s]
        return np.asarray(rng.randn(*s) * scale, np.float32)
    return draw(SHAPES)


def _to_jax(tree, dt):
    return jax.tree.map(lambda a: jnp.asarray(a, dt), tree)


def _to_torch(tree, dt):
    return opt.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dt), tree)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _same(got, want, exact: bool):
    gl, wl = opt.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        if exact:
            assert np.array_equal(_np(g), _np(w))
        else:
            scale = float(np.abs(_np(w)).max()) if w.size else 0.0
            np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=RTOL * scale)


CASES = {
    "sgd_plain": lambda m: m.sgd(lr=0.05, momentum=0.0),
    "sgd_momentum": lambda m: m.sgd(lr=0.05, momentum=0.9),
    "sgd_nesterov": lambda m: m.sgd(lr=0.05, momentum=0.9, nesterov=True),
    "adamw": lambda m: m.adamw(lr=3e-3),
    "adamw_cli": lambda m: m.get_optimizer("adamw", 3e-3),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_five_steps_match_jax(name, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    p0 = _tree(rng, 0.5)
    jo, to = CASES[name](jopt), CASES[name](opt)
    jp, tp = _to_jax(p0, jdt), _to_torch(p0, tdt)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["count"].dtype == torch.int32
    for leaf in opt.tree_leaves({k: v for k, v in ts.items() if k != "count"}):
        assert leaf.dtype == torch.float32
    for step in range(5):
        g = _tree(rng, 2.0)  # norms above 1: the clip scales
        jg, tg = _to_jax(g, jdt), _to_torch(g, tdt)
        jg, jn = jopt.clip_by_global_norm(jg, 1.0)
        tg, tn = opt.clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
        _same(tg, jg, exact=dtype == "bf16")
        # both updates take JAX's clipped gradients: the clip scale's last bit
        # (the norm's sum order) would otherwise reach moments whose terms cancel
        tg = _to_torch(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jg), tdt)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), opt.apply_updates(tp, tu)
        for leaf in opt.tree_leaves(tp):
            assert leaf.dtype == tdt
        _same(tp, jp, exact=dtype == "bf16")
        _same({k: v for k, v in ts.items() if k != "count"},
              {k: v for k, v in js.items() if k != "count"}, exact=False)
        assert int(ts["count"]) == int(js["count"]) == step + 1


def test_global_norm_and_clip_below_the_limit():
    rng = np.random.RandomState(1)
    g = _tree(rng, 0.01)
    tg = _to_torch(g, torch.float32)
    n = opt.global_norm(tg)
    np.testing.assert_allclose(float(n), float(jopt.global_norm(_to_jax(g, jnp.float32))),
                               rtol=RTOL)
    clipped, n2 = opt.clip_by_global_norm(tg, 1.0)
    assert float(n2) == float(n) < 1.0
    for a, b in zip(opt.tree_leaves(clipped), opt.tree_leaves(tg)):
        assert torch.equal(a, b)  # scale 1: unchanged
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.get_optimizer("lion", 1e-3)


def test_tree_helpers_follow_jax_flatten_order():
    tree = {"b": [1, {"z": 2, "a": 3}], "a": (4, None)}
    assert opt.tree_leaves(tree) == jax.tree.leaves(tree)
    assert opt.tree_map(lambda x, y: x + y, tree, tree) == jax.tree.map(lambda x, y: x + y,
                                                                         tree, tree)
