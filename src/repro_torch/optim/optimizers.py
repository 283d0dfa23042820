"""Optimizers: SGD(+momentum) — the paper's algorithm — and AdamW
(``repro/optim/optimizers.py``).

The same functional interface, on pytrees of tensors (nested dicts, lists
and tuples; dict leaves are visited in sorted-key order, as JAX flattens
them) — no ``torch.optim``::

    opt = sgd(lr=..., momentum=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Moments are fp32 whatever the parameter dtype; ``count`` is an int32
tensor; :func:`apply_updates` adds in fp32 and casts once to the parameter
dtype. Every function returns new tensors and leaves its inputs alone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def _items(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def tree_items(tree, prefix: str = ""):
    """``(dotted path, leaf)`` pairs of ``tree`` in JAX's flatten order
    (``None`` has none)."""
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for k, v in _items(tree):
            yield from tree_items(v, f"{prefix}.{k}" if prefix else str(k))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` and of the trees
    in ``rest``, which have ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def _f32(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def _count(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float = 1e-2, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _f32(params), "count": _count(params)}

    def update(grads, state, params=None):
        del params
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: momentum * m + g.float(), mu, grads)
        else:
            upd = mu
        updates = tree_map(lambda u: -lr * u, upd)
        return updates, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        return {"m": _f32(params), "v": _f32(params), "count": _count(params)}

    def update(grads, state, params):
        c = state["count"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state["v"], grads)
        bc1 = 1 - b1 ** c.float()
        bc2 = 1 - b2 ** c.float()

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return -lr * (step + weight_decay * p.float())

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "count": c}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def get_optimizer(name: str, lr: float) -> Optimizer:
    if name == "sgd":
        return sgd(lr=lr)
    if name == "adamw":
        return adamw(lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")
