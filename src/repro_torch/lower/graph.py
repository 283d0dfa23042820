"""The training-graph IR and the host-side training loop.

Counterpart of ``repro/lower/graph.py`` for the pieces the torch executor
needs: :class:`GraphNode`, :class:`NetworkGraph` (``chain``,
``param_shapes``, ``init_params``, ``logits_edge``), :func:`edge_consumers`,
:func:`paper_cnn_graph`, :func:`frequency_band_batches`,
:func:`softmax_xent_loss` and :func:`train_graph`. The NTX command compiler
(``lower_training_step``) is not ported yet: the torch executor walks the
graph itself, in the same fwd -> loss grad -> dW/update/dX schedule.

``init_params`` draws from the same numpy RNG calls as the JAX package, so
both give bit-identical parameter arrays for the same seed.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.lower.rules import (
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    SoftmaxXentSpec,
)


@dataclass(frozen=True)
class GraphNode:
    """One layer node: a spec plus its explicit tensor edges.

    ``aux_edges`` are extra input edges beyond ``in_edge``; an edge consumed
    by more than one node gets its gradient accumulated from each consumer.
    """

    name: str
    spec: Any
    in_edge: str
    out_edge: str
    param: str | None = None  # parameter edge name (conv/matmul: w, bias: b)
    in_shape: tuple[int, ...] = ()  # per-image
    out_shape: tuple[int, ...] = ()
    aux_edges: tuple[str, ...] = ()


def _shape_after(spec, cur: tuple[int, ...]) -> tuple[int, ...]:
    """Per-image output shape of ``spec`` applied to per-image ``cur``."""
    if isinstance(spec, Conv2dSpec):
        if cur != (spec.in_h, spec.in_w, spec.cin):
            raise ValueError(f"conv expects {(spec.in_h, spec.in_w, spec.cin)}, got {cur}")
        return (spec.out_h, spec.out_w, spec.cout)
    if isinstance(spec, MaxPool2dSpec):
        if cur != (spec.in_h, spec.in_w, spec.c):
            raise ValueError(f"maxpool expects {(spec.in_h, spec.in_w, spec.c)}, got {cur}")
        return (spec.out_h, spec.out_w, spec.c)
    if isinstance(spec, ReluSpec):
        if tuple(spec.shape) != cur:
            raise ValueError(f"relu expects {spec.shape}, got {cur}")
        return cur
    if isinstance(spec, FlattenSpec):
        if tuple(spec.in_shape) != cur:
            raise ValueError(f"flatten expects {spec.in_shape}, got {cur}")
        return (spec.size,)
    if isinstance(spec, MatmulSpec):
        if cur == (spec.k,):
            return (spec.n,)
        if len(cur) == 2 and cur[-1] == spec.k:
            return (cur[0], spec.n)
        raise ValueError(f"matmul expects (.., {spec.k}), got {cur}")
    if isinstance(spec, BiasSpec):
        if cur[-1] != spec.c:
            raise ValueError(f"bias expects {spec.c} channels, got {cur}")
        return cur
    raise TypeError(f"no graph rule for {type(spec).__name__}")


def _param_shape(spec) -> tuple[int, ...] | None:
    if isinstance(spec, Conv2dSpec):
        return (spec.kh, spec.kw, spec.cin, spec.cout)
    if isinstance(spec, MatmulSpec):
        return (spec.k, spec.n)
    if isinstance(spec, BiasSpec):
        return (spec.c,)
    return None


@dataclass
class NetworkGraph:
    """A sequential training graph: layer nodes + loss + update policy."""

    name: str
    batch: int
    input_shape: tuple[int, ...]  # per-image
    nodes: list[GraphNode]
    loss: SoftmaxXentSpec
    lr: float = 0.05
    momentum: float = 0.0

    input_edge: str = "x"
    label_edge: str = "onehot"

    @classmethod
    def chain(
        cls,
        name: str,
        batch: int,
        input_shape: tuple[int, ...],
        layers: Iterable[tuple[str, Any]],
        *,
        lr: float = 0.05,
        momentum: float = 0.0,
    ) -> "NetworkGraph":
        """Chain ``layers`` ([(node_name, spec)]) over per-image
        ``input_shape``. Spec sugar: the strings ``"relu"``, ``"flatten"``
        and ``"bias"`` expand to specs matching the current shape; matmul
        specs must use ``m == batch``.
        """
        cur = tuple(input_shape)
        nodes: list[GraphNode] = []
        edge = cls.input_edge
        for lname, spec in layers:
            if spec == "relu":
                spec = ReluSpec(cur)
            elif spec == "flatten":
                spec = FlattenSpec(cur)
            elif spec == "bias":
                spec = BiasSpec(rows=batch * math.prod(cur[:-1]), c=cur[-1])
            if isinstance(spec, MatmulSpec) and spec.m != batch:
                raise ValueError(f"matmul node {lname!r}: m={spec.m} != batch={batch}")
            if isinstance(spec, BiasSpec) and spec.rows != batch * math.prod(cur[:-1]):
                raise ValueError(
                    f"bias node {lname!r}: rows={spec.rows} != "
                    f"{batch * math.prod(cur[:-1])}"
                )
            nxt = _shape_after(spec, cur)
            param = None
            if _param_shape(spec) is not None:
                prefix = "b" if isinstance(spec, BiasSpec) else "w"
                param = f"{prefix}_{lname}"
            nodes.append(
                GraphNode(
                    name=lname, spec=spec, in_edge=edge, out_edge=f"a_{lname}",
                    param=param, in_shape=cur, out_shape=nxt,
                )
            )
            edge = f"a_{lname}"
            cur = nxt
        if len(cur) != 1:
            raise ValueError(f"loss expects 1-D logits per image, got {cur}")
        return cls(
            name=name, batch=batch, input_shape=tuple(input_shape),
            nodes=nodes, loss=SoftmaxXentSpec(batch=batch, classes=cur[0]),
            lr=lr, momentum=momentum,
        )

    @property
    def logits_edge(self) -> str:
        return self.nodes[-1].out_edge

    def param_nodes(self) -> list[GraphNode]:
        return [n for n in self.nodes if n.param is not None]

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return {n.param: _param_shape(n.spec) for n in self.param_nodes()}

    def init_params(self, seed: int = 0) -> dict[str, np.ndarray]:
        """Parameter (and momentum-state) arrays keyed by edge name."""
        rng = np.random.RandomState(seed)
        out: dict[str, np.ndarray] = {}
        for node in self.param_nodes():
            pname = node.param
            shape = _param_shape(node.spec)
            if pname.startswith("b_"):
                out[pname] = np.zeros(shape, np.float32)
            else:
                out[pname] = (rng.randn(*shape) * 0.1).astype(np.float32)
            if self.momentum:
                out[f"v_{pname}"] = np.zeros(shape, np.float32)
        return out


def edge_consumers(graph: NetworkGraph) -> dict[str, list[GraphNode]]:
    """Forward-order consumer nodes per edge (``in_edge`` + ``aux_edges``)."""
    out: dict[str, list[GraphNode]] = {}
    for n in graph.nodes:
        for e in (n.in_edge, *n.aux_edges):
            out.setdefault(e, []).append(n)
    return out


def paper_cnn_graph(
    batch: int = 8,
    img: int = 32,
    n_classes: int = 10,
    *,
    lr: float = 0.05,
    momentum: float = 0.9,
) -> NetworkGraph:
    """The small GoogLeNet-style CNN of the paper as a training graph
    (GAP swapped for maxpool+flatten)."""
    h1 = (img + 2 * 2 - 5) // 2 + 1  # conv1: 5x5 stride 2 pad 2
    h2 = (h1 + 2 * 1 - 3) // 2 + 1  # conv2: 3x3 stride 2 pad 1
    h3 = h2 // 2  # maxpool 2x2
    return NetworkGraph.chain(
        "paper_cnn", batch, (img, img, 3),
        [
            ("c1", Conv2dSpec(img, img, 3, 5, 5, 16, stride=2, padding=2)),
            ("r1", "relu"),
            ("c2", Conv2dSpec(h1, h1, 16, 3, 3, 32, stride=2, padding=1)),
            ("r2", "relu"),
            ("p1", MaxPool2dSpec(h2, h2, 32)),
            ("f1", "flatten"),
            ("fc", MatmulSpec(batch, n_classes, h3 * h3 * 32)),
            ("fcb", "bias"),
        ],
        lr=lr, momentum=momentum,
    )


def frequency_band_batches(
    rng: np.random.RandomState, batch: int, img: int, n_classes: int = 10
) -> Callable[[int], tuple[np.ndarray, np.ndarray]]:
    """The synthetic separable image task every CNN driver trains on:
    class = dominant frequency band, plus gaussian pixel noise. Returns a
    ``batch_fn(step) -> (images (B, img, img, 3), labels (B,))``."""

    def batch_fn(_step):
        y = rng.randint(0, n_classes, batch)
        base = np.linspace(0, 3.14 * 4, img)
        imgs = np.stack([
            np.sin(base[None, :] * (1 + c)) * np.cos(base[:, None] * (1 + c))
            for c in y
        ])[..., None].repeat(3, axis=-1)
        imgs += rng.randn(*imgs.shape) * 0.1
        return imgs.astype(np.float32), y

    return batch_fn


def softmax_xent_loss(logits: np.ndarray, labels: np.ndarray) -> float:
    """Host-side scalar loss over the step's logits output."""
    z = np.asarray(logits, np.float64)
    z = z - z.max(axis=1, keepdims=True)
    lse = np.log(np.exp(z).sum(axis=1))
    return float(np.mean(lse - z[np.arange(len(labels)), labels]))


def train_graph(
    graph: NetworkGraph,
    steps: int,
    batch_fn: Callable[[int], tuple[np.ndarray, np.ndarray]],
    *,
    params: dict | None = None,
    fuse: bool = True,
    device=None,
    cache=None,
) -> dict[str, Any]:
    """Train ``graph`` for ``steps`` through the torch executor.

    ``batch_fn(i)`` returns (images (B, H, W, C) float32, labels (B,) int).
    Parameters round-trip through the ``*_new`` outputs and stay on the
    device between steps. The result carries the per-step losses, the
    per-step wall seconds (each ending in a device synchronise), the final
    parameters as numpy arrays, the step-0 outputs and the fusion plan.
    """
    import torch

    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.lower import executors

    dev = resolve_device(device)
    if cache is None:
        cache = executors.PlanCache()
    if params is None:
        params = graph.init_params()
    params = params_from_jax(params, graph, dev)
    eye = np.eye(graph.loss.classes, dtype=np.float32)
    losses: list[float] = []
    walls: list[float] = []
    first = None
    for i in range(steps):
        t0 = time.perf_counter()
        x, labels = batch_fn(i)
        inputs = {
            graph.input_edge: torch.as_tensor(np.asarray(x, np.float32), device=dev),
            graph.label_edge: torch.as_tensor(eye[np.asarray(labels)], device=dev),
            **params,
        }
        outs = executors.run_torch(graph, inputs, fuse=fuse, device=dev, cache=cache)
        logits = outs[graph.logits_edge].cpu().numpy()  # synchronises
        losses.append(softmax_xent_loss(logits, labels))
        if first is None:
            first = outs
        for p in graph.param_shapes():
            params[p] = outs[f"{p}_new"]
            if graph.momentum:
                params[f"v_{p}"] = outs[f"v_{p}_new"]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    fusion = cache.fusion_plan(graph) if fuse else None
    return {"params": params_to_numpy(params), "losses": losses,
            "walls": walls, "first_outputs": first, "fusion": fusion}
