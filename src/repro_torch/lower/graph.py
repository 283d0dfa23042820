"""The training-graph IR, its NTX command compiler and the training loop.

Counterpart of ``repro/lower/graph.py`` for the CNN rule set:
:class:`GraphNode`, :class:`NetworkGraph` (``chain``, ``param_shapes``,
``init_params``, ``logits_edge``), :func:`edge_consumers`,
:func:`lower_training_step` (one :class:`~repro_torch.lower.ir.NtxProgram`
per training step: per-layer programs relocated into liveness-allocated
TCDM regions, per-image passes with one outer driver level over the batch,
spill / fill blocks around what does not fit the budget),
:func:`paper_cnn_graph`, :func:`frequency_band_batches`,
:func:`softmax_xent_loss` and :func:`train_graph`, which runs each step on
the torch executor (region kernels and per-node steps, walking the graph)
or on the command interpreter (the compiled program, command by command).

``init_params`` draws from the same numpy RNG calls as the JAX package, so
both give bit-identical parameter arrays for the same seed.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

from repro_torch.core.ntx import Agu, NtxCommand
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import trace as obs_trace
from repro_torch.lower import rules
from repro_torch.lower.ir import (
    ELEM_BYTES,
    LIVE_END,
    CommandBlock,
    DesignPoint,
    LivenessAllocator,
    NTX_DESIGN,
    NtxProgram,
    TensorRegion,
)
from repro_torch.lower.rules import (
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    SgdUpdateSpec,
    SoftmaxXentSpec,
    lower,
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


# ---------------------------------------------------------------------------
# Relocation: per-layer programs rebased into graph regions (+ batch loop)
# ---------------------------------------------------------------------------


def _relocate_blocks(
    layer_prog: NtxProgram,
    rename: dict[str, str],
    regions: dict[str, TensorRegion],
    static_names: set[str],
    batch: int,
    tag_prefix: str,
    *,
    skip_staging_of: tuple[str, ...] = (),
) -> list[CommandBlock]:
    """Rebase every block of ``layer_prog`` into graph-allocated regions.

    ``rename`` maps the layer program's region names to graph region names;
    ``static_names`` are graph regions that do NOT step with the batch
    (parameters, staged constants). With ``batch > 1`` each block gains one
    outermost driver replication level whose per-AGU base step is the
    per-image footprint of the region that AGU streams.
    """
    old_regions = layer_prog.regions
    out: list[CommandBlock] = []
    for b in layer_prog.blocks:
        if b.is_staging and any(w in skip_staging_of for w in b.writes):
            continue

        def target(old_name: str | None):
            if old_name is None:
                return None, 0
            gname = rename[old_name]
            new_r = regions[gname]
            old_r = old_regions[old_name]
            step = 0 if gname in static_names else old_r.size
            return new_r.base - old_r.base, step

        rd0_name = b.reads[0] if b.reads else b.writes[0]
        # a single-region reads tuple with both read AGUs live means rd1
        # streams the same region as rd0 (x*x squares, q·k within one qkv)
        rd1_name = b.reads[1] if len(b.reads) > 1 else (
            rd0_name if b.template.agu_rd1 is not None else None
        )
        wr_name = b.writes[0] if b.writes else None
        d0, s0 = target(rd0_name)
        d1, s1 = target(rd1_name if b.template.agu_rd1 is not None else None)
        dw_, sw = target(wr_name if b.template.agu_wr is not None else None)

        def rebase(agu: Agu | None, delta: int) -> Agu | None:
            if agu is None:
                return None
            return Agu(agu.base + delta, agu.strides)

        t = b.template
        template = NtxCommand(
            loops=t.loops,
            opcode=t.opcode,
            agu_rd0=rebase(t.agu_rd0, d0),
            agu_rd1=rebase(t.agu_rd1, d1),
            agu_wr=rebase(t.agu_wr, dw_),
            init_level=t.init_level,
            store_level=t.store_level,
            init_value=t.init_value,
        )
        reps, r0, r1, rw = b.reps, b.rd0_step, b.rd1_step, b.wr_step
        if batch > 1:
            reps = reps + (batch,)
            r0 = r0 + (s0,)
            r1 = r1 + (s1,)
            rw = rw + (sw,)
        out.append(
            CommandBlock(
                template=template,
                reps=reps,
                rd0_step=r0,
                rd1_step=r1,
                wr_step=rw,
                tag=f"{tag_prefix}:{b.tag}",
                reads=tuple(rename[n] for n in b.reads),
                writes=tuple(rename[n] for n in b.writes),
                dma_bytes_in=b.dma_bytes_in,
                dma_bytes_out=b.dma_bytes_out,
                tile=b.tile,
            )
        )
    return out


def _batch_reduce_block(
    src: TensorRegion,
    one: TensorRegion,
    dst: TensorRegion,
    batch: int,
    design: DesignPoint,
    tag: str,
) -> CommandBlock:
    """dst[i] = sum_b src[b, i] — reduce per-image weight-grad replicas."""
    n = dst.size
    return rules._nest_block(
        (batch, n), 1,
        (src.base, (n, 1)),
        (one.base, (0, 0)),
        (dst.base, (0, 1)),
        design, opcode="mac", tag=tag,
        reads=(src, one), writes=(dst,),
    )


def _spill_block(r: TensorRegion, direction: str) -> CommandBlock:
    """Model one spill/fill DMA transfer as an in-band identity copy.

    Semantically a no-op (read AGU == write AGU), but it occupies the
    engine for one cycle per word and carries the region's bytes as DMA
    traffic — what spilling an over-budget region to DRAM costs.
    """
    agu = Agu(r.base, (1, 0, 0, 0, 0))
    return CommandBlock(
        template=NtxCommand(
            loops=(r.size, 1, 1, 1, 1),
            opcode="copy",
            agu_rd0=agu,
            agu_wr=agu,
            init_level=0,
            store_level=0,
        ),
        tag=f"{direction}:{r.name}",
        reads=(r.name,),
        writes=(r.name,),
        dma_bytes_in=float(r.bytes) if direction == "fill" else 0.0,
        dma_bytes_out=float(r.bytes) if direction == "spill" else 0.0,
    )


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------


@dataclass
class _Step:
    """One schedule position: its region touches + a block emitter."""

    key: str
    touched: dict[str, tuple[tuple[int, ...], str]] = field(default_factory=dict)
    aliases: list[tuple[str, str, tuple[int, ...], str]] = field(default_factory=list)
    emit: Callable[[dict[str, TensorRegion]], list[CommandBlock]] | None = None

    def touch(self, name: str, shape: tuple[int, ...] = (), kind: str = "scratch"):
        if name not in self.touched:
            self.touched[name] = (tuple(shape), kind)




def _plan_relocated(
    step: _Step,
    layer_prog: NtxProgram,
    rename: dict[str, str],
    kinds: dict[str, str],
    batched: bool,
    batch: int,
    static_names: set[str],
    tag_prefix: str,
    skip_staging_of: tuple[str, ...] = (),
) -> None:
    """Register a relocation emission on ``step``.

    ``rename`` maps layer-program region names to graph names; ``kinds``
    overrides the graph-level kind per graph name (default "scratch").
    """
    for old_name, old_r in layer_prog.regions.items():
        gname = rename[old_name]
        rep = batched and gname not in static_names
        shape = ((batch,) + old_r.shape) if (rep and batch > 1) else old_r.shape
        step.touch(gname, shape, kinds.get(gname, "scratch"))

    def emit(regions: dict[str, TensorRegion]) -> list[CommandBlock]:
        return _relocate_blocks(
            layer_prog, rename, regions,
            static_names if batched else set(rename.values()),
            batch if batched else 1,
            tag_prefix, skip_staging_of=skip_staging_of,
        )

    step.emit = emit


def _grad(edge: str) -> str:
    return f"d_{edge}"


def lower_training_step(
    graph: NetworkGraph,
    *,
    design: DesignPoint = NTX_DESIGN,
    n_clusters: int = 16,
    keep_grads: bool = True,
) -> NtxProgram:
    """Compile ``graph`` into one whole-train-step :class:`NtxProgram`
    (``repro/lower/graph.py::lower_training_step``, the CNN rule set).

    Block order: forward node by node, the loss gradient, then per node in
    reverse — dW, the parameter's SGD update (freeing the gradient early),
    dX — the fwd -> loss grad -> interleaved dX/dW -> update schedule of the
    training loop. TCDM comes from the liveness allocator with the design
    point's ``64 KiB x n_clusters`` budget; ``meta["peak_tcdm_bytes"]``
    reports the high-water mark (at most the budget: what does not fit is
    spilled, with in-band spill / fill blocks, and listed in
    ``meta["spilled"]``).

    Per-layer programs are relocated into the graph's regions; per-image
    passes (conv, pool) gain one outer driver level over the batch. The LM
    nodes and the DAG fan-out accumulate steps are not ported yet (ROADMAP
    A5) and raise ``NotImplementedError``.
    """
    B = graph.batch
    mom = graph.momentum
    steps: list[_Step] = []
    param_edges = set(graph.param_shapes())
    static: set[str] = set(param_edges)
    for node in graph.nodes:
        if type(node.spec).__name__ in rules.LM_SPECS:
            raise NotImplementedError(
                f"node {node.name!r}: the {type(node.spec).__name__} lowering is not "
                f"ported yet (ROADMAP A5)")
    for edge, cs in edge_consumers(graph).items():
        if len(cs) > 1:
            raise NotImplementedError(
                f"edge {edge!r} feeds {len(cs)} nodes: the fan-out gradient "
                f"accumulate is not ported yet (ROADMAP A5)")

    kinds_base: dict[str, str] = {
        graph.input_edge: "input",
        graph.label_edge: "input",
        graph.logits_edge: "output",
    }
    for p in param_edges:
        kinds_base[p] = "param"
        kinds_base[f"{p}_new"] = "output"
        kinds_base[_grad(p)] = "output" if keep_grads else "scratch"
        if mom:
            kinds_base[f"v_{p}"] = "param"
            kinds_base[f"v_{p}_new"] = "output"

    def kinds_for(names: Iterable[str]) -> dict[str, str]:
        return {n: kinds_base.get(n, "scratch") for n in names}

    def relocated_step(key, spec, pass_, rename, *, batched, skip=(), prog=None):
        if prog is None:
            prog = lower(spec, pass_, design=design)
        step = _Step(key=key)
        _plan_relocated(
            step, prog, rename, kinds_for(rename.values()), batched, B,
            static, key, skip_staging_of=skip,
        )
        steps.append(step)
        return step

    # -- forward ------------------------------------------------------------
    for node in graph.nodes:
        s = node.spec
        if isinstance(s, Conv2dSpec):
            relocated_step(
                f"{node.name}:fwd", s, "fwd",
                {"x": node.in_edge, "w": node.param, "y": node.out_edge,
                 "x_pad": f"{node.name}.x_pad"},
                batched=True,
            )
        elif isinstance(s, MatmulSpec):
            relocated_step(
                f"{node.name}:fwd", s, "fwd",
                {"a": node.in_edge, "b": node.param, "c": node.out_edge},
                batched=False,
            )
        elif isinstance(s, BiasSpec):
            relocated_step(
                f"{node.name}:fwd", s, "fwd",
                {"x": node.in_edge, "b": node.param, "y": node.out_edge},
                batched=False,
            )
        elif isinstance(s, ReluSpec):
            whole = ReluSpec((B,) + tuple(s.shape)) if B > 1 else s
            relocated_step(
                f"{node.name}:fwd", whole, "fwd",
                {"x": node.in_edge, "y": node.out_edge},
                batched=False,
            )
        elif isinstance(s, MaxPool2dSpec):
            relocated_step(
                f"{node.name}:fwd", s, "fwd",
                {"x": node.in_edge, "y": node.out_edge},
                batched=True,
            )
        elif isinstance(s, FlattenSpec):
            step = _Step(key=f"{node.name}:fwd")
            step.touch(node.in_edge)  # keeps the storage alive through here
            step.aliases.append(
                (node.out_edge, node.in_edge,
                 (B, s.size) if B > 1 else (s.size,),
                 kinds_base.get(node.out_edge, "scratch"))
            )
            steps.append(step)
        else:
            raise TypeError(f"no graph lowering for {type(s).__name__}")

    # -- loss gradient ------------------------------------------------------
    loss_rename = {"z": graph.logits_edge, "onehot": graph.label_edge,
                   "dz": _grad(graph.logits_edge)}
    for sname in rules.softmax_xent_scratch_shapes(graph.loss):
        loss_rename[sname] = f"loss.{sname}"
    static.add("loss.consts")
    relocated_step("loss:dx", graph.loss, "dx", loss_rename, batched=False)

    # -- backward: dW -> update -> dX, node by node in reverse ---------------
    for node in reversed(graph.nodes):
        s = node.spec
        g_out = _grad(node.out_edge)
        g_in = _grad(node.in_edge)

        # dW + the update
        if node.param is not None:
            p = node.param
            dwb = f"{node.name}.dwb"  # per-image replicas (conv only, B > 1)
            if isinstance(s, Conv2dSpec):
                dw_target = dwb if B > 1 else _grad(p)
                step = relocated_step(
                    f"{node.name}:dw", s, "dw",
                    {"x": node.in_edge, "dy": g_out, "dw": dw_target,
                     "x_pad": f"{node.name}.x_pad"},
                    batched=True,
                    skip=("x_pad",) if s.padding else (),
                )
                if B > 1:
                    pshape = _param_shape(s)
                    one = f"{node.name}.one"
                    step.touch(one, (1,), "scratch")
                    step.touch(_grad(p), pshape, kinds_base[_grad(p)])
                    inner_emit = step.emit

                    def emit_dw(regions, _inner=inner_emit, _one=one,
                                _dwb=dwb, _dp=_grad(p), _node=node):
                        blocks = _inner(regions)
                        blocks.append(rules._memset_at(regions[_one], 0, 1.0))
                        blocks.append(
                            _batch_reduce_block(
                                regions[_dwb], regions[_one], regions[_dp],
                                B, design, tag=f"{_node.name}:dw:batch_reduce",
                            )
                        )
                        return blocks

                    step.emit = emit_dw
            elif isinstance(s, MatmulSpec):
                relocated_step(
                    f"{node.name}:dw", s, "dw",
                    {"a": node.in_edge, "dy": g_out, "dw": _grad(p)},
                    batched=False,
                )
            elif isinstance(s, BiasSpec):
                relocated_step(
                    f"{node.name}:dw", s, "dw",
                    {"dy": g_out, "one": f"{node.name}.one", "db": _grad(p)},
                    batched=False,
                )

            # the SGD(+momentum) update, right after dW so the gradient's
            # liveness ends here unless the caller keeps it as an output
            pshape = _param_shape(s)
            upd = _Step(key=f"{node.name}:upd")
            upd.touch(p, pshape, "param")
            upd.touch(_grad(p), pshape, kinds_base[_grad(p)])
            upd.touch(f"{p}_new", pshape, "output")
            nconst = 4 if mom else 2
            upd.touch(f"{node.name}.upd.consts", (nconst,), "scratch")
            if mom:
                upd.touch(f"v_{p}", pshape, "param")
                upd.touch(f"v_{p}_new", pshape, "output")

            def emit_upd(regions, _node=node, _p=p, _pshape=pshape):
                spec_u = SgdUpdateSpec(
                    n=math.prod(_pshape), lr=graph.lr, momentum=mom
                )
                return rules.sgd_update_blocks(
                    spec_u,
                    regions[_p], regions[_grad(_p)], regions[f"{_p}_new"],
                    regions[f"{_node.name}.upd.consts"], design,
                    v=regions.get(f"v_{_p}"),
                    v_new=regions.get(f"v_{_p}_new"),
                    tag=f"{_node.name}:upd",
                )

            upd.emit = emit_upd
            steps.append(upd)

        # dX (skipped for the input-most node: nothing consumes it)
        if node.in_edge == graph.input_edge:
            continue
        if isinstance(s, Conv2dSpec):
            rename = {"dy": g_out, "w": node.param, "dx": g_in}
            dx_prog = lower(s, "dx", design=design)
            for rn in dx_prog.regions:
                rename.setdefault(rn, f"{node.name}.dx.{rn}")
            relocated_step(f"{node.name}:dx", s, "dx", rename, batched=True,
                           prog=dx_prog)
        elif isinstance(s, MatmulSpec):
            relocated_step(
                f"{node.name}:dx", s, "dx",
                {"dy": g_out, "b": node.param, "dx": g_in},
                batched=False,
            )
        elif isinstance(s, ReluSpec):
            whole = ReluSpec((B,) + tuple(s.shape)) if B > 1 else s
            relocated_step(
                f"{node.name}:dx", whole, "dx",
                {"x": node.in_edge, "dy": g_out,
                 "mask": f"{node.name}.mask", "dx": g_in},
                batched=False,
            )
        elif isinstance(s, MaxPool2dSpec):
            relocated_step(
                f"{node.name}:dx", s, "dx",
                {"x": node.in_edge, "y": node.out_edge, "dy": g_out,
                 "mask": f"{node.name}.mask", "dx": g_in},
                batched=True,
            )
        elif isinstance(s, (FlattenSpec, BiasSpec)):
            # pure views backward: d_in aliases d_out, in the input's shape
            step = _Step(key=f"{node.name}:dx")
            step.touch(g_out)
            in_shape = ((B,) + node.in_shape) if B > 1 else node.in_shape
            if isinstance(s, BiasSpec):
                in_shape = (s.rows, s.c)
            step.aliases.append(
                (g_in, g_out, in_shape, kinds_base.get(g_in, "scratch"))
            )
            steps.append(step)
        else:
            raise TypeError(f"no dX graph lowering for {type(s).__name__}")

    return _assemble(graph, steps, design, n_clusters, keep_grads)


def _assemble(
    graph: NetworkGraph,
    steps: list[_Step],
    design: DesignPoint,
    n_clusters: int,
    keep_grads: bool,
) -> NtxProgram:
    """Liveness analysis -> interval allocation -> block emission."""
    # union storage groups through aliases (zero-copy views share addresses)
    parent: dict[str, str] = {}

    def find(n: str) -> str:
        while parent.get(n, n) != n:
            n = parent[n]
        return n

    first: dict[str, int] = {}
    last: dict[str, int] = {}
    shapes: dict[str, tuple[int, ...]] = {}
    kinds: dict[str, str] = {}
    alias_specs: dict[str, tuple[str, tuple[int, ...], str]] = {}
    order: list[str] = []
    for i, step in enumerate(steps):
        for name, (shape, kind) in step.touched.items():
            if name not in first:
                first[name] = i
                shapes[name] = shape
                kinds[name] = kind
                order.append(name)
            elif not shapes[name] and shape:
                shapes[name] = shape
                kinds[name] = kind
            last[name] = i
        for name, of, shape, kind in step.aliases:
            if name in first:
                raise ValueError(f"alias {name!r} already exists")
            first[name] = i
            last[name] = i
            shapes[name] = shape
            kinds[name] = kind
            alias_specs[name] = (of, shape, kind)
            parent[name] = of
            order.append(name)

    # graph inputs/params must be resident from program start (the executors
    # write them into memory before the first command)
    for name, kind in kinds.items():
        if kind in ("input", "param"):
            first[name] = -1

    # storage-group live interval = union over members
    group_first: dict[str, int] = {}
    group_last: dict[str, int] = {}
    for name in order:
        root = find(name)
        group_first[root] = min(group_first.get(root, first[name]), first[name])
        e = LIVE_END if kinds[name] == "output" else last[name]
        group_last[root] = max(group_last.get(root, e), e)

    budget_words = design.tcdm_budget_bytes(n_clusters) // ELEM_BYTES
    alloc = LivenessAllocator(budget_words=budget_words)
    # allocate primaries in birth order, then materialize aliases
    for name in sorted(order, key=lambda n: (group_first[find(n)], order.index(n))):
        root = find(name)
        if name == root:
            alloc.alloc(
                name, shapes[name] or (1,), kinds[name],
                start=group_first[root], end=group_last[root],
            )
    for name in order:
        if name in alias_specs:
            of, shape, kind = alias_specs[name]
            alloc.alias(name, of, shape, kind, end=group_last[find(name)])

    regions = alloc.regions
    spilled = set(alloc.spilled)

    # emit, inserting spill/fill DMA blocks around spilled regions' lives
    col = obs_trace.get_active_trace()
    blocks: list[CommandBlock] = []
    filled: set[str] = set()
    spilled_out: set[str] = set()
    for i, step in enumerate(steps):
        pre: list[CommandBlock] = []
        post: list[CommandBlock] = []
        for name in step.touched:
            root = find(name)
            if root not in spilled:
                continue
            if group_first[root] < i and root not in filled:
                pre.append(_spill_block(regions[root], "fill"))
                filled.add(root)
            if group_first[root] == i and root not in spilled_out:
                post.append(_spill_block(regions[root], "spill"))
                spilled_out.add(root)
        blocks.extend(pre)
        if step.emit is not None:
            if col is not None:
                with col.host_span(f"lower:{step.key}", tid="lowering",
                                   cat="lowering"):
                    blocks.extend(step.emit(regions))
            else:
                blocks.extend(step.emit(regions))
        blocks.extend(post)

    prog = NtxProgram(
        name=f"{graph.name}:train_step",
        blocks=blocks,
        regions=regions,
        design=design,
        meta={
            "graph": graph,
            "pass": "train_step",
            "batch": graph.batch,
            "n_clusters": n_clusters,
            "keep_grads": keep_grads,
            "peak_tcdm_bytes": alloc.peak_tcdm_bytes,
            "tcdm_budget_bytes": design.tcdm_budget_bytes(n_clusters),
            "spilled": sorted(spilled),
            "intervals": dict(alloc.intervals),
            "steps": [s.key for s in steps],
        },
    )
    assert prog.meta["peak_tcdm_bytes"] <= prog.meta["tcdm_budget_bytes"], (
        "liveness allocator exceeded the TCDM budget without spilling"
    )
    return prog


# ---------------------------------------------------------------------------
# The paper's CNN + a host-side training loop over the compiled step
# ---------------------------------------------------------------------------


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
    backend: str = "torch",
    program: NtxProgram | None = None,
    params: dict | None = None,
    fuse: bool = True,
    device=None,
    cache=None,
    registry=None,
    metrics_path=None,
) -> dict[str, Any]:
    """Train ``graph`` for ``steps`` steps.

    ``batch_fn(i)`` returns (images (B, H, W, C) float32, labels (B,) int).
    ``backend`` is ``"torch"`` (the torch executor: region kernels and
    per-node steps, fused unless ``fuse=False``) or ``"reference"`` (the
    compiled ``program``, lowered here when not given, command by command on
    the command interpreter). Parameters round-trip through the ``*_new``
    outputs and stay on the device between steps. The result carries the
    per-step losses, the per-step wall seconds (each ending in a device
    synchronise), the final parameters as numpy arrays, the step-0 outputs,
    the program, the fusion plan (from the program when there is one, so
    that it counts coverage; None for the reference backend and for
    ``fuse=False``) and the registry.

    ``registry`` (a :class:`repro_torch.obs.CounterRegistry`) is installed
    for the loop (else the active one, if any, is used); each step records
    under a ``step{i}`` scope, so per-step totals equal the program's
    closed-form counts. With a registry the torch backend runs the program
    (lowered here when not given), so that it books those counts.
    ``metrics_path`` streams one JSONL record per step (step, loss, wall
    seconds, the step's counter totals).
    """
    import torch

    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.lower import executors
    from repro_torch.obs import report as obs_report

    if backend not in ("torch", "reference"):
        raise ValueError(f"unknown backend {backend!r}; expected 'torch' or 'reference'")
    dev = resolve_device(device)
    reg = registry if registry is not None else obs_counters.get_active()
    if program is None and (backend == "reference" or reg is not None):
        program = lower_training_step(graph)
    if cache is None:
        cache = executors.PlanCache()
    if params is None:
        params = graph.init_params()
    params = params_from_jax(params, graph, dev)
    eye = np.eye(graph.loss.classes, dtype=np.float32)
    losses: list[float] = []
    walls: list[float] = []
    first = None
    writer = obs_report.MetricsWriter(metrics_path) if metrics_path else None
    install = (obs_counters.use_registry(registry) if registry is not None
               else contextlib.nullcontext())
    try:
        with install:
            for i in range(steps):
                t0 = time.perf_counter()
                x, labels = batch_fn(i)
                inputs = {
                    graph.input_edge: torch.as_tensor(np.asarray(x, np.float32), device=dev),
                    graph.label_edge: torch.as_tensor(eye[np.asarray(labels)], device=dev),
                    **params,
                }
                with reg.scope(f"step{i}") if reg is not None else contextlib.nullcontext():
                    if backend == "reference":
                        outs = executors.run_reference(program, inputs, device=dev)
                    else:
                        outs = executors.run_torch(
                            program if program is not None else graph, inputs,
                            fuse=fuse, device=dev, cache=cache)
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
                if writer is not None:
                    writer.write({
                        "step": i,
                        "loss": losses[-1],
                        "wall_s": walls[-1],
                        "counters": reg.totals(f"step{i}/") if reg is not None else {},
                    })
    finally:
        if writer is not None:
            writer.close()
    fusion = None
    if backend == "torch" and fuse:
        fusion = (executors._fusion_for(program) if program is not None
                  else cache.fusion_plan(graph))
    return {"params": params_to_numpy(params), "losses": losses, "walls": walls,
            "first_outputs": first, "program": program, "fusion": fusion,
            "registry": reg}
