"""The training-graph IR, its NTX command compiler and the training loop.

Counterpart of ``repro/lower/graph.py``: :class:`GraphNode`,
:class:`NetworkGraph` (``chain``, ``from_model_config`` — the decoder-only
LM as a DAG with residual fan-out — ``param_shapes``, ``init_params``,
``logits_edge``), :func:`edge_consumers`, :func:`lower_training_step` (one
:class:`~repro_torch.lower.ir.NtxProgram` per training step: per-layer
programs relocated into liveness-allocated TCDM regions, per-image and
per-sequence passes with one outer driver level over the batch, one
accumulate step per fan-out edge, spill / fill blocks around what does not
fit the budget), :func:`paper_cnn_graph`, :func:`frequency_band_batches`,
:func:`lm_token_batches`, :func:`softmax_xent_loss` and
:func:`train_graph`, which runs each step on the torch executor (region
kernels and per-node steps, walking the graph) or on the command
interpreter (the compiled program, command by command).

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
    AttentionSpec,
    BiasSpec,
    Conv2dSpec,
    EmbeddingSpec,
    FlattenSpec,
    LayerNormSpec,
    MatmulSpec,
    MaxPool2dSpec,
    PosEmbedSpec,
    ReluSpec,
    ResidualAddSpec,
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
    if isinstance(spec, AttentionSpec):
        if cur != (spec.seq, 3 * spec.d):
            raise ValueError(
                f"attention expects {(spec.seq, 3 * spec.d)}, got {cur}"
            )
        return (spec.seq, spec.d)
    if isinstance(spec, LayerNormSpec):
        if not cur or cur[-1] != spec.d:
            raise ValueError(f"layernorm expects last dim {spec.d}, got {cur}")
        return cur
    if isinstance(spec, ResidualAddSpec):
        if math.prod(spec.shape) % math.prod(cur) != 0:
            raise ValueError(f"residual shape {spec.shape} mismatches {cur}")
        return cur
    if isinstance(spec, EmbeddingSpec):
        if not cur or cur[-1] != spec.vocab:
            raise ValueError(
                f"embedding expects one-hot last dim {spec.vocab}, got {cur}"
            )
        return cur[:-1] + (spec.d,)
    if isinstance(spec, PosEmbedSpec):
        if cur != (spec.seq, spec.d):
            raise ValueError(f"posembed expects {(spec.seq, spec.d)}, got {cur}")
        return cur
    raise TypeError(f"no graph rule for {type(spec).__name__}")


def _param_shape(spec) -> tuple[int, ...] | None:
    if isinstance(spec, Conv2dSpec):
        return (spec.kh, spec.kw, spec.cin, spec.cout)
    if isinstance(spec, MatmulSpec):
        return (spec.k, spec.n)
    if isinstance(spec, BiasSpec):
        return (spec.c,)
    if isinstance(spec, LayerNormSpec):
        return (2, spec.d)  # row 0 = gamma, row 1 = beta
    if isinstance(spec, EmbeddingSpec):
        return (spec.vocab, spec.d)
    if isinstance(spec, PosEmbedSpec):
        return (spec.seq, spec.d)
    return None


@dataclass
class NetworkGraph:
    """A training graph (a chain, or the DAG of a decoder-only LM): layer
    nodes + loss + update policy."""

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

    @classmethod
    def from_model_config(
        cls,
        cfg,
        *,
        batch: int = 2,
        seq: int = 8,
        lr: float = 0.05,
        momentum: float = 0.0,
    ) -> "NetworkGraph":
        """Build a decoder-only transformer training DAG from a
        :class:`repro_torch.models.config.ModelConfig`.

        Per token position the input is a one-hot row over the vocabulary
        (the near-memory controller streams token indices as one-hot MAC
        operands), so the input edge is ``(seq, vocab)`` per sequence and
        the label edge is the next-token one-hot at ``(batch*seq, vocab)``.

        The lowered family is the dense pre-LN block NTX speaks: embedding
        + learned positions, then per layer LN → qkv matmul → causal MHA →
        out-proj → residual, LN → FFN (relu) → residual, with a final LN
        and vocab head. Config fields outside that family (RMS-vs-layer
        norm, swiglu, GQA ``n_kv_heads``, MoE/SSM mixers) map onto it —
        use :func:`repro_torch.configs.reduce_config` plus ``cfg.with_(...)``
        overrides for test-sized graphs.
        """
        V, d, F = cfg.vocab_size, cfg.d_model, cfg.d_ff
        H = cfg.n_heads
        Dh = cfg.head_dim or d // H
        B, S = batch, seq
        rows = B * S
        eps = cfg.norm_eps
        nodes: list[GraphNode] = []
        edge, cur = cls.input_edge, (S, V)

        def add(name, spec, *, aux: tuple[str, ...] = ()):
            nonlocal edge, cur
            nxt = _shape_after(spec, cur)
            param = None
            if _param_shape(spec) is not None:
                param = f"w_{name}"
            nodes.append(
                GraphNode(
                    name=name, spec=spec, in_edge=edge, out_edge=f"a_{name}",
                    param=param, in_shape=cur, out_shape=nxt, aux_edges=aux,
                )
            )
            edge, cur = f"a_{name}", nxt

        add("emb", EmbeddingSpec(rows=rows, vocab=V, d=d))
        add("pos", PosEmbedSpec(batch=B, seq=S, d=d))
        for i in range(cfg.n_layers):
            skip = edge
            add(f"ln1_{i}", LayerNormSpec(rows, d, eps))
            add(f"qkv_{i}", MatmulSpec(rows, 3 * H * Dh, d))
            add(f"attn_{i}", AttentionSpec(S, H, Dh))
            add(f"proj_{i}", MatmulSpec(rows, d, H * Dh))
            add(f"res1_{i}", ResidualAddSpec((rows, d)), aux=(skip,))
            skip = edge
            add(f"ln2_{i}", LayerNormSpec(rows, d, eps))
            add(f"fc1_{i}", MatmulSpec(rows, F, d))
            add(f"relu_{i}", ReluSpec((S, F)))
            add(f"fc2_{i}", MatmulSpec(rows, d, F))
            add(f"res2_{i}", ResidualAddSpec((rows, d)), aux=(skip,))
        add("lnf", LayerNormSpec(rows, d, eps))
        add("head", MatmulSpec(rows, V, d))
        return cls(
            name=f"lm_{cfg.name}", batch=B, input_shape=(S, V), nodes=nodes,
            loss=SoftmaxXentSpec(batch=rows, classes=V),
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
            if isinstance(node.spec, LayerNormSpec):
                w = np.zeros(shape, np.float32)
                w[0] = 1.0  # gamma row; beta row stays zero
                out[pname] = w
            elif pname.startswith("b_"):
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
    (``repro/lower/graph.py::lower_training_step``).

    Block order: forward node by node, the loss gradient, then per node in
    reverse — dW, the parameter's SGD update (freeing the gradient early),
    dX — the fwd -> loss grad -> interleaved dX/dW -> update schedule of the
    training loop. TCDM comes from the liveness allocator with the design
    point's ``64 KiB x n_clusters`` budget; ``meta["peak_tcdm_bytes"]``
    reports the high-water mark (at most the budget: what does not fit is
    spilled, with in-band spill / fill blocks, and listed in
    ``meta["spilled"]``).

    Per-layer programs are relocated into the graph's regions; per-image
    passes (conv, pool) and per-sequence ones (attention) gain one outer
    driver level over the batch. An edge with several consumers (the LM's
    residual fan-out) gets each consumer's dX as a private partial
    ``d_<edge>@<consumer>`` and one ``<edge>:acc`` step that sums them
    after the last contribution.
    """
    B = graph.batch
    mom = graph.momentum
    steps: list[_Step] = []
    param_edges = set(graph.param_shapes())
    static: set[str] = set(param_edges)
    consumers = edge_consumers(graph)
    producers = {n.out_edge: n for n in graph.nodes}

    def grad_target(node: GraphNode, edge: str) -> str:
        """Where this node's dX contribution to ``edge`` lands."""
        if len(consumers.get(edge, ())) <= 1:
            return _grad(edge)
        return f"{_grad(edge)}@{node.name}"

    def edge_size(edge: str) -> int:
        if edge == graph.input_edge:
            return B * math.prod(graph.input_shape)
        return B * math.prod(producers[edge].out_shape)

    def scratch_rename(prog, rename: dict[str, str], prefix: str):
        for rn in prog.regions:
            if rn not in rename:
                rename[rn] = f"{prefix}.{rn}"
        return rename

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
        elif isinstance(s, AttentionSpec):
            prog = lower(s, "fwd", design=design)
            rename = scratch_rename(
                prog, {"x": node.in_edge, "y": node.out_edge},
                f"{node.name}.fwd",
            )
            static.add(f"{node.name}.fwd.mask")
            static.add(f"{node.name}.fwd.consts")
            relocated_step(f"{node.name}:fwd", s, "fwd", rename,
                           batched=True, prog=prog)
        elif isinstance(s, LayerNormSpec):
            prog = lower(s, "fwd", design=design)
            rename = scratch_rename(
                prog,
                {"x": node.in_edge, "w": node.param, "y": node.out_edge},
                f"{node.name}.fwd",
            )
            relocated_step(f"{node.name}:fwd", s, "fwd", rename,
                           batched=False, prog=prog)
        elif isinstance(s, ResidualAddSpec):
            relocated_step(
                f"{node.name}:fwd", s, "fwd",
                {"x": node.in_edge, "x2": node.aux_edges[0],
                 "y": node.out_edge},
                batched=False,
            )
        elif isinstance(s, (EmbeddingSpec, PosEmbedSpec)):
            relocated_step(
                f"{node.name}:fwd", s, "fwd",
                {"x": node.in_edge, "w": node.param, "y": node.out_edge},
                batched=False,
            )
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
        g_in = grad_target(node, node.in_edge)
        is_first = node.in_edge == graph.input_edge

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
            elif isinstance(s, LayerNormSpec):
                prog = lower(s, "dw", design=design)
                rename = scratch_rename(
                    prog,
                    {"x": node.in_edge, "dy": g_out, "dw": _grad(p)},
                    f"{node.name}.dw",
                )
                relocated_step(f"{node.name}:dw", s, "dw", rename,
                               batched=False, prog=prog)
            elif isinstance(s, EmbeddingSpec):
                relocated_step(
                    f"{node.name}:dw", s, "dw",
                    {"x": node.in_edge, "dy": g_out, "dw": _grad(p)},
                    batched=False,
                )
            elif isinstance(s, PosEmbedSpec):
                relocated_step(
                    f"{node.name}:dw", s, "dw",
                    {"dy": g_out, "one": f"{node.name}.dw.one",
                     "dw": _grad(p)},
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
        if is_first:
            continue
        if isinstance(s, Conv2dSpec):
            rename = {"dy": g_out, "w": node.param, "dx": g_in}
            dx_prog = lower(s, "dx", design=design)
            scratch_rename(dx_prog, rename, f"{node.name}.dx")
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
        elif isinstance(s, AttentionSpec):
            dx_prog = lower(s, "dx", design=design)
            rename = {"x": node.in_edge, "dy": g_out, "dx": g_in}
            scratch_rename(dx_prog, rename, f"{node.name}.dx")
            static.add(f"{node.name}.dx.mask")
            static.add(f"{node.name}.dx.consts")
            relocated_step(f"{node.name}:dx", s, "dx", rename, batched=True,
                           prog=dx_prog)
        elif isinstance(s, LayerNormSpec):
            dx_prog = lower(s, "dx", design=design)
            rename = {"x": node.in_edge, "w": node.param, "dy": g_out,
                      "dx": g_in}
            scratch_rename(dx_prog, rename, f"{node.name}.dx")
            relocated_step(f"{node.name}:dx", s, "dx", rename, batched=False,
                           prog=dx_prog)
        elif isinstance(s, ResidualAddSpec):
            # one step, two identity-copy relocations: the upstream grad
            # flows unchanged into BOTH the main and the skip branch
            t_main = g_in
            t_aux = grad_target(node, node.aux_edges[0])
            dx_prog = lower(s, "dx", design=design)
            step = _Step(key=f"{node.name}:dx")
            step.touch(g_out, dx_prog.regions["dy"].shape,
                       kinds_base.get(g_out, "scratch"))
            for t in (t_main, t_aux):
                step.touch(t, dx_prog.regions["dx"].shape,
                           kinds_base.get(t, "scratch"))

            def emit_res_dx(regions, _prog=dx_prog, _g=g_out,
                            _targets=(t_main, t_aux),
                            _key=f"{node.name}:dx"):
                blocks: list[CommandBlock] = []
                for dst in _targets:
                    rename = {"dy": _g, "dx": dst}
                    blocks.extend(_relocate_blocks(
                        _prog, rename, regions, set(rename.values()), 1,
                        _key,
                    ))
                return blocks

            step.emit = emit_res_dx
            steps.append(step)
        elif isinstance(s, PosEmbedSpec):
            relocated_step(
                f"{node.name}:dx", s, "dx",
                {"dy": g_out, "dx": g_in},
                batched=False,
            )
        elif isinstance(s, (FlattenSpec, BiasSpec)):
            if len(consumers[node.in_edge]) > 1:
                # the alias trick can't feed a partial sum — identity-copy
                # the grad into this consumer's private partial instead
                relocated_step(
                    f"{node.name}:dx",
                    ResidualAddSpec((edge_size(node.in_edge),)), "dx",
                    {"dy": g_out, "dx": g_in},
                    batched=False,
                )
            else:
                # pure views backward: d_in aliases d_out, input's shape
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

        # fan-out edges: once the forward-FIRST consumer (processed last
        # here) has contributed, sum the per-consumer partials into d_<e>
        for e in (node.in_edge, *node.aux_edges):
            cs = consumers[e]
            if len(cs) <= 1 or cs[0] is not node:
                continue
            size = edge_size(e)
            parts = [f"{_grad(e)}@{c.name}" for c in cs]
            acc = _Step(key=f"{e}:acc")
            for pn in parts:
                acc.touch(pn)
            chain: list[tuple[str, str, str]] = []
            cur = parts[0]
            for i, nxt in enumerate(parts[1:]):
                dst = (_grad(e) if i == len(parts) - 2
                       else f"{_grad(e)}.acc{i}")
                acc.touch(dst, (size,), kinds_base.get(dst, "scratch"))
                chain.append((cur, nxt, dst))
                cur = dst
            add_prog = lower(ResidualAddSpec((size,)), "fwd", design=design)

            def emit_acc(regions, _chain=tuple(chain), _prog=add_prog,
                         _key=f"{e}:acc"):
                blocks: list[CommandBlock] = []
                for a, b2, dst in _chain:
                    rename = {"x": a, "x2": b2, "y": dst}
                    blocks.extend(_relocate_blocks(
                        _prog, rename, regions, set(rename.values()), 1,
                        _key,
                    ))
                return blocks

            acc.emit = emit_acc
            steps.append(acc)

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


def one_hot_rows(ids, n_classes: int) -> np.ndarray:
    """float32 one-hot rows ``(len(ids), n_classes)``: the rows of
    ``np.eye(n_classes)[ids]`` without the ``n_classes``-square identity
    (at the Qwen vocabulary, 151,936, that identity is 92 GB)."""
    ids = np.asarray(ids).reshape(-1)
    out = np.zeros((ids.size, n_classes), np.float32)
    out[np.arange(ids.size), ids] = 1.0
    return out


def lm_token_batches(
    rng: np.random.RandomState, batch: int, seq: int, vocab: int
) -> Callable[[int], tuple[np.ndarray, np.ndarray]]:
    """Synthetic next-token task for the LM train-step drivers
    (``repro/lower/graph.py::lm_token_batches``, the same draws from
    ``rng``): every position's target is a fixed affine remap of its input
    token, so the mapping is learnable by embedding + head alone and a few
    SGD steps visibly reduce the CE loss. Returns ``batch_fn(step) ->
    (one-hot tokens (B*S, V) float32, target ids (B*S,) int)`` — the
    token-row layout :meth:`NetworkGraph.from_model_config` graphs consume."""

    def batch_fn(_step):
        tok = rng.randint(0, vocab, batch * seq)
        nxt = (tok * 3 + 1) % vocab
        return one_hot_rows(tok, vocab), nxt

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
    chaos=None,
) -> dict[str, Any]:
    """Train ``graph`` for ``steps`` steps.

    ``batch_fn(i)`` returns (inputs, labels): images (B, H, W, C) float32
    and labels (B,) int for a CNN, one-hot token rows (B*S, V) and target
    ids (B*S,) for an LM graph; the labels become one-hot rows.
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

    ``chaos`` (a :class:`repro_torch.runtime.faults.ChaosController`)
    injects faults: each executed step is intercepted BEFORE its outputs
    commit, so a cube kill discards the step, swaps in the re-sharded
    program and replays it, and a preemption rewinds to the latest
    checkpoint (its parameters put back on the run's device); ``losses``
    and ``walls`` are cut back to the step the run resumes at, and the
    replayed step re-enters ``batch_fn(i)`` at the same ``i`` (a batch keyed
    on the step alone makes the stream bit-identical). The result then also
    holds ``"discarded"``: per discarded step, its index, the wall of its
    run to a device synchronise (``wall_s``) and the controller's handling
    of the fault after it (``handling_s``).
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
    losses: list[float] = []
    walls: list[float] = []
    discarded: list[dict] = []
    first = None
    writer = obs_report.MetricsWriter(metrics_path) if metrics_path else None
    install = (obs_counters.use_registry(registry) if registry is not None
               else contextlib.nullcontext())
    try:
        with install:
            if chaos is not None:
                program = chaos.start(program, params)
            i = 0
            while i < steps:
                t0 = time.perf_counter()
                x, labels = batch_fn(i)
                inputs = {
                    graph.input_edge: torch.as_tensor(np.asarray(x, np.float32), device=dev),
                    graph.label_edge: torch.as_tensor(
                        one_hot_rows(labels, graph.loss.classes), device=dev),
                    **params,
                }
                action = None
                with reg.scope(f"step{i}") if reg is not None else contextlib.nullcontext():
                    if backend == "reference":
                        outs = executors.run_reference(program, inputs, device=dev)
                    else:
                        outs = executors.run_torch(
                            program if program is not None else graph, inputs,
                            fuse=fuse, device=dev, cache=cache)
                    if chaos is not None:
                        # the controller books the fault and its modeled
                        # recovery in the step's own scope
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
                        t1 = time.perf_counter()
                        action = chaos.intercept(i, outs, params)
                if action is not None:
                    # the step is discarded before it commits: swap in the
                    # re-sharded program / the restored params and replay
                    discarded.append({"step": i, "wall_s": t1 - t0,
                                      "handling_s": time.perf_counter() - t1})
                    if action.program is not None:
                        program = action.program
                    if action.params is not None:
                        params = params_from_jax(action.params, graph, dev)
                    del losses[action.resume_step:]
                    del walls[action.resume_step:]
                    i = action.resume_step
                    continue
                logits = outs[graph.logits_edge].cpu().numpy()  # synchronises
                losses.append(softmax_xent_loss(logits, labels))
                if i == 0:
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
                if chaos is not None:
                    chaos.committed(i, params)
                i += 1
    finally:
        if writer is not None:
            writer.close()
    fusion = None
    if backend == "torch" and fuse:
        fusion = (executors.step_fusion(program) if program is not None
                  else cache.fusion_plan(graph))
    res = {"params": params_to_numpy(params), "losses": losses, "walls": walls,
           "first_outputs": first, "program": program, "fusion": fusion,
           "registry": reg}
    if chaos is not None:
        res["discarded"] = discarded
    return res
