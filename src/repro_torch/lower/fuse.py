"""Region fuser: group contiguous train-step steps into fused kernels.

Counterpart of ``repro/lower/fuse.py``. :func:`plan_fusion` walks the
train-step schedule of a :class:`~repro_torch.lower.graph.NetworkGraph`, or
of the :class:`~repro_torch.lower.ir.NtxProgram` lowered from one, and
greedily groups contiguous *fusable* steps into :class:`RegionSpec`
regions — fwd chains, the softmax-CE gradient, bwd chains and the SGD /
momentum updates fused as the epilogue of the dW that feeds them. Steps
without a fusion rule become per-node fallback :class:`Segment`s. Given a
program, the plan also counts the program's commands that its regions
cover (:attr:`FusionPlan.coverage`).

The JAX fuser treats the regions that the NTX TCDM model spilled as
barriers. A GPU has no such budget, so the port plans with ``spilled=()``
by default; ``spilled=program.meta["spilled"]`` keeps the barrier, and so
reproduces the JAX plan and its coverage.

One numerical identity makes bwd chains closed: the relu backward mask can
be taken from the relu *output* (``y > 0`` iff ``x > 0`` for ``y = max(x,
0)``), so pre-activations never need to escape a forward region.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.lower.ir import NtxProgram
from repro_torch.lower.rules import (
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
)


@dataclass(frozen=True)
class Stage:
    """One node pass inside a fused region (a former per-node dispatch)."""

    node: str
    pass_: str  # "fwd" | "dw" | "upd" | "dx"
    spec: object  # the layer spec (frozen dataclass)
    in_edge: str
    out_edge: str
    param: str | None = None


@dataclass(frozen=True)
class RegionSpec:
    """Plan-cache key for one fused region kernel.

    ``inputs`` are ``(edge, batched)`` pairs — batched edges carry a leading
    batch axis, unbatched ones (params, momentum state) are resident.
    ``outputs`` are ``(edge, kind)`` with kind ``"batched"`` (written per
    image) or ``"reduced"`` (reduced over the batch: dW totals and updated
    params).
    """

    stages: tuple[Stage, ...]
    batch: int
    lr: float
    momentum: float
    inputs: tuple[tuple[str, bool], ...]
    outputs: tuple[tuple[str, str], ...]

    @property
    def label(self) -> str:
        first, last = self.stages[0], self.stages[-1]
        return (
            f"fused[{first.node}:{first.pass_}..{last.node}:{last.pass_}]"
            f"x{len(self.stages)}"
        )


@dataclass
class Segment:
    """One dispatch of the fused walk: a region or a per-node fallback."""

    region: RegionSpec | None = None
    step: str | None = None


@dataclass
class FusionPlan:
    """plan_fusion's output: the segment walk plus coverage accounting (the
    command counts stay 0 for a plan made from a graph alone)."""

    segments: list[Segment] = field(default_factory=list)
    fused_steps: set[str] = field(default_factory=set)
    fallback_steps: list[str] = field(default_factory=list)
    fused_commands: int = 0
    total_commands: int = 0

    @property
    def n_regions(self) -> int:
        return sum(1 for s in self.segments if s.region is not None)

    @property
    def coverage(self) -> float:
        """Fused commands / total program commands."""
        if not self.total_commands:
            return 0.0
        return self.fused_commands / self.total_commands

    def stats(self) -> dict:
        return {
            "regions": self.n_regions,
            "fallback_dispatches": len(self.fallback_steps),
            "fused_steps": len(self.fused_steps),
            "fused_commands": self.fused_commands,
            "total_commands": self.total_commands,
            "coverage": self.coverage,
        }


def step_schedule(graph, keep_grads: bool = True) -> list[str]:
    """The train-step step keys in schedule order."""
    from repro_torch.lower.graph import edge_consumers

    consumers = edge_consumers(graph)
    keys = [f"{n.name}:fwd" for n in graph.nodes]
    keys.append("loss:dx")
    for node in reversed(graph.nodes):
        if node.param is not None:
            keys.append(f"{node.name}:dw")
            keys.append(f"{node.name}:upd")
        if node.in_edge == graph.input_edge:
            continue
        keys.append(f"{node.name}:dx")
        # fan-out accumulate fires once the forward-FIRST consumer (the
        # last one visited in reverse) has produced its partial
        for e in (node.in_edge, *node.aux_edges):
            cs = consumers.get(e, ())
            if len(cs) > 1 and cs[0] is node:
                keys.append(f"{e}:acc")
    return keys


def pool_tiles(s: MaxPool2dSpec) -> bool:
    """The in-kernel pool needs window == stride and exact tiling."""
    return (
        s.window == s.stride
        and s.in_h % s.window == 0
        and s.in_w % s.window == 0
    )


def _fusable(node, pass_: str, *, fuse_updates: bool) -> bool:
    """Does this (node, pass) have an in-kernel fusion rule?"""
    s = node.spec
    if pass_ == "fwd":
        if isinstance(s, MaxPool2dSpec):
            return pool_tiles(s)
        return isinstance(
            s, (Conv2dSpec, MatmulSpec, BiasSpec, ReluSpec, FlattenSpec)
        )
    if pass_ == "dw":
        return isinstance(s, (Conv2dSpec, MatmulSpec, BiasSpec))
    if pass_ == "upd":
        return fuse_updates
    if pass_ == "dx":
        if isinstance(s, Conv2dSpec):
            # the transposed conv pads by k-1-p
            return s.padding <= s.kh - 1 and s.padding <= s.kw - 1
        if isinstance(s, MaxPool2dSpec):
            return pool_tiles(s)
        return isinstance(s, (MatmulSpec, ReluSpec, BiasSpec, FlattenSpec))
    return False


def _step_io(graph, node, pass_: str, *, fused: bool):
    """(reads, writes) edge names of one step, as the fused walk sees them.

    ``fused`` matters for relu-dX: inside a region the mask comes from the
    relu *output* (so pre-activations stay in scratch); the per-node
    fallback masks from the input, which must then escape.
    """
    if node is None:  # loss:dx
        return (
            [graph.logits_edge, graph.label_edge],
            [f"d_{graph.logits_edge}"],
        )
    s = node.spec
    if pass_ == "fwd":
        reads = [node.in_edge]
        if node.param is not None:
            reads.append(node.param)
        return reads, [node.out_edge]
    if pass_ == "dw":
        p = node.param
        if isinstance(s, BiasSpec):
            return [f"d_{node.out_edge}"], [f"d_{p}"]
        return [node.in_edge, f"d_{node.out_edge}"], [f"d_{p}"]
    if pass_ == "upd":
        p = node.param
        reads = [p, f"d_{p}"]
        writes = [f"{p}_new"]
        if graph.momentum:
            reads.append(f"v_{p}")
            writes.append(f"v_{p}_new")
        return reads, writes
    # dx
    g = f"d_{node.out_edge}"
    if isinstance(s, ReluSpec):
        mask_edge = node.out_edge if fused else node.in_edge
        return [mask_edge, g], [f"d_{node.in_edge}"]
    if isinstance(s, MaxPool2dSpec):
        return [node.in_edge, g], [f"d_{node.in_edge}"]
    if isinstance(s, (Conv2dSpec, MatmulSpec)):
        return [g, node.param], [f"d_{node.in_edge}"]
    return [g], [f"d_{node.in_edge}"]  # bias / flatten reshape


def _touches_spill(graph, node, pass_: str, spilled: set[str]) -> bool:
    """Conservative spill barrier: the step's edges or scratch are spilled."""
    if not spilled:
        return False
    reads, writes = _step_io(graph, node, pass_, fused=True)
    names = set(reads) | set(writes)
    if names & spilled:
        return True
    prefix = f"{node.name}." if node is not None else "loss."
    return any(name.startswith(prefix) for name in spilled)


def _heavy(stages: list[Stage]) -> bool:
    """Is this group worth a fused kernel (vs cheap per-node dispatches)?"""
    if len(stages) >= 2:
        return True
    return any(isinstance(st.spec, (Conv2dSpec, MatmulSpec)) for st in stages)


def _stage_of(graph, nodes, key: str) -> Stage:
    name, pass_ = key.split(":")
    if name == "loss":
        return Stage(
            node="loss", pass_="dx", spec=graph.loss,
            in_edge=graph.logits_edge, out_edge=graph.logits_edge,
            param=graph.label_edge,
        )
    node = nodes[name]
    return Stage(
        node=name, pass_=pass_, spec=node.spec, in_edge=node.in_edge,
        out_edge=node.out_edge, param=node.param,
    )


def plan_fusion(
    graph,
    *,
    keep_grads: bool = True,
    spilled=(),
    fuse_updates: bool = True,
) -> FusionPlan:
    """Plan the fused-region walk for one train step of ``graph``.

    ``graph`` is a :class:`~repro_torch.lower.graph.NetworkGraph` or an
    :class:`~repro_torch.lower.ir.NtxProgram` lowered from one; a program
    gives its graph, ``keep_grads`` and step order, and the plan counts its
    commands. ``spilled`` names edges / node scratch that a memory model
    spilled; steps touching them become fallbacks. ``fuse_updates=False``
    keeps every SGD update a per-node step.
    """
    program = graph if isinstance(graph, NtxProgram) else None
    if program is not None:
        graph = program.meta["graph"]
        keep_grads = program.meta["keep_grads"]
    spilled = set(spilled)
    keys = (program.meta["steps"] if program is not None
            else step_schedule(graph, keep_grads))
    nodes = {n.name: n for n in graph.nodes}
    unbatched = set()
    for p in graph.param_shapes():
        unbatched |= {p, f"v_{p}", f"d_{p}", f"{p}_new", f"v_{p}_new"}

    # 1. classify every step: fusable or per-node fallback
    fusable: dict[str, bool] = {}
    for key in keys:
        name, pass_ = key.split(":")
        if name == "loss":
            fusable[key] = not _touches_spill(graph, None, "dx", spilled)
            continue
        node = nodes.get(name)
        if node is None:
            # fan-out accumulate steps ({edge}:acc) have no fusion rule
            fusable[key] = False
            continue
        fusable[key] = _fusable(
            node, pass_, fuse_updates=fuse_updates
        ) and not _touches_spill(graph, node, pass_, spilled)

    # 2. greedy contiguous grouping; groups not worth a kernel demote to
    #    per-node fallbacks before the escape analysis sees them
    groups: list[tuple[bool, list[str]]] = []  # (is_region, step keys)
    for key in keys:
        if fusable[key] and groups and groups[-1][0]:
            groups[-1][1].append(key)
        else:
            groups.append((fusable[key], [key]))
    groups = [
        (ok and _heavy([_stage_of(graph, nodes, k) for k in ks]), ks)
        for ok, ks in groups
    ]

    # 3. per-step IO for escape analysis (fallback steps read their
    #    per-node operands, fused relu-dX masks from the relu output)
    key_fused = {key: ok for ok, ks in groups for key in ks}
    io: dict[str, tuple[list[str], list[str]]] = {}
    for key in keys:
        name, pass_ = key.split(":")
        if pass_ == "acc":
            io[key] = ([], [])
            continue
        node = nodes.get(name) if name != "loss" else None
        io[key] = _step_io(graph, node, pass_, fused=key_fused[key])

    program_outputs = {graph.logits_edge}
    for p in graph.param_shapes():
        program_outputs.add(f"{p}_new")
        if keep_grads:
            program_outputs.add(f"d_{p}")
        if graph.momentum:
            program_outputs.add(f"v_{p}_new")

    readers: dict[str, set[str]] = {}
    for key in keys:
        for edge in io[key][0]:
            readers.setdefault(edge, set()).add(key)

    plan = FusionPlan()
    for is_region, ks in groups:
        if not is_region:
            for key in ks:
                plan.segments.append(Segment(step=key))
                plan.fallback_steps.append(key)
            continue
        in_region = set(ks)
        written: set[str] = set()
        inputs: dict[str, bool] = {}
        outputs: dict[str, str] = {}
        for key in ks:
            reads, writes = io[key]
            for edge in reads:
                if edge not in written and edge not in inputs:
                    inputs[edge] = edge not in unbatched
            written.update(writes)
        for key in ks:
            for edge in io[key][1]:
                escapes = edge in program_outputs or any(
                    r not in in_region for r in readers.get(edge, ())
                )
                if escapes and edge not in outputs:
                    outputs[edge] = "reduced" if edge in unbatched else "batched"
        region = RegionSpec(
            stages=tuple(_stage_of(graph, nodes, k) for k in ks),
            batch=graph.batch,
            lr=graph.lr,
            momentum=graph.momentum,
            inputs=tuple(inputs.items()),
            outputs=tuple(outputs.items()),
        )
        plan.segments.append(Segment(region=region))
        plan.fused_steps |= in_region

    # 4. command-level coverage accounting against the program's blocks
    for block in program.blocks if program is not None else ():
        step = ":".join(block.tag.split(":")[:2])
        plan.total_commands += block.n_commands
        if step in plan.fused_steps:
            plan.fused_commands += block.n_commands
    return plan
