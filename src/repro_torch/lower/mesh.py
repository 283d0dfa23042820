"""Mesh-of-HMCs data parallelism: shard a train-step program across cubes
(``repro/lower/mesh.py``).

The paper's §4.9 scales training past one HMC by replicating the cube and
splitting the batch: every cube runs the same step on its shard of the
images, then the weight update is exchanged over the serial links (eqs.
14-21). :func:`shard_training_step` realizes that at the command level: it
takes ONE whole-train-step :class:`~repro_torch.lower.ir.NtxProgram` and
splits it into per-HMC shard programs plus an explicit gradient-allreduce
epilogue, emitted as ordinary DMA/MAC command blocks
(:class:`~repro_torch.lower.ir.CommandBlock`).

Bit-identity is the design invariant, and it holds *by construction* rather
than by tolerance:

  * **Batch-parallel blocks** (forward, dX, the per-image conv-dW replicas,
    the loss-gradient stream) are split along the batch: either the
    outermost driver replication level the graph compiler appended
    (:func:`split_block_reps`) or the outermost template loop
    (:func:`~repro_torch.runtime.scheduler.partition_command`).
    Concatenating the shard pieces in shard order reproduces the original
    command stream exactly — same commands, same order, same accumulator
    roundings.
  * **Cross-batch gradient reductions** (the conv batch-reduce MAC, the
    matmul dW, the bias db) become the *reduce-scatter* phase: each is
    split along its **output** dims into one chunk per HMC, so every chunk
    keeps its full f64 accumulation over all B contributions in the
    unsharded image order. Chunk c is owned by HMC c and reads the other
    shards' per-image contributions across the mesh links.
  * **The SGD update** splits the same way: HMC c updates the parameter
    chunk it just reduced (the ZeRO-style sharded update of the paper's
    systolic weight exchange), and an **allgather** epilogue of identity
    ``copy`` blocks broadcasts every updated chunk back to the replicas —
    a no-op in the flat reference memory (read AGU == write AGU), but
    carrying the link traffic the timing model charges.

The matmul-dW chunks read the batch-sharded *activations* across links (an
activation gather) instead of pre-reduced gradient partials, because a
per-shard partial sum would insert an extra fp32 rounding and break
bit-identity. The timing model charges the §4.9 weight-update traffic
(eqs. 14-15) either way.

``shard_training_step(..., shard="2d")`` lays the same step out over a 2D
logical mesh: rows are **pipeline stages** (contiguous layer runs balanced
by busy cycles, GPipe-style microbatch fill/drain) and columns are a
**tensor/data hybrid** within each stage — conv/matmul/bias blocks split
their output-channel replication level across the row (the rules of
:mod:`repro_torch.parallel.sharding` decide which layers tensor-shard),
stage parameters live only on their row, and the stage-boundary
activations and gradients cross the vertical links as explicit
``send:``/``recv:`` identity-copy chunks. Every communication block is an
identity copy and every compute split is a disjoint partition of pure
output dims, so the combined stream replays the unsharded arithmetic
exactly. See :func:`_split_program_2d`.

The combined program (:attr:`ShardedTrainStep.program`) is consumed
unchanged by ``run_reference`` and ``run_timing``; ``run_torch`` takes its
mesh route (:mod:`repro_torch.lower.executors`), and
:mod:`repro_torch.runtime.mesh` times the per-HMC shard programs plus the
inter-HMC link schedule (``time_mesh_step`` / ``time_mesh_step_2d``).

The combined program's ``meta`` is the base program's without its private
memo keys (``_fusion_plans``, ``_ntx_exec``: plans and command tables of the
base program's blocks), plus ``"mesh"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from repro_torch.core.ntx import Agu, NtxCommand
from repro_torch.lower.graph import NetworkGraph, lower_training_step
from repro_torch.lower.ir import (
    ELEM_BYTES,
    CommandBlock,
    DesignPoint,
    NTX_DESIGN,
    NtxProgram,
    TensorRegion,
)

#: Blocks whose template body is at most this many iterations are treated as
#: driver-side staging (constant memsets, the 1.0 scalar) and replicated to
#: every HMC instead of being assigned to one.
_TINY_ITERS = 64

#: hmc assignment sentinel: the block runs on every HMC (reference executes
#: it once; the timing model charges it to each cube).
ALL_HMCS = -1


def _public(meta: dict) -> dict:
    """``meta`` without its private memo keys (``_``-prefixed): a sharded
    program has other blocks than the program it was split from."""
    return {k: v for k, v in meta.items() if not k.startswith("_")}


def parse_mesh(mesh: str | tuple[int, int]) -> tuple[int, int]:
    """``"2x4"`` or ``(2, 4)`` -> (rows, cols)."""
    if isinstance(mesh, str):
        try:
            r, c = (int(p) for p in mesh.lower().split("x"))
        except ValueError as e:
            raise ValueError(f"mesh spec {mesh!r} is not 'RxC'") from e
        return r, c
    r, c = mesh
    return int(r), int(c)


def _chunk_sizes(n: int, parts: int) -> list[int]:
    """The contiguous chunk sizes :func:`partition_command` uses (remainder
    spread over the first chunks) — shared so reduce/update/allgather agree
    on ownership boundaries."""
    parts = min(parts, n)
    base, rem = divmod(n, parts)
    return [base + (1 if p < rem else 0) for p in range(parts)]


def _rebased(agu: Agu | None, delta: int) -> Agu | None:
    if agu is None or delta == 0:
        return agu
    return Agu(agu.base + delta, agu.strides)


def split_block_reps(
    block: CommandBlock, parts: int, level: int = -1
) -> list[CommandBlock]:
    """Split one of a block's driver replication levels into ``parts``
    contiguous runs.

    ``level`` indexes :attr:`CommandBlock.reps` (innermost first; the
    default ``-1`` is the outermost level — the batch loop the graph
    compiler appended, used by the 1D batch split). The 2D tensor split
    passes ``len(reps) - 2``: for every conv lowering (NTX and NS alike)
    that is the output-channel replication level, so the pieces partition
    the layer's output channels.

    Pieces keep the full odometer shape except at ``level``, where piece
    ``p`` covers a contiguous run of replica indices with the template
    rebased by ``start * step`` per AGU — the same arithmetic
    :meth:`CommandBlock.commands` performs. Splitting any rep level
    yields disjoint writes (driver reps are pure output dims — the
    lowering keeps reduction dims inside the template), so concatenating
    the pieces reproduces the original final memory bit for bit even
    though the *outer* iteration order changes when ``level`` is not the
    outermost.
    """
    if level < 0:
        level += len(block.reps)
    n_out = block.reps[level]
    sizes = _chunk_sizes(n_out, parts)
    out = []
    start = 0
    t = block.template
    for sz in sizes:
        d0 = start * block.rd0_step[level]
        d1 = start * block.rd1_step[level]
        dw = start * block.wr_step[level]
        out.append(
            replace(
                block,
                template=NtxCommand(
                    loops=t.loops,
                    opcode=t.opcode,
                    agu_rd0=_rebased(t.agu_rd0, d0),
                    agu_rd1=_rebased(t.agu_rd1, d1),
                    agu_wr=_rebased(t.agu_wr, dw),
                    init_level=t.init_level,
                    store_level=t.store_level,
                    init_value=t.init_value,
                ),
                reps=block.reps[:level] + (sz,) + block.reps[level + 1 :],
            )
        )
        start += sz
    return out


def split_block_template(block: CommandBlock, parts: int) -> list[CommandBlock]:
    """Split a block along its template's outermost splittable loop —
    :func:`~repro_torch.runtime.scheduler.partition_command` with the block's
    driver loops and block-level DMA totals carried over (traffic
    preserved, like ``partition_program``). Blocks whose template refuses
    to split (unit loops, accumulator spans) come back whole.

    Shared by the batch sharding here and the coarse-block §3.1 refinement
    of :mod:`repro_torch.runtime.mesh` — one implementation of the
    piece/DMA-division semantics.
    """
    from repro_torch.runtime.scheduler import partition_command

    try:
        pieces = partition_command(block.template, parts)
    except ValueError:
        pieces = [block.template]
    if len(pieces) == 1:
        return [block]
    return [
        replace(
            block,
            template=p,
            dma_bytes_in=block.dma_bytes_in / len(pieces),
            dma_bytes_out=block.dma_bytes_out / len(pieces),
        )
        for p in pieces
    ]


def _bcast_block(
    region: TensorRegion, start: int, size: int, owner: int, n_hmcs: int,
    *, tag_prefix: str = "allgather",
) -> CommandBlock:
    """One allgather step: HMC ``owner`` broadcasts its updated chunk.

    An identity copy (read AGU == write AGU) over the chunk — semantically
    a no-op in the flat reference memory, but it occupies the engine for
    one cycle per word and carries ``(n_hmcs - 1)`` chunk transfers of link
    traffic, which :mod:`repro_torch.runtime.mesh` schedules over the serial
    links.
    """
    agu = Agu(region.base + start, (1, 0, 0, 0, 0))
    return CommandBlock(
        template=NtxCommand(
            loops=(size, 1, 1, 1, 1),
            opcode="copy",
            agu_rd0=agu,
            agu_wr=agu,
            init_level=0,
            store_level=0,
        ),
        tag=f"{tag_prefix}:{region.name}[{owner}]",
        reads=(region.name,),
        writes=(region.name,),
        dma_bytes_out=float(size * ELEM_BYTES * max(n_hmcs - 1, 0)),
    )


def _xfer_block(
    region: TensorRegion, start: int, size: int, kind: str, idx: int
) -> CommandBlock:
    """One pipeline-boundary transfer chunk: ``send:`` or ``recv:``.

    Like :func:`_bcast_block` an identity copy over a contiguous chunk of
    the boundary tensor — a no-op in the flat reference memory, but the
    block carries the chunk's bytes as outbound (``send``, charged to the
    producing stage's cube) or inbound (``recv``, charged to the consuming
    stage's cube) DMA, and :func:`repro_torch.runtime.mesh.time_mesh_step_2d`
    schedules the matching vertical-link events per microbatch.
    """
    agu = Agu(region.base + start, (1, 0, 0, 0, 0))
    nbytes = float(size * ELEM_BYTES)
    return CommandBlock(
        template=NtxCommand(
            loops=(size, 1, 1, 1, 1),
            opcode="copy",
            agu_rd0=agu,
            agu_wr=agu,
            init_level=0,
            store_level=0,
        ),
        tag=f"{kind}:{region.name}[{idx}]",
        reads=(region.name,),
        writes=(region.name,),
        dma_bytes_out=nbytes if kind == "send" else 0.0,
        dma_bytes_in=nbytes if kind == "recv" else 0.0,
    )


@dataclass
class ShardedTrainStep:
    """One train step split across a mesh of HMCs.

    ``program`` is the combined command stream (bit-identical to the
    unsharded step under ``run_reference``); ``hmc_of_block[i]`` says which
    cube issues ``program.blocks[i]`` (:data:`ALL_HMCS` = every cube).
    ``alive`` is the ordered tuple of surviving cube ids after an elastic
    re-shard (:func:`reshard_training_step`); ``None`` means every cube in
    the physical mesh is healthy.
    """

    graph: NetworkGraph
    mesh_shape: tuple[int, int]
    program: NtxProgram
    base_program: NtxProgram
    hmc_of_block: list[int]
    alive: tuple[int, ...] | None = None

    @property
    def n_hmcs(self) -> int:
        """Cubes in the *physical* mesh (dead ones included)."""
        return self.mesh_shape[0] * self.mesh_shape[1]

    @property
    def alive_hmcs(self) -> tuple[int, ...]:
        return self.alive if self.alive is not None else tuple(range(self.n_hmcs))

    @property
    def n_alive(self) -> int:
        return len(self.alive_hmcs)

    @property
    def failed_hmcs(self) -> tuple[int, ...]:
        return tuple(sorted(set(range(self.n_hmcs)) - set(self.alive_hmcs)))

    @property
    def shard_batch(self) -> int:
        """Images per surviving cube (the largest shard when uneven)."""
        return -(-self.graph.batch // self.n_alive)

    @property
    def shard(self) -> str:
        """``"1d"`` (batch split) or ``"2d"`` (pipeline rows x tensor/data
        columns)."""
        return self.program.meta.get("mesh", {}).get("shard", "1d")

    @property
    def row_owners(self) -> list[tuple[int, ...]] | None:
        """2D programs: surviving cube ids per pipeline row (else None)."""
        ro = self.program.meta.get("mesh", {}).get("row_owners")
        return [tuple(r) for r in ro] if ro is not None else None

    @property
    def allreduce_bytes(self) -> float:
        """Bytes of parameters exchanged per update pass (eq. 14's W)."""
        return float(sum(
            math.prod(shape) * ELEM_BYTES
            for shape in self.graph.param_shapes().values()
        ))

    def shard_program(self, hmc: int) -> NtxProgram:
        """The command stream cube ``hmc`` issues (plus replicated staging).

        All shards are structurally symmetric — timing one of them times
        them all.
        """
        if not 0 <= hmc < self.n_hmcs:
            raise ValueError(f"hmc {hmc} outside mesh {self.mesh_shape}")
        if hmc not in self.alive_hmcs:
            raise ValueError(
                f"hmc {hmc} has failed; survivors are {self.alive_hmcs}"
            )
        blocks = [
            b for b, h in zip(self.program.blocks, self.hmc_of_block)
            if h == hmc or h == ALL_HMCS
        ]
        return NtxProgram(
            name=f"{self.program.name}:hmc{hmc}",
            blocks=blocks,
            regions=self.program.regions,
            design=self.program.design,
            meta={**_public(self.program.meta), "hmc": hmc},
        )

    def epilogue_blocks(self) -> list[tuple[int, CommandBlock]]:
        """(hmc, block) pairs of the communication blocks, in program order.

        1D programs: the reduce-scatter/update/allgather epilogue. 2D
        programs additionally carry the in-row tensor gathers and the
        pipeline-boundary ``send:``/``recv:`` chunks.
        """
        out = []
        comm = ("allreduce:", "allgather:", "tpgather:", "send:", "recv:")
        for b, h in zip(self.program.blocks, self.hmc_of_block):
            if b.tag.startswith(comm):
                out.append((h, b))
        return out


def _n_microbatches(batch: int, rows: int) -> int:
    """GPipe microbatch count for the fill/drain schedule: aim for ~16
    in-flight microbatches (bubble fraction ``(R-1)/(M+R-1)`` under 20%
    for R <= 4), clipped to what divides the batch."""
    if rows <= 1:
        return 1
    return max(1, math.gcd(batch, 16 * (rows - 1)))


def shard_training_step(
    graph: NetworkGraph,
    *,
    design: DesignPoint = NTX_DESIGN,
    mesh_shape: str | tuple[int, int] = (2, 2),
    n_clusters: int = 16,
    keep_grads: bool = True,
    program: NtxProgram | None = None,
    shard: str = "1d",
) -> ShardedTrainStep:
    """Compile ``graph`` and split its train-step program across a mesh.

    ``program`` optionally supplies the already-compiled unsharded step
    (must come from ``lower_training_step(graph, ...)`` with the same
    design). The batch must divide evenly over the mesh.

    ``shard="1d"`` (default) is pure data parallelism — every cube runs
    the whole step on its batch shard. Block classification:

      * blocks writing a ``d_<param>`` region are the gradient reductions —
        split by output chunk (**reduce-scatter**, chunk c -> HMC c) and
        re-tagged ``allreduce:reduce:...``;
      * blocks writing ``<param>_new`` / ``v_<param>_new`` are the update —
        split by the same chunks (owner updates what it reduced), with the
        weight allgather appended after the parameter's last update piece;
      * everything else splits along the batch (outermost rep level, else
        the outermost template loop); unsplittable staging (constant
        memsets) is replicated to every HMC.

    ``shard="2d"`` maps mesh *rows* to pipeline stages (contiguous layer
    runs balanced by busy cycles, GPipe fill/drain over
    ``meta["mesh"]["pipeline"]["n_micro"]`` microbatches) and mesh
    *columns* to a tensor/data hybrid within each stage — see
    :func:`_split_program_2d`. Stage parameters live only on their row
    (the per-shard weight regions: each row holds ~1/R of the model), so
    a model too big for one HMC fits a tall-enough mesh. Both layouts
    produce a combined stream that is bit-identical to the unsharded step
    under ``run_reference``.
    """
    rows, cols = parse_mesh(mesh_shape)
    n = rows * cols
    if n < 1:
        raise ValueError(f"degenerate mesh {rows}x{cols}")
    if graph.batch % n:
        raise ValueError(
            f"batch {graph.batch} does not divide over a {rows}x{cols} mesh"
        )
    if shard not in ("1d", "2d"):
        raise ValueError(f"shard must be '1d' or '2d', got {shard!r}")
    if program is None:
        program = lower_training_step(
            graph, design=design, n_clusters=n_clusters, keep_grads=keep_grads
        )

    if shard == "2d":
        row_owners = [tuple(range(r * cols, (r + 1) * cols)) for r in range(rows)]
        blocks, hmc_of, pmeta = _split_program_2d(program, graph, row_owners)
        pmeta["n_micro"] = _n_microbatches(graph.batch, rows)
        mesh_meta = {
            "shape": (rows, cols),
            "n_hmcs": n,
            "shard_batch": graph.batch // n,
            "shard": "2d",
            "row_owners": [list(ro) for ro in row_owners],
            "pipeline": pmeta,
        }
    else:
        blocks, hmc_of = _split_program_onto(program, graph, tuple(range(n)))
        mesh_meta = {
            "shape": (rows, cols),
            "n_hmcs": n,
            "shard_batch": graph.batch // n,
        }

    combined = NtxProgram(
        name=f"{program.name}:mesh{rows}x{cols}"
        + (":2d" if shard == "2d" else ""),
        blocks=blocks,
        regions=program.regions,
        design=program.design,
        meta={**_public(program.meta), "mesh": mesh_meta},
    )
    sharded = ShardedTrainStep(
        graph=graph,
        mesh_shape=(rows, cols),
        program=combined,
        base_program=program,
        hmc_of_block=hmc_of,
    )
    from repro_torch.obs import counters as obs

    reg = obs.get_active()
    if reg is not None:
        with reg.scope("shard"):
            reg.inc("programs", 1)
            reg.inc("hmcs", n)
            reg.inc("epilogue_blocks", len(sharded.epilogue_blocks()))
            reg.inc("allreduce_bytes", sharded.allreduce_bytes)
            if shard == "2d":
                reg.inc("pipeline_stages", rows)
    return sharded


def _split_program_onto(
    program: NtxProgram, graph: NetworkGraph, owners: tuple[int, ...]
) -> tuple[list[CommandBlock], list[int]]:
    """Partition the unsharded step program over the cubes in ``owners``.

    The shared core of :func:`shard_training_step` (owners = the whole
    mesh) and :func:`reshard_training_step` (owners = the survivors).
    ``len(owners)`` sets the number of batch shards / reduce-scatter chunks;
    the owner *values* are the physical cube ids the pieces land on, so a
    degraded mesh re-partitions the exact same command stream onto fewer
    cubes — concatenation order (and therefore ``run_reference`` output) is
    unchanged by construction.
    """
    parts = len(owners)
    params = set(graph.param_shapes())
    grad_regions = {f"d_{p}" for p in params}
    new_regions = {f"{p}_new" for p in params} | {f"v_{p}_new" for p in params}
    param_of_new = {f"{p}_new": p for p in params}

    blocks: list[CommandBlock] = []
    hmc_of: list[int] = []

    def emit(piece: CommandBlock, hmc: int) -> None:
        blocks.append(piece)
        hmc_of.append(hmc)

    def emit_split(pieces: list[CommandBlock], retag: str | None = None) -> None:
        if len(pieces) == 1:
            b = pieces[0]
            tiny = b.template.total_iterations <= _TINY_ITERS and b.n_commands == 1
            emit(b, ALL_HMCS if tiny else owners[0])
            return
        for i, b in enumerate(pieces):
            if retag:
                b = replace(b, tag=f"{retag}:{b.tag}[{i}]")
            # pieces < parts only when the split dim had fewer iterations
            # than cubes; owners then cover a prefix of the survivors.
            emit(b, owners[i % parts])

    def output_split(b: CommandBlock) -> list[CommandBlock]:
        # Reduction/update blocks keep every reduction dim inside the
        # template (the lowering enforces usable >= n_red), so any driver
        # rep level is a pure output dim: rep-split and template-split are
        # both contiguous output-chunk (reduce-scatter) splits.
        return (
            split_block_reps(b, parts) if b.reps else split_block_template(b, parts)
        )

    for block in program.blocks:
        spillage = block.tag.startswith(("spill:", "fill:"))
        is_reduce = not spillage and any(w in grad_regions for w in block.writes)
        is_update = not spillage and any(w in new_regions for w in block.writes)
        if is_reduce:
            # cross-batch gradient reduction: output-chunk split ==
            # reduce-scatter. (Batched conv per-image dW replica writes
            # target the ``<node>.dwb`` staging region, not ``d_<param>``,
            # and take the batch split below — they are shard-local.)
            emit_split(output_split(block), retag="allreduce:reduce")
            continue
        if is_update:
            emit_split(output_split(block), retag="allreduce:update")
            # after the *parameter* update (not the momentum block), each
            # owner broadcasts its updated chunk to the other replicas
            wn = next((w for w in block.writes if w in param_of_new), None)
            if wn is not None:
                r = program.regions[wn]
                start = 0
                for c, sz in enumerate(_chunk_sizes(r.size, parts)):
                    if parts > 1:
                        emit(_bcast_block(r, start, sz, owners[c], parts), owners[c])
                    start += sz
            continue
        if block.reps:
            emit_split(split_block_reps(block, parts))
        else:
            emit_split(split_block_template(block, parts))

    return blocks, hmc_of


def _balanced_cuts(weights: list[int], k: int) -> list[tuple[int, int]]:
    """Contiguous min-max partition of ``weights`` into ``k`` non-empty
    runs (classic linear-partition DP). Returns ``[(start, stop), ...]``."""
    n = len(weights)
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    inf = float("inf")
    best = [[inf] * (k + 1) for _ in range(n + 1)]
    arg = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, min(i, k) + 1):
            for m in range(j - 1, i):
                cost = max(best[m][j - 1], prefix[i] - prefix[m])
                if cost < best[i][j]:
                    best[i][j] = cost
                    arg[i][j] = m
    cuts: list[tuple[int, int]] = []
    i, j = n, k
    while j:
        m = arg[i][j]
        cuts.append((m, i))
        i, j = m, j - 1
    return cuts[::-1]


def _pipeline_stages(
    graph: NetworkGraph, program: NtxProgram, n_stages: int
) -> tuple[list[list[str]], list[int]]:
    """Assign the graph's layers to ``n_stages`` contiguous pipeline stages.

    Stage weight is the layer's busy cycles in the unsharded step program
    (fwd + dW + dX + update, read off the block tags), so the min-max cut
    balances the *training* work per mesh row, not the parameter count.
    The loss gradient runs where the logits live (folded into the last
    layer); spill/fill traffic rides with whichever stage is active.
    Zero-cycle layers trailing a stage (flatten aliases) are pushed into
    the next stage so every stage boundary edge is a tensor some block
    actually writes.
    """
    names = [nd.name for nd in graph.nodes]
    cyc = dict.fromkeys(names, 0)
    extra_last = 0
    for b in program.blocks:
        head = b.tag.split(":")[0]
        if head in cyc:
            cyc[head] += b.busy_cycles
        elif head == "loss":
            extra_last += b.busy_cycles
    weights = [cyc[nm] for nm in names]
    weights[-1] += extra_last
    busy = sum(1 for w in weights if w > 0)
    if n_stages > busy:
        raise ValueError(
            f"mesh has {n_stages} pipeline rows but {graph.name!r} has only "
            f"{busy} layers with compute to place on them"
        )
    stages = [list(names[a:b]) for a, b in _balanced_cuts(weights, n_stages)]
    for r in range(len(stages) - 1):
        while len(stages[r]) > 1 and cyc[stages[r][-1]] == 0:
            stages[r + 1].insert(0, stages[r].pop())
    stage_cycles = [
        sum(cyc[nm] for nm in st) + (extra_last if r == len(stages) - 1 else 0)
        for r, st in enumerate(stages)
    ]
    return stages, stage_cycles


def _split_program_2d(
    program: NtxProgram,
    graph: NetworkGraph,
    row_owners: list[tuple[int, ...]],
) -> tuple[list[CommandBlock], list[int], dict]:
    """Partition the unsharded step over a 2D (pipeline x tensor/data) mesh.

    Row ``r`` of ``row_owners`` lists the surviving cube ids of pipeline
    stage ``r`` (elastic re-sharding passes shrunken rows). Within a row
    the split is Megatron-style tensor/data hybrid:

      * layers with a tensor rule (:func:`repro_torch.parallel.sharding
        .cnn_param_spec` — conv/matmul/bias) split their *output-channel*
        replication level (``reps[-2]``, present in every conv lowering)
        across the row's columns, followed by an in-row ``tpgather:``
        identity-copy round that re-replicates the produced tensor (the
        Megatron allgather; its bytes ride on the blocks);
      * layers without a rule (pool/relu/loss) and template-only blocks
        split along the batch / outermost template loop as in 1D —
        their outputs are gathered the same way so "replicated within the
        row after the producing step" is an invariant every consumer can
        rely on;
      * gradient reductions and the ZeRO update split by output chunk
        across the row (reduce-scatter; chunk c -> column c), with the
        weight allgather scoped to the row — stage ``r``'s parameters
        never leave their row. Reduce-scatter *inputs* (the per-image
        ``.dwb`` partials, the dW activation operands) skip the gather:
        that traffic is priced by the per-row weight-update exchange
        (eqs. 14-15), exactly like the 1D splitter's deviation note.

    Stage boundary tensors (the last layer's activation going down, its
    gradient coming back up) get explicit ``send:``/``recv:`` chunk pairs
    emitted the moment their producing step ends, so the vertical-link
    traffic is visible to :class:`repro_torch.runtime.mesh.MeshInterconnect`.
    All communication blocks are identity copies: ``run_reference`` of the
    combined stream stays bit-identical to the unsharded step.
    """
    from repro_torch.parallel.sharding import cnn_param_spec

    rows = len(row_owners)
    stages, stage_cycles = _pipeline_stages(graph, program, rows)
    stage_of = {nm: r for r, st in enumerate(stages) for nm in st}
    stage_of["loss"] = rows - 1
    node_of = {nd.name: nd for nd in graph.nodes}
    tensor_nodes = {
        nd.name
        for nd in graph.nodes
        if nd.param is not None
        and (spec := cnn_param_spec(nd.spec)) is not None
        and any(ax is not None for ax in spec)
    }
    params = set(graph.param_shapes())
    grad_regions = {f"d_{p}" for p in params}
    new_regions = {f"{p}_new" for p in params} | {f"v_{p}_new" for p in params}
    param_of_new = {f"{p}_new": p for p in params}
    param_rows = {
        nd.param: stage_of[nd.name] for nd in graph.nodes if nd.param is not None
    }
    stage_param_bytes = [0] * rows
    for p, shape in graph.param_shapes().items():
        stage_param_bytes[param_rows[p]] += math.prod(shape) * ELEM_BYTES

    written: set[str] = set()
    reduce_inputs: set[str] = set()
    for b in program.blocks:
        written.update(b.writes)
        if any(w in grad_regions for w in b.writes):
            reduce_inputs.update(b.reads)

    def _resolve(name: str) -> str | None:
        """Region actually written under ``name``'s storage (alias chase:
        flatten/bias edges share the producer's base)."""
        if name not in program.regions:
            return None
        if name in written:
            return name
        reg = program.regions[name]
        for n2, r2 in program.regions.items():
            if n2 != name and r2.base == reg.base and r2.size == reg.size and n2 in written:
                return n2
        return None

    # boundary tensors: stage r's last activation flows down to r+1, its
    # gradient flows back up. watch[written_name] = (src_row, dst_row, edge)
    watch: dict[str, tuple[int, int, str]] = {}
    boundaries: list[str] = []
    for r in range(rows - 1):
        edge = node_of[stages[r][-1]].out_edge
        boundaries.append(edge)
        fwd = _resolve(edge)
        if fwd is not None:
            watch[fwd] = (r, r + 1, edge)
        bwd = _resolve(f"d_{edge}")
        if bwd is not None:
            watch[bwd] = (r + 1, r, f"d_{edge}")

    blocks: list[CommandBlock] = []
    hmc_of: list[int] = []
    xfers: list[dict] = []

    def emit(piece: CommandBlock, hmc: int) -> None:
        blocks.append(piece)
        hmc_of.append(hmc)

    def emit_split(
        pieces: list[CommandBlock],
        owners: tuple[int, ...],
        retag: str | None = None,
    ) -> bool:
        """Returns True when the block actually fanned out over the row."""
        if len(pieces) == 1:
            b = pieces[0]
            tiny = b.template.total_iterations <= _TINY_ITERS and b.n_commands == 1
            emit(b, ALL_HMCS if tiny else owners[0])
            return False
        for i, b in enumerate(pieces):
            if retag:
                b = replace(b, tag=f"{retag}:{b.tag}[{i}]")
            emit(b, owners[i % len(owners)])
        return True

    def gather_row(region_name: str, owners: tuple[int, ...]) -> None:
        reg = program.regions[region_name]
        parts = len(owners)
        start = 0
        for c, sz in enumerate(_chunk_sizes(reg.size, parts)):
            emit(
                _bcast_block(reg, start, sz, owners[c], parts, tag_prefix="tpgather"),
                owners[c],
            )
            start += sz

    def flush(name: str) -> None:
        src, dst, edge = watch.pop(name)
        reg = program.regions[name]
        for side, kind in ((src, "send"), (dst, "recv")):
            start = 0
            for c, sz in enumerate(_chunk_sizes(reg.size, len(row_owners[side]))):
                emit(_xfer_block(reg, start, sz, kind, c), row_owners[side][c])
                start += sz
        xfers.append({
            "edge": edge,
            "region": name,
            "bytes": reg.size * ELEM_BYTES,
            "src": src,
            "dst": dst,
        })

    cur_stage = 0
    cur_key: tuple[str, ...] | None = None
    pending: list[str] = []

    for block in program.blocks:
        parts_tag = block.tag.split(":")
        head = parts_tag[0]
        key = tuple(parts_tag[:2])
        if key != cur_key:
            cur_key = key
            for name in pending:
                flush(name)
            pending = []
        if head in stage_of:
            cur_stage = stage_of[head]
        owners = row_owners[cur_stage]
        parts = len(owners)

        spillage = head in ("spill", "fill")
        is_reduce = not spillage and any(w in grad_regions for w in block.writes)
        is_update = not spillage and any(w in new_regions for w in block.writes)
        if is_reduce:
            pieces = (
                split_block_reps(block, parts)
                if block.reps
                else split_block_template(block, parts)
            )
            emit_split(pieces, owners, retag="allreduce:reduce")
        elif is_update:
            pieces = (
                split_block_reps(block, parts)
                if block.reps
                else split_block_template(block, parts)
            )
            emit_split(pieces, owners, retag="allreduce:update")
            wn = next((w for w in block.writes if w in param_of_new), None)
            if wn is not None and parts > 1:
                reg = program.regions[wn]
                start = 0
                for c, sz in enumerate(_chunk_sizes(reg.size, parts)):
                    emit(_bcast_block(reg, start, sz, owners[c], parts), owners[c])
                    start += sz
        else:
            if (
                head in tensor_nodes
                and len(block.reps) >= 2
                and not block.is_staging
            ):
                # output-channel split: reps[-2] is the channel replication
                # level in every conv lowering (batch is always outermost)
                pieces = split_block_reps(block, parts, level=len(block.reps) - 2)
            elif block.reps:
                pieces = split_block_reps(block, parts)
            else:
                pieces = split_block_template(block, parts)
            fanned = emit_split(pieces, owners)
            if (
                fanned
                and not block.is_staging
                and block.writes
                and block.writes[0] in program.regions
                and block.writes[0] not in reduce_inputs
            ):
                gather_row(block.writes[0], owners)

        for w in block.writes:
            if w in watch and w not in pending:
                pending.append(w)

    for name in list(pending):
        flush(name)

    pmeta = {
        "n_stages": rows,
        "stages": [list(st) for st in stages],
        "stage_cycles": [int(c) for c in stage_cycles],
        "stage_param_bytes": [int(b) for b in stage_param_bytes],
        "param_rows": param_rows,
        "boundaries": boundaries,
        "xfers": xfers,
    }
    return blocks, hmc_of, pmeta


def reshard_training_step(
    sharded: ShardedTrainStep, failed: int | tuple[int, ...] | list[int]
) -> ShardedTrainStep:
    """Elastic re-shard after cube loss: same step, surviving cubes only.

    Re-partitions the *unsharded* base program onto the cubes that are
    still alive — batch shards, reduce-scatter chunks, ZeRO update chunks
    and the allgather epilogue are all re-chunked for ``n_alive`` owners —
    so ``run_reference(resharded.program)`` stays bit-identical to the
    unsharded step (the command stream is re-grouped, never re-ordered or
    re-rounded). An uneven batch is allowed on the degraded mesh: the
    remainder spreads over the first survivors (:func:`_chunk_sizes`),
    matching how ``run_torch`` falls back to the single-device walk when
    the survivors cannot take an even split.

    ``failed`` names physical cube ids; cubes already dead in ``sharded``
    stay dead (failures accumulate across successive re-shards).

    2D programs re-shard *within rows*: losing a cube inside a tensor
    group re-chunks that pipeline stage's tensor/data split (and its
    row-scoped reduce-scatter/update/allgather) over the row's survivors,
    leaving the other stages untouched. A row that loses every cube takes
    its pipeline stage with it — that raises, because no re-chunking can
    recover a stage with zero compute left (restore from a checkpoint
    instead).
    """
    if isinstance(failed, int):
        failed = (failed,)
    dead = set(sharded.failed_hmcs) | {int(h) for h in failed}
    bad = dead - set(range(sharded.n_hmcs))
    if bad:
        raise ValueError(f"failed cubes {sorted(bad)} outside mesh {sharded.mesh_shape}")
    alive = tuple(h for h in range(sharded.n_hmcs) if h not in dead)
    if not alive:
        raise ValueError(f"no surviving HMCs in mesh {sharded.mesh_shape}")

    program = sharded.base_program
    rows, cols = sharded.mesh_shape
    if sharded.shard == "2d":
        row_owners = [
            tuple(h for h in range(r * cols, (r + 1) * cols) if h in set(alive))
            for r in range(rows)
        ]
        dead_rows = [r for r, ro in enumerate(row_owners) if not ro]
        if dead_rows:
            raise ValueError(
                f"pipeline stage row(s) {dead_rows} lost every cube in mesh "
                f"{rows}x{cols}; a 2d program needs at least one survivor "
                "per row (restore from checkpoint instead)"
            )
        blocks, hmc_of, pmeta = _split_program_2d(program, sharded.graph, row_owners)
        pmeta["n_micro"] = _n_microbatches(sharded.graph.batch, rows)
        mesh_meta = {
            "shape": (rows, cols),
            "n_hmcs": rows * cols,
            "alive": list(alive),
            "failed": sorted(dead),
            "shard_batch": -(-sharded.graph.batch // len(alive)),
            "shard": "2d",
            "row_owners": [list(ro) for ro in row_owners],
            "pipeline": pmeta,
        }
    else:
        blocks, hmc_of = _split_program_onto(program, sharded.graph, alive)
        mesh_meta = {
            "shape": (rows, cols),
            "n_hmcs": rows * cols,
            "alive": list(alive),
            "failed": sorted(dead),
            "shard_batch": -(-sharded.graph.batch // len(alive)),
        }
    combined = NtxProgram(
        name=f"{program.name}:mesh{rows}x{cols}:alive{len(alive)}",
        blocks=blocks,
        regions=program.regions,
        design=program.design,
        meta={**_public(program.meta), "mesh": mesh_meta},
    )
    out = ShardedTrainStep(
        graph=sharded.graph,
        mesh_shape=(rows, cols),
        program=combined,
        base_program=program,
        hmc_of_block=hmc_of,
        alive=alive,
    )
    from repro_torch.obs import counters as obs

    reg = obs.get_active()
    if reg is not None:
        with reg.scope("reshard"):
            reg.inc("programs", 1)
            reg.inc("failed_hmcs", len(dead))
            reg.inc("alive_hmcs", len(alive))
            reg.inc("epilogue_blocks", len(out.epilogue_blocks()))
    return out
