"""Training driver of the port: ``python -m repro_torch.launch.train [--backend ntx|xla]``.

``--backend xla`` is the JAX CLI's default route, the model-zoo trainer
(``--arch``, default ``qwen1_5_0_5b``; ``--reduced``): the train-step
factory :func:`make_train_step` (blockwise attention and chunked SSD,
autograd, clipping, SGD or AdamW) under the fault-tolerant
:class:`~repro_torch.runtime.supervisor.Supervisor` (``--ckpt-dir``,
``--ckpt-every``, ``--crash-at``), fed by the in-memory
:class:`~repro_torch.data.pipeline.DataIterator`; ``--offload-report``
prints :func:`offload_step_report`. The port's default stays ``ntx``.

Counterpart of ``repro/launch/train.py``'s ``run_ntx_cnn``, ``run_ntx_lm``
and the ntx branch of its CLI: lower the paper's small CNN — or, with
``--model``, a decoder-only transformer built from a config of
:mod:`repro_torch.configs` (``--reduced`` for the smoke-scale one) — to one
NTX program per step (printed as blocks, commands, peak TCDM against the
budget and spills; the LM also prints the timing model's offloads and
cycles), then train it with every step one pass of the torch executor —
fused region kernels by default (the fusion plan's coverage of the
program's commands is printed), per-node streaming matmuls with
``--no-fuse``. ``--check-grads`` holds the LM's gradients against
``torch.autograd`` of a plain graph oracle. Runs on the CUDA device unless
``--device cpu`` is given.

``--mesh RxC`` shards the step program across an RxC mesh of HMCs
(:func:`~repro_torch.lower.mesh.shard_training_step`; ``--shard 2d`` makes
rows pipeline stages and columns tensor/data shards), prints the mesh, the
route the executor takes (:func:`~repro_torch.lower.executors.mesh_route`)
and the modeled mesh step of :func:`~repro_torch.runtime.mesh.time_mesh_step`
(NTX cycle model and link schedule, not a time on any chip), then trains
the sharded program.

``--chaos SPEC`` injects faults into the CNN run
(:class:`~repro_torch.runtime.faults.ChaosSchedule` grammar: a killed cube's
step is discarded, the program re-shards onto the survivors and the step
replays; a preemption rewinds to the latest checkpoint, kept in
``--chaos-ckpt DIR``; a straggler is recorded) and prints every event and
the modeled recovery.

``--metrics OUT.jsonl`` writes one JSON record per step (loss, wall
seconds, the step's counters: the program's closed-form offload, cycle and
DMA counts, the plan cache's and the fuser's); ``--trace OUT.json`` writes
one chrome trace (Perfetto or ``chrome://tracing``) with the host's
lowering and dispatch spans and the NTX cycle model's cluster lanes of the
step program (with ``--mesh``: the lead cube's shard lanes, the weight
exchange's link lanes and their flows). Either also prints the top-k
hotspot table.
"""

from __future__ import annotations

import argparse
import contextlib
import math

import numpy as np

import torch

from repro_torch import obs
from repro_torch.kernels.ops import resolve_device, strict_fp32
from repro_torch.lower import (
    AttentionSpec,
    EmbeddingSpec,
    LayerNormSpec,
    MatmulSpec,
    NetworkGraph,
    PlanCache,
    PosEmbedSpec,
    ReluSpec,
    ResidualAddSpec,
    frequency_band_batches,
    lm_token_batches,
    lower_training_step,
    one_hot_rows,
    paper_cnn_graph,
    run_timing,
    run_torch,
    train_graph,
)
from repro_torch.lower import executors
from repro_torch.lower.mesh import parse_mesh, shard_training_step
from repro_torch.models import lm
from repro_torch.models.blocks import param_pytree
from repro_torch.optim.optimizers import (
    apply_updates,
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    tree_items,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime.mesh import time_mesh_step

#: the CLI's learning rate for --model (the JAX CLI's --lr default)
LM_LR = 3e-3


def validate_mesh_args(mesh: str | None, shard: str, batch: int) -> tuple[int, int] | None:
    """Upfront ``--mesh`` / ``--shard`` validation with actionable errors.

    Checks what would otherwise surface as a deep splitter failure: the
    mesh spec parses as RxC, the mesh is not degenerate, the batch divides
    over the cubes, and ``--shard 2d`` has a mesh to shard over. Fewer
    ranks than cubes is only a note — the executor takes the single-device
    walk. Returns (rows, cols), or None when no mesh was requested.
    """
    if shard not in ("1d", "2d"):
        raise SystemExit(f"--shard must be '1d' or '2d', got {shard!r}")
    if mesh is None:
        if shard == "2d":
            raise SystemExit(
                "--shard 2d needs a mesh: pass --mesh RxC (rows = pipeline "
                "stages, columns = tensor/data shards), e.g. --mesh 2x2"
            )
        return None
    try:
        rows, cols = parse_mesh(mesh)
    except ValueError as e:
        raise SystemExit(
            f"bad --mesh {mesh!r}: {e} (expected RxC, e.g. --mesh 2x4)"
        ) from None
    if rows < 1 or cols < 1:
        raise SystemExit(
            f"--mesh {mesh!r} is degenerate: both dimensions must be >= 1"
        )
    n = rows * cols
    if batch % n != 0:
        raise SystemExit(
            f"--batch {batch} does not divide over the {rows}x{cols} mesh "
            f"({n} cubes); pick a batch that is a multiple of {n}, e.g. "
            f"--batch {max(n, (batch // n + 1) * n)}"
        )
    ranks = executors.world_size()
    if ranks < n:
        print(f"note: {ranks} rank(s) < {n} cubes — run_torch will use the "
              f"(bit-identical) single-device walk")
    return rows, cols


def _shard(graph, program, mesh: str, shard: str, n_clusters: int, unit: str):
    """Shard ``program`` over ``mesh``; print the mesh, the executor's route,
    the 2D pipeline and the modeled mesh step (the JAX driver's lines).
    Returns the sharded step, its route and its modeled timing."""
    sharded = shard_training_step(graph, mesh_shape=mesh, n_clusters=n_clusters,
                                  program=program, shard=shard)
    prog = sharded.program
    route = executors.mesh_route(prog)
    ranks = executors.world_size()
    how = ("the sharded walk (1 rank: the gradient reduce over one shard)"
           if route == "sharded"
           else f"single-device walk ({ranks} rank(s) < {sharded.n_alive} HMCs)"
           if ranks < sharded.n_alive
           else f"single-device walk (batch {graph.batch} does not divide over "
                f"{sharded.n_alive} HMCs)")
    print(f"mesh {sharded.mesh_shape[0]}x{sharded.mesh_shape[1]}: "
          f"{sharded.n_hmcs} HMCs x {sharded.shard_batch} {unit}, "
          f"{len(prog.blocks)} blocks incl. allreduce epilogue; "
          f"executing via {how}")
    if sharded.shard == "2d":
        pmeta = prog.meta["mesh"]["pipeline"]
        stages = [">".join(st) for st in pmeta["stages"]]
        print(f"2d pipeline: {pmeta['n_stages']} stage(s) "
              f"[{' | '.join(stages)}], "
              f"{pmeta['n_micro']} microbatch(es), "
              f"{len(pmeta['xfers'])} boundary transfer(s)")
    tm = time_mesh_step(sharded, n_clusters=n_clusters)
    print(f"modeled mesh step: shard {tm.t_shard*1e3:.3f} ms + "
          f"update {tm.t_update*1e3:.3f} ms "
          f"-> speedup {tm.speedup:.2f}, "
          f"parallel eff {tm.parallel_eff:.1%}")
    if sharded.shard == "2d":
        print(f"2d timing: compute {tm.t_compute*1e3:.3f} ms "
              f"(bubble {tm.bubble_frac:.1%}), boundary "
              f"{tm.t_boundary*1e3:.3f} ms (overlapped)")
    return {"sharded": sharded, "route": route, "mesh_timing": tm}


def _trace_lanes(collector, program, sharded, n_clusters: int, trace: str) -> None:
    """The modeled lanes of the step: the lead cube's shard and the link
    exchange with a mesh, else the whole program on ``hmc0``."""
    if sharded is not None:
        result, _ = collector.add_mesh_step(sharded, n_clusters=n_clusters)
    else:
        # the lane-rendering timing run must not book into the run's counters
        with obs.use_registry(None):
            result = run_timing(program, n_clusters=n_clusters)
        collector.add_cluster_lanes(program, result, n_clusters, pid="hmc0")
        exec_evs = [e for e in collector.events if e.get("cat") == "exec"]
        collector.link_flows(exec_evs, [])
    print(f"merged trace: {collector.save(trace)} ({len(collector.events)} events; "
          f"modeled step {result.total_cycles} NTX cycles) — open in "
          "https://ui.perfetto.dev or chrome://tracing")


def run_ntx_cnn(steps: int, batch: int, img: int, *, n_clusters: int = 16,
                lr: float = 0.05, momentum: float = 0.9, fuse: bool = True,
                device=None, mesh: str | None = None, shard: str = "1d",
                metrics: str | None = None, trace: str | None = None,
                chaos: str | None = None, chaos_ckpt: str | None = None) -> dict:
    """Train the paper CNN for ``steps`` steps; print the per-step losses.

    ``n_clusters`` sizes the program's TCDM budget and the timing model.
    ``mesh="RxC"`` shards the step program across a mesh of HMCs
    (``shard`` "1d" or "2d") and trains the sharded program on the route
    :func:`~repro_torch.lower.executors.mesh_route` names, printing the
    modeled mesh step. ``metrics`` streams one JSONL record per step;
    ``trace`` writes the merged chrome trace (host lowering / dispatch
    spans, the step program's modeled cluster exec / DMA lanes — with a
    mesh the lead cube's and the link lanes — flow events). Returns the
    :func:`~repro_torch.lower.graph.train_graph` result dict plus the plan
    cache (``"cache"``) and, with a mesh, the
    :class:`~repro_torch.lower.mesh.ShardedTrainStep` (``"sharded"``), its
    route (``"route"``) and modeled timing (``"mesh_timing"``).

    ``chaos`` injects faults (:class:`~repro_torch.runtime.faults.ChaosSchedule`
    grammar, e.g. ``"kill:hmc=1@step=2"``) through a
    :class:`~repro_torch.runtime.faults.ChaosController`: a killed cube's
    step is discarded, the program re-shards onto the survivors and the step
    replays (the executor's route may change with it), a preemption rewinds
    to the latest checkpoint in ``chaos_ckpt`` (default
    ``artifacts/ntx_chaos_ckpt``, which the controller owns and wipes at the
    start). Any chaos run, ``"none"`` included, takes step-keyed batches
    (``batch_fn(i)`` depends on ``i`` alone), so a replayed step sees the
    same images. The result then also holds the controller's report
    (``"chaos"``), the controller (``"controller"``) and the discarded steps'
    walls (``"discarded"``).
    """
    dev = resolve_device(device)
    registry = obs.CounterRegistry() if (metrics or trace) else None
    collector = obs.TraceCollector() if trace else None
    reg_ctx = obs.use_registry(registry) if registry is not None else contextlib.nullcontext()
    col_ctx = obs.use_collector(collector) if collector is not None else contextlib.nullcontext()
    with reg_ctx, col_ctx:
        graph = paper_cnn_graph(batch=batch, img=img, lr=lr, momentum=momentum)
        n_params = sum(int(np.prod(s)) for s in graph.param_shapes().values())
        print(f"ntx train-step graph: {graph.name}, {len(graph.nodes)} nodes, "
              f"{n_params} parameters, batch {batch}, img {img}, device {dev}")
        program = lower_training_step(graph, n_clusters=n_clusters)
        print(f"ntx train-step program: {len(program.blocks)} blocks, "
              f"{program.n_commands} commands, "
              f"peak TCDM {program.meta['peak_tcdm_bytes']} / "
              f"{program.meta['tcdm_budget_bytes']} B "
              f"({len(program.meta['spilled'])} spilled)")
        mesh_res = {}
        if mesh is not None:
            mesh_res = _shard(graph, program, mesh, shard, n_clusters, "images")
            program = mesh_res["sharded"].program
        chaos_ctl = None
        if chaos is not None:
            from repro_torch.runtime.faults import ChaosController

            # chaos runs need replayable data: key every batch on the step
            # alone so a replayed step sees bit-identical images
            def batch_fn(i):
                rng = np.random.RandomState(10_000 + i)
                return frequency_band_batches(rng, batch, img, graph.loss.classes)(i)

            chaos_ctl = ChaosController(
                chaos, sharded=mesh_res.get("sharded"),
                ckpt_dir=chaos_ckpt or "artifacts/ntx_chaos_ckpt", n_clusters=n_clusters)
            print(f"chaos: {chaos!r} (ckpt dir {chaos_ctl.ckpt_dir}, retries "
                  f"{chaos_ctl.retry.max_retries} @ backoff {chaos_ctl.retry.delays()})")
        else:
            batch_fn = frequency_band_batches(np.random.RandomState(0), batch, img,
                                              graph.loss.classes)
        cache = PlanCache()
        res = train_graph(graph, steps, batch_fn, program=program,
                          params=graph.init_params(seed=0), fuse=fuse, device=dev,
                          cache=cache, metrics_path=metrics, chaos=chaos_ctl)
        sharded = mesh_res.get("sharded")
        if chaos_ctl is not None:
            rep = res["chaos"] = chaos_ctl.report()
            res["controller"] = chaos_ctl
            if chaos_ctl.sharded is not None:
                sharded = chaos_ctl.sharded  # trace the surviving mesh
            for line in rep["events"]:
                print(f"chaos event: {line}")
            print(f"chaos report: {rep['remesh_events']} re-shard(s), "
                  f"{rep['preemptions']} preemption(s), "
                  f"{rep['straggler_events']} straggler(s), "
                  f"{rep['recovery_cycles']} modeled recovery cycles, "
                  f"{rep['alive_hmcs']} cube(s) alive at exit")
            if sharded is not None:
                print(f"chaos: executing via the {executors.mesh_route(res['program'])} "
                      f"route at exit")
        if collector is not None:
            _trace_lanes(collector, res["program"], sharded, n_clusters, trace)
    losses = res["losses"]
    for i, (loss, w) in enumerate(zip(losses, res["walls"])):
        print(f"step {i:5d} loss={loss:.4f} ({w*1e3:.0f} ms)", flush=True)
    for d in res.get("discarded", ()):
        print(f"discarded step {d['step']}: {d['wall_s']*1e3:.0f} ms run, "
              f"{d['handling_s']*1e3:.0f} ms handling the fault", flush=True)
    print(f"plan cache: {len(cache)} plans "
          f"({cache.hits} hits / {cache.misses} misses over {cache.calls} calls)")
    fusion = res["fusion"]
    if fusion is not None:
        print(f"fusion: {fusion.n_regions} regions + "
              f"{len(fusion.fallback_steps)} fallback steps per step, covering "
              f"{fusion.fused_commands} of {fusion.total_commands} program commands "
              f"({100 * fusion.coverage:.2f} %)")
    else:
        print("fusion: disabled (--no-fuse) — per-node plan dispatch")
    if metrics:
        print(f"per-step metrics JSONL: {metrics}")
    if registry is not None:
        print(obs.format_hotspots(registry))
    print(f"done: {steps} ntx steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    res["cache"] = cache
    res.update(mesh_res)
    return res


def _dag_oracle_loss(graph, p: dict, x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Any DAG NetworkGraph in plain torch, differentiable by autograd — the
    ``--check-grads`` oracle (``repro/launch/train.py::_dag_oracle_loss``)."""
    acts = {graph.input_edge: x}
    for node in graph.nodes:
        s = node.spec
        a = acts[node.in_edge]
        if isinstance(s, (MatmulSpec, EmbeddingSpec)):
            y = a @ p[node.param]
        elif isinstance(s, ReluSpec):
            y = torch.relu(a)
        elif isinstance(s, LayerNormSpec):
            mu = a.mean(dim=-1, keepdim=True)
            var = ((a - mu) ** 2).mean(dim=-1, keepdim=True)
            w = p[node.param]
            y = (a - mu) * torch.rsqrt(var + s.eps) * w[0] + w[1]
        elif isinstance(s, ResidualAddSpec):
            y = a + acts[node.aux_edges[0]]
        elif isinstance(s, PosEmbedSpec):
            y = (a.reshape(s.batch, s.seq, s.d) + p[node.param][None]).reshape(-1, s.d)
        elif isinstance(s, AttentionSpec):
            D, S = s.d, s.seq
            qkv = a.reshape(-1, S, 3 * D)

            def heads(m, s=s, S=S):
                return m.reshape(m.shape[0], S, s.n_heads, s.head_dim).transpose(1, 2)

            q, k, v = (heads(qkv[..., i * D:(i + 1) * D]) for i in range(3))
            sc = torch.einsum("bhid,bhjd->bhij", q, k) * s.scale
            keep = torch.tril(torch.ones((S, S), dtype=a.dtype, device=a.device)) > 0
            mask = torch.where(keep, 0.0, -1e9).to(a.dtype)
            pr = torch.softmax(sc + mask, dim=-1)
            ctx = torch.einsum("bhij,bhjd->bhid", pr, v)
            y = ctx.transpose(1, 2).reshape(-1, D)
        else:
            raise TypeError(f"no oracle rule for {type(s).__name__}")
        acts[node.out_edge] = y
    z = acts[graph.logits_edge]
    return -torch.mean(torch.sum(torch.log_softmax(z, dim=-1) * onehot, dim=1))


def check_lm_grads(graph, program, x, labels, *, fuse: bool = True, device=None,
                   cache=None) -> float:
    """One step of ``program`` on the torch executor at the initial
    parameters, every ``d_<p>`` against ``torch.autograd.grad`` of
    :func:`_dag_oracle_loss` (TF32 off) at ``rtol=1e-4, atol=1e-5``; raises
    SystemExit naming the first parameter outside. Returns the worst
    max |got - want| / max |want| over the parameters."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        strict_fp32()
    onehot = one_hot_rows(labels, graph.loss.classes)
    params = graph.init_params(seed=0)
    inputs = {graph.input_edge: x, graph.label_edge: onehot, **params}
    outs = run_torch(program, inputs, fuse=fuse, device=dev, cache=cache)
    tp = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in params.items()}
    loss = _dag_oracle_loss(graph, tp, torch.as_tensor(x, device=dev),
                            torch.as_tensor(onehot, device=dev))
    names = list(graph.param_shapes())
    grads = torch.autograd.grad(loss, [tp[p] for p in names])
    worst = 0.0
    for p, want in zip(names, grads):
        got = outs[f"d_{p}"].detach().double()
        want = want.detach().double()
        rel = float((got - want).abs().max() / (want.abs().max() + 1e-12))
        worst = max(worst, rel)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            raise SystemExit(f"gradient check FAILED for {p}: rel err {rel:.2e}")
    return worst


def run_ntx_lm(model: str, steps: int, batch: int, seq: int, *, n_clusters: int = 16,
               lr: float = 0.05, reduced: bool = True, mesh: str | None = None,
               shard: str = "1d", fuse: bool = True, device=None,
               metrics: str | None = None, trace: str | None = None,
               check_grads: bool = False) -> dict:
    """Train a decoder-only transformer, every step one compiled NtxProgram.

    The named config of :mod:`repro_torch.configs` (reduced to smoke scale
    with ``reduced``, the default; the full config otherwise) is built into
    a DAG training graph by :meth:`NetworkGraph.from_model_config` —
    embedding, learned positions, pre-LN attention + FFN blocks with
    residual fan-out, final norm, head — and trained on the synthetic
    next-token task of :func:`~repro_torch.lower.lm_token_batches` through
    the torch executor: the matmuls and the embedding on the streaming
    matmul kernel, the SGD updates of the matmul weights as update-only
    regions on the fused-region kernel, the rest plain. The block-engine
    timing run prints the step's offloads, commands and NTX cycles.

    ``check_grads`` then runs one step at the initial parameters and holds
    every ``d_<param>`` against ``torch.autograd`` of a plain oracle
    (:func:`check_lm_grads`). ``mesh="RxC"`` (``shard`` "1d" or "2d")
    shards the step program across a mesh of HMCs, as :func:`run_ntx_cnn`
    does. Returns the :func:`~repro_torch.lower.train_graph` result plus the
    plan cache (``"cache"``), the block-engine result (``"timing"``), with a
    mesh ``"sharded"``, ``"route"`` and ``"mesh_timing"``, and, with
    ``check_grads``, the worst relative gradient error (``"grad_err"``).
    """
    from repro_torch.configs import get_config, reduce_config

    dev = resolve_device(device)
    cfg = get_config(model)
    if reduced:
        cfg = reduce_config(cfg)
    else:
        print(f"note: lowering the FULL {cfg.name} config — expect a very large program; "
              f"--reduced is the smoke-scale path")
    registry = obs.CounterRegistry() if (metrics or trace) else None
    collector = obs.TraceCollector() if trace else None
    reg_ctx = obs.use_registry(registry) if registry is not None else contextlib.nullcontext()
    col_ctx = obs.use_collector(collector) if collector is not None else contextlib.nullcontext()
    with reg_ctx, col_ctx:
        graph = NetworkGraph.from_model_config(cfg, batch=batch, seq=seq, lr=lr)
        n_params = sum(int(np.prod(s)) for s in graph.param_shapes().values())
        print(f"ntx LM train-step graph: {graph.name}, {len(graph.nodes)} nodes, {n_params} "
              f"parameters, batch {batch}, seq {seq}, device {dev}")
        program = lower_training_step(graph, n_clusters=n_clusters)
        print(f"ntx LM train-step program ({graph.name}): {len(graph.nodes)} nodes -> "
              f"{len(program.blocks)} blocks, {program.n_commands} commands, "
              f"peak TCDM {program.meta['peak_tcdm_bytes']} / "
              f"{program.meta['tcdm_budget_bytes']} B "
              f"({len(program.meta['spilled'])} spilled)")
        with obs.use_registry(None):
            timed = run_timing(program, n_clusters=n_clusters, engine="block")
        print(f"timing engine: {program.n_offloads} offloads, {program.n_commands} commands, "
              f"{timed.total_cycles} cycles/step on {n_clusters} clusters (NTX cycle model)")
        mesh_res = {}
        if mesh is not None:
            mesh_res = _shard(graph, program, mesh, shard, n_clusters, "sequences")
            program = mesh_res["sharded"].program
        batch_fn = lm_token_batches(np.random.RandomState(0), batch, seq, cfg.vocab_size)
        cache = PlanCache()
        res = train_graph(graph, steps, batch_fn, program=program,
                          params=graph.init_params(seed=0), fuse=fuse, device=dev,
                          cache=cache, metrics_path=metrics)
        if collector is not None:
            _trace_lanes(collector, program, mesh_res.get("sharded"), n_clusters, trace)
    losses = res["losses"]
    for i, (loss, w) in enumerate(zip(losses, res["walls"])):
        print(f"step {i:5d} loss={loss:.4f} ({w*1e3:.0f} ms)", flush=True)
    print(f"plan cache: {len(cache)} plans "
          f"({cache.hits} hits / {cache.misses} misses over {cache.calls} calls)")
    fusion = res["fusion"]
    if fusion is not None:
        print(f"fusion: {fusion.n_regions} regions + "
              f"{len(fusion.fallback_steps)} fallback steps per step, covering "
              f"{fusion.fused_commands} of {fusion.total_commands} program commands "
              f"({100 * fusion.coverage:.2f} %) — token-row graphs fuse update "
              f"epilogues only")
    else:
        print("fusion: disabled (--no-fuse) — per-node plan dispatch")
    if check_grads:
        # the next draw of the run's token stream, as the JAX package's run_ntx_lm takes it
        x, labels = batch_fn(0)
        worst = check_lm_grads(graph, res["program"], x, labels, fuse=fuse, device=dev,
                               cache=cache)
        res["grad_err"] = worst
        print(f"gradient check vs torch.autograd: {len(graph.param_shapes())} params OK "
              f"(worst rel err {worst:.2e})")
    if metrics:
        print(f"per-step metrics JSONL: {metrics}")
    if registry is not None:
        print(obs.format_hotspots(registry))
    print(f"done: {steps} LM ntx steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    res["cache"] = cache
    res["timing"] = timed
    res.update(mesh_res)
    return res


# ---------------------------------------------------------------------------
# The model-zoo trainer (``--backend xla``): ``repro/launch/train.py``'s
# train-step factory, offload report and CLI route. The step runs the
# blockwise attention and chunked SSD routes (``ParallelCtx(attn_backend=
# "xla")``) and autograd; no hand-written kernel is on this path.
# ---------------------------------------------------------------------------


def init_train_state(seed: int, cfg, optimizer, grad_sync: str = "auto", mesh=None,
                     dp_axes: tuple[str, ...] = (), device=None) -> dict:
    """``{"params", "opt", "step"}`` (plus ``"err"`` for ``grad_sync="compressed"``).

    Parameters are :func:`~repro_torch.models.lm.init_lm`'s, drawn from
    ``seed`` on ``device`` (CUDA unless ``"cpu"``), as a pytree
    (:func:`~repro_torch.models.blocks.param_pytree`); ``step`` is an int32
    tensor.
    """
    params = param_pytree(lm.init_lm(cfg, seed=seed, device=device))
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if grad_sync == "compressed":
        dp = math.prod(mesh.shape[a] for a in dp_axes) if mesh is not None and dp_axes else 1
        state["err"] = tree_map(
            lambda p: torch.zeros((dp,) + tuple(p.shape), dtype=torch.float32, device=p.device),
            params)
    return state


def _value_and_grad(params, batch, cfg, ctx):
    """(grads in the parameters' dtypes, metrics) of ``lm_loss`` by autograd;
    a parameter the loss does not reach gets zeros."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(p)
    loss, metrics = lm.lm_loss(p, batch, cfg, ctx)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g) for t, g in zip(leaves, got)}
    grads = tree_map(lambda t: by_id[id(t)], p)
    return grads, {k: v.detach() for k, v in metrics.items()}


def _grads_and_metrics(params, batch, cfg, ctx, num_microbatches: int):
    """Gradients and the loss metrics of one batch.

    With ``num_microbatches`` > 1 the batch is split along its first axis;
    the microbatches' gradients are summed in fp32, divided by their number
    and cast to the parameter dtype; the metrics are the last
    microbatch's, as in the JAX scan.
    """
    if num_microbatches <= 1:
        return _value_and_grad(params, batch, cfg, ctx)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                   params)

    def mb_slice(x, i):
        mb = x.shape[0] // num_microbatches
        return x[i * mb:(i + 1) * mb]

    metrics = None
    for i in range(num_microbatches):
        g, metrics = _value_and_grad(params, {k: mb_slice(v, i) for k, v in batch.items()},
                                     cfg, ctx)
        acc = tree_map(lambda a, b: a + b.float(), acc, g)
    grads = tree_map(lambda g, p: (g / num_microbatches).to(p.dtype), acc, params)
    return grads, metrics


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(device) for k, v in batch.items()}


def make_train_step(cfg, ctx, optimizer, *, grad_sync: str = "auto",
                    num_microbatches: int = 1, clip_norm: float | None = 1.0):
    """``train_step(state, batch) -> (new_state, metrics)``: gradients by
    autograd, clipping by global norm (``grad_norm`` in the metrics), the
    optimizer update, ``step + 1``. The state's tensors are not changed in
    place.

    This is the JAX factory's one-device branch, which it takes for every
    ``grad_sync`` when there is no mesh. A mesh with data-parallel axes
    (the systolic and compressed gradient exchange) is refused.
    """
    mesh, dp_axes = ctx.mesh, ctx.dp_axes
    if not (grad_sync == "auto" or mesh is None or not dp_axes):
        raise NotImplementedError(
            f"grad_sync={grad_sync!r} on a mesh with data-parallel axes {dp_axes} "
            "(core/systolic.py, optim/compression.py) is not ported yet (ROADMAP A6b)"
        )

    def train_step(state, batch):
        params = state["params"]
        batch = batch_to(batch, tree_leaves(params)[0].device)
        grads, metrics = _grads_and_metrics(params, batch, cfg, ctx, num_microbatches)
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            metrics = dict(metrics, grad_norm=gnorm)
        updates, opt = optimizer.update(grads, state["opt"], params)
        new_state = dict(state, params=apply_updates(params, updates), opt=opt,
                         step=state["step"] + 1)
        return new_state, metrics

    return train_step


def offload_step_report(cfg, seq: int, batch: int, *, n_clusters: int = 16,
                        queue_depth: int = 4, f_ntx: float = 1.5e9) -> dict:
    """Map one training step onto the NTX offload runtime (modeled; host
    arithmetic, ``repro/launch/train.py::offload_step_report``).

    MACs come from the analytic flop counts, DMA bytes from the HBM-traffic
    model at fp32 stream width; the cycle estimate runs the double-buffered
    runtime of :mod:`repro_torch.runtime.scheduler`. The per-layer block
    lowers the step's GEMMs through :func:`~repro_torch.lower.lower_layer` —
    forward plus both training passes (dW, dX) — and times them on the NTX
    and NS designs; the queue-level block maps the dominant forward GEMM
    onto per-cluster command streams, queued against synchronous offload.
    """
    from repro_torch.lower import NS_DESIGN, lower_layer
    from repro_torch.models import flops
    from repro_torch.runtime import scheduler as rt_sched

    macs = flops.train_step_flops(cfg, seq, batch) / 2.0
    dma_bytes = flops.train_hbm_bytes_per_chip(cfg, seq, batch, tp=1, dp=1, dtype_bytes=4)
    est = rt_sched.simulate_workload(macs, dma_bytes, n_clusters=n_clusters, f_ntx=f_ntx)

    tokens = seq * batch
    d_ff = cfg.d_ff or getattr(cfg, "moe_d_ff", 0) or 4 * cfg.d_model
    layer_specs = {
        "attn_qkvo": MatmulSpec(tokens, 4 * cfg.d_model, cfg.d_model),
        "ffn_in": MatmulSpec(tokens, d_ff, cfg.d_model),
        "ffn_out": MatmulSpec(tokens, cfg.d_model, d_ff),
    }
    layers = {}
    layer_progs = {}
    for lname, spec in layer_specs.items():
        progs = layer_progs[lname] = lower_layer(spec)
        # the NS design re-issues one command per output element, which only
        # the block engine can time; split the coarse NTX programs over the
        # clusters first (§3.1)
        timed = {}
        for design, prs in (("ntx", progs), ("ns", lower_layer(spec, design=NS_DESIGN))):
            total = 0
            for pr in prs.values():
                want = n_clusters * rt_sched.ENGINES_PER_CLUSTER * queue_depth
                if pr.n_commands < want:
                    pr = rt_sched.partition_program(pr, -(-want // pr.n_commands))
                total += run_timing(pr, n_clusters=n_clusters, f_ntx=f_ntx,
                                    engine="block").total_cycles
            timed[design] = total
        layers[lname] = {
            "offloads": {p: pr.n_offloads for p, pr in progs.items()},
            "busy_cycles": {p: pr.busy_cycles for p, pr in progs.items()},
            "fwd_bwd_offloads": sum(pr.n_offloads for pr in progs.values()),
            "fwd_bwd_cycles_timed": timed["ntx"],
            "fwd_bwd_cycles_timed_ns": timed["ns"],
            "ns_over_ntx_cycles": timed["ns"] / max(timed["ntx"], 1),
        }

    # queue-level view of the dominant GEMM: (tokens x d_ff x d_model)
    gemm = layer_progs["ffn_in"]["fwd"].blocks[0].template
    parts = rt_sched.partition_command(
        gemm, n_clusters * rt_sched.ENGINES_PER_CLUSTER * queue_depth)
    tile_bytes = [(p.loops[2] * p.loops[0] + p.loops[0] * p.loops[1]) * 4 for p in parts]
    sched = rt_sched.MultiClusterScheduler(
        n_clusters=n_clusters, cluster=rt_sched.ClusterConfig(queue_depth=queue_depth),
        f_ntx=f_ntx)
    queued = sched.schedule(parts, bytes_per_command=tile_bytes)
    sync_sched = rt_sched.MultiClusterScheduler(
        n_clusters=n_clusters, cluster=rt_sched.ClusterConfig(sync=True), f_ntx=f_ntx)
    synced = sync_sched.schedule(parts, bytes_per_command=tile_bytes)
    return {
        "macs_per_step": macs,
        "dma_bytes_per_step": dma_bytes,
        "cycles_per_step": est.cycles,
        "step_time_s": est.time,
        "overlap_efficiency": est.overlap_efficiency,
        "layers": layers,
        "gemm_offloads": queued.summary()["n_commands"],
        "gemm_cycles_queued": queued.total_cycles,
        "gemm_cycles_sync": synced.total_cycles,
        "gemm_queued_speedup": synced.total_cycles / max(queued.total_cycles, 1),
        "gemm_utilization": queued.utilization,
    }


# -- the first-step gate: step 0 against the same step in fp64 ---------------

#: the first-step gate's limits: the bf16 step against the same step in
#: fp64. ``p10_leaf_rel_rms`` is the tenth percentile of the leaves'
#: relative RMS, over the leaves of at least ``P10_MIN_NUMEL`` elements: a
#: gradient rounded to 3 mantissa bits (:func:`fp8_rounded`) reads about
#: 0.026 in every such leaf, while the bf16 step's error varies from leaf
#: to leaf. The reduced configs read, in bf16 on the CPU
#: (tests/test_torch_train_lm.py; Qwen / Mamba-2): ce 5.2e-5 / 1.2e-5, grad
#: norm 5.4e-5 / 3.7e-4, worst leaf 0.019 / 0.036 and p10 0.0130 / 0.0117;
#: the control's p10 reads 0.0258 / 0.0256. The limits keep a margin of
#: 1.9x-8.4x, 27x-186x, 2.8x-5.2x and 1.54x-1.71x over the bf16 readings,
#: and the p10 limit sits 1.28x under the control's smaller reading.
FIRST_STEP_LIMITS = {"ce_rel": 1e-4, "grad_norm_rel": 1e-2, "leaf_rel_rms": 0.1,
                     "p10_leaf_rel_rms": 0.02}
P10_MIN_NUMEL = 1024

#: The leaf readings grow with depth, in JAX's bf16 step as in the port's:
#: Mamba-2 780M at its ``reduce_config`` widths cut to 48 layers (batch 8,
#: seq 64, ssd_chunk 16, on the CPU) reads against fp64 a p10 leaf of
#: 0.3211 and a worst leaf of 1.5195 in JAX (0.0119 and 0.0686 at 2
#: layers), 0.3266 and 1.5984 in the port. Past that depth bf16 rounding,
#: not a fault, sets the leaf readings, so a 48-layer bf16 step holds its
#: leaves to JAX's own readings at 48 layers times ``DEPTH_FACTOR``, the
#: band that tests/test_torch_train_lm.py holds the port's readings to
#: around JAX's at a given depth. ce and the gradient norm keep
#: ``FIRST_STEP_LIMITS``. The control such a gate must reject is the step
#: computed in fp64 from weights rounded through :func:`fp8_rounded`
#: (``weights_control``): a gradient rounded once at the end, as
#: ``control`` does, reads about 0.026 at any depth.
DEPTH_FACTOR = 1.25
JAX_BF16_48_LAYERS = {"leaf_rel_rms": 1.5195, "p10_leaf_rel_rms": 0.3211}
DEPTH_48_LIMITS = dict(FIRST_STEP_LIMITS,
                       **{k: DEPTH_FACTOR * v for k, v in JAX_BF16_48_LAYERS.items()})


def fp8_rounded(g: torch.Tensor) -> torch.Tensor:
    """The first-step gate's control: ``g`` rounded through float8 e4m3 at a
    per-tensor scale (max|g| to 448, the format's largest value) and back:
    a gradient that carries 3 mantissa bits."""
    amax = g.abs().max()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (g * scale).to(torch.float8_e4m3fn).to(g.dtype) / scale


def leaf_rel_rms(got: dict, want: dict) -> dict:
    """Per leaf of two params-shaped pytrees, ``||got - want|| / ||want||``
    in fp64, keyed by the leaf's name; leaves where ``want`` is zero are
    skipped."""
    out = {}
    for (n, w), g in zip(tree_items(want), tree_leaves(got)):
        den = float(torch.linalg.vector_norm(w.double()))
        if den > 0:
            out[n] = float(torch.linalg.vector_norm(g.double() - w.double())) / den
    return out


def leaf_readings(grads: dict, g64: dict) -> dict:
    """Per leaf the relative RMS of ``grads`` against ``g64``
    (:func:`leaf_rel_rms`), its worst leaf and its tenth percentile over
    the leaves of at least ``P10_MIN_NUMEL`` elements."""
    leaf = leaf_rel_rms(grads, g64)
    numel = {n: w.numel() for n, w in tree_items(g64)}
    big = sorted(v for n, v in leaf.items() if numel[n] >= P10_MIN_NUMEL)
    worst = max(leaf, key=leaf.get)
    return {"leaf_rel_rms": leaf[worst], "worst_leaf": worst,
            "p10_leaf_rel_rms": big[int(0.1 * (len(big) - 1))], "leaves": leaf}


def first_step_readings(cfg, params, batch, ctx, *, control=None,
                        weights_control=None) -> dict:
    """Step 0's ``ce``, global gradient norm and every gradient leaf against
    the same step computed in fp64 from the same parameters (cast exactly)
    and batch: relative errors of ``ce`` and the norm and
    :func:`leaf_readings`. Controls the gate must reject, when given:
    ``control(g64)`` replaces the step's gradients by a function of the
    fp64 ones; ``weights_control(p)`` replaces the step by the fp64 step
    from a function of each fp64 parameter. Returns the readings and the
    worst leaf's name."""
    batch = batch_to(batch, tree_leaves(params)[0].device)
    p64 = tree_map(lambda p: p.double(), params)
    cfg64 = cfg.with_(dtype=torch.float64)
    g64, m64 = _grads_and_metrics(p64, batch, cfg64, ctx, 1)
    if weights_control is not None:
        grads, metrics = _grads_and_metrics(tree_map(weights_control, p64), batch, cfg64, ctx, 1)
    else:
        grads, metrics = _grads_and_metrics(params, batch, cfg, ctx, 1)
    if control is not None:
        grads = tree_map(control, g64)
    gn, gn64 = float(global_norm(grads)), float(global_norm(g64))
    return {"ce": float(metrics["ce"]), "ce64": float(m64["ce"]),
            "ce_rel": abs(float(metrics["ce"]) - float(m64["ce"])) / abs(float(m64["ce"])),
            "grad_norm": gn, "grad_norm64": gn64, "grad_norm_rel": abs(gn - gn64) / gn64,
            **leaf_readings(grads, g64)}


def first_step_passes(readings: dict, limits: dict = FIRST_STEP_LIMITS) -> bool:
    return all(readings[k] <= lim for k, lim in limits.items())


def state_diff(a: dict, b: dict) -> dict:
    """How two :func:`run_xla_lm` results' final states differ: the number
    of parameter and optimizer-state leaves that are not bit-identical (a
    dtype or shape differing counts), whether the step counters differ, and
    whether the data iterators' states differ."""
    def leaves_off(x, y) -> int:
        lx, ly = tree_leaves(x), tree_leaves(y)
        if len(lx) != len(ly):
            return max(len(lx), len(ly))
        return sum(not (u.dtype == v.dtype and u.shape == v.shape and torch.equal(u, v))
                   for u, v in zip(lx, ly))

    sa, sb = a["state"], b["state"]
    return {"params": leaves_off(sa["params"], sb["params"]),
            "opt": leaves_off(sa["opt"], sb["opt"]),
            "step": int(not torch.equal(sa["step"], sb["step"])),
            "iterator": int(a["iterator"].state_dict() != b["iterator"].state_dict())}


def run_xla_lm(arch: str = "qwen1_5_0_5b", steps: int = 50, batch: int = 8, seq: int = 64, *,
               reduced: bool = False, optimizer: str = "adamw", lr: float = 3e-3,
               grad_sync: str = "auto", microbatches: int = 1,
               ckpt_dir: str = "artifacts/train_cli_ckpt", ckpt_every: int = 25,
               crash_at: int | None = None, offload_report: bool = False,
               offload_clusters: int = 16, queue_depth: int = 4,
               metrics: str | None = None, device=None, iterator=None) -> dict:
    """The JAX CLI's ``--backend xla`` run: train a model-zoo LM under the
    :class:`~repro_torch.runtime.supervisor.Supervisor`.

    The config of :mod:`repro_torch.configs` (``reduced`` for the
    smoke-scale one), ``ParallelCtx(attn_backend="xla")``, the named
    optimizer, the synthetic corpus of 2,000,000 tokens (seed 0) and a
    :class:`~repro_torch.data.pipeline.DataIterator` (seed 0; ``iterator``
    replaces it) feed ``steps`` steps of :func:`make_train_step`,
    checkpointed to ``ckpt_dir`` every ``ckpt_every`` steps; ``crash_at``
    injects one crash before that step (restored from the latest
    checkpoint). Prints what the JAX CLI prints. Returns the report, the
    final state and iterator, each step's metrics and host wall seconds,
    and the offload report when asked for.
    """
    import time

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import DataIterator, InMemoryDataset
    from repro_torch.models.config import ParallelCtx
    from repro_torch.runtime.supervisor import FailureInjector, Supervisor

    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg)
    if cfg.input_mode == "embeddings":
        raise SystemExit("CLI driver trains token-input archs; use examples/ for stubs")
    ctx = ParallelCtx(attn_backend="xla")
    opt = get_optimizer(optimizer, lr)
    if iterator is None:
        ds = InMemoryDataset.synthetic(2_000_000, cfg.vocab_size, seq, seed=0)
        iterator = DataIterator(ds, batch_size=batch, seed=0)

    res: dict = {"metrics": [], "walls": [], "state": None}

    def init_state(_mesh):
        return init_train_state(0, cfg, opt, grad_sync, device=dev)

    def make_step(_mesh):
        step = make_train_step(cfg, ctx, opt, grad_sync=grad_sync,
                               num_microbatches=microbatches)

        def run(state, batch_):
            t = time.perf_counter()
            state, m = step(state, batch_)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            res["walls"].append(time.perf_counter() - t)
            res["metrics"].append(m)
            res["state"] = state
            return state, m

        return run

    offload = None
    if offload_report:
        offload = offload_step_report(cfg, seq, batch, n_clusters=offload_clusters,
                                      queue_depth=queue_depth)
        print("offload step accounting (modeled NTX runtime):")
        for key, v in offload.items():
            if key == "layers":
                print("  per-layer fwd+bwd offloads (lowered programs):")
                for lname, info in v.items():
                    offs = info["offloads"]
                    print(f"    {lname}: fwd={offs['fwd']} dw={offs['dw']} "
                          f"dx={offs['dx']} total={info['fwd_bwd_offloads']} "
                          f"timed_cycles={info['fwd_bwd_cycles_timed']} "
                          f"ns/ntx={info['ns_over_ntx_cycles']:.2f}x")
            else:
                print(f"  {key}: {v:.4g}" if isinstance(v, float) else f"  {key}: {v}")

    injector = FailureInjector({crash_at: "crash"} if crash_at else {})
    t0 = time.time()

    def cb(step, m):
        if step % 10 == 0:
            print(f"step {step:5d} ce={float(m['ce']):.4f} ({time.time() - t0:.0f}s)",
                  flush=True)

    registry = obs.CounterRegistry() if metrics else None
    sup = Supervisor(make_step, init_state, iterator, ckpt_dir, ckpt_every=ckpt_every,
                     injector=injector, registry=registry, metrics_path=metrics)
    report = sup.run(steps, metrics_cb=cb)
    print(f"done: {report.steps_run} steps, {report.restarts} restarts")
    if metrics:
        print(f"per-step metrics JSONL: {metrics}")
    if offload is not None and report.steps_run:
        measured = (time.time() - t0) / report.steps_run
        print(f"offload model: {offload['step_time_s']*1e3:.2f} ms/step modeled "
              f"on {offload_clusters} clusters vs {measured*1e3:.2f} ms/step "
              f"measured on {dev.type}")
    res.update(report=report, iterator=iterator, offload=offload, cfg=cfg, ctx=ctx)
    return res


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="ntx", choices=["ntx", "xla"],
                    help="ntx (the default): train the paper's small CNN — or, with "
                         "--model, a decoder-only transformer — through the torch "
                         "executor; xla: train the model-zoo LM named by --arch under "
                         "the supervisor (the JAX CLI's default route: blockwise "
                         "attention and SSD, autograd)")
    ap.add_argument("--arch", default="qwen1_5_0_5b", help="xla: the model-zoo config")
    ap.add_argument("--optimizer", default="adamw", choices=["sgd", "adamw"],
                    help="xla: the optimizer")
    ap.add_argument("--grad-sync", default="auto", choices=["auto", "systolic", "compressed"],
                    help="xla: gradient exchange; on one device every value takes the "
                         "one-device step, as in the JAX CLI")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="xla: gradient accumulation over this many microbatches")
    ap.add_argument("--ckpt-dir", default="artifacts/train_cli_ckpt",
                    help="xla: the supervisor's checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=25, help="xla: checkpoint cadence")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="xla: inject one crash before this step (restored from the "
                         "latest checkpoint)")
    ap.add_argument("--offload-report", action="store_true",
                    help="xla: print the modeled NTX offload accounting for one train "
                         "step and compare it with the measured step time at the end")
    ap.add_argument("--offload-clusters", type=int, default=16,
                    help="xla: clusters of the offload report")
    ap.add_argument("--queue-depth", type=int, default=4,
                    help="xla: command-queue depth of the offload report")
    ap.add_argument("--model", default=None, metavar="ARCH",
                    help="instead of the CNN, train a decoder-only transformer built "
                         "from this config (e.g. qwen1_5_0_5b) by "
                         "NetworkGraph.from_model_config; the full config unless "
                         "--reduced")
    ap.add_argument("--reduced", action="store_true",
                    help="--model and xla: the smoke-scale config")
    ap.add_argument("--seq", type=int, default=64, help="--model and xla: sequence length")
    ap.add_argument("--lr", type=float, default=LM_LR,
                    help="--model: SGD learning rate; xla: the optimizer's (the CNN "
                         "keeps its own 0.05)")
    ap.add_argument("--check-grads", action="store_true",
                    help="--model: after training, run one step and hold every "
                         "parameter gradient against torch.autograd of a plain "
                         "graph oracle at rtol 1e-4 / atol 1e-5")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="shard the train step across an RxC mesh of HMCs (batch "
                         "must divide evenly); prints the route the executor takes "
                         "and the modeled mesh timing")
    ap.add_argument("--shard", default="1d", choices=["1d", "2d"],
                    help="mesh sharding layout. 1d: pure data parallelism (every "
                         "cube runs the whole model on a batch slice). 2d: mesh "
                         "rows are GPipe-style pipeline stages with explicit "
                         "send/recv link traffic, columns tensor/data-shard each "
                         "stage")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="CNN only: inject faults — 'kill:hmc=1@step=2', "
                         "'straggle:hmc=0,slow=4@step=3', 'preempt@step=5' (join with "
                         "';'), or 'random:seed=7,p_kill=0.02'. A killed cube's step is "
                         "discarded, the program re-shards onto the survivors and the "
                         "step replays; a preemption rewinds to the latest checkpoint. "
                         "'none' takes the (step-keyed) chaos data path without faults: "
                         "the healthy baseline for chaos diffs")
    ap.add_argument("--chaos-ckpt", default=None, metavar="DIR",
                    help="checkpoint dir the chaos controller owns (wiped at start; "
                         "default artifacts/ntx_chaos_ckpt)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img", type=int, default=16, help="CNN input image size")
    ap.add_argument("--n-clusters", type=int, default=16,
                    help="HMC clusters: the program's TCDM budget and the timing model")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the region fuser and run per-node plans")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a GPU; cpu runs the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--metrics", default=None, metavar="OUT.jsonl",
                    help="write one JSON record per step (loss, wall, counters; both "
                         "backends)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the merged chrome trace (host spans, modeled "
                         "cluster lanes)")
    args = ap.parse_args(argv)
    if args.backend == "xla":
        return run_xla_lm(args.arch, args.steps, args.batch, args.seq, reduced=args.reduced,
                          optimizer=args.optimizer, lr=args.lr, grad_sync=args.grad_sync,
                          microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every, crash_at=args.crash_at,
                          offload_report=args.offload_report,
                          offload_clusters=args.offload_clusters,
                          queue_depth=args.queue_depth, metrics=args.metrics,
                          device=args.device)
    if args.model is not None and args.chaos is not None:
        raise SystemExit("--chaos is CNN-path only, as in the JAX CLI (ROADMAP A6c "
                         "ported the CNN run's faults); drop it or drop --model")
    validate_mesh_args(args.mesh, args.shard, args.batch)
    if args.model is not None:
        res = run_ntx_lm(args.model, args.steps, args.batch, args.seq,
                         n_clusters=args.n_clusters, lr=args.lr, reduced=args.reduced,
                         mesh=args.mesh, shard=args.shard, fuse=not args.no_fuse,
                         device=args.device, metrics=args.metrics, trace=args.trace,
                         check_grads=args.check_grads)
        if len(res["losses"]) >= 3 and not res["losses"][-1] < res["losses"][0]:
            raise SystemExit("ntx LM training did not decrease the loss")
        return
    res = run_ntx_cnn(args.steps, args.batch, args.img, n_clusters=args.n_clusters,
                      fuse=not args.no_fuse, device=args.device, mesh=args.mesh,
                      shard=args.shard, metrics=args.metrics, trace=args.trace,
                      chaos=args.chaos, chaos_ckpt=args.chaos_ckpt)
    if len(res["losses"]) >= 3 and not res["losses"][-1] < res["losses"][0]:
        raise SystemExit("ntx CNN training did not decrease the loss")


if __name__ == "__main__":
    _cli()
