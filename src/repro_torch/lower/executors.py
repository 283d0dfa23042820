"""The executors of one whole training step.

Counterpart of ``repro/lower/executors.py``'s ``run_reference``,
``run_timing`` and of its graph route (``_run_pallas_graph``,
``_graph_step_local``, ``_walk_fused``, ``PlanCache``).

:func:`run_reference` executes a lowered
:class:`~repro_torch.lower.ir.NtxProgram` command by command on a flat fp32
TCDM: on the card through the command kernel
(:mod:`repro_torch.kernels.ntx_exec`, one launch per command), on the CPU
through the plain interpreter (:func:`repro_torch.core.ntx.ntx_execute`).

:func:`run_torch` walks a :class:`~repro_torch.lower.graph.NetworkGraph` (or
the graph a program was lowered from) in the fwd -> loss grad ->
dW/update/dX schedule:

  * fused (default): the :func:`~repro_torch.lower.fuse.plan_fusion`
    segments — region kernels (:mod:`repro_torch.kernels.fused`) and
    per-node fallback steps;
  * ``fuse=False``: every step per node.

:func:`run_timing` plays a program through the NTX cycle model
(:mod:`repro_torch.runtime.scheduler`): host arithmetic, no device.

With a :class:`~repro_torch.obs.CounterRegistry` installed, every executor
books the program's closed-form counts (and :func:`run_torch` its plan-cache
and fusion counters); with a :class:`~repro_torch.obs.TraceCollector`
installed, :func:`run_torch` wraps each plan call in a host span.

Per-node conv and matmul passes, and the LM embedding's forward and dW,
run on the streaming matmul kernel (:mod:`repro_torch.kernels.streaming`).
There is no per-image vmap: conv passes put the batch straight into the
matmul M dimension, and conv dW contracts over ``B*oh*ow`` in one product
instead of summing per-image dWs; attention runs over ``(rows/S, S, 3D)``
in one batched function. Pool, relu, bias, the softmax-CE gradient, the SGD
update and the LM's attention, layernorm, residual add and positional
embedding are plain torch, as they are plain jnp in the JAX executor;
max-pool dX routes each window's gradient to its first maximal tap, as the
fused kernel does. Gradients are computed stage by stage by explicit
formulas (attention's dX recomputes the softmax from qkv); nothing here
uses autograd.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import conv_decomp
from repro_torch.core.ntx import ntx_execute
from repro_torch.kernels import fused, ntx_exec, streaming
from repro_torch.kernels.ops import resolve_device, use_kernel
from repro_torch.lower.ir import NtxProgram
from repro_torch.lower.fuse import (
    FusionPlan,
    RegionSpec,
    Segment,
    plan_fusion,
    pool_tiles,
    step_schedule,
)
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import scheduler as rt_sched
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
)


def run_reference(program: NtxProgram, inputs: dict, *, wide: bool = True,
                  vectorize: bool = True, device=None) -> dict:
    """Execute ``program`` on a flat TCDM; return its output regions.

    ``inputs`` maps region names (kind "input" / "param") to arrays or
    tensors of the region's shape. The TCDM is one fp32 tensor on the
    device: on the card every command runs on the command kernel; on the
    CPU on the plain interpreter (``vectorize`` picks its fast path).
    Scratch regions are staged by the program's own memset / copy commands.
    """
    dev = resolve_device(device)
    mem = torch.zeros(program.memory_words, dtype=torch.float32, device=dev)
    needed = {r.name for r in program.regions.values() if r.kind in ("input", "param")}
    missing = needed - set(inputs)
    if missing:
        raise ValueError(f"missing input regions: {sorted(missing)}")
    for name, arr in _as_f32(inputs, dev).items():
        r = program.region(name)
        if tuple(arr.shape) != r.shape:
            raise ValueError(f"region {name!r} expects shape {r.shape}, got {tuple(arr.shape)}")
        mem[r.base:r.end] = arr.reshape(-1)
    if use_kernel(mem):
        ntx_exec.run_program(program, mem, wide=wide)
    else:
        for cmd in program.commands():
            ntx_execute(cmd, mem, wide=wide, vectorize=vectorize, inplace=True)
    obs.record_program(obs.get_active(), program)
    return {
        r.name: mem[r.base:r.end].reshape(r.shape).clone()
        for r in program.regions_of_kind("output")
    }


def run_timing(
    program: NtxProgram,
    *,
    n_clusters: int = 1,
    cluster=None,
    f_ntx: float = 1.5e9,
    engine: str = "auto",
    exec_cycles=None,
):
    """Simulate ``program`` on the offload runtime; returns a ScheduleResult.

    The command stream and the per-command input-DMA byte counts both come
    straight from the lowered program, so the timing model sees exactly what
    :func:`run_reference` executes. ``engine`` picks the simulation strategy
    (``"auto"`` | ``"event"`` | ``"block"``): the block-replicated
    steady-state path gives cycle counts identical to the event-driven
    engine in O(blocks) time. ``exec_cycles`` optionally overrides
    per-command datapath cycles (must not depend on AGU bases on the block
    path). Cycles are the NTX model's, not a time on any chip.
    """
    sched = rt_sched.MultiClusterScheduler(
        n_clusters=n_clusters, cluster=cluster, f_ntx=f_ntx
    )
    result = sched.schedule_program(program, engine=engine, exec_cycles=exec_cycles)
    reg = obs.get_active()
    if reg is not None:
        obs.record_program(reg, program)
        obs.record_schedule(reg, result)
    return result


def _attention_probs(x: torch.Tensor, spec: AttentionSpec):
    """q, k, v as (N, H, S, Dh) and the causal softmax p (N, H, S, S) of
    qkv rows ``x`` (N, S, 3D), laid out ``[q | k | v]``: scores scaled by
    ``head_dim**-0.5`` plus the additive -1e9 mask above the diagonal."""
    n, S, H, Dh, D = x.shape[0], spec.seq, spec.n_heads, spec.head_dim, spec.d
    q, k, v = (x[..., i * D:(i + 1) * D].reshape(n, S, H, Dh).transpose(1, 2)
               for i in range(3))
    sc = torch.matmul(q, k.transpose(-1, -2)) * spec.scale
    mask = torch.full((S, S), -1e9, dtype=x.dtype, device=x.device).triu(1)
    return q, k, v, torch.softmax(sc + mask, dim=-1)


def attention_fwd(x: torch.Tensor, spec: AttentionSpec) -> torch.Tensor:
    """Causal multi-head attention of qkv rows (N, S, 3D): context (N, S, D)."""
    _, _, v, p = _attention_probs(x, spec)
    return torch.matmul(p, v).transpose(1, 2).reshape(x.shape[0], spec.seq, spec.d)


def attention_dx(x: torch.Tensor, dy: torch.Tensor, spec: AttentionSpec) -> torch.Tensor:
    """d qkv (N, S, 3D) from d context ``dy`` (N, S, D), p recomputed from
    ``x``: dv = p^T dy, dp = dy v^T, ds = p (dp - rowsum(dp p)) * scale,
    dq = ds k, dk = ds^T q."""
    n, S, H, Dh = x.shape[0], spec.seq, spec.n_heads, spec.head_dim
    q, k, v, p = _attention_probs(x, spec)
    g = dy.reshape(n, S, H, Dh).transpose(1, 2)
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * spec.scale
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([t.transpose(1, 2).reshape(n, S, spec.d) for t in (dq, dk, dv)], dim=-1)


def _layernorm_stats(x: torch.Tensor, eps: float):
    """(xhat, rstd) over the last dim, with the biased variance."""
    mu = x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True) + eps)
    return (x - mu) * rstd, rstd


def layernorm_dx(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Layernorm input gradient, ``w`` the packed (gamma, beta):
    (dy g - mean(dy g) - xhat mean(dy g xhat)) rstd."""
    xhat, rstd = _layernorm_stats(x, eps)
    dyg = dy * w[0]
    m1 = dyg.mean(dim=-1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    return (dyg - m1 - xhat * m2) * rstd


def _plan_callable(spec, pass_: str, device: torch.device):
    """The ``dict -> dict`` function of one per-node plan or one region.

    Shapes and strides come from the frozen ``spec``, so one callable serves
    every invocation of that (spec, pass).
    """
    if isinstance(spec, RegionSpec):
        return fused.build_region_callable(spec, device=device)

    if isinstance(spec, MatmulSpec):
        if pass_ == "fwd":
            return lambda j: {"c": streaming.streaming_matmul(j["a"], j["b"])}
        if pass_ == "dw":
            return lambda j: {"dw": streaming.streaming_matmul(j["a"].T, j["dy"])}
        if pass_ == "dx":
            return lambda j: {"dx": streaming.streaming_matmul(j["dy"], j["b"].T)}

    if isinstance(spec, Conv2dSpec):
        s, p = spec.stride, spec.padding
        if pass_ == "fwd":
            return lambda j: {
                "y": streaming.streaming_conv2d(j["x"], j["w"], stride=s, padding=p)
            }
        if pass_ == "dw":
            # dW = cols(x)^T @ dy over the whole batch: the (B*oh*ow)
            # output pixels are the contraction dim
            def dw(j):
                xp = streaming.pad_hw(j["x"], p, p)
                cols = streaming.im2col(xp, spec.kh, spec.kw, s, spec.out_h, spec.out_w)
                dyf = j["dy"].reshape(-1, spec.cout)
                dwf = streaming.streaming_matmul(cols.T, dyf)
                return {"dw": dwf.reshape(spec.kh, spec.kw, spec.cin, spec.cout)}

            return dw
        if pass_ == "dx":
            # the §3.2 phase decomposition, each dense phase correlation on
            # the streaming kernel
            def conv_fn(dy, w_ab, pads):
                ph, pw = pads
                return streaming.streaming_conv2d(
                    streaming.pad_hw(dy, ph, pw), w_ab, stride=1, padding=0
                )

            return lambda j: {
                "dx": conv_decomp.conv2d_input_grad_decomposed(
                    j["dy"], j["w"], s, (spec.in_h, spec.in_w), p, conv_fn=conv_fn
                )
            }

    if isinstance(spec, MaxPool2dSpec):
        # the explicit first-match mask of the fused kernel, not whatever a
        # library op picks on ties
        if not pool_tiles(spec):
            raise NotImplementedError(f"maxpool needs window == stride and exact tiling: {spec}")
        if pass_ == "fwd":
            return lambda j: {"y": fused.pool_fwd(j["x"], spec)}
        if pass_ == "dx":
            return lambda j: {"dx": fused.pool_dx(j["x"], j["dy"], spec)}

    if isinstance(spec, ReluSpec):
        if pass_ == "fwd":
            return lambda j: {"y": torch.clamp_min(j["x"], 0.0)}
        if pass_ == "dx":
            return lambda j: {"dx": torch.where(j["x"] > 0.0, j["dy"], 0.0)}

    if isinstance(spec, BiasSpec):
        if pass_ == "fwd":
            return lambda j: {"y": j["x"] + j["b"][None, :]}
        if pass_ == "dw":
            return lambda j: {"db": j["dy"].sum(dim=0)}

    if isinstance(spec, SoftmaxXentSpec) and pass_ == "dx":
        return lambda j: {"dz": fused.softmax_xent_dx(j["z"], j["onehot"], spec.batch)}

    if isinstance(spec, SgdUpdateSpec) and pass_ == "upd":
        lr, mu = spec.lr, spec.momentum
        if mu:

            def upd_mom(j):
                v_new = mu * j["v"] + j["dw"]
                return {"v_new": v_new, "w_new": j["w"] - lr * v_new}

            return upd_mom
        return lambda j: {"w_new": j["w"] - lr * j["dw"]}

    if isinstance(spec, AttentionSpec):  # per sequence: x (N, S, 3D), dy (N, S, D)
        if pass_ == "fwd":
            return lambda j: {"y": attention_fwd(j["x"], spec)}
        if pass_ == "dx":
            return lambda j: {"dx": attention_dx(j["x"], j["dy"], spec)}

    if isinstance(spec, LayerNormSpec):
        eps = spec.eps
        if pass_ == "fwd":
            return lambda j: {"y": _layernorm_stats(j["x"], eps)[0] * j["w"][0] + j["w"][1]}
        if pass_ == "dw":
            def ln_dw(j):
                xhat = _layernorm_stats(j["x"], eps)[0]
                return {"dw": torch.stack([(j["dy"] * xhat).sum(dim=0), j["dy"].sum(dim=0)])}

            return ln_dw
        if pass_ == "dx":
            return lambda j: {"dx": layernorm_dx(j["x"], j["w"], j["dy"], eps)}

    if isinstance(spec, ResidualAddSpec):
        if pass_ == "fwd":
            return lambda j: {"y": j["x"] + j["x2"]}
        if pass_ == "dx":
            return lambda j: {"dx": j["dy"]}

    if isinstance(spec, EmbeddingSpec):  # one-hot token rows @ the table
        if pass_ == "fwd":
            return lambda j: {"y": streaming.streaming_matmul(j["x"], j["w"])}
        if pass_ == "dw":
            return lambda j: {"dw": streaming.streaming_matmul(j["x"].T, j["dy"])}

    if isinstance(spec, PosEmbedSpec):  # x, dy (N, S, d)
        if pass_ == "fwd":
            return lambda j: {"y": j["x"] + j["w"][None]}
        if pass_ == "dw":
            return lambda j: {"dw": j["dy"].sum(dim=0)}
        if pass_ == "dx":
            return lambda j: {"dx": j["dy"]}

    raise TypeError(f"no torch route for spec {type(spec).__name__} pass {pass_!r}")


class CompiledPlan:
    """One cached plan callable and its call count."""

    __slots__ = ("key", "fn", "calls")

    def __init__(self, key, fn):
        self.key = key
        self.fn = fn
        self.calls = 0

    def __call__(self, inputs):
        self.calls += 1
        return self.fn(inputs)


def _graph_fingerprint(graph):
    """Hashable identity of everything a fusion plan depends on."""
    return (
        tuple((n.name, n.spec, n.param, n.in_edge, n.out_edge, n.aux_edges)
              for n in graph.nodes),
        graph.loss, graph.batch, graph.lr, graph.momentum,
        graph.input_edge, graph.label_edge,
    )


class PlanCache:
    """Plan cache of the torch executor.

    Keyed by ``(spec, pass, device)`` — ``(RegionSpec, "region", device)``
    for fused regions — with hit/miss counts. Fusion plans are memoised per
    graph the same way.
    """

    def __init__(self):
        self._plans: dict = {}
        self._fusions: dict = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, spec, pass_: str, device: torch.device) -> CompiledPlan:
        key = (spec, pass_, str(device))
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        plan = self._plans[key] = CompiledPlan(key, _plan_callable(spec, pass_, device))
        return plan

    @property
    def calls(self) -> int:
        return sum(p.calls for p in self._plans.values())

    def fusion_plan(self, graph, keep_grads: bool = True) -> FusionPlan:
        key = (_graph_fingerprint(graph), keep_grads)
        plan = self._fusions.get(key)
        if plan is None:
            plan = self._fusions[key] = plan_fusion(graph, keep_grads=keep_grads)
        return plan


def _as_f32(inputs: dict, device: torch.device) -> dict:
    """Inputs as float32 tensors on ``device``; such tensors pass untouched."""
    out = {}
    for k, v in inputs.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device=device, dtype=torch.float32)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return out


def _fusion_for(program: NtxProgram, *, fuse_updates: bool = True) -> FusionPlan:
    """The program's memoised fusion plan for ``fuse_updates`` (it counts the
    program's commands); one plan per value, as JAX keeps ``_fusion_plans``."""
    plans = program.meta.setdefault("_fusion_plans", {})
    plan = plans.get(fuse_updates)
    if plan is None:
        plan = plans[fuse_updates] = plan_fusion(program, fuse_updates=fuse_updates)
    return plan


def _route_of(program: NtxProgram | None) -> str | None:
    """The mesh route of ``program`` (None when it is not sharded)."""
    return mesh_route(program) if program is not None and "mesh" in program.meta else None


def step_fusion(program: NtxProgram) -> FusionPlan:
    """The fusion plan :func:`run_torch` walks for ``program``: updates fused
    unless its mesh route is the sharded walk."""
    return _fusion_for(program, fuse_updates=_route_of(program) != "sharded")


def world_size() -> int:
    """Ranks of the initialised ``torch.distributed`` process group; 1 when
    none is initialised (the mesh route's "devices")."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def mesh_route(program: NtxProgram) -> str:
    """How :func:`run_torch` runs a mesh-sharded program (``meta["mesh"]``):
    JAX's ``_run_pallas_graph_mesh`` rule, with devices read as ranks.

    * ``"walk"``: fewer ranks than live HMCs, or a batch the live HMCs do
      not divide — the whole batch on the caller's device, the single-device
      walk with the updates fused (``fuse_updates=True``);
    * ``"sharded"``: one live HMC and one rank — the shard walks its slice
      (the whole batch) with every SGD update a per-node step after the
      gradient reduce (``fuse_updates=False``);
    * two or more ranks otherwise: NotImplementedError (ROADMAP A6b).
    """
    mesh = program.meta["mesh"]
    alive = mesh.get("alive")
    n_alive = len(alive) if alive is not None else mesh["n_hmcs"]
    ranks = world_size()
    if ranks < n_alive or program.meta["graph"].batch % n_alive:
        return "walk"
    if ranks == 1:
        return "sharded"
    raise NotImplementedError(
        f"{ranks} ranks for {n_alive} live HMCs: the sharded walk over a "
        "torch.distributed process group is not ported yet (ROADMAP A6b)")


def _record_cache_delta(reg, cache: PlanCache, before) -> None:
    """Book what the cache did during one executor call under plan_cache/."""
    if not reg.enabled:
        return
    h0, m0, c0 = before
    with reg.scope("plan_cache"):
        reg.inc("hits", cache.hits - h0)
        reg.inc("misses", cache.misses - m0)
        reg.inc("calls", cache.calls - c0)


def _record_fusion(reg, fusion: FusionPlan | None) -> None:
    """Book what the fuser covered this step under fusion/."""
    if not reg.enabled or fusion is None:
        return
    with reg.scope("fusion"):
        reg.inc("regions", fusion.n_regions)
        reg.inc("fallback_dispatches", len(fusion.fallback_steps))
        reg.inc("fused_commands", fusion.fused_commands)
        reg.inc("unfused_commands", fusion.total_commands - fusion.fused_commands)


def _spanned(col, plan: CompiledPlan, spec, pass_: str):
    """``plan`` wrapped in a host span: the region's label with cat "fused",
    ``Type:pass`` with cat "dispatch". The span ends when the call returns,
    without a device synchronise, so it times the host's dispatch."""
    label = spec.label if isinstance(spec, RegionSpec) else None
    name = label or f"{type(spec).__name__}:{pass_}"
    cat = "fused" if label else "dispatch"

    def timed(j):
        with col.host_span(name, tid="dispatch", cat=cat):
            return plan(j)

    return timed


def run_torch(graph, inputs: dict, *, fuse: bool = True, keep_grads: bool = True,
              device=None, cache: PlanCache | None = None) -> dict:
    """Run one training step of ``graph`` on ``inputs``.

    ``graph`` is a :class:`~repro_torch.lower.graph.NetworkGraph` or an
    :class:`~repro_torch.lower.ir.NtxProgram` lowered from one (its graph and
    ``keep_grads`` are taken, and the fusion plan is the program's, which
    counts its commands). ``inputs`` holds the input edge, the one-hot
    labels, the parameters and (with momentum) the ``v_<param>`` state, as
    numpy arrays or tensors. Returns the logits, ``d_<param>`` (with
    ``keep_grads``), ``<param>_new`` and ``v_<param>_new`` as tensors on the
    device.

    A program sharded over a mesh of HMCs (``meta["mesh"]``, from
    :func:`~repro_torch.lower.mesh.shard_training_step`) takes the route
    :func:`mesh_route` names: the single-device walk, or the sharded walk,
    whose gradient reduce (over one shard: the identity) runs on every
    ``d_<param>`` between its dW and its SGD update.

    With a registry active it books the plan cache's ``hits``, ``misses``
    and ``calls`` of this call under ``plan_cache/`` (the JAX executor's
    ``retraces`` has no counterpart: the cache holds Python callables, with
    no tracing JIT behind them), the fusion plan under ``fusion/`` when
    fused, and, when given a program, the program's closed-form counts.
    """
    program = None
    if isinstance(graph, NtxProgram):
        program = graph
        keep_grads = program.meta["keep_grads"]
        graph = program.meta["graph"]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if cache is None:
        cache = PlanCache()
    reg = obs.get_active()
    col = obs_trace.get_active_trace()
    before = (cache.hits, cache.misses, cache.calls) if reg is not None else None
    j = _as_f32(inputs, dev)

    def plan(spec, pass_):
        p = cache.get(spec, pass_, dev)
        return p if col is None else _spanned(col, p, spec, pass_)

    route = _route_of(program)
    fusion = None
    if fuse:
        fusion = (_fusion_for(program, fuse_updates=route != "sharded")
                  if program is not None else cache.fusion_plan(graph, keep_grads))
        segments = fusion.segments
    else:
        segments = [Segment(step=k) for k in step_schedule(graph, keep_grads)]
    out = _walk(graph, j, plan, segments, keep_grads=keep_grads,
                grad_reduce=_identity if route == "sharded" else None)
    if reg is not None:
        if program is not None:
            obs.record_program(reg, program)
        _record_cache_delta(reg, cache, before)
        _record_fusion(reg, fusion)
    return out


def _identity(g):
    return g


def _walk(graph, j, plan, segments, *, keep_grads, grad_reduce=None, batch=None):
    """The segment walk: region kernels and per-node steps.

    The unfused walk (``_graph_step_local`` in the JAX executor) is this
    walk with every step a per-node segment. Activations and their
    gradients live in ``env`` keyed by edge name (the gradient of edge
    ``e`` is ``d_<e>``), so regions and per-node steps compose in any
    interleaving the fusion plan produced.

    ``batch`` is the images the arrays carry (default the graph's): a mesh
    shard walks its slice, its regions resized to it while the loss keeps
    the global batch's 1/B. ``grad_reduce`` runs on every ``d_<param>`` as
    it is produced, before the SGD update reads it, so no region of the walk
    may hold an update (a plan with ``fuse_updates=False``).
    """
    nodes = {n.name: n for n in graph.nodes}
    env = {graph.input_edge: j[graph.input_edge]}
    outs: dict = {}
    B = graph.batch if batch is None else batch
    reduce = grad_reduce or _identity

    def add_grad(edge, v):
        key = f"d_{edge}"
        env[key] = env[key] + v if key in env else v

    def exec_step(key):
        name, pass_ = key.split(":")
        if pass_ == "acc":
            # fan-out accumulate: add_grad summed each consumer's dX into
            # d_<edge> as it landed
            return
        if name == "loss":
            env[f"d_{graph.logits_edge}"] = plan(graph.loss, "dx")(
                {"z": env[graph.logits_edge], "onehot": j[graph.label_edge]}
            )["dz"]
            return
        node = nodes[name]
        s = node.spec
        if pass_ == "fwd":
            a = env[node.in_edge]
            if isinstance(s, Conv2dSpec):
                y = plan(s, "fwd")({"x": a, "w": j[node.param]})["y"]
            elif isinstance(s, MatmulSpec):
                y = plan(s, "fwd")({"a": a, "b": j[node.param]})["c"]
            elif isinstance(s, BiasSpec):
                y = plan(s, "fwd")(
                    {"x": a.reshape(-1, s.c), "b": j[node.param]}
                )["y"].reshape(a.shape)
            elif isinstance(s, (ReluSpec, MaxPool2dSpec)):
                y = plan(s, "fwd")({"x": a})["y"]
            elif isinstance(s, FlattenSpec):
                y = a.reshape(B, s.size)
            elif isinstance(s, AttentionSpec):  # per sequence over token rows
                y = plan(s, "fwd")({"x": a.reshape(-1, s.seq, 3 * s.d)})["y"]
                y = y.reshape(-1, s.d)
            elif isinstance(s, (LayerNormSpec, EmbeddingSpec)):
                y = plan(s, "fwd")({"x": a, "w": j[node.param]})["y"]
            elif isinstance(s, ResidualAddSpec):
                y = plan(s, "fwd")({"x": a, "x2": env[node.aux_edges[0]]})["y"]
            elif isinstance(s, PosEmbedSpec):
                y = plan(s, "fwd")(
                    {"x": a.reshape(-1, s.seq, s.d), "w": j[node.param]}
                )["y"].reshape(-1, s.d)
            else:
                raise TypeError(f"no graph route for {type(s).__name__}")
            env[node.out_edge] = y
        elif pass_ == "dw":
            g = env[f"d_{node.out_edge}"]
            if isinstance(s, Conv2dSpec):
                dw = plan(s, "dw")({"x": env[node.in_edge], "dy": g})["dw"]
            elif isinstance(s, MatmulSpec):
                dw = plan(s, "dw")({"a": env[node.in_edge], "dy": g})["dw"]
            elif isinstance(s, BiasSpec):
                dw = plan(s, "dw")({"dy": g.reshape(-1, s.c)})["db"]
            elif isinstance(s, (LayerNormSpec, EmbeddingSpec)):
                dw = plan(s, "dw")({"x": env[node.in_edge], "dy": g})["dw"]
            elif isinstance(s, PosEmbedSpec):
                dw = plan(s, "dw")({"dy": g.reshape(-1, s.seq, s.d)})["dw"]
            else:
                raise TypeError(f"no dW route for {type(s).__name__}")
            dw = reduce(dw)
            env[f"d_{node.param}"] = dw
            if keep_grads:
                outs[f"d_{node.param}"] = dw
        elif pass_ == "upd":
            p = node.param
            dw = env[f"d_{p}"]
            u_spec = SgdUpdateSpec(n=dw.numel(), lr=graph.lr, momentum=graph.momentum)
            u_in = {"w": j[p].reshape(-1), "dw": dw.reshape(-1)}
            if graph.momentum:
                u_in["v"] = j[f"v_{p}"].reshape(-1)
            u = plan(u_spec, "upd")(u_in)
            outs[f"{p}_new"] = u["w_new"].reshape(j[p].shape)
            if graph.momentum:
                outs[f"v_{p}_new"] = u["v_new"].reshape(j[p].shape)
        else:  # dx
            g = env[f"d_{node.out_edge}"]
            if isinstance(s, Conv2dSpec):
                gx = plan(s, "dx")({"dy": g, "w": j[node.param]})["dx"]
            elif isinstance(s, MatmulSpec):
                gx = plan(s, "dx")({"dy": g, "b": j[node.param]})["dx"]
            elif isinstance(s, (ReluSpec, MaxPool2dSpec)):
                gx = plan(s, "dx")({"x": env[node.in_edge], "dy": g})["dx"]
            elif isinstance(s, FlattenSpec):
                gx = g.reshape((B,) + tuple(s.in_shape))
            elif isinstance(s, BiasSpec):  # shape-preserving passthrough
                gx = g.reshape(env[node.in_edge].shape)
            elif isinstance(s, AttentionSpec):
                a_in = env[node.in_edge]
                gx = plan(s, "dx")(
                    {"x": a_in.reshape(-1, s.seq, 3 * s.d), "dy": g.reshape(-1, s.seq, s.d)}
                )["dx"].reshape(a_in.shape)
            elif isinstance(s, LayerNormSpec):
                gx = plan(s, "dx")({"x": env[node.in_edge], "w": j[node.param], "dy": g})["dx"]
            elif isinstance(s, ResidualAddSpec):  # dy flows into both branches
                gx = plan(s, "dx")({"dy": g})["dx"]
                add_grad(node.aux_edges[0], gx)
            elif isinstance(s, PosEmbedSpec):
                gx = plan(s, "dx")({"dy": g.reshape(-1, s.seq, s.d)})["dx"].reshape(-1, s.d)
            else:
                raise TypeError(f"no dX route for {type(s).__name__}")
            add_grad(node.in_edge, gx)

    for seg in segments:
        if seg.region is None:
            exec_step(seg.step)
            continue
        region = seg.region
        if grad_reduce is not None and any(st.pass_ == "upd" for st in region.stages):
            raise ValueError(f"{region.label}: a region with an update cannot take a "
                             "gradient reduce; plan with fuse_updates=False")
        if region.batch != B:
            region = dataclasses.replace(region, batch=B)
        ins = {name: env[name] if name in env else j[name] for name, _ in region.inputs}
        ro = plan(region, "region")(ins)
        for name, kind in region.outputs:
            v = ro[name]
            if kind == "batched":
                env[name] = v
            elif name.startswith("d_"):
                v = reduce(v)
                env[name] = v
                if keep_grads:
                    outs[name] = v
            else:  # <param>_new / v_<param>_new epilogue results
                outs[name] = v
    outs[graph.logits_edge] = env[graph.logits_edge]
    return outs
