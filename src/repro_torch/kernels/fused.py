"""Fused-region kernel: one whole train-step chain per :class:`RegionSpec`.

Counterpart of ``repro/kernels/fused.py``. A region is a contiguous chain
of node passes (conv / matmul / bias / relu / maxpool / flatten fwd, the
softmax-CE gradient, dW, dX and the SGD / momentum update) planned by
:func:`repro_torch.lower.fuse.plan_fusion`.

* :func:`region_torch` is the plain version: a line-for-line port of the
  TPU kernel's ``_stage_flow`` / ``_stage_updates`` over the whole batch.
* :func:`build_region_callable` returns a ``dict -> dict`` callable. On
  CUDA tensors it launches ``csrc/fused_region.cu``; on CPU tensors it runs
  :func:`region_torch`.

The TPU kernel walks batch tiles in order on one core: it initialises the
dW accumulators on grid step 0, accumulates across steps and runs the
update on the last. CUDA blocks run in no order, so the Hopper design makes
that ordering explicit with two launches: a body kernel computes each
image's stages and writes its dW partials to ``[B, *param_shape]``; an
epilogue kernel, one thread per parameter element, sums the B partials in
image order (deterministic, no float atomics), writes ``d_<p>`` where it
escapes and applies ``v_new = mu*v + dw``, ``w_new = w - lr*v_new``.

The body has two C entries, picked by shape alone (:func:`entry`):

* :data:`SMEM` (``fused_region_smem_launch``): a thread-block cluster of
  :func:`cluster_size` CTAs per image. Each CTA holds the image's staged
  inputs, the parameters the body reads and every live intermediate in
  shared memory, laid out by liveness (:func:`smem_layout`). The convs'
  forward and dX outputs are split over the cluster and each CTA writes its
  share into every CTA's shared memory (DSMEM), followed by a cluster
  barrier; the dW partials are split over the cluster and go to device
  memory; the cheap stages run whole in every CTA. Each output is summed in
  one order that does not depend on the cluster size.
* :data:`ARENA` (``fused_region_launch``): one CTA per image walking the
  stage table over a per-image scratch arena in device memory, for regions
  whose shared-memory layout does not fit one block.

The stage table is compiled once per (spec, device) and kept in a device
int32 tensor; each call only fills a small table of buffer pointers,
passed to the kernels by value.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import LaunchCounter, matmul_block_k, use_kernel
from repro_torch.kernels.streaming import im2col, pad_hw
from repro_torch.lower.rules import (
    BiasSpec,
    Conv2dSpec,
    FlattenSpec,
    MatmulSpec,
    MaxPool2dSpec,
    ReluSpec,
    SoftmaxXentSpec,
)

COUNTER = LaunchCounter("fused_region")
_LIB = "fused_region"
SMEM = "fused_region_smem_launch"  # C entry: cluster per image, shared memory
ARENA = "fused_region_launch"  # C entry: CTA per image, device-memory arena

# ---------------------------------------------------------------------------
# The plain version (a port of _stage_flow / _stage_updates, whole batch)
# ---------------------------------------------------------------------------


def _conv_fwd(x, w, spec: Conv2dSpec):
    p = spec.padding
    cols = im2col(pad_hw(x, p, p), spec.kh, spec.kw, spec.stride, spec.out_h, spec.out_w)
    y = cols @ w.reshape(spec.kh * spec.kw * spec.cin, spec.cout)
    return y.reshape(x.shape[0], spec.out_h, spec.out_w, spec.cout)


def _conv_dw(x, dy, spec: Conv2dSpec):
    """cols(x)^T @ dy, batch in the contraction."""
    p = spec.padding
    cols = im2col(pad_hw(x, p, p), spec.kh, spec.kw, spec.stride, spec.out_h, spec.out_w)
    dwf = cols.T @ dy.reshape(-1, spec.cout)
    return dwf.reshape(spec.kh, spec.kw, spec.cin, spec.cout)


def _conv_dx(dy, w, spec: Conv2dSpec):
    """Transposed conv: dilate dy, pad by k-1-p, correlate rot180(w)."""
    bn = dy.shape[0]
    s, p = spec.stride, spec.padding
    oh, ow = spec.out_h, spec.out_w
    if s > 1:
        z = dy.new_zeros((bn, (oh - 1) * s + 1, (ow - 1) * s + 1, spec.cout))
        z[:, ::s, ::s, :] = dy
    else:
        z = dy
    qh, qw = spec.kh - 1 - p, spec.kw - 1 - p
    rh = (spec.in_h + 2 * p - spec.kh) % s
    rw = (spec.in_w + 2 * p - spec.kw) % s
    z = torch.nn.functional.pad(z, (0, 0, qw, qw + rw, qh, qh + rh))
    w_hat = w.flip((0, 1)).permute(0, 1, 3, 2)  # (kh, kw, cout, cin)
    cols = torch.cat(
        [
            z[:, dh : dh + spec.in_h, dw : dw + spec.in_w, :]
            for dh in range(spec.kh)
            for dw in range(spec.kw)
        ],
        dim=-1,
    ).reshape(bn * spec.in_h * spec.in_w, spec.kh * spec.kw * spec.cout)
    dxf = cols @ w_hat.reshape(-1, spec.cin)
    return dxf.reshape(bn, spec.in_h, spec.in_w, spec.cin)


def pool_fwd(x, spec: MaxPool2dSpec):
    """window == stride max pool as a reshape-max."""
    bn, h, w, c = x.shape
    k = spec.window
    return x.reshape(bn, h // k, k, w // k, k, c).amax(dim=(2, 4))


def pool_dx(x, g, spec: MaxPool2dSpec):
    """Max-pool input gradient: first-match winner mask, row-major taps.

    Ties route the gradient to the first maximal tap in window order, the
    tie-breaking of XLA's select-and-scatter.
    """
    bn, h, w, c = x.shape
    k = spec.window
    oh, ow = h // k, w // k
    xw = x.reshape(bn, oh, k, ow, k, c)
    y = xw.amax(dim=(2, 4))
    eq = xw == y[:, :, None, :, None, :]
    taps = eq.permute(0, 1, 3, 5, 2, 4).reshape(bn, oh, ow, c, k * k)
    first = taps & (torch.cumsum(taps.to(torch.int32), dim=-1) == 1)
    dx = first.to(g.dtype) * g[:, :, :, :, None]
    return (
        dx.reshape(bn, oh, ow, c, k, k)
        .permute(0, 1, 4, 2, 5, 3)
        .reshape(bn, h, w, c)
    )


def softmax_xent_dx(z, onehot, batch: int):
    """(softmax(z) - onehot) / batch, softmax as exp(z - max) / sum."""
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True) - onehot) / batch


def _stage_flow(region, env):
    """Run the region's dataflow stages over the whole batch.

    ``env`` maps edge names to tensors (leading batch axis on batched
    edges) and gains every intermediate. Returns ``(env, partials)`` where
    ``partials`` holds each ``d_<param>`` reduced over the batch.
    """
    partials = {}
    for st in region.stages:
        s = st.spec
        if st.pass_ == "fwd":
            x = env[st.in_edge]
            if isinstance(s, Conv2dSpec):
                y = _conv_fwd(x, env[st.param], s)
            elif isinstance(s, MatmulSpec):
                y = x @ env[st.param]
            elif isinstance(s, BiasSpec):
                y = x + env[st.param]
            elif isinstance(s, ReluSpec):
                y = torch.clamp_min(x, 0.0)
            elif isinstance(s, MaxPool2dSpec):
                y = pool_fwd(x, s)
            elif isinstance(s, FlattenSpec):
                y = x.reshape(x.shape[0], -1)
            else:
                raise TypeError(f"no fused fwd rule for {type(s).__name__}")
            env[st.out_edge] = y
        elif st.pass_ == "dw":
            g = env[f"d_{st.out_edge}"]
            if isinstance(s, Conv2dSpec):
                d = _conv_dw(env[st.in_edge], g, s)
            elif isinstance(s, MatmulSpec):
                d = env[st.in_edge].T @ g
            elif isinstance(s, BiasSpec):
                d = g.reshape(-1, s.c).sum(dim=0)
            else:
                raise TypeError(f"no fused dW rule for {type(s).__name__}")
            partials[f"d_{st.param}"] = d
        elif st.pass_ == "dx":
            if isinstance(s, SoftmaxXentSpec):
                # the onehot labels arrive via the stage's param slot
                env[f"d_{st.in_edge}"] = softmax_xent_dx(
                    env[st.in_edge], env[st.param], s.batch
                )
                continue
            g = env[f"d_{st.out_edge}"]
            if isinstance(s, Conv2dSpec):
                dx = _conv_dx(g, env[st.param], s)
            elif isinstance(s, MatmulSpec):
                dx = g @ env[st.param].T
            elif isinstance(s, ReluSpec):
                # mask from the relu *output*: y > 0 iff x > 0
                dx = torch.where(env[st.out_edge] > 0.0, g, 0.0)
            elif isinstance(s, MaxPool2dSpec):
                dx = pool_dx(env[st.in_edge], g, s)
            elif isinstance(s, FlattenSpec):
                dx = g.reshape((g.shape[0],) + tuple(s.in_shape))
            elif isinstance(s, BiasSpec):
                dx = g
            else:
                raise TypeError(f"no fused dX rule for {type(s).__name__}")
            env[f"d_{st.in_edge}"] = dx
        elif st.pass_ != "upd":
            raise TypeError(f"unknown pass {st.pass_!r} in fused region")
    return env, partials


def _stage_updates(region, totals, env):
    """SGD/momentum epilogue on the fully reduced dW totals."""
    outs = {}
    for st in region.stages:
        if st.pass_ != "upd":
            continue
        p = st.param
        # when a barrier split the dw stage into an earlier region, the
        # reduced total arrives as a resident input instead
        dw = totals.get(f"d_{p}")
        if dw is None:
            dw = env[f"d_{p}"]
        if region.momentum:
            v_new = region.momentum * env[f"v_{p}"] + dw
            outs[f"v_{p}_new"] = v_new
        else:
            v_new = dw
        outs[f"{p}_new"] = env[p] - region.lr * v_new
    return outs


def region_torch(region, inputs: dict) -> dict:
    """Plain version of one fused region: inputs -> escaping outputs."""
    COUNTER.plain_calls += 1
    env = {n: inputs[n] for n, _ in region.inputs}
    env, totals = _stage_flow(region, env)
    upd = _stage_updates(region, totals, env)
    outs = {}
    for name, kind in region.outputs:
        if kind == "batched":
            outs[name] = env[name]
        else:
            outs[name] = upd[name] if name in upd else totals[name]
    return outs


# ---------------------------------------------------------------------------
# Compilation of a RegionSpec into the kernels' stage tables
# ---------------------------------------------------------------------------

# opcodes; keep in sync with csrc/fused_region.cu
OP_CONV_FWD, OP_CONV_DW, OP_CONV_DX = 1, 2, 3
OP_MM_FWD, OP_MM_DW, OP_MM_DX = 4, 5, 6
OP_BIAS_FWD, OP_BIAS_DW, OP_COPY = 7, 8, 9
OP_RELU_FWD, OP_RELU_DX = 10, 11
OP_POOL_FWD, OP_POOL_DX = 12, 13
OP_XENT_DX = 14
REC = 16  # ints per body record: op, a, b, out, 10 static ints, 0, scratch slot
EPI_REC = 8  # ints per epilogue record
MAX_BUFS = 64  # RegionBufs capacity in the kernel source
BODY_THREADS = 512
# the shared-memory entry (keep in sync with csrc/fused_region.cu):
SMEM_THREADS = 512
MAX_SMEM_STAGES = 48  # body stages it takes (its stage table sits in static shared memory)
SMEM_STATIC = 4 * (MAX_SMEM_STAGES * REC + 3 * MAX_BUFS) + 8 * MAX_BUFS  # its static bytes
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
CLUSTER_SIZES = (8, 4, 2, 1)
DW_CHUNK = 32  # a conv-dW sub-sum: whole output rows, at least this many pixels
# ops whose outputs every CTA needs: split over the cluster, each share
# written into every CTA's shared memory, then a cluster barrier
BROADCAST_OPS = frozenset({OP_CONV_FWD, OP_CONV_DX})
# dW partials: split over the cluster, written to device memory only
PARTIAL_OPS = frozenset({OP_CONV_DW, OP_MM_DW, OP_BIAS_DW})
# every other op runs whole in each CTA of the cluster
STAGED, ESCAPES = 1, 2  # Buffer.mode bits: loaded at the start; also written to device memory


@dataclass(frozen=True)
class Buffer:
    """One operand buffer of a compiled region.

    ``kind``: ``"in"`` (a region input), ``"out"`` (a region output),
    ``"scratch"`` (a slot of the per-image arena at ``offset``) or
    ``"partial"`` (per-image dW partials). ``shape`` is per image for
    batched buffers and whole for resident ones. ``slot`` and ``mode`` place
    it in the shared-memory entry (:func:`smem_layout`).
    """

    kind: str
    name: str
    shape: tuple[int, ...]
    batched: bool
    offset: int = 0
    slot: int = -1  # float offset in the shared-memory entry's layout, -1: none
    mode: int = 0  # STAGED | ESCAPES

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class CompiledRegion:
    region: object
    buffers: tuple[Buffer, ...]
    body: list[int]  # n_stages * REC ints
    epilogue: list[int]  # n_params * EPI_REC ints
    arena: int  # scratch floats per image
    smem: int  # floats of one CTA's shared memory in the SMEM entry
    live: dict  # slot-holding name -> (first, last) stage, as smem_layout gives it

    @property
    def n_stages(self) -> int:
        return len(self.body) // REC

    @property
    def n_params(self) -> int:
        return len(self.epilogue) // EPI_REC

    @property
    def max_param_numel(self) -> int:
        return max((self.epilogue[i] for i in range(0, len(self.epilogue), EPI_REC)), default=0)


def _conv_ints(s: Conv2dSpec) -> list[int]:
    return [s.in_h, s.in_w, s.cin, s.kh, s.kw, s.cout, s.stride, s.padding, s.out_h, s.out_w]


def _pool_ints(s: MaxPool2dSpec) -> list[int]:
    return [s.in_h, s.in_w, s.c, s.window, s.out_h, s.out_w]


def edge_shapes(region, input_shapes: dict) -> dict[str, tuple[int, ...]]:
    """Per-image shapes of every edge the region touches (whole shapes for
    unbatched edges), from the input shapes and the stage specs."""
    sh = dict(input_shapes)
    for st in region.stages:
        s = st.spec
        if st.pass_ == "fwd":
            if isinstance(s, Conv2dSpec):
                out = (s.out_h, s.out_w, s.cout)
            elif isinstance(s, MatmulSpec):
                out = (s.n,)
            elif isinstance(s, MaxPool2dSpec):
                out = (s.out_h, s.out_w, s.c)
            elif isinstance(s, FlattenSpec):
                out = (s.size,)
            else:  # bias, relu: shape-preserving
                out = sh[st.in_edge]
            sh[st.out_edge] = out
        elif st.pass_ == "dw":
            if isinstance(s, Conv2dSpec):
                sh[f"d_{st.param}"] = (s.kh, s.kw, s.cin, s.cout)
            elif isinstance(s, MatmulSpec):
                sh[f"d_{st.param}"] = (s.k, s.n)
            else:
                sh[f"d_{st.param}"] = (s.c,)
        elif st.pass_ == "dx":
            if isinstance(s, SoftmaxXentSpec):
                out = (s.classes,)
            elif isinstance(s, Conv2dSpec):
                out = (s.in_h, s.in_w, s.cin)
            elif isinstance(s, MatmulSpec):
                out = (s.k,)
            elif isinstance(s, ReluSpec):
                out = tuple(s.shape)
            elif isinstance(s, MaxPool2dSpec):
                out = (s.in_h, s.in_w, s.c)
            elif isinstance(s, FlattenSpec):
                out = tuple(s.in_shape)
            else:  # bias
                out = sh[f"d_{st.out_edge}"]
            sh[f"d_{st.in_edge}"] = out
        else:  # upd
            p = st.param
            sh[f"{p}_new"] = sh[p]
            if region.momentum:
                sh[f"v_{p}_new"] = sh[p]
    return sh


def compile_region(region, input_shapes: dict) -> CompiledRegion:
    """Lay out the region's buffers and encode its stage tables.

    ``input_shapes`` maps each input edge to its per-image shape (batched)
    or whole shape (resident).
    """
    sh = edge_shapes(region, input_shapes)
    buffers: list[Buffer] = []
    index: dict[str, int] = {}
    arena = 0

    def add(buf: Buffer) -> int:
        if buf.name in index:
            raise ValueError(f"edge {buf.name!r} is written twice in {region.label}")
        index[buf.name] = len(buffers)
        buffers.append(buf)
        return index[buf.name]

    for name, batched in region.inputs:
        add(Buffer("in", name, tuple(sh[name]), batched))
    batched_outs = {n for n, k in region.outputs if k == "batched"}
    for name, kind in region.outputs:
        if kind == "reduced":
            add(Buffer("out", name, tuple(sh[name]), False))

    def written(name: str, partial: bool = False) -> int:
        nonlocal arena
        if partial:
            # a dW partial whose total escapes is still written per image
            return add(Buffer("partial", f"{name}@partial", tuple(sh[name]), True))
        if name in batched_outs:
            return add(Buffer("out", name, tuple(sh[name]), True))
        buf = Buffer("scratch", name, tuple(sh[name]), True, offset=arena)
        arena += buf.numel
        return add(buf)

    def numel(name: str) -> int:
        return math.prod(sh[name])

    body: list[int] = []
    partial_of: dict[str, int] = {}
    for st in region.stages:
        s = st.spec
        if st.pass_ == "upd":
            continue
        if st.pass_ == "fwd":
            a, b = index[st.in_edge], index.get(st.param, -1)
            out = written(st.out_edge)
            if isinstance(s, Conv2dSpec):
                rec = [OP_CONV_FWD, a, b, out, *_conv_ints(s)]
            elif isinstance(s, MatmulSpec):
                rec = [OP_MM_FWD, a, b, out, s.k, s.n]
            elif isinstance(s, BiasSpec):
                rec = [OP_BIAS_FWD, a, b, out, numel(st.in_edge), s.c]
            elif isinstance(s, ReluSpec):
                rec = [OP_RELU_FWD, a, -1, out, numel(st.in_edge)]
            elif isinstance(s, MaxPool2dSpec):
                rec = [OP_POOL_FWD, a, -1, out, *_pool_ints(s)]
            elif isinstance(s, FlattenSpec):
                rec = [OP_COPY, a, -1, out, s.size]
            else:
                raise TypeError(f"no fused fwd rule for {type(s).__name__}")
        elif st.pass_ == "dw":
            dname = f"d_{st.param}"
            g = index[f"d_{st.out_edge}"]
            out = written(dname, partial=True)
            partial_of[st.param] = out
            if isinstance(s, Conv2dSpec):
                rec = [OP_CONV_DW, index[st.in_edge], g, out, *_conv_ints(s)]
            elif isinstance(s, MatmulSpec):
                rec = [OP_MM_DW, index[st.in_edge], g, out, s.k, s.n]
            elif isinstance(s, BiasSpec):
                rec = [OP_BIAS_DW, g, -1, out, numel(f"d_{st.out_edge}"), s.c]
            else:
                raise TypeError(f"no fused dW rule for {type(s).__name__}")
        else:  # dx
            if isinstance(s, SoftmaxXentSpec):
                out = written(f"d_{st.in_edge}")
                rec = [OP_XENT_DX, index[st.in_edge], index[st.param], out, s.classes, s.batch]
            else:
                g = index[f"d_{st.out_edge}"]
                out = written(f"d_{st.in_edge}")
                if isinstance(s, Conv2dSpec):
                    rec = [OP_CONV_DX, g, index[st.param], out, *_conv_ints(s)]
                elif isinstance(s, MatmulSpec):
                    rec = [OP_MM_DX, g, index[st.param], out, s.k, s.n]
                elif isinstance(s, ReluSpec):
                    rec = [OP_RELU_DX, index[st.out_edge], g, out, s.size]
                elif isinstance(s, MaxPool2dSpec):
                    rec = [OP_POOL_DX, index[st.in_edge], g, out, *_pool_ints(s)]
                elif isinstance(s, (FlattenSpec, BiasSpec)):
                    rec = [OP_COPY, g, -1, out, numel(f"d_{st.out_edge}")]
                else:
                    raise TypeError(f"no fused dX rule for {type(s).__name__}")
        body += rec + [0] * (REC - len(rec))

    # epilogue: one record per parameter with a dW or an update in the region
    epilogue: list[int] = []
    params = [st.param for st in region.stages if st.pass_ in ("dw", "upd")]
    for p in dict.fromkeys(params):
        has_upd = any(st.pass_ == "upd" and st.param == p for st in region.stages)
        partial = partial_of.get(p, -1)
        mom = bool(region.momentum) and has_upd
        epilogue += [
            math.prod(sh[f"d_{p}"]),
            partial,
            -1 if partial >= 0 else index[f"d_{p}"],
            # with an in-region dW, d_<p> is in the index only as an output
            index[f"d_{p}"] if partial >= 0 and f"d_{p}" in index else -1,
            index[p] if has_upd else -1,
            index[f"v_{p}"] if mom else -1,
            index[f"{p}_new"] if has_upd else -1,
            index[f"v_{p}_new"] if mom else -1,
        ]
    if len(buffers) > MAX_BUFS:
        raise ValueError(f"{region.label} needs {len(buffers)} buffers > {MAX_BUFS}")
    slots, modes, scratch, smem, live = smem_layout(buffers, body)
    buffers = [Buffer(b.kind, b.name, b.shape, b.batched, b.offset, slots[i], modes[i])
               for i, b in enumerate(buffers)]
    for s_, off in scratch.items():
        body[s_ * REC + REC - 1] = off
    return CompiledRegion(region, tuple(buffers), body, epilogue, arena, smem, live)


def stage_scratch(rec) -> int:
    """Floats of CTA-local scratch a stage of the SMEM entry needs: the conv
    dW's sub-sums (one per chunk of :func:`dw_rows` output rows and output), the conv dX's
    copy of w as [tap][co][ci] in rows of Cin + 4, and the matmul forward's
    slice sums and K-tile sums (one per slice of 8, one per tile, and output)."""
    if rec[0] == OP_CONV_DW:
        oh, ow = rec[12], rec[13]
        return -(-oh // dw_rows(ow)) * math.prod(rec[7:10]) * rec[6]
    if rec[0] == OP_CONV_DX:
        return rec[7] * rec[8] * rec[9] * (rec[6] + 4)
    if rec[0] == OP_MM_FWD:
        k, n = rec[4], rec[5]
        bk = matmul_block_k(k)
        tiles = -(-k // bk)
        return (tiles * -(-bk // 8) + tiles) * n
    return 0


def dw_rows(ow: int) -> int:
    """Output rows of one conv-dW sub-sum (``dw_rows`` in the kernel source)."""
    return max(1, DW_CHUNK // ow)


def smem_layout(buffers, body):
    """Lay the SMEM entry's shared memory out by liveness.

    Slots go to the staged inputs (those the body reads), every intermediate
    and every batched output (a batched output is also written to device
    memory, ``ESCAPES``), and one CTA-local scratch per stage that needs it
    (:func:`stage_scratch`). Each holds an interval of stages: an input from
    0, an output from the stage that writes it, to its last reader. An
    output written into every CTA (:data:`BROADCAST_OPS`) holds from the
    stage after the previous cluster barrier, since a CTA may still be in
    any stage since then when a peer writes it. Two slots share memory only
    if their intervals are disjoint; each is placed first fit at a multiple
    of 4 floats. Returns (slot per buffer, mode per buffer, scratch offset
    per stage, floats in all, name -> interval).
    """
    n_st = len(body) // REC
    recs = [body[i * REC:(i + 1) * REC] for i in range(n_st)]
    first, last, modes = {}, {}, [0] * len(buffers)
    for s, r in enumerate(recs):
        for i in (r[1], r[2]):
            if i >= 0:
                last[i] = s
                if buffers[i].kind == "in":
                    first[i] = 0
                    modes[i] |= STAGED
        out = r[3]
        if buffers[out].kind == "partial":
            continue
        if r[0] in BROADCAST_OPS:
            barrier = max((u for u in range(s) if recs[u][0] in BROADCAST_OPS), default=-1)
            first[out] = barrier + 1
        else:
            first[out] = s
        last.setdefault(out, s)
        if buffers[out].kind == "out":
            modes[out] |= ESCAPES
    items = [(first[i], last[i], buffers[i].numel, ("buf", i)) for i in first]
    items += [(s, s, stage_scratch(r), ("scratch", s)) for s, r in enumerate(recs)
              if stage_scratch(r)]
    placed, where = [], {}
    for lo, hi, size, key in sorted(items, key=lambda t: (t[0], t[3])):
        busy = sorted((o, o + n) for a, b, o, n in placed if a <= hi and lo <= b)
        off = 0
        for o0, o1 in busy:
            if off + size <= o0:
                break
            off = max(off, -(-o1 // 4) * 4)
        placed.append((lo, hi, off, size))
        where[key] = off
    slots = [where.get(("buf", i), -1) for i in range(len(buffers))]
    scratch = {s: off for (kind, s), off in where.items() if kind == "scratch"}
    total = max((o + n for _, _, o, n in placed), default=0)
    live = {buffers[i].name: (first[i], last[i]) for i in first}
    live.update({f"scratch@{s}": (s, s) for s in scratch})
    return slots, modes, scratch, total, live


# ---------------------------------------------------------------------------
# The kernel launch
# ---------------------------------------------------------------------------


def _fn(name: str):
    fn = getattr(build.library(_LIB), name)
    if fn.argtypes is None:
        types = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # body table, stages, threads
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # epilogue table, params, max numel
            ctypes.c_int, ctypes.c_float, ctypes.c_float,  # batch, lr, momentum
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,  # nbuf, ptrs, strides
        ]
        if name == SMEM:  # cluster size, shared bytes, slots, numels, modes
            types += [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
        fn.argtypes = types + [ctypes.c_void_p]  # stream
        fn.restype = ctypes.c_int
    return fn


def entry(compiled: CompiledRegion) -> str:
    """The C entry a CUDA region launches, by shape alone: :data:`SMEM` where
    its shared-memory layout fits one block (and it has at most
    :data:`MAX_SMEM_STAGES` body stages), else :data:`ARENA`."""
    fits = (4 * compiled.smem + SMEM_STATIC <= MAX_SMEM
            and compiled.n_stages <= MAX_SMEM_STAGES)
    return SMEM if fits else ARENA


def cluster_size(batch: int, active: dict[int, int]) -> int:
    """CTAs per image on the SMEM entry: the largest of 8, 4, 2, 1 whose
    clusters for the whole batch run at once. ``active`` maps a cluster size
    to how many such clusters the device runs at once
    (:func:`active_clusters`; a cluster's CTAs share one GPC, so at most
    SMs // size: B * C <= 132 on an H100)."""
    return next(c for c in CLUSTER_SIZES if c == 1 or batch <= active[c])


def active_clusters(smem_bytes: int, device: torch.device) -> dict[int, int]:
    """Cluster size -> clusters of the SMEM entry the device runs at once."""
    fn = build.library(_LIB).fused_region_smem_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    with torch.cuda.device(device):
        for c in CLUSTER_SIZES[:-1]:
            n = ctypes.c_int(0)
            build.check(_LIB, fn(c, smem_bytes, SMEM_THREADS, ctypes.byref(n)),
                        "fused_region_smem_max_clusters")
            out[c] = n.value
    return out


class RegionKernel:
    """A region compiled for one CUDA device: stage tables on the device."""

    def __init__(self, compiled: CompiledRegion, device: torch.device):
        self.compiled = compiled
        self.device = device
        self.body = torch.tensor(compiled.body or [0], dtype=torch.int32, device=device)
        self.epilogue = torch.tensor(compiled.epilogue or [0], dtype=torch.int32, device=device)
        self.entry = entry(compiled)
        self.cluster = (cluster_size(compiled.region.batch,
                                     active_clusters(4 * compiled.smem, device))
                        if self.entry == SMEM else 1)
        # what each launch passes that does not change from call to call
        bufs = compiled.buffers
        n = len(bufs)
        self.strides = (ctypes.c_longlong * n)(
            *(compiled.arena if b.kind == "scratch" else (b.numel if b.batched else 0)
              for b in bufs))
        self.smem_args = [(ctypes.c_int * n)(*(b.slot for b in bufs)),
                          (ctypes.c_int * n)(*(b.numel for b in bufs)),
                          (ctypes.c_int * n)(*(b.mode for b in bufs))]

    def __call__(self, inputs: dict, *, name: str | None = None,
                 cluster: int | None = None) -> dict:
        """Run the region; ``name`` forces a C entry (the arena entry takes
        every region; SMEM raises where the layout does not fit) and
        ``cluster`` the SMEM entry's cluster size (1, 2, 4 or 8)."""
        c = self.compiled
        region = c.region
        B = region.batch
        dev = self.device
        name = name or self.entry
        if name == SMEM and self.entry != SMEM:
            raise ValueError(f"{region.label}: {c.n_stages} stages and a shared-memory layout "
                             f"of {4 * c.smem} + {SMEM_STATIC} bytes do not fit {SMEM}; only "
                             f"{ARENA} runs it")
        if name not in (SMEM, ARENA):
            raise ValueError(f"fused region: no C entry {name!r}; entries are {SMEM}, {ARENA}")
        cluster = cluster or self.cluster
        if cluster not in CLUSTER_SIZES:
            raise ValueError(f"cluster size {cluster} is not one of {CLUSTER_SIZES}")
        keep, ptrs, outs = [], [], {}
        arena = (torch.empty((B, max(c.arena, 1)), dtype=torch.float32, device=dev)
                 if name == ARENA else None)
        for buf in c.buffers:
            if buf.kind == "in":
                t = inputs[buf.name]
                want = ((B,) + buf.shape) if buf.batched else buf.shape
                if tuple(t.shape) != want or t.dtype != torch.float32 or t.device != dev:
                    raise ValueError(
                        f"{region.label}: input {buf.name!r} must be float32 {want} on "
                        f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                    )
                t = t.contiguous()
                ptr = t.data_ptr()
            elif buf.kind == "scratch":
                t = None
                ptr = arena.data_ptr() + 4 * buf.offset if arena is not None else 0
            else:
                shape = ((B,) + buf.shape) if buf.batched else buf.shape
                t = torch.empty(shape, dtype=torch.float32, device=dev)
                ptr = t.data_ptr()
                if buf.kind == "out":
                    outs[buf.name] = t
            keep.append(t)
            ptrs.append(ptr)
        n = len(ptrs)
        args = [
            self.body.data_ptr(), c.n_stages, SMEM_THREADS if name == SMEM else BODY_THREADS,
            self.epilogue.data_ptr(), c.n_params, c.max_param_numel,
            B, float(region.lr), float(region.momentum),
            n, (ctypes.c_longlong * n)(*ptrs), self.strides,
        ]
        if name == SMEM:
            args += [cluster, 4 * c.smem, *self.smem_args]
        code = _fn(name)(*args, torch.cuda.current_stream(dev).cuda_stream)
        build.check(_LIB, code, region.label)
        COUNTER.launches += 1
        COUNTER.entries[name] = COUNTER.entries.get(name, 0) + 1
        return outs


_KERNELS: dict = {}


def region_kernel(region, inputs: dict, device: torch.device) -> RegionKernel:
    """The compiled kernel of ``region`` on ``device`` (cached by spec)."""
    shapes = {
        n: tuple(inputs[n].shape[1:]) if b else tuple(inputs[n].shape)
        for n, b in region.inputs
    }
    key = (region, device, tuple(sorted(shapes.items())))
    k = _KERNELS.get(key)
    if k is None:
        k = _KERNELS[key] = RegionKernel(compile_region(region, shapes), device)
    return k


def build_region_callable(region, *, device):
    """Compile one RegionSpec into a ``dict -> dict`` callable.

    The callable takes the region's input edges (batched activations and
    gradients, resident params) and returns its escaping edges. CUDA
    tensors launch the fused-region kernel on ``device``; CPU tensors run
    :func:`region_torch`.
    """
    want = torch.device(device).type

    def fn(inputs: dict) -> dict:
        ins = {n: inputs[n] for n, _ in region.inputs}
        if not use_kernel(*ins.values()):
            return region_torch(region, ins)
        dev = next(iter(ins.values())).device
        if dev.type != want:
            raise ValueError(f"{region.label} was built for {want}, got tensors on {dev}")
        return region_kernel(region, ins, dev)(ins)

    return fn
