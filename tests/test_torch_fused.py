"""The port's region fuser and fused-region kernel vs the JAX package.

* plan parity: ``repro_torch`` plans from the graph; the JAX fuser plans
  from the lowered NTX program. With the program's spilled regions passed
  as ``spilled=``, both give the same segments, stages, inputs and outputs.
* region parity: the plain version ``region_torch`` vs the JAX region
  kernel in interpret mode, on every region of those plans.
* the stage tables the CUDA kernel walks: a numpy emulation of the tables
  (one image at a time, per-image scratch arena, per-image dW partials,
  fixed-order epilogue) must reproduce ``region_torch``. The CUDA kernel
  itself runs only on the card (tests/test_torch_kernels_cuda.py).
* the shared-memory entry's layout (no two live buffers share a slot) and
  its cluster split, emulated CTA by CTA with each CTA's own shared memory
  (C 1, 2, 4 and 8 give the same results, those of ``region_torch``), and
  the route by shape.
* maxpool ties route the gradient to the first maximal tap, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused import build_region_callable as jax_region_callable
from repro.lower import lower_training_step
from repro.lower import paper_cnn_graph as jax_paper_cnn_graph
from repro.lower import plan_fusion as jax_plan_fusion
from repro_torch.kernels import fused
from repro_torch.kernels.ops import matmul_block_k
from repro_torch.lower import MaxPool2dSpec, RegionSpec, Stage, paper_cnn_graph, plan_fusion
from repro_torch.lower.executors import _plan_callable

SIZES = [(4, 16), (8, 32), (64, 32)]


def _plans(batch, img):
    jg = jax_paper_cnn_graph(batch=batch, img=img)
    program = lower_training_step(jg)
    jplan = jax_plan_fusion(program)
    spilled = program.meta["spilled"]
    tplan = plan_fusion(paper_cnn_graph(batch=batch, img=img), spilled=spilled)
    return jplan, tplan, spilled


def _seg_view(seg):
    if seg.region is None:
        return ("step", seg.step)
    r = seg.region
    stages = tuple(
        (st.node, st.pass_, type(st.spec).__name__, tuple(vars(st.spec).values()),
         st.in_edge, st.out_edge, st.param)
        for st in r.stages
    )
    return ("region", stages, r.inputs, r.outputs, r.batch, r.lr, r.momentum)


@pytest.mark.parametrize("batch,img", SIZES)
def test_plan_matches_jax_fuser(batch, img):
    jplan, tplan, spilled = _plans(batch, img)
    assert [_seg_view(s) for s in tplan.segments] == [_seg_view(s) for s in jplan.segments]
    assert tplan.fallback_steps == jplan.fallback_steps
    assert tplan.n_regions == jplan.n_regions
    assert bool(spilled) == (img == 32)  # the NTX TCDM model spills at img 32


def test_the_card_tests_spill_set_is_the_jax_lowerings():
    from test_torch_kernels_cuda import SPILLED_16_32

    _, _, spilled = _plans(16, 32)
    assert set(spilled) == set(SPILLED_16_32)


@pytest.mark.parametrize("batch", [8, 64])
def test_full_width_plans_one_region_without_spill_barrier(batch):
    plan = plan_fusion(paper_cnn_graph(batch=batch, img=32))
    assert plan.n_regions == 1 and plan.fallback_steps == []
    (seg,) = plan.segments
    assert len(seg.region.stages) == 24


# ---------------------------------------------------------------------------
# Region inputs made from seeded numpy
# ---------------------------------------------------------------------------


def _edge_shapes(graph):
    """Per-image shapes of the graph's batched edges, whole shapes of params."""
    sh = {graph.input_edge: tuple(graph.input_shape), graph.label_edge: (graph.loss.classes,)}
    for n in graph.nodes:
        sh[n.out_edge] = tuple(n.out_shape)
    sh.update({f"d_{e}": s for e, s in list(sh.items())})
    for p, s in graph.param_shapes().items():
        sh.update({p: s, f"v_{p}": s, f"d_{p}": s})
    return sh


def _region_inputs(region, graph, seed):
    """Seeded inputs at the scales of a training step: images ~1, params
    ~0.1 (``init_params``), momentum and activation gradients ~0.01."""
    rng = np.random.RandomState(seed)
    sh = _edge_shapes(graph)
    params = set(graph.param_shapes())
    out = {}
    for name, batched in region.inputs:
        shape = ((region.batch,) + sh[name]) if batched else sh[name]
        if name == graph.label_edge:
            labels = rng.randint(0, graph.loss.classes, region.batch)
            out[name] = np.eye(graph.loss.classes, dtype=np.float32)[labels]
            continue
        if name == graph.input_edge:
            scale = 1.0
        elif name in params:
            scale = 0.1
        elif name.startswith(("v_", "d_")):
            scale = 0.01
        else:  # activations
            scale = 0.5
        out[name] = (rng.randn(*shape) * scale).astype(np.float32)
    return out


def _region_cases():
    cases = []
    for batch, img in [(4, 16), (8, 32)]:
        jplan, tplan, _ = _plans(batch, img)
        regions = [(j.region, t.region) for j, t in zip(jplan.segments, tplan.segments)
                   if t.region is not None]
        for i, pair in enumerate(regions):
            cases.append(pytest.param(batch, img, pair, id=f"b{batch}-img{img}-r{i}"))
    return cases


@pytest.mark.parametrize("batch,img,pair", _region_cases())
def test_region_torch_matches_jax_region_kernel(batch, img, pair):
    jregion, tregion = pair
    graph = paper_cnn_graph(batch=batch, img=img)
    ins = _region_inputs(tregion, graph, seed=batch + img)
    want = jax.jit(jax_region_callable(jregion, interpret=True))(
        {k: jnp.asarray(v) for k, v in ins.items()}
    )
    got = fused.region_torch(tregion, {k: torch.from_numpy(v) for k, v in ins.items()})
    assert set(got) == set(want) == {n for n, _ in tregion.outputs}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_region_callable_runs_plain_version_on_cpu():
    graph = paper_cnn_graph(batch=4, img=16)
    (seg,) = plan_fusion(graph).segments
    ins = {k: torch.from_numpy(v) for k, v in _region_inputs(seg.region, graph, 0).items()}
    fused.COUNTER.reset()
    out = fused.build_region_callable(seg.region, device="cpu")(ins)
    assert fused.COUNTER.plain_calls == 1 and fused.COUNTER.launches == 0
    assert set(out) == {n for n, _ in seg.region.outputs}


# ---------------------------------------------------------------------------
# The stage tables of the CUDA kernel, emulated image by image
# ---------------------------------------------------------------------------


def _conv_cols(x, r):
    H, W, Cin, KH, KW, Cout, S, P, OH, OW = r[4:14]
    xp = np.pad(x.reshape(H, W, Cin), ((P, P), (P, P), (0, 0)))
    cols = np.stack([xp[dh:dh + (OH - 1) * S + 1:S, dw:dw + (OW - 1) * S + 1:S]
                     for dh in range(KH) for dw in range(KW)], axis=2)
    return cols.reshape(OH * OW, KH * KW * Cin)


def _conv_dx(dy, w, r):
    H, W, Cin, KH, KW, Cout, S, P, OH, OW = r[4:14]
    dy = dy.reshape(OH, OW, Cout)
    w = w.reshape(KH, KW, Cin, Cout)
    full = np.zeros((H + 2 * P + KH, W + 2 * P + KW, Cin), np.float64)
    for dh in range(KH):
        for dw in range(KW):
            full[dh:dh + (OH - 1) * S + 1:S, dw:dw + (OW - 1) * S + 1:S] += dy @ w[dh, dw].T
    return full[P:P + H, P:P + W].ravel()


def _pool_dx(x, g, r):
    H, W, C, K, OH, OW = r[4:10]
    xw = x.reshape(OH, K, OW, K, C).transpose(0, 2, 4, 1, 3).reshape(OH, OW, C, K * K)
    first = np.argmax(xw == xw.max(axis=-1, keepdims=True), axis=-1)
    dx = (np.arange(K * K) == first[..., None]) * g.reshape(OH, OW, C)[..., None]
    return dx.reshape(OH, OW, C, K, K).transpose(0, 3, 1, 4, 2).ravel()


def _one_stage(r, a, w):
    """One image's outputs of one stage record, from its operands."""
    op = r[0]
    if op == fused.OP_CONV_FWD:
        return _conv_cols(a, r) @ w.reshape(-1, r[9])
    elif op == fused.OP_CONV_DW:
        return _conv_cols(a, r).T @ w.reshape(-1, r[9])
    elif op == fused.OP_CONV_DX:
        return _conv_dx(a, w, r)
    elif op == fused.OP_MM_FWD:
        return a[:r[4]] @ w.reshape(r[4], r[5])
    elif op == fused.OP_MM_DW:
        return np.outer(a[:r[4]], w[:r[5]])
    elif op == fused.OP_MM_DX:
        return w.reshape(r[4], r[5]) @ a[:r[5]]
    elif op == fused.OP_BIAS_FWD:
        return a[:r[4]] + np.tile(w[:r[5]], r[4] // r[5])
    elif op == fused.OP_BIAS_DW:
        return a[:r[4]].reshape(-1, r[5]).sum(axis=0)
    elif op == fused.OP_COPY:
        return a[:r[4]]
    elif op == fused.OP_RELU_FWD:
        return np.maximum(a[:r[4]], 0.0)
    elif op == fused.OP_RELU_DX:
        return np.where(a[:r[4]] > 0, w[:r[4]], 0.0)
    elif op == fused.OP_POOL_FWD:
        H, W, C, K, OH, OW = r[4:10]
        return a.reshape(OH, K, OW, K, C).max(axis=(1, 3))
    elif op == fused.OP_POOL_DX:
        return _pool_dx(a, w, r)
    elif op == fused.OP_XENT_DX:
        e = np.exp(a[:r[4]] - a[:r[4]].max())
        return (e / e.sum() - w[:r[4]]) / r[5]
    else:
        raise AssertionError(f"unknown op {op}")


def _emulate(compiled, ins):
    """Run the body and epilogue tables on numpy buffers, one image at a time."""
    region = compiled.region
    B = region.batch
    arena = np.full(B * compiled.arena, np.nan, np.float32)
    store, outs = [], {}
    for buf in compiled.buffers:
        if buf.kind == "in":
            arr = np.asarray(ins[buf.name], np.float32).reshape(-1)
        elif buf.kind == "scratch":
            arr = None
        else:
            arr = np.full((B if buf.batched else 1) * buf.numel, np.nan, np.float32)
            if buf.kind == "out":
                outs[buf.name] = arr
        store.append(arr)

    def view(i, b):
        buf = compiled.buffers[i]
        if buf.kind == "scratch":
            lo = b * compiled.arena + buf.offset
            return arena[lo:lo + buf.numel]
        return store[i][b * buf.numel:(b + 1) * buf.numel] if buf.batched else store[i]

    for b in range(B):
        for s in range(compiled.n_stages):
            r = compiled.body[s * fused.REC:(s + 1) * fused.REC]
            op = r[0]
            a = view(r[1], b) if r[1] >= 0 else None
            w = view(r[2], b) if r[2] >= 0 else None
            out = view(r[3], b)
            res = _one_stage(r, a, w)
            out[:] = np.asarray(res, np.float32).ravel()

    _emulate_epilogue(compiled, store, view)
    return outs


def _emulate_epilogue(compiled, store, view):
    """The epilogue table: dW partials summed in image order, the update."""
    region = compiled.region
    for p in range(compiled.n_params):
        numel, partial, d_in, d_out, wi, vi, w_new, v_new = compiled.epilogue[
            p * fused.EPI_REC:(p + 1) * fused.EPI_REC]
        if partial >= 0:
            dw = np.zeros(numel, np.float32)
            for b in range(region.batch):
                dw += view(partial, b)[:numel]
        else:
            dw = view(d_in, 0)[:numel]
        if d_out >= 0:
            store[d_out][:numel] = dw
        if w_new >= 0:
            vn = dw
            if vi >= 0:
                vn = np.float32(region.momentum) * view(vi, 0)[:numel] + dw
                store[v_new][:numel] = vn
            store[w_new][:numel] = view(wi, 0)[:numel] - np.float32(region.lr) * vn


def _table_cases():
    cases = []
    for batch, img, spilled in [(4, 16, None), (8, 32, None), (8, 32, "jax")]:
        if spilled:
            _, tplan, _ = _plans(batch, img)
        else:
            tplan = plan_fusion(paper_cnn_graph(batch=batch, img=img))
        for i, seg in enumerate(s for s in tplan.segments if s.region is not None):
            tag = "spilled" if spilled else "nospill"
            cases.append(pytest.param(batch, img, seg.region, id=f"b{batch}-img{img}-{tag}-r{i}"))
    return cases


@pytest.mark.parametrize("batch,img,region", _table_cases())
def test_stage_tables_reproduce_region_torch(batch, img, region):
    graph = paper_cnn_graph(batch=batch, img=img)
    ins = _region_inputs(region, graph, seed=7)
    shapes = {n: ins[n].shape[1:] if b else ins[n].shape for n, b in region.inputs}
    compiled = fused.compile_region(region, shapes)
    got = _emulate(compiled, ins)
    want = fused.region_torch(region, {k: torch.from_numpy(v) for k, v in ins.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].reshape(v.shape), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _compiled(batch, img):
    graph = paper_cnn_graph(batch=batch, img=img)
    (seg,) = plan_fusion(graph).segments
    sh = _edge_shapes(graph)
    return fused.compile_region(seg.region, {n: sh[n] for n, _ in seg.region.inputs})


def _live_floats(compiled, stage):
    """Floats of the intermediates (not the staged inputs, not scratch) that
    hold a shared-memory slot at ``stage``."""
    return sum(b.numel for b in compiled.buffers
               if b.slot >= 0 and b.kind != "in" and
               compiled.live[b.name][0] <= stage <= compiled.live[b.name][1])


def test_full_width_region_scratch_arena_size():
    compiled = _compiled(64, 32)
    # the arena entry: every intermediate edge of one image (~100 KB), none of
    # the escaping ones
    assert 80_000 < 4 * compiled.arena < 120_000
    assert len(compiled.buffers) <= fused.MAX_BUFS
    assert compiled.n_params == 4 and compiled.n_stages == 20
    # the shared-memory entry: x (12 KB) and the four parameters the body
    # reads (44 KB) staged, the intermediates laid out by liveness and the
    # dW sub-sums' scratch, all in one block's shared memory
    staged = [b for b in compiled.buffers if b.mode & fused.STAGED]
    assert {b.name for b in staged} == {"x", "onehot", "w_c1", "w_c2", "w_fc", "b_fcb"}
    assert 4 * sum(b.numel for b in staged) == 56_080
    assert 4 * compiled.smem == 150_304 <= fused.MAX_SMEM - fused.SMEM_STATIC
    peak = max(_live_floats(compiled, s) for s in range(compiled.n_stages))
    # at r2's dX: d_a_r1 (written into every CTA at c2's dX) holds since c2's barrier
    assert 4 * peak == 57_344 < 4 * compiled.arena


# ---------------------------------------------------------------------------
# The shared-memory entry: layout, cluster split, route
# ---------------------------------------------------------------------------


def _slot_holders(compiled):
    """(name, first stage, last stage, offset, floats) of every shared-memory slot."""
    out = [(b.name, *compiled.live[b.name], b.slot, b.numel)
           for b in compiled.buffers if b.slot >= 0]
    for st in range(compiled.n_stages):
        rec = compiled.body[st * fused.REC:(st + 1) * fused.REC]
        if fused.stage_scratch(rec):
            out.append((f"scratch@{st}", st, st, rec[-1], fused.stage_scratch(rec)))
    return out


@pytest.mark.parametrize("batch,img,region", _table_cases())
def test_smem_layout_gives_no_two_live_buffers_one_slot(batch, img, region):
    graph = paper_cnn_graph(batch=batch, img=img)
    ins = _region_inputs(region, graph, seed=7)
    shapes = {n: ins[n].shape[1:] if b else ins[n].shape for n, b in region.inputs}
    compiled = fused.compile_region(region, shapes)
    holders = _slot_holders(compiled)
    read = {i for st in range(compiled.n_stages)
            for i in compiled.body[st * fused.REC + 1:st * fused.REC + 3] if i >= 0}
    for i, b in enumerate(compiled.buffers):
        assert bool(b.mode & fused.STAGED) == (b.kind == "in" and i in read), b.name
        assert (b.slot >= 0) == (bool(b.mode & fused.STAGED) or b.kind == "scratch"
                                 or (b.kind == "out" and b.batched)), b.name
    for name, lo, hi, off, n in holders:
        assert off % 4 == 0 and 0 <= off and off + n <= compiled.smem, name
        for name2, lo2, hi2, off2, n2 in holders:
            if name2 != name and lo <= hi2 and lo2 <= hi:
                assert off + n <= off2 or off2 + n2 <= off, (name, name2)


def _share(n, rank, c):
    return n * rank // c, n * (rank + 1) // c


def _tile_width(tasks, channels, c):
    for t in (4, 2):
        if channels % t == 0 and tasks // t // c >= fused.SMEM_THREADS:
            return t
    return 1


def _column_by_residue(j, w, s):
    for r in range(s - 1):
        n = (w - r + s - 1) // s
        if j < n:
            return r + j * s
        j -= n
    return s - 1 + j * s


def _owned(rec, n, rank, c):
    """Indices of a stage's per-image outputs that CTA ``rank`` computes."""
    op = rec[0]
    if op == fused.OP_CONV_FWD:
        cout = rec[9]
        t = _tile_width(n, cout, c)
        lo, hi = _share(n // t, rank, c)
        return np.arange(lo * t, hi * t)
    if op == fused.OP_CONV_DX:
        W, cin, S = rec[5], rec[6], rec[10]
        t = _tile_width(n, cin, c)
        lo, hi = _share(n // t, rank, c)
        tasks = np.arange(lo, hi)
        q = tasks // (cin // t)
        cols = np.array([_column_by_residue(j, W, S) for j in q % W], dtype=np.int64)
        first = ((q // W) * W + cols) * cin + tasks % (cin // t) * t
        return (first[:, None] + np.arange(t)).ravel()
    if op == fused.OP_CONV_DW:
        cout = rec[9]
        chunks = -(-rec[12] // fused.dw_rows(rec[13]))
        t = _tile_width(n * chunks, cout, c)
        lo, hi = _share(n // t, rank, c)
        return np.arange(lo * t, hi * t)
    lo, hi = _share(n, rank, c)
    return np.arange(lo, hi)


def _stage_values(rec, a, w, scratch):
    """One image's outputs of a stage from one CTA's copies; the conv dW
    sub-sums, the conv dX's copy of w and the matmul slices and tiles pass
    through the CTA's scratch."""
    op = rec[0]
    if op == fused.OP_CONV_DX:
        kh, kw, cin, cout = rec[7], rec[8], rec[6], rec[9]
        rows = scratch[:kh * kw * cout * (cin + 4)].reshape(kh * kw, cout, cin + 4)
        rows[:, :, :cin] = w.reshape(kh * kw, cin, cout).transpose(0, 2, 1)
        return _conv_dx(a, rows[:, :, :cin].transpose(0, 2, 1), rec)
    if op == fused.OP_CONV_DW:
        cols, dy = _conv_cols(a, rec), w.reshape(-1, rec[9])
        n_out = cols.shape[1] * dy.shape[1]
        step = fused.dw_rows(rec[13]) * rec[13]  # whole output rows
        chunks = -(-cols.shape[0] // step)
        for k in range(chunks):
            rows = slice(k * step, (k + 1) * step)
            scratch[k * n_out:(k + 1) * n_out] = (cols[rows].T @ dy[rows]).ravel()
        total = scratch[:n_out].copy()
        for k in range(1, chunks):
            total = total + scratch[k * n_out:(k + 1) * n_out]
        return total
    if op == fused.OP_MM_FWD:
        K, N = rec[4], rec[5]
        bk = matmul_block_k(K)
        spt = -(-bk // 8)
        n_sl = -(-K // bk) * spt
        for sl in range(n_sl):
            t = sl // spt
            k0 = t * bk + sl % spt * 8
            k1 = min(k0 + 8, (t + 1) * bk, K)
            scratch[sl * N:(sl + 1) * N] = a[k0:k1] @ w.reshape(K, N)[k0:k1] if k0 < K else 0
        tiles = n_sl // spt
        scratch[n_sl * N:(n_sl + tiles) * N] = (
            scratch[:n_sl * N].reshape(tiles, spt, N).sum(axis=1, dtype=np.float32).ravel())
        return scratch[n_sl * N:(n_sl + tiles) * N].reshape(tiles, N).sum(axis=0, dtype=np.float32)
    return None


def _emulate_cluster(compiled, ins, c, ahead=False):
    """The SMEM entry's body, CTA by CTA: each CTA of an image's cluster has
    its own shared memory; a broadcast stage's share goes into every CTA's,
    a partial stage's share to device memory, the other stages run whole on
    the CTA's copy. Between two cluster barriers the CTAs run one after the
    other (the last first with ``ahead``), so a peer that writes too early
    into a slot another CTA still reads shows up in the results."""
    region = compiled.region
    B = region.batch
    bufs = compiled.buffers
    recs = [compiled.body[st * fused.REC:(st + 1) * fused.REC] for st in range(compiled.n_stages)]
    store, outs = [], {}
    for buf in bufs:
        if buf.kind == "in":
            arr = np.asarray(ins[buf.name], np.float32).reshape(-1)
        elif buf.kind in ("out", "partial"):
            arr = np.full((B if buf.batched else 1) * buf.numel, np.nan, np.float32)
            if buf.kind == "out":
                outs[buf.name] = arr
        else:
            arr = None
        store.append(arr)

    def view(i, b):
        buf = bufs[i]
        return store[i][b * buf.numel:(b + 1) * buf.numel] if buf.batched else store[i]

    epochs, cur = [], []
    for st, rec in enumerate(recs):
        cur.append(st)
        if rec[0] in fused.BROADCAST_OPS:
            epochs.append(cur)
            cur = []
    epochs.append(cur)
    for b in range(B):
        sm = [np.full(compiled.smem, np.nan, np.float32) for _ in range(c)]
        for mem in sm:
            for i, buf in enumerate(bufs):
                if buf.mode & fused.STAGED:
                    mem[buf.slot:buf.slot + buf.numel] = view(i, b)
        for epoch in epochs:
            for rank in (range(c - 1, -1, -1) if ahead else range(c)):
                mem = sm[rank]
                for st in epoch:
                    rec = recs[st]
                    op, oi = rec[0], rec[3]
                    a, w = (mem[bufs[i].slot:bufs[i].slot + bufs[i].numel] if i >= 0 else None
                            for i in rec[1:3])
                    out = bufs[oi]
                    vals = _stage_values(rec, a, w, mem[rec[-1]:])
                    if vals is None:  # the arena emulation's math on this CTA's copies
                        vals = _one_stage(rec, a, w)
                    vals = np.asarray(vals, np.float32).ravel()
                    own = _owned(rec, out.numel, rank, c)
                    if op in fused.BROADCAST_OPS:
                        for peer in sm:
                            peer[out.slot + own] = vals[own]
                    elif op in fused.PARTIAL_OPS:
                        view(oi, b)[own] = vals[own]
                        continue
                    else:
                        mem[out.slot:out.slot + out.numel] = vals
                    if out.mode & fused.ESCAPES:
                        view(oi, b)[own] = vals[own]
    _emulate_epilogue(compiled, store, view)
    return outs


@pytest.mark.parametrize("batch,img,region", _table_cases())
def test_cluster_split_gives_the_same_results_for_every_cluster_size(batch, img, region):
    graph = paper_cnn_graph(batch=batch, img=img)
    ins = _region_inputs(region, graph, seed=7)
    shapes = {n: ins[n].shape[1:] if b else ins[n].shape for n, b in region.inputs}
    compiled = fused.compile_region(region, shapes)
    want = fused.region_torch(region, {k: torch.from_numpy(v) for k, v in ins.items()})
    first = None
    for c in fused.CLUSTER_SIZES:
        for ahead in (False, True):
            got = _emulate_cluster(compiled, ins, c, ahead)
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k].reshape(v.shape), v.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=f"C {c}: {k}")
            if first is None:
                first = got
            for k in got:
                np.testing.assert_array_equal(got[k], first[k], err_msg=f"C {c}: {k}")


@pytest.mark.parametrize("batch,img,cluster", [(64, 32, 2), (16, 32, 8), (4, 16, 8)])
def test_shape_route_picks_the_smem_entry(batch, img, cluster):
    compiled = _compiled(batch, img)
    assert fused.entry(compiled) == fused.SMEM
    every_sm = {c: 132 // c for c in (8, 4, 2)}  # B * C <= 132
    assert fused.cluster_size(batch, every_sm) == cluster and batch * cluster <= 132
    assert fused.cluster_size(200, every_sm) == 1
    # the H100 runs 15 clusters of 8 at once at this shared memory: batch 16
    # takes clusters of 4 (a cluster's CTAs share one GPC)
    active = {8: 15, 4: 30, 2: 66}
    assert fused.cluster_size(batch, active) == {64: 2, 16: 4, 4: 8}[batch]


def test_shape_route_sends_what_does_not_fit_to_the_arena_entry():
    compiled = _compiled(8, 64)  # 64 x 64 images: a 64 KB conv output alone
    assert 4 * compiled.smem > fused.MAX_SMEM
    assert fused.entry(compiled) == fused.ARENA


# ---------------------------------------------------------------------------
# Max-pool ties: the gradient goes to the FIRST maximal tap, exactly
# ---------------------------------------------------------------------------


def _jax_pool_vjp(x, g):
    def pool(x):
        return jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID"
        )

    _, vjp = jax.vjp(pool, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _tie_case():
    x = np.ones((2, 4, 4, 2), np.float32)  # every window is all-ties
    g = np.random.RandomState(0).randn(2, 2, 2, 2).astype(np.float32)
    return x, g


def _pool_region(spec, batch):
    st = Stage(node="p1", pass_="dx", spec=spec, in_edge="x", out_edge="a_p1")
    return RegionSpec(stages=(st,), batch=batch, lr=0.05, momentum=0.0,
                      inputs=(("x", True), ("d_a_p1", True)),
                      outputs=(("d_x", "batched"),))


@pytest.mark.parametrize("route", ["region_torch", "per_node", "stage_table"])
def test_maxpool_tie_breaking_matches_xla(route):
    x, g = _tie_case()
    spec = MaxPool2dSpec(4, 4, 2)
    want = _jax_pool_vjp(x, g)
    if route == "per_node":
        plan = _plan_callable(spec, "dx", torch.device("cpu"))
        got = plan({"x": torch.from_numpy(x), "dy": torch.from_numpy(g)})["dx"].numpy()
    else:
        region = _pool_region(spec, batch=2)
        ins = {"x": x, "d_a_p1": g}
        if route == "region_torch":
            tins = {k: torch.from_numpy(v) for k, v in ins.items()}
            got = fused.region_torch(region, tins)["d_x"].numpy()
        else:
            compiled = fused.compile_region(region, {"x": (4, 4, 2), "d_a_p1": (2, 2, 2)})
            got = _emulate(compiled, ins)["d_x"].reshape(x.shape)
    np.testing.assert_allclose(got, want, atol=0, rtol=0)


def test_maxpool_partial_ties_match_xla():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 3, (3, 8, 8, 4)).astype(np.float32)  # many plateaus
    g = rng.randn(3, 4, 4, 4).astype(np.float32)
    want = _jax_pool_vjp(x, g)
    spec = MaxPool2dSpec(8, 8, 4)
    got = fused.pool_dx(torch.from_numpy(x), torch.from_numpy(g), spec).numpy()
    np.testing.assert_allclose(got, want, atol=0, rtol=0)

