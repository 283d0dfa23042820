"""Lowering rules: layer specs -> :class:`~repro_torch.lower.ir.NtxProgram`
(``repro/lower/rules.py``, the CNN rule set).

One rule per (layer type, pass). Every rule goes through the same loop-nest
builder: order the iteration dims innermost-first as

    reduction dims  ++  output dims

give each AGU its per-dim element stride (eq. 1), and split the nest at the
design point's hardware-loop budget: the inner dims become the command
template, the outer dims the driver's replication loops (Table 2's offload
counts fall out of this split). A design without an autonomous write-back
AGU (NS) offloads at most the reduction dims: every output pixel is its own
command.

The conv backward rules are the §3.2 decomposition at the command level:
the weight gradient is one dense correlation block; the input gradient is
s*s phase blocks, each a dense correlation of a zero-padded ``dy`` with the
(spatially flipped) filter-tap subset of that phase — the flip and the
subset are AGU striding (negative strides), and the zero padding is staged
in-band with ``memset`` / ``copy`` commands.

The spec dataclasses key the plan cache and the region compilations, so
they stay frozen and hashable. The LM specs (attention, layernorm, residual
add, embedding, positional embedding) and their lowerings are not ported
yet (ROADMAP A5): :func:`lower` raises ``TypeError`` for them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.ntx import MAX_LOOPS, Agu, ConvShape, NtxCommand
from repro_torch.core.tiling import plan_matmul_tiles, plan_stencil_tiles
from repro_torch.lower.ir import (
    ELEM_BYTES,
    CommandBlock,
    DesignPoint,
    NTX_DESIGN,
    NtxProgram,
    RegionAllocator,
    TensorRegion,
)

PASSES = ("fwd", "dw", "dx")


# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MatmulSpec:
    """C[m,n] = A[m,k] @ B[k,n] (row major). dw = A^T dY, dx = dY B^T."""

    m: int
    n: int
    k: int


@dataclass(frozen=True)
class Conv2dSpec:
    """One conv layer per image: NHWC x HWIO -> NHWC with N=1."""

    in_h: int
    in_w: int
    cin: int
    kh: int
    kw: int
    cout: int
    stride: int = 1
    padding: int = 0

    @property
    def out_h(self) -> int:
        return (self.in_h + 2 * self.padding - self.kh) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w + 2 * self.padding - self.kw) // self.stride + 1

    def conv_shape(self) -> ConvShape:
        """The paper's Table 2 view of this layer (``offload_count`` input)."""
        return ConvShape(
            kw=self.kw, kh=self.kh, cin=self.cin,
            out_w=self.out_w, out_h=self.out_h, cout=self.cout,
        )


@dataclass(frozen=True)
class MaxPool2dSpec:
    in_h: int
    in_w: int
    c: int
    window: int = 2
    stride: int = 2

    @property
    def out_h(self) -> int:
        return (self.in_h - self.window) // self.stride + 1

    @property
    def out_w(self) -> int:
        return (self.in_w - self.window) // self.stride + 1


@dataclass(frozen=True)
class ReluSpec:
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class FlattenSpec:
    """A zero-copy reshape to 1-D per item."""

    in_shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.in_shape)


@dataclass(frozen=True)
class BiasSpec:
    """y[r, c] = x[r, c] + b[c] over ``rows`` broadcast rows (rows folds
    batch and any spatial extent). db reduces dy over the rows."""

    rows: int
    c: int


@dataclass(frozen=True)
class SoftmaxXentSpec:
    """Softmax-cross-entropy over (batch, classes) logits; only the gradient
    pass runs: dz = (softmax(z) - onehot) / batch."""

    batch: int
    classes: int


@dataclass(frozen=True)
class SgdUpdateSpec:
    """SGD weight update over a flat parameter of ``n`` elements:
    v_new = momentum * v + dW, w_new = w - lr * v_new (v_new = dW without
    momentum)."""

    n: int
    lr: float
    momentum: float = 0.0


# ---------------------------------------------------------------------------
# The shared loop-nest splitter
# ---------------------------------------------------------------------------


def _pad5(xs: tuple[int, ...], fill: int) -> tuple[int, ...]:
    return tuple(xs) + (fill,) * (MAX_LOOPS - len(xs))


def _nest_block(
    sizes: tuple[int, ...],
    n_red: int,
    rd0: tuple[int, tuple[int, ...]],
    rd1: tuple[int, tuple[int, ...]] | None,
    wr: tuple[int, tuple[int, ...]],
    design: DesignPoint,
    *,
    opcode: str = "mac",
    tag: str,
    reads: tuple[TensorRegion, ...],
    writes: tuple[TensorRegion, ...],
    init_value: float = 0.0,
    tile=None,
) -> CommandBlock:
    """Split an iteration nest at the design point's hardware-loop budget.

    ``sizes`` is the full nest innermost-first (reduction dims leading);
    ``rd0``/``rd1``/``wr`` are (base, per-dim element strides) over the same
    ordering. Dims beyond the budget become driver replication loops.
    """
    usable = min(design.hw_loops, len(sizes))
    if not design.autonomous_writeback:
        usable = min(usable, n_red)
    if usable < n_red:
        raise NotImplementedError(
            f"{tag}: {n_red} reduction dims exceed the {design.name} design's "
            f"{usable} offloadable loops — the driver would have to accumulate"
        )

    def split(agu):
        if agu is None:
            return None, ()
        base, strides = agu
        hw = Agu(base, _pad5(tuple(strides[:usable]), 0))
        return hw, tuple(strides[usable:])

    a0, s0 = split(rd0)
    a1, s1 = split(rd1)
    aw, sw = split(wr)
    template = NtxCommand(
        loops=_pad5(tuple(sizes[:usable]), 1),
        opcode=opcode,
        agu_rd0=a0,
        agu_rd1=a1,
        agu_wr=aw,
        init_level=n_red,
        store_level=n_red,
        init_value=init_value,
    )
    reps = tuple(sizes[usable:])
    n_cmds = math.prod(reps) if reps else 1
    bytes_in = sum(r.bytes for r in reads) / n_cmds
    bytes_out = sum(r.bytes for r in writes) / n_cmds
    return CommandBlock(
        template=template,
        reps=reps,
        rd0_step=s0,
        rd1_step=s1 if rd1 is not None else (0,) * len(reps),
        wr_step=sw,
        tag=tag,
        reads=tuple(r.name for r in reads),
        writes=tuple(r.name for r in writes),
        dma_bytes_in=bytes_in,
        dma_bytes_out=bytes_out,
        tile=tile,
    )


# ---------------------------------------------------------------------------
# In-band staging blits (zero padding as memset + copy commands)
# ---------------------------------------------------------------------------


def _memset_block(dst: TensorRegion, value: float = 0.0) -> CommandBlock:
    return CommandBlock(
        template=NtxCommand(
            loops=(dst.size, 1, 1, 1, 1),
            opcode="memset",
            agu_rd0=Agu(dst.base, (0,) * MAX_LOOPS),
            agu_wr=Agu(dst.base, _pad5((1,), 0)),
            init_level=0,
            store_level=0,
            init_value=value,
        ),
        tag=f"memset:{dst.name}",
        writes=(dst.name,),
        dma_bytes_out=float(dst.bytes),
    )


def _memset_at(dst: TensorRegion, off: int, value: float) -> CommandBlock:
    """Stage one scalar constant in-band (a single-element memset)."""
    return CommandBlock(
        template=NtxCommand(
            loops=(1, 1, 1, 1, 1),
            opcode="memset",
            agu_rd0=Agu(dst.base + off, (0,) * MAX_LOOPS),
            agu_wr=Agu(dst.base + off, (0,) * MAX_LOOPS),
            init_level=0,
            store_level=0,
            init_value=value,
        ),
        tag=f"memset:{dst.name}[{off}]",
        writes=(dst.name,),
        dma_bytes_out=float(ELEM_BYTES),
    )


def _copy_block(
    src: TensorRegion,
    dst: TensorRegion,
    *,
    rows: int,
    row_elems: int,
    src_row_stride: int,
    dst_row_stride: int,
    src_off: int = 0,
    dst_off: int = 0,
    tag: str = "",
) -> CommandBlock:
    return CommandBlock(
        template=NtxCommand(
            loops=(row_elems, rows, 1, 1, 1),
            opcode="copy",
            agu_rd0=Agu(src.base + src_off, _pad5((1, src_row_stride), 0)),
            agu_wr=Agu(dst.base + dst_off, _pad5((1, dst_row_stride), 0)),
            init_level=0,
            store_level=0,
        ),
        tag=tag or f"copy:{src.name}->{dst.name}",
        reads=(src.name,),
        writes=(dst.name,),
        dma_bytes_in=float(rows * row_elems * ELEM_BYTES),
        dma_bytes_out=float(rows * row_elems * ELEM_BYTES),
    )


def _padded_plane(
    alloc: RegionAllocator,
    src: TensorRegion,
    *,
    h: int,
    w: int,
    c: int,
    pad: int,
    name: str,
) -> tuple[TensorRegion, list[CommandBlock]]:
    """Zero-padded copy of an (h, w, c) plane, staged with memset + copy."""
    if pad == 0:
        return src, []
    hp, wp = h + 2 * pad, w + 2 * pad
    dst = alloc.alloc(name, (hp, wp, c), "scratch")
    blocks = [
        _memset_block(dst),
        _copy_block(
            src,
            dst,
            rows=h,
            row_elems=w * c,
            src_row_stride=w * c,
            dst_row_stride=wp * c,
            dst_off=(pad * wp + pad) * c,
        ),
    ]
    return dst, blocks


# ---------------------------------------------------------------------------
# Matmul rules (fwd / dw / dx)
# ---------------------------------------------------------------------------


def matmul_nest(
    m: int, n: int, k: int, pass_: str, a_base: int, b_base: int, c_base: int
):
    """(sizes, n_red, rd0, rd1, wr) for one matmul pass at explicit bases.

    ``a``/``b``/``c`` are the *roles* of the three operands for the pass:
    fwd reads (A, B) writes C; dw reads (A, dY) writes dW; dx reads (dY, B)
    writes dX. Transposes are pure AGU striding — no data movement.
    """
    if pass_ == "fwd":
        # C[i2,i1] += A[i2,i0] * B[i0,i1];  dims (k, n, m)
        return (
            (k, n, m), 1,
            (a_base, (1, 0, k)),
            (b_base, (n, 1, 0)),
            (c_base, (0, 1, n)),
        )
    if pass_ == "dw":
        # dW[i2,i1] += A[i0,i2] * dY[i0,i1];  dims (m, n, k)
        return (
            (m, n, k), 1,
            (a_base, (k, 0, 1)),
            (b_base, (n, 1, 0)),
            (c_base, (0, 1, n)),
        )
    if pass_ == "dx":
        # dX[i2,i1] += dY[i2,i0] * B[i1,i0];  dims (n, k, m)
        return (
            (n, k, m), 1,
            (a_base, (1, 0, n)),
            (b_base, (1, n, 0)),
            (c_base, (0, 1, k)),
        )
    raise ValueError(f"unknown matmul pass {pass_!r}; expected one of {PASSES}")


def matmul_template(
    m: int, n: int, k: int, a_base: int, b_base: int, c_base: int
) -> NtxCommand:
    """The single-command NTX matmul at explicit TCDM bases (fwd pass)."""
    sizes, n_red, rd0, rd1, wr = matmul_nest(m, n, k, "fwd", a_base, b_base, c_base)
    return NtxCommand(
        loops=_pad5(sizes, 1),
        opcode="mac",
        agu_rd0=Agu(rd0[0], _pad5(rd0[1], 0)),
        agu_rd1=Agu(rd1[0], _pad5(rd1[1], 0)),
        agu_wr=Agu(wr[0], _pad5(wr[1], 0)),
        init_level=n_red,
        store_level=n_red,
    )


def _lower_matmul(spec: MatmulSpec, pass_: str, design: DesignPoint) -> NtxProgram:
    m, n, k = spec.m, spec.n, spec.k
    alloc = RegionAllocator()
    if pass_ == "fwd":
        ra = alloc.alloc("a", (m, k), "input")
        rb = alloc.alloc("b", (k, n), "param")
        rc = alloc.alloc("c", (m, n), "output")
    elif pass_ == "dw":
        ra = alloc.alloc("a", (m, k), "input")
        rb = alloc.alloc("dy", (m, n), "input")
        rc = alloc.alloc("dw", (k, n), "output")
    elif pass_ == "dx":
        ra = alloc.alloc("dy", (m, n), "input")
        rb = alloc.alloc("b", (k, n), "param")
        rc = alloc.alloc("dx", (m, k), "output")
    else:
        raise ValueError(f"unknown matmul pass {pass_!r}; expected one of {PASSES}")
    sizes, n_red, rd0, rd1, wr = matmul_nest(m, n, k, pass_, ra.base, rb.base, rc.base)
    plan = plan_matmul_tiles(m, n, k, in_dtype_bytes=ELEM_BYTES)
    block = _nest_block(
        sizes, n_red, rd0, rd1, wr, design,
        tag=f"matmul:{pass_}", reads=(ra, rb), writes=(rc,), tile=plan,
    )
    return NtxProgram(
        name=f"matmul{m}x{n}x{k}:{pass_}",
        blocks=[block],
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": pass_, "plan": plan},
    )


# ---------------------------------------------------------------------------
# Conv2d rules (fwd / dw / dx)
# ---------------------------------------------------------------------------


def _conv_plan(spec: Conv2dSpec):
    return plan_stencil_tiles(
        spec.out_h, spec.out_w, spec.cin, spec.cout, spec.kh, spec.kw,
        dtype_bytes=ELEM_BYTES,
    )


def _lower_conv_fwd(spec: Conv2dSpec, design: DesignPoint) -> NtxProgram:
    s, p = spec.stride, spec.padding
    oh, ow = spec.out_h, spec.out_w
    alloc = RegionAllocator()
    rx = alloc.alloc("x", (spec.in_h, spec.in_w, spec.cin), "input")
    rw = alloc.alloc("w", (spec.kh, spec.kw, spec.cin, spec.cout), "param")
    ry = alloc.alloc("y", (oh, ow, spec.cout), "output")
    xp, staging = _padded_plane(
        alloc, rx, h=spec.in_h, w=spec.in_w, c=spec.cin, pad=p, name="x_pad"
    )
    iw = spec.in_w + 2 * p  # padded row pitch
    cin, kw, kh, cout = spec.cin, spec.kw, spec.kh, spec.cout
    block = _nest_block(
        (cin, kw, kh, ow, oh, cout), 3,
        (xp.base, (1, cin, iw * cin, s * cin, s * iw * cin, 0)),
        (rw.base, (cout, cin * cout, kw * cin * cout, 0, 0, 1)),
        (ry.base, (0, 0, 0, cout, ow * cout, 1)),
        design,
        tag="conv2d:fwd", reads=(xp, rw), writes=(ry,), tile=_conv_plan(spec),
    )
    return NtxProgram(
        name=f"conv{spec.kh}x{spec.kw}x{cin}->{oh}x{ow}x{cout}:fwd",
        blocks=staging + [block],
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "fwd", "plan": block.tile},
    )


def conv2d_fwd_template(
    in_h: int, in_w: int, cin: int, kh: int, kw: int, cout: int,
    x_base: int, w_base: int, y_base: int, stride: int = 1,
) -> NtxCommand:
    """The NTX conv-forward command template at explicit TCDM bases.

    With ``cout=1`` this is the single-output-channel command (HWI-
    contiguous weights, one full output plane per offload).
    """
    oh = (in_h - kh) // stride + 1
    ow = (in_w - kw) // stride + 1
    return NtxCommand(
        loops=(cin, kw, kh, ow, oh),
        opcode="mac",
        agu_rd0=Agu(x_base, (1, cin, in_w * cin, stride * cin, stride * in_w * cin)),
        agu_rd1=Agu(w_base, (cout, cin * cout, kw * cin * cout, 0, 0)),
        agu_wr=Agu(y_base, (0, 0, 0, cout, ow * cout)),
        init_level=3,
        store_level=3,
    )


def _lower_conv_dw(spec: Conv2dSpec, design: DesignPoint) -> NtxProgram:
    s, p = spec.stride, spec.padding
    oh, ow = spec.out_h, spec.out_w
    alloc = RegionAllocator()
    rx = alloc.alloc("x", (spec.in_h, spec.in_w, spec.cin), "input")
    rdy = alloc.alloc("dy", (oh, ow, spec.cout), "input")
    rdw = alloc.alloc("dw", (spec.kh, spec.kw, spec.cin, spec.cout), "output")
    xp, staging = _padded_plane(
        alloc, rx, h=spec.in_h, w=spec.in_w, c=spec.cin, pad=p, name="x_pad"
    )
    iw = spec.in_w + 2 * p
    cin, kw, kh, cout = spec.cin, spec.kw, spec.kh, spec.cout
    # dW[u,v,ci,co] += x_pad[s*ohi+u, s*owi+v, ci] * dy[ohi, owi, co]
    # dims innermost-first: (owi, ohi | ci, v, u, co)
    block = _nest_block(
        (ow, oh, cin, kw, kh, cout), 2,
        (xp.base, (s * cin, s * iw * cin, 1, cin, iw * cin, 0)),
        (rdy.base, (cout, ow * cout, 0, 0, 0, 1)),
        (rdw.base, (0, 0, cout, cin * cout, kw * cin * cout, 1)),
        design,
        tag="conv2d:dw", reads=(xp, rdy), writes=(rdw,), tile=_conv_plan(spec),
    )
    return NtxProgram(
        name=f"conv{kh}x{kw}x{cin}->{oh}x{ow}x{cout}:dw",
        blocks=staging + [block],
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "dw", "plan": block.tile},
    )


def _lower_conv_dx(spec: Conv2dSpec, design: DesignPoint) -> NtxProgram:
    """§3.2 / Fig. 6: s*s dense phase convolutions over zero-padded dy.

    Phase (a, b) collects the input pixels (i, j) with (i+p) % s == a etc.;
    only the filter taps congruent to the phase ever touch them, so each
    phase is a *dense* stride-1 correlation — constant MACs per pixel, one
    command block per phase (driver reps over cin). The tap subset and the
    spatial flip are encoded as negative AGU strides into the original
    weights; the zero padding of dy is staged in-band (memset + copy).
    """
    s, p = spec.stride, spec.padding
    oh, ow = spec.out_h, spec.out_w
    xh, xw = spec.in_h, spec.in_w
    cin, kw, kh, cout = spec.cin, spec.kw, spec.kh, spec.cout
    alloc = RegionAllocator()
    rdy = alloc.alloc("dy", (oh, ow, cout), "input")
    rw = alloc.alloc("w", (kh, kw, cin, cout), "param")
    rdx = alloc.alloc("dx", (xh, xw, cin), "output")

    blocks: list[CommandBlock] = []
    n_phases = 0
    for a in range(s):
        ta = len(range(a, kh, s))
        if ta == 0:
            continue
        for b in range(s):
            tb = len(range(b, kw, s))
            if tb == 0:
                continue
            i0 = (a - p) % s
            j0 = (b - p) % s
            na = len(range(i0, xh, s))
            nb = len(range(j0, xw, s))
            if na == 0 or nb == 0:
                continue
            ii0 = (i0 + p - a) // s
            jj0 = (j0 + p - b) // s
            # dy staged zero-padded: taps reach ta-1 rows above the first dy
            # row and the last phase pixel reaches ii0 + na - 1 + ta - 1.
            pt, pl = ta - 1, tb - 1
            hp = max(pt + oh, ii0 + na + ta - 1)
            wp = max(pl + ow, jj0 + nb + tb - 1)
            if (hp, wp) == (oh, ow):
                dyp, staging = rdy, []
            else:
                dyp = alloc.alloc(f"dy_pad{a}{b}", (hp, wp, cout), "scratch")
                staging = [
                    _memset_block(dyp),
                    _copy_block(
                        rdy, dyp,
                        rows=oh, row_elems=ow * cout,
                        src_row_stride=ow * cout, dst_row_stride=wp * cout,
                        dst_off=(pt * wp + pl) * cout,
                        tag=f"copy:dy->dy_pad{a}{b}",
                    ),
                ]
            blocks += staging
            # dx[i0+s*qi, j0+s*qj, ci] +=
            #   dy_pad[ii0+qi+ti, jj0+qj+tj, co] * w[a+s*(ta-1-ti), b+s*(tb-1-tj), ci, co]
            # dims innermost-first: (co, tj, ti | qj, qi, ci)
            u0 = a + s * (ta - 1)
            v0 = b + s * (tb - 1)
            blocks.append(
                _nest_block(
                    (cout, tb, ta, nb, na, cin), 3,
                    (
                        # dy_pad row r holds dy row r - pt; phase pixel qi
                        # reads rows (ii0 + qi) + ti of the padded plane.
                        dyp.base + (ii0 * wp + jj0) * cout,
                        (1, cout, wp * cout, cout, wp * cout, 0),
                    ),
                    (
                        rw.base + (u0 * kw + v0) * cin * cout,
                        (1, -s * cin * cout, -s * kw * cin * cout, 0, 0, cout),
                    ),
                    (
                        rdx.base + (i0 * xw + j0) * cin,
                        (0, 0, 0, s * cin, s * xw * cin, 1),
                    ),
                    design,
                    tag=f"conv2d:dx[{a},{b}]",
                    reads=(dyp, rw), writes=(rdx,), tile=_conv_plan(spec),
                )
            )
            n_phases += 1
    return NtxProgram(
        name=f"conv{kh}x{kw}x{cin}->{oh}x{ow}x{cout}:dx",
        blocks=blocks,
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "dx", "n_phases": n_phases,
              "plan": _conv_plan(spec)},
    )


# ---------------------------------------------------------------------------
# Pooling / ReLU rules
# ---------------------------------------------------------------------------


def _lower_maxpool(spec: MaxPool2dSpec, design: DesignPoint) -> NtxProgram:
    s, ww = spec.stride, spec.window
    oh, ow, c = spec.out_h, spec.out_w, spec.c
    iw = spec.in_w
    alloc = RegionAllocator()
    rx = alloc.alloc("x", (spec.in_h, spec.in_w, c), "input")
    ry = alloc.alloc("y", (oh, ow, c), "output")
    # y[i3,i2,i4] = max over (i1,i0) of x[s*i3+i1, s*i2+i0, i4]
    block = _nest_block(
        (ww, ww, ow, oh, c), 2,
        (rx.base, (c, iw * c, s * c, s * iw * c, 1)),
        None,
        (ry.base, (0, 0, c, ow * c, 1)),
        design,
        opcode="vmax",
        tag="maxpool:fwd", reads=(rx,), writes=(ry,),
    )
    return NtxProgram(
        name=f"maxpool{ww}x{ww}s{s}:{oh}x{ow}x{c}:fwd",
        blocks=[block],
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "fwd"},
    )


def _lower_relu(spec: ReluSpec, design: DesignPoint) -> NtxProgram:
    alloc = RegionAllocator()
    rx = alloc.alloc("x", spec.shape, "input")
    ry = alloc.alloc("y", spec.shape, "output")
    block = _nest_block(
        (spec.size,), 0,
        (rx.base, (1,)),
        None,
        (ry.base, (1,)),
        design,
        opcode="relu",
        tag="relu:fwd", reads=(rx,), writes=(ry,),
    )
    return NtxProgram(
        name=f"relu{spec.size}:fwd",
        blocks=[block],
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "fwd"},
    )


def relu_dx_blocks(
    x: TensorRegion,
    dy: TensorRegion,
    mask: TensorRegion,
    dx: TensorRegion,
    design: DesignPoint,
    *,
    tag: str = "relu:dx",
) -> list[CommandBlock]:
    """dX = dY * (x > 0): the sign/select mask pattern at explicit regions.

    Two streaming blocks: a ``sign`` pass turns the forward input into a
    0/1 mask, a ``vmul`` pass gates the incoming gradient through it.
    """
    n = x.size
    return [
        _nest_block(
            (n,), 0,
            (x.base, (1,)), None, (mask.base, (1,)),
            design, opcode="sign", tag=f"{tag}:mask",
            reads=(x,), writes=(mask,),
        ),
        _nest_block(
            (n,), 0,
            (mask.base, (1,)), (dy.base, (1,)), (dx.base, (1,)),
            design, opcode="vmul", tag=tag,
            reads=(mask, dy), writes=(dx,),
        ),
    ]


def _lower_relu_dx(spec: ReluSpec, design: DesignPoint) -> NtxProgram:
    alloc = RegionAllocator()
    rx = alloc.alloc("x", spec.shape, "input")
    rdy = alloc.alloc("dy", spec.shape, "input")
    rm = alloc.alloc("mask", spec.shape, "scratch")
    rdx = alloc.alloc("dx", spec.shape, "output")
    return NtxProgram(
        name=f"relu{spec.size}:dx",
        blocks=relu_dx_blocks(rx, rdy, rm, rdx, design),
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "dx"},
    )


def maxpool_dx_blocks(
    spec: MaxPool2dSpec,
    x: TensorRegion,
    y: TensorRegion,
    dy: TensorRegion,
    mask: TensorRegion,
    dx: TensorRegion,
    design: DesignPoint,
    *,
    tag: str = "maxpool:dx",
) -> list[CommandBlock]:
    """Max-pool backward as the argmax-mask scatter, staged per window tap.

    For non-overlapping pooling every input pixel belongs to exactly one
    window, so the scatter is affine: per window tap (a, b), a ``cmpge``
    block recomputes the winner mask (x strided at the tap vs the pooled
    max), and a ``vmul`` block routes dY through it into the strided dX
    positions. The leading memset zeroes remainder pixels no window covers.
    Ties route the gradient to every winning tap (an autodiff oracle picks one;
    with continuous inputs the two agree).
    """
    s, ww = spec.stride, spec.window
    if ww != s:
        raise NotImplementedError(
            "maxpool dX lowers only for non-overlapping pooling "
            f"(window == stride); got window={ww} stride={s}"
        )
    oh, ow, c = spec.out_h, spec.out_w, spec.c
    iw = spec.in_w
    blocks = [_memset_block(dx)]
    for a in range(ww):
        for b in range(ww):
            off = (a * iw + b) * c
            blocks.append(
                _nest_block(
                    (c, ow, oh), 0,
                    (x.base + off, (1, s * c, s * iw * c)),
                    (y.base, (1, c, ow * c)),
                    (mask.base, (1, c, ow * c)),
                    design, opcode="cmpge", tag=f"{tag}:mask[{a},{b}]",
                    reads=(x, y), writes=(mask,),
                )
            )
            blocks.append(
                _nest_block(
                    (c, ow, oh), 0,
                    (mask.base, (1, c, ow * c)),
                    (dy.base, (1, c, ow * c)),
                    (dx.base + off, (1, s * c, s * iw * c)),
                    design, opcode="vmul", tag=f"{tag}[{a},{b}]",
                    reads=(mask, dy), writes=(dx,),
                )
            )
    return blocks


def _lower_maxpool_dx(spec: MaxPool2dSpec, design: DesignPoint) -> NtxProgram:
    oh, ow, c = spec.out_h, spec.out_w, spec.c
    alloc = RegionAllocator()
    rx = alloc.alloc("x", (spec.in_h, spec.in_w, c), "input")
    ry = alloc.alloc("y", (oh, ow, c), "input")
    rdy = alloc.alloc("dy", (oh, ow, c), "input")
    rm = alloc.alloc("mask", (oh, ow, c), "scratch")
    rdx = alloc.alloc("dx", (spec.in_h, spec.in_w, c), "output")
    return NtxProgram(
        name=f"maxpool{spec.window}x{spec.window}s{spec.stride}:{oh}x{ow}x{c}:dx",
        blocks=maxpool_dx_blocks(spec, rx, ry, rdy, rm, rdx, design),
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "dx"},
    )


# ---------------------------------------------------------------------------
# Bias rules (fwd / dw / dx)
# ---------------------------------------------------------------------------


def _lower_bias(spec: BiasSpec, pass_: str, design: DesignPoint) -> NtxProgram:
    rows, c = spec.rows, spec.c
    alloc = RegionAllocator()
    if pass_ == "fwd":
        rx = alloc.alloc("x", (rows, c), "input")
        rb = alloc.alloc("b", (c,), "param")
        ry = alloc.alloc("y", (rows, c), "output")
        blocks = [
            _nest_block(
                (c, rows), 0,
                (rx.base, (1, c)), (rb.base, (1, 0)), (ry.base, (1, c)),
                design, opcode="vadd", tag="bias:fwd",
                reads=(rx, rb), writes=(ry,),
            )
        ]
    elif pass_ == "dw":
        rdy = alloc.alloc("dy", (rows, c), "input")
        rone = alloc.alloc("one", (1,), "scratch")
        rdb = alloc.alloc("db", (c,), "output")
        blocks = [
            _memset_at(rone, 0, 1.0),
            # db[ch] = sum_rows dy[row, ch] — a MAC against the staged 1.0
            _nest_block(
                (rows, c), 1,
                (rdy.base, (c, 1)), (rone.base, (0, 0)), (rdb.base, (0, 1)),
                design, opcode="mac", tag="bias:dw",
                reads=(rdy, rone), writes=(rdb,),
            ),
        ]
    elif pass_ == "dx":
        rdy = alloc.alloc("dy", (rows, c), "input")
        rdx = alloc.alloc("dx", (rows, c), "output")
        blocks = [
            _nest_block(
                (rows * c,), 0,
                (rdy.base, (1,)), None, (rdx.base, (1,)),
                design, opcode="copy", tag="bias:dx",
                reads=(rdy,), writes=(rdx,),
            )
        ]
    else:
        raise ValueError(f"unknown bias pass {pass_!r}; expected one of {PASSES}")
    return NtxProgram(
        name=f"bias{rows}x{c}:{pass_}",
        blocks=blocks,
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": pass_},
    )


# ---------------------------------------------------------------------------
# Softmax-cross-entropy gradient (the loss node's backward rule)
# ---------------------------------------------------------------------------


def softmax_xent_grad_blocks(
    spec: SoftmaxXentSpec,
    z: TensorRegion,
    onehot: TensorRegion,
    dz: TensorRegion,
    scratch: dict[str, TensorRegion],
    design: DesignPoint,
    *,
    tag: str = "softmax_xent:dx",
) -> list[CommandBlock]:
    """dz = (softmax(z) - onehot) / B, staged entirely in-band.

    ``scratch`` must hold regions ``m``/``negm``/``s``/``r`` shaped (B,),
    ``zc``/``e``/``p``/``pb``/``ohb`` shaped (B, C), and a 4-element
    ``consts`` region. The max-subtraction keeps exp in range exactly like
    the numerically-stable softmax.
    """
    B, C = spec.batch, spec.classes
    m, negm = scratch["m"], scratch["negm"]
    zc, e = scratch["zc"], scratch["e"]
    s, r, p = scratch["s"], scratch["r"], scratch["p"]
    pb, ohb = scratch["pb"], scratch["ohb"]
    consts = scratch["consts"]
    blocks = [
        _memset_at(consts, 0, -1.0),
        _memset_at(consts, 1, 1.0),
        _memset_at(consts, 2, 1.0 / B),
        _memset_at(consts, 3, -1.0 / B),
        # m[b] = max_c z[b, c]
        _nest_block(
            (C, B), 1,
            (z.base, (1, C)), None, (m.base, (0, 1)),
            design, opcode="vmax", tag=f"{tag}:rowmax",
            reads=(z,), writes=(m,),
        ),
        # negm = -m
        _nest_block(
            (B,), 0,
            (m.base, (1,)), (consts.base + 0, (0,)), (negm.base, (1,)),
            design, opcode="vmul", tag=f"{tag}:negmax",
            reads=(m, consts), writes=(negm,),
        ),
        # zc[b, c] = z - m[b]
        _nest_block(
            (C, B), 0,
            (z.base, (1, C)), (negm.base, (0, 1)), (zc.base, (1, C)),
            design, opcode="vadd", tag=f"{tag}:shift",
            reads=(z, negm), writes=(zc,),
        ),
        # e = exp(zc)
        _nest_block(
            (B * C,), 0,
            (zc.base, (1,)), None, (e.base, (1,)),
            design, opcode="vexp", tag=f"{tag}:exp",
            reads=(zc,), writes=(e,),
        ),
        # s[b] = sum_c e[b, c]
        _nest_block(
            (C, B), 1,
            (e.base, (1, C)), (consts.base + 1, (0, 0)), (s.base, (0, 1)),
            design, opcode="mac", tag=f"{tag}:rowsum",
            reads=(e, consts), writes=(s,),
        ),
        # r = 1 / s
        _nest_block(
            (B,), 0,
            (s.base, (1,)), None, (r.base, (1,)),
            design, opcode="vrecip", tag=f"{tag}:recip",
            reads=(s,), writes=(r,),
        ),
        # p[b, c] = e * r[b]
        _nest_block(
            (C, B), 0,
            (e.base, (1, C)), (r.base, (0, 1)), (p.base, (1, C)),
            design, opcode="vmul", tag=f"{tag}:softmax",
            reads=(e, r), writes=(p,),
        ),
        # dz = p/B - onehot/B
        _nest_block(
            (B * C,), 0,
            (p.base, (1,)), (consts.base + 2, (0,)), (pb.base, (1,)),
            design, opcode="vmul", tag=f"{tag}:scale_p",
            reads=(p, consts), writes=(pb,),
        ),
        _nest_block(
            (B * C,), 0,
            (onehot.base, (1,)), (consts.base + 3, (0,)), (ohb.base, (1,)),
            design, opcode="vmul", tag=f"{tag}:scale_onehot",
            reads=(onehot, consts), writes=(ohb,),
        ),
        _nest_block(
            (B * C,), 0,
            (pb.base, (1,)), (ohb.base, (1,)), (dz.base, (1,)),
            design, opcode="vadd", tag=tag,
            reads=(pb, ohb), writes=(dz,),
        ),
    ]
    return blocks


def softmax_xent_scratch_shapes(spec: SoftmaxXentSpec) -> dict[str, tuple[int, ...]]:
    """The scratch regions :func:`softmax_xent_grad_blocks` needs."""
    B, C = spec.batch, spec.classes
    return {
        "m": (B,), "negm": (B,), "s": (B,), "r": (B,),
        "zc": (B, C), "e": (B, C), "p": (B, C), "pb": (B, C), "ohb": (B, C),
        "consts": (4,),
    }


def _lower_softmax_xent_grad(spec: SoftmaxXentSpec, design: DesignPoint) -> NtxProgram:
    B, C = spec.batch, spec.classes
    alloc = RegionAllocator()
    rz = alloc.alloc("z", (B, C), "input")
    roh = alloc.alloc("onehot", (B, C), "input")
    rdz = alloc.alloc("dz", (B, C), "output")
    scratch = {
        name: alloc.alloc(name, shape, "scratch")
        for name, shape in softmax_xent_scratch_shapes(spec).items()
    }
    return NtxProgram(
        name=f"softmax_xent{B}x{C}:dx",
        blocks=softmax_xent_grad_blocks(spec, rz, roh, rdz, scratch, design),
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "dx"},
    )


# ---------------------------------------------------------------------------
# SGD update rule (w <- w - lr * dW, optional momentum)
# ---------------------------------------------------------------------------


def _pair_mac_block(
    src0: TensorRegion,
    src1: TensorRegion,
    coeffs: TensorRegion,
    coeff_off: int,
    dst: TensorRegion,
    design: DesignPoint,
    *,
    tag: str,
) -> CommandBlock:
    """dst[i] = src0[i]*coeffs[off] + src1[i]*coeffs[off+1] as one MAC nest.

    The two operands stream through rd0 via the cross-region base delta in
    the reduction dim; the coefficient pair streams through rd1 with the
    output-dim stride pinned to 0. NOT relocation-safe (the delta bakes the
    final bases in) — emit only at final region addresses.
    """
    delta = src1.base - src0.base
    return _nest_block(
        (2, src0.size), 1,
        (src0.base, (delta, 1)),
        (coeffs.base + coeff_off, (1, 0)),
        (dst.base, (0, 1)),
        design, opcode="mac", tag=tag,
        reads=(src0, src1, coeffs), writes=(dst,),
    )


def sgd_update_blocks(
    spec: SgdUpdateSpec,
    w: TensorRegion,
    dw: TensorRegion,
    w_new: TensorRegion,
    consts: TensorRegion,
    design: DesignPoint,
    *,
    v: TensorRegion | None = None,
    v_new: TensorRegion | None = None,
    tag: str = "sgd",
) -> list[CommandBlock]:
    """The weight-update MAC blocks (see :class:`SgdUpdateSpec`).

    ``consts`` is 2 elements for plain SGD ((1, -lr)), 4 with momentum
    ((mu, 1) then (1, -lr)).
    """
    lr, mu = spec.lr, spec.momentum
    if mu:
        if v is None or v_new is None:
            raise ValueError("momentum update needs v and v_new regions")
        return [
            _memset_at(consts, 0, mu),
            _memset_at(consts, 1, 1.0),
            _memset_at(consts, 2, 1.0),
            _memset_at(consts, 3, -lr),
            _pair_mac_block(v, dw, consts, 0, v_new, design, tag=f"{tag}:momentum"),
            _pair_mac_block(w, v_new, consts, 2, w_new, design, tag=f"{tag}:update"),
        ]
    return [
        _memset_at(consts, 0, 1.0),
        _memset_at(consts, 1, -lr),
        _pair_mac_block(w, dw, consts, 0, w_new, design, tag=f"{tag}:update"),
    ]


def _lower_sgd_update(spec: SgdUpdateSpec, design: DesignPoint) -> NtxProgram:
    n = spec.n
    alloc = RegionAllocator()
    rw = alloc.alloc("w", (n,), "param")
    rdw = alloc.alloc("dw", (n,), "input")
    rv = rvn = None
    if spec.momentum:
        rv = alloc.alloc("v", (n,), "param")
        rvn = alloc.alloc("v_new", (n,), "output")
    rc = alloc.alloc("consts", (4 if spec.momentum else 2,), "scratch")
    rwn = alloc.alloc("w_new", (n,), "output")
    return NtxProgram(
        name=f"sgd{n}:upd",
        blocks=sgd_update_blocks(spec, rw, rdw, rwn, rc, design, v=rv, v_new=rvn),
        regions=alloc.regions,
        design=design,
        meta={"spec": spec, "pass": "upd"},
    )



# ---------------------------------------------------------------------------
# The lowering registry + entry point
# ---------------------------------------------------------------------------

#: spec type -> {pass name -> rule fn(spec, pass_, design) -> NtxProgram}
_LOWERINGS: dict[type, dict[str, object]] = {}
#: spec type -> factory(pass_) -> Exception, raised for unregistered passes
_UNSUPPORTED: dict[type, object] = {}

ALL_PASSES = (*PASSES, "upd")  # canonical ordering for introspection


def register_lowering(spec_type: type, *passes: str):
    """Decorator: register ``fn(spec, pass_, design)`` as the lowering rule
    for ``spec_type`` under each named pass.

    New layer types plug into :func:`lower` this way instead of growing a
    dispatch ladder; :func:`supported_matrix` introspects the result.
    """
    if not passes:
        raise ValueError("register_lowering needs at least one pass name")

    def deco(fn):
        table = _LOWERINGS.setdefault(spec_type, {})
        for p in passes:
            if p in table:
                raise ValueError(
                    f"{spec_type.__name__} pass {p!r} already registered"
                )
            table[p] = fn
        return fn

    return deco


def register_unsupported(spec_type: type, make_error):
    """Declare what :func:`lower` raises for ``spec_type`` passes with no
    registered rule. ``make_error(pass_)`` returns the exception instance:
    ``NotImplementedError`` for meaningful-but-unsupported combinations,
    ``ValueError`` for nonsensical pass names (the precise split the support
    -matrix tests pin)."""
    _UNSUPPORTED[spec_type] = make_error
    return make_error


#: the JAX package's LM spec types, whose lowerings are not ported yet
LM_SPECS = ("AttentionSpec", "LayerNormSpec", "ResidualAddSpec", "EmbeddingSpec",
            "PosEmbedSpec")


def _registry_entry(spec) -> tuple[type, dict]:
    for klass in type(spec).__mro__:
        if klass in _LOWERINGS or klass in _UNSUPPORTED:
            return klass, _LOWERINGS.get(klass, {})
    name = type(spec).__name__
    if name in LM_SPECS:
        raise TypeError(f"no lowering rule for {name}: the LM lowerings are not "
                        f"ported yet (ROADMAP A5)")
    raise TypeError(f"no lowering rule for {name}")


def lower(spec, pass_: str = "fwd", *, design: DesignPoint = NTX_DESIGN) -> NtxProgram:
    """Lower one layer spec + pass to an :class:`NtxProgram`.

    Dispatches through the lowering registry (:func:`register_lowering`);
    :func:`supported_matrix` renders the live support matrix. Combinations
    outside it raise what their :func:`register_unsupported` entry declares:
    ``NotImplementedError`` when the pass is meaningful but genuinely
    unsupported (overlapping-pool dX, flatten standalone), ``ValueError``
    when the pass name itself is nonsensical for the spec (e.g. relu ``dw``
    — no parameters exist). Unknown spec types, the LM ones among them
    (ROADMAP A5), raise ``TypeError``.
    """
    klass, table = _registry_entry(spec)
    fn = table.get(pass_)
    if fn is not None:
        return fn(spec, pass_, design)
    make_error = _UNSUPPORTED.get(klass)
    if make_error is None:
        raise ValueError(
            f"{klass.__name__} has no {pass_!r} pass; "
            f"registered: {tuple(table)}"
        )
    raise make_error(pass_)


def supported_matrix() -> dict[str, tuple[str, ...]]:
    """Spec-type name -> lowerable passes, straight from the registry.

    Spec types that never lower standalone (flatten) appear with an empty
    tuple.
    """
    known = set(_LOWERINGS) | set(_UNSUPPORTED)
    return {
        klass.__name__: tuple(
            p for p in ALL_PASSES if p in _LOWERINGS.get(klass, {})
        )
        for klass in sorted(known, key=lambda k: k.__name__)
    }


def lower_layer(spec, *, design: DesignPoint = NTX_DESIGN) -> dict[str, NtxProgram]:
    """All registered training passes of one layer, keyed by pass name.

    Parameterized layers (matmul/conv/bias) get fwd+dw+dx; relu and
    (non-overlapping) pooling get fwd+dx — the pass set comes from the
    registry.
    """
    klass, table = _registry_entry(spec)
    if not table:
        raise _UNSUPPORTED[klass]("fwd")
    return {
        p: lower(spec, p, design=design) for p in ALL_PASSES if p in table
    }


# -- registrations for the existing rule set --------------------------------


@register_lowering(MatmulSpec, *PASSES)
def _matmul_rule(spec, pass_, design):
    return _lower_matmul(spec, pass_, design)


register_unsupported(
    MatmulSpec,
    lambda p: ValueError(f"unknown matmul pass {p!r}; expected one of {PASSES}"),
)


@register_lowering(Conv2dSpec, *PASSES)
def _conv_rule(spec, pass_, design):
    if pass_ == "fwd":
        return _lower_conv_fwd(spec, design)
    if pass_ == "dw":
        return _lower_conv_dw(spec, design)
    return _lower_conv_dx(spec, design)


register_unsupported(
    Conv2dSpec,
    lambda p: ValueError(f"unknown conv pass {p!r}; expected one of {PASSES}"),
)


@register_lowering(MaxPool2dSpec, "fwd", "dx")
def _maxpool_rule(spec, pass_, design):
    # dx lowers for window == stride only (maxpool_dx_blocks raises otherwise)
    return _lower_maxpool(spec, design) if pass_ == "fwd" else _lower_maxpool_dx(spec, design)


register_unsupported(
    MaxPool2dSpec,
    lambda p: ValueError(
        f"maxpool has no {p!r} pass (no parameters); supported: fwd, dx"
    ),
)


@register_lowering(ReluSpec, "fwd", "dx")
def _relu_rule(spec, pass_, design):
    return _lower_relu(spec, design) if pass_ == "fwd" else _lower_relu_dx(spec, design)


register_unsupported(
    ReluSpec,
    lambda p: ValueError(
        f"relu has no {p!r} pass (no parameters); supported: fwd, dx"
    ),
)


@register_lowering(BiasSpec, *PASSES)
def _bias_rule(spec, pass_, design):
    return _lower_bias(spec, pass_, design)


register_unsupported(
    BiasSpec,
    lambda p: ValueError(f"unknown bias pass {p!r}; expected one of {PASSES}"),
)


@register_lowering(SoftmaxXentSpec, "dx")
def _softmax_xent_rule(spec, pass_, design):
    return _lower_softmax_xent_grad(spec, design)


register_unsupported(
    SoftmaxXentSpec,
    lambda p: NotImplementedError(
        "softmax-cross-entropy lowers only its gradient (pass 'dx'); "
        "the scalar loss value is computed on the driver core"
    ),
)


@register_lowering(SgdUpdateSpec, "upd")
def _sgd_rule(spec, pass_, design):
    return _lower_sgd_update(spec, design)


register_unsupported(
    SgdUpdateSpec,
    lambda p: ValueError(f"sgd update only has the 'upd' pass, got {p!r}"),
)


register_unsupported(
    FlattenSpec,
    lambda p: NotImplementedError(
        "flatten is a zero-copy view; only the graph compiler "
        "(repro_torch.lower.graph) consumes it, by aliasing regions"
    ),
)

