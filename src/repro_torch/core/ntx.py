"""The NTX offload programming model (``repro/core/ntx.py``).

An NTX command is five nested hardware loops (L0 innermost … L4 outermost),
three address-generator units (AGUs) evaluating the affine address equation

    A = A_base + i0*s0 + i1*s1 + i2*s2 + i3*s3 + i4*s4            (eq. 1)

plus an opcode executed in the innermost loop body. The accumulator is
(re-)initialized when the loops below ``init_level`` are all at zero, and
stored through the write AGU when the loops below ``store_level`` wrap.

  * :class:`Agu`, :class:`NtxCommand` — the staging-area contents.
  * :func:`ntx_execute` — the interpreter over a flat fp32 TCDM tensor. A
    CUDA tensor runs the command on the hand-written command kernel
    (:mod:`repro_torch.kernels.ntx_exec`); a CPU tensor runs the plain
    version below, a copy of the JAX package's two paths: the vectorized
    fast path (``_execute_vectorized``) and the loop nest
    (``_execute_loops``). Both are bit-identical to the JAX package's numpy
    interpreter, but for ``vexp``: numpy's fp32 exp is up to 2 ulp from the
    correctly rounded value this version takes (:func:`_exp`).
  * :func:`strides_to_steps` — eq. (2)/(3), the stride -> step conversion.
  * :func:`offload_count` / :func:`busy_cycles_per_offload` — Table 2's
    arithmetic for the NS (3 loops, 2 AGUs) and NTX (5 loops, 3 AGUs)
    design points.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Sequence

import torch

MAX_LOOPS = 5
_OPS = (
    "mac", "vadd", "vmul", "vmax", "vmin", "relu", "copy", "memset", "argmax",
    # comparison / transcendental helpers: the step function and >= mask feed
    # the ReLU / max-pool backward masks, exp and reciprocal the softmax-CE
    # gradient, reciprocal-sqrt the layernorm rstd
    "sign", "cmpge", "vexp", "vrecip", "vrsqrt",
)


@dataclass(frozen=True)
class Agu:
    """One address-generator unit: base address + per-loop element strides."""

    base: int
    strides: tuple[int, ...]  # length MAX_LOOPS, strides[i] applies to loop i

    def __post_init__(self):
        if len(self.strides) != MAX_LOOPS:
            raise ValueError(f"AGU needs {MAX_LOOPS} strides, got {len(self.strides)}")

    def address(self, idx: Sequence[int]) -> int:
        return self.base + sum(i * s for i, s in zip(idx, self.strides))


@dataclass(frozen=True)
class NtxCommand:
    """A complete NTX staging-area image (one offload)."""

    loops: tuple[int, ...]  # N0..N4, innermost first; unused loops = 1
    opcode: str
    agu_rd0: Agu
    agu_rd1: Agu | None = None
    agu_wr: Agu | None = None
    init_level: int = MAX_LOOPS  # accumulator init when loops >= level wrap
    store_level: int = 1  # write-back once loops < level complete
    init_value: float = 0.0

    def __post_init__(self):
        if len(self.loops) != MAX_LOOPS:
            raise ValueError(f"need {MAX_LOOPS} loop bounds, got {len(self.loops)}")
        if self.opcode not in _OPS:
            raise ValueError(f"unknown opcode {self.opcode!r}; supported: {_OPS}")
        if any(n < 1 for n in self.loops):
            raise ValueError("loop bounds must be >= 1")

    @property
    def total_iterations(self) -> int:
        return math.prod(self.loops)

    @property
    def busy_cycles(self) -> int:
        """Single-cycle-throughput FMAC: one iteration per cycle."""
        return self.total_iterations


def strides_to_steps(strides: Sequence[int], loops: Sequence[int]) -> list[int]:
    """Eq. (2)/(3): absolute strides s_i -> the incremental steps p_i the AGU
    adds, one per cycle (the step of loop i undoes the inner loops' wrap)."""
    steps = [0] * len(strides)
    steps[0] = strides[0]
    for i in range(1, len(strides)):
        steps[i] = strides[i] - (loops[i - 1] - 1) * steps[i - 1]
    return steps


def steps_to_strides(steps: Sequence[int], loops: Sequence[int]) -> list[int]:
    """Inverse of :func:`strides_to_steps`."""
    strides = [0] * len(steps)
    strides[0] = steps[0]
    for i in range(1, len(steps)):
        strides[i] = steps[i] + (loops[i - 1] - 1) * steps[i - 1]
    return strides


def ntx_execute(
    cmd: NtxCommand,
    memory: torch.Tensor,
    wide: bool = True,
    *,
    vectorize: bool = True,
    inplace: bool = False,
) -> torch.Tensor:
    """Execute one command against ``memory``, a flat fp32 tensor (the TCDM).

    Returns a copy with the results written through the write AGU, or
    ``memory`` itself with ``inplace=True``. ``wide=True`` carries the
    accumulator in fp64 and rounds it once at the store; ``wide=False``
    rounds after every multiply and add in fp32. On a CUDA tensor the
    command kernel runs it; on a CPU tensor the plain version, whose
    ``vectorize=True`` takes the fast path where it is provably
    bit-identical to the loop nest and the loop nest elsewhere.
    """
    if not isinstance(memory, torch.Tensor):
        raise TypeError(f"ntx_execute takes a flat float32 tensor, got {type(memory).__name__}")
    if memory.dtype != torch.float32 or memory.dim() != 1:
        raise ValueError("ntx_execute needs a flat float32 memory")
    mem = memory if inplace else memory.clone()
    from repro_torch.kernels import ntx_exec  # the kernel module imports this one

    if ntx_exec.use_kernel(mem):
        ntx_exec.launch_command(cmd, mem, wide=wide)
        return mem
    ntx_exec.COUNTER.plain_calls += 1
    if not (vectorize and _execute_vectorized(cmd, mem, wide)):
        _execute_loops(cmd, mem, wide)
    return mem


def _execute_loops(cmd: NtxCommand, mem: torch.Tensor, wide: bool, first: int = 0,
                   count: int | None = None) -> None:
    """The 5-deep loop nest in issue order (mutates ``mem``): iterations
    ``[first, first + count)`` of it, all by default, with the accumulator
    starting at ``init_value`` (how one thread of the command kernel runs).

    Values are 0-d tensors so every operation rounds as the JAX package's
    numpy scalars do: fp32 operands, an fp64 (``wide``) or fp32 accumulator.
    """
    acc_dtype = torch.float64 if wide else torch.float32

    def acc_of(x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=acc_dtype)

    zero = torch.zeros((), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    acc = acc_of(cmd.init_value)
    arg_idx = 0
    counter = 0
    op = cmd.opcode
    init_lv = min(cmd.init_level, MAX_LOOPS)
    store_lv = min(cmd.store_level, MAX_LOOPS)
    if count is None:
        count = cmd.total_iterations - first
    for flat in range(first, first + count):
        idx = []  # (i0, .., i4) of the flat issue-order index
        for n in cmd.loops:
            idx.append(flat % n)
            flat //= n
        if all(idx[j] == 0 for j in range(init_lv)):
            acc = acc_of(cmd.init_value)
            counter = 0
            arg_idx = 0
        # copies, not views: a later store may hit the address
        rd0 = mem[cmd.agu_rd0.address(idx)].clone()
        rd1 = mem[cmd.agu_rd1.address(idx)].clone() if cmd.agu_rd1 is not None else zero
        if op == "mac":
            if wide:
                acc = acc + rd0.double() * rd1.double()
            else:
                acc = acc + rd0 * rd1
        elif op == "vadd":
            acc = (rd0 + rd1).to(acc_dtype)
        elif op == "vmul":
            acc = (rd0 * rd1).to(acc_dtype)
        elif op == "vmax":
            x = rd0.to(acc_dtype)
            acc = x if not counter or x > acc else acc
        elif op == "vmin":
            x = rd0.to(acc_dtype)
            acc = x if not counter or x < acc else acc
        elif op == "relu":
            acc = (rd0 if rd0 > 0 else zero).to(acc_dtype)
        elif op == "sign":
            acc = acc_of(1.0 if rd0 > 0 else 0.0)
        elif op == "cmpge":
            acc = acc_of(1.0 if rd0 >= rd1 else 0.0)
        elif op == "vexp":
            acc = _exp(rd0).to(acc_dtype)
        elif op == "vrecip":
            acc = torch.div(one, rd0).to(acc_dtype)
        elif op == "vrsqrt":
            acc = torch.div(one, _sqrt(rd0)).to(acc_dtype)
        elif op == "copy":
            acc = rd0.to(acc_dtype)
        elif op == "memset":
            acc = acc_of(cmd.init_value)
        elif op == "argmax":
            x = rd0.to(acc_dtype)
            if counter == 0 or x > acc:
                acc = x
                arg_idx = counter
        counter += 1
        wraps = all(idx[j] == cmd.loops[j] - 1 for j in range(store_lv))
        if wraps and cmd.agu_wr is not None:
            out = float(arg_idx) if op == "argmax" else acc.to(torch.float32)
            mem[cmd.agu_wr.address(idx)] = out


# ---------------------------------------------------------------------------
# Vectorized fast path (bit-identical to the loop nest)
# ---------------------------------------------------------------------------


def agu_span(agu: Agu, loops: Sequence[int]) -> tuple[int, int]:
    """(min, max) address the AGU can emit over the loop nest."""
    lo = hi = agu.base
    for n, s in zip(loops, agu.strides):
        d = (n - 1) * s
        if d < 0:
            lo += d
        else:
            hi += d
    return lo, hi


@functools.lru_cache(maxsize=256)
def _offset_grid(strides: tuple[int, ...], loops: tuple[int, ...]) -> torch.Tensor:
    """Base-relative AGU offsets, shaped (n4..n0) so C-order == issue order.

    Cached on (strides, loops): a command block re-issues one template with
    only the AGU bases rebased, so every replica shares the lattice.
    """
    addr = torch.zeros((), dtype=torch.int64)
    for j, (n, s) in enumerate(zip(loops, strides)):
        shape = [1] * MAX_LOOPS
        shape[MAX_LOOPS - 1 - j] = n
        addr = addr + (torch.arange(n, dtype=torch.int64) * s).reshape(shape)
    return addr.expand(tuple(reversed(loops))).contiguous()


def _agu_grid(agu: Agu, loops: Sequence[int]) -> torch.Tensor:
    """All addresses, shaped (n4, n3, n2, n1, n0) so C-order == issue order."""
    return agu.base + _offset_grid(agu.strides, tuple(loops))


def _spans_ok(cmd: NtxCommand, size: int, check_alias: bool = True) -> bool:
    """All addresses in range and (for value-reading opcodes) the write span
    disjoint from every read span: the loop nest interleaves reads and
    writes, so gathering all reads up front is only safe without aliasing.
    Out of range also covers negative addresses, which wrap as indices."""
    agus = [a for a in (cmd.agu_rd0, cmd.agu_rd1, cmd.agu_wr) if a is not None]
    spans = [agu_span(a, cmd.loops) for a in agus]
    if any(lo < 0 or hi >= size for lo, hi in spans):
        return False
    if check_alias and cmd.agu_wr is not None:
        wlo, whi = agu_span(cmd.agu_wr, cmd.loops)
        for agu, (lo, hi) in zip(agus, spans):
            if agu is cmd.agu_wr:
                continue
            if not (hi < wlo or whi < lo):
                return False
    return True


def _unique(addr: torch.Tensor) -> bool:
    return torch.unique(addr).numel() == addr.numel()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """fp32 square root rounded once: torch's CPU fp32 ``sqrt`` is off by an
    ulp for about 0.7 % of inputs; the fp64 root rounded to fp32 is the
    correctly rounded one (53 >= 2 * 24 + 2 bits), as numpy's and CUDA's
    ``__fsqrt_rn`` are."""
    return torch.sqrt(a.double()).to(torch.float32)


def _exp(a: torch.Tensor) -> torch.Tensor:
    """fp32 exp, from the fp64 one rounded once: the correctly rounded value
    but for ties closer than fp64's error. numpy's fp32 exp is up to 2 ulp
    from it (measured on 400 k normal values, scale 3), CUDA's ``expf`` up
    to 2 ulp by its documentation: ``vexp`` is the one opcode whose bits may
    differ between the JAX package, this version and the kernel."""
    return torch.exp(a.double()).to(torch.float32)


# Streaming elementwise opcodes in fp32, bit-identical to the loop nest.
_ELEMENTWISE = {
    "vadd": lambda a, b: a + b,
    "vmul": lambda a, b: a * b,
    "relu": lambda a, _: torch.clamp_min(a, 0.0),
    "sign": lambda a, _: (a > 0).to(torch.float32),
    "cmpge": lambda a, b: (a >= b).to(torch.float32),
    "vexp": lambda a, _: _exp(a),
    "vrecip": lambda a, _: torch.div(torch.ones_like(a), a),
    "vrsqrt": lambda a, _: torch.div(torch.ones_like(a), _sqrt(a)),
}


def _region_store(cmd: NtxCommand, lvl: int) -> torch.Tensor:
    """Store address of each region (inner loops at their last index), in
    region issue order: pinning the inner bounds to 1 folds their last
    stride contribution into the base."""
    wr = cmd.agu_wr
    base = wr.base + sum((cmd.loops[j] - 1) * wr.strides[j] for j in range(lvl))
    return _agu_grid(Agu(base, wr.strides), (1,) * lvl + tuple(cmd.loops[lvl:])).reshape(-1)


def _execute_vectorized(cmd: NtxCommand, mem: torch.Tensor, wide: bool) -> bool:
    """Try the affine-dense fast path; return False to fall back to loops."""
    if cmd.agu_wr is None:
        return False
    # memset ignores the values it reads, and an identity copy (read AGU ==
    # write AGU: the graph compiler's spill / fill DMA model) writes back
    # exactly what it reads, so aliasing is harmless for both
    identity_copy = cmd.opcode == "copy" and cmd.agu_rd0 == cmd.agu_wr
    if not _spans_ok(cmd, mem.numel(),
                     check_alias=cmd.opcode != "memset" and not identity_copy):
        return False

    if cmd.opcode in ("memset", "copy") or cmd.opcode in _ELEMENTWISE:
        if cmd.store_level != 0:
            return False
        wa = _agu_grid(cmd.agu_wr, cmd.loops).reshape(-1)
        if not _unique(wa):
            return False  # colliding writes: the issue order matters
        if cmd.opcode == "memset":
            mem[wa] = torch.tensor(cmd.init_value, dtype=torch.float32)
            return True
        v0 = mem[_agu_grid(cmd.agu_rd0, cmd.loops).reshape(-1)]
        if cmd.opcode == "copy":
            mem[wa] = v0
            return True
        v1 = None
        if cmd.opcode in ("vadd", "vmul", "cmpge"):
            if cmd.agu_rd1 is None:
                return False
            v1 = mem[_agu_grid(cmd.agu_rd1, cmd.loops).reshape(-1)]
        mem[wa] = _ELEMENTWISE[cmd.opcode](v0, v1)
        return True

    if cmd.opcode in ("vmax", "vmin", "mac"):
        # one accumulation region per outer-loop combination: the init and
        # store boundaries must coincide so that regions are contiguous runs
        lvl = cmd.init_level
        if cmd.store_level != lvl or not 1 <= lvl <= MAX_LOOPS:
            return False
        if cmd.opcode == "mac" and cmd.agu_rd1 is None:
            return False
        red = math.prod(cmd.loops[:lvl])  # reduction length per region
        outer = math.prod(cmd.loops[lvl:])  # number of regions
        wa = _region_store(cmd, lvl)
        if not _unique(wa):
            return False
        v0 = mem[_agu_grid(cmd.agu_rd0, cmd.loops).reshape(-1)].reshape(outer, red)
        if cmd.opcode != "mac":
            # max / min keep fp32 values exactly: the reduce is bit-identical
            mem[wa] = v0.amax(dim=1) if cmd.opcode == "vmax" else v0.amin(dim=1)
            return True
        v1 = mem[_agu_grid(cmd.agu_rd1, cmd.loops).reshape(-1)].reshape(outer, red)
        if wide:
            v0, v1 = v0.double(), v1.double()
        # the products round alone (exactly, in fp64), so taking them all at
        # once is bit-identical; the sum runs in issue order, across regions
        # at once: the same operations in the same order as the loop nest
        prods = (v0 * v1).t().contiguous().unbind(0)
        acc = torch.full((outer,), cmd.init_value, dtype=v0.dtype)
        for p in prods:
            acc.add_(p)
        mem[wa] = acc.to(torch.float32)
        return True

    return False


# ---------------------------------------------------------------------------
# Offload-count analytics (paper Table 2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvShape:
    """A convolution as the paper counts it: 4D weights, 3D input/output."""

    kw: int
    kh: int
    cin: int
    out_w: int
    out_h: int
    cout: int

    @property
    def reduction_dims(self) -> tuple[int, int, int]:
        return (self.kw, self.kh, self.cin)

    @property
    def output_dims(self) -> tuple[int, int, int]:
        return (self.out_w, self.out_h, self.cout)


def _usable(conv: ConvShape, hw_loops: int, autonomous_writeback: bool) -> tuple[list[int], int]:
    dims = list(conv.reduction_dims) + list(conv.output_dims)  # innermost first
    usable = min(hw_loops, len(dims))
    if not autonomous_writeback:
        usable = min(usable, len(conv.reduction_dims))
    return dims, usable


def offload_count(conv: ConvShape, hw_loops: int, autonomous_writeback: bool) -> int:
    """Commands a driver core issues for one conv layer: the innermost
    ``hw_loops`` of the 6-deep nest run inside one command, the rest on the
    driver; without a write-back AGU (NS) only the 3 reduction dims can be
    offloaded, so every output pixel is its own command."""
    dims, usable = _usable(conv, hw_loops, autonomous_writeback)
    host_dims = dims[usable:]
    return math.prod(host_dims) if host_dims else 1


def busy_cycles_per_offload(conv: ConvShape, hw_loops: int, autonomous_writeback: bool) -> int:
    dims, usable = _usable(conv, hw_loops, autonomous_writeback)
    return math.prod(dims[:usable])


# The two design points the paper compares (Table 2).
NS_LOOPS = dict(hw_loops=3, autonomous_writeback=False)
NTX_LOOPS = dict(hw_loops=5, autonomous_writeback=True)
