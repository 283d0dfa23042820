"""The NTX command kernel: NTX commands executed on a device TCDM.

The JAX package runs an :class:`~repro_torch.lower.ir.NtxProgram` command
by command through a numpy interpreter (``repro/core/ntx.py::ntx_execute``,
``repro/lower/executors.py::run_reference``); no TPU kernel does it. On the
card a torch copy of that interpreter would issue one multiply and one add
per reduction index, about 2.1 M launches for the paper CNN's step at batch
64, and one scalar access per iteration for the commands its fast path
refuses. :func:`run_program` instead launches the hand-written kernel
``csrc/ntx_exec.cu`` once per command, from one C entry that walks a
command table uploaded once per program: about 11.6 k launches a step.

Each command runs in one of three modes, decided once per program on the
host (:func:`command_mode`) and cached on it:

  * ``region`` — one thread per accumulation region (``prod(loops[init_level:])``
    regions), each running the inner ``init_level`` loops in issue order. Taken
    when every address the command stores to belongs to one region and no
    region reads an address another region writes.
  * ``streaming`` — elementwise, ``copy`` and ``memset`` commands that store
    every iteration (``store_level == 0``) to unique addresses, no iteration
    reading another's write: one thread per iteration.
  * ``sequential`` — everything else: the whole five-loop nest in issue order
    on one thread, the loop interpreter itself.

The aliasing checks are the JAX fast path's span checks; where spans
overlap, the exact address sets decide. The numerics are those of the plain
version (:func:`repro_torch.core.ntx.ntx_execute` on a CPU tensor): ``mac``
sums each region in issue order, in fp64 (``wide``) with the product and
the add rounded apart, or in fp32; ``vrecip`` and ``vrsqrt`` divide;
``vexp`` is CUDA's ``expf``, within a few ulp of the CPU's. No atomics: a
result is the same bits run to run.

The kernel is bound by latency, not by bytes or operations: most commands
are a few hundred threads that each walk a short dependent chain, and each
command is one launch. It keeps nothing between commands. Launching a
block's replicas together, or one persistent kernel for the program, is
later work.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import numpy as np
import torch

from repro_torch.core.ntx import _OPS, MAX_LOOPS, NtxCommand, agu_span
from repro_torch.kernels import build
from repro_torch.kernels.ops import LaunchCounter, use_kernel

__all__ = ["COUNTER", "ENTRY", "LIB", "MODES", "command_mode", "command_table", "emulate",
           "launch_command", "program_table", "run_program", "use_kernel"]

LIB = "ntx_exec"
ENTRY = "ntx_exec_program"
COUNTER = LaunchCounter("ntx_exec")  # entries: launches per mode
SEQUENTIAL, REGION, STREAMING = 0, 1, 2
MODES = ("sequential", "region", "streaming")
ROW_WORDS = 32  # int64 words of one command row (struct NtxCmd in ntx_exec.cu)
_STREAM_OPS = ("vadd", "vmul", "relu", "sign", "cmpge", "vexp", "vrecip", "vrsqrt",
               "copy", "memset")
_BOTH_READ = ("mac", "vadd", "vmul", "cmpge")  # opcodes whose rd1 value is used


def _levels(cmd: NtxCommand) -> tuple[int, int]:
    return (max(0, min(cmd.init_level, MAX_LOOPS)), max(0, min(cmd.store_level, MAX_LOOPS)))


def _used_reads(cmd: NtxCommand) -> list:
    """The read AGUs whose values the opcode uses (memset uses none)."""
    if cmd.opcode == "memset":
        return []
    reads = [cmd.agu_rd0]
    if cmd.opcode in _BOTH_READ and cmd.agu_rd1 is not None:
        reads.append(cmd.agu_rd1)
    return reads


@functools.lru_cache(maxsize=1024)
def _offsets(strides: tuple[int, ...], loops: tuple[int, ...]) -> np.ndarray:
    """Base-relative addresses of every iteration, flat in issue order."""
    addr = np.zeros((), np.int64)
    for j, (n, s) in enumerate(zip(loops, strides)):
        shape = [1] * MAX_LOOPS
        shape[MAX_LOOPS - 1 - j] = n
        addr = addr + (np.arange(n, dtype=np.int64) * s).reshape(shape)
    out = np.broadcast_to(addr, tuple(reversed(loops))).reshape(-1).copy()
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1024)
def _stores(loops: tuple[int, ...], init_level: int, store_level: int,
            per: str) -> tuple[np.ndarray, np.ndarray, int]:
    """The iterations that store, the owner of each (its region, or itself
    with ``per="iteration"``), and the iterations one owner spans."""
    last = np.ones(tuple(reversed(loops)), bool)
    for j in range(store_level):
        idx = [slice(None)] * MAX_LOOPS
        idx[MAX_LOOPS - 1 - j] = slice(0, loops[j] - 1)
        last[tuple(idx)] = False
    it = np.flatnonzero(last.reshape(-1))
    span = math.prod(loops[:init_level]) if per == "region" else 1
    return it, it // span, span


@functools.lru_cache(maxsize=1024)
def _writes_apart(strides: tuple[int, ...], loops: tuple[int, ...], init_level: int,
                  store_level: int, per: str) -> bool:
    """Each stored address is stored by one owner only (the base shifts
    every address alike, so this holds for every replica of a template)."""
    it, owner, _ = _stores(loops, init_level, store_level, per)
    addr = _offsets(strides, loops)[it]
    order = np.argsort(addr, kind="stable")
    a, o = addr[order], owner[order]
    same = a[1:] == a[:-1]
    return bool(np.all(o[1:][same] == o[:-1][same]))


def _reads_own(cmd: NtxCommand, init_level: int, store_level: int, per: str) -> bool:
    """Exact check: no iteration reads an address that another owner (region,
    or iteration) stores to. Needs :func:`_writes_apart` to hold."""
    it, owner, span = _stores(cmd.loops, init_level, store_level, per)
    w = cmd.agu_wr.base + _offsets(cmd.agu_wr.strides, cmd.loops)[it]
    order = np.argsort(w, kind="stable")
    ws, wo = w[order], owner[order]
    for agu in _used_reads(cmd):
        r = agu.base + _offsets(agu.strides, cmd.loops)
        pos = np.clip(np.searchsorted(ws, r), 0, len(ws) - 1)
        hit = ws[pos] == r
        reader = np.arange(len(r), dtype=np.int64) // span
        if np.any(wo[pos][hit] != reader[hit]):
            return False
    return True


def command_mode(cmd: NtxCommand, size: int) -> int:
    """The kernel mode of ``cmd`` on a TCDM of ``size`` words (see the module
    docstring). Addresses beyond the memory raise, as the interpreter's
    indexing does; negative ones wrap as indices do and run sequentially."""
    agus = [a for a in (cmd.agu_rd0, cmd.agu_rd1, cmd.agu_wr) if a is not None]
    spans = [agu_span(a, cmd.loops) for a in agus]
    if any(lo < -size or hi >= size for lo, hi in spans):
        raise ValueError(f"command addresses leave the {size}-word memory: {cmd}")
    if cmd.agu_wr is None or any(lo < 0 for lo, _ in spans):
        return SEQUENTIAL
    init_level, store_level = _levels(cmd)
    wlo, whi = agu_span(cmd.agu_wr, cmd.loops)
    apart = all(hi < wlo or whi < lo
                for lo, hi in (agu_span(a, cmd.loops) for a in _used_reads(cmd)))
    if cmd.opcode in _STREAM_OPS and store_level == 0:
        if _writes_apart(cmd.agu_wr.strides, cmd.loops, 0, 0, "iteration") and (
                apart or _reads_own(cmd, 0, 0, "iteration")):
            return STREAMING
    if _writes_apart(cmd.agu_wr.strides, cmd.loops, init_level, store_level, "region") and (
            apart or _reads_own(cmd, init_level, store_level, "region")):
        return REGION
    return SEQUENTIAL


def _row(cmd: NtxCommand, mode: int) -> list[int]:
    init_level, store_level = _levels(cmd)
    total = math.prod(cmd.loops)
    per_thread = {SEQUENTIAL: total, REGION: math.prod(cmd.loops[:init_level]),
                  STREAMING: 1}[mode]
    agus = (cmd.agu_rd0, cmd.agu_rd1, cmd.agu_wr)
    flags = sum(1 << i for i, a in enumerate(agus) if a is not None)
    row = [*cmd.loops, _OPS.index(cmd.opcode), init_level, store_level, mode,
           struct.unpack("<q", struct.pack("<d", float(cmd.init_value)))[0], flags,
           total // per_thread, per_thread]
    row += [0 if a is None else a.base for a in agus]
    for a in agus:
        row += [0] * MAX_LOOPS if a is None else list(a.strides)
    return row + [0] * (ROW_WORDS - len(row))


def command_table(commands, size: int) -> tuple[np.ndarray, np.ndarray]:
    """The host command table (one row of :data:`ROW_WORDS` int64 per
    command: loops, opcode, levels, mode, init value, AGUs) and the modes."""
    rows, modes = [], []
    for cmd in commands:
        mode = command_mode(cmd, size)
        rows.append(_row(cmd, mode))
        modes.append(mode)
    return (np.asarray(rows, np.int64).reshape(-1, ROW_WORDS),
            np.asarray(modes, np.int64))


def program_table(program) -> dict:
    """The program's command table and modes, built once and cached in
    ``program.meta["_ntx_exec"]`` (device copies are added per device)."""
    cached = program.meta.get("_ntx_exec")
    if cached is None:
        table, modes = command_table(program.commands(), program.memory_words)
        cached = program.meta["_ntx_exec"] = {
            "table": table, "modes": modes,
            "per_mode": {m: int((modes == i).sum()) for i, m in enumerate(MODES)},
            "device": {},
        }
    return cached


def _launch(table: np.ndarray, dev_table: torch.Tensor, modes: np.ndarray,
            mem: torch.Tensor, wide: bool) -> None:
    if mem.dtype != torch.float32 or mem.dim() != 1 or not mem.is_contiguous():
        raise ValueError("the command kernel needs a flat contiguous float32 memory")
    fn = build.library(LIB).ntx_exec_program
    if fn.argtypes is None:
        # host table, device table, count, memory, size, wide, stream
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    host = np.ascontiguousarray(table)
    stream = torch.cuda.current_stream(mem.device).cuda_stream
    code = fn(host.ctypes.data, dev_table.data_ptr(), len(host), mem.data_ptr(), mem.numel(),
              int(wide), stream)
    build.check(LIB, code, ENTRY)
    COUNTER.launches += len(host)
    for i, m in enumerate(MODES):
        n = int((modes == i).sum())
        if n:
            COUNTER.entries[m] = COUNTER.entries.get(m, 0) + n


def run_program(program, mem: torch.Tensor, *, wide: bool = True) -> None:
    """Run every command of ``program`` on the CUDA TCDM ``mem`` in place,
    one kernel launch per command, all from one C call on the current
    stream."""
    if not use_kernel(mem):
        raise ValueError("run_program launches the command kernel: mem must be a CUDA tensor")
    if mem.numel() != program.memory_words:
        raise ValueError(f"the program needs {program.memory_words} words, got {mem.numel()}")
    cached = program_table(program)
    dev = cached["device"].get(mem.device)
    if dev is None:
        dev = cached["device"][mem.device] = torch.as_tensor(cached["table"], device=mem.device)
    _launch(cached["table"], dev, cached["modes"], mem, wide)


def launch_command(cmd: NtxCommand, mem: torch.Tensor, *, wide: bool = True) -> None:
    """Run one command on the CUDA TCDM ``mem`` in place (one launch)."""
    table, modes = command_table([cmd], mem.numel())
    _launch(table, torch.as_tensor(table, device=mem.device), modes, mem, wide)


def emulate(cmd: NtxCommand, mem: torch.Tensor, *, wide: bool = True, order=None) -> int:
    """The kernel's thread split in plain PyTorch, on a CPU tensor in place:
    the command's mode cuts the nest into threads as the kernel does, and
    each thread runs its iterations through the loop interpreter, the
    threads one after another in ``order`` (reversed issue order by
    default). Where the mode is right, no order changes a bit. Returns the
    mode."""
    from repro_torch.core.ntx import _execute_loops

    mode = command_mode(cmd, mem.numel())
    row = _row(cmd, mode)
    n_threads, per_thread = row[11], row[12]
    for t in (reversed(range(n_threads)) if order is None else order):
        _execute_loops(cmd, mem, wide, t * per_thread, per_thread)
    return mode
