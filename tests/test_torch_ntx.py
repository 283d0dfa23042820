"""The port's NTX interpreter and command kernel design vs the JAX package, on the CPU.

The same commands and memories (made with numpy from a seed) go through the
JAX package's numpy interpreter (``repro.core.ntx.ntx_execute``) and the
port's plain version (``repro_torch.core.ntx.ntx_execute`` on a CPU
tensor), fast path and loop nest: the cases of tests/test_ntx.py,
tests/test_ntx_fast.py and tests/test_ntx_opcodes.py. Results are
bit-identical, except ``vexp``: the port's exp is the correctly rounded one
(fp64 rounded once) and numpy's fp32 exp is up to 2 ulp from it, so vexp
is held within 2 ulp (:data:`EXP_ULPS`).

``csrc/ntx_exec.cu`` runs only on the card. Its thread split is emulated
here (``ntx_exec.emulate``: the command cut into the threads its mode
gives, each thread through the loop interpreter, the threads in reverse or
shuffled order): where the mode planning is right, the order changes no bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ntx as jntx
from repro.lower.rules import conv2d_fwd_template as j_conv_template
from repro.lower.rules import matmul_template as j_matmul_template
from repro_torch.core import ntx
from repro_torch.core.ntx import MAX_LOOPS, Agu, NtxCommand
from repro_torch.kernels import conv2d, ntx_exec, ntx_matmul, ops, streaming
from repro_torch.lower.rules import conv2d_fwd_template, matmul_template


EXP_ULPS = 2  # numpy's fp32 exp vs the correctly rounded one (core/ntx.py::_exp)


def _agu(base, *strides):
    return Agu(base, tuple(strides) + (0,) * (MAX_LOOPS - len(strides)))


def _jax_cmd(cmd: NtxCommand) -> jntx.NtxCommand:
    """The same command as the JAX package's dataclasses."""
    def agu(a):
        return None if a is None else jntx.Agu(a.base, a.strides)

    return jntx.NtxCommand(
        loops=cmd.loops, opcode=cmd.opcode, agu_rd0=agu(cmd.agu_rd0),
        agu_rd1=agu(cmd.agu_rd1), agu_wr=agu(cmd.agu_wr), init_level=cmd.init_level,
        store_level=cmd.store_level, init_value=cmd.init_value)


def _run(cmd, mem, wide=True, vectorize=True):
    return ntx.ntx_execute(cmd, torch.from_numpy(np.asarray(mem, np.float32)), wide,
                           vectorize=vectorize).numpy()


def _ulps(a, b) -> int:
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _match_jax(cmd, mem, wide=True, ulps=0):
    """Port (fast path and loops) vs JAX (both paths): bit-identical, or within
    ``ulps`` for vexp; returns the port's result."""
    jcmd = _jax_cmd(cmd)
    got = {v: _run(cmd, mem, wide, v) for v in (True, False)}
    want = {v: jntx.ntx_execute(jcmd, mem, wide=wide, vectorize=v) for v in (True, False)}
    for v in (True, False):
        if ulps:
            assert _ulps(got[v], want[v]) <= ulps, repr(cmd)
        else:
            np.testing.assert_array_equal(got[v], want[v], err_msg=repr(cmd))
    return got[True]


def _random_command(rng, opcodes):
    loops = tuple(int(x) for x in rng.randint(1, 4, MAX_LOOPS))
    opcode = opcodes[rng.randint(len(opcodes))]

    def agu():
        return Agu(int(rng.randint(0, 60)), tuple(int(s) for s in rng.randint(-3, 4, MAX_LOOPS)))

    lvl = int(rng.randint(0, MAX_LOOPS + 1))
    return NtxCommand(
        loops=loops, opcode=opcode, agu_rd0=agu(),
        agu_rd1=agu() if opcode in ("mac", "vadd", "vmul", "cmpge") else None,
        agu_wr=agu(), init_level=lvl,
        store_level=lvl if opcode == "mac" else int(rng.randint(0, 3)),
        init_value=float(rng.randn()),
    )


# -- AGU math and Table 2 ----------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_strides_steps_roundtrip(seed):
    rng = np.random.RandomState(seed)
    for _ in range(30):
        loops = [int(x) for x in rng.randint(1, 10, 5)]
        strides = [int(x) for x in rng.randint(-50, 51, 5)]
        steps = ntx.strides_to_steps(strides, loops)
        assert steps == jntx.strides_to_steps(strides, loops)
        assert ntx.steps_to_strides(steps, loops) == strides


def test_table2_offload_counts():
    """Paper Table 2, and the same counts as the JAX package."""
    rows = [
        ((7, 7, 3, 112, 112, 64), 802_816, 64, 147, 1_843_968),
        ((3, 3, 64, 56, 56, 192), 602_112, 192, 576, 1_806_336),
        ((1, 1, 256, 28, 28, 64), 50_176, 64, 256, 200_704),
        ((1, 1, 512, 14, 14, 192), 37_632, 192, 512, 100_352),
    ]
    for dims, ns_off, ntx_off, ns_cyc, ntx_cyc in rows:
        conv, jconv = ntx.ConvShape(*dims), jntx.ConvShape(*dims)
        assert ntx.offload_count(conv, **ntx.NS_LOOPS) == ns_off
        assert ntx.offload_count(conv, **ntx.NTX_LOOPS) == ntx_off
        assert ntx.busy_cycles_per_offload(conv, **ntx.NS_LOOPS) == ns_cyc
        assert ntx.busy_cycles_per_offload(conv, **ntx.NTX_LOOPS) == ntx_cyc
        for design in (ntx.NS_LOOPS, ntx.NTX_LOOPS):
            assert ntx.offload_count(conv, **design) == jntx.offload_count(jconv, **design)


# -- the matmul and conv templates -------------------------------------------


@pytest.mark.parametrize("m,n,k", [(4, 4, 2), (1, 1, 1), (5, 3, 6), (2, 5, 4), (3, 1, 5)])
def test_interpreter_matmul(m, n, k):
    """The matmul template against the fp64 product, and bit-identical to JAX."""
    rng = np.random.RandomState(m * 100 + n * 10 + k)
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    mem = np.zeros(500, np.float32)
    mem[: m * k] = a.ravel()
    mem[100: 100 + k * n] = b.ravel()
    cmd = matmul_template(m, n, k, 0, 100, 300)
    assert dataclasses.astuple(cmd) == dataclasses.astuple(j_matmul_template(m, n, k, 0, 100, 300))
    out = _match_jax(cmd, mem)
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(out[300: 300 + m * n].reshape(m, n), want, rtol=1e-5, atol=1e-6)


def test_interpreter_wide_beats_fpu():
    rng = np.random.RandomState(0)
    k = 4096
    a = (rng.randn(1, k) * 10.0 ** rng.uniform(-3, 3, (1, k))).astype(np.float32)
    b = rng.randn(k, 1).astype(np.float32)
    mem = np.zeros(3 * k + 10, np.float32)
    mem[:k] = a.ravel()
    mem[k: 2 * k] = b.ravel()
    cmd = matmul_template(1, 1, k, 0, k, 3 * k)
    ref = np.dot(a.astype(np.float64), b.astype(np.float64))[0, 0]
    wide = _match_jax(cmd, mem, wide=True)[3 * k]
    fpu = _match_jax(cmd, mem, wide=False)[3 * k]
    assert abs(wide - ref) <= abs(fpu - ref)


def test_conv_command_matches_numpy():
    rng = np.random.RandomState(3)
    ih, iw, ci, kh, kw = 7, 8, 3, 3, 2
    x = rng.randn(ih, iw, ci).astype(np.float32)
    w = rng.randn(kh, kw, ci).astype(np.float32)
    mem = np.zeros(2000, np.float32)
    mem[: x.size] = x.ravel()
    mem[500: 500 + w.size] = w.ravel()
    cmd = conv2d_fwd_template(ih, iw, ci, kh, kw, 1, 0, 500, 1000)
    assert dataclasses.astuple(cmd) == dataclasses.astuple(
        j_conv_template(ih, iw, ci, kh, kw, 1, 0, 500, 1000))
    out = _match_jax(cmd, mem)
    oh, ow = ih - kh + 1, iw - kw + 1
    want = np.array([[(x[i: i + kh, j: j + kw] * w).sum() for j in range(ow)]
                     for i in range(oh)], np.float32)
    np.testing.assert_allclose(out[1000: 1000 + oh * ow].reshape(oh, ow), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "comp"])
def test_command_semantics_match_the_matmul_kernels_plain_versions(compensated):
    """The offload model and the kernels compute one contraction: the matmul
    template through the interpreter vs the plain versions of B5
    (``ops.matmul`` / ``ntx_matmul``) and B2 (``streaming_matmul``)."""
    rng = np.random.RandomState(11)
    m, n, k = 8, 6, 12
    a = rng.randn(m, k).astype(np.float32)
    b = rng.randn(k, n).astype(np.float32)
    mem = np.zeros(1000, np.float32)
    mem[: m * k] = a.ravel()
    mem[200: 200 + k * n] = b.ravel()
    want = _run(matmul_template(m, n, k, 0, 200, 500), mem)[500: 500 + m * n].reshape(m, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (ops.matmul(ta, tb, compensated=compensated),
                ntx_matmul.ntx_matmul(ta, tb, compensated=compensated),
                streaming.streaming_matmul(ta, tb)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_command_matches_the_conv_kernels_plain_version(stride):
    """B6's plain version (``conv2d_ntx`` on a CPU tensor) vs the conv-forward
    template, one command per output channel, through the interpreter."""
    rng = np.random.RandomState(7 + stride)
    h, w, cin, kh, kw, cout = 9, 8, 3, 3, 3, 4
    x = rng.randn(1, h, w, cin).astype(np.float32)
    wt = rng.randn(kh, kw, cin, cout).astype(np.float32)
    oh, ow = (h - kh) // stride + 1, (w - kw) // stride + 1
    mem = torch.zeros(2000)
    mem[: x.size] = torch.from_numpy(x.ravel())
    mem[500: 500 + wt.size] = torch.from_numpy(wt.ravel())
    for co in range(cout):  # cout stride 4 into the HWIO weights, one channel each
        cmd = conv2d_fwd_template(h, w, cin, kh, kw, cout, 0, 500 + co, 1000 + co, stride=stride)
        ntx.ntx_execute(cmd, mem, inplace=True)
    want = mem[1000: 1000 + oh * ow * cout].reshape(1, oh, ow, cout)
    got = conv2d.conv2d_ntx(torch.from_numpy(x), torch.from_numpy(wt), stride=stride)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# -- fast path vs loops vs JAX (tests/test_ntx_fast.py) -----------------------


def test_matmul_bit_identical_both_widths():
    rng = np.random.RandomState(0)
    mem = rng.randn(3 * 32 * 32 + 8).astype(np.float32)
    cmd = matmul_template(32, 32, 32, 0, 32 * 32, 2 * 32 * 32)
    for wide in (True, False):
        _match_jax(cmd, mem, wide=wide)


def test_conv_command_bit_identical():
    rng = np.random.RandomState(1)
    ih, iw, ci, kh, kw = 9, 8, 4, 3, 3
    mem = np.zeros(2000, np.float32)
    mem[: ih * iw * ci] = rng.randn(ih * iw * ci)
    mem[600: 600 + kh * kw * ci] = rng.randn(kh * kw * ci)
    _match_jax(conv2d_fwd_template(ih, iw, ci, kh, kw, 1, 0, 600, 1200), mem)


def test_copy_and_memset_bit_identical():
    rng = np.random.RandomState(2)
    mem = rng.randn(256).astype(np.float32)
    _match_jax(NtxCommand(loops=(8, 6, 1, 1, 1), opcode="copy", agu_rd0=_agu(0, 1, 8),
                          agu_wr=_agu(100, 6, 1), init_level=0, store_level=0), mem)
    _match_jax(NtxCommand(loops=(10, 4, 1, 1, 1), opcode="memset", agu_rd0=_agu(0),
                          agu_wr=_agu(50, 2, 20), init_level=0, store_level=0,
                          init_value=-3.25), mem)


def test_aliasing_read_write_falls_back_correctly():
    """An in-place prefix shift (reads [0, 16), writes [8, 24)): the fast path
    refuses, the loops give the sequential answer, and so does the kernel's
    sequential mode."""
    rng = np.random.RandomState(3)
    mem = rng.randn(64).astype(np.float32)
    cmd = NtxCommand(loops=(16, 1, 1, 1, 1), opcode="copy", agu_rd0=_agu(0, 1),
                     agu_wr=_agu(8, 1), init_level=0, store_level=0)
    want = _match_jax(cmd, mem)
    assert not ntx._execute_vectorized(cmd, torch.from_numpy(mem.copy()), True)
    t = torch.from_numpy(mem.copy())
    assert ntx_exec.emulate(cmd, t) == ntx_exec.SEQUENTIAL
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_randomized_commands_bit_identical(seed):
    """Random loops, strides and opcodes: every path of the port and of JAX
    gives the same bits."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(30):
        cmd = _random_command(rng, ("mac", "copy", "memset", "vadd", "relu", "vmax"))
        mem = rng.randn(400).astype(np.float32)
        _match_jax(cmd, mem, wide=bool(rng.randint(2)))


@pytest.mark.parametrize("seed", range(2))
def test_randomized_commands_every_opcode(seed):
    """Every opcode, random loops and strides; vexp within EXP_ULPS of JAX."""
    rng = np.random.RandomState(300 + seed)
    for op in ntx._OPS:
        for _ in range(4):
            cmd = _random_command(rng, (op,))
            mem = (rng.rand(400) + 0.25).astype(np.float32)  # > 0 for vrsqrt
            mem[::3] *= -1
            if op == "vrsqrt":
                mem = np.abs(mem)
            _match_jax(cmd, mem, wide=bool(rng.randint(2)), ulps=EXP_ULPS if op == "vexp" else 0)


def test_inplace_execution_mutates_and_matches():
    rng = np.random.RandomState(5)
    mem = torch.from_numpy(rng.randn(200).astype(np.float32))
    cmd = matmul_template(4, 5, 6, 0, 60, 120)
    copied = ntx.ntx_execute(cmd, mem)
    inplace = mem.clone()
    assert ntx.ntx_execute(cmd, inplace, inplace=True) is inplace
    assert torch.equal(copied, inplace)


def test_execute_takes_flat_float32_tensors_only():
    cmd = matmul_template(2, 2, 2, 0, 4, 8)
    with pytest.raises(TypeError, match="tensor"):
        ntx.ntx_execute(cmd, np.zeros(16, np.float32))
    with pytest.raises(ValueError, match="flat float32"):
        ntx.ntx_execute(cmd, torch.zeros(4, 4))
    with pytest.raises(ValueError, match="flat float32"):
        ntx.ntx_execute(cmd, torch.zeros(16, dtype=torch.float64))
    ntx_exec.COUNTER.reset()
    ntx.ntx_execute(cmd, torch.zeros(16))
    assert (ntx_exec.COUNTER.launches, ntx_exec.COUNTER.plain_calls) == (0, 1)


# -- opcode edge cases (tests/test_ntx_opcodes.py) ----------------------------


def test_memset_fills_strided_region():
    mem = np.arange(32, dtype=np.float32)
    cmd = NtxCommand(loops=(8, 1, 1, 1, 1), opcode="memset", agu_rd0=_agu(0, 0),
                     agu_wr=_agu(4, 2), init_level=MAX_LOOPS, store_level=0, init_value=7.5)
    out = _match_jax(cmd, mem)
    np.testing.assert_array_equal(out[4:20:2], np.full(8, 7.5, np.float32))


def test_copy_transposes_via_agus():
    rows, cols = 3, 4
    mem = np.zeros(50, np.float32)
    mem[: rows * cols] = np.arange(rows * cols)
    cmd = NtxCommand(loops=(cols, rows, 1, 1, 1), opcode="copy", agu_rd0=_agu(0, 1, cols),
                     agu_wr=_agu(20, rows, 1), init_level=0, store_level=0)
    out = _match_jax(cmd, mem)
    want = mem[: rows * cols].reshape(rows, cols).T
    np.testing.assert_array_equal(out[20: 20 + rows * cols].reshape(cols, rows), want)


def test_argmax_writes_index():
    vec = np.array([3.0, -1.0, 9.0, 9.0, 2.0], np.float32)  # the first max wins
    mem = np.concatenate([vec, np.zeros(3, np.float32)])
    cmd = NtxCommand(loops=(5, 1, 1, 1, 1), opcode="argmax", agu_rd0=_agu(0, 1),
                     agu_wr=_agu(6, 0), init_level=MAX_LOOPS, store_level=1)
    assert _match_jax(cmd, mem)[6] == 2.0


def test_argmax_per_row_with_init_level():
    x = np.array([[1.0, 5.0, 2.0], [7.0, 0.0, 3.0]], np.float32)
    mem = np.concatenate([x.ravel(), np.zeros(4, np.float32)])
    cmd = NtxCommand(loops=(3, 2, 1, 1, 1), opcode="argmax", agu_rd0=_agu(0, 1, 3),
                     agu_wr=_agu(8, 0, 1), init_level=1, store_level=1)
    np.testing.assert_array_equal(_match_jax(cmd, mem)[8:10], [1.0, 0.0])


@pytest.mark.parametrize("op,fn", [("vmax", np.max), ("vmin", np.min)])
def test_vmax_vmin_ignore_init_value(op, fn):
    vec = np.random.RandomState(0).randn(16).astype(np.float32) - 5.0
    mem = np.concatenate([vec, np.zeros(2, np.float32)])
    cmd = NtxCommand(loops=(16, 1, 1, 1, 1), opcode=op, agu_rd0=_agu(0, 1),
                     agu_wr=_agu(17, 0), init_level=1, store_level=1, init_value=0.0)
    assert _match_jax(cmd, mem)[17] == np.float32(fn(vec))


def test_relu_and_vadd_elementwise():
    a = np.array([-2.0, 3.0, -0.5, 4.0], np.float32)
    b = np.ones(4, np.float32)
    mem = np.concatenate([a, b, np.zeros(8, np.float32)])
    relu = NtxCommand(loops=(4, 1, 1, 1, 1), opcode="relu", agu_rd0=_agu(0, 1),
                      agu_wr=_agu(8, 1), init_level=0, store_level=0)
    np.testing.assert_array_equal(_match_jax(relu, mem)[8:12], np.maximum(a, 0.0))
    vadd = NtxCommand(loops=(4, 1, 1, 1, 1), opcode="vadd", agu_rd0=_agu(0, 1),
                      agu_rd1=_agu(4, 1), agu_wr=_agu(8, 1), init_level=0, store_level=0)
    np.testing.assert_array_equal(_match_jax(vadd, mem)[8:12], a + b)


def test_mac_init_level_max_is_one_running_sum():
    x = np.ones(12, np.float32)
    mem = np.concatenate([x, x, np.zeros(2, np.float32)])
    cmd = NtxCommand(loops=(4, 3, 1, 1, 1), opcode="mac", agu_rd0=_agu(0, 1, 4),
                     agu_rd1=_agu(12, 1, 4), agu_wr=_agu(25, 0, 0),
                     init_level=MAX_LOOPS, store_level=2, init_value=100.0)
    assert _match_jax(cmd, mem)[25] == 112.0


def test_mac_store_level_0_streams_partial_sums():
    x = np.array([1.0, 2.0, 3.0], np.float32)
    mem = np.concatenate([x, np.ones(3, np.float32), np.zeros(4, np.float32)])
    cmd = NtxCommand(loops=(3, 1, 1, 1, 1), opcode="mac", agu_rd0=_agu(0, 1),
                     agu_rd1=_agu(3, 1), agu_wr=_agu(6, 1), init_level=MAX_LOOPS, store_level=0)
    np.testing.assert_array_equal(_match_jax(cmd, mem)[6:9], np.cumsum(x))


def test_wide_false_rounds_every_fma():
    rng = np.random.RandomState(4)
    k = 2048
    a = (rng.randn(k) * 10.0 ** rng.uniform(-3, 3, k)).astype(np.float32)
    b = rng.randn(k).astype(np.float32)
    mem = np.concatenate([a, b, np.zeros(1, np.float32)])
    cmd = matmul_template(1, 1, k, 0, k, 2 * k)
    ref = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    wide = float(_match_jax(cmd, mem, wide=True)[2 * k])
    narrow = float(_match_jax(cmd, mem, wide=False)[2 * k])
    assert abs(wide - ref) <= abs(narrow - ref)


@pytest.mark.parametrize("op", ["sign", "cmpge", "vexp", "vrecip", "vrsqrt"])
def test_softmax_and_mask_helpers_match_jax(op):
    """The helper opcodes of the loss gradient and the backward masks,
    streaming over 300 values; vexp within EXP_ULPS."""
    rng = np.random.RandomState(9)
    n = 300
    x = (rng.randn(n) * 3).astype(np.float32)
    if op == "vrsqrt":
        x = np.abs(x) + 0.1
    mem = np.concatenate([x, np.round(rng.randn(n)).astype(np.float32), np.zeros(n, np.float32)])
    cmd = NtxCommand(loops=(n, 1, 1, 1, 1), opcode=op, agu_rd0=_agu(0, 1),
                     agu_rd1=_agu(n, 1) if op == "cmpge" else None, agu_wr=_agu(2 * n, 1),
                     init_level=0, store_level=0)
    _match_jax(cmd, mem, ulps=EXP_ULPS if op == "vexp" else 0)


def test_invalid_commands_rejected():
    with pytest.raises(ValueError):
        NtxCommand(loops=(1, 1, 1, 1), opcode="mac", agu_rd0=_agu(0, 1))
    with pytest.raises(ValueError):
        NtxCommand(loops=(1, 1, 1, 1, 1), opcode="nope", agu_rd0=_agu(0, 1))
    with pytest.raises(ValueError):
        NtxCommand(loops=(0, 1, 1, 1, 1), opcode="mac", agu_rd0=_agu(0, 1))
    with pytest.raises(ValueError):
        Agu(0, (1, 2))


# -- the command kernel's modes, emulated -------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_kernel_thread_split_changes_no_bit(seed):
    """Random commands of every opcode: the kernel's mode cuts each into
    threads; running them in reverse and in shuffled order gives the
    sequential interpreter's bits (vexp: the same exp both ways)."""
    rng = np.random.RandomState(500 + seed)
    seen = set()
    for i in range(60):
        cmd = _random_command(rng, ntx._OPS)
        if i % 10 == 0:  # a streaming one: dense unique writes, away from the reads
            dense = [int(np.prod(cmd.loops[:j])) for j in range(MAX_LOOPS)]
            cmd = dataclasses.replace(cmd, opcode=("relu", "vmul", "memset")[i % 3],
                                      agu_rd0=_agu(0, *dense), agu_rd1=_agu(0, *dense),
                                      agu_wr=_agu(250, *dense), store_level=0)
        mem = np.abs(rng.randn(400)).astype(np.float32) + 0.1
        wide = bool(i % 2)
        want = torch.from_numpy(mem.copy())
        ntx._execute_loops(cmd, want, wide)
        for order in (None, "shuffled"):
            got = torch.from_numpy(mem.copy())
            if order is not None:
                n = int(ntx_exec._row(cmd, ntx_exec.command_mode(cmd, 400))[11])
                order = rng.permutation(n).tolist()
            seen.add(ntx_exec.emulate(cmd, got, wide=wide, order=order))
            assert torch.equal(got, want), repr(cmd)
    assert seen == {ntx_exec.SEQUENTIAL, ntx_exec.REGION, ntx_exec.STREAMING}


def test_command_modes():
    """The mode planning on the shapes the training step uses."""
    size = 10_000
    mm = matmul_template(8, 6, 12, 0, 200, 500)
    assert ntx_exec.command_mode(mm, size) == ntx_exec.REGION
    relu = NtxCommand(loops=(64, 1, 1, 1, 1), opcode="relu", agu_rd0=_agu(0, 1),
                      agu_wr=_agu(100, 1), init_level=0, store_level=0)
    assert ntx_exec.command_mode(relu, size) == ntx_exec.STREAMING
    spill = NtxCommand(loops=(64, 1, 1, 1, 1), opcode="copy", agu_rd0=_agu(100, 1),
                       agu_wr=_agu(100, 1), init_level=0, store_level=0)
    assert ntx_exec.command_mode(spill, size) == ntx_exec.STREAMING  # identity copy
    # the pair-mac SGD update: rd0 spans w .. dW, over w_new in between; the
    # JAX fast path refuses it, the exact check finds the regions apart
    pair = NtxCommand(loops=(2, 50, 1, 1, 1), opcode="mac", agu_rd0=_agu(0, 200, 1),
                      agu_rd1=_agu(1000, 1, 0), agu_wr=_agu(100, 0, 1),
                      init_level=1, store_level=1)
    assert not ntx._spans_ok(pair, size)
    assert ntx_exec.command_mode(pair, size) == ntx_exec.REGION
    # a running sum over all iterations: one region, one thread
    total = NtxCommand(loops=(4, 3, 1, 1, 1), opcode="mac", agu_rd0=_agu(0, 1, 4),
                       agu_rd1=_agu(12, 1, 4), agu_wr=_agu(25, 0, 0),
                       init_level=MAX_LOOPS, store_level=2)
    assert ntx_exec.command_mode(total, size) == ntx_exec.REGION
    assert ntx_exec._row(total, ntx_exec.REGION)[11:13] == [1, 12]
    # a region reading what another region stores: sequential
    chain = NtxCommand(loops=(1, 8, 1, 1, 1), opcode="copy", agu_rd0=_agu(0, 0, 1),
                       agu_wr=_agu(1, 0, 1), init_level=1, store_level=1)
    assert ntx_exec.command_mode(chain, size) == ntx_exec.SEQUENTIAL
    negative = dataclasses.replace(relu, agu_rd0=_agu(-10, 1))
    assert ntx_exec.command_mode(negative, size) == ntx_exec.SEQUENTIAL
    with pytest.raises(ValueError, match="leave"):
        ntx_exec.command_mode(dataclasses.replace(relu, agu_wr=_agu(size - 10, 1)), size)


def test_command_table_rows():
    cmd = NtxCommand(loops=(3, 4, 1, 1, 1), opcode="vmax", agu_rd0=_agu(5, 1, 3),
                     agu_wr=_agu(40, 0, 1), init_level=1, store_level=1, init_value=-2.5)
    table, modes = ntx_exec.command_table([cmd], 100)
    row = table[0]
    assert table.shape == (1, ntx_exec.ROW_WORDS) and table.dtype == np.int64
    assert list(row[:9]) == [3, 4, 1, 1, 1, ntx._OPS.index("vmax"), 1, 1, ntx_exec.REGION]
    assert row[9:10].view(np.float64)[0] == -2.5
    assert list(row[10:16]) == [0b101, 4, 3, 5, 0, 40]
    assert list(row[16:21]) == [1, 3, 0, 0, 0] and list(row[26:31]) == [0, 1, 0, 0, 0]
    assert list(modes) == [ntx_exec.REGION]
