"""The port's model-zoo training step against the JAX package's, on the CPU.

``repro_torch.launch.train.make_train_step`` (``ParallelCtx(attn_backend=
"xla")``: blockwise attention, chunked SSD, autograd) against
``repro.launch.train.make_train_step`` on the reduced Qwen1.5-0.5B and
Mamba-2 780M configs (``reduce_config`` as it is: fp32), from JAX's
``init_train_state`` parameters (``convert.lm_params_from_jax``) and the
same batch: loss, ``ce``, ``grad_norm`` and the updated parameters at rtol
1e-4 / atol 1e-6, for SGD and AdamW (its moments too; see the test for the
elements whose gradient is at rounding level), and SGD with two
microbatches. In bf16 the step keeps every parameter's dtype, as
``tests/test_dtype_consistency.py`` asks of JAX's, and its gradients are
held per leaf against JAX's at ``BF16_GRAD_BAND``. ``flops`` and
``offload_step_report`` equal JAX's; the CLI's ``--backend xla`` runs on
the CPU; the first-step gate (step 0 against fp64) reads its limits here at
reduced size, and its control fails it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.launch import train as jtrain
from repro.models import flops as jflops
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import ParallelCtx as JaxCtx
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.pipeline import DataIterator, InMemoryDataset
from repro_torch.launch import train
from repro_torch.models import flops
from repro_torch.models.blocks import param_pytree
from repro_torch.models.config import ParallelCtx
from repro_torch.optim import optimizers as opt

ARCHS = ("qwen1_5_0_5b", "mamba2_780m")
TOL = {"rtol": 1e-4, "atol": 1e-6}
BATCH, SEQ = 4, 32
CTX_KW = dict(attn_backend="xla", block_kv=16, ssd_chunk=16)  # two KV blocks, two chunks
OPTS = {"sgd": lambda m: m.sgd(lr=0.05), "adamw": lambda m: m.adamw(lr=3e-3)}


def _configs(arch, dtype=None):
    jcfg, cfg = jax_reduce_config(jax_get_config(arch)), reduce_config(get_config(arch))
    if dtype is not None:
        jcfg, cfg = jcfg.with_(dtype=jnp.bfloat16), cfg.with_(dtype=torch.bfloat16)
    return jcfg, cfg


def _batch(cfg, batch=BATCH, seq=SEQ):
    ds = InMemoryDataset.synthetic(100_000, cfg.vocab_size, seq, seed=0)
    return next(DataIterator(ds, batch, seed=0))


def _port_params(jparams, cfg):
    return param_pytree(lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype):
    """JAX's ``init_train_state`` parameters (read-only arrays, shared by
    the tests of one config)."""
    return jtrain.init_train_state(jax.random.PRNGKey(0), _configs(arch, dtype)[0],
                                   jopt.sgd(0.1))["params"]


def _run_both(arch, opt_name, microbatches, dtype=None, with_grads=False):
    """One step of both packages from the same parameters and batch. With
    ``with_grads`` JAX's side also returns the gradients the step updates
    with (one microbatch), from the same jit."""
    jcfg, cfg = _configs(arch, dtype)
    jo, to = OPTS[opt_name](jopt), OPTS[opt_name](opt)
    jparams = _jax_params(arch, dtype)  # init_train_state's, as below
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32)}
    params = _port_params(jparams, cfg)
    state = {"params": params, "opt": to.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = _batch(cfg)
    jctx = JaxCtx(**CTX_KW)
    jstep = jtrain.make_train_step(jcfg, jctx, jo, num_microbatches=microbatches)

    def jfn(st, b):
        out = jstep(st, b)
        if with_grads:
            out = out + (jtrain._grads_and_metrics(st["params"], b, jcfg, jctx, 1)[0],)
        return out

    step = train.make_train_step(cfg, ParallelCtx(**CTX_KW), to,
                                 num_microbatches=microbatches)
    jout = jax.jit(jfn)(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = step(state, batch)
    return cfg, jout, (new, m), state


def _port_tree(jtree, cfg):
    """JAX's params-shaped pytree (params or a moment) in the port's layout."""
    return opt.tree_leaves(_port_params(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                     jtree), cfg.with_(dtype=torch.float32)))


@pytest.mark.parametrize("opt_name,microbatches", [("sgd", 1), ("adamw", 1), ("sgd", 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_matches_jax(arch, opt_name, microbatches):
    """SGD: every updated parameter at the band. AdamW divides each gradient
    element by its own magnitude, so an element whose gradient is at
    rounding level (|m| at most 1e-4 of its leaf's max|m|) moves by a step
    that rounding sets: those are held within 2·lr, every other element and
    both moments (atol of the leaf's max) at the band."""
    cfg, (jnew, jm), (new, m), old = _run_both(arch, opt_name, microbatches)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL)
    assert float(m["load_balance"]) == float(m["router_z"]) == 0.0
    assert int(new["step"]) == int(jnew["step"]) == 1 and new["step"].dtype == torch.int32
    want = opt.tree_leaves(_port_params(jnew["params"], cfg))
    got = opt.tree_leaves(new["params"])
    assert len(got) == len(want) == len(opt.tree_leaves(old["params"]))
    if opt_name == "adamw":
        keep = []
        for name in ("m", "v"):
            for g, w in zip(opt.tree_leaves(new["opt"][name]), _port_tree(jnew["opt"][name], cfg)):
                w = _np(w)
                scale = float(np.abs(w).max(initial=0.0))
                np.testing.assert_allclose(_np(g), w, rtol=TOL["rtol"],
                                           atol=TOL["atol"] * scale)
                if name == "m":  # a zero gradient (an unused token's row) is exact
                    keep.append((np.abs(w) > 1e-4 * scale) | (w == 0))
    else:
        keep = [np.ones(tuple(w.shape), bool) for w in want]
    moved = 0
    for g, w, o, k in zip(got, want, opt.tree_leaves(old["params"]), keep):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(_np(g)[k], _np(w)[k], **TOL)
        assert np.abs(_np(g)[~k] - _np(w)[~k]).max(initial=0.0) <= 2 * 3e-3
        moved += int(not torch.equal(g, o))
    assert moved > len(got) // 2  # the step moved the parameters
    assert int(new["opt"]["count"]) == 1


#: the bf16 gradients' band against JAX's, per leaf relative RMS: two bf16
#: computations of the step differ by about as much as either differs from
#: fp64 (one-ulp differences of bf16 activations, from other sum orders,
#: spread through the backward). Reduced configs, Qwen / Mamba-2: worst leaf
#: 0.030 / 0.043, median leaf 0.0125 / 0.0122, so the limits keep 2.3x-3.3x
#: and 1.6x. The band resolves what lies above that floor: a wrong or
#: missing term in a leaf, or gradients at fp8 precision (0.026 a leaf).
BF16_GRAD_BAND = {"worst": 0.1, "median": 0.02}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_keeps_dtypes_and_tracks_jax(arch):
    """The dtype check of tests/test_dtype_consistency.py on both packages,
    the bf16 metrics within 2e-2 of JAX's, and the bf16 gradients that the
    step updates with (``_grads_and_metrics``, both packages) per leaf
    within ``BF16_GRAD_BAND`` of JAX's."""
    cfg, (jnew, jm, jgrads), (new, m), old = _run_both(arch, "sgd", 1, dtype=torch.bfloat16,
                                                       with_grads=True)
    jleaves = jax.tree.leaves(jnew["params"])
    for a, b, c in zip(opt.tree_leaves(old["params"]), opt.tree_leaves(new["params"]),
                       opt.tree_leaves(_port_params(jnew["params"], cfg))):
        assert a.dtype == b.dtype == c.dtype
    assert {str(x.dtype) for x in jleaves} == {"bfloat16", "float32"}
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-2)
        assert m[k].dtype == torch.float32

    grads, _ = train._grads_and_metrics(old["params"], train.batch_to(_batch(cfg), "cpu"), cfg,
                                        ParallelCtx(**CTX_KW), 1)
    want = _port_params(jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads),
                        cfg.with_(dtype=torch.float32))
    assert all(g.dtype == p.dtype for g, p in
               zip(opt.tree_leaves(grads), opt.tree_leaves(old["params"])))
    rel = train.leaf_rel_rms(grads, want)
    assert len(rel) == len(opt.tree_leaves(grads))
    worst = max(rel, key=rel.get)
    assert rel[worst] <= BF16_GRAD_BAND["worst"], (worst, rel[worst])
    assert float(np.median(list(rel.values()))) <= BF16_GRAD_BAND["median"], rel


def test_microbatches_sum_in_fp32_and_cast_once():
    """Two microbatches of a batch give the mean of their gradients."""
    cfg = reduce_config(get_config("qwen1_5_0_5b"))
    st = train.init_train_state(0, cfg, opt.sgd(0.1), device="cpu")
    ctx = ParallelCtx(**CTX_KW)
    batch = train.batch_to(_batch(cfg), "cpu")
    g2, _ = train._grads_and_metrics(st["params"], batch, cfg, ctx, 2)
    halves = [train._grads_and_metrics(st["params"], {k: v[i * 2:(i + 1) * 2]
                                                      for k, v in batch.items()}, cfg, ctx, 1)[0]
              for i in range(2)]
    want = opt.tree_map(lambda a, b: ((a.float() + b.float()) / 2), *halves)
    for g, w in zip(opt.tree_leaves(g2), opt.tree_leaves(want)):
        assert torch.equal(g, w)


def test_mesh_with_dp_axes_is_refused_naming_a6b():
    cfg = reduce_config(get_config("qwen1_5_0_5b"))
    ctx = ParallelCtx(mesh=object(), dp_axes=("data",), attn_backend="xla")
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        train.make_train_step(cfg, ctx, opt.sgd(0.1), grad_sync="systolic")
    for sync in ("auto", "systolic", "compressed"):  # one device: every value runs
        train.make_train_step(cfg, ParallelCtx(attn_backend="xla"), opt.sgd(0.1),
                              grad_sync=sync)
    st = train.init_train_state(0, cfg, opt.sgd(0.1), "compressed", device="cpu")
    assert {tuple(e.shape) for e in opt.tree_leaves(st["err"])} == {
        (1,) + tuple(p.shape) for p in opt.tree_leaves(st["params"])}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_jax(arch, reduced):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jax_reduce_config(jcfg), reduce_config(cfg)
    assert dataclasses.asdict(flops.count(cfg)) == dataclasses.asdict(jflops.count(jcfg))
    for seq, batch in ((64, 8), (4096, 2)):
        assert flops.train_step_flops(cfg, seq, batch) == jflops.train_step_flops(jcfg, seq,
                                                                                  batch)
        assert flops.prefill_flops(cfg, seq, batch) == jflops.prefill_flops(jcfg, seq, batch)
        assert flops.decode_step_flops(cfg, seq, batch) == jflops.decode_step_flops(jcfg, seq,
                                                                                    batch)
        for kw in ({}, {"tp": 1, "dp": 1, "dtype_bytes": 4}):
            assert flops.train_hbm_bytes_per_chip(cfg, seq, batch, **kw) == \
                jflops.train_hbm_bytes_per_chip(jcfg, seq, batch, **kw)
            assert flops.prefill_hbm_bytes_per_chip(cfg, seq, batch, **kw) == \
                jflops.prefill_hbm_bytes_per_chip(jcfg, seq, batch, **kw)
            assert flops.decode_hbm_bytes_per_chip(cfg, seq, batch, **kw) == \
                jflops.decode_hbm_bytes_per_chip(jcfg, seq, batch, **kw)


def _same_report(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _same_report(g, w)
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0), k
        else:
            assert g == w and type(g) is type(w), k


@pytest.mark.parametrize("arch,reduced,seq,batch", [("qwen1_5_0_5b", True, 32, 4),
                                                    ("qwen1_5_0_5b", False, 64, 8),
                                                    ("mamba2_780m", True, 32, 4)])
def test_offload_step_report_equals_jax(arch, reduced, seq, batch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jax_reduce_config(jcfg), reduce_config(cfg)
    _same_report(train.offload_step_report(cfg, seq, batch, n_clusters=8, queue_depth=2),
                 jtrain.offload_step_report(jcfg, seq, batch, n_clusters=8, queue_depth=2))


def test_cli_backend_xla_on_the_cpu(tmp_path, capsys, monkeypatch):
    train._cli(["--backend", "xla", "--reduced", "--steps", "4", "--batch", "4", "--seq", "32",
                "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
                "--crash-at", "3", "--metrics", str(tmp_path / "m.jsonl"),
                "--offload-report"])
    out = capsys.readouterr().out
    assert "done: 5 steps, 1 restarts" in out  # step 3 replayed after the crash
    assert "offload step accounting (modeled NTX runtime):" in out
    assert "measured on cpu" in out
    from repro_torch import obs

    recs = obs.read_jsonl(tmp_path / "m.jsonl")
    assert [r["step"] for r in recs] == [1, 2, 3, 3, 4]
    assert recs[-1]["counters"]["restarts"] == 1
    assert {"loss", "ce", "grad_norm"} <= set(recs[-1]["metrics"])
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        train._cli(["--backend", "xla", "--arch", "llava_next_mistral_7b", "--device", "cpu"])
    import repro_torch.configs as configs

    stub = reduce_config(get_config("qwen1_5_0_5b")).with_(input_mode="embeddings")
    monkeypatch.setattr(configs, "get_config", lambda name: stub)
    with pytest.raises(SystemExit, match="CLI driver trains token-input archs"):
        train._cli(["--backend", "xla", "--device", "cpu", "--ckpt-dir", str(tmp_path / "e")])


def test_cli_without_cpu_raises_rather_than_falls_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run_xla_lm(reduced=True, steps=1, batch=2, seq=16, ckpt_dir=str(tmp_path))


def test_crash_and_restore_is_exact_and_the_off_by_one_control_is_not(tmp_path):
    """The card's gate B at reduced size: a crash at step 3 with checkpoints
    every 2 ends bit-identical to the uncrashed run; a restore whose
    iterator step is off by one does not."""
    kw = dict(reduced=True, steps=5, batch=2, seq=16, ckpt_every=2, device="cpu")
    ref = train.run_xla_lm(ckpt_dir=str(tmp_path / "a"), **kw)
    got = train.run_xla_lm(ckpt_dir=str(tmp_path / "b"), crash_at=3, **kw)

    class OffByOne(DataIterator):
        def load_state_dict(self, state):
            super().load_state_dict(dict(state, step=int(state["step"]) + 1))

    cfg = reduce_config(get_config("qwen1_5_0_5b"))
    bad = train.run_xla_lm(ckpt_dir=str(tmp_path / "c"), crash_at=3, iterator=OffByOne(
        InMemoryDataset.synthetic(2_000_000, cfg.vocab_size, 16, seed=0), 2), **kw)
    assert (got["report"].restarts, got["report"].steps_run) == (1, 6)
    assert not any(train.state_diff(got, ref).values())
    diff = train.state_diff(bad, ref)
    assert diff["params"] > 0 and diff["opt"] > 0 and diff["iterator"]
    assert float(ref["metrics"][-1]["ce"]) < float(ref["metrics"][0]["ce"])


def depth_readings(n_layers: int) -> dict:
    """The p10 leaf against the fp64 step, at ``n_layers`` (below), of the
    port's bf16 step, JAX's, and the three controls; and JAX's
    :func:`train.leaf_readings`."""
    arch = "mamba2_780m"
    jcfg = jax_reduce_config(jax_get_config(arch)).with_(dtype=jnp.bfloat16, n_layers=n_layers)
    cfg = reduce_config(get_config(arch)).with_(dtype=torch.bfloat16, n_layers=n_layers)
    jparams = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt.sgd(0.1))["params"]
    params = _port_params(jparams, cfg)
    batch = _batch(cfg, 8, 64)
    tbatch = train.batch_to(batch, "cpu")
    ctx = ParallelCtx(attn_backend="xla", ssd_chunk=16)
    jctx = JaxCtx(attn_backend="xla", ssd_chunk=16)
    cfg64 = cfg.with_(dtype=torch.float64)
    p64 = opt.tree_map(lambda p: p.double(), params)
    g64 = train._grads_and_metrics(p64, tbatch, cfg64, ctx, 1)[0]
    jgrads = jax.jit(lambda p, b: jtrain._grads_and_metrics(p, b, jcfg, jctx, 1)[0])(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = _port_params(jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads),
                          cfg.with_(dtype=torch.float32))
    p32 = opt.tree_map(lambda p: p.float(), params)
    runs = {
        "port": train._grads_and_metrics(params, tbatch, cfg, ctx, 1)[0],
        "jax": jgrads,
        "e4m3 grads": opt.tree_map(train.fp8_rounded, g64),
        "e4m3 weights": train._grads_and_metrics(opt.tree_map(train.fp8_rounded, p64), tbatch,
                                                 cfg64, ctx, 1)[0],
        "fp32": train._grads_and_metrics(p32, tbatch, cfg.with_(dtype=torch.float32), ctx,
                                         1)[0],
    }
    out = {k: train.leaf_readings(g, g64) for k, g in runs.items()}
    return {"p10": {k: r["p10_leaf_rel_rms"] for k, r in out.items()}, "jax": out["jax"]}


@pytest.mark.parametrize("n_layers", [12, 48])
def test_bf16_step_grows_with_depth_as_jax_does(n_layers):
    """ROADMAP C8: in bf16 the first step's gradients lie as far from fp64
    as JAX's own bf16 step's do, at depth. Mamba-2 780M at its
    ``reduce_config`` widths cut to ``n_layers``, batch 8, seq 64,
    ssd_chunk 16 (JAX's unmasked 64-token chunk is NaN there, C7), the same
    parameters and batch: the port's p10 leaf against the fp64 step within
    ``DEPTH_FACTOR`` of JAX's, both ways (``python
    tests/test_torch_train_lm.py`` prints the readings). Controls outside
    that band: the fp64 gradients through amax-scaled e4m3 (rounded once,
    at the end), the fp64 step from weights through e4m3, the step on the
    same weights in fp32. At 48 layers JAX's readings are
    ``JAX_BF16_48_LAYERS``, from which chip_smoke.py's gate on the
    full-width step takes its limits."""
    r = depth_readings(n_layers)
    ratio = {k: v / r["p10"]["jax"] for k, v in r["p10"].items()}
    band = (1 / train.DEPTH_FACTOR, train.DEPTH_FACTOR)
    assert band[0] <= ratio["port"] <= band[1], r["p10"]
    for k in ("e4m3 grads", "e4m3 weights", "fp32"):
        assert not band[0] <= ratio[k] <= band[1], (k, r["p10"])
    if n_layers == 48:
        for k, v in train.JAX_BF16_48_LAYERS.items():
            np.testing.assert_allclose(r["jax"][k], v, rtol=0.05)


def test_first_step_gate_reads_under_its_limits_and_rejects_its_control():
    for arch in ARCHS:
        cfg = reduce_config(get_config(arch)).with_(dtype=torch.bfloat16)
        st = train.init_train_state(0, cfg, opt.adamw(3e-3), device="cpu")
        batch = _batch(cfg, 8, 64)
        ctx = ParallelCtx(attn_backend="xla")
        r = train.first_step_readings(cfg, st["params"], batch, ctx)
        assert train.first_step_passes(r), r
        assert len(r["leaves"]) == len(opt.tree_leaves(st["params"]))
        ctl = train.first_step_readings(cfg, st["params"], batch, ctx,
                                        control=train.fp8_rounded)
        assert not train.first_step_passes(ctl)
        # only the p10 reading tells a 3-mantissa-bit gradient from the step's
        lim = train.FIRST_STEP_LIMITS
        assert ctl["p10_leaf_rel_rms"] > lim["p10_leaf_rel_rms"]
        assert all(ctl[k] <= lim[k] for k in lim if k != "p10_leaf_rel_rms"), ctl
        # the deep gate's control: the step from weights through e4m3
        assert not train.first_step_passes(train.first_step_readings(
            cfg, st["params"], batch, ctx, weights_control=train.fp8_rounded))


if __name__ == "__main__":
    for n in (12, 48):
        r = depth_readings(n)
        print(f"{n} layers, p10 leaf vs fp64:", {k: round(v, 4) for k, v in r["p10"].items()},
              f"JAX's worst leaf {r['jax']['leaf_rel_rms']:.4f}")
