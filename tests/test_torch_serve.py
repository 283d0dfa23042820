"""The port's decode step and serving against the JAX package's, on the CPU.

Parameters come from the JAX ``init_lm`` through ``lm_params_from_jax``;
token ids are made with numpy from a seed. Every family of
``tests/test_models.py`` whose layer kinds the port has (``dense``,
``dense_bias_qknorm``, ``swa`` with window 8 over 16 steps so that the
ring buffer wraps, ``tied``, ``layernorm_gelu``, ``ssm``,
``audio_codebooks``) runs 16 decode steps in fp32:

* against the port's own ``forward`` of the same tokens, within 1e-4 (as
  JAX's ``test_decode_matches_forward``);
* against JAX's ``serve_step`` step by step, logits and the final cache
  (through ``lm_cache_from_jax``) at rtol 1e-5 / atol 1e-6 · max(1,
  max|want|), the max taken over each step's logits and over each layer's
  cache; also from JAX's cache at position 5. Both packages drift from
  fp64 over four fp32 layers: the closest reading is the qk-norm family's
  last k cache, 1.26e-6 of the layer's max off JAX where JAX itself is
  8.6e-7 off the same decode in fp64;

the reduced ``qwen1_5_0_5b`` and ``mamba2_780m`` in bf16 at the bf16 band
of ``tests/test_torch_blockwise.py`` (atol 2e-2 · max). The two controls of
the decode-against-prefill gate (positions one late; the cache rounded to
bf16 after each step) must fail the forward check. ``greedy_decode`` is
held to JAX's tokens wherever JAX's top-two margin exceeds 1e-3.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.launch.serve import greedy_decode as jax_greedy_decode
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import ParallelCtx as JaxCtx
from repro_torch.convert import _flatten, lm_cache_from_jax, lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ParallelCtx

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  the decode gates' readings and controls

F32 = {"rtol": 1e-5, "atol": 1e-6}
FORWARD_ATOL = 1e-4  # tests/test_models.py::test_decode_matches_forward
BF16_ATOL = 2e-2  # of max|want|, tests/test_torch_blockwise.py's bf16 band
JCTX = JaxCtx(attn_backend="xla")
CTX = ParallelCtx(attn_backend="xla")
BATCH, STEPS, START = 2, 16, 5
# gate S2 on the reduced configs on the CPU, where the bf16 decode and
# prefill share every plain operation: seeds 0-2 read at most 0.00083
# (Mamba-2) and 0.00028 (Qwen), their e4m3 controls at least 0.0147 and
# 0.0682 (`python tests/test_torch_serve.py`)
REDUCED_BF16_RMS = 1e-2


def _tiny(name, **kw):  # tests/test_models.py::tiny
    base = dict(name=name, family="dense", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=97, dtype=jnp.float32)
    return JaxModelConfig(**{**base, **kw})


# the families of tests/test_models.py whose layer kinds the port has
FAMILIES = {
    "dense": _tiny("dense"),
    "dense_bias_qknorm": _tiny("dbq", qkv_bias=True, qk_norm=True),
    "swa": _tiny("swa", pattern=(("swa", "mlp"),), window=8),
    "tied": _tiny("tied", tie_embeddings=True, embed_scale=True),
    "layernorm_gelu": _tiny("ln", norm_type="layer", mlp_act="gelu"),
    "ssm": _tiny("ssm", family="ssm", pattern=(("ssm", None),), n_heads=8, ssm_headdim=16,
                 ssm_state=16, ssm_groups=2),
    "audio_codebooks": _tiny("audio", family="audio", n_codebooks=2, vocab_size=32),
}
SERVED = {"qwen1_5_0_5b": jax_reduce_config(jax_get_config("qwen1_5_0_5b")),
          "mamba2_780m": jax_reduce_config(jax_get_config("mamba2_780m"))}


def _port_config(jcfg, dtype) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JaxModelConfig)}
    return ModelConfig(**{**kw, "dtype": dtype})


def _tokens(cfg, seed=1):
    shape = (BATCH, STEPS, cfg.n_codebooks) if cfg.n_codebooks > 1 else (BATCH, STEPS)
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, tol, scale=None):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if scale is None else scale
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _flat_cache(tree) -> dict:
    """``{"units.<pos>.<u>.<key>" | "rem.<i>.<key>": tensor}`` of a port cache."""
    return dict(_flatten(tree))


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, dtype: str = "f32"):
    """JAX's 16 decode steps of a config: each step's logits, the numpy cache
    after step START - 1 and after the last step, and the numpy parameters."""
    jcfg = (FAMILIES | SERVED)[name]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jcfg = jcfg.with_(dtype=jdt)
    jparams = jlm.init_lm(jax.random.PRNGKey(1), jcfg)
    tokens = _tokens(jcfg)
    cache = jlm.init_cache(jcfg, BATCH, STEPS, dtype=jdt)
    step = jax.jit(lambda p, c, t, pos: jlm.serve_step(p, c, t, pos, jcfg, JCTX))
    logits, mid = [], None
    for t in range(STEPS):
        if t == START:
            mid = jax.tree.map(np.asarray, cache)
        lg, cache = step(jparams, cache, jnp.asarray(tokens[:, t]), jnp.int32(t))
        logits.append(np.asarray(lg.astype(jnp.float32)))
    return (np.stack(logits, axis=1), mid, jax.tree.map(np.asarray, cache),
            jax.tree.map(np.asarray, jparams), tokens)


def _port(name: str, dtype=torch.float32):
    jcfg = (FAMILIES | SERVED)[name]
    cfg = _port_config(jcfg, dtype)
    jdt = "f32" if dtype == torch.float32 else "bf16"
    want, mid, final, np_params, tokens = _jax_run(name, jdt)
    return cfg, lm_params_from_jax(np_params, cfg, "cpu"), torch.from_numpy(tokens), want, \
        mid, final


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_decode_matches_forward_and_jax(name):
    cfg, params, tokens, want, _, final = _port(name)
    got, cache = serve.teacher_force(params, cfg, CTX, tokens, device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == (BATCH, STEPS, *((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()),
                         cfg.vocab_size)
    fwd, _ = lm.forward(params, tokens, cfg, CTX)
    assert float((got - fwd).abs().max()) <= FORWARD_ATOL
    for t in range(STEPS):  # step by step
        _close(got[:, t], want[:, t], F32)
    # the final cache layer by layer, atol of max(1, max|want|) over the layer's cache
    want_cache = _flat_cache(lm_cache_from_jax(final, cfg, "cpu"))
    got_cache = _flat_cache(cache)
    assert set(got_cache) == set(want_cache)
    layer_max: dict[str, float] = {}
    for k, v in want_cache.items():
        layer = k.rsplit(".", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 1.0), float(v.abs().max()))
    for k, v in want_cache.items():
        assert got_cache[k].dtype == v.dtype and got_cache[k].shape == v.shape, k
        _close(got_cache[k], v.numpy(), F32, scale=layer_max[k.rsplit(".", 1)[0]])
    if name == "swa":  # the ring buffer wrapped: 16 steps through 8 slots
        assert got_cache["units.0.0.k"].shape[2] == cfg.window < STEPS


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_decode_from_a_jax_cache_mid_stream(name):
    """The port takes over JAX's cache at position 5 and decodes the rest."""
    cfg, params, tokens, want, mid, _ = _port(name)
    cache = lm_cache_from_jax(mid, cfg, "cpu")
    got, _ = serve.teacher_force(params, cfg, CTX, tokens[:, START:], cache=cache, start=START)
    _close(got, want[:, START:], F32)


@pytest.mark.parametrize("name", sorted(SERVED))
def test_bf16_decode_matches_jax(name):
    cfg, params, tokens, want, _, _ = _port(name, torch.bfloat16)
    got, cache = serve.teacher_force(params, cfg, CTX, tokens, device="cpu")
    scale = float(np.abs(want).max())
    assert float((got - torch.from_numpy(want)).abs().max()) <= BF16_ATOL * scale
    kinds = {k.rsplit(".", 1)[1]: v.dtype for k, v in _flat_cache(cache).items()}
    assert kinds == ({"conv": torch.bfloat16, "ssm": torch.float32} if cfg.ssm_state
                     else {"k": torch.bfloat16, "v": torch.bfloat16})


@pytest.mark.parametrize("control", ["shifted_positions", "cache_bf16"])
@pytest.mark.parametrize("name", ["dense", "ssm"])
def test_gate_controls_fail_the_forward_check(name, control):
    """The decode-against-prefill gate's controls, each read through the
    check above: positions one late (RoPE and the slot, or the conv history)
    and the KV cache or SSM state rounded to bf16 after every step."""
    cfg, params, tokens, _, _, _ = _port(name)
    step = serve.make_serve_step(cfg, CTX)
    if control == "shifted_positions":
        step = chip_smoke.shifted_positions(step)
    else:
        step = chip_smoke.rounded_cache(step, lambda t: t.to(torch.bfloat16).to(t.dtype))
    got, _ = serve.teacher_force(params, cfg, CTX, tokens, step=step, max_len=STEPS + 1,
                                 device="cpu")
    fwd, _ = lm.forward(params, tokens, cfg, CTX)
    assert float((got - fwd).abs().max()) > FORWARD_ATOL


def gate_readings(arch: str, seed: int = 0) -> dict:
    """chip_smoke.py's decode-against-prefill gates on the reduced config
    (port only; the kernel route's plain versions on the CPU), batch 4, 64
    tokens: S1 in fp32 with its two controls, S2 in bf16 with its e4m3
    control."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.train import fp8_rounded

    cs = chip_smoke
    cfg = reduce_config(get_config(arch)).with_(dtype=torch.bfloat16)
    ctx = ParallelCtx()
    params = lm.init_lm(cfg, seed=seed, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(seed).randint(0, cfg.vocab_size, (4, 64)))
    out = {}
    step = serve.make_serve_step(cfg, ctx)
    pre16 = lm.prefill(params, tokens, cfg, ctx)
    out["s2"] = cs.rel_rms(serve.teacher_force(params, cfg, ctx, tokens, device="cpu")[0],
                           pre16)
    out["s2_e4m3"] = cs.rel_rms(serve.teacher_force(
        params, cfg, ctx, tokens, device="cpu", step=cs.rounded_cache(step, fp8_rounded))[0],
        pre16)
    params.to(torch.float32)
    cfg = cfg.with_(dtype=torch.float32)
    step = serve.make_serve_step(cfg, ctx)
    pre32 = lm.prefill(params, tokens, cfg, ctx)
    out["s1"] = cs.worst_row(serve.teacher_force(params, cfg, ctx, tokens, device="cpu")[0],
                             pre32)
    out["s1_late"] = cs.worst_row(serve.teacher_force(
        params, cfg, ctx, tokens, step=cs.shifted_positions(step), max_len=65,
        device="cpu")[0], pre32)
    out["s1_bf16"] = cs.worst_row(serve.teacher_force(
        params, cfg, ctx, tokens, device="cpu",
        step=cs.rounded_cache(step, lambda t: t.to(torch.bfloat16).to(t.dtype)))[0], pre32)
    return out


@pytest.mark.parametrize("arch", sorted(SERVED))
def test_decode_against_prefill_gates_and_their_controls(arch):
    r = gate_readings(arch)
    tol = chip_smoke.PREFILL_TOL["float32"]
    assert r["s1"] <= tol
    assert r["s1_late"] > tol and r["s1_bf16"] > tol
    assert r["s2"] <= REDUCED_BF16_RMS < r["s2_e4m3"]


def test_greedy_decode_takes_jax_tokens_where_the_margin_is_clear():
    """tests/test_system.py's greedy decode (reduced qwen, vocab 64): JAX's
    tokens teacher-forced through the port give the same argmax wherever
    JAX's top-two logit margin exceeds 1e-3."""
    jcfg = jax_reduce_config(jax_get_config("qwen1_5_0_5b")).with_(vocab_size=64)
    cfg = _port_config(jcfg, torch.float32)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    max_new = 6
    jout = np.asarray(jax_greedy_decode(jparams, jcfg, JCTX, jnp.asarray(prompt), max_new))
    seq = np.concatenate([prompt, jout], axis=1)  # (2, 10)
    jcache = jlm.init_cache(jcfg, 2, seq.shape[1], dtype=jnp.float32)
    jlogits = []
    for t in range(seq.shape[1] - 1):
        lg, jcache = jlm.serve_step(jparams, jcache, jnp.asarray(seq[:, t]), jnp.int32(t),
                                    jcfg, JCTX)
        jlogits.append(np.asarray(lg))
    jlogits = np.stack(jlogits, axis=1)[:, prompt.shape[1] - 1:]  # predicts jout
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.mean() > 0.5

    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got, _ = serve.teacher_force(params, cfg, CTX, torch.from_numpy(seq[:, :-1]), device="cpu")
    got_tokens = got[:, prompt.shape[1] - 1:].argmax(-1).numpy()
    np.testing.assert_array_equal(got_tokens[clear], jout[clear])

    out = serve.greedy_decode(params, cfg, CTX, torch.from_numpy(prompt), max_new, device="cpu")
    assert out.shape == (2, max_new) and out.dtype == torch.int32
    assert bool((out >= 0).all()) and bool((out < cfg.vocab_size).all())
    if clear.all():
        np.testing.assert_array_equal(out.numpy(), jout)


def test_entry_points_refuse_without_a_card_and_past_the_cache(monkeypatch):
    """Without ``device="cpu"`` the entry points ask for the card and, with
    none, raise rather than fall back; a position past a windowless cache,
    or past a ring shorter than its window, raises where JAX's update would
    clamp or wrap it; a ring that holds the whole window wraps."""
    cfg, params, tokens, _, _, _ = _port("dense")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, BATCH, STEPS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.greedy_decode(params, cfg, CTX, tokens[:, :4], 2)
    cache = lm.init_cache(cfg, BATCH, 4, device="cpu")
    with pytest.raises(IndexError, match="outside the KV cache"):
        lm.serve_step(params, cache, tokens[:, 0], 4, cfg, CTX)
    swa_cfg, swa_params, swa_tokens, _, _, _ = _port("swa")
    short = lm.init_cache(swa_cfg, BATCH, 4, device="cpu")  # 4 slots, window 8
    with pytest.raises(IndexError, match="outside the KV cache"):
        lm.serve_step(swa_params, short, swa_tokens[:, 0], 4, swa_cfg, CTX)
    ring = lm.init_cache(swa_cfg, BATCH, 32, device="cpu")  # the window's 8 slots
    assert ring["units"][0][0]["k"].shape[2] == swa_cfg.window
    lm.serve_step(swa_params, ring, swa_tokens[:, 0], 9, swa_cfg, CTX)


def test_lm_cache_from_jax_checks_names_shapes_and_dtypes():
    cfg, _, _, _, _, final = _port("ssm")
    tree = lm_cache_from_jax(final, cfg, "cpu")
    assert len(tree["units"]) == 1 and len(tree["units"][0]) == cfg.n_layers
    np.testing.assert_array_equal(tree["units"][0][2]["ssm"].numpy(),
                                  final["units"][0]["ssm"][2])
    bad = jax.tree.map(lambda a: a, final)
    bad["units"][0]["ssm"] = bad["units"][0]["ssm"][..., :8]
    with pytest.raises(ValueError, match="ssm: expected"):
        lm_cache_from_jax(bad, cfg, "cpu")
    extra = {"units": final["units"], "rem": ({"k": final["units"][0]["conv"][0]},)}
    with pytest.raises(ValueError, match="cache names differ"):
        lm_cache_from_jax(extra, cfg, "cpu")


if __name__ == "__main__":
    for name in sorted(SERVED):
        for seed in (0, 1):
            print(name, f"seed {seed}:",
                  {k: float(f"{v:.3e}") for k, v in gate_readings(name, seed).items()})
