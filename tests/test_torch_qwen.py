"""The port's attention decoder against the JAX package's, on the CPU.

Parameters come from the JAX ``init_lm`` through ``lm_params_from_jax``;
activations and token ids are made with numpy from a seed. RoPE, the three
MLP activations, ``attention_block`` and ``lm.prefill`` of the reduced
``qwen1_5_0_5b`` are held against JAX with ``attn_backend="interpret"``
(the Pallas flash kernel in interpret mode) and ``"xla"`` (the blockwise
jnp path): fp32 at atol 1e-5 (the band of ``tests/test_models.py``), bf16
at 2e-2 of max|out| or max|logits|. The attention families of
``tests/test_models.py`` (GQA, QKV bias with qk-norm, sliding window, tied
and scaled embeddings, LayerNorm with GELU) are held in fp32. Only reduced
configs are built; the full ``qwen1_5_0_5b`` is checked field for field and
counted on the meta device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import ParallelCtx as JaxCtx
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, blocks, lm
from repro_torch.models.config import ModelConfig, ParallelCtx

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ACTS = ("swiglu", "geglu", "gelu")


def _tiny(name, **kw):  # tests/test_models.py::tiny
    base = dict(name=name, family="dense", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=97, dtype=jnp.float32)
    return JaxModelConfig(**{**base, **kw})


# the attention families of tests/test_models.py
FAMILIES = {
    "dense": _tiny("dense"),
    "dense_bias_qknorm": _tiny("dbq", qkv_bias=True, qk_norm=True),
    "swa": _tiny("swa", pattern=(("swa", "mlp"),), window=8),
    "tied": _tiny("tied", tie_embeddings=True, embed_scale=True),
    "layernorm_gelu": _tiny("ln", norm_type="layer", mlp_act="gelu"),
}
QWEN_REDUCED = jax_reduce_config(jax_get_config("qwen1_5_0_5b"))


def _port_config(jcfg, dtype) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JaxModelConfig)}
    return ModelConfig(**{**kw, "dtype": dtype})


def _params(jcfg, seed=0):
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _tokens(cfg, batch=2, seq=64, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def test_full_config_matches_jax_field_for_field():
    jcfg, cfg = jax_get_config("qwen1_5_0_5b"), get_config("qwen1_5_0_5b")
    for f in dataclasses.fields(JaxModelConfig):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if f.name == "dtype":
            assert (jnp.dtype(want).name, got) == ("bfloat16", torch.bfloat16)
        else:
            assert got == want, f.name
    assert get_config("qwen1.5-0.5b") is cfg


@pytest.mark.parametrize("name", ["qwen1_5_0_5b", "llava_next_mistral_7b", "qwen3_8b"])
def test_reduced_config_matches_jax(name):
    """qwen's own, and the window and GQA branches of the shrink on JAX's configs."""
    jcfg = jax_reduce_config(jax_get_config(name))
    assert reduce_config(_port_config(jax_get_config(name), torch.bfloat16)) == \
        _port_config(jcfg, torch.float32)


def test_parameter_count_on_meta_matches_jax_eval_shape():
    jcfg = jax_get_config("qwen1_5_0_5b")
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    params = lm.init_lm(get_config("qwen1_5_0_5b"), device="meta")
    got = sum(p.numel() for p in params.parameters())
    assert got == want == 463_987_712
    assert all(p.device.type == "meta" for p in params.parameters())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", ["qwen1_5_0_5b_reduced", "dense_bias_qknorm", "layernorm_gelu"])
def test_lm_params_from_jax_names_shapes_dtypes(name, dt):
    jdt, tdt = DTYPES[dt]
    jcfg = (QWEN_REDUCED if name == "qwen1_5_0_5b_reduced" else FAMILIES[name]).with_(dtype=jdt)
    cfg = _port_config(jcfg, tdt)
    _, np_params = _params(jcfg)
    converted = dict(lm_params_from_jax(np_params, cfg, "cpu").named_parameters())
    own = dict(lm.init_lm(cfg, seed=0, device="cpu").named_parameters())
    assert set(own) == set(converted)
    for k, v in own.items():
        assert (v.shape, v.dtype) == (converted[k].shape, converted[k].dtype), k
        if k.endswith(("scale", ".bias", ".bq", ".bk", ".bv")):  # constants: zeros / ones
            torch.testing.assert_close(v, converted[k], rtol=0, atol=0, msg=k)
    names = {k.split(".", 4)[-1] for k in own if k.startswith("decoder.units.0.")}
    want = {"norm1.scale", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "norm2.scale",
            "mlp.w_up", "mlp.w_down"}
    if cfg.norm_type == "layer":
        want |= {"norm1.bias", "norm2.bias"}
    if cfg.mlp_act != "gelu":
        want.add("mlp.w_gate")
    if cfg.qkv_bias:
        want |= {"attn.bq", "attn.bk", "attn.bv"}
    if cfg.qk_norm:
        want |= {"attn.q_norm.scale", "attn.k_norm.scale"}
    assert names == want
    wq = np_params["decoder"]["units"][0]["attn"]["wq"]
    for u in range(cfg.n_layers):
        got = converted[f"decoder.units.0.{u}.attn.wq"]
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(wq[u], np.float32))


def test_unported_layer_kinds_raise():
    cfg = reduce_config(get_config("qwen1_5_0_5b"))
    for kind in (("attn", "moe"), ("rec", "mlp")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lm.init_lm(cfg.with_(pattern=(kind,)), device="cpu")


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    x = np.random.RandomState(0).randn(2, 4, 256, 64).astype(np.float32)
    pos = np.arange(256)
    want = np.asarray(jblocks.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = blocks.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    freqs = np.asarray(jblocks.rope_frequencies(64, theta))
    np.testing.assert_allclose(blocks.rope_frequencies(64, theta).numpy(), freqs, rtol=1e-6)
    bf = blocks.apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), theta)
    want_bf = np.asarray(jblocks.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta),
                         np.float32)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), want_bf, atol=2e-2 * np.abs(want_bf).max())


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_mlp_matches_jax(act, dt):
    jdt, tdt = DTYPES[dt]
    jp = jblocks.init_mlp(jax.random.PRNGKey(1), 64, 128, act, jdt)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt) for k, v in jp.items()}
    own = blocks.init_mlp(64, 128, act, torch.Generator().manual_seed(0), "cpu", tdt)
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.named_parameters()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    x = np.random.RandomState(2).randn(2, 16, 64).astype(np.float32)
    want = np.asarray(jblocks.mlp(jnp.asarray(x, jdt), jp, act), np.float32)
    got = blocks.mlp(torch.from_numpy(x).to(tdt), tp, act)
    assert got.dtype == tdt
    err = np.abs(got.float().numpy() - want).max()
    assert err <= (1e-5 if dt == "f32" else 2e-2 * np.abs(want).max())


def _layer0(jcfg, cfg, seed):
    _, np_params = _params(jcfg, seed=seed)
    tree = lm_params_from_jax(np_params, cfg, "cpu")
    jlayer = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["decoder"]["units"][0])
    return jlayer["attn"], tree["decoder"]["units"][0][0]["attn"]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("name", ["qwen1_5_0_5b_reduced", "dense_bias_qknorm", "swa"])
def test_attention_block_matches_jax(name, backend, dt):
    jdt, tdt = DTYPES[dt]
    jcfg = (QWEN_REDUCED if name == "qwen1_5_0_5b_reduced" else FAMILIES[name]).with_(dtype=jdt)
    cfg = _port_config(jcfg, tdt)
    jp, tp = _layer0(jcfg, cfg, seed=3)
    window = cfg.window if name == "swa" else None
    x = np.random.RandomState(1).randn(2, 64, cfg.d_model).astype(np.float32)
    want = jattn.attention_block(jnp.asarray(x, jdt), jp, jcfg, window=window, backend=backend,
                                 block_kv=32)
    fa.COUNTER.reset()
    got = attention.attention_block(torch.from_numpy(x).to(tdt), tp, cfg, window=window)
    assert (fa.COUNTER.launches, fa.COUNTER.plain_calls) == (0, 1)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= (1e-5 if dt == "f32" else 2e-2 * np.abs(want).max())


def _prefill_pair(jcfg, backend, dt, seed=0):
    jdt, tdt = DTYPES[dt]
    jcfg = jcfg.with_(dtype=jdt)
    cfg = _port_config(jcfg, tdt)
    jparams, np_params = _params(jcfg, seed=seed)
    tree = lm_params_from_jax(np_params, cfg, "cpu")
    toks = _tokens(cfg)
    want = np.asarray(jlm.prefill(jparams, jnp.asarray(toks), jcfg,
                                  JaxCtx(attn_backend=backend, block_kv=32)))
    fa.COUNTER.reset()
    got = lm.prefill(tree, torch.from_numpy(toks), cfg, ParallelCtx())
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)][0] in ("attn", "swa")
                 for i in range(cfg.n_layers))
    assert (fa.COUNTER.launches, fa.COUNTER.plain_calls) == (0, n_attn)
    assert got.shape == (2, 64, cfg.vocab_size) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    return got.numpy(), want


@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_qwen_prefill_matches_jax_f32(backend):
    got, want = _prefill_pair(QWEN_REDUCED, backend, "f32")
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_qwen_prefill_matches_jax_bf16(backend):
    got, want = _prefill_pair(QWEN_REDUCED, backend, "bf16")
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_prefill_matches_jax_f32(name, backend):
    got, want = _prefill_pair(FAMILIES[name], backend, "f32", seed=1)
    assert np.abs(got - want).max() <= 1e-5


def _report():
    """Print the CPU parity margins quoted in PERF.md and ROADMAP.md (C):
    the port against either JAX route, and JAX's two routes against each
    other and against its fp32 prefill, in bf16."""
    for backend in ("interpret", "xla"):
        for dt in ("f32", "bf16"):
            got, want = _prefill_pair(QWEN_REDUCED, backend, dt)
            err, scale = np.abs(got - want).max(), np.abs(want).max()
            print(f"reduced qwen1_5_0_5b {dt}, port vs JAX {backend}: max_abs {err:.3e} = "
                  f"{err / scale:.3e} of max|logits|")
    for name, jcfg in (("reduced qwen1_5_0_5b", QWEN_REDUCED), ("dense", FAMILIES["dense"])):
        toks = jnp.asarray(_tokens(jcfg))
        jparams, _ = _params(jcfg)
        truth = np.asarray(jlm.prefill(jparams, toks, jcfg, JaxCtx(attn_backend="xla", block_kv=32)))
        j16 = jcfg.with_(dtype=jnp.bfloat16)
        p16, _ = _params(j16)
        out = {be: np.asarray(jlm.prefill(p16, toks, j16, JaxCtx(attn_backend=be, block_kv=32)))
               for be in ("interpret", "xla")}
        scale = np.abs(truth).max()
        gap = np.abs(out["interpret"] - out["xla"])
        print(f"{name} bf16, JAX interpret vs xla: max {gap.max() / scale:.3e}, mean "
              f"{gap.mean() / scale:.3e} of max|logits|; vs JAX fp32: interpret "
              f"{np.abs(out['interpret'] - truth).max() / scale:.3e}, xla "
              f"{np.abs(out['xla'] - truth).max() / scale:.3e}")


if __name__ == "__main__":  # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_qwen.py
    _report()
