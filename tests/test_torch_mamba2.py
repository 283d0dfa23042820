"""The port's Mamba-2 forward against the JAX package's, on the CPU.

Parameters come from the JAX ``init_lm`` through ``lm_params_from_jax``;
token ids are made with numpy from a seed. The port's ``ssm_block`` and
``lm.prefill`` are held against JAX's with ``attn_backend="interpret"``
(the Pallas SSD kernel in interpret mode) and ``"xla"`` (the chunked jnp
scan): in fp32 at atol 1e-5 (the band of ``tests/test_models.py``), in
bf16 at 2e-2 of max|y| / max|logits| on the reduced ``mamba2_780m``, and
on every config with a bf16 error against JAX's fp32 logits no larger than
JAX's own bf16 error. Only reduced configs are built; the full
``mamba2_780m`` is checked field for field and counted on the meta device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.config import ParallelCtx as JaxCtx
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import ssd_scan
from repro_torch.models import lm, ssm, transformer
from repro_torch.models.config import ModelConfig, ParallelCtx

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the G = 2 "ssm" family of tests/test_models.py
JAX_SSM_G2 = JaxModelConfig(
    name="ssm", family="ssm", n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=97, pattern=(("ssm", None),), ssm_headdim=16, ssm_state=16,
    ssm_groups=2, dtype=jnp.float32,
)
JAX_CONFIGS = {
    "mamba2_780m_reduced": jax_reduce_config(jax_get_config("mamba2_780m")),
    "ssm_g2": JAX_SSM_G2,
}


def _port_config(jcfg, dtype) -> ModelConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JaxModelConfig)}
    return ModelConfig(**{**kw, "dtype": dtype})


def _params(jcfg, seed=0):
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _tokens(cfg, batch=2, seq=64, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def test_full_config_matches_jax_field_for_field():
    jcfg, cfg = jax_get_config("mamba2_780m"), get_config("mamba2_780m")
    for f in dataclasses.fields(JaxModelConfig):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if f.name == "dtype":
            assert (jnp.dtype(want).name, got) == ("bfloat16", torch.bfloat16)
        else:
            assert got == want, f.name
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]


def test_reduced_config_matches_jax():
    jcfg = jax_reduce_config(jax_get_config("mamba2_780m"))
    assert reduce_config(get_config("mamba2_780m")) == _port_config(jcfg, torch.float32)
    assert get_config("mamba2-780m") is get_config("mamba2_780m")


def test_unported_archs_and_layers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("qwen3_moe_235b_a22b")
    with pytest.raises(KeyError):
        get_config("no_such_arch")
    cfg = reduce_config(get_config("mamba2_780m"))
    for kind in (("attn", "moe"), ("rec", "mlp")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            transformer.init_layer(cfg, kind, None, "cpu")


def test_parameter_count_on_meta_matches_jax_eval_shape():
    jcfg = jax_get_config("mamba2_780m")
    shapes = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    params = lm.init_lm(get_config("mamba2_780m"), device="meta")
    got = sum(p.numel() for p in params.parameters())
    assert got == want == 780_161_280
    assert all(p.device.type == "meta" for p in params.parameters())


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_init_lm_matches_jax_shapes_dtypes_and_constants(name):
    jcfg = JAX_CONFIGS[name]
    cfg = _port_config(jcfg, torch.float32)
    _, np_params = _params(jcfg)
    converted = dict(lm_params_from_jax(np_params, cfg, "cpu").named_parameters())
    own = dict(lm.init_lm(cfg, seed=0, device="cpu").named_parameters())
    assert set(own) == set(converted)
    assert len([k for k in own if k.endswith(".ssm.w_z")]) == cfg.n_layers
    for k, v in own.items():
        assert (v.shape, v.dtype) == (converted[k].shape, converted[k].dtype), k
        if k.endswith(("d_skip", "scale", "conv_bx", "conv_bb", "conv_bc")):
            torch.testing.assert_close(v, converted[k], rtol=0, atol=0, msg=k)
        if k.endswith("a_log"):  # log(1..H): torch and XLA logs differ in the last bit
            torch.testing.assert_close(v, converted[k], rtol=2e-7, atol=0, msg=k)
        if k.endswith("dt_bias"):  # softplus(dt_bias) = dt in [1e-3, 1e-1]
            dt = torch.nn.functional.softplus(v)
            assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all()), k
    assert float(own["embed"].std()) == pytest.approx(0.02, rel=0.05)


def test_init_lm_ties_conv_wc_to_conv_wb_as_jax_does():
    """JAX draws conv_wb and conv_wc from one key, so they are equal; so are the port's."""
    jcfg = JAX_CONFIGS["mamba2_780m_reduced"]
    _, np_params = _params(jcfg)
    jblock = np_params["decoder"]["units"][0]["ssm"]  # layers stacked on axis 0
    np.testing.assert_array_equal(jblock["conv_wc"], jblock["conv_wb"])
    own = dict(lm.init_lm(_port_config(jcfg, torch.float32), seed=0,
                          device="cpu").named_parameters())
    wb = {k: v for k, v in own.items() if k.endswith(".conv_wb")}
    assert len(wb) == jcfg.n_layers
    for k, v in wb.items():
        assert torch.equal(own[k[: -len("conv_wb")] + "conv_wc"], v), k
    assert not torch.equal(*list(wb.values())[:2])  # layers still differ


def test_lm_params_from_jax_unstacks_layers_and_checks_names():
    jcfg = JAX_CONFIGS["ssm_g2"]
    cfg = _port_config(jcfg, torch.float32)
    _, np_params = _params(jcfg)
    tree = lm_params_from_jax(np_params, cfg, "cpu")
    stacked = np_params["decoder"]["units"][0]["ssm"]["w_x"]
    for u in range(cfg.n_layers):
        np.testing.assert_array_equal(tree["decoder"]["units"][0][u]["ssm"]["w_x"].numpy(),
                                      stacked[u])
    bad = {**np_params, "final_norm": {}}
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax(bad, cfg, "cpu")
    with pytest.raises(ValueError):
        lm_params_from_jax(np_params, cfg.with_(dtype=torch.bfloat16), "cpu")


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_ssm_block_matches_jax(backend, dt):
    jdt, tdt = DTYPES[dt]
    jcfg = JAX_CONFIGS["ssm_g2"].with_(dtype=jdt)
    cfg = _port_config(jcfg, tdt)
    _, np_params = _params(jcfg, seed=3)
    tree = lm_params_from_jax(np_params, cfg, "cpu")
    layer = jax.tree.map(lambda a: a[1], np_params["decoder"]["units"][0])
    x = np.random.RandomState(1).randn(2, 64, cfg.d_model).astype(np.float32)
    want = jssm.ssm_block(jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, layer["ssm"]),
                          jcfg, backend=backend, chunk=16)
    got = ssm.ssm_block(torch.from_numpy(x).to(tdt), tree["decoder"]["units"][0][1]["ssm"],
                        cfg, chunk=16)
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    if dt == "f32":
        assert err <= 1e-5
    else:
        assert err <= 2e-2 * np.abs(want).max()


def _prefill_pair(name, backend, dt):
    jdt, tdt = DTYPES[dt]
    jcfg = JAX_CONFIGS[name].with_(dtype=jdt)
    cfg = _port_config(jcfg, tdt)
    jparams, np_params = _params(jcfg)
    tree = lm_params_from_jax(np_params, cfg, "cpu")
    toks = _tokens(cfg)
    want = np.asarray(jlm.prefill(jparams, jnp.asarray(toks), jcfg,
                                  JaxCtx(attn_backend=backend, ssd_chunk=16)))
    ssd_scan.COUNTER.reset()
    got = lm.prefill(tree, torch.from_numpy(toks), cfg, ParallelCtx(ssd_chunk=16))
    assert ssd_scan.COUNTER.plain_calls == cfg.n_layers and ssd_scan.COUNTER.launches == 0
    assert got.shape == (2, 64, cfg.vocab_size) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    return got.numpy(), want


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_prefill_matches_jax_f32(name, backend):
    got, want = _prefill_pair(name, backend, "f32")
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("backend", ["interpret", "xla"])
def test_prefill_matches_jax_bf16(backend):
    """mamba2_780m reduced, bf16: within 2e-2 of max|logits| of either JAX route."""
    got, want = _prefill_pair("mamba2_780m_reduced", backend, "bf16")
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_prefill_bf16_error_is_jax_sized(name):
    """The port's bf16 error against the fp32 prefill is the JAX package's.

    Held against JAX's fp32 logits, the port's bf16 prefill must be as
    close as JAX's own bf16 prefill on either route: within 1.25x of the
    larger JAX max error and 1.1x of its mean error. On the G = 2 config,
    bf16 rounding alone moves the logits by ~5 % of max|logits| in both
    packages, and JAX's interpret and xla routes differ from each other by
    ~1.6 %, so a direct 2e-2 band between the packages would measure the
    noise of independent rounding, not the port.
    """
    j32 = JAX_CONFIGS[name]
    jparams, _ = _params(j32)
    toks = _tokens(j32)
    truth = np.asarray(jlm.prefill(jparams, jnp.asarray(toks), j32,
                                   JaxCtx(attn_backend="xla", ssd_chunk=16)))
    jax_max, jax_mean = 0.0, 0.0
    for backend in ("interpret", "xla"):
        got, want = _prefill_pair(name, backend, "bf16")
        jax_max = max(jax_max, np.abs(want - truth).max())
        jax_mean = max(jax_mean, np.abs(want - truth).mean())
    err = np.abs(got - truth)
    assert err.max() <= 1.25 * jax_max
    assert err.mean() <= 1.1 * jax_mean


@pytest.mark.parametrize("variant", ["embed_scale", "layer_norm", "codebooks", "embeddings"])
def test_forward_input_and_norm_variants_match_jax(variant):
    """The LM wrapper's other branches on the G = 2 config, fp32, xla route."""
    kw = {"embed_scale": {"embed_scale": True}, "layer_norm": {"norm_type": "layer"},
          "codebooks": {"n_codebooks": 2, "vocab_size": 32},
          "embeddings": {"input_mode": "embeddings"}}[variant]
    jcfg = JAX_SSM_G2.with_(**kw)
    cfg = _port_config(jcfg, torch.float32)
    jparams, np_params = _params(jcfg, seed=2)
    tree = lm_params_from_jax(np_params, cfg, "cpu")
    rng = np.random.RandomState(2)
    if variant == "codebooks":
        inputs = rng.randint(0, cfg.vocab_size, (2, 32, 2)).astype(np.int32)
    elif variant == "embeddings":
        inputs = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    else:
        inputs = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = jlm.forward(jparams, jnp.asarray(inputs), jcfg,
                          JaxCtx(attn_backend="xla", ssd_chunk=16))
    got, _ = lm.forward(tree, torch.from_numpy(inputs), cfg, ParallelCtx(ssd_chunk=16))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_forward_returns_zero_aux_and_init_lm_needs_a_device():
    cfg = reduce_config(get_config("mamba2_780m"))
    tree = lm.init_lm(cfg, seed=1, device="cpu")
    logits, aux = lm.forward(tree, torch.from_numpy(_tokens(cfg, 1, 32)), cfg, ParallelCtx())
    assert logits.shape == (1, 32, cfg.vocab_size)
    assert {k: float(v) for k, v in aux.items()} == {"load_balance": 0.0, "router_z": 0.0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lm.init_lm(cfg, seed=0)
