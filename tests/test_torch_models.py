"""Model parity: the port's layers, attention engines and trunk vs the JAX package.

Weights and inputs are drawn by the reference (or by numpy) and carried into
the port with ``repro_torch.interop``; both run on the CPU.  Tolerances:
elementwise layers 1e-6 (f32 transcendental rounding differs by an ulp
between XLA and PyTorch); attention 2e-5 f32 / 2e-2 bf16 (the reference
kernel tests' own); the two-layer trunk 2e-4 f32 / 4e-2 bf16 (the
reference's trunk test, ``tests/test_kernels.py``: matmul sums run in
another order and bf16 rounds at other places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.archs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs.archs import get_config, qwen3_1_7b
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.model import Model
from test_torch_threads import one_torch_thread  # noqa: F401


def _np(x):
    return np.asarray(x).astype(np.float32)


def _rand(seed, shape, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def test_rmsnorm_and_rope_match_jax():
    x = _rand(0, (3, 8, 4, 16))
    w = _rand(1, (16,))
    pos = np.broadcast_to(np.arange(8)[None], (3, 8)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
        _np(j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)), rtol=1e-6, atol=1e-6)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
            _np(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
            rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp_apply_matches_jax(mlp_type):
    params, _ = j_layers.mlp_init(jax.random.PRNGKey(0), 32, 64, mlp_type)
    x = _rand(2, (5, 32))
    got = layers.mlp_apply(interop.tree_from_numpy(params), torch.from_numpy(x), mlp_type)
    want = j_layers.mlp_apply(params, jnp.asarray(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal,window,cap", [(False, None, None), (True, None, 30.0),
                                               (True, 5, None)])
def test_attention_engines_match_jax(dtype, tol, causal, window, cap):
    b, s, h, kv, d = 16, 8, 4, 2, 16  # 16 lanes x 8 tokens, the backbone's shape
    q, k, v = _rand(3, (b, s, h, d), dtype), _rand(4, (b, s, kv, d), dtype), _rand(5, (b, s, kv, d), dtype)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    kw = dict(causal=causal, window=window, kv_len=None, cap=cap)
    tq, tk, tv = (interop.to_torch(x) for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    for port_impl, j_impl in (("dense", "dense"), ("kernel", "pallas")):
        got = attention.attention_engine(tq, tk, tv, tpos, tpos, impl=port_impl, **kw)
        want = j_attn.attention_engine(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), jnp.asarray(pos), impl=j_impl, **kw)
        np.testing.assert_allclose(_np(interop.to_numpy(got)), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 4e-2)])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_reduced_qwen3_trunk_matches_jax(dtype, tol, impl):
    j_cfg = dataclasses.replace(j_get_config("qwen3-1.7b", smoke=True), dtype=dtype)
    params, _ = JModel(j_cfg).init_params(jax.random.PRNGKey(0))
    b, s = 16, 8
    x = jax.random.normal(jax.random.PRNGKey(1), (b, s, j_cfg.d_model), j_cfg.activation_dtype)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want, _, _ = j_tf.stack_apply(params["layers"], dataclasses.replace(j_cfg, attn_impl="auto"),
                                  x, pos, j_cfg.num_layers, causal=False)
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    assert cfg == dataclasses.replace(get_config("qwen3-1.7b", smoke=True), dtype=dtype,
                                      attn_impl=impl)
    layers_t = interop.tree_from_numpy(params["layers"])
    xt = interop.to_torch(np.asarray(x))
    got = tf.stack_apply(layers_t, cfg, xt, torch.from_numpy(np.array(pos)), cfg.num_layers,
                         causal=False)
    assert got.dtype == cfg.activation_dtype
    np.testing.assert_allclose(_np(interop.to_numpy(got)), _np(want), rtol=tol, atol=tol)
    # one stored copy of the matrices in the activation dtype gives the same bits
    cast = tf.cast_matrices(layers_t, cfg.activation_dtype)
    again = tf.stack_apply(cast, cfg, xt, torch.from_numpy(np.array(pos)), cfg.num_layers,
                           causal=False)
    assert torch.equal(again, got)


def test_full_qwen3_param_counts_are_exact():
    cfg = qwen3_1_7b()
    per_layer = 2048 * 128 * (16 + 2 * 8) + 16 * 128 * 2048 + 3 * 2048 * 6144
    assert per_layer == 50_331_648
    embed = 151_936 * 2048
    assert cfg.param_counts() == dict(total=embed + 28 * per_layer, active=1_720_451_072)
    assert cfg.param_counts() == j_get_config("qwen3-1.7b").param_counts()
    assert cfg.activation_dtype == torch.bfloat16


def test_port_init_matches_the_reference_layout_and_scale():
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0))
    j_params, _ = JModel(j_get_config("qwen3-1.7b", smoke=True)).init_params(jax.random.PRNGKey(0))
    flat_t = jax.tree_util.tree_leaves_with_path(
        interop.tree_to_numpy(params), is_leaf=lambda x: isinstance(x, np.ndarray))
    flat_j = jax.tree_util.tree_leaves_with_path(j_params)
    assert [(jax.tree_util.keystr(p), x.shape) for p, x in flat_t] == [
        (jax.tree_util.keystr(p), x.shape) for p, x in flat_j]
    wq = params["layers"][0]["attn"]["wq"]
    assert abs(wq.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.1  # 1/sqrt(fan_in) scale


def test_unsupported_pieces_raise():
    with pytest.raises(NotImplementedError, match="chunked"):
        dataclasses.replace(qwen3_1_7b(), attn_impl="chunked").check_supported()
    with pytest.raises(NotImplementedError, match="mamba"):
        dataclasses.replace(qwen3_1_7b(), layer_pattern=("mamba",)).check_supported()
    moe = dataclasses.replace(qwen3_1_7b(), moe=MoEConfig(num_experts=4))
    with pytest.raises(NotImplementedError, match="moe"):
        Model(moe)
    assert isinstance(moe, ModelConfig) and moe.param_counts()["total"] > 0
