"""Model parity: the port's layers, attention engines and trunk vs the JAX package.

Weights and inputs are drawn by the reference (or by numpy) and carried into
the port with ``repro_torch.interop``; both run on the CPU.  Tolerances:
elementwise layers 1e-6 (f32 transcendental rounding differs by an ulp
between XLA and PyTorch); attention 2e-5 f32 / 2e-2 bf16 (the reference
kernel tests' own); the two-layer trunk 2e-4 f32 / 4e-2 bf16 (the
reference's trunk test, ``tests/test_kernels.py``: matmul sums run in
another order and bf16 rounds at other places in the two frameworks);
prefill / decode logits of the two-layer smoke models 2e-5 f32 (the same
sums, 2 layers deep, over logits of magnitude ~1); the port's teacher-forced
decode against its own prefill 2e-5 f32 (the reference test's 2e-2 covers
bf16; here both sides run the same f32 code, only the cache path differs).
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
from repro_torch.configs.archs import ARCHS, get_config, mamba2_370m, qwen3_1_7b
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.model import Model, random_model, serving_params
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
    got, _, _ = tf.stack_apply(layers_t, cfg, xt, torch.from_numpy(np.array(pos)),
                               cfg.num_layers, causal=False)
    assert got.dtype == cfg.activation_dtype
    np.testing.assert_allclose(_np(interop.to_numpy(got)), _np(want), rtol=tol, atol=tol)
    # one stored copy of the matrices in the activation dtype gives the same bits
    cast = tf.cast_matrices(layers_t, cfg.activation_dtype)
    again, _, _ = tf.stack_apply(cast, cfg, xt, torch.from_numpy(np.array(pos)),
                                 cfg.num_layers, causal=False)
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
    """Only an engine the port does not have is refused; the chunked engine
    (since the training slice) and the mixers, MoE and encoder that were
    refused before the model zoo now build."""
    with pytest.raises(NotImplementedError, match="'flash'"):
        dataclasses.replace(qwen3_1_7b(), attn_impl="flash").check_supported()
    dataclasses.replace(qwen3_1_7b(), attn_impl="chunked").check_supported()
    with pytest.raises(ValueError, match="ssm=SSMConfig"):
        dataclasses.replace(qwen3_1_7b(), layer_pattern=("hymba",)).check_supported()
    hymba = dataclasses.replace(get_config("qwen3-1.7b", smoke=True), layer_pattern=("hymba",),
                                ssm=get_config("hymba-1.5b", smoke=True).ssm)
    moe = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              moe=MoEConfig(num_experts=4, d_ff_expert=32))
    gen = torch.Generator().manual_seed(0)
    for cfg in (hymba, moe, get_config("seamless-m4t-large-v2", smoke=True)):
        cfg.check_supported()
        params = Model(cfg).init_params(gen)
        assert ("moe" in params["layers"][0]) == (cfg.moe is not None)
        assert ("ssm" in params["layers"][0]) == (cfg.ssm is not None)
        assert ("enc_layers" in params) == (cfg.encoder is not None)
    assert isinstance(moe, ModelConfig) and moe.param_counts()["total"] > 0


def test_model_config_from_holds_no_reference_objects():
    for arch in sorted(ARCHS):
        for smoke in (False, True):
            j_cfg = j_get_config(arch, smoke=smoke)
            cfg = interop.model_config_from(j_cfg)
            assert cfg == get_config(arch, smoke=smoke)
            for f in dataclasses.fields(cfg):
                value = getattr(cfg, f.name)
                assert not type(value).__module__.startswith("repro."), (f.name, type(value))
            for nested in (cfg.ssm, cfg.moe, cfg.encoder):
                if nested is not None:
                    assert type(nested).__module__ == "repro_torch.models.config"
    moe = interop.model_config_from(dataclasses.replace(
        j_get_config("qwen3-1.7b", smoke=True), moe=j_get_config("grok-1-314b", smoke=True).moe))
    assert type(moe.moe) is MoEConfig


def test_full_mamba2_param_counts_match_the_reference():
    cfg = mamba2_370m()
    assert cfg.param_counts() == j_get_config("mamba2-370m").param_counts()
    assert (cfg.num_layers, cfg.d_model, cfg.ssm.state_dim, cfg.ssm.head_dim,
            cfg.ssm.num_heads(cfg.d_model)) == (48, 1024, 128, 64, 32)
    cfg.check_supported()


def test_mamba2_init_layout_and_serving_copy():
    cfg = get_config("mamba2-370m", smoke=True)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0))
    j_params, _ = JModel(j_get_config("mamba2-370m", smoke=True)).init_params(
        jax.random.PRNGKey(0))
    flat_t = jax.tree_util.tree_leaves_with_path(
        interop.tree_to_numpy(params), is_leaf=lambda x: isinstance(x, np.ndarray))
    flat_j = jax.tree_util.tree_leaves_with_path(j_params)
    assert [(jax.tree_util.keystr(p), x.shape) for p, x in flat_t] == [
        (jax.tree_util.keystr(p), x.shape) for p, x in flat_j]
    ssm_p = params["layers"][0]["ssm"]
    np.testing.assert_allclose(ssm_p["A_log"].numpy(),  # log(1..H): an ulp apart
                               np.asarray(j_params["layers"][0]["ssm"]["A_log"]), rtol=1e-6)
    dt = torch.nn.functional.softplus(ssm_p["dt_bias"])  # inverse softplus of dt in [1e-3, 0.1]
    assert ((dt > 0.0009) & (dt < 0.1001)).all()
    serve = serving_params(params, dataclasses.replace(cfg, dtype="bfloat16"))
    s_ssm = serve["layers"][0]["ssm"]
    for k in ("A_log", "D", "dt_bias", "norm_w", "conv_b"):
        assert s_ssm[k].dtype == torch.float32 and s_ssm[k] is ssm_p[k], k
    for k in ("in_proj", "conv_w", "out_proj"):
        assert s_ssm[k].dtype == torch.bfloat16, k
    assert serve["embed"].dtype == torch.bfloat16 and serve["final_ln"].dtype == torch.float32


def _prefill_decode(model, params, tokens, steps, max_len, to_tensor):
    logits, cache = model.prefill(params, {"tokens": to_tensor(tokens[:, :-steps])}, max_len)
    out = [logits]
    for t in range(tokens.shape[1] - steps, tokens.shape[1]):
        logits, cache = model.decode_step(params, to_tensor(tokens[:, t:t + 1]), cache)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_prefill_and_decode_match_jax(arch, impl):
    """Prefill of 32 tokens then 3 decode steps, on the reference's smoke
    params carried across: the logits of every step and the cache length."""
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="float32")
    j_model = JModel(j_cfg)
    j_params, _ = j_model.init_params(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, j_cfg.vocab_size, (2, 35)).astype(np.int32)
    want, j_cache = _prefill_decode(j_model, j_params, tokens, 3, 40, jnp.asarray)
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    params = interop.tree_from_numpy(jax.device_get(j_params))
    for counts in (fa_ops, da_ops, ssd_ops):
        counts.reset_counts()
    got, cache = _prefill_decode(Model(cfg), params, tokens, 3, 40,
                                 lambda t: torch.from_numpy(t).long())
    for g, w in zip(got, want):
        assert g.shape == (2, 1, cfg.vocab_size) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=2e-5, atol=2e-5)
    assert int(cache.length) == int(j_cache.length) == 35
    plain = {**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS}
    if impl == "dense":
        assert not any(plain.values()), plain
    elif arch == "mamba2-370m":  # 2 layers: the SSD route in prefill, ssd_step in decode
        assert plain == {"flash_attention": 0, "decode_attention_partials": 0,
                         "decode_attention_fused": 0, "ssd_intra_chunk": 2,
                         "ssd_inter_chunk": 2}, plain
    else:  # the flash route in prefill, the fused decode route per step
        assert plain == {"flash_attention": 2, "decode_attention_partials": 0,
                         "decode_attention_fused": 6, "ssd_intra_chunk": 0,
                         "ssd_inter_chunk": 0}, plain


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_teacher_forced_decode_matches_prefill_of_longer_prefixes(arch):
    """``test_arch_smoke.py::test_decode_matches_prefill_incremental`` on the
    port, through the kernel route (plain twins here)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model, params = random_model(cfg, seed=0, device="cpu")
    seq, cut = 16, 8
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (1, seq)).astype(np.int64))
    logits, cache = model.prefill(params, {"tokens": tokens[:, :cut]}, max_len=seq + 4)
    steps = [logits[:, -1]]
    for t in range(cut, seq):
        lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        steps.append(lg[:, -1])
    for i, t in enumerate(range(cut, seq + 1)):
        want, _ = model.prefill(params, {"tokens": tokens[:, :t]}, max_len=seq + 4)
        np.testing.assert_allclose(steps[i].numpy(), want[:, -1].numpy(), rtol=2e-5, atol=2e-5)


def test_random_model_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only machine's refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_model(get_config("mamba2-370m", smoke=True))
    # a text model takes a vision batch as the reference does: it reads the tokens only
    model, params = random_model(get_config("qwen3-1.7b", smoke=True), device="cpu")
    _, cache = model.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                                      "image_embeds": torch.zeros((1, 2, 64))}, 8)
    assert int(cache.length) == 4
