"""Hymba parity: the "hymba" mixer (attention and Mamba-2 heads in parallel
on the same normed input, mean-fused) against the JAX package on the CPU,
block by block and through prefill and decode of the smoke model, whose
cache holds both a KV stack and an SSM state per layer.

Tolerances: one block 2e-5 f32 (as the attention engines') and 4e-2 bf16
(the reference's trunk tolerance); prefill / decode logits of the two-layer
smoke model 2e-5 f32, as ``test_torch_zoo.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_parity import as_np, check_prefill_decode
from repro.configs.archs import get_config as j_get_config
from repro.models import transformer as j_tf
from repro_torch import interop
from repro_torch.configs.archs import get_config
from repro_torch.models import transformer as tf
from repro_torch.models.model import random_model
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("j_impl,impl", [("dense", "dense"), ("pallas", "kernel")])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 4e-2)])
def test_hymba_block_matches_jax(dtype, tol, j_impl, impl):
    """One hymba block over 32 tokens (2 SSD chunks of 16), no cache, causal."""
    j_cfg = dataclasses.replace(j_get_config("hymba-1.5b", smoke=True), dtype=dtype,
                                attn_impl=j_impl)
    p, _ = j_tf.block_init(jax.random.PRNGKey(5), j_cfg, "hymba")
    assert {"attn", "ssm", "mlp"} <= set(p)
    x = np.random.default_rng(6).standard_normal((2, 32, j_cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(j_cfg.activation_dtype)
    pos = jnp.broadcast_to(jnp.arange(32)[None], (2, 32))
    want, _, _, _ = j_tf.block_apply(p, j_cfg, "hymba", jx, pos)
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    got, _, _ = tf.block_apply(interop.tree_from_numpy(jax.device_get(p)), cfg, "hymba",
                               interop.to_torch(np.asarray(jx)), torch.from_numpy(np.array(pos)))
    assert got.dtype == cfg.activation_dtype
    np.testing.assert_allclose(as_np(interop.to_numpy(got)), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("j_impl,impl", [("dense", "dense"), ("dense", "kernel"),
                                         ("pallas", "kernel")])
def test_prefill_and_decode_match_jax(j_impl, impl):
    plain = check_prefill_decode("hymba-1.5b", impl, j_impl=j_impl)
    if impl == "dense":
        assert not any(plain.values()), plain
    else:  # 2 layers: flash + SSD in the prefill, fused decode + ssd_step a step
        assert plain == {"flash_attention": 2, "decode_attention_partials": 0,
                         "decode_attention_fused": 6, "ssd_intra_chunk": 2,
                         "ssd_inter_chunk": 2}, plain


def test_hymba_cache_holds_kv_and_ssm_stacks_like_the_reference():
    cfg = get_config("hymba-1.5b", smoke=True)
    cache = tf.init_model_cache(cfg, 2, 40, torch.bfloat16)
    j_cache = j_tf.init_model_cache(j_get_config("hymba-1.5b", smoke=True), 2, 40, jnp.bfloat16)
    for name in ("kv_k", "kv_v", "ssm_conv", "ssm_h"):
        got, want = getattr(cache, name), getattr(j_cache, name)
        assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want], name
        assert [str(t.dtype).removeprefix("torch.") for t in got] == [str(w.dtype) for w in want]
    assert cache.enc_out is None and int(cache.length) == 0


def test_hymba_attention_ignores_the_sliding_window_as_the_reference_does():
    """Reference caveat: a hymba layer calls its attention as "global", so
    the config's ``sliding_window`` never applies (32 tokens > window 16)."""
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True), dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (1, 32)))
    out = []
    for window in (16, None):
        model, params = random_model(dataclasses.replace(cfg, sliding_window=window), seed=0,
                                     device="cpu")
        out.append(model.prefill(params, {"tokens": tokens}, 40)[0])
    assert torch.equal(out[0], out[1])


def test_full_param_counts_match_the_reference():
    cfg = get_config("hymba-1.5b")
    assert cfg.param_counts() == j_get_config("hymba-1.5b").param_counts()
    s = cfg.ssm
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, s.state_dim, s.head_dim,
            s.num_heads(cfg.d_model)) == (25, 5, 64, 16, 64, 50)
