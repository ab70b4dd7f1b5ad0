"""Model-zoo parity, dense variants: untied embeddings (nemotron, danube,
llava), sliding windows (danube; gemma2's local / global alternation),
logit softcaps and head_dim 256 (gemma2), the vision prefix (llava) and the
encoder-decoder (seamless: the encoder, cross-attention) — the port against
the JAX package on the CPU, from the reference's ``init_params`` carried
across by ``interop``.

Tolerances: prefill / decode logits of the two-layer smoke models 2e-5 f32
(matmul sums in another order, 2 layers deep, over logits of magnitude ~1;
as ``test_torch_models.py``), 4e-2 bf16 (the reference's trunk tolerance:
bf16 rounds at other places in the two frameworks); cross-attention and
the encoder 2e-5 f32 / 2e-2 bf16 (the reference kernel tests' attention
tolerances).
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_parity import as_np, check_prefill_decode
from repro.configs.archs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs.archs import ARCHS, SMOKES, get_config
from repro_torch.models import attention
from repro_torch.models.model import Model, random_model, serving_params
from test_torch_threads import one_torch_thread  # noqa: F401

DENSE_ZOO = ["gemma2-9b", "nemotron-4-15b", "h2o-danube-1.8b", "llava-next-mistral-7b",
             "seamless-m4t-large-v2"]


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", DENSE_ZOO)
def test_prefill_and_decode_match_jax(arch, impl):
    """Prefill of 32 tokens (after llava's 8 image embeds; over seamless's 32
    encoded frames) then 3 decode steps: every step's logits and the cache
    length; the kernel route runs every attention through a kernel's twin."""
    plain = check_prefill_decode(arch, impl)
    n = 2 if arch != "gemma2-9b" else 4  # gemma2's smoke has 4 layers
    if impl == "dense":
        assert not any(plain.values()), plain
    elif arch == "seamless-m4t-large-v2":
        # the prefill: 2 encoder layers, then self- and cross-attention in each
        # of the n decoder layers; a step: n cross-attentions (flash, Sq 1) and
        # n self-attentions over the cache (fused decode)
        enc, steps = 2, 3
        assert plain == {"flash_attention": enc + 2 * n + steps * n,
                         "decode_attention_partials": 0,
                         "decode_attention_fused": steps * n, "ssd_intra_chunk": 0,
                         "ssd_inter_chunk": 0}, plain
    else:
        assert plain == {"flash_attention": n, "decode_attention_partials": 0,
                         "decode_attention_fused": 3 * n, "ssd_intra_chunk": 0,
                         "ssd_inter_chunk": 0}, plain


def test_gemma2_prefill_and_decode_match_jax_in_bf16():
    """The bf16 route: local windows, both softcaps, head_dim 16 here."""
    check_prefill_decode("gemma2-9b", "kernel", dtype="bfloat16", tol=4e-2)


@pytest.mark.parametrize("j_impl,impl", [("dense", "dense"), ("pallas", "kernel")])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_cross_attention_matches_jax(dtype, tol, j_impl, impl):
    """``attn_apply(..., xk=enc_out)``: K / V from the encoder output, no
    RoPE, no mask, no cache; 5 decoder queries (and 1, the decode shape)
    over 12 frames."""
    j_cfg = dataclasses.replace(j_get_config("seamless-m4t-large-v2", smoke=True), dtype=dtype,
                                attn_impl=j_impl)
    p, _ = j_attn.attn_init(jax.random.PRNGKey(3), j_cfg, cross=True)
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    rng = np.random.default_rng(4)
    for sq in (5, 1):
        x = rng.standard_normal((2, sq, j_cfg.d_model)).astype(np.float32)
        enc = rng.standard_normal((2, 12, j_cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(7, 7 + sq)[None], (2, sq)).astype(np.int32)
        jx, jenc = (jnp.asarray(a).astype(j_cfg.activation_dtype) for a in (x, enc))
        want, _ = j_attn.attn_apply(p, j_cfg, jx, jnp.asarray(pos), "global", xk=jenc,
                                    causal=False)
        got, cache = attention.attn_apply(
            interop.tree_from_numpy(jax.device_get(p)), cfg, interop.to_torch(np.asarray(jx)),
            torch.from_numpy(pos), "global", xk=interop.to_torch(np.asarray(jenc)))
        assert cache is None and got.dtype == cfg.activation_dtype
        np.testing.assert_allclose(as_np(interop.to_numpy(got)), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_encode_matches_jax(impl):
    """``Model._encode``: the encoder stack over 32 frames, non-causal, no
    cache, then ``enc_ln``."""
    j_cfg = dataclasses.replace(j_get_config("seamless-m4t-large-v2", smoke=True),
                                dtype="float32")
    j_model = JModel(j_cfg)
    j_params, _ = j_model.init_params(jax.random.PRNGKey(0))
    frames = np.random.default_rng(5).standard_normal((2, 32, j_cfg.d_model)).astype(np.float32)
    want = j_model._encode(j_params, jnp.asarray(frames))
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    got = Model(cfg)._encode(interop.tree_from_numpy(jax.device_get(j_params)),
                             torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), as_np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_layout_matches_the_reference(arch):
    """Every leaf path and shape of ``init_params`` equals the reference's
    (untied ``unembed``, ``enc_layers`` / ``enc_ln``, ``img_proj``, the
    decoder's ``cross`` / ``ln_cross``, ``moe``, hymba's ``attn`` + ``ssm``)."""
    params = Model(get_config(arch, smoke=True)).init_params(torch.Generator().manual_seed(0))
    j_params, _ = JModel(j_get_config(arch, smoke=True)).init_params(jax.random.PRNGKey(0))
    flat_t = jax.tree_util.tree_leaves_with_path(
        interop.tree_to_numpy(params), is_leaf=lambda x: isinstance(x, np.ndarray))
    flat_j = jax.tree_util.tree_leaves_with_path(j_params)
    assert [(jax.tree_util.keystr(p), x.shape) for p, x in flat_t] == [
        (jax.tree_util.keystr(p), x.shape) for p, x in flat_j]


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_serving_build_is_the_cast_of_init_bitwise(arch):
    """``random_model`` builds the serving tree from the draws directly (one
    f32 matrix alive at a time): bitwise ``serving_params(init_params(gen))``
    from the same seed, leaf for leaf, dtype for dtype."""
    cfg = get_config(arch, smoke=True)
    want = serving_params(Model(cfg).init_params(torch.Generator().manual_seed(7)), cfg)
    _, got = random_model(cfg, seed=7, device="cpu")
    flat_w = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, torch.Tensor))
    flat_g = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == [
        jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and torch.equal(g, w), jax.tree_util.keystr(path)
    assert got["embed"].dtype == torch.bfloat16 and got["final_ln"].dtype == torch.float32


def test_serving_build_frees_its_stacks_without_the_cycle_collector():
    """A served model's memory goes when its tree does: nothing of the build
    holds the stacks in a reference cycle (on the card, a cycle kept a freed
    model's 41 GB alive into the next model's build)."""
    gc.disable()
    try:
        _, params = random_model(get_config("grok-1-314b", smoke=True), seed=0, device="cpu")
        refs = [weakref.ref(params["layers"][0]["moe"]["wu"]),
                weakref.ref(params["layers"][0]["ln1"]), weakref.ref(params["embed"])]
        del params
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


@pytest.mark.parametrize("arch", DENSE_ZOO)
def test_full_param_counts_match_the_reference(arch):
    assert get_config(arch).param_counts() == j_get_config(arch).param_counts()
