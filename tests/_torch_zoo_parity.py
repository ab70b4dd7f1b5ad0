"""Shared by the model-zoo parity tests (``test_torch_zoo.py``,
``test_torch_moe.py``, ``test_torch_hymba.py``): one smoke architecture's
prefill and teacher-forced decode steps through the JAX package and the
port, from the reference's ``init_params`` carried across by ``interop``.

Inputs are numpy, from a seed: tokens, and the vision prefix's image embeds
or the encoder's frames where the architecture takes them.  Not a test
module (no ``test_`` prefix): the test files import it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.archs import get_config as j_get_config
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.configs.archs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.model import Model

PROMPT, STEPS, BATCH = 32, 3, 2


def as_np(x):
    return np.asarray(x).astype(np.float32)


def batch_for(cfg, seed: int, batch: int = BATCH, seq: int = PROMPT + STEPS) -> dict:
    """numpy inputs: tokens [B, seq] int32, plus image embeds / frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return out


def _prefill_decode(model, params, batch, steps, max_len, to_tokens, to_float):
    tokens = batch["tokens"]
    extra = {k: to_float(v) for k, v in batch.items() if k != "tokens"}
    logits, cache = model.prefill(params, {"tokens": to_tokens(tokens[:, :-steps]), **extra},
                                  max_len)
    out = [logits]
    for t in range(tokens.shape[1] - steps, tokens.shape[1]):
        logits, cache = model.decode_step(params, to_tokens(tokens[:, t:t + 1]), cache)
        out.append(logits)
    return out, cache


def reference_run(arch: str, dtype: str = "float32", j_impl: str = "dense", seed: int = 1):
    """-> (the reference's config, its numpy params, the batch, its logits
    per step, its final cache length)."""
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype, attn_impl=j_impl)
    j_model = JModel(j_cfg)
    j_params, _ = j_model.init_params(jax.random.PRNGKey(0))
    batch = batch_for(j_cfg, seed)
    max_len = PROMPT + STEPS + 8 + (j_cfg.num_image_tokens if j_cfg.frontend == "vision" else 0)
    want, cache = _prefill_decode(j_model, j_params, batch, STEPS, max_len, jnp.asarray,
                                  jnp.asarray)
    return j_cfg, jax.device_get(j_params), batch, [as_np(w) for w in want], int(cache.length)


def port_run(j_cfg, j_params, batch, impl: str):
    """The same through the port (``impl`` "dense" or "kernel") -> (logits
    per step, final cache length, plain-twin calls by kernel)."""
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    assert cfg == dataclasses.replace(get_config(j_cfg.name.removesuffix("-smoke"), smoke=True),
                                      dtype=j_cfg.dtype, attn_impl=impl)
    params = interop.tree_from_numpy(j_params)
    for counts in (fa_ops, da_ops, ssd_ops):
        counts.reset_counts()
    max_len = PROMPT + STEPS + 8 + (cfg.num_image_tokens if cfg.frontend == "vision" else 0)
    got, cache = _prefill_decode(Model(cfg), params, batch, STEPS, max_len,
                                 lambda t: torch.from_numpy(t).long(),
                                 lambda a: interop.to_torch(a))
    for g in got:
        assert g.shape == (BATCH, 1, cfg.vocab_size) and g.dtype == torch.float32
    plain = {**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS}
    return [g.numpy() for g in got], int(cache.length), plain


def check_prefill_decode(arch: str, impl: str, dtype: str = "float32", tol: float = 2e-5,
                         j_impl: str = "dense") -> dict:
    """Prefill of 32 tokens then 3 teacher-forced decode steps, the logits of
    every step within ``tol`` of the reference's -> the port's plain calls."""
    j_cfg, j_params, batch, want, j_len = reference_run(arch, dtype, j_impl)
    got, length, plain = port_run(j_cfg, j_params, batch, impl)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=f"{arch} step {i}")
    assert length == j_len
    return plain
