"""Shared by the training parity tests (``test_torch_train_*.py``): one
smoke architecture's ``Model.loss_fn`` and its gradients through the JAX
package (``jax.value_and_grad``) and the port (autograd), from the
reference's ``init_params`` carried across by ``interop``.

Inputs are numpy, from a seed: tokens and targets, and the vision prefix's
image embeds or the encoder's frames where the architecture takes them.
Not a test module (no ``test_`` prefix): the test files import it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.archs import get_config as j_get_config
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.models.model import Model
from repro_torch.optim.tree import leaves, tree_map, unflatten

BATCH, SEQ, LOSS_CHUNK = 2, 32, 16  # two cross-entropy chunks a row


def batch_for(cfg, seed: int, batch: int = BATCH, seq: int = SEQ) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    return out


def reference_loss(arch: str, dtype: str = "float32", seed: int = 1):
    """-> (the reference's config, numpy params, the batch, loss, metrics,
    numpy gradients: the reference's trees)."""
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    j_model = JModel(j_cfg)
    j_params, _ = j_model.init_params(jax.random.PRNGKey(0))
    batch = batch_for(j_cfg, seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: j_model.loss_fn(p, jb, loss_chunk=LOSS_CHUNK), has_aux=True))(j_params)
    return (j_cfg, jax.device_get(j_params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, jax.device_get(grads))


def port_loss(j_cfg, j_params, batch, **cfg_changes):
    """The same through the port -> (loss, metrics as floats, gradients as a
    tree of numpy arrays of the params' structure)."""
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), **cfg_changes)
    params = tree_map(lambda t: t.requires_grad_(True), interop.tree_from_numpy(j_params))
    tb = {k: interop.to_torch(v) for k, v in batch.items()}
    loss, metrics = Model(cfg).loss_fn(params, tb, loss_chunk=LOSS_CHUNK)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True, materialize_grads=True)
    return (loss.item(), {k: v.item() for k, v in metrics.items()},
            interop.tree_to_numpy(unflatten(params, list(grads))))


def keyed(tree) -> dict:
    """{jax key path: float32 array} over a numpy tree."""
    flat = jax.tree_util.tree_leaves_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32) for p, x in flat}


def assert_loss_matches(arch, loss_rtol, grad_rel, dtype="float32", **cfg_changes):
    """Loss and every metric within ``loss_rtol`` (relative), and every
    gradient leaf within ``grad_rel`` of that leaf's largest magnitude."""
    j_cfg, j_params, batch, want_loss, want_m, want_g = reference_loss(arch, dtype)
    loss, metrics, grads = port_loss(j_cfg, j_params, batch, **cfg_changes)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=loss_rtol, err_msg=arch)
    assert set(metrics) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(metrics[k], want_m[k], rtol=loss_rtol, err_msg=f"{arch} {k}")
    got, want = keyed(grads), keyed(want_g)
    assert list(got) == list(want), arch
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= grad_rel * scale, f"{arch} {k}: max abs diff {err} of scale {scale}"
    return got, want
