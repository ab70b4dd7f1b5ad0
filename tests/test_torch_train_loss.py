"""``Model.loss_fn`` through autograd against the JAX package's
``jax.value_and_grad``: the eight smoke architectures without a mixture of
experts (``test_torch_train_loss_moe.py`` has grok-1 and Arctic).

The weights are the reference's ``init_params``, carried by ``interop``;
the batch (tokens, targets, image embeds, frames) is numpy from a seed.
Two cross-entropy chunks a row, so the chunked loss and its per-chunk
remat are exercised.  Tolerances:

* f32: the loss and metrics within rtol 1e-5, every gradient leaf within
  1e-4 of that leaf's largest magnitude (matmul sums and the backward's
  reductions run in another order; the worst leaf measured ~3e-6);
* bf16 (qwen3): the loss within rtol 2e-3 and every gradient leaf within
  4e-2 of its scale — the port's distance from JAX (~0.020) is under the
  JAX bf16 run's own distance from its f32 run (~0.023): both round each
  activation to 2^-9 relative at other places.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_train_parity import assert_loss_matches, port_loss, reference_loss
from repro_torch.kernels.autograd import NoBackwardError
from test_torch_threads import one_torch_thread  # noqa: F401

DENSE_ARCHS = ["qwen3-1.7b", "gemma2-9b", "h2o-danube-1.8b", "nemotron-4-15b",
               "llava-next-mistral-7b", "seamless-m4t-large-v2", "mamba2-370m", "hymba-1.5b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    assert_loss_matches(arch, loss_rtol=1e-5, grad_rel=1e-4)


def test_bf16_loss_and_gradients_match_jax():
    assert_loss_matches("qwen3-1.7b", loss_rtol=2e-3, grad_rel=4e-2, dtype="bfloat16")


def test_remat_and_the_chunked_engine_change_no_gradient():
    """remat off, and every attention on the chunked engine (4 query rows a
    block would be the default's 256: the smoke rows are 32), give the same
    loss and gradients as the default run: remat bitwise, the chunked engine
    within f32 rounding of the dense one."""
    j_cfg, j_params, batch, _, _, _ = reference_loss("gemma2-9b")
    base = port_loss(j_cfg, j_params, batch)
    no_remat = port_loss(j_cfg, j_params, batch, remat=False)
    assert base[0] == no_remat[0]
    for a, b in zip(_leaves(base[2]), _leaves(no_remat[2])):
        np.testing.assert_array_equal(a, b)
    chunked = port_loss(j_cfg, j_params, batch, attn_impl="chunked")
    np.testing.assert_allclose(chunked[0], base[0], rtol=1e-6)
    for a, b in zip(_leaves(chunked[2]), _leaves(base[2])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * float(np.abs(b).max()))


def test_loss_through_the_kernel_route_refuses_grad():
    """A config on the kernel route cannot train: its attention wrapper
    refuses a query that requires grad instead of returning a loss whose
    projections get no gradient; without grad the same loss evaluates."""
    j_cfg, j_params, batch, want, _, _ = reference_loss("qwen3-1.7b")
    with pytest.raises(NoBackwardError, match="no backward pass"):
        port_loss(j_cfg, j_params, batch, attn_impl="kernel")
    from repro_torch import interop
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl="kernel")
    with torch.no_grad():
        loss, _ = Model(cfg).loss_fn(interop.tree_from_numpy(j_params),
                                     {k: interop.to_torch(v) for k, v in batch.items()},
                                     loss_chunk=16)
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)


def _leaves(tree):
    from _torch_train_parity import keyed

    return list(keyed(tree).values())
