"""``Model.loss_fn`` through autograd against the JAX package for the two
mixture-of-experts smoke architectures (grok-1: 4 experts, geglu; Arctic: 8
experts beside a dense residual MLP): the cross-entropy, the load-balance
and router-z aux losses summed over every block, the total, and every
gradient leaf, router and expert stacks included.  Tolerances as
``test_torch_train_loss.py``'s f32 ones (loss rtol 1e-5; each gradient
leaf within 1e-4 of its largest magnitude), through the same top-k routing
(``moe._top_k`` keeps ``jax.lax.top_k``'s order)."""

import numpy as np
import pytest

from _torch_train_parity import assert_loss_matches, reference_loss
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_loss_aux_and_every_gradient_match_jax(arch):
    got, _ = assert_loss_matches(arch, loss_rtol=1e-5, grad_rel=1e-4)
    assert any("router" in k for k in got)


def test_moe_aux_losses_enter_the_loss_with_their_weights():
    """loss = ce + load_balance_loss * lb + router_z_loss * z, as the
    reference adds them, with lb and z summed over the blocks."""
    j_cfg, _, _, loss, metrics, _ = reference_loss("grok-1-314b")
    m = j_cfg.moe
    assert metrics["lb_loss"] > 0 and metrics["z_loss"] > 0
    np.testing.assert_allclose(loss, metrics["ce"] + m.load_balance_loss * metrics["lb_loss"]
                               + m.router_z_loss * metrics["z_loss"], rtol=1e-6)
