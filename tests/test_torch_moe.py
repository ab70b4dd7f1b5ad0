"""Mixture-of-experts parity: ``models/moe.py`` and the two MoE
architectures (grok-1: 8 experts top-2, geglu; Arctic: 128 top-2, swiglu,
with a dense residual MLP) against the JAX package on the CPU.

Tolerances: ``moe_apply``'s output 2e-5 f32 (matmul sums in another order)
and its aux losses rtol 1e-6 (f32 means of softmax probabilities); the
selections (``_top_k``) exactly; prefill / decode logits of the two-layer
smoke models 2e-5 f32, as ``test_torch_zoo.py``; bf16 ``moe_apply`` 4e-2
(the reference's trunk tolerance) on a router scaled so that no token's
second choice sits within bf16 rounding of its third: bf16 matmuls in the
two frameworks round the router logits differently, and a near tie can
route a token to another expert (a different result, not a rounding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_parity import as_np, check_prefill_decode
from repro.configs.archs import get_config as j_get_config
from repro.models import moe as j_moe
from repro_torch import interop
from repro_torch.configs.archs import get_config
from repro_torch.models import moe
from test_torch_threads import one_torch_thread  # noqa: F401

MOE_ARCHS = ["grok-1-314b", "arctic-480b"]


def _moe_case(arch, seed, tokens, dtype="float32", router_scale=1.0, bias_expert=None):
    """The reference's smoke MoE params and numpy inputs [2, tokens, d]."""
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    p, _ = j_moe.moe_init(jax.random.PRNGKey(seed), j_cfg)
    p = jax.device_get(p)
    router = np.asarray(p["router"]) * router_scale
    x = np.random.default_rng(seed).standard_normal((2, tokens, j_cfg.d_model)).astype(np.float32)
    if bias_expert is not None:  # a popular expert: its capacity truncates
        x = x + 0.5 * router[:, bias_expert] / np.linalg.norm(router[:, bias_expert])
        router = router.copy()
        router[:, bias_expert] *= 3.0
    p = dict(p, router=router.astype(np.float32))
    return j_cfg, p, x


def _both(j_cfg, p, x):
    jx = jnp.asarray(x).astype(j_cfg.activation_dtype)
    want, want_aux = j_moe.moe_apply(p, j_cfg, jx)
    cfg = interop.model_config_from(j_cfg)
    got, aux = moe.moe_apply(interop.tree_from_numpy(p), cfg, interop.to_torch(np.asarray(jx)))
    assert got.dtype == cfg.activation_dtype and got.shape == x.shape
    return (as_np(interop.to_numpy(got)), aux), (as_np(want), want_aux)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch):
    """64 tokens a group: one expert is popular enough that its capacity
    (``expert_capacity``: 40 of 64 for grok's 4-expert smoke, 16 for
    Arctic's 8) drops tokens, so the truncation is part of the comparison."""
    j_cfg, p, x = _moe_case(arch, seed=1, tokens=64, bias_expert=0)
    (got, aux), (want, want_aux) = _both(j_cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux.load_balance_loss), float(want_aux.load_balance_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(float(aux.router_z_loss), float(want_aux.router_z_loss),
                               rtol=1e-6)
    # the case truncates: the popular expert is the first choice of more
    # tokens than its capacity in some group
    m = j_cfg.moe
    probs = torch.softmax(torch.from_numpy(x @ p["router"]), -1)
    first = probs.argmax(-1)
    cap = min(moe.expert_capacity(64, m.num_experts, m.top_k, m.capacity_factor), 64)
    assert int((first == 0).sum(-1).max()) > cap


def test_moe_router_tie_picks_the_lower_expert():
    """Experts 1 and 2 get identical router columns, so every token's
    probabilities tie between them; ``jax.lax.top_k`` keeps the lower index
    and so must the port (the experts' weights differ, so a flip would show
    in the output and in the load-balance aux)."""
    j_cfg, p, x = _moe_case("grok-1-314b", seed=2, tokens=16)
    router = p["router"].copy()
    router[:, 2] = router[:, 1]
    router[:, 0] -= 10.0 * np.sign(x.reshape(-1, x.shape[-1]).mean(0))  # 0 rarely wins
    p = dict(p, router=router)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    assert bool(jnp.all(probs[..., 1] == probs[..., 2]))
    _, top_idx = jax.lax.top_k(probs, 2)
    assert bool(jnp.any(jnp.all(top_idx == jnp.array([1, 2]), axis=-1)))  # the tie decides
    (got, aux), (want, want_aux) = _both(j_cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux.load_balance_loss), float(want_aux.load_balance_loss),
                               rtol=1e-6)


def test_top_k_order_matches_jax_on_ties():
    """Values descending, equal values in index order, as ``jax.lax.top_k``:
    a gate-like matrix (mostly exact zeros, a few repeated weights)."""
    rng = np.random.default_rng(3)
    x = rng.choice(np.array([0.0, 0.0, 0.0, 0.25, 0.5, 0.5, 1.0], np.float32), size=(3, 5, 40))
    for k in (1, 2, 8, 40):
        vals, idx = moe._top_k(torch.from_numpy(x), k)
        j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_recording_routes_holds_each_router_choice():
    """``recording_routes`` (how the card is held to the CPU's routing)
    records one [groups, tokens, top_k] choice a call, the reference's
    top-k experts sorted, and nothing outside its block."""
    j_cfg, p, x = _moe_case("grok-1-314b", seed=2, tokens=16)
    cfg = interop.model_config_from(j_cfg)
    params = interop.tree_from_numpy(p)
    with moe.recording_routes() as seen:
        moe.moe_apply(params, cfg, torch.from_numpy(x))
    moe.moe_apply(params, cfg, torch.from_numpy(x))
    assert len(seen) == 1 and moe._ROUTE_LOG is None
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), axis=-1)
    _, j_idx = jax.lax.top_k(probs, cfg.moe.top_k)
    np.testing.assert_array_equal(seen[0].numpy(), np.sort(np.asarray(j_idx), axis=-1))


def test_capacity_and_group_length_match_the_reference():
    for tokens, experts, k, factor in [(16, 4, 2, 1.25), (64, 4, 2, 1.25), (512, 128, 2, 1.25),
                                       (1, 8, 2, 1.25), (4096, 8, 2, 1.0), (333, 16, 1, 2.0)]:
        assert moe.expert_capacity(tokens, experts, k, factor) == j_moe.expert_capacity(
            tokens, experts, k, factor)
    for s in (1, 7, 512, 4096, 4608, 8192, 12288, 5000):
        assert moe._group_len(s) == j_moe._group_len(s), s


def test_moe_apply_matches_jax_in_bf16():
    j_cfg, p, x = _moe_case("arctic-480b", seed=4, tokens=32, dtype="bfloat16",
                            router_scale=8.0)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), axis=-1))
    top3 = -np.sort(-probs, axis=-1)[..., :3]
    assert (top3[..., 1] - top3[..., 2] > 2e-2 * top3[..., 1]).all()  # no near tie at the cut
    (got, _), (want, _) = _both(j_cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch, impl):
    plain = check_prefill_decode(arch, impl)
    if impl == "dense":
        assert not any(plain.values()), plain
    else:
        assert plain == {"flash_attention": 2, "decode_attention_partials": 0,
                         "decode_attention_fused": 6, "ssd_intra_chunk": 0,
                         "ssd_inter_chunk": 0}, plain


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_param_counts_match_the_reference(arch):
    """Total and ACTIVE counts: the cascade's backbone cost is 2 x active
    parameters a token."""
    cfg = get_config(arch)
    assert cfg.param_counts() == j_get_config(arch).param_counts()
    m = cfg.moe
    assert (m.num_experts, m.top_k, m.d_ff_expert, m.dense_residual) == (
        (8, 2, 32768, False) if arch == "grok-1-314b" else (128, 2, 4864, True))
