"""The port's optimisers and gradient compression against the JAX package,
leaf by leaf on identical inputs (numpy from a seed).

Each optimiser is held alone, tightly: one update's parameters and state
within rtol 1e-6 / atol 1e-7 in f32 (the same f32 ops; ``pow`` / ``rsqrt``
may round one ulp apart between XLA and PyTorch), bf16 parameters within
one bf16 ulp.  Clipping and the schedule within 1e-6.  ``topk_compress``
exactly (ties in index order, as ``jax.lax.top_k``), ``int8_compress``
exactly on the reference's own noise.  Also the two quadratic-convergence
checks of ``tests/test_substrate.py``, on the port.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch import interop
from repro_torch.optim import adafactor, adamw, compress
from repro_torch.optim.tree import leaves
from test_torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-7


def _tree(seed, shapes: dict, dtype=np.float32, scale=1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32).astype(dtype)
            for k, s in shapes.items()}


SHAPES = {"w": (8, 12), "stack": (3, 8, 6), "b": (12,), "s": (1,)}


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = interop.to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_adamw_updates_match_jax_leaf_by_leaf(state_dtype):
    """Three updates of f32 and bf16 leaves (bf16 leaves keep f32 moments
    unless ``state_dtype`` says otherwise), with weight decay and a
    learning-rate scale."""
    params = {**_tree(0, SHAPES), "h": _tree(1, {"h": (6, 5)}, ml_dtypes.bfloat16)["h"]}
    j_opt = j_adamw.AdamW(lr=1e-2, state_dtype=state_dtype)
    opt = adamw.AdamW(lr=1e-2, state_dtype=state_dtype)
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    tp = interop.tree_from_numpy(params)
    js, ts = j_opt.init(jp), opt.init(tp)
    for step in range(3):
        grads = _tree(10 + step, {k: v.shape for k, v in params.items()})
        grads["h"] = grads["h"].astype(ml_dtypes.bfloat16)
        jp, js = j_opt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp,
                              lr_scale=0.5)
        tp, ts = opt.update(interop.tree_from_numpy(grads), ts, tp, lr_scale=0.5)
    assert int(ts.step) == int(js.step) == 3
    for k in params:
        assert interop.to_numpy(tp[k]).dtype == np.asarray(jp[k]).dtype
        assert interop.to_numpy(ts.mu[k]).dtype == np.asarray(js.mu[k]).dtype
        bf16 = np.asarray(jp[k]).dtype == ml_dtypes.bfloat16
        _close(tp[k], jp[k], rtol=2 ** -8 if bf16 else RTOL, what=k)
        mom_bf16 = np.asarray(js.mu[k]).dtype == ml_dtypes.bfloat16
        for name in ("mu", "nu"):
            _close(getattr(ts, name)[k], getattr(js, name)[k],
                   rtol=2 ** -8 if mom_bf16 else RTOL, atol=ATOL, what=f"{name} {k}")


def test_adamw_donated_update_is_the_same_in_place():
    params = interop.tree_from_numpy(_tree(2, SHAPES))
    grads = interop.tree_from_numpy(_tree(3, SHAPES))
    opt = adamw.AdamW()
    want_p, want_s = opt.update(grads, opt.init(params), params)
    state = opt.init(params)
    ptrs = [t.data_ptr() for t in leaves(params) + leaves(state.mu)]
    got_p, got_s = opt.update(grads, state, params, donate=True)
    assert [t.data_ptr() for t in leaves(got_p) + leaves(got_s.mu)] == ptrs
    for a, b in zip(leaves((got_p, got_s.mu, got_s.nu)), leaves((want_p, want_s.mu, want_s.nu))):
        assert torch.equal(a, b)


def test_clip_by_global_norm_and_cosine_schedule_match_jax():
    tree = {**_tree(4, SHAPES, scale=3.0), "h": _tree(5, {"h": (7,)}, ml_dtypes.bfloat16)["h"]}
    for max_norm in (1.0, 1e3):
        j_clipped, j_norm = j_adamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in
                                                         tree.items()}, max_norm)
        clipped, norm = adamw.clip_by_global_norm(interop.tree_from_numpy(tree), max_norm)
        _close(norm, j_norm)
        _close(adamw.global_norm(clipped), j_adamw.global_norm(j_clipped))
        for k in tree:
            assert clipped[k].dtype == interop.to_torch(tree[k]).dtype  # scaled in its dtype
            _close(clipped[k], j_clipped[k], rtol=2 ** -8 if k == "h" else RTOL, what=k)
    for step in (0, 3, 10, 55, 100, 140):
        _close(adamw.cosine_schedule(torch.tensor(step), 3e-4, warmup=10, total=100),
               j_adamw.cosine_schedule(jnp.asarray(step), 3e-4, warmup=10, total=100))
    assert adamw.cosine_schedule(0, 1.0, 10, 100).item() == 0.0


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_updates_match_jax_leaf_by_leaf(weight_decay):
    """Factored leaves (2-d and a 3-d stack), vectors (full second moment),
    a bf16 leaf, three updates."""
    params = {**_tree(6, SHAPES), "h": _tree(7, {"h": (6, 5)}, ml_dtypes.bfloat16)["h"]}
    j_opt, opt = j_adafactor.Adafactor(weight_decay=weight_decay), adafactor.Adafactor(
        weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = interop.tree_from_numpy(params)
    js, ts = j_opt.init(jp), opt.init(tp)
    for step in range(3):
        grads = _tree(20 + step, {k: v.shape for k, v in params.items()})
        jp, js = j_opt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        tp, ts = opt.update(interop.tree_from_numpy(grads), ts, tp)
    for k in params:
        _close(tp[k], jp[k], rtol=2 ** -8 if k == "h" else RTOL, what=k)
        for name in ("v_row", "v_col", "v_full"):
            assert tuple(getattr(ts, name)[k].shape) == np.asarray(getattr(js, name)[k]).shape
            _close(getattr(ts, name)[k], getattr(js, name)[k], rtol=1e-5, what=f"{name} {k}")


def test_adafactor_clips_a_big_stack_per_slice_as_the_reference():
    """A leaf of ndim 3 over ``CHUNK_ELEMS`` (2 x 4,097 x 4,096) updates one
    leading slice at a time, each RMS-clipped on its own.  Slice 0's
    gradient is rank one (its factored update has RMS 1: no clip), slice 1's
    heavy-tailed (RMS over 1: clipped), so a whole-leaf clip would scale
    slice 0 too: the port matches JAX and differs from the whole-leaf
    update."""
    shape = (2, 4097, 4096)
    assert np.prod(shape) > adafactor.CHUNK_ELEMS
    rng = np.random.default_rng(8)
    g = np.empty(shape, np.float32)
    g[0] = np.outer(rng.standard_normal(4097), rng.standard_normal(4096)).astype(np.float32)
    g[1] = rng.standard_t(1.5, (4097, 4096)).astype(np.float32)
    p = np.ones(shape, np.float32)
    j_opt, opt = j_adafactor.Adafactor(), adafactor.Adafactor()
    jp, js = j_opt.update({"w": jnp.asarray(g)}, j_opt.init({"w": jnp.asarray(p)}),
                          {"w": jnp.asarray(p)})
    tp, ts = opt.update({"w": torch.from_numpy(g)}, opt.init({"w": torch.from_numpy(p)}),
                        {"w": torch.from_numpy(p)})
    want = np.asarray(jp["w"])
    _close(tp["w"], want, rtol=1e-6, atol=1e-6)
    for name in ("v_row", "v_col"):
        _close(getattr(ts, name)["w"], getattr(js, name)["w"], rtol=1e-5)
    decay = torch.zeros(())  # step 1: decay = 1 - 1 ** -0.8 = 0
    whole, *_ = opt._update_leaf(torch.from_numpy(g), *(torch.zeros(s) for s in
                                 ((2, 4097), (2, 4096), (1,))), torch.from_numpy(p), decay,
                                 opt.lr)
    assert np.abs(whole.numpy()[0] - want[0]).max() > 1e-4  # slice 0 scaled by slice 1's RMS
    np.testing.assert_allclose(1.0 - want[0], opt.lr * _unclipped(g[0]), rtol=1e-4, atol=1e-6)


def _unclipped(g):
    """Slice 0's factored update at step 1, before any clip."""
    g2 = g.astype(np.float64) ** 2 + 1e-30
    vr, vc = g2.mean(-1), g2.mean(-2)
    vhat = (vr / vr.mean())[:, None] * vc[None, :]
    return g / np.sqrt(vhat)


def test_topk_compress_matches_jax_on_distinct_magnitudes_and_on_a_tie():
    grads = _tree(9, {"a": (64, 64), "b": (100,)})
    grads["tie"] = np.array([0.5, -2.0, 2.0, 1.0, -2.0, 0.25, 2.0, 0.0], np.float32)
    j_state = j_compress.init_error_feedback({k: jnp.asarray(v) for k, v in grads.items()})
    state = compress.init_error_feedback(interop.tree_from_numpy(grads))
    for fraction in (0.1, 0.25):
        j_comp, j_state = j_compress.topk_compress({k: jnp.asarray(v) for k, v in grads.items()},
                                                   j_state, fraction)
        comp, state = compress.topk_compress(interop.tree_from_numpy(grads), state, fraction)
        for k in grads:
            np.testing.assert_array_equal(comp[k].numpy(), np.asarray(j_comp[k]), err_msg=k)
            np.testing.assert_array_equal(state.error[k].numpy(), np.asarray(j_state.error[k]))
    # 25% of 8 is 2 of the four |2.0|s: the two with the lowest indices (1, 2)
    first = compress.topk_compress({"tie": torch.from_numpy(grads["tie"])},
                                   compress.init_error_feedback(
                                       {"tie": torch.from_numpy(grads["tie"])}), 0.25)[0]["tie"]
    np.testing.assert_array_equal(first.numpy(), [0, -2.0, 2.0, 0, 0, 0, 0, 0])
    assert compress.compression_ratio_topk(1000, 0.01) == j_compress.compression_ratio_topk(
        1000, 0.01)


def test_int8_compress_matches_jax_exactly_on_its_noise():
    """The reference's own ``jax.random.split`` / ``uniform`` noise fed to
    the port's quantiser: the dequantised gradients and the residuals equal
    JAX's bit for bit, over two rounds of error feedback."""
    grads = {**_tree(11, {"a": (128,), "b": (16, 9)}),
             "h": _tree(12, {"h": (33,)}, ml_dtypes.bfloat16)["h"]}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    j_state = j_compress.init_error_feedback(jg)
    state = compress.init_error_feedback(interop.tree_from_numpy(grads))
    for round_ in range(2):
        key = jax.random.PRNGKey(round_)
        j_comp, j_state_new = j_compress.int8_compress(jg, j_state, key)
        keys = jax.random.split(key, len(grads))
        for (k, g), sub in zip(sorted(grads.items()), keys):
            noise = np.array(jax.random.uniform(sub, g.shape) - 0.5)
            deq, err = compress.quantize_int8(interop.to_torch(g), state.error[k],
                                              torch.from_numpy(noise))
            np.testing.assert_array_equal(interop.to_numpy(deq), np.asarray(j_comp[k]),
                                          err_msg=k)
            np.testing.assert_array_equal(err.numpy(), np.asarray(j_state_new.error[k]))
            state.error[k] = err
        j_state = j_state_new
    comp, _ = compress.int8_compress(interop.tree_from_numpy(grads), state,
                                     torch.Generator().manual_seed(0))
    scale = np.abs(grads["a"] + state.error["a"].numpy()).max() / 127.0
    assert np.abs(comp["a"].numpy() - grads["a"] - state.error["a"].numpy()).max() <= scale * 1.01


def test_adamw_converges_quadratic():
    opt = adamw.AdamW(lr=0.1, weight_decay=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"x": 2 * params["x"]}, state, params)  # d/dx x^2
    assert float(params["x"].abs().max()) < 0.1


def test_adafactor_converges_quadratic():
    opt = adafactor.Adafactor(lr=0.3)
    params = {"w": torch.full((8, 8), 4.0)}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.3
    assert state.v_row["w"].shape == (8,) and state.v_col["w"].shape == (8,)  # factored: small
