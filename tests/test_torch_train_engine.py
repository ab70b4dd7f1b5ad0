"""The port's chunked attention engine against the JAX package's
``_chunked_engine``: outputs and the gradients of q, k and v (one random
cotangent through ``jax.vjp`` and autograd), over the cases
``tests/test_attention_engines.py`` holds the reference to — causal or
not, a window, a softcap, a cache length, rows with no live key — plus the
"auto" switch on both sides of ``CHUNK_THRESHOLD`` and the per-block remat.

Inputs are numpy from a seed.  Tolerances: f32 outputs and gradients 2e-5
(the reference tests' own: the einsums sum in another order); bf16 3e-2
(the port's output rounds to bf16 once, as the reference's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro_torch import interop
from repro_torch.models import attention
from test_torch_threads import one_torch_thread  # noqa: F401


def _inputs(seed, b=2, sq=64, skv=64, h=4, kv=2, d=16, dtype=np.float32, q_base=None):
    rng = np.random.default_rng(seed)
    q, k, v, ct = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d)))
    base = skv - sq if q_base is None else q_base
    q_pos = np.broadcast_to(np.arange(base, base + sq)[None], (b, sq)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(skv)[None], (b, skv)).astype(np.int32)
    if dtype != np.float32:
        q, k, v = (x.astype(dtype) for x in (q, k, v))
    return q, k, v, q_pos, kv_pos, ct


def _both(q, k, v, q_pos, kv_pos, ct, causal, window, kv_len, cap, q_chunk):
    """-> ((out, dq, dk, dv) from JAX, the same from the port), f32 numpy."""
    jkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def j_fn(q_, k_, v_):
        return j_attn._chunked_engine(q_, k_, v_, jnp.asarray(q_pos), jnp.asarray(kv_pos), causal,
                                      window, jkl, cap, q_chunk=q_chunk)

    j_out, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(ct).astype(j_out.dtype))
    tq, tk, tv = (interop.to_torch(x).requires_grad_(True) for x in (q, k, v))
    tkl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out = attention._chunked_engine(tq, tk, tv, torch.from_numpy(q_pos.copy()),
                                    torch.from_numpy(kv_pos.copy()), causal, window, tkl, cap,
                                    q_chunk=q_chunk)
    grads = torch.autograd.grad(out, (tq, tk, tv), interop.to_torch(ct).to(out.dtype))

    def f32(x):
        return np.asarray(x).astype(np.float32)

    return ([f32(j_out)] + [f32(g) for g in j_grads],
            [f32(interop.to_numpy(out))] + [f32(interop.to_numpy(g)) for g in grads])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("cap", [None, 20.0])
def test_chunked_engine_and_its_gradients_match_jax(causal, window, cap):
    want, got = _both(*_inputs(0), causal, window, None, cap, q_chunk=16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)


def test_chunked_engine_with_a_cache_length_matches_jax():
    """16 queries at positions 84-99 over a 256-row cache of which 100 live."""
    want, got = _both(*_inputs(1, sq=16, skv=256, q_base=84), True, None, 100, None, q_chunk=16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5, err_msg=name)


def test_fully_masked_rows_are_zero_with_zero_gradients():
    """An empty cache masks every key: the output is 0, not NaN, and every
    gradient is 0, in both packages."""
    want, got = _both(*_inputs(3, sq=8, skv=64), True, None, 0, None, q_chunk=8)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, 0.0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(w, 0.0, atol=1e-6, err_msg=name)


def test_chunked_engine_in_bf16_matches_jax():
    import ml_dtypes

    want, got = _both(*_inputs(2, dtype=ml_dtypes.bfloat16), True, None, None, 30.0, q_chunk=16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2, err_msg=name)


def test_query_blocks_shrink_to_a_divisor_of_the_rows():
    """Sq 60 with 16-row blocks runs 15-row blocks (the reference's rule for
    a vision prefix): 4 block calls, outputs as JAX's."""
    attention.reset_counts()
    want, got = _both(*_inputs(4, sq=60, skv=60), True, None, None, None, q_chunk=16)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    # 4 blocks forward, each recomputed once in the backward pass
    assert attention.ENGINE_CALLS == {"dense": 0, "chunked": 8}


@pytest.mark.parametrize("sq", [2047, 2048])
def test_auto_switches_at_the_threshold_as_the_reference(sq):
    """Sq * Skv below ``CHUNK_THRESHOLD`` runs dense, from it chunked, in
    both packages; the outputs agree with JAX's "auto"."""
    assert attention.CHUNK_THRESHOLD == j_attn.CHUNK_THRESHOLD == 2048 * 2048
    q, k, v, q_pos, kv_pos, _ = _inputs(5, b=1, sq=sq, skv=2048, h=2, kv=1, d=8)
    kw = dict(causal=True, window=None, kv_len=None, cap=None, impl="auto")
    want = j_attn.attention_engine(*(jnp.asarray(x) for x in (q, k, v, q_pos, kv_pos)), **kw)
    attention.reset_counts()
    with torch.no_grad():
        got = attention.attention_engine(*(torch.from_numpy(x.copy()) for x in
                                           (q, k, v, q_pos, kv_pos)), **kw)
    chunked = sq * 2048 >= attention.CHUNK_THRESHOLD
    assert attention.ENGINE_CALLS == ({"dense": 0, "chunked": 8} if chunked
                                      else {"dense": 1, "chunked": 0})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_per_block_remat_changes_no_bit(monkeypatch):
    """The blocks recomputed in the backward pass give the gradients a run
    that keeps every block's residuals gives, bitwise."""
    args = _inputs(6)
    _, remat = _both(*args, True, 20, None, 20.0, q_chunk=16)
    monkeypatch.setattr(attention, "checkpoint", lambda fn, *a, **_: fn(*a))
    _, kept = _both(*args, True, 20, None, 20.0, q_chunk=16)
    for a, b in zip(remat, kept):
        np.testing.assert_array_equal(a, b)
