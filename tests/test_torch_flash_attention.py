"""Flash attention parity: the port's plain twin vs the JAX reference on the CPU.

Inputs are drawn with numpy and handed to both packages.  The port's
``ops.flash_attention`` on CPU tensors runs its plain twin (``ref.py``);
it is held against the reference's ``reference_bhsd`` and against the
reference's Pallas kernel in interpret mode, on the reference tests' cases
(``tests/test_kernels.py``), the partial ``kv_len`` case and the cascade
backbone's shape (16 lanes x 8 tokens).  Tolerances are the reference
tests' own: 2e-5 in f32 (sums in another order), 2e-2 in bf16 (the output
rounds to bf16 once in each package, at places that can differ by an ulp).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention import ref as j_ref
from repro_torch import interop
from repro_torch.kernels.flash_attention import kernel, ops, ref
from test_torch_threads import one_torch_thread  # noqa: F401

# b, sq, skv, h, kv, d, causal, window, softcap, dtype
FA_CASES = [
    (1, 128, 128, 4, 2, 32, True, None, None, "float32"),
    (2, 256, 256, 4, 4, 64, True, None, 50.0, "float32"),
    (1, 128, 128, 8, 2, 32, True, 48, None, "float32"),
    (2, 128, 128, 4, 1, 64, False, None, None, "float32"),
    (1, 256, 256, 4, 2, 32, True, None, None, "bfloat16"),
    (16, 8, 8, 4, 2, 16, False, None, None, "float32"),  # backbone: 16 lanes x 8 tokens
    (16, 8, 8, 4, 2, 16, False, None, None, "bfloat16"),
    (1, 128, 128, 4, 2, 80, True, None, None, "bfloat16"),  # h2o-danube's head dim
    (1, 128, 128, 4, 1, 80, True, 48, 30.0, "bfloat16"),
    (1, 128, 128, 4, 2, 256, True, 48, 50.0, "bfloat16"),  # gemma2's: window + softcap
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, b, sq, skv, h, kv, d, dtype):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.standard_normal(s).astype(np.float32).astype(np_dt)
            for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))]


def _bhsd(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, d))


def _f32(x):
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("case", FA_CASES)
def test_plain_twin_matches_jax_reference_and_kernel(case):
    b, sq, skv, h, kv, d, causal, window, cap, dtype = case
    q, k, v = _inputs(sq + d, b, sq, skv, h, kv, d, dtype)
    ops.reset_counts()
    out = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)), causal=causal,
                              window=window, logit_softcap=cap)
    assert ops.PLAIN_CALLS["flash_attention"] == 1 and ops.LAUNCHES["flash_attention"] == 0
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    kv_len = jnp.asarray([skv], jnp.int32)
    j_kernel = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len,
                                     causal=causal, window=window, logit_softcap=cap,
                                     block_q=64, block_kv=64, interpret=True)
    j_plain = j_ref.reference_bhsd(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                   jnp.asarray(_bhsd(v)), kv_len, num_q_heads=h,
                                   num_kv_heads=kv, causal=causal, window=window, softcap=cap)
    j_plain = np.transpose(_f32(j_plain).reshape(b, h, sq, d), (0, 2, 1, 3))
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(interop.to_numpy(out)), j_plain, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(interop.to_numpy(out)), _f32(j_kernel), rtol=tol, atol=tol)


# bf16 shapes of the "short" route (Sq < 64, D 64 / 128), with the whole mask
# contract: b, sq, skv, h, kv, d, kv_len, window, softcap (causal, queries at
# the end of the valid cache)
SHORT_CASES = [
    (4, 8, 64, 4, 2, 128, 6, 4, 20.0),  # G * Sq = 16; rows 0-1 sit before key 0
    (2, 33, 128, 8, 2, 128, 100, 24, 30.0),  # G 4, Sq 33: G * Sq = 132, a ragged tile
    (2, 33, 128, 8, 2, 64, 100, 24, 30.0),
]


@pytest.mark.parametrize("case", SHORT_CASES)
def test_short_route_shapes_match_jax(case):
    b, sq, skv, h, kv, d, kv_len, window, cap = case
    assert kernel.route(torch.bfloat16, sq, d) == "short"
    q, k, v = _inputs(sq * 7 + d, b, sq, skv, h, kv, d, "bfloat16")
    kw = dict(causal=True, window=window, logit_softcap=cap, q_offset_from_kv_len=True)
    out = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)),
                              torch.tensor([kv_len], dtype=torch.int32), **kw)
    j_kv_len = jnp.asarray([kv_len], jnp.int32)
    j_kernel = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_kv_len,
                                     block_q=64, block_kv=64, interpret=True, **kw)
    j_plain = j_ref.reference_bhsd(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                   jnp.asarray(_bhsd(v)), j_kv_len, num_q_heads=h,
                                   num_kv_heads=kv, causal=True, window=window, softcap=cap,
                                   q_offset_from_kv_len=True)
    j_plain = np.transpose(_f32(j_plain).reshape(b, h, sq, d), (0, 2, 1, 3))
    got = _f32(interop.to_numpy(out))
    np.testing.assert_allclose(got, j_plain, rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    np.testing.assert_allclose(got, _f32(j_kernel), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    if kv_len < sq:  # rows before key 0 see no key: 0 (the l == 0 rule)
        assert not got[:, :sq - kv_len].any()


# bf16 tc shapes whose scores reach the softcap: q drawn unit-normal times
# q_scale, so s ~ N(0, q_scale^2) against the cap (|s / cap| up to ~2); unit
# scores barely feel a cap of 30-50.  b, sq, skv, h, kv, d, window, softcap, q_scale
CAPPED_CASES = [
    (1, 128, 128, 4, 2, 80, 48, 30.0, 12.0),
    (1, 128, 128, 4, 2, 128, None, 30.0, 12.0),
    (1, 128, 128, 4, 2, 256, None, 50.0, 16.0),
]


@pytest.mark.parametrize("case", CAPPED_CASES)
def test_plain_twin_matches_jax_where_the_softcap_binds(case):
    b, sq, skv, h, kv, d, window, cap, q_scale = case
    assert kernel.route(torch.bfloat16, sq, d) == "tc"
    q, k, v = _inputs(sq * 3 + d, b, sq, skv, h, kv, d, "float32")
    q, k, v = ((x * s).astype(ml_dtypes.bfloat16) for x, s in ((q, q_scale), (k, 1), (v, 1)))
    kw = dict(causal=True, window=window, logit_softcap=cap)
    out = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)), **kw)
    kv_len = jnp.asarray([skv], jnp.int32)
    j_kernel = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len,
                                     block_q=64, block_kv=64, interpret=True, **kw)
    j_plain = j_ref.reference_bhsd(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                   jnp.asarray(_bhsd(v)), kv_len, num_q_heads=h,
                                   num_kv_heads=kv, causal=True, window=window, softcap=cap)
    j_plain = np.transpose(_f32(j_plain).reshape(b, h, sq, d), (0, 2, 1, 3))
    got = _f32(interop.to_numpy(out))
    np.testing.assert_allclose(got, j_plain, rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    np.testing.assert_allclose(got, _f32(j_kernel), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    # the cap binds: the same inputs without it give another answer
    uncapped = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)),
                                   **{**kw, "logit_softcap": None})
    assert not np.allclose(_f32(interop.to_numpy(uncapped)), j_plain,
                           rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, 60)])
def test_partial_kv_len_queries_at_the_end_of_the_cache(causal, window):
    b, sq, skv, h, kv, d = 1, 64, 256, 4, 2, 32
    q, k, v = _inputs(1, b, sq, skv, h, kv, d, "float32")
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.tensor([100], dtype=torch.int32), causal=causal,
                              window=window, q_offset_from_kv_len=True)
    want = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray([100], jnp.int32), causal=causal, window=window,
                                 q_offset_from_kv_len=True, block_q=64, block_kv=64,
                                 interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_rows_without_a_live_key_are_zero():
    # kv_len 3 < Sq 5 with queries at the end of the cache: rows 0 and 1 sit
    # before position 0, see no key and must output 0 (the l == 0 rule)
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 1, 5, 9, 2, 1, 16, "float32"))
    out = ops.flash_attention(q, k, v, torch.tensor([3], dtype=torch.int32), causal=True,
                              q_offset_from_kv_len=True)
    assert torch.all(out[:, :2] == 0) and torch.all(out[:, 2:].abs().sum(-1) > 0)
    plain = ref.reference_bhsd(q.transpose(1, 2).reshape(2, 5, 16),
                               k.transpose(1, 2).reshape(1, 9, 16),
                               v.transpose(1, 2).reshape(1, 9, 16),
                               torch.tensor([3], dtype=torch.int32), num_q_heads=2,
                               num_kv_heads=1, causal=True, q_offset_from_kv_len=True)
    torch.testing.assert_close(out, plain.reshape(1, 2, 5, 16).transpose(1, 2), rtol=0, atol=0)


def test_ops_refuses_mixed_devices_dtypes_and_shapes():
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 1, 8, 8, 4, 2, 16, "float32"))
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="takes"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="group"):
        ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="on meta"):
        ops.flash_attention(q, k.to("meta"), v)
    with pytest.raises(TypeError, match="int32"):
        ops.flash_attention(q, k, v, torch.tensor([8]))


@pytest.mark.parametrize("dtype,sq,d,want", [
    (torch.bfloat16, 2048, 128, "tc"),  # the qwen3-1.7b prefill
    (torch.bfloat16, 64, 64, "tc"),
    (torch.bfloat16, 200, 128, "tc"),
    (torch.bfloat16, 8, 128, "short"),  # the cascade's 8 tokens a lane
    (torch.bfloat16, 63, 128, "short"),
    (torch.bfloat16, 8, 64, "short"),
    (torch.bfloat16, 8, 96, "simt"),
    (torch.bfloat16, 4096, 80, "tc"),  # the h2o-danube and gemma2 prefills
    (torch.bfloat16, 4096, 256, "tc"),
    (torch.bfloat16, 64, 80, "tc"),
    (torch.bfloat16, 8, 256, "simt"),  # short blocks the short kernel does not take
    (torch.bfloat16, 8, 80, "simt"),
    (torch.bfloat16, 63, 256, "simt"),
    (torch.bfloat16, 4096, 32, "simt"),  # head dims the tc kernel does not take
    (torch.bfloat16, 4096, 96, "simt"),
    (torch.float32, 4096, 128, "simt"),  # f32 keeps exact FMAs: no TF32
    (torch.float32, 4096, 256, "simt"),
    (torch.float16, 4096, 128, "simt"),
])
def test_route_picks_the_kernel_from_dtype_and_shape(dtype, sq, d, want):
    assert kernel.route(dtype, sq, d) == want


def test_cpu_calls_count_no_route():
    q, k, v = _inputs(3, 1, 64, 64, 4, 2, 64, "bfloat16")
    ops.reset_counts()
    ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)))
    assert ops.ROUTES == {"tc": 0, "short": 0, "simt": 0}
    assert ops.PLAIN_CALLS["flash_attention"] == 1
