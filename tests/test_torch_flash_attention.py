"""Flash attention parity: the port's plain twin vs the JAX reference on the CPU.

Inputs are drawn with numpy and handed to both packages.  The port's
``ops.flash_attention`` on CPU tensors runs its plain twin (``ref.py``);
it is held against the reference's ``reference_bhsd`` and against the
reference's Pallas kernel in interpret mode, on the reference tests' cases
(``tests/test_kernels.py``), the partial ``kv_len`` case and the cascade
backbone's shape (16 lanes x 8 tokens).  The split kernel's twin
(``ref.split_bhsd``: partials over shares of the live keys, then the
combine) is held against both at 1, 2, 3 and 8 shares.  Tolerances are the
reference tests' own: 2e-5 in f32 (sums in another order), 2e-2 in bf16
(the output rounds to bf16 once in each package, at places that can differ
by an ulp).
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
# the tc kernel's pipeline edges (two products in flight, the warpgroups'
# turns), at D 64 and 128; then kv_len and q_offset_from_kv_len
for _d in (64, 128):
    FA_CASES += [
        (1, 128, 128, 4, 2, _d, False, None, None, "bfloat16"),  # 1 live key tile
        (1, 128, 256, 4, 2, _d, False, None, None, "bfloat16"),  # 2
        (1, 128, 384, 4, 2, _d, False, None, None, "bfloat16"),  # 3
        (1, 200, 200, 4, 2, _d, True, None, None, "bfloat16"),  # 8 live rows in warpgroup 1
        (1, 200, 256, 2, 1, _d, True, None, None, "bfloat16", 100, True),  # rows 0-99: no key
        # rows 0-139 see no key: query tiles with no live key tile beside tiles with four
        (1, 640, 640, 2, 1, _d, True, None, None, "bfloat16", 500, True),
        (1, 64, 256, 4, 2, _d, True, 64, None, "bfloat16", None, True),  # the window: one tile
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


def _block(n):
    """The reference kernel's block along an axis of n rows: 64, or the whole
    axis where 64 does not divide it (its grid takes whole blocks only)."""
    return 64 if n % 64 == 0 else n


@pytest.mark.parametrize("case", FA_CASES)
def test_plain_twin_matches_jax_reference_and_kernel(case):
    b, sq, skv, h, kv, d, causal, window, cap, dtype, kv_len, q_off = (*case, None, False)[:12]
    q, k, v = _inputs(sq + d, b, sq, skv, h, kv, d, dtype)
    ops.reset_counts()
    t_len = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32)
    out = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)), t_len, causal=causal,
                              window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    assert ops.PLAIN_CALLS["flash_attention"] == 1 and ops.LAUNCHES["flash_attention"] == 0
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    kv_len = jnp.asarray([skv if kv_len is None else kv_len], jnp.int32)
    j_kernel = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len,
                                     causal=causal, window=window, logit_softcap=cap,
                                     q_offset_from_kv_len=q_off, block_q=_block(sq),
                                     block_kv=_block(skv), interpret=True)
    j_plain = j_ref.reference_bhsd(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                   jnp.asarray(_bhsd(v)), kv_len, num_q_heads=h,
                                   num_kv_heads=kv, causal=causal, window=window, softcap=cap,
                                   q_offset_from_kv_len=q_off)
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
    assert kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "short"
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
    # the tc pipeline's ragged tiles at D 64 and 128; then kv_len, q_offset_from_kv_len
    (2, 200, 333, 4, 2, 64, 100, 30.0, 12.0, 300, True),
    (2, 200, 333, 4, 2, 128, 100, 30.0, 12.0, 300, True),
]


@pytest.mark.parametrize("case", CAPPED_CASES)
def test_plain_twin_matches_jax_where_the_softcap_binds(case):
    b, sq, skv, h, kv, d, window, cap, q_scale, kv_len, q_off = (*case, None, False)[:11]
    assert kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "tc"
    q, k, v = _inputs(sq * 3 + d, b, sq, skv, h, kv, d, "float32")
    q, k, v = ((x * s).astype(ml_dtypes.bfloat16) for x, s in ((q, q_scale), (k, 1), (v, 1)))
    kw = dict(causal=True, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    t_len = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32)
    out = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)), t_len, **kw)
    kv_len = jnp.asarray([skv if kv_len is None else kv_len], jnp.int32)
    j_kernel = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len,
                                     block_q=_block(sq), block_kv=_block(skv), interpret=True,
                                     **kw)
    j_plain = j_ref.reference_bhsd(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                   jnp.asarray(_bhsd(v)), kv_len, num_q_heads=h,
                                   num_kv_heads=kv, causal=True, window=window, softcap=cap,
                                   q_offset_from_kv_len=q_off)
    j_plain = np.transpose(_f32(j_plain).reshape(b, h, sq, d), (0, 2, 1, 3))
    got = _f32(interop.to_numpy(out))
    np.testing.assert_allclose(got, j_plain, rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    np.testing.assert_allclose(got, _f32(j_kernel), rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    # the cap binds: the same inputs without it give another answer
    uncapped = ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)), t_len,
                                   **{**kw, "logit_softcap": None})
    assert not np.allclose(_f32(interop.to_numpy(uncapped)), j_plain,
                           rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


# the split route's shapes (G * Sq <= 8 rows over > 64 keys, D 64 / 128), the
# whole mask contract: b, sq, skv, h, kv, d, causal, window, softcap, kv_len,
# q_scale, dtype (queries at the end of the valid cache)
SPLIT_CASES = [
    (1, 1, 256, 4, 4, 64, False, None, None, None, 1.0, "float32"),  # 1 query, G 1
    (1, 1, 256, 4, 4, 64, False, None, None, None, 1.0, "bfloat16"),
    (2, 4, 256, 8, 4, 128, True, 48, None, 200, 1.0, "float32"),  # G 2 x Sq 4: causal rows
    (1, 2, 256, 8, 2, 64, True, None, 30.0, 256, 12.0, "bfloat16"),  # the softcap binds
    (1, 8, 256, 1, 1, 64, True, 100, None, 4, 1.0, "float32"),  # rows 0-3: no live key
]


@pytest.mark.parametrize("num_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_twin_matches_jax(case, num_splits):
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_scale, dtype = case
    assert kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "split"
    q, k, v = _inputs(sq * 5 + d + skv, b, sq, skv, h, kv, d, "float32")
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q, k, v = ((x * s).astype(np_dt) for x, s in ((q, q_scale), (k, 1), (v, 1)))
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=True)
    kl = skv if kv_len is None else kv_len
    args = [interop.to_torch(x) for x in (q, k, v)] + [torch.tensor([kl], dtype=torch.int32)]
    got = _f32(interop.to_numpy(ops.plain_bshd(*args, num_splits=num_splits, **kw)))
    j_kv_len = jnp.asarray([kl], jnp.int32)
    j_kernel = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_kv_len,
                                     block_q=64, block_kv=64, interpret=True, **kw)
    j_plain = j_ref.reference_bhsd(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                                   jnp.asarray(_bhsd(v)), j_kv_len, num_q_heads=h,
                                   num_kv_heads=kv, causal=causal, window=window, softcap=cap,
                                   q_offset_from_kv_len=True)
    j_plain = np.transpose(_f32(j_plain).reshape(b, h, sq, d), (0, 2, 1, 3))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, j_plain, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, _f32(j_kernel), rtol=tol, atol=tol)
    if kl < sq:  # rows before key 0 see no key: 0 (the l == 0 rule)
        assert not got[:, :sq - kl].any() and got[:, sq - kl:].any()
    if q_scale > 1:  # the cap binds: the twin without it gives another answer
        uncapped = ops.plain_bshd(*args, num_splits=num_splits,
                                  **{**kw, "logit_softcap": None})
        assert not np.allclose(_f32(interop.to_numpy(uncapped)), j_plain, rtol=tol, atol=tol)


def test_split_bounds_share_the_union_of_the_live_keys():
    """Shares of [first token's lo, last token's hi), differing by at most one
    key; none live, or fewer keys than shares, leaves empty shares."""
    kw = dict(causal=True, window=48, q_offset_from_kv_len=True)
    assert ref.split_bounds(200, 256, 4, 3, **kw) == [(149, 166), (166, 183), (183, 200)]
    assert ref.split_bounds(4, 256, 8, 2, **{**kw, "window": None}) == [(0, 2), (2, 4)]
    assert ref.split_bounds(0, 256, 1, 2, **kw) == [(0, 0), (0, 0)]
    assert ref.split_bounds(300, 256, 1, 8, causal=False, window=None,
                            q_offset_from_kv_len=True)[-1] == (224, 256)
    shares = ref.split_bounds(3, 256, 1, 8, causal=False, window=None,
                              q_offset_from_kv_len=False)
    assert sum(e - s for s, e in shares) == 3 and sum(s == e for s, e in shares) == 5


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


@pytest.mark.parametrize("dtype,sq,d,g,skv,want", [
    (torch.bfloat16, 2048, 128, 2, 4096, "tc"),  # the qwen3-1.7b prefill
    (torch.bfloat16, 64, 64, 1, 64, "tc"),
    (torch.bfloat16, 200, 128, 2, 333, "tc"),
    (torch.bfloat16, 8, 128, 2, 8, "short"),  # the cascade's 8 tokens a lane
    (torch.bfloat16, 8, 64, 5, 8, "short"),  # the hymba trunk's: 40 rows a kv head
    (torch.bfloat16, 63, 128, 1, 4096, "short"),
    (torch.bfloat16, 8, 64, 2, 300, "short"),  # 16 rows a kv head over 300 keys
    (torch.bfloat16, 1, 64, 1, 1024, "split"),  # seamless's cross-attention decode
    (torch.bfloat16, 8, 128, 1, 300, "split"),  # G * Sq = 8
    (torch.bfloat16, 4, 64, 2, 65, "split"),
    (torch.bfloat16, 1, 128, 8, 4096, "split"),
    (torch.bfloat16, 1, 64, 1, 64, "short"),  # 64 keys or fewer stay "short"
    (torch.bfloat16, 9, 128, 1, 4096, "short"),  # 9 rows a kv head
    (torch.bfloat16, 1, 80, 1, 1024, "simt"),  # head dims neither short kernel takes
    (torch.bfloat16, 1, 256, 2, 1024, "simt"),
    (torch.float32, 1, 64, 1, 1024, "simt"),
    (torch.bfloat16, 8, 96, 2, 8, "simt"),
    (torch.bfloat16, 4096, 80, 4, 4640, "tc"),  # the h2o-danube and gemma2 prefills
    (torch.bfloat16, 4096, 256, 2, 4640, "tc"),
    (torch.bfloat16, 64, 80, 4, 64, "tc"),
    (torch.bfloat16, 8, 256, 2, 8, "simt"),  # short blocks the short kernel does not take
    (torch.bfloat16, 8, 80, 4, 8, "simt"),
    (torch.bfloat16, 63, 256, 2, 63, "simt"),
    (torch.bfloat16, 4096, 32, 2, 4096, "simt"),  # head dims the tc kernel does not take
    (torch.bfloat16, 4096, 96, 2, 4096, "simt"),
    (torch.float32, 4096, 128, 2, 4096, "simt"),  # f32 keeps exact FMAs: no TF32
    (torch.float32, 4096, 256, 2, 4096, "simt"),
    (torch.float16, 4096, 128, 2, 4096, "simt"),
])
def test_route_picks_the_kernel_from_dtype_and_shape(dtype, sq, d, g, skv, want):
    assert kernel.route(dtype, sq, d, g, skv) == want


def test_cpu_calls_count_no_route():
    q, k, v = _inputs(3, 1, 64, 64, 4, 2, 64, "bfloat16")
    ops.reset_counts()
    ops.flash_attention(*(interop.to_torch(x) for x in (q, k, v)))
    assert ops.ROUTES == {"tc": 0, "short": 0, "split": 0, "simt": 0}
    assert ops.PLAIN_CALLS["flash_attention"] == 1
