"""Decode-attention parity: the port's split-KV twin and decode route vs the JAX package.

Inputs are drawn with numpy and handed to both packages; both run on the
CPU.  The port's ``ops`` on CPU tensors run the plain twin (``ref.py``); it
is held against the reference's Pallas kernel in interpret mode on
``tests/test_kernels.py``'s cases.  Tolerances:

* the partials (m, l, acc) at equal ``num_splits``: rtol / atol 2e-5 — the
  dot products and sums run in another order (bf16 inputs hold the same bits
  in both packages and are computed in f32);
* the combined output: the reference tests' own 2e-5 (f32) and 3e-2 (bf16:
  the port returns q's dtype, so its output rounds to bf16 once);
* the combine across split counts: the reference test's 1e-5 / 1e-6;
* the model's decode route against the reference's dense engine: 2e-5
  (f32), the attention tests' tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_kernels import DA_CASES

from repro.configs.archs import get_config as j_get_config
from repro.kernels.decode_attention import kernel as j_kernel
from repro.kernels.decode_attention import ops as j_ops
from repro.kernels.decode_attention import ref as j_ref
from repro.models import attention as j_attn
from repro_torch import interop
from repro_torch.configs.archs import ARCHS, get_config
from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.models import attention
from test_torch_threads import one_torch_thread  # noqa: F401

PART_TOL = 2e-5


def _f32(x):
    return np.asarray(interop.to_numpy(x) if torch.is_tensor(x) else x).astype(np.float32)


def _inputs(seed, b, skv, h, kv, d, dtype):
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == jnp.bfloat16 else np.float32
    return [rng.standard_normal(s).astype(np.float32).astype(np_dt)
            for s in ((b, 1, h, d), (b, skv, kv, d), (b, skv, kv, d))]


def _grouped(q, k, v):
    """[B, 1, H, D] / [B, Skv, KV, D] -> the kernel's [BKV, G, D] / [BKV, Skv, D]."""
    b, _, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qm = q[:, 0].reshape(b * kvh, h // kvh, d)
    km, vm = (np.ascontiguousarray(np.transpose(t, (0, 2, 1, 3)).reshape(b * kvh, skv, d))
              for t in (k, v))
    return qm, km, vm


@pytest.mark.parametrize("case", DA_CASES)
def test_partials_twin_matches_the_pallas_kernel(case):
    b, skv, h, kv, d, cap, window, ns, dtype = case
    arrays = _grouped(*_inputs(0, b, skv, h, kv, d, dtype))
    kv_len = np.asarray([skv * 3 // 4], np.int32)
    want = j_kernel.decode_attention_partials(*(jnp.asarray(a) for a in arrays),
                                              jnp.asarray(kv_len), softcap=cap, window=window,
                                              num_splits=ns, interpret=True)
    ops.reset_counts()
    got = ops.decode_attention_partials(*(interop.to_torch(a) for a in arrays),
                                        torch.from_numpy(kv_len), softcap=cap, window=window,
                                        num_splits=ns)
    assert ops.PLAIN_CALLS[ops.KERNEL] == 1 and ops.LAUNCHES[ops.KERNEL] == 0
    for name, g, w in zip(("m", "l", "acc"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PART_TOL, atol=PART_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", DA_CASES)
def test_decode_attention_matches_jax(case):
    b, skv, h, kv, d, cap, window, ns, dtype = case
    q, k, v = _inputs(1, b, skv, h, kv, d, dtype)
    kv_len = np.asarray([skv * 3 // 4], np.int32)
    got = ops.decode_attention(*(interop.to_torch(a) for a in (q, k, v)),
                               torch.from_numpy(kv_len), softcap=cap, window=window,
                               num_splits=ns)
    assert got.shape == (b, 1, h, d) and got.dtype == interop.to_torch(q).dtype
    jargs = [jnp.asarray(a) for a in (q, k, v, kv_len)]
    want = j_ops.decode_attention(*jargs, softcap=cap, window=window, num_splits=ns,
                                  interpret=True)
    oracle = j_ref.reference_decode(*jargs, softcap=cap, window=window)
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-5
    for w in (want, oracle):
        np.testing.assert_allclose(_f32(got), _f32(w), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _f32(ref.reference_decode(*(interop.to_torch(a) for a in (q, k, v, kv_len)),
                                  softcap=cap, window=window)), _f32(oracle), rtol=tol, atol=tol)


def test_combine_partials_algebra_over_split_counts():
    """The reference test's fixture: the combine is exact whatever the splits."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 1, 512, 4, 2, 32, jnp.float32))
    kv_len = torch.tensor([512], dtype=torch.int32)
    outs = [ops.decode_attention(q, k, v, kv_len, num_splits=ns).numpy() for ns in (1, 2, 8)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-6)
    m, l, acc = (torch.from_numpy(np.array(t)) for t in j_kernel.decode_attention_partials(
        *(jnp.asarray(a) for a in _grouped(q.numpy(), k.numpy(), v.numpy())),
        jnp.asarray([512], jnp.int32), num_splits=8, interpret=True))
    np.testing.assert_allclose(ref.combine_partials(m, l, acc).numpy(),
                               np.asarray(j_ops.combine_partials(*(jnp.asarray(t.numpy())
                                                                   for t in (m, l, acc)))),
                               rtol=1e-6, atol=1e-7)


def test_dead_splits_and_an_empty_cache():
    """A split with no live key gives the TPU kernel's (-1e30, 0, 0), and
    kv_len = 0 combines to 0, not NaN."""
    qm, km, vm = (interop.to_torch(a) for a in _grouped(*_inputs(2, 2, 256, 4, 2, 32,
                                                                 jnp.float32)))
    for kv_len, window in ((40, None), (200, 16), (0, None)):
        kl = torch.tensor([kv_len], dtype=torch.int32)
        m, l, acc = ops.decode_attention_partials(qm, km, vm, kl, window=window, num_splits=8)
        pos = torch.arange(256).reshape(8, 32)
        live = (pos < kv_len) & ((pos > kv_len - window) if window else True)
        dead = ~live.any(dim=1)
        assert dead.any()
        assert (m[:, dead] == ref.NEG_INF).all() and (l[:, dead] == 0).all()
        assert (acc[:, dead] == 0).all()
        jm, jl, jacc = j_kernel.decode_attention_partials(
            *(jnp.asarray(t.numpy()) for t in (qm, km, vm)), jnp.asarray([kv_len], jnp.int32),
            window=window, num_splits=8, interpret=True)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=PART_TOL, atol=PART_TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=PART_TOL, atol=PART_TOL)
    out = ref.combine_partials(m, l, acc)
    assert torch.isfinite(out).all() and (out == 0).all()


def _local_cfgs(window):
    j_cfg = dataclasses.replace(j_get_config("qwen3-1.7b", smoke=True), dtype="float32",
                                layer_pattern=("local",), sliding_window=window,
                                attn_logit_softcap=30.0)
    return j_cfg, interop.model_config_from(j_cfg)


@pytest.mark.parametrize("mixer", ["local", "global"])
def test_decode_route_matches_the_dense_engine_decode(mixer):
    """The port's ``attn_apply`` decode route (``impl="kernel"``: one query
    token over the cache goes to the decode kernel) equals the reference's
    dense-engine decode, at a local window too: the route translates the
    model's window (``k > q - window``) into the kernel's (``k > kv_len -
    window``) by passing ``window + 1``."""
    window, b, s_max, prefix = 8, 3, 48, 39
    j_cfg, cfg = _local_cfgs(window)
    j_params, _ = j_attn.attn_init(jax.random.PRNGKey(0), j_cfg)
    params = interop.tree_from_numpy(jax.device_get(j_params))
    rng = np.random.default_rng(3)
    shape = (b, s_max, cfg.num_kv_heads, cfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((b, 1), prefix, np.int32)
    j_cache = j_attn.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(prefix, jnp.int32))
    want, j_new = j_attn.attn_apply(j_params, dataclasses.replace(j_cfg, attn_impl="dense"),
                                    jnp.asarray(x), jnp.asarray(pos), mixer, cache=j_cache,
                                    update_cache=True)
    cache = attention.init_kv_cache(cfg, b, s_max, torch.float32)
    assert int(cache.length) == 0 and cache.k.shape == shape
    cache.k.copy_(torch.from_numpy(k0))
    cache.v.copy_(torch.from_numpy(v0))
    cache = cache._replace(length=torch.tensor(prefix, dtype=torch.int32))
    ops.reset_counts()
    got, new = attention.attn_apply(params, dataclasses.replace(cfg, attn_impl="kernel"),
                                    torch.from_numpy(x), torch.from_numpy(pos).long(), mixer,
                                    cache=cache, update_cache=True)
    assert ops.PLAIN_CALLS[ops.FUSED] == 1  # the decode route ran (the fused kernel's twin)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-5, atol=2e-5)
    assert int(new.length) == int(j_new.length) == prefix + 1
    # the new row written in place (RoPE rounds an ulp apart in the two packages)
    np.testing.assert_allclose(new.k.numpy(), _f32(j_new.k), rtol=1e-6, atol=1e-6)
    assert new.k is cache.k


def test_decode_kernel_window_convention_is_one_key_narrower():
    """The reference kernel's window (``k > kv_len - window``, the query at
    ``kv_len``) admits one key fewer than the dense engine's (``k > q -
    window``, the query at ``kv_len - 1``): equal with ``window + 1``,
    different without it.  Nothing in the reference routes its model
    through the decode kernel, so its own tests cannot see this."""
    window, kv_len, b, s_max, h, kv, d = 8, 40, 2, 64, 4, 2, 16
    q, k, v = _inputs(4, b, s_max, h, kv, d, jnp.float32)
    q_pos = np.full((b, 1), kv_len - 1, np.int32)
    kv_pos = np.broadcast_to(np.arange(s_max)[None], (b, s_max)).astype(np.int32)
    dense = j_attn.attention_engine(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)),
                                    causal=True, window=window,
                                    kv_len=jnp.asarray(kv_len, jnp.int32), cap=None,
                                    impl="dense")
    kl = torch.tensor([kv_len], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plus_one = ops.decode_attention(tq, tk, tv, kl, window=window + 1)
    as_is = ops.decode_attention(tq, tk, tv, kl, window=window)
    np.testing.assert_allclose(plus_one.numpy(), _f32(dense), rtol=2e-5, atol=2e-5)
    assert np.abs(as_is.numpy() - _f32(dense)).max() > 0.5  # 0.713 on these inputs
    j_as_is = j_ops.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray([kv_len], jnp.int32), window=window,
                                     interpret=True)
    np.testing.assert_allclose(as_is.numpy(), _f32(j_as_is), rtol=2e-5, atol=2e-5)


def test_decode_wrapper_refuses_bad_operands():
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 1, 32, 4, 2, 16, jnp.float32))
    kl = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.decode_attention(q, k, v, kl.long())
    with pytest.raises(TypeError, match="dtype"):
        ops.decode_attention(q, k.bfloat16(), v, kl)
    with pytest.raises(ValueError, match="B, 1, H, D"):
        ops.decode_attention(q.expand(1, 2, 4, 16), k, v, kl)
    assert ops.default_num_splits(64, 4096) == 16 and ops.default_num_splits(1024, 4096) == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(a for a in ARCHS if ARCHS[a]().num_heads))
def test_partials_kernel_takes_every_zoo_decode_group(arch, dtype):
    """The partials kernel (the mesh decode's route over a row-sharded cache)
    takes every decode group the port's architectures give it, G = H / KV
    heads of head dim D, in both dtypes: G 6 / 7 at D 128 (nemotron, grok-1,
    arctic) included, which the kernel once refused on the card (its simt
    form held at most 512 query values a block) while the reference's
    Pallas kernel computes them.  The form is "tc" exactly for bf16 at the
    tensor-core head dims."""
    cfg = get_config(arch)  # every architecture with attention heads (not mamba2)
    g, d = cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    assert kernel.supports_partials(g, d, dtype), (arch, g, d, dtype)
    want = "tc" if dtype == torch.bfloat16 and d in kernel.TC_HEAD_DIMS else "simt"
    assert kernel.partials_route(dtype, d) == want


def test_partials_split_count_fills_the_sms_in_each_form():
    """``default_num_splits`` doubles the reference's 8 while the blocks are
    fewer than the SMs hold at once in the partials kernel's form (four a SM
    in simt, two in tc) and a split keeps 64 keys; ``decode_attention_split``
    takes the count of the form its dtype and head dim route to, on the CPU
    as on the card, so the twin's splits are the kernel's."""
    assert ops.default_num_splits(64, 4096) == ops.default_num_splits(64, 4096, "simt") == 16
    assert ops.default_num_splits(64, 4096, "tc") == 8  # qwen3-1.7b decode in bf16
    assert ops.default_num_splits(8, 2080, "tc") == 32 and ops.default_num_splits(8, 544, "tc") == 8
    q, k, v = (interop.to_torch(a) for a in _inputs(15, 8, 4096, 8, 8, 64, jnp.bfloat16))
    kl = torch.tensor([2048], dtype=torch.int32)
    m, _, acc = ops.decode_attention_split(q, k, v, kl)  # bf16 at D 64: the tc form's count
    assert m.shape == (8, 8, 8, 1) and acc.shape == (8, 8, 8, 1, 64)
    m, _, _ = ops.decode_attention_split(q.float(), k.float(), v.float(), kl)
    assert m.shape == (8, 8, 16, 1)


# b, skv, h, kv, d, kv_len, window, softcap, num_splits: the groups over 512
# values a block that the simt form runs as row sub-groups (nemotron, grok-1:
# G 6; arctic: G 7), at D 128
WIDE_GROUP_CASES = [
    (1, 256, 48, 8, 128, 200, None, None, 4),
    (1, 256, 56, 8, 128, 231, 64, 30.0, 8),
    (2, 128, 56, 8, 128, 128, None, None, 2),
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", WIDE_GROUP_CASES)
def test_split_partials_at_wide_groups_match_the_pallas_kernel(case, dtype):
    """``decode_attention_split`` (the mesh decode's call, on the cache's
    [B, S, KV, D] layout) at G 6 / 7, D 128 against the reference's Pallas
    kernel in interpret mode on the grouped layout, and its combine against
    the reference's jnp combine, at 2e-5."""
    b, skv, h, kv, d, kv_len, window, cap, ns = case
    q, k, v = _inputs(14, b, skv, h, kv, d, dtype)
    kl = np.asarray([kv_len], np.int32)
    ops.reset_counts()
    m, l, acc = ops.decode_attention_split(*(interop.to_torch(a) for a in (q, k, v)),
                                           torch.from_numpy(kl), softcap=cap, window=window,
                                           num_splits=ns)
    assert ops.PLAIN_CALLS[ops.KERNEL] == 1 and not any(ops.PARTIAL_ROUTES.values())
    g = h // kv
    assert m.shape == (b, kv, ns, g) and acc.shape == (b, kv, ns, g, d)
    jm, jl, jacc = j_kernel.decode_attention_partials(
        *(jnp.asarray(a) for a in _grouped(q, k, v)), jnp.asarray(kl), softcap=cap,
        window=window, num_splits=ns, interpret=True)
    for name, got, want in zip(("m", "l", "acc"), (m, l, acc), (jm, jl, jacc)):
        np.testing.assert_allclose(got.reshape(want.shape).numpy(), np.asarray(want),
                                   rtol=PART_TOL, atol=PART_TOL, err_msg=name)
    np.testing.assert_allclose(
        ref.combine_partials(m, l, acc).reshape(b * kv, g, d).numpy(),
        np.asarray(j_ops.combine_partials(jm, jl, jacc)), rtol=PART_TOL, atol=PART_TOL)


# b, skv, h, kv, d, kv_len, window, softcap, num_splits (the fused route's live-key splits)
LIVE_CASES = [
    (2, 64, 4, 2, 64, 0, None, None, 8),  # an empty cache: 0, not NaN
    (2, 64, 4, 2, 64, 1, None, None, 8),  # one live key
    (1, 128, 8, 1, 128, 5, None, None, 8),  # fewer live keys than splits; GQA 8
    (2, 96, 4, 4, 64, 77, None, None, 6),  # kv_len not a multiple of ns; GQA 1
    (2, 256, 4, 2, 128, 200, 48, 30.0, 8),  # window and softcap; GQA 2
    (1, 512, 16, 2, 64, 384, None, 50.0, 4),  # GQA 8 with a softcap
    (2, 128, 8, 1, 128, 100, 200, None, 3),  # a window wider than the live keys
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", LIVE_CASES)
def test_fused_decode_twin_matches_jax(case, dtype):
    """The fused route's twin (partials over the live-key splits, then the
    combine) against JAX's ``decode_attention`` (the Pallas kernel in
    interpret mode, splits over the cache length) and ``reference_decode``."""
    b, skv, h, kv, d, kv_len, window, cap, ns = case
    q, k, v = _inputs(11, b, skv, h, kv, d, dtype)
    kl = np.asarray([kv_len], np.int32)
    ops.reset_counts()
    got = ops.decode_attention(*(interop.to_torch(a) for a in (q, k, v)), torch.from_numpy(kl),
                               softcap=cap, window=window, num_splits=ns)
    assert ops.PLAIN_CALLS == {ops.KERNEL: 0, ops.FUSED: 1} and not any(ops.LAUNCHES.values())
    assert got.shape == (b, 1, h, d) and got.dtype == interop.to_torch(q).dtype
    jargs = [jnp.asarray(a) for a in (q, k, v, kl)]
    want = j_ops.decode_attention(*jargs, softcap=cap, window=window, interpret=True)
    oracle = j_ref.reference_decode(*jargs, softcap=cap, window=window)
    if kv_len == 0:
        assert (got == 0).all()  # the reference's dense softmax over no key is NaN
        np.testing.assert_array_equal(_f32(want), 0.0)
        return
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-5
    for w in (want, oracle):
        np.testing.assert_allclose(_f32(got), _f32(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_len,skv,ns,window", [
    (0, 64, 8, None), (1, 64, 8, None), (5, 128, 8, None), (9, 64, 8, None),
    (77, 96, 6, None), (4096, 4096, 8, None), (300, 256, 8, 48), (100, 128, 3, 200),
    (2048, 4096, 8, 513),
])
def test_live_split_bounds_share_the_live_keys(kv_len, skv, ns, window):
    """The fused kernel's shares cover the live keys once, in order, differ
    by at most one key, and leave a block idle only when fewer than ``ns``
    keys are live; the partials over them combine to the same output as
    the reference's splits over the cache length."""
    bounds = ref.live_split_bounds(kv_len, skv, ns, window)
    lo = 0 if window is None else max(0, kv_len - window + 1)
    hi = min(kv_len, skv)
    assert len(bounds) == ns and bounds[0][0] == lo and bounds[-1][1] == max(hi, lo)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [e - s for s, e in bounds]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == max(hi - lo, 0)
    assert (0 in sizes) == (hi - lo < ns)
    q, k, v = (torch.from_numpy(a) for a in _inputs(12, 1, skv, 4, 2, 32, jnp.float32))
    kl = torch.tensor([kv_len], dtype=torch.int32)
    qm, km, vm = (torch.from_numpy(a) for a in _grouped(q.numpy(), k.numpy(), v.numpy()))
    m, l, acc = ref.live_partials(qm, km, vm, kl, num_splits=ns, window=window)
    for i, (s, e) in enumerate(bounds):
        if s == e:
            assert (m[:, i] == ref.NEG_INF).all() and (l[:, i] == 0).all()
            assert (acc[:, i] == 0).all()
    split_ns = ref.split_count(skv, 8)
    np.testing.assert_allclose(
        ref.combine_partials(m, l, acc).numpy(),
        ref.combine_partials(*ref.decode_attention_partials(
            qm, km, vm, kl, num_splits=split_ns, window=window)).numpy(), rtol=1e-5, atol=1e-6)


def test_fused_split_count_and_its_refusals():
    """``fused_num_splits`` keeps one cluster of at most 8 blocks per kv
    head, fewer for a short cache or when the blocks would outnumber what
    the SMs hold at once in the kernel's form; the wrapper refuses a count
    the cluster cannot hold."""
    assert ops.fused_num_splits(64, 4096, "tc") == 2  # qwen3-1.7b decode: B 8 x KV 8, bf16
    assert ops.fused_num_splits(64, 4096, "simt") == 4  # ... in f32
    assert ops.fused_num_splits(16, 4096, "simt") == 8 and ops.fused_num_splits(16, 4096, "tc") == 8
    assert ops.fused_num_splits(32, 4096, "simt") == 8 and ops.fused_num_splits(32, 4096, "tc") == 4
    assert ops.fused_num_splits(64, 128, "simt") == 2 and ops.fused_num_splits(4, 16, "tc") == 1
    assert ops.fused_num_splits(1024, 4096, "simt") == 1 and ops.fused_num_splits(100, 4096, "simt") == 2
    assert kernel.fused_route(torch.bfloat16, 128) == "tc" and kernel.fused_route(torch.float32, 128) == "simt"
    assert kernel.fused_route(torch.bfloat16, 256) == "tc" and kernel.fused_route(torch.bfloat16, 64) == "tc"
    q, k, v = (torch.from_numpy(a) for a in _inputs(13, 1, 32, 4, 2, 16, jnp.float32))
    kl = torch.tensor([8], dtype=torch.int32)
    for ns in (0, 9, 16):
        with pytest.raises(ValueError, match="1 to 8 splits"):
            ops.decode_attention(q, k, v, kl, num_splits=ns)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 80, "tc"),  # h2o-danube's head dim
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 256, "tc"),  # gemma2's
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 48, "simt"), (torch.bfloat16, 96, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 80, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),  # f32 keeps f32 FMAs
])
def test_fused_route_picks_the_form_from_dtype_and_head_dim(dtype, d, want):
    """The fused kernel's tensor-core form takes bf16 at D 64, 80, 128 and
    256, every group of at most 8 heads; the simt form the rest.  A CPU call
    runs the twin and counts no form."""
    assert kernel.fused_route(dtype, d) == want
    if want == "tc":
        assert all(kernel.supports_fused(g, d, dtype) for g in range(1, 9))
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 32, 4, 2, 16, jnp.float32))
    ops.reset_counts()
    ops.decode_attention(q, k, v, torch.tensor([8], dtype=torch.int32))
    assert ops.ROUTES == {"tc": 0, "simt": 0, "split": 0} and ops.PLAIN_CALLS[ops.FUSED] == 1


# b, skv, h, kv, d, kv_len, window, softcap, num_splits, q_scale, dtype: q drawn
# unit-normal times q_scale, so the scores (about N(0, q_scale^2)) reach
# |s / cap| ~ 2, where the cap moves them by far more than the tolerance
BINDING_CASES = [
    (2, 256, 4, 2, 64, 200, 48, 30.0, 8, 12.0, jnp.float32),  # the tc form's D 64
    (2, 256, 4, 2, 128, 200, None, 30.0, 8, 12.0, jnp.bfloat16),  # and D 128
    (1, 300, 32, 8, 80, 280, 129, 30.0, 4, 12.0, jnp.float32),  # the simt form at D 80, G 4
    (1, 600, 16, 8, 256, 580, 257, 50.0, 8, 16.0, jnp.bfloat16),  # gemma2 local: G 2, D 256
    (1, 600, 16, 8, 256, 580, None, 50.0, 8, 16.0, jnp.float32),  # gemma2 global
]


@pytest.mark.parametrize("case", BINDING_CASES)
def test_decode_softcap_holds_where_it_binds(case):
    """The fused route's twin and the partials twin against JAX's Pallas
    kernel (interpret mode) and ``reference_decode`` with scores that reach
    the cap; the twin without its cap (the control) must miss JAX's capped
    output beyond the tolerance, or the case could not tell a right softcap
    from a missing one."""
    b, skv, h, kv, d, kv_len, window, cap, ns, q_scale, dtype = case
    q, k, v = _inputs(13, b, skv, h, kv, d, jnp.float32)
    np_dt = ml_dtypes.bfloat16 if dtype == jnp.bfloat16 else np.float32
    q, k, v = (q * q_scale).astype(np_dt), k.astype(np_dt), v.astype(np_dt)
    kl = np.asarray([kv_len], np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, kl)]
    want = _f32(j_ops.decode_attention(*jargs, softcap=cap, window=window, interpret=True))
    np.testing.assert_allclose(want, _f32(j_ref.reference_decode(*jargs, softcap=cap,
                                                                 window=window)),
                               rtol=3e-2, atol=3e-2)
    targs = [interop.to_torch(a) for a in (q, k, v)] + [torch.from_numpy(kl)]
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-5
    got = ops.decode_attention(*targs, softcap=cap, window=window, num_splits=ns)
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol)
    uncapped = ops.decode_attention(*targs, softcap=None, window=window, num_splits=ns)
    miss = np.abs(_f32(uncapped) - want).max()
    assert miss > 10 * tol, f"the cap does not bind here: uncapped misses by only {miss}"
    # the partials twin against the Pallas kernel, and its control
    grouped = _grouped(q, k, v)
    j_part = j_kernel.decode_attention_partials(*(jnp.asarray(a) for a in grouped),
                                                jnp.asarray(kl), softcap=cap, window=window,
                                                num_splits=ns, interpret=True)
    t_grouped = [interop.to_torch(a) for a in grouped] + [torch.from_numpy(kl)]
    part = ops.decode_attention_partials(*t_grouped, softcap=cap, window=window, num_splits=ns)
    for name, g, w in zip(("m", "l", "acc"), part, j_part):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PART_TOL, atol=PART_TOL,
                                   err_msg=name)
    part_uncapped = ops.decode_attention_partials(*t_grouped, softcap=None, window=window,
                                                  num_splits=ns)
    assert np.abs(part_uncapped[0].numpy() - np.asarray(j_part[0])).max() > 1.0  # the max score
