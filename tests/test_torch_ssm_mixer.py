"""The Mamba-2 mixer's front and gated norm: the port's twins vs the JAX package.

``kernels/ssm_mixer/ref.py`` holds the mixer's elementwise chain around the
SSD (the causal conv + SiLU, SiLU(z), softplus(dt + dt_bias); the D skip
and ``rmsnorm(y * gate)``), the twins of the two CUDA kernels in
``csrc/ssm_mixer.cu``.  Inputs are drawn with numpy from a seed and handed
to both packages on the CPU.  Tolerances, of the reference's values:

* f32: ``F32_TOL`` — XLA and PyTorch compute SiLU (``x * logistic(x)`` vs
  ``x / (1 + exp(-x))``), softplus (``logaddexp(x, 0)`` vs
  ``log1p(exp(x))`` below 20) and the norm's mean in other ways, each an
  ulp or two apart;
* bf16: ``BF16_TOL`` — XLA may keep a chain of bf16 ops in f32 (excess
  precision) where PyTorch rounds after each op, so the conv's partial sums
  and the norm's input differ by a few bf16 ulps (2^-8).

On the CPU ``ops`` runs the twins themselves, so the kernel engine's mixer
is the plain engines' bit for bit; only the kernel engine reaches ``ops``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.archs import get_config as j_get_config
from repro.models import ssm as j_ssm
from repro.models.layers import rmsnorm as j_rmsnorm
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.kernels.autograd import NoBackwardError
from repro_torch.kernels.ssm_mixer import kernel, ops, ref
from repro_torch.models import ssm
from _torch_ulps import ulps
from test_torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-6
BF16_TOL = 2e-2
ARCHS = ("mamba2-370m", "hymba-1.5b")
DTYPES = {"float32": (np.float32, F32_TOL), "bfloat16": (ml_dtypes.bfloat16, BF16_TOL)}


def _np(x):
    return np.asarray(interop.to_numpy(x) if torch.is_tensor(x) else x).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _widths(arch):
    """(d_inner, state_dim, heads, head_dim, conv width) of the smoke config."""
    s = j_get_config(arch, smoke=True).ssm
    d = j_get_config(arch, smoke=True).d_model
    return s.d_inner(d), s.state_dim, s.num_heads(d), s.head_dim, s.conv_width


def _front_inputs(arch, b, s, dtype, tail, seed):
    di, n, h, _, width = _widths(arch)
    c = di + 2 * n
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype][0]
    proj = (rng.standard_normal((b, s, 2 * di + 2 * n + h)) * 2).astype(np.float32).astype(np_dt)
    w = (rng.standard_normal((width, c)) * 0.5).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dt_bias = (rng.standard_normal(h) * 3).astype(np.float32)
    dt_bias[0] = 25.0  # past PyTorch's softplus threshold of 20
    cache = rng.standard_normal((b, width - 1, c)).astype(np.float32).astype(np_dt) if tail else None
    return proj, w, bias, dt_bias, cache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,tail", [(1, True), (1, False), (9, False), (9, True), (40, True)])
def test_front_twin_matches_jax(arch, dtype, s, tail):
    """``ref.front`` (split, conv + SiLU, SiLU(z), softplus) against the
    reference's ``_split_proj``, ``_causal_conv``, ``jax.nn.silu`` and
    ``jax.nn.softplus`` on the same inputs, the new tail included."""
    j_cfg = j_get_config(arch, smoke=True)
    di, n, _, _, _ = _widths(arch)
    proj, w, bias, dt_bias, cache = _front_inputs(arch, 2, s, dtype, tail, seed=s + len(arch))
    tol = DTYPES[dtype][1]
    z, xbc, dt_raw = j_ssm._split_proj(j_cfg, jnp.asarray(proj))
    j_xbc, j_tail = j_ssm._causal_conv(xbc, jnp.asarray(w), jnp.asarray(bias),
                                       None if cache is None else jnp.asarray(cache))
    want = (j_xbc, jax.nn.silu(z), jax.nn.softplus(dt_raw.astype(jnp.float32) + dt_bias), j_tail)
    got = ref.front(interop.to_torch(proj), torch.from_numpy(w), torch.from_numpy(bias),
                    torch.from_numpy(dt_bias), di, n,
                    None if cache is None else interop.to_torch(cache))
    for name, g, wt in zip(("xbc", "gate", "dt", "new_tail"), got, want):
        assert tuple(g.shape) == wt.shape, name
        assert g.dtype == (torch.float32 if name == "dt" else interop.to_torch(proj).dtype), name
        _close(g, wt, F32_TOL if name == "new_tail" else tol)  # the tail is copied, not computed
    assert got[0].is_contiguous() and got[1].is_contiguous()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [1, 24])
def test_gated_norm_twin_matches_jax(arch, dtype, s):
    """``ref.gated_norm`` (y + x D, then rmsnorm(y * gate)) against the
    reference's lines (``y + x_in * D.astype``, ``rmsnorm(y * silu(z))``),
    x a strided view of the conv output as in the model."""
    j_cfg = j_get_config(arch, smoke=True)
    di, n, h, p, _ = _widths(arch)
    np_dt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + di)
    y = rng.standard_normal((2, s, h, p)).astype(np.float32).astype(np_dt)
    xbc = rng.standard_normal((2, s, di + 2 * n)).astype(np.float32).astype(np_dt)
    z = rng.standard_normal((2, s, di)).astype(np.float32).astype(np_dt)
    d_skip = rng.standard_normal(h).astype(np.float32)
    norm_w = (1 + 0.1 * rng.standard_normal(di)).astype(np.float32)
    jy = jnp.asarray(y) + jnp.asarray(xbc)[..., :di].reshape(2, s, h, p) * jnp.asarray(
        d_skip).astype(jnp.asarray(y).dtype)[None, None, :, None]
    want = j_rmsnorm(jy.reshape(2, s, di) * jax.nn.silu(jnp.asarray(z)), jnp.asarray(norm_w),
                     j_cfg.rmsnorm_eps)
    t_xbc = interop.to_torch(xbc)
    gate = torch.nn.functional.silu(interop.to_torch(z))
    got = ref.gated_norm(interop.to_torch(y), t_xbc[..., :di].reshape(2, s, h, p),
                         torch.from_numpy(d_skip), gate, torch.from_numpy(norm_w),
                         j_cfg.rmsnorm_eps)
    assert tuple(got.shape) == (2, s, di) and got.dtype == interop.to_torch(y).dtype
    _close(got, want, 4 * tol if dtype == "float32" else tol)  # f32: a mean over di values


def _layer(arch, dtype, impl):
    """The reference's config and init of layer 0's mixer, and the same in
    the port -> (j_cfg, j_layer, cfg, layer)."""
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    params, _ = JModel(j_cfg).init_params(jax.random.PRNGKey(1))
    j_layer = jax.tree.map(lambda t: t[0], params["layers"][0]["ssm"])
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    return j_cfg, j_layer, cfg, interop.tree_from_numpy(jax.device_get(j_layer))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["auto", "dense", "chunked", "kernel"])
def test_only_the_kernel_engine_reaches_the_wrappers(arch, impl, monkeypatch):
    """``ssm_apply``'s plain engines call the twins themselves and never
    ``ops`` (whose CUDA route launches the kernels) or a launcher; the kernel
    engine calls ``ops.front`` and ``ops.gated_norm`` once each (a prefill
    into a cache and a decode step), which on the CPU run the same twins, so
    every engine's output and cache are bitwise the dense engine's."""
    calls = {"front": 0, "gated_norm": 0, "launch": 0}
    for name in ("front", "gated_norm"):
        fn = getattr(ops, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(ops, name, counted)

    def launch(*args, **kwargs):
        calls["launch"] += 1
        raise AssertionError("a mixer kernel launched")

    monkeypatch.setattr(kernel, "launch_front", launch)
    monkeypatch.setattr(kernel, "launch_gated_norm", launch)
    _, _, cfg, layer = _layer(arch, "bfloat16", impl)
    dense_cfg = dataclasses.replace(cfg, attn_impl="dense")
    rng = np.random.default_rng(11)
    x = interop.to_torch(rng.standard_normal((2, 32, cfg.d_model)).astype(ml_dtypes.bfloat16))
    x1 = interop.to_torch(rng.standard_normal((2, 1, cfg.d_model)).astype(ml_dtypes.bfloat16))
    outs = []
    for c in (cfg, dense_cfg):
        cache = ssm.init_ssm_cache(c, 2, torch.bfloat16)
        y, cache = ssm.ssm_apply(layer, c, x, cache, update_cache=True)
        y1, cache = ssm.ssm_apply(layer, c, x1, cache, update_cache=True)
        outs.append((y, y1, cache.conv, cache.h))
        if c is cfg:
            want = 2 if impl == "kernel" else 0
            assert calls == {"front": want, "gated_norm": want, "launch": 0}, calls
    for g, w in zip(*outs):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_engine_mixer_matches_jax(arch, dtype):
    """The whole mixer under the kernel engine (``ops`` on the CPU: the
    twins) against the reference's ``ssm_apply``: a prefill into a cache,
    then a decode step, the cache's conv tail and state included."""
    j_cfg, j_layer, cfg, layer = _layer(arch, dtype, "kernel")
    np_dt, tol = DTYPES[dtype]
    tol = 2e-5 if dtype == "float32" else 5 * tol  # the SSD's sums and the projections too
    rng = np.random.default_rng(12)
    j_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    j_cache = j_ssm.init_ssm_cache(j_cfg, 2, j_dt)
    cache = ssm.init_ssm_cache(cfg, 2, interop.to_torch(np.zeros(1, np_dt)).dtype)
    ops.reset_counts()
    for s in (32, 1):
        x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32).astype(np_dt)
        want, j_cache = j_ssm.ssm_apply(j_layer, j_cfg, jnp.asarray(x), j_cache,
                                        update_cache=True)
        got, cache = ssm.ssm_apply(layer, cfg, interop.to_torch(x), cache, update_cache=True)
        _close(got, want, tol)
        for g, w in zip(cache, j_cache):
            _close(g, w, tol)
    assert ops.PLAIN_CALLS == {ops.FRONT: 2, ops.NORM: 2} and not any(ops.LAUNCHES.values())


def test_wrappers_refuse_grad_and_misfit_operands():
    """The wrappers refuse an input that requires grad (the kernels have no
    backward; on any device) and operands that do not fit one another; a
    projection read with hymba's row stride of 6,482 values is taken."""
    di, n = 64, 8
    h = 4
    width = 2 * di + 2 * n + h
    proj = torch.randn(2, 5, width)
    w, b, dt_bias = torch.randn(4, di + 2 * n), torch.randn(di + 2 * n), torch.randn(h)
    with pytest.raises(NoBackwardError):
        ops.front(proj.requires_grad_(True), w, b, dt_bias, d_inner=di, state_dim=n)
    proj = proj.detach()
    with pytest.raises(ValueError, match="do not fit"):
        ops.front(proj, w, b, dt_bias[:3], d_inner=di, state_dim=n)
    with pytest.raises(ValueError, match="cache_tail"):
        ops.front(proj, w, b, dt_bias, d_inner=di, state_dim=n, cache_tail=torch.zeros(2, 2, 80))
    with pytest.raises(TypeError, match="one dtype"):
        ops.front(proj.half(), w, b, dt_bias, d_inner=di, state_dim=n)
    y = torch.randn(2, 5, h, di // h)
    x_in, gate, d_skip, norm_w = torch.randn_like(y), torch.randn(2, 5, di), torch.ones(h), \
        torch.ones(di)
    with pytest.raises(NoBackwardError):
        ops.gated_norm(y, x_in, d_skip, gate.requires_grad_(True), norm_w, 1e-5)
    gate = gate.detach()
    with pytest.raises(ValueError, match="do not fit"):
        ops.gated_norm(y, x_in, d_skip, gate[..., :8], norm_w, 1e-5)
    with pytest.raises(ValueError, match="x_in"):
        ops.gated_norm(y, x_in[:1], d_skip, gate, norm_w, 1e-5)
    with pytest.raises(TypeError, match="one dtype"):
        ops.gated_norm(y, x_in.bfloat16(), d_skip, gate, norm_w, 1e-5)
    # hymba's rows: 2 x 3,200 + 32 + 50 = 6,482 values, a slice of wider rows
    rows = torch.randn(1, 3, 6490).bfloat16()[..., :6482]
    out = ops.front(rows, torch.randn(4, 3232), torch.randn(3232), torch.randn(50),
                    d_inner=3200, state_dim=16, new_tail=True)
    assert [tuple(t.shape) for t in out] == [(1, 3, 3232), (1, 3, 3200), (1, 3, 50), (1, 3, 3232)]


@pytest.mark.parametrize("width,dtype,pad,fits", [
    (4384, torch.bfloat16, 0, True),  # mamba2-370m's rows
    (6482, torch.bfloat16, 0, True),  # hymba-1.5b's: every row after the first 4-byte aligned
    (6482, torch.bfloat16, 1, False),  # an odd row stride
    (4384, torch.float32, 0, True),
    (6482, torch.float32, 1, False),
])
def test_kernels_take_the_operands_their_loads_fit(width, dtype, pad, fits):
    """``kernel.front_fits`` holds where every row, the tail and the z / xBC
    boundary take loads of two values, ``kernel.norm_fits`` where every row
    takes 16-byte loads (plain functions of the operands: no CUDA)."""
    di, n = (2048, 128) if width == 4384 else (3200, 16)
    proj = torch.zeros((2, 3, width + pad), dtype=dtype)[..., :width]
    tail = torch.zeros((2, 3, di + 2 * n), dtype=dtype)
    assert kernel.front_fits(proj, tail, di, di + 2 * n) == fits
    y = torch.zeros((2, 3, di // 64, 64), dtype=dtype)
    xbc = torch.zeros((2, 3, di + 2 * n + pad), dtype=dtype)
    x = xbc[..., pad:pad + di].reshape(y.shape)
    assert kernel.norm_fits(y, x, y.reshape(2, 3, di), torch.ones(di), 64) == fits


def test_ulps_counts_units_in_the_last_place():
    one = torch.tensor([1.0, -1.0, 0.0, 2.0], dtype=torch.bfloat16)
    up = torch.tensor([1.0078125, -1.0078125, -0.0, 2.0], dtype=torch.bfloat16)
    assert ulps(one, up).tolist() == [1, 1, 0, 0]
    x = torch.tensor([1.0, 0.0])
    assert ulps(x, torch.nextafter(x, torch.tensor([2.0, -1.0]))).tolist() == [1, 1]
    with pytest.raises(TypeError):
        ulps(x, x.double())
