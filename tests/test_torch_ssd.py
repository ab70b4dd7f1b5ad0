"""SSD parity: the port's intra-chunk twin, scan and Mamba-2 mixer vs the JAX package.

Inputs are drawn with numpy and handed to both packages; both run on the
CPU.  The port's ``ops`` on CPU tensors run the plain twin (``ref.py``); it
is held against the reference's Pallas kernel in interpret mode and its
``ops.ssd_scan`` / ``reference_ssd``, on ``tests/test_kernels.py``'s cases.
Tolerances:

* the intra-chunk outputs: rtol / atol 2e-5 — the port's cumsum is a
  sequential scan, the reference kernel's a tril-ones matmul, so
  ``exp(cum)`` and the decays differ in the last f32 bits, and the products
  sum over Q and N in another order (bf16 inputs round identically: both
  packages hold the same bits and compute in f32);
* the scan against the naive recurrence: the reference tests' own 1e-4
  (f32) and 5e-2 (bf16);
* the mixer and the SSD engines against the reference's jnp ``ssd_chunked``
  and ``ssm_apply``: 2e-5 (f32 sums in another order, XLA's and PyTorch's
  softplus / exp differ by an ulp);
* the inter-chunk twin (``ref.inter_chunk_bshp``, the CPU path of
  ``ops.inter_chunk``) and ``ops.ssd_bshp`` against the reference's
  ``ssd_scan`` (its Pallas intra-chunk kernel in interpret mode, then its
  jnp scan) and ``ssd_chunked``, at state dims 16 and 128 and chunks of 8
  and 256: ``INTER_TOL`` of the output's largest magnitude (the twin's
  states sum over the chunks' exponentials in another order than XLA's
  scan, and C.h sums N products in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES

from repro.configs.archs import get_config as j_get_config
from repro.kernels.ssd_scan import kernel as j_kernel
from repro.kernels.ssd_scan import ops as j_ops
from repro.kernels.ssd_scan import ref as j_ref
from repro.models import ssm as j_ssm
from repro.models.model import Model as JModel
from repro_torch import interop
from repro_torch.kernels.ssd_scan import kernel, ops, ref
from repro_torch.models import ssm
from test_torch_threads import one_torch_thread  # noqa: F401

INTRA_TOL = 2e-5
MIXER_TOL = 2e-5
INTER_TOL = 2e-5  # of the output's largest magnitude


def _f32(x):
    return np.asarray(interop.to_numpy(x) if torch.is_tensor(x) else x).astype(np.float32)


def _inputs(seed, bh, s, p, n, dtype, h0=False):
    """x, dt, a, b, c (and h0) as numpy, the reference tests' distributions."""
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == jnp.bfloat16 else np.float32
    x = rng.standard_normal((bh, s, p)).astype(np.float32).astype(np_dt)
    dt = (np.log1p(np.exp(rng.standard_normal((bh, s)))) * 0.1).astype(np.float32)
    a = (-np.exp(rng.standard_normal(bh) * 0.3)).astype(np.float32)
    b = rng.standard_normal((bh, s, n)).astype(np.float32).astype(np_dt)
    c = rng.standard_normal((bh, s, n)).astype(np.float32).astype(np_dt)
    out = [x, dt, a, b, c]
    if h0:
        out.append(rng.standard_normal((bh, p, n)).astype(np.float32))
    return out


@pytest.mark.parametrize("case", SSD_CASES)
def test_intra_chunk_twin_matches_the_pallas_kernel(case):
    bh, s, p, n, chunk, dtype = case
    arrays = _inputs(3, bh, s, p, n, dtype)
    want = j_kernel.ssd_intra_chunk(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                                    interpret=True)
    got = ref.ssd_intra_chunk(*(interop.to_torch(a) for a in arrays), chunk=chunk)
    for name, g, w in zip(("y_intra", "s_contrib", "cumexp"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=INTRA_TOL, atol=INTRA_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_jax_scan_and_recurrence(case):
    bh, s, p, n, chunk, dtype = case
    arrays = _inputs(4, bh, s, p, n, dtype)
    ops.reset_counts()
    y, h = ops.ssd_scan(*(interop.to_torch(a) for a in arrays), chunk=chunk)
    assert ops.PLAIN_CALLS[ops.KERNEL] == 1 and ops.LAUNCHES[ops.KERNEL] == 0
    jy, jh = j_ops.ssd_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), _f32(jy), rtol=INTRA_TOL, atol=INTRA_TOL)
    np.testing.assert_allclose(h.numpy(), _f32(jh), rtol=INTRA_TOL, atol=INTRA_TOL)
    tol = 5e-2 if dtype == jnp.bfloat16 else 1e-4
    ry, rh = j_ref.reference_ssd(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), _f32(ry), rtol=tol, atol=tol)
    np.testing.assert_allclose(h.numpy(), _f32(rh), rtol=tol, atol=tol)
    ty, th = ref.reference_ssd(*(interop.to_torch(a) for a in arrays))
    np.testing.assert_allclose(ty.numpy(), _f32(ry), rtol=INTRA_TOL, atol=INTRA_TOL)
    np.testing.assert_allclose(th.numpy(), _f32(rh), rtol=INTRA_TOL, atol=INTRA_TOL)


def test_ssd_scan_with_initial_state_matches_jax():
    """The fixture of ``test_kernels.py::test_ssd_scan_with_initial_state``."""
    arrays = _inputs(5, 2, 64, 16, 8, jnp.float32, h0=True)
    y, h = ops.ssd_scan(*(interop.to_torch(a) for a in arrays), chunk=32)
    jy, jh = j_ops.ssd_scan(*(jnp.asarray(a) for a in arrays), chunk=32, interpret=True)
    np.testing.assert_allclose(y.numpy(), _f32(jy), rtol=INTRA_TOL, atol=INTRA_TOL)
    np.testing.assert_allclose(h.numpy(), _f32(jh), rtol=INTRA_TOL, atol=INTRA_TOL)
    ry, rh = j_ref.reference_ssd(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y.numpy(), _f32(ry), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), _f32(rh), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(64, 16), (8, 8)])
def test_shared_bc_layout_and_dropped_final_state(s, chunk):
    """The model's layout (B / C shared by H heads, read with a head stride of
    0) gives the [BH] layout's outputs; without a final state the last
    chunk's state is left out and nothing else changes."""
    bsz, nh, p, n = 2, 3, 8, 12
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((bsz, s, nh, p)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bsz, s, nh)).astype(np.float32))
    a = -torch.from_numpy(rng.uniform(0.5, 2.0, nh).astype(np.float32))
    b, c = (torch.from_numpy(rng.standard_normal((bsz, s, n)).astype(np.float32))
            for _ in range(2))
    a_bh = a[None].expand(bsz, nh)
    full = ref.intra_chunk_bshp(x, dt, a_bh, b, c, chunk=chunk)
    part = ref.intra_chunk_bshp(x, dt, a_bh, b, c, chunk=chunk, final_state=False)
    nc = s // chunk
    assert full[1].shape == (bsz, nh, nc, p, n) and part[1].shape == (bsz, nh, nc - 1, p, n)
    assert torch.equal(full[0], part[0]) and torch.equal(full[2], part[2])
    assert torch.equal(full[1][:, :, :-1], part[1])
    # the [BH] layout with B / C broadcast over the heads
    xb = x.permute(0, 2, 1, 3).reshape(bsz * nh, s, p)
    bb, cb = (t[:, None].expand(bsz, nh, s, n).reshape(bsz * nh, s, n) for t in (b, c))
    y_bh, h_bh = ops.ssd_scan(xb, dt.permute(0, 2, 1).reshape(bsz * nh, s), a_bh.reshape(-1),
                              bb, cb, chunk=chunk)
    y, h = ops.ssd_bshp(x, dt, a_bh, b, c, chunk=chunk)
    torch.testing.assert_close(y.permute(0, 2, 1, 3).reshape(bsz * nh, s, p), y_bh,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h.reshape(bsz * nh, p, n), h_bh, rtol=1e-6, atol=1e-6)
    y2, h2 = ops.ssd_bshp(x, dt, a_bh, b, c, chunk=chunk, final_state=False)
    assert h2 is None and torch.equal(y2, y)


# ------------------------------------------------- the inter-chunk twin --


def _model_layout(seed, bsz, s, nh, p, n):
    """x, dt, a [H], b, c and h0 in the model's layout (numpy, f32), the
    reference tests' distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, nh, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((bsz, s, nh)))) * 0.1).astype(np.float32)
    a = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    b, c = (rng.standard_normal((bsz, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((bsz, nh, p, n)).astype(np.float32)
    return x, dt, a, b, c, h0


def _close(got, want):
    want = _f32(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=INTER_TOL * scale)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("n,chunk", [(16, 8), (16, 256), (128, 8), (128, 256)])
def test_inter_chunk_twin_matches_the_reference_scan(n, chunk, with_h0):
    """The twin on the intra-chunk twin's outputs, and ``ops.ssd_bshp`` on the
    CPU (both twins, each counted as a plain call), against the reference's
    ``ssd_scan`` (the [BH] layout, B / C broadcast over the heads) and its
    model-layout ``ssd_chunked``; with and without h0, with the final state
    and without it (then y alone, and no state)."""
    bsz, nh, p = 2, 2, 8
    s = 4 * chunk if chunk == 8 else 2 * chunk
    x, dt, a, b, c, h0 = _model_layout(n + chunk, bsz, s, nh, p, n)
    h0 = h0 if with_h0 else None
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    a_bh = t[2][None].expand(bsz, nh)
    parts = ref.intra_chunk_bshp(t[0], t[1], a_bh, t[3], t[4], chunk=chunk)
    y_twin, h_twin = ref.inter_chunk_bshp(*parts, t[4], th0, chunk=chunk)
    ops.reset_counts()
    y, h = ops.ssd_bshp(t[0], t[1], a_bh, t[3], t[4], th0, chunk=chunk)
    assert ops.PLAIN_CALLS == {ops.KERNEL: 1, ops.INTER: 1} and not any(ops.LAUNCHES.values())
    assert torch.equal(y, y_twin) and torch.equal(h, h_twin)
    y_part, none = ops.ssd_bshp(t[0], t[1], a_bh, t[3], t[4], th0, chunk=chunk,
                                final_state=False)
    assert none is None and torch.equal(y_part, y)
    # the reference: its scan in the [BH] layout, and the model's ssd_chunked
    xb = x.transpose(0, 2, 1, 3).reshape(bsz * nh, s, p)
    dtb = dt.transpose(0, 2, 1).reshape(bsz * nh, s)
    ab = np.broadcast_to(a, (bsz, nh)).reshape(-1).copy()
    bb, cb = (np.broadcast_to(m[:, None], (bsz, nh, s, n)).reshape(bsz * nh, s, n).copy()
              for m in (b, c))
    h0b = None if h0 is None else jnp.asarray(h0.reshape(bsz * nh, p, n))
    jy, jh = j_ops.ssd_scan(*(jnp.asarray(v) for v in (xb, dtb, ab, bb, cb)), h0b, chunk=chunk,
                            interpret=True)
    _close(y.permute(0, 2, 1, 3).reshape(bsz * nh, s, p), jy)
    _close(h.reshape(bsz * nh, p, n), jh)
    jy, jh = j_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                               None if h0 is None else jnp.asarray(h0), chunk=chunk)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("impl", ["auto", "dense", "chunked", "kernel"])
def test_plain_engines_run_the_twin_and_never_the_kernel_route(impl, monkeypatch):
    """``ssd_chunked``'s plain engines call ``ref.inter_chunk_bshp`` itself and
    never ``ops.inter_chunk`` (whose CUDA route launches the kernel), so the
    card's oracle stays plain; the kernel engine goes through
    ``ops.inter_chunk``, which on the CPU runs the same twin."""
    calls = {"twin": 0, "ops": 0, "launch": 0}
    twin, routed = ref.inter_chunk_bshp, ops.inter_chunk

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def launch(*args, **kwargs):
        calls["launch"] += 1
        raise AssertionError("the inter-chunk kernel launched")

    monkeypatch.setattr(ref, "inter_chunk_bshp", counted("twin", twin))
    monkeypatch.setattr(ops, "inter_chunk", counted("ops", routed))
    monkeypatch.setattr(ops, "_launch_inter", launch)
    monkeypatch.setattr(kernel, "launch_inter", launch)
    x, dt, a, b, c, h0 = (torch.from_numpy(v) for v in _model_layout(10, 2, 48, 3, 8, 16))
    y, h = ssm.ssd_chunked(x, dt, a, b, c, h0, chunk=16, impl=impl)
    assert calls == {"twin": 1, "ops": int(impl == "kernel"), "launch": 0}, calls
    want = twin(*ref.intra_chunk_bshp(x, dt, a[None].expand(2, 3), b, c, chunk=16), c, h0,
                chunk=16)
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])


def test_inter_chunk_refuses_grad_and_misfit_operands():
    """The wrapper refuses an input that requires grad (the kernel has no
    backward; on any device) and operands that do not fit one another."""
    from repro_torch.kernels.autograd import NoBackwardError

    x, dt, a, b, c, h0 = (torch.from_numpy(v) for v in _model_layout(11, 2, 32, 2, 8, 16))
    parts = ref.intra_chunk_bshp(x, dt, a[None].expand(2, 2), b, c, chunk=8)
    with pytest.raises(NoBackwardError):
        ops.inter_chunk(parts[0].requires_grad_(True), *parts[1:], c, h0, chunk=8)
    parts = [t.detach() for t in parts]
    with pytest.raises(ValueError, match="s_contrib"):
        ops.inter_chunk(*parts, c, h0, chunk=8, final_state=False)
    with pytest.raises(ValueError, match="does not divide"):
        ops.inter_chunk(*parts, c, h0, chunk=7)
    with pytest.raises(ValueError, match="h0"):
        ops.inter_chunk(*parts, c, h0[:, :1], chunk=8)
    with pytest.raises(ValueError, match="cumexp"):
        ops.inter_chunk(parts[0], parts[1], parts[2][:, :, :16], c, h0, chunk=8)


# ------------------------------------------------------------- the mixer --


def _mamba_layer():
    """Reduced mamba2 f32 params of layer 0 (the reference's init)."""
    j_cfg = dataclasses.replace(j_get_config("mamba2-370m", smoke=True), dtype="float32")
    params, _ = JModel(j_cfg).init_params(jax.random.PRNGKey(0))
    j_layer = jax.tree.map(lambda t: t[0], params["layers"][0]["ssm"])
    return j_cfg, j_layer, interop.tree_from_numpy(jax.device_get(j_layer))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_ssd_chunked_with_initial_state_matches_jax(impl):
    bsz, s, nh, p, n = 2, 48, 4, 8, 16
    rng = np.random.default_rng(7)
    x = rng.standard_normal((bsz, s, nh, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bsz, s, nh)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, nh).astype(np.float32)
    b, c = (rng.standard_normal((bsz, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((bsz, nh, p, n)).astype(np.float32)
    jy, jh = j_ssm.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, b, c, h0)), chunk=16)
    ops.reset_counts()
    y, h = ssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, b, c, h0)), chunk=16,
                           impl=impl)
    assert ops.PLAIN_CALLS[ops.KERNEL] == (impl == "kernel")
    np.testing.assert_allclose(y.numpy(), _f32(jy), rtol=MIXER_TOL, atol=MIXER_TOL)
    np.testing.assert_allclose(h.numpy(), _f32(jh), rtol=MIXER_TOL, atol=MIXER_TOL)


def test_ssd_step_matches_jax():
    bsz, nh, p, n = 3, 4, 8, 16
    rng = np.random.default_rng(8)
    arrays = (rng.standard_normal((bsz, nh, p)), rng.uniform(0.01, 0.2, (bsz, nh)),
              -rng.uniform(0.5, 4.0, nh), rng.standard_normal((bsz, n)),
              rng.standard_normal((bsz, n)), rng.standard_normal((bsz, nh, p, n)))
    arrays = [t.astype(np.float32) for t in arrays]
    jy, jh = j_ssm.ssd_step(*(jnp.asarray(t) for t in arrays))
    y, h = ssm.ssd_step(*(torch.from_numpy(t) for t in arrays))
    np.testing.assert_allclose(y.numpy(), _f32(jy), rtol=MIXER_TOL, atol=MIXER_TOL)
    np.testing.assert_allclose(h.numpy(), _f32(jh), rtol=MIXER_TOL, atol=MIXER_TOL)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_ssm_apply_matches_jax_with_and_without_a_cache(impl):
    j_cfg, j_layer, layer = _mamba_layer()
    cfg = dataclasses.replace(interop.model_config_from(j_cfg), attn_impl=impl)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, _ = j_ssm.ssm_apply(j_layer, j_cfg, jnp.asarray(x))
    got, none = ssm.ssm_apply(layer, cfg, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=MIXER_TOL, atol=MIXER_TOL)
    # prefill into a cache, then one decode step through ssd_step
    j_cache = j_ssm.init_ssm_cache(j_cfg, 2, jnp.float32)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32)
    want, j_cache = j_ssm.ssm_apply(j_layer, j_cfg, jnp.asarray(x), j_cache, update_cache=True)
    got, cache = ssm.ssm_apply(layer, cfg, torch.from_numpy(x), cache, update_cache=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=MIXER_TOL, atol=MIXER_TOL)
    for g, w in zip(cache, j_cache):
        np.testing.assert_allclose(g.numpy(), _f32(w), rtol=MIXER_TOL, atol=MIXER_TOL)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, j_cache = j_ssm.ssm_apply(j_layer, j_cfg, jnp.asarray(x1), j_cache, update_cache=True)
    got, cache = ssm.ssm_apply(layer, cfg, torch.from_numpy(x1), cache, update_cache=True)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=MIXER_TOL, atol=MIXER_TOL)
    for g, w in zip(cache, j_cache):
        np.testing.assert_allclose(g.numpy(), _f32(w), rtol=MIXER_TOL, atol=MIXER_TOL)


def test_intra_chunk_refuses_bad_operands():
    x = torch.zeros((1, 8, 2, 4))
    dt, a, b = torch.zeros((1, 8, 2)), torch.zeros((1, 2)), torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="does not divide"):
        ops.intra_chunk(x, dt, a, b, b, chunk=3)
    with pytest.raises(TypeError, match="one dtype"):
        ops.intra_chunk(x, dt, a, b.bfloat16(), b, chunk=4)
    with pytest.raises(ValueError, match="do not fit"):
        ops.intra_chunk(x, dt[:, :4], a, b, b, chunk=4)


@pytest.mark.parametrize("chunk,final", [(64, True), (128, False)])
def test_state_dim_16_twin_over_a_ragged_head_group_matches_the_pallas_kernel(chunk, final):
    """hymba's SSD shape cut down (P 64, N 16, bf16) in the model's layout:
    x, B and C strided views of one projection, 6 heads, so that the tc
    kernel's head groups of 4 (or 2 and 1) leave a ragged group; the port's
    intra-chunk term (the twin on the CPU) against the reference's Pallas
    kernel in interpret mode over the [B*H, ...] layout, B and C broadcast."""
    bsz, s, nh, p, n = 1, 256, 6, 64, 16
    rng = np.random.default_rng(chunk)
    xbc = rng.standard_normal((bsz, s, nh * p + 2 * n)).astype(np.float32)
    xbc = xbc.astype(ml_dtypes.bfloat16)
    dt = rng.uniform(0.001, 0.1, (bsz, s, nh)).astype(np.float32)
    a = -rng.uniform(1.0, 32.0, nh).astype(np.float32)
    txbc = interop.to_torch(xbc)
    x = txbc[..., :nh * p].reshape(bsz, s, nh, p)
    b, c = txbc[..., nh * p:nh * p + n], txbc[..., nh * p + n:]
    assert kernel.route(torch.bfloat16, chunk, p, n) == "tc"
    ops.reset_counts()
    got = ops.intra_chunk(x, torch.from_numpy(dt), torch.from_numpy(a)[None].expand(bsz, nh),
                          b, c, chunk=chunk, final_state=final)
    assert ops.PLAIN_CALLS[ops.KERNEL] == 1 and not any(ops.ROUTES.values())
    xj = np.transpose(xbc[..., :nh * p].reshape(bsz, s, nh, p), (0, 2, 1, 3)).reshape(-1, s, p)
    bj, cj = (np.broadcast_to(t[:, None], (bsz, nh, s, n)).reshape(-1, s, n)
              for t in (xbc[..., nh * p:nh * p + n], xbc[..., nh * p + n:]))
    jy, js, jce = j_kernel.ssd_intra_chunk(
        jnp.asarray(xj), jnp.asarray(np.transpose(dt, (0, 2, 1)).reshape(-1, s)),
        jnp.asarray(np.broadcast_to(a, (bsz, nh)).reshape(-1)), jnp.asarray(bj),
        jnp.asarray(cj), chunk=chunk, interpret=True)
    nc = s // chunk
    want = (np.transpose(np.asarray(jy).reshape(bsz, nh, s, p), (0, 2, 1, 3)),
            np.asarray(js).reshape(bsz, nh, nc, p, n)[:, :, :nc if final else nc - 1],
            np.asarray(jce).reshape(bsz, nh, s))
    for name, g, w in zip(("y_intra", "s_contrib", "cumexp"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=INTRA_TOL, atol=INTRA_TOL, err_msg=name)


@pytest.mark.parametrize("dtype,chunk,p,n,want", [
    (torch.bfloat16, 256, 64, 128, "tc"),  # the mamba2-370m prefill
    (torch.bfloat16, 64, 128, 64, "tc"),
    (torch.bfloat16, 128, 64, 64, "tc"),
    (torch.float32, 256, 64, 128, "simt"),  # f32 stays on the CUDA cores
    (torch.bfloat16, 50, 64, 128, "simt"),  # a chunk the tensor-core tiles do not take
    (torch.bfloat16, 256, 32, 128, "simt"),  # a head dim they do not take
    (torch.bfloat16, 256, 64, 16, "tc"),  # hymba's prefill: state dim 16
    (torch.float32, 256, 64, 16, "simt"),  # ... in f32: the CUDA cores
    (torch.bfloat16, 256, 64, 32, "simt"),  # a state dim the tensor-core tiles do not take
    (torch.bfloat16, 8, 64, 128, "packed"),  # the cascade's 8 tokens
    (torch.float32, 32, 16, 16, "packed"),
    (torch.bfloat16, 4, 64, 128, "packed"),
])
def test_route_picks_the_kernel_by_dtype_and_shape(dtype, chunk, p, n, want):
    """``kernel.route`` names the CUDA kernel a call takes from its dtype
    and shape alone; the CPU path runs the twin whatever the route."""
    assert kernel.route(dtype, chunk, p, n) == want
    rng = np.random.default_rng(chunk + p + n)
    x = torch.from_numpy(rng.standard_normal((1, chunk, 2, p)).astype(np.float32)).to(dtype)
    b, c = (torch.from_numpy(rng.standard_normal((1, chunk, n)).astype(np.float32)).to(dtype)
            for _ in range(2))
    dt = torch.full((1, chunk, 2), 0.05)
    a = -torch.ones((1, 2))
    ops.reset_counts()
    got = ops.intra_chunk(x, dt, a, b, c, chunk=chunk)
    assert ops.PLAIN_CALLS[ops.KERNEL] == 1 and not any(ops.ROUTES.values())
    want_out = ref.intra_chunk_bshp(x, dt, a, b, c, chunk=chunk)
    for g, w in zip(got, want_out):
        assert torch.equal(g, w)
