"""The port's batched enrich_score scoring vs the JAX reference.

The same numpy inputs go through ``repro.kernels.enrich_score.ops.
fused_benefits_batched`` (Pallas, interpret mode on the CPU) and the port's
``fused_benefits_batched`` (its plain PyTorch version on CPU tensors).

Parity contract per output, against the reference:

* ``next_fn`` and ``cost`` — exact (integer gathers and one ``max``).
* ``benefit`` / ``est_joint`` — within 4 ulp (rtol 5e-7).  Both sides
  apply the same f32 ops in the same order, but XLA may contract the LUT
  lerp ``p_lo*(1-frac) + p_hi*frac`` into an FMA inside the interpreted
  kernel (the reference documents this drift in
  ``repro/kernels/enrich_score/kernel.py``); eager PyTorch never contracts.

On the card the CUDA kernels are held BITWISE against the plain version by
``tests/test_torch_cuda.py`` (skipped without a GPU).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.benefit import compute_benefits_batched as j_compute_batched
from repro.core.combine import default_combine_params
from repro.core.decision_table import fallback_decision_table, learn_decision_table
from repro.data.synthetic import make_corpus
from repro.kernels.enrich_score import ops as j_ops
from repro_torch import interop
from repro_torch.core.benefit import compute_benefits_batched as t_compute_batched
from repro_torch.core.errors import SubstrateDtypeError
from repro_torch.kernels.enrich_score import ops as t_ops
from repro_torch.kernels.enrich_score import ref as t_ref
from _torch_screen_world import SCREEN_KINDS, screen_world
from test_torch_threads import one_torch_thread  # noqa: F401

BENEFIT_RTOL = 5e-7  # 4 ulp of f32: the lerp's possible FMA contraction under XLA


def _binary_entropy(p):
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -(p * np.log2(p) + (1 - p) * np.log2(1 - p))
    return np.nan_to_num(h).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rows(seed, n, p, f, q, edge=False):
    """numpy (pred_prob, uncertainty, state_id, joint) made from a seed."""
    rng = np.random.default_rng(seed)
    pp = rng.uniform(0.02, 0.98, size=(n, p)).astype(np.float32)
    sid = rng.integers(0, 2**f, size=(n, p)).astype(np.int32)
    if edge:  # h ~ 0 (saturated), h ~ 1 (coin flips), exhausted rows
        pp[: n // 3] = rng.uniform(1e-6, 1e-4, size=(n // 3, p))
        pp[n // 3: 2 * n // 3] = 0.5 + rng.uniform(-1e-5, 1e-5, size=(n // 3, p))
        sid[2 * n // 3:] = 2**f - 1
    joint = rng.uniform(0.0 if edge else 0.01, 1.0, size=(q, n)).astype(np.float32)
    out = (pp, _binary_entropy(pp.astype(np.float64)), sid, joint)
    for a in out:
        a.setflags(write=False)
    return out


def _fallback(p, f):
    return (
        fallback_decision_table(p, f, jnp.linspace(0.6, 0.9, f)),
        np.tile(np.linspace(0.05, 0.9, f), (p, 1)).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _learned(p, f):
    corpus = make_corpus(
        jax.random.PRNGKey(11), 256, list(range(p)), [1] * p, aucs=[0.6, 0.8, 0.9, 0.95][:f]
    )
    table = learn_decision_table(corpus.func_probs, default_combine_params(corpus.aucs))
    return table, np.array(corpus.costs)


def _both(rows, table, costs, mode, dtype):
    """-> (jax TripleBenefits as numpy, port TripleBenefits as numpy)."""
    pp, unc, sid, joint = rows
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = j_ops.fused_benefits_batched(
        jnp.asarray(pp).astype(jdt), jnp.asarray(unc).astype(jdt), jnp.asarray(sid),
        jnp.asarray(joint).astype(jdt), table, jnp.asarray(costs),
        function_selection=mode, interpret=True,
    )
    tdt = getattr(torch, dtype)
    t = t_ops.fused_benefits_batched(
        interop.to_torch(pp).to(tdt), interop.to_torch(unc).to(tdt), interop.to_torch(sid),
        interop.to_torch(joint).to(tdt), interop.decision_table_from_numpy(jax.device_get(table)),
        torch.from_numpy(costs), function_selection=mode,
    )
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_parity(jb, tb):
    (jben, jnf, jest, jcost), (tben, tnf, test, tcost) = jb, tb
    np.testing.assert_array_equal(tnf, jnf)
    np.testing.assert_array_equal(tcost, jcost)
    np.testing.assert_array_equal(np.isfinite(tben), np.isfinite(jben))
    fin = np.isfinite(jben)
    np.testing.assert_allclose(tben[fin], jben[fin], rtol=BENEFIT_RTOL, atol=0)
    np.testing.assert_allclose(test, jest, rtol=BENEFIT_RTOL, atol=0)
    return fin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["table", "best"])
@pytest.mark.parametrize("n,p,f,q", [(130, 3, 4, 5), (40, 1, 3, 1)])
def test_fused_benefits_batched_matches_jax(mode, dtype, n, p, f, q):
    table, costs = _fallback(p, f)
    jb, tb = _both(_rows(0, n, p, f, q), table, costs, mode, dtype)
    assert _assert_parity(jb, tb).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["table", "best"])
def test_fused_benefits_batched_edge_bins(mode, dtype):
    """h ~ 0, h ~ 1 and exhausted rows (every function executed)."""
    n, p, f, q = 96, 2, 4, 3
    table, costs = _fallback(p, f)
    jb, tb = _both(_rows(7, n, p, f, q, edge=True), table, costs, mode, dtype)
    _assert_parity(jb, tb)
    assert (tb[1][:, 2 * n // 3:, :] == -1).all()
    assert np.isneginf(tb[0][:, 2 * n // 3:, :]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 8])
@pytest.mark.parametrize("p", [2, 4, 5])
def test_best_mode_matches_jax_over_p_and_f(p, f, dtype):
    """Best mode at the shapes the CUDA kernel's forms split on: P 2 and 4
    (one thread an object, vector rows), P 5 (one thread a lane), F 1 and 8,
    and C = 67, not a multiple of 4."""
    table, costs = _fallback(p, f)
    jb, tb = _both(_rows(p * 10 + f, 67, p, f, 3), table, costs, "best", dtype)
    assert _assert_parity(jb, tb).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["table", "best"])
def test_fused_benefits_batched_learned_table(mode, dtype):
    table, costs = _learned(4, 4)
    jb, tb = _both(_rows(3, 128, 4, 4, 4), table, costs, mode, dtype)
    assert _assert_parity(jb, tb).any()


@pytest.mark.parametrize("mode", ["table", "best"])
def test_compute_benefits_batched_matches_jax(mode):
    """The step-by-step oracle (``core.benefit``) against the reference's.

    next_fn exact; the float leaves recompute binary entropy (log) on both
    sides, whose XLA and PyTorch CPU implementations differ by an ulp or
    two, so benefit / est_joint / cost agree to rtol 1e-5.
    """
    table, costs = _learned(4, 4)
    pp, unc, sid, joint = _rows(3, 128, 4, 4, 4)
    j = j_compute_batched(
        jnp.asarray(pp), jnp.asarray(unc), jnp.asarray(sid), jnp.asarray(joint),
        table, jnp.asarray(costs), function_selection=mode,
    )
    t = t_compute_batched(
        interop.to_torch(pp), interop.to_torch(unc), interop.to_torch(sid),
        interop.to_torch(joint), interop.decision_table_from_numpy(jax.device_get(table)),
        torch.from_numpy(costs), function_selection=mode,
    )
    np.testing.assert_array_equal(t.next_fn.numpy(), np.asarray(j.next_fn))
    fin = np.isfinite(np.asarray(j.benefit))
    np.testing.assert_array_equal(np.isfinite(t.benefit.numpy()), fin)
    for a, b in zip(t[:1] + t[2:], j[:1] + j[2:]):
        np.testing.assert_allclose(a.numpy()[fin], np.asarray(b)[fin], rtol=1e-5, atol=1e-7)


def test_mixed_probability_dtypes_raise():
    pp, unc, sid, joint = (interop.to_torch(x) for x in _rows(1, 16, 2, 4, 2))
    table, costs = _fallback(2, 4)
    ttable = interop.decision_table_from_numpy(jax.device_get(table))
    with pytest.raises(SubstrateDtypeError) as ei:
        t_ops.fused_benefits_batched(
            pp.to(torch.bfloat16), unc, sid, joint, ttable, torch.from_numpy(costs)
        )
    assert ei.value.where == "fused_benefits_batched"
    assert ei.value.expected == "torch.bfloat16"


def test_cpu_tensors_take_the_plain_path_and_count_it():
    pp, unc, sid, joint = (interop.to_torch(x) for x in _rows(2, 32, 2, 4, 2))
    table, costs = _fallback(2, 4)
    ttable = interop.decision_table_from_numpy(jax.device_get(table))
    before = dict(t_ops.PLAIN_CALLS)
    launches = dict(t_ops.LAUNCHES)
    t_ops.fused_benefits_batched(pp, unc, sid, joint, ttable, torch.from_numpy(costs), "best")
    assert t_ops.PLAIN_CALLS["enrich_score_best"] == before["enrich_score_best"] + 1
    assert t_ops.LAUNCHES == launches


# Shapes whose decision tables outgrow a Hopper block's shared memory at the
# default 10 bins (a table has 2^F states), or (best mode) F > 8, or reach
# the mode's measured crossover (``kernel.GLOBAL_FROM``): the CUDA wrappers
# take the "global" table route there; the main paths' shapes (the
# session's P 4 F 4, the cascade's P 3 F 3, the operator's P 2 F 4) stay on
# "smem", as does the last ladder rung below each crossover.
GLOBAL_ROUTE_SHAPES = (
    [("best", p, 8) for p in (3, 4, 5)] + [("best", 7, 7), ("best", 15, 6)]
    + [("best", p, f) for f in (9, 10, 11, 12) for p in (1, 2, 3, 4, 5)]
    + [(mode, p, 8) for mode in ("table", "single") for p in (11, 16)]
    + [("best", 1, 7), ("best", 1, 8), ("best", 2, 8), ("table", 5, 6), ("single", 3, 6)]
)
SMEM_ROUTE_SHAPES = [(mode, p, f) for mode in ("table", "best", "single")
                     for p, f in ((4, 4), (3, 3), (2, 4))] + [
    ("best", 2, 6), ("table", 4, 6), ("single", 4, 5)]


@pytest.mark.parametrize("mode,p,f,route",
                         [(*s, "global") for s in GLOBAL_ROUTE_SHAPES]
                         + [(*s, "smem") for s in SMEM_ROUTE_SHAPES])
def test_table_route_takes_every_table(mode, p, f, route):
    from repro_torch.kernels.enrich_score import kernel

    assert kernel.table_route(mode, p, 2**f, 10, f, 4096) == route
    # the wrappers' one check past the route: the global route's costs and LUT fit
    assert kernel.global_smem_bytes(p, f, 4096) <= kernel.SMEM_LIMIT


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,f", [(3, 8), (2, 9), (4, 10), (4, 12)])
def test_best_mode_matches_jax_on_global_route_tables(p, f, dtype):
    """Best mode where the card takes the "global" route: P 3 F 8 (the
    table outgrows shared memory) and P 2 / 4 at F 9, 10 and 12 (past the
    smem route's F 8), at the default 10 bins, C = 67."""
    table, costs = _fallback(p, f)
    assert table.num_bins == 10
    pp, unc, sid, joint = _rows(p * 10 + f, 67, p, f, 3)
    if f > 9:  # functions 0-7 ran on the first rows: only the later ones remain
        sid = sid.copy()
        sid[:16] |= 0xFF
    jb, tb = _both((pp, unc, sid, joint), table, costs, "best", dtype)
    assert _assert_parity(jb, tb).any()
    assert f == 8 or (tb[1] >= 8).any()  # past F 8, some lanes choose a function >= 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,p,f", [(k, p, f) for k in SCREEN_KINDS + ("random",)
                                      for p in (1, 4, 5) for f in (3, 8, 10)])
def test_best_screen_twin_picks_the_plain_versions_function(kind, p, f, dtype):
    """The lane kernels' division screen, computed in PyTorch
    (``ref.best_screen``: one division per (tenant, lane) where the
    estimates decide, the exact fold elsewhere) on inputs that press on it
    (exact ties, benefits an ulp apart, zero and subnormal joints, pred_prob
    0, every function exhausted): all four outputs bitwise the plain
    version's, and never more divisions than the functions that remain."""
    dev = torch.device("cpu")
    pp, unc, sid, joint, delta, costs = screen_world(dev, kind, p, f, getattr(torch, dtype),
                                                     p * 100 + f * 7 + len(kind))
    lut = t_ops._lut(4096, dev)
    out, divisions = t_ref.best_screen(pp, unc, sid, joint, delta, costs, lut)
    want = t_ref.enrich_score_best_ref(pp, unc, sid, joint, delta, costs, lut)
    for name, a, b in zip(("benefit", "next_fn", "est_joint", "cost"), out, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    pred = torch.arange(p)[None, :]
    rows = delta[pred, sid.long(), t_ref._bins(unc.float(), delta.shape[2])]
    left = torch.isfinite(rows).sum(-1)  # [C, P]: the exact fold's divisions per tenant
    assert divisions <= int(left.sum()) * joint.shape[0]
    if kind in ("random", "pp0"):  # one division per (tenant, lane) with a function left
        assert divisions == int((left > 0).sum()) * joint.shape[0]
