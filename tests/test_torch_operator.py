"""The port's single-query operator half vs the JAX package.

The same numpy inputs go through ``repro`` and ``repro_torch``.  Parity
contract per output:

* integer and mask outputs — ``next_fn``, plans (valid lanes), executed
  triples, answer sets, answer sizes — EXACT;
* ``fused_benefits`` (the reference's Pallas kernel in interpret mode vs
  the port's plain twin on the same state): ``cost`` exact, ``benefit`` and
  ``est_joint`` within 4 ulp (rtol 5e-7): XLA may contract the LUT lerp
  into an FMA, eager PyTorch never does;
* ``compute_benefits`` floats within rtol 1e-5: both recompute binary
  entropy (a log), whose XLA and PyTorch CPU versions differ by an ulp;
* derived probabilities within atol 5e-7 and their entropies within atol
  2e-6: XLA's and PyTorch's CPU log / exp / pow differ by 1-2 ulp inside
  the combine function, an error of a few 1e-6 in a pooled logit of
  magnitude up to ~10, which the sigmoid scales by p(1-p) <= 1/4 and the
  entropy by p(1-p)|H'(p)| <= 0.29;
* spend within rtol 1e-6 (f32 sums accumulate in another order);
* ``benefit_exact_slow`` within atol 2e-5: it takes differences of E(F)
  values, which the port accumulates in f64 and the reference in f32.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as JConfig
from repro.core import ProgressiveQueryOperator as JOperator
from repro.core import StaticOrderEvaluator as JStatic
from repro.core import benefit as j_benefit
from repro.core import blocks as j_blocks
from repro.core import join as j_join
from repro.core import plan as j_plan
from repro.core import query as jq
from repro.core import state as j_state
from repro.core.benefit import TripleBenefits as JTriple
from repro.core.combine import default_combine_params, fit_combine_weights
from repro.core.decision_table import fallback_decision_table, learn_decision_table
from repro.data.synthetic import make_corpus, split_corpus, truth_answer_mask
from repro.enrich.simulated import SimulatedBank as JBank
from repro.enrich.simulated import preprocess_cheapest as j_preprocess
from repro.kernels.enrich_score import ops as j_ops
from repro_torch import interop
from repro_torch.core import benefit as t_benefit
from repro_torch.core import blocks as t_blocks
from repro_torch.core import join as t_join
from repro_torch.core import plan as t_plan
from repro_torch.core import query as tq
from repro_torch.core import state as t_state
from repro_torch.core.benefit import TripleBenefits as TTriple
from repro_torch.core.errors import SubstrateDtypeError
from repro_torch.core.operator import OperatorConfig as TConfig
from repro_torch.core.operator import ProgressiveQueryOperator as TOperator
from repro_torch.core.baselines import StaticOrderEvaluator as TStatic
from repro_torch.enrich.simulated import preprocess_cheapest as t_preprocess
from repro_torch.kernels.enrich_score import ops as t_ops
from test_torch_threads import one_torch_thread  # noqa: F401

ULP4 = 5e-7  # 4 ulp of f32
PROB_ATOL = 5e-7
ENTROPY_ATOL = 2e-6
SUM_RTOL = 1e-6
EXACT_SLOW_ATOL = 2e-5
AUCS = [0.60, 0.88, 0.93, 0.97]
COSTS = [0.023, 0.114, 0.42, 0.949]


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return interop.to_torch(_np(x))


def _queries(p):
    """(jax query, port query) conjunction of p predicates."""
    return (jq.conjunction(*[jq.Predicate(i, 1) for i in range(p)]),
            tq.conjunction(*[tq.Predicate(i, 1) for i in range(p)]))


def _general_queries():
    """A non-conjunctive AST in both packages: (A AND B) OR NOT C."""
    def build(m):
        return m.compile_query(m.Or(m.And(m.Predicate(0, 1), m.Predicate(1, 2)),
                                    m.Not(m.Predicate(2, 1))))
    return build(jq), build(tq)


def _mk_state(seed, n, p, f, jquery, exec_frac=0.5):
    """The reference tests' random state (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    combine = default_combine_params(jnp.full((p, f), 0.8))
    stt = j_state.init_state(n, p, f)
    mask = rng.uniform(size=(n, p, f)) < exec_frac
    probs = rng.uniform(0.02, 0.98, size=(n, p, f)).astype(np.float32)
    stt = dataclasses.replace(stt, exec_mask=jnp.asarray(mask), func_probs=jnp.asarray(probs))
    return j_state.refresh_derived(stt, jquery, combine), combine


def _port_state(jstate):
    return interop.enrichment_state_from_numpy(jax.device_get(jstate))


def _table(table):
    return interop.decision_table_from_numpy(jax.device_get(table))


def _fallback(p, f):
    return (fallback_decision_table(p, f, jnp.linspace(0.6, 0.9, f)),
            np.tile(np.linspace(0.05, 0.9, f), (p, 1)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _learned(p, f):
    corpus = make_corpus(jax.random.PRNGKey(5), 512, list(range(p)), [1] * p,
                         aucs=[0.6, 0.8, 0.9, 0.95][:f])
    table = learn_decision_table(corpus.func_probs, default_combine_params(corpus.aucs))
    return table, np.array(corpus.costs)


def _assert_state_close(ts, js):
    for k in ("func_probs", "exec_mask", "in_answer"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), _np(getattr(js, k)))
    for k, atol in (("pred_prob", PROB_ATOL), ("uncertainty", ENTROPY_ATOL),
                    ("joint_prob", PROB_ATOL)):
        np.testing.assert_allclose(getattr(ts, k).numpy(), _np(getattr(js, k)),
                                   rtol=0, atol=atol, err_msg=k)
    np.testing.assert_allclose(float(ts.cost_spent), float(js.cost_spent), rtol=SUM_RTOL)


# ------------------------------------------------------------------- state --


def test_enrichment_state_half_matches_jax():
    """init_state, refresh_derived, apply_function_outputs, with_cached_state."""
    jquery, tquery = _queries(3)
    n, p, f = 120, 3, 4
    rng = np.random.default_rng(2)
    combine = default_combine_params(jnp.asarray(rng.uniform(0.6, 0.95, (p, f)), jnp.float32))
    tcombine = interop.combine_params_from_numpy(jax.device_get(combine))
    js = j_state.refresh_derived(j_state.init_state(n, p, f), jquery, combine)
    ts = t_state.refresh_derived(t_state.init_state(n, p, f), tquery, tcombine)
    _assert_state_close(ts, js)
    assert ts.state_id().dtype == torch.int32

    cached_p = rng.uniform(0.02, 0.98, (n, p, f)).astype(np.float32)
    cached_m = rng.uniform(size=(n, p, f)) < 0.3
    js = j_state.with_cached_state(js, jquery, combine, jnp.asarray(cached_p),
                                   jnp.asarray(cached_m))
    ts = t_state.with_cached_state(ts, tquery, tcombine, torch.from_numpy(cached_p),
                                   torch.from_numpy(cached_m))
    _assert_state_close(ts, js)

    k = 40  # a batch of triples, some already executed (charged once), some invalid
    obj = rng.integers(0, n, k).astype(np.int32)
    prd = rng.integers(0, p, k).astype(np.int32)
    fn = rng.integers(0, f, k).astype(np.int32)
    keys = (obj.astype(np.int64) * p + prd) * f + fn
    _, first = np.unique(keys, return_index=True)
    valid = np.zeros(k, bool)
    valid[first] = True
    valid[::7] = False
    probs = rng.uniform(0.02, 0.98, k).astype(np.float32)
    cost = rng.uniform(0.01, 1.0, k).astype(np.float32)
    js = j_state.apply_function_outputs(js, jquery, combine, *(jnp.asarray(x) for x in
                                        (obj, prd, fn, probs, cost, valid)))
    ts = t_state.apply_function_outputs(ts, tquery, tcombine, *(torch.from_numpy(x) for x in
                                        (obj, prd, fn, probs, cost, valid)))
    _assert_state_close(ts, js)
    sub = ts.substrate
    assert torch.equal(ts.with_substrate(sub).func_probs, ts.func_probs)

    with pytest.raises(SubstrateDtypeError) as ei:
        t_state.with_cached_state(ts, tquery, tcombine, torch.from_numpy(cached_p).bfloat16(),
                                  torch.from_numpy(cached_m))
    assert ei.value.where == "with_cached_state"


def test_enrichment_state_round_trips_through_interop():
    jquery, _ = _queries(2)
    js, _ = _mk_state(4, 64, 2, 4, jquery)
    ts = _port_state(js)
    back = interop.enrichment_state_from_numpy(interop.enrichment_state_to_numpy(ts))
    for k in ("func_probs", "exec_mask", "pred_prob", "joint_prob", "in_answer", "cost_spent"):
        a, b = getattr(ts, k), getattr(back, k)
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------- benefits --


def _assert_benefits_close(tb, jb, rtol, exact_cost=False):
    """``exact_cost``: both sides gather the same f32 cost-table entry."""
    np.testing.assert_array_equal(tb.next_fn.numpy(), _np(jb.next_fn))
    fin = np.isfinite(_np(jb.benefit))
    np.testing.assert_array_equal(np.isfinite(tb.benefit.numpy()), fin)
    np.testing.assert_allclose(tb.benefit.numpy()[fin], _np(jb.benefit)[fin], rtol=rtol, atol=0)
    np.testing.assert_allclose(tb.est_joint.numpy(), _np(jb.est_joint), rtol=rtol, atol=1e-7)
    if exact_cost:
        np.testing.assert_array_equal(tb.cost.numpy(), _np(jb.cost))
    else:
        np.testing.assert_allclose(tb.cost.numpy(), _np(jb.cost), rtol=rtol, atol=0)
    return fin


@pytest.mark.parametrize("mode", ["table", "best"])
@pytest.mark.parametrize("shape", ["conjunctive", "general"])
@pytest.mark.parametrize("with_load", [False, True])
def test_compute_benefits_matches_jax(mode, shape, with_load):
    if shape == "conjunctive":
        jquery, tquery = _queries(3)
    else:
        jquery, tquery = _general_queries()
    n, p, f = 120, 3, 4
    js, _ = _mk_state(6, n, p, f, jquery)
    ts = _port_state(js)
    table, costs = _learned(p, f)
    cand = np.random.default_rng(3).uniform(size=n) < 0.7
    load = None
    if with_load:
        jbs = j_blocks.make_block_state(n, 4, 2, 0.8)
        load = (j_blocks.per_object_load_cost(jbs, n),
                t_blocks.per_object_load_cost(t_blocks.make_block_state(n, 4, 2, 0.8), n))
        np.testing.assert_array_equal(load[1].numpy(), _np(load[0]))
    jb = j_benefit.compute_benefits(js, jquery, table, jnp.asarray(costs), jnp.asarray(cand),
                                    load_cost=None if load is None else load[0],
                                    function_selection=mode)
    tb = t_benefit.compute_benefits(ts, tquery, _table(table), torch.from_numpy(costs),
                                    torch.from_numpy(cand),
                                    load_cost=None if load is None else load[1],
                                    function_selection=mode)
    assert _assert_benefits_close(tb, jb, rtol=1e-5).any()


def test_benefit_exact_slow_matches_jax():
    """Small N, untied joints; the plans it induces are equal."""
    jquery, tquery = _queries(2)
    n, p, f = 64, 2, 4
    js, _ = _mk_state(8, n, p, f, jquery)
    assert len(np.unique(_np(js.joint_prob))) == n  # untied
    ts = _port_state(js)
    table, costs = _learned(p, f)
    jb = j_benefit.benefit_exact_slow(js, jquery, table, jnp.asarray(costs), 1.0)
    tb = t_benefit.benefit_exact_slow(ts, tquery, _table(table), torch.from_numpy(costs), 1.0,
                                      chunk_elements=7 * n)  # several object chunks
    np.testing.assert_array_equal(tb.next_fn.numpy(), _np(jb.next_fn))
    fin = np.isfinite(_np(jb.benefit))
    np.testing.assert_array_equal(np.isfinite(tb.benefit.numpy()), fin)
    np.testing.assert_allclose(tb.benefit.numpy()[fin], _np(jb.benefit)[fin],
                               rtol=0, atol=EXACT_SLOW_ATOL)
    jp = j_plan.select_plan(jb, 16)
    tp = t_plan.select_plan(tb, 16)
    for a, b in zip(tp[:3], jp[:3]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_array_equal(tp.valid.numpy(), _np(jp.valid))


# ------------------------------------------------ the single-query kernel --


def _fused_both(js, jquery, tquery, table, costs, cand):
    jb = j_ops.fused_benefits(js, jquery, table, jnp.asarray(costs),
                              candidate_mask=None if cand is None else jnp.asarray(cand),
                              interpret=True)
    tb = t_ops.fused_benefits(_port_state(js), tquery, _table(table), torch.from_numpy(costs),
                              candidate_mask=None if cand is None else torch.from_numpy(cand))
    return jb, tb


@pytest.mark.parametrize("n,p,f", [(64, 2, 4), (200, 3, 4), (33, 1, 3)])
def test_fused_benefits_twin_matches_jax_kernel(n, p, f):
    jquery, tquery = _queries(p)
    js, _ = _mk_state(0, n, p, f, jquery)
    table, costs = _fallback(p, f)
    cand = np.random.default_rng(1).uniform(size=n) < 0.7
    before = t_ops.PLAIN_CALLS["enrich_score_single"]
    jb, tb = _fused_both(js, jquery, tquery, table, costs, cand)
    assert t_ops.PLAIN_CALLS["enrich_score_single"] == before + 1
    fin = _assert_benefits_close(tb, jb, rtol=ULP4, exact_cost=True)
    assert fin.any() and not fin[~cand].any()
    assert tb.next_fn.dtype == torch.int32


def test_fused_benefits_twin_learned_table_and_default_candidates():
    jquery, tquery = _queries(2)
    js, _ = _mk_state(2, 64, 2, 4, jquery)
    js = dataclasses.replace(
        js, in_answer=jnp.asarray(np.random.default_rng(9).uniform(size=64) < 0.4))
    table, costs = _learned(2, 4)
    jb, tb = _fused_both(js, jquery, tquery, table, costs, None)  # None: ~in_answer
    assert _assert_benefits_close(tb, jb, rtol=ULP4, exact_cost=True).any()


def test_fused_benefits_twin_edge_bins():
    """h ~ 0 (saturated), h ~ 1 (coin flips) and exhausted rows."""
    jquery, tquery = _queries(2)
    n, p, f = 64, 2, 4
    js, _ = _mk_state(3, n, p, f, jquery)
    rng = np.random.default_rng(4)
    pp = _np(js.pred_prob).copy()
    pp[: n // 3] = rng.uniform(1e-6, 1e-4, size=(n // 3, p))
    pp[n // 3: 2 * n // 3] = 0.5 + rng.uniform(-1e-5, 1e-5, size=(n // 3, p))
    with np.errstate(divide="ignore", invalid="ignore"):
        p64 = pp.astype(np.float64)
        unc = np.nan_to_num(-(p64 * np.log2(p64) + (1 - p64) * np.log2(1 - p64)))
    mask = _np(js.exec_mask).copy()
    mask[2 * n // 3:] = True
    js = dataclasses.replace(js, pred_prob=jnp.asarray(pp), uncertainty=jnp.asarray(
        unc.astype(np.float32)), exec_mask=jnp.asarray(mask))
    table, costs = _fallback(p, f)
    jb, tb = _fused_both(js, jquery, tquery, table, costs, np.ones(n, bool))
    _assert_benefits_close(tb, jb, rtol=ULP4, exact_cost=True)
    assert (tb.next_fn[2 * n // 3:] == -1).all() and torch.isneginf(tb.benefit[2 * n // 3:]).all()


def test_fused_benefits_refuses_general_queries():
    jquery, tquery = _general_queries()
    js, _ = _mk_state(1, 120, 3, 4, jquery)
    table, costs = _fallback(3, 4)
    with pytest.raises(ValueError, match="conjunctive"):
        t_ops.fused_benefits(_port_state(js), tquery, _table(table), torch.from_numpy(costs))


# --------------------------------------------------------------- operator --


@functools.lru_cache(maxsize=None)
def _world():
    """``tests/test_core_operator.py``'s fixture: 512 train + 512 served."""
    jquery = jq.conjunction(jq.Predicate(0, 1), jq.Predicate(1, 2))
    corpus = make_corpus(jax.random.PRNGKey(0), 512 + 512, [0, 1], [1, 2],
                         selectivity=[0.3, 0.4], aucs=AUCS, costs=COSTS)
    train, evalc = split_corpus(corpus, 512)
    combine = fit_combine_weights(train.func_probs, train.truth_pred.astype(jnp.float32),
                                  steps=120)
    table = learn_decision_table(train.func_probs, combine, num_bins=10)
    return dict(jquery=jquery, tquery=tq.conjunction(tq.Predicate(0, 1), tq.Predicate(1, 2)),
                combine=combine, table=table, evalc=evalc,
                truth=truth_answer_mask(evalc, jquery), n=512)


def _operators(cfg: dict, fused: bool, general: bool = False):
    w = _world()
    ev = w["evalc"]
    jquery, tquery = (w["jquery"], w["tquery"])
    if general:
        jquery = jq.compile_query(jq.Or(jq.Predicate(0, 1), jq.Predicate(1, 2)))
        tquery = tq.compile_query(tq.Or(tq.Predicate(0, 1), tq.Predicate(1, 2)))
    jop = JOperator(jquery, w["table"], w["combine"], ev.costs, JBank(ev.func_probs, ev.costs),
                    JConfig(**cfg), truth_mask=w["truth"],
                    benefit_fn=j_ops.fused_benefits if fused else None)
    tbank = interop.simulated_bank_from_numpy(jax.device_get(JBank(ev.func_probs, ev.costs)))
    top = TOperator(tquery, _table(w["table"]),
                    interop.combine_params_from_numpy(jax.device_get(w["combine"])),
                    tbank.costs, tbank, TConfig(**cfg), truth_mask=_t(w["truth"]),
                    benefit_fn=t_ops.fused_benefits if fused else None, device="cpu")
    return jop, top


def _warm(jop, top, n):
    ev = _world()["evalc"]
    jp, jm, _ = j_preprocess(ev.func_probs, ev.costs)
    tp, tm, cheapest = t_preprocess(_t(ev.func_probs), _t(ev.costs))
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    assert cheapest.tolist() == [0, 0]
    js = jop.warm_start(jop.init_state(n), jp, jm)
    ts = top.warm_start(top.init_state(n), tp, tm)
    _assert_state_close(ts, js)
    return js, ts


@pytest.mark.parametrize("route,cfg", [
    ("kernel", dict(plan_size=32)),
    ("general", dict(plan_size=32, function_selection="best", candidate_strategy="outside_answer")),
    ("exact_slow", dict(plan_size=24, benefit_mode="exact_slow")),
])
def test_operator_legacy_routes_match_jax_epoch_by_epoch(route, cfg):
    """The per-epoch loop: the kernel route (benefit_fn=fused_benefits), a
    general AST scored in best mode, and exact_slow — plans, answer sets and
    the executed triples equal on every epoch."""
    jop, top = _operators(cfg, fused=route == "kernel", general=route == "general")
    assert top._legacy_only
    n = 64 if cfg.get("benefit_mode") == "exact_slow" else _world()["n"]
    js, ts = jop.init_state(n), top.init_state(n)
    if n == _world()["n"]:
        js, ts = _warm(jop, top, n)
    epochs = 4 if n == 64 else 12
    for e in range(epochs):
        js, jsel, jpl, _ = jop.run_epoch(js)
        ts, tsel, tpl, _ = top.run_epoch(ts)
        np.testing.assert_array_equal(tpl.valid.numpy(), _np(jpl.valid), err_msg=f"epoch {e}")
        v = tpl.valid.numpy()
        for a, b in zip(tpl[:3], jpl[:3]):
            np.testing.assert_array_equal(a.numpy()[v], _np(b)[v], err_msg=f"epoch {e}")
        np.testing.assert_array_equal(tsel.mask.numpy(), _np(jsel.mask), err_msg=f"epoch {e}")
        np.testing.assert_allclose(float(ts.cost_spent), float(js.cost_spent), rtol=SUM_RTOL)
        np.testing.assert_allclose(float(tsel.expected_f), float(jsel.expected_f), rtol=1e-5)
    _assert_state_close(ts, js)


@pytest.mark.parametrize("mode", ["table", "best"])
def test_operator_session_facade_matches_jax(mode):
    """Default scoring runs through the one-slot session facade: answer sets,
    executed triples and stats equal epoch by epoch, and a run split into
    single epochs equals one run."""
    cfg = dict(plan_size=32, function_selection=mode)
    jop, top = _operators(cfg, fused=False)
    assert not top._legacy_only
    n = _world()["n"]
    js, ts = _warm(jop, top, n)
    ts0 = ts
    for e in range(8):
        js, (jh,) = jop.run(n, 1, state=js, stop_when_exhausted=False)
        ts, (th,) = top.run(n, 1, state=ts, stop_when_exhausted=False)
        np.testing.assert_array_equal(ts.exec_mask.numpy(), _np(js.exec_mask), err_msg=f"{e}")
        np.testing.assert_array_equal(ts.in_answer.numpy(), _np(js.in_answer), err_msg=f"{e}")
        assert (th.answer_size, th.plan_valid) == (jh.answer_size, jh.plan_valid)
        np.testing.assert_allclose(th.cost_spent, jh.cost_spent, rtol=SUM_RTOL)
        np.testing.assert_allclose(th.true_f1, jh.true_f1, rtol=1e-6)
    whole, hist = top.run(n, 8, state=ts0, stop_when_exhausted=False)
    assert len(hist) == 8 and torch.equal(whole.in_answer, ts.in_answer)
    assert torch.equal(whole.exec_mask, ts.exec_mask)


def test_operator_kernel_route_and_facade_match_jax_full_runs():
    """``run`` from a cold start, both routes, to the end of the history."""
    for fused in (True, False):
        jop, top = _operators(dict(plan_size=64), fused=fused)
        n = _world()["n"]
        js, jh = jop.run(n, 10)
        ts, th = top.run(n, 10)
        assert [h.answer_size for h in th] == [h.answer_size for h in jh]
        assert [h.plan_valid for h in th] == [h.plan_valid for h in jh]
        np.testing.assert_allclose([h.cost_spent for h in th], [h.cost_spent for h in jh],
                                   rtol=SUM_RTOL)
        np.testing.assert_array_equal(ts.in_answer.numpy(), _np(js.in_answer))


def test_run_driver_kwarg_is_a_deprecated_shim():
    _, top = _operators(dict(plan_size=16), fused=False)
    n = _world()["n"]
    with pytest.warns(DeprecationWarning):
        st_loop, h_loop = top.run(n, 3, driver="loop")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        st_auto, h_auto = top.run(n, 3)
    assert torch.equal(st_loop.in_answer, st_auto.in_answer)
    assert [h.cost_spent for h in h_loop] == pytest.approx([h.cost_spent for h in h_auto],
                                                           rel=SUM_RTOL)
    with pytest.raises(ValueError), pytest.warns(DeprecationWarning):
        top.run(n, 1, driver="bogus")


def test_operator_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = _world()
    tbank = interop.simulated_bank_from_numpy(jax.device_get(JBank(w["evalc"].func_probs,
                                                                   w["evalc"].costs)))
    with pytest.raises(RuntimeError, match="cuda"):
        TOperator(w["tquery"], _table(w["table"]),
                  interop.combine_params_from_numpy(jax.device_get(w["combine"])),
                  tbank.costs, tbank)


# -------------------------------------------------------------- baselines --


@pytest.mark.parametrize("strategy", ["baseline1", "baseline2", "traditional", "incremental"])
def test_static_order_evaluator_matches_jax(strategy):
    w = _world()
    ev = w["evalc"]
    quality = np.tile(np.asarray(AUCS, np.float32), (2, 1))
    jbank = JBank(ev.func_probs, ev.costs)
    tbank = interop.simulated_bank_from_numpy(jax.device_get(jbank))
    tcombine = interop.combine_params_from_numpy(jax.device_get(w["combine"]))
    jev = JStatic(strategy, w["jquery"], w["combine"], ev.costs, quality, jbank,
                  JConfig(plan_size=128), truth_mask=w["truth"])
    tev = TStatic(strategy, w["tquery"], tcombine, tbank.costs, quality, tbank,
                  TConfig(plan_size=128), truth_mask=_t(w["truth"]), device="cpu")
    jp, jm, _ = j_preprocess(ev.func_probs, ev.costs)
    js, jh = jev.run(w["n"], 10, jp, jm)
    ts, th = tev.run(w["n"], 10, tbank.outputs, t_preprocess(tbank.outputs, tbank.costs)[1])
    assert len(th) == len(jh) == 10
    assert [(h.answer_size, h.plan_valid) for h in th] == [(h.answer_size, h.plan_valid)
                                                           for h in jh]
    np.testing.assert_allclose([h.cost_spent for h in th], [h.cost_spent for h in jh],
                               rtol=SUM_RTOL)
    np.testing.assert_allclose([h.true_f1 for h in th], [h.true_f1 for h in jh], rtol=1e-6)
    _assert_state_close(ts, js)


def test_static_plan_from_order_matches_jax():
    rng = np.random.default_rng(0)
    m = 50
    order = rng.permutation(m).astype(np.int32)
    preds = rng.integers(0, 2, m).astype(np.int32)
    fns = rng.integers(-1, 4, m).astype(np.int32)
    costs = rng.uniform(0.01, 1.0, (2, 4)).astype(np.float32)
    for offset in (0, 16, 48):
        jp = j_plan.static_plan_from_order(*(jnp.asarray(x) for x in (order, preds, fns, costs)),
                                           jnp.asarray(offset, jnp.int32), 16)
        tp = t_plan.static_plan_from_order(*(torch.from_numpy(x) for x in
                                             (order, preds, fns, costs)), offset, 16)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), _np(b))


# -------------------------------------------------------- blocks and joins --


def test_blocks_match_jax():
    n, p = 60, 3
    rng = np.random.default_rng(5)
    ben = rng.uniform(0, 2, (n, p)).astype(np.float32)
    ben[rng.uniform(size=(n, p)) < 0.2] = -np.inf
    zeros = np.zeros((n, p), np.float32)
    jb = JTriple(jnp.asarray(ben), jnp.zeros((n, p), jnp.int32), jnp.asarray(zeros),
                 jnp.asarray(zeros))
    tb = TTriple(torch.from_numpy(ben), torch.zeros((n, p), dtype=torch.int32),
                 torch.from_numpy(zeros), torch.from_numpy(zeros))
    jbs = j_blocks.make_block_state(n, 6, 2, 1.5)
    tbs = t_blocks.make_block_state(n, 6, 2, 1.5)
    for a, b in zip(tbs, jbs):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    np.testing.assert_allclose(t_blocks.block_benefits(tbs, tb).numpy(),
                               _np(j_blocks.block_benefits(jbs, jb)), rtol=1e-6)
    for _ in range(3):
        jbs = j_blocks.swap_best_block(jbs, jb)
        tbs = t_blocks.swap_best_block(tbs, tb)
        np.testing.assert_array_equal(tbs.resident.numpy(), _np(jbs.resident))


def test_join_matches_jax():
    rng = np.random.default_rng(6)
    own = rng.uniform(size=40).astype(np.float32)
    partner = rng.uniform(size=24).astype(np.float32)
    np.testing.assert_allclose(
        t_join.join_predicate_probability(torch.from_numpy(own), torch.from_numpy(partner)),
        _np(j_join.join_predicate_probability(jnp.asarray(own), jnp.asarray(partner))),
        rtol=1e-6)
    shard_sums = partner.reshape(4, 6).sum(1)
    np.testing.assert_allclose(
        t_join.join_predicate_probability_sharded(torch.from_numpy(own),
                                                  torch.from_numpy(shard_sums), 24),
        _np(j_join.join_predicate_probability_sharded(jnp.asarray(own),
                                                      jnp.asarray(shard_sums.sum()), 24)),
        rtol=1e-6)
