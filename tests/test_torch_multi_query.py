"""The port's multi-query facade vs the JAX package, and both new serve modes.

Same corpus, combine parameters and decision table in both packages
(carried with ``repro_torch.interop``).  The JAX engine scores through its
Pallas kernels in interpret mode (``backend="pallas"``), which is what the
port's engine runs on the CPU (the kernels' plain twins).  Contract: plans,
merged plans and answer sets EXACT, epoch by epoch; spend within rtol 1e-6
(f32 sums accumulate in another order); E(F) within rtol 1e-5 (the port
accumulates the E(F) curve in f64, the reference in f32); joint
probabilities within atol 5e-7 (XLA's and PyTorch's CPU log / exp differ by
an ulp or two inside the combine function).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MultiQueryConfig as JConfig
from repro.core import MultiQueryEngine as JEngine
from repro.core import build_query_set as j_build
from repro.core import plan as j_plan
from repro.core import query as jq
from repro.core.combine import default_combine_params
from repro.core.decision_table import learn_decision_table
from repro.data.synthetic import make_corpus
from repro.enrich import simulated as j_sim
from repro.enrich.simulated import SimulatedBank as JBank
from repro.launch import serve as j_serve
from repro_torch import interop
from repro_torch.core import plan as t_plan
from repro_torch.core import query as tq
from repro_torch.core.multi_query import MultiQueryConfig as TConfig
from repro_torch.core.multi_query import MultiQueryEngine as TEngine
from repro_torch.core.multi_query import build_query_set as t_build
from repro_torch.core.operator import OperatorConfig as TOpConfig
from repro_torch.core.operator import ProgressiveQueryOperator as TOperator
from repro_torch.enrich import simulated as t_sim
from repro_torch.kernels.enrich_score import ops as t_ops
from repro_torch.launch import serve as t_serve
from test_torch_threads import one_torch_thread  # noqa: F401

P, F, N = 4, 4, 160
SUM_RTOL = 1e-6
PROB_ATOL = 5e-7
CONJ = [(0, 1), (1, 2), (0, 1), (2, 3)]  # tenant 2 duplicates tenant 0


def _np(x):
    return np.asarray(jax.device_get(x))


@functools.lru_cache(maxsize=None)
def _world():
    corpus = make_corpus(jax.random.PRNGKey(0), N + 256, list(range(P)), [1] * P,
                         selectivity=[0.3, 0.4, 0.25, 0.35], aucs=[0.6, 0.88, 0.93, 0.97],
                         costs=[0.01, 0.05, 0.2, 0.5])
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[N:], combine, num_bins=10)
    bank = JBank(outputs=corpus.func_probs[:N], costs=corpus.costs)
    return combine, table, bank


def _query(mod, cols):
    return mod.conjunction(*[mod.Predicate(c, 1) for c in cols])


def _or_query(mod):
    return mod.compile_query(mod.Or(mod.Predicate(0, 1), mod.Predicate(2, 1)))


def _query_set(mod, queries):
    qs = [_or_query(mod) if q == "or" else _query(mod, q) for q in queries]
    build = j_build if mod is jq else t_build
    return build(qs, global_predicates=[mod.Predicate(i, 1) for i in range(P)])


def _truths(queries):
    return np.random.default_rng(0).uniform(size=(len(queries), N)) < 0.3


def _port_engine(queries, truth=False, **cfg):
    combine, table, bank = _world()
    tbank = interop.simulated_bank_from_numpy(jax.device_get(bank))
    return TEngine(_query_set(tq, queries),
                   interop.decision_table_from_numpy(jax.device_get(table)),
                   interop.combine_params_from_numpy(jax.device_get(combine)), tbank.costs,
                   tbank, TConfig(**{"plan_size": 16, **cfg}),
                   truth_masks=torch.from_numpy(_truths(queries)) if truth else None,
                   device="cpu")


def _engines(queries, truth=False, **cfg):
    """(jax engine, port engine) over the same world; ``queries`` is a list of
    column tuples or "or" for the non-conjunctive query.  The JAX engine
    scores conjunctive sets with its Pallas kernels (interpret mode)."""
    combine, table, bank = _world()
    backend = "jnp" if "or" in queries else "pallas"
    je = JEngine(_query_set(jq, queries), table, combine, bank.costs, bank,
                 JConfig(backend=backend, pallas_interpret=True, **{"plan_size": 16, **cfg}),
                 truth_masks=jnp.asarray(_truths(queries)) if truth else None)
    return je, _port_engine(queries, truth, **cfg)


def _assert_states(ts, js):
    np.testing.assert_array_equal(ts.substrate.exec_mask.numpy(), _np(js.substrate.exec_mask))
    np.testing.assert_array_equal(ts.substrate.func_probs.numpy(),
                                  _np(js.substrate.func_probs))
    np.testing.assert_array_equal(ts.per_query.in_answer.numpy(), _np(js.per_query.in_answer))
    np.testing.assert_allclose(ts.per_query.joint_prob.numpy(), _np(js.per_query.joint_prob),
                               rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(float(ts.cost_spent), float(js.cost_spent), rtol=SUM_RTOL)


def _assert_plans(tp, jp, msg):
    np.testing.assert_array_equal(tp.valid.numpy(), _np(jp.valid), err_msg=msg)
    v = tp.valid.numpy()
    for a, b in zip(tp[:3], jp[:3]):
        np.testing.assert_array_equal(a.numpy()[v], _np(b)[v], err_msg=msg)


# --------------------------------------------------------------- query set --


def test_query_set_matches_jax():
    queries = CONJ + ["or"]
    qsets = []
    for mod, build in ((jq, j_build), (tq, t_build)):
        qs = [_or_query(mod) if q == "or" else _query(mod, q) for q in queries]
        qsets.append(build(qs))  # global space: first-seen order
    js, ts = qsets
    np.testing.assert_array_equal(ts.pred_mask.numpy(), _np(js.pred_mask))
    np.testing.assert_array_equal(ts.unique_rows.numpy(), _np(js.unique_rows))
    np.testing.assert_array_equal(ts.unique_index.numpy(), _np(js.unique_index))
    assert (ts.num_queries, ts.num_predicates, ts.num_unique) == (5, 4, 4)
    assert not ts.all_conjunctive and ts.unique_index[2] == ts.unique_index[0]
    pp = np.random.default_rng(1).uniform(size=(5, 30, 4)).astype(np.float32)
    np.testing.assert_allclose(ts.evaluate_batched(torch.from_numpy(pp)).numpy(),
                               _np(js.evaluate_batched(jnp.asarray(pp))), rtol=1e-6)
    conj = t_build([_query(tq, q) for q in CONJ])
    jconj = j_build([_query(jq, q) for q in CONJ])
    assert conj.all_conjunctive
    np.testing.assert_allclose(conj.evaluate_batched(torch.from_numpy(pp[:4])).numpy(),
                               _np(jconj.evaluate_batched(jnp.asarray(pp[:4]))), rtol=1e-6)


def test_admission_errors():
    te = _port_engine([(0, 1)])
    state = te.init_state(N)
    alien = tq.Predicate(17, 1)
    with pytest.raises(ValueError, match="outside the compiled global space"):
        te.admit(state, tq.conjunction(tq.Predicate(0, 1), alien))
    with pytest.raises(ValueError, match="outside the compiled global space"):
        te.query_set.add(tq.conjunction(alien))
    assert te.query_set.num_queries == 1
    with pytest.raises(ValueError, match="truth_mask"):
        te.admit(state, _query(tq, (3,)), truth_mask=torch.zeros(N, dtype=torch.bool))
    tbest = _port_engine([(0,)], function_selection="best")
    with pytest.raises(NotImplementedError):
        tbest.admit(tbest.init_state(N), _or_query(tq))
    with pytest.raises(NotImplementedError):
        _port_engine(["or"], function_selection="best")
    with pytest.raises(ValueError, match="num_shards"):
        _port_engine([(0, 1)], num_shards=0)
    tshard = _port_engine([(0, 1)], num_shards=3)
    with pytest.raises(ValueError, match="divide evenly"):
        tshard.init_state(N)


def test_admit_warm_starts_like_jax_and_dedups_duplicates():
    je, te = _engines([(0, 1), (1, 2)], truth=False)
    js, ts = je.init_state(N), te.init_state(N)
    for _ in range(3):
        js, *_ = je.run_epoch(js)
        ts, *_ = te.run_epoch(ts)
    spent = float(ts.cost_spent)
    js = je.admit(js, _query(jq, (0, 1)))
    ts = te.admit(ts, _query(tq, (0, 1)))
    assert float(ts.cost_spent) == spent  # admission is free
    assert te.query_set.num_unique == 2 and te.query_set.unique_index[2] == 0
    js = je.admit(js, _query(jq, (2, 3)))
    ts = te.admit(ts, _query(tq, (2, 3)))
    _assert_states(ts, js)
    js, jsel, *_ = je.run_epoch(js)
    ts, tsel, *_ = te.run_epoch(ts)
    np.testing.assert_array_equal(tsel.mask.numpy(), _np(jsel.mask))
    assert torch.equal(tsel.mask[2], tsel.mask[0])
    _assert_states(ts, js)


# ------------------------------------------------------------------ engine --


@pytest.mark.parametrize("mode", ["table", "best"])
def test_legacy_epochs_match_jax(mode):
    """``run_epoch`` (the serving API): per-query plans, the merged plan and
    answer sets equal epoch by epoch."""
    je, te = _engines(CONJ, function_selection=mode)
    js, ts = je.init_state(N), te.init_state(N)
    name = t_ops.KERNELS[mode == "best"]
    before = t_ops.PLAIN_CALLS[name]
    for e in range(6):
        js, jsel, jplans, jmerged, _, jprev = je.run_epoch(js)
        ts, tsel, tplans, tmerged, _, tprev = te.run_epoch(ts)
        _assert_plans(tplans, jplans, f"{mode} epoch {e} per-query plans")
        _assert_plans(tmerged, jmerged, f"{mode} epoch {e} merged plan")
        np.testing.assert_array_equal(tsel.mask.numpy(), _np(jsel.mask))
        np.testing.assert_allclose(tsel.expected_f.numpy(), _np(jsel.expected_f), rtol=1e-5)
        np.testing.assert_allclose(tprev, jprev, rtol=SUM_RTOL)
    _assert_states(ts, js)
    assert t_ops.PLAIN_CALLS[name] == before + 6


@pytest.mark.parametrize("mode", ["table", "best"])
def test_session_facade_matches_jax(mode):
    """``run`` on an all-conjunctive set goes through the session facade;
    the history and final state equal the reference's."""
    je, te = _engines(CONJ, truth=True, function_selection=mode)
    js, jh = je.run(N, 8)
    ts, th = te.run(N, 8)
    assert te._session is not None and te._session[1].max_tenants == 4
    assert len(th) == len(jh) == 8
    for a, b in zip(th, jh):
        assert (a.answer_size, a.plan_valid, a.merged_valid) == (b.answer_size, b.plan_valid,
                                                                 b.merged_valid)
        np.testing.assert_allclose(a.cost_spent, b.cost_spent, rtol=SUM_RTOL)
        np.testing.assert_allclose(a.requested_cost, b.requested_cost, rtol=SUM_RTOL)
        np.testing.assert_allclose(a.true_f, b.true_f, rtol=1e-6)
    _assert_states(ts, js)
    # the facade and the legacy loop serve the same epochs
    tl, hl = te._run_legacy_loop(te.init_state(N), 8, True)
    assert torch.equal(tl.per_query.in_answer, ts.per_query.in_answer)
    assert [h.answer_size for h in hl] == [h.answer_size for h in th]


def test_non_conjunctive_query_set_matches_jax():
    je, te = _engines(["or", (1, 3)])
    assert not te.query_set.all_conjunctive
    js, jh = je.run(N, 5)
    ts, th = te.run(N, 5)
    assert [h.answer_size for h in th] == [h.answer_size for h in jh]
    assert [h.plan_valid for h in th] == [h.plan_valid for h in jh]
    _assert_states(ts, js)
    pp = ts.per_query.pred_prob[0]
    expect = pp[:, 0] + pp[:, 2] - pp[:, 0] * pp[:, 2]
    np.testing.assert_allclose(ts.per_query.joint_prob[0].numpy(), expect.numpy(), rtol=1e-5)


def test_state_round_trips_through_interop():
    te = _port_engine(CONJ[:2])
    ts, _ = te.run(N, 2)
    back = interop.multi_query_state_from_numpy(interop.multi_query_state_to_numpy(ts))
    assert torch.equal(back.substrate.exec_mask, ts.substrate.exec_mask)
    assert torch.equal(back.per_query.joint_prob, ts.per_query.joint_prob)
    assert back.num_queries == 2


# --------------------------------------------------- plan merges and banks --


def _random_plans(seed, *shape):
    """numpy leaves of random plans (``tests/test_superstep.py``'s)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 40, size=shape).astype(np.int32),
            rng.integers(0, 3, size=shape).astype(np.int32),
            rng.integers(0, 4, size=shape).astype(np.int32),
            rng.uniform(0, 5, size=shape).astype(np.float32),
            rng.uniform(0.1, 1.0, size=shape).astype(np.float32),
            rng.uniform(size=shape) < 0.85)


def _both_plans(leaves):
    return (j_plan.Plan(*(jnp.asarray(x) for x in leaves)),
            t_plan.Plan(*(torch.from_numpy(x).long() if x.dtype == np.int32
                          else torch.from_numpy(x) for x in leaves)))


@pytest.mark.parametrize("budget", [None, 3.0])
def test_plan_merges_match_jax(budget):
    """The hierarchical dedup merge equals the reference's (and the flat
    merge) on every valid lane; the plain sharded top-k merge too."""
    jp, tp = _both_plans(_random_plans(3, 4, 6, 8))  # [S=4, Q=6, K=8]
    jh = j_plan.merge_plans_dedup_sharded(jp, 3, 4, cost_budget=budget, num_objects=40)
    th = t_plan.merge_plans_dedup_sharded(tp, 3, 4, cost_budget=budget, num_objects=40)
    flat = t_plan.merge_plans_dedup(tp, 3, 4, cost_budget=budget, num_objects=40)
    _assert_plans(th, jh, "merge_plans_dedup_sharded")
    _assert_plans(th, flat, "sharded vs flat")
    jp, tp = _both_plans(_random_plans(5, 4, 8))  # [S=4, K=8]
    jm = j_plan.merge_sharded_plans(jp, 12)
    tm = t_plan.merge_sharded_plans(tp, 12)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_simulated_banks_match_jax():
    combine, table, bank = _world()
    tbank = interop.simulated_bank_from_numpy(jax.device_get(bank))
    assert torch.equal(interop.simulated_bank_from_numpy(
        interop.simulated_bank_to_numpy(tbank)).outputs, tbank.outputs)
    jsub, tsub = j_sim.subset_columns(bank, [2, 0]), t_sim.subset_columns(tbank, [2, 0])
    np.testing.assert_array_equal(tsub.outputs.numpy(), _np(jsub.outputs))
    np.testing.assert_array_equal(tsub.costs.numpy(), _np(jsub.costs))
    jpre, tpre = j_sim.preprocess_cheapest(bank.outputs, bank.costs), t_sim.preprocess_cheapest(
        tbank.outputs, tbank.costs)
    for a, b in zip(tpre, jpre):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    jp, tp = _both_plans(_random_plans(7, 24))
    np.testing.assert_array_equal(tbank.execute(tp).numpy(), _np(bank.execute(jp)))
    rng = np.random.default_rng(8)
    shard_of = rng.integers(0, 3, N).astype(np.int32)
    slow = np.asarray([1.0, 3.0, 1.5], np.float32)
    jl = j_sim.LatencyModelBank(outputs=bank.outputs, costs=bank.costs,
                                shard_of_object=jnp.asarray(shard_of),
                                shard_slowdown=jnp.asarray(slow))
    tl = t_sim.LatencyModelBank(outputs=tbank.outputs, costs=tbank.costs,
                                shard_of_object=torch.from_numpy(shard_of),
                                shard_slowdown=torch.from_numpy(slow))
    np.testing.assert_allclose(float(tl.modeled_plan_time(tp)), float(jl.modeled_plan_time(jp)),
                               rtol=1e-6)
    tl0 = t_sim.LatencyModelBank(outputs=tbank.outputs, costs=tbank.costs)
    np.testing.assert_allclose(float(tl0.modeled_plan_time(tp)),
                               float(torch.where(tp.valid, tp.cost, 0.0).sum()), rtol=1e-6)


# ------------------------------------------------------------------- serve --


@pytest.mark.parametrize("queries", [1, 4])
def test_serve_modes_on_cpu(queries, capsys):
    argv = ["--objects", "96", "--preds", "3", "--epochs", "4", "--backbone", "",
            "--device", "cpu", "--queries", str(queries)]
    assert t_serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "epochs on cpu" in out and "true F1" in out


def test_serve_reports():
    op, _, truth, _ = t_serve.build_server(96, 2, None, device="cpu")
    rep = t_serve.serve_query(op, 96, epochs=5)
    assert 1 <= rep.epochs <= 5 and rep.cost_spent > 0 and 0.0 <= rep.expected_f <= 1.0
    assert rep.true_f1 is not None and truth.shape == (96,)
    costs = [h["cost"] for h in rep.history]
    assert all(b >= a for a, b in zip(costs, costs[1:]))
    engine, _, truths, _, queries = t_serve.build_multi_server(96, 3, 4, None, device="cpu")
    rep = t_serve.serve_queries(engine, 96, epochs=5)
    assert rep.num_queries == 4 and len(queries) == 4 and truths.shape == (4, 96)
    assert rep.requested_cost >= rep.cost_spent > 0 and rep.dedup_savings >= 0
    assert len(rep.true_f) == 4 and all(0.0 <= f <= 1.0 for f in rep.expected_f)


def _shared_fields(cls, jcfg):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}


def _assert_history(th, jh, keys_equal, keys_close):
    assert len(th) == len(jh)
    for e, (a, b) in enumerate(zip(th, jh)):
        for k in keys_equal:
            assert a[k] == b[k], f"epoch {e}: {k} {a[k]} != {b[k]}"
        for k, rtol in keys_close:
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-12,
                                       err_msg=f"epoch {e}: {k}")


@functools.lru_cache(maxsize=None)
def _jax_servers():
    """The reference's single- and multi-query servers (probe cascades, no
    backbone): its offline phase trains the levels, learns combine and table."""
    single = j_serve.build_server(num_objects=96, num_preds=2, backbone_arch=None, seed=0)
    multi = j_serve.build_multi_server(num_objects=96, num_preds=3, num_queries=4,
                                       backbone_arch=None, seed=0)
    return single, multi


def _port_parts(jobj):
    return (interop.cascade_bank_from_numpy(jobj.bank.cascades, np.asarray(jobj.bank.features)),
            interop.decision_table_from_numpy(jax.device_get(jobj.table)),
            interop.combine_params_from_numpy(jax.device_get(jobj.combine_params)))


def test_serve_query_matches_jax_server():
    """The reference's single-query server, its bank, table and combine
    weights carried into the port: serve_query's history (spend, E(F),
    answer size) epoch by epoch, and the true F1."""
    (jop, _, jtruth, _), _ = _jax_servers()
    bank, table, combine = _port_parts(jop)
    np.testing.assert_array_equal(bank.costs.numpy(), _np(jop.costs))
    top = TOperator(tq.conjunction(tq.Predicate(0, 1), tq.Predicate(1, 1)), table, combine,
                    bank.costs, bank, TOpConfig(**_shared_fields(TOpConfig, jop.config)),
                    truth_mask=torch.tensor(_np(jtruth)), device="cpu")
    jrep = j_serve.serve_query(jop, 96, epochs=6)
    trep = t_serve.serve_query(top, 96, epochs=6)
    assert trep.epochs == jrep.epochs == 6
    _assert_history(trep.history, jrep.history, ("epoch", "size"),
                    (("cost", SUM_RTOL), ("expected_f", 1e-5)))
    np.testing.assert_allclose(trep.true_f1, jrep.true_f1, rtol=1e-6)


def test_serve_queries_matches_jax_server():
    """The reference's multi-query server (its queries, bank, table and
    combine weights) against the port's engine over the same parts:
    serve_queries' history (spend, requested spend, per-query E(F) and
    answer sizes, merged plan lanes) epoch by epoch.  The reference engine
    scores through its Pallas kernels in interpret mode, the route the
    port's engine takes on the CPU."""
    _, (je, _, jtruths, _, jqueries) = _jax_servers()
    je = JEngine(je.query_set, je.table, je.combine_params, je.costs, je.bank,
                 dataclasses.replace(je.config, backend="pallas", pallas_interpret=True),
                 truth_masks=je.truth_masks)
    bank, table, combine = _port_parts(je)
    queries = [tq.conjunction(*[tq.Predicate(p.tag_type, p.tag) for p in q.predicates])
               for q in jqueries]
    qs = t_build(queries, global_predicates=[tq.Predicate(i, 1) for i in range(3)])
    np.testing.assert_array_equal(qs.pred_mask.numpy(), _np(je.query_set.pred_mask))
    te = TEngine(qs, table, combine, bank.costs, bank,
                 TConfig(**_shared_fields(TConfig, je.config)),
                 truth_masks=torch.tensor(_np(jtruths)), device="cpu")
    jrep = j_serve.serve_queries(je, 96, epochs=6)
    trep = t_serve.serve_queries(te, 96, epochs=6)
    assert trep.epochs == jrep.epochs == 6 and trep.num_queries == jrep.num_queries == 4
    _assert_history(trep.history, jrep.history, ("epoch", "sizes", "merged_valid"),
                    (("cost", SUM_RTOL), ("requested_cost", SUM_RTOL),
                     ("expected_f", 1e-5), ("mean_expected_f", 1e-5)))
    np.testing.assert_allclose(trep.true_f, jrep.true_f, rtol=1e-6)


def test_facades_attach_the_cascade_bank_to_their_session():
    """A bank with no outputs buffer runs inside the facade's superstep."""
    op, _, _, _ = t_serve.build_server(64, 2, None, device="cpu")
    st, hist = op.run(64, 3)
    assert op._session[1].bank is op.bank and len(hist) == 3 and hist[-1].cost_spent > 0
    engine, *_ = t_serve.build_multi_server(64, 3, 3, None, device="cpu")
    st, hist = engine.run(64, 3)
    assert engine._session[1].bank is engine.bank and hist[-1].cost_spent > 0
    assert st.per_query.in_answer.shape == (3, 64)
