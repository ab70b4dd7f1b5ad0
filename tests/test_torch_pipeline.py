"""The port's session pipeline, ``grow`` and ``reshard``, held against the
port's lockstep path and the JAX package's pipeline.

Within the port everything is bitwise: the pipeline (events against host
shadows, chunks enqueued without waiting, one wait at ``finish``) equals
lockstep application of the same trace with no extra chunk programs, a
session resharded 2 -> 1 answers the same, and ``grow`` is explicit and
idempotent.  Against the JAX pipeline on one trace the answer digest and
every integer output are equal, spend and invoices within rtol 1e-6 (f32
sums over plan lanes run in XLA's order there, PyTorch's here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineSession as JSession
from repro.core import MultiQueryConfig
from repro.core import Predicate as JPredicate
from repro.core.combine import default_combine_params
from repro.core.decision_table import learn_decision_table
from repro.data.synthetic import make_corpus
from repro.launch import serve as j_serve
from repro_torch import interop
from repro_torch.core.errors import CapacityError, SlotActiveError, SlotsExhaustedError
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate as TPredicate
from repro_torch.core.query import conjunction
from repro_torch.core.session import EngineSession as TSession
from repro_torch.launch import serve as t_serve
from repro_torch.runtime.fault_tolerance import Heartbeat, PreemptionHandler
from test_torch_threads import one_torch_thread  # noqa: F401

P, F = 4, 4
SUM_RTOL = 1e-6  # f32 sums over plan lanes, XLA's order vs PyTorch's
Q0, Q1, Q2 = (conjunction(TPredicate(a, 1), TPredicate(b, 1)) for a, b in ((0, 1), (1, 2), (2, 3)))


@functools.lru_cache(maxsize=None)
def _world():
    preds = [JPredicate(i, 1) for i in range(P)]
    corpus = make_corpus(
        jax.random.PRNGKey(5), 256 + 192, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3] * P, aucs=[0.60, 0.88, 0.93, 0.97], costs=[0.01, 0.05, 0.2, 0.5],
    )
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:256], combine, num_bins=10)
    return preds, corpus, combine, table, np.array(corpus.func_probs[256:])


def _session(capacity=128, max_capacity=512, max_tenants=3, shards=1):
    _, corpus, combine, table, _ = _world()
    return TSession(
        [TPredicate(i, 1) for i in range(P)],
        interop.decision_table_from_numpy(jax.device_get(table)),
        interop.combine_params_from_numpy(jax.device_get(combine)),
        np.array(corpus.costs), capacity=capacity, max_tenants=max_tenants,
        max_capacity=max_capacity, device="cpu",
        config=EngineConfig(plan_size=16, function_selection="best", num_shards=shards),
    )


def _outputs(a, b):
    return torch.from_numpy(_world()[4][a:b])


def _lockstep(sess, chunk_size=2):
    st = sess.init_state(_outputs(0, 96))
    st, s0 = sess.admit(st, Q0)
    st, _ = sess.admit(st, Q1)
    hist = []
    st, h = sess.run(st, 4, chunk_size=chunk_size, stop_when_exhausted=False)
    hist += h
    st = sess.ingest(st, _outputs(96, 160))  # 160 rows: tier 256
    st, h = sess.run(st, 4, chunk_size=chunk_size, stop_when_exhausted=False)
    hist += h
    st, _ = sess.admit(st, Q2)
    st = sess.retire(st, s0)
    st, h = sess.run(st, 4, chunk_size=chunk_size, stop_when_exhausted=False)
    return st, hist + h


def test_pipeline_equals_lockstep_bitwise_with_no_extra_chunk_programs():
    sess_l = _session()
    st_l, h_l = _lockstep(sess_l)
    sess_p = _session()
    pipe = sess_p.pipeline(sess_p.init_state(_outputs(0, 96)), chunk_size=2)
    s0 = pipe.admit(Q0)
    pipe.admit(Q1)
    pipe.run(4)
    pipe.ingest(_outputs(96, 160))
    pipe.run(4)
    pipe.admit(Q2)
    pipe.retire(s0)
    pipe.run(4)
    assert pipe.events_staged == 5 and pipe.epochs_dispatched == 12
    st_p, h_p = pipe.finish()
    assert len(h_l) == len(h_p) == 12
    for a, b in zip(h_l, h_p):
        assert (a.epoch, a.cost_spent, a.merged_valid, a.attributed, a.active, a.num_rows,
                a.expected_f) == (b.epoch, b.cost_spent, b.merged_valid, b.attributed,
                                  b.active, b.num_rows, b.expected_f)
    assert float(st_l.cost_spent).hex() == float(st_p.cost_spent).hex()
    assert torch.equal(st_l.derived.in_answer, st_p.derived.in_answer)
    assert np.array_equal(st_l.ledger.bills(st_l.cost_spent), st_p.ledger.bills(st_p.cost_spent))
    assert sess_p.superstep_traces == sess_l.superstep_traces == 2  # length 2 on two tiers
    assert sess_p.growths == sess_l.growths == 1
    # the host shadows tracked the state exactly
    assert pipe.num_rows == int(st_p.num_rows) == 160
    assert np.array_equal(pipe.active, st_p.active.numpy())
    assert len(pipe.stamps) == 12 and pipe._chunks == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overlap_serve_matches_lockstep_and_the_jax_pipeline(dtype):
    preds, corpus, combine, table, outputs = _world()
    trace = "admit:2;admit:3;run:5;ingest:64;admit:2;run:4;retire:0;run:3"
    events = t_serve.parse_trace(trace)
    reports = {}
    for overlap in (False, True):
        ts = TSession(
            [TPredicate(i, 1) for i in range(P)],
            interop.decision_table_from_numpy(jax.device_get(table)),
            interop.combine_params_from_numpy(jax.device_get(combine)),
            np.array(corpus.costs), capacity=128, max_tenants=4, max_capacity=256,
            device="cpu", config=EngineConfig(plan_size=16, function_selection="best",
                                              substrate_dtype=dtype))
        reports[overlap] = t_serve.serve_session_trace(
            ts, ts.init_state(torch.from_numpy(outputs[:96])), events,
            pool=torch.from_numpy(outputs[96:]), preds=[TPredicate(i, 1) for i in range(P)],
            seed=3, chunk_size=2, overlap=overlap)
    lock, over = reports[False], reports[True]
    assert over.overlap and not lock.overlap
    for key in ("cost_hex", "bills_hex", "answer_digest", "epochs_total", "scan_lengths"):
        assert getattr(over, key) == getattr(lock, key), key
    assert over.superstep_traces == lock.superstep_traces
    js = JSession(
        [p.positive() for p in preds], table, combine, corpus.costs, capacity=128,
        max_tenants=4, max_capacity=256,
        config=MultiQueryConfig(plan_size=16, function_selection="best", substrate_dtype=dtype))
    jrep = j_serve.serve_session_trace(
        js, js.init_state(jnp.asarray(outputs[:96])), j_serve.parse_trace(trace),
        pool=jnp.asarray(outputs[96:]), preds=preds, seed=3, chunk_size=2, overlap=True)
    assert (over.answer_digest, over.epochs, over.num_rows, over.growths, over.scan_lengths) == (
        jrep.answer_digest, jrep.epochs, jrep.num_rows, jrep.growths, jrep.scan_lengths)
    assert [h.merged_valid for h in over.history] == [h.merged_valid for h in jrep.history]
    np.testing.assert_allclose(over.cost_spent, jrep.cost_spent, rtol=SUM_RTOL)
    np.testing.assert_allclose([float.fromhex(h) for h in over.bills_hex],
                               [float.fromhex(h) for h in jrep.bills_hex],
                               rtol=SUM_RTOL, atol=1e-7)


def test_pipeline_shadow_validation_raises_the_lockstep_errors():
    def lockstep_errors():
        sess = _session(capacity=96, max_capacity=96, max_tenants=2)
        st = sess.init_state(_outputs(0, 96))
        st, slot = sess.admit(st, Q0)
        errs = []
        for fn in (lambda: sess.admit(st, Q1, slot=slot),
                   lambda: sess.ingest(st, torch.full((1, P, F), 0.5)),
                   lambda: sess.retire(sess.retire(st, slot), slot),
                   lambda: sess.admit(sess.admit(st, Q1)[0], Q2)):
            with pytest.raises((ValueError, RuntimeError)) as ei:
                fn()
            errs.append((type(ei.value), str(ei.value)))
        return errs

    sess = _session(capacity=96, max_capacity=96, max_tenants=2)
    pipe = sess.pipeline(sess.init_state(_outputs(0, 96)))
    slot = pipe.admit(Q0)
    errs = []
    with pytest.raises(SlotActiveError) as e1:
        pipe.admit(Q1, slot=slot)
    errs.append((type(e1.value), str(e1.value)))
    with pytest.raises(CapacityError, match="overflows capacity") as e2:
        pipe.ingest(torch.full((1, P, F), 0.5))
    errs.append((type(e2.value), str(e2.value)))
    pipe.retire(slot)
    with pytest.raises(ValueError, match="not active") as e3:
        pipe.retire(slot)
    errs.append((type(e3.value), str(e3.value)))
    pipe.admit(Q1)
    pipe.admit(Q2)
    with pytest.raises(SlotsExhaustedError) as e4:
        pipe.admit(Q0)
    errs.append((type(e4.value), str(e4.value)))
    assert errs == lockstep_errors()
    pipe.run(2)  # still coherent after the rejected events
    _, hist = pipe.finish()
    assert len(hist) == 2 and hist[-1].merged_valid > 0 and pipe.num_rows == 96


def test_grow_is_explicit_and_idempotent():
    sess = _session(capacity=64, max_capacity=256, max_tenants=2)
    st = sess.init_state(_outputs(0, 64))
    st, _ = sess.admit(st, Q0)
    assert sess.grow(st, 64) is st  # within the tier: the same object
    grown = sess.grow(st, 65)
    assert grown.capacity == 128 and int(grown.num_rows) == 64 and sess.growths == 1
    assert sess.grow(grown, 100, num_rows=64) is grown  # the tier holds it already
    assert not grown.substrate.exec_mask[64:].any() and not grown.derived.in_answer[:, 64:].any()
    with pytest.raises(CapacityError) as ei:
        sess.grow(grown, 1000)
    assert (ei.value.used, ei.value.capacity, ei.value.requested) == (64, 256, 936)
    # a grown state runs bitwise like one allocated at the larger tier
    pre = _session(capacity=128, max_capacity=256, max_tenants=2)
    pst, _ = pre.admit(pre.init_state(_outputs(0, 64)), Q0)
    a, ha = sess.run(grown, 3, stop_when_exhausted=False)
    b, hb = pre.run(pst, 3, stop_when_exhausted=False)
    assert [h.cost_spent for h in ha] == [h.cost_spent for h in hb]
    assert torch.equal(a.derived.in_answer, b.derived.in_answer)


def test_reshard_two_to_one_gives_the_same_answers():
    two = _session(shards=2)
    one = two.reshard(1)
    assert one.config.num_shards == 1 and two.config.num_shards == 2
    assert (one.capacity, one.max_capacity, one.tier_capacities, one.device) == (
        two.capacity, two.max_capacity, two.tier_capacities, two.device)
    assert torch.equal(one.costs, two.costs) and one.global_predicates == two.global_predicates
    st2, h2 = _lockstep(two)
    st1, h1 = _lockstep(one)
    assert [h.cost_spent for h in h1] == [h.cost_spent for h in h2]
    assert torch.equal(st1.derived.in_answer, st2.derived.in_answer)
    assert np.array_equal(st1.ledger.bills(st1.cost_spent), st2.ledger.bills(st2.cost_spent))


def test_pipeline_preemption_stops_at_a_chunk_boundary():
    sess = _session(capacity=96, max_capacity=96)
    st, _ = sess.admit(sess.init_state(_outputs(0, 96)), Q0)
    handler = PreemptionHandler()
    clock = [0.0]
    hb = Heartbeat(num_workers=1, timeout_s=10.0, clock=lambda: clock[0])
    fired = []
    pipe = sess.pipeline(st, chunk_size=2, preemption=handler, heartbeat=hb,
                         boundary_hook=lambda: fired.append(pipe.epochs_dispatched))
    pipe.run(4)
    assert pipe.epochs_dispatched == 4 and not pipe.preempted and len(fired) == 2
    handler.request()
    pipe.run(6)  # the first boundary poll sees the flag: nothing dispatched
    assert pipe.epochs_dispatched == 4 and pipe.preempted and len(fired) == 2
    _, history = pipe.finish()
    assert [h.epoch for h in history] == [0, 1, 2, 3] and hb.healthy()
