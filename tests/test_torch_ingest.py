"""Streaming ingestion in the port: the pending-row ring and the staged
stream, held against the JAX package's ``repro.ingest``.

Ring semantics under every backpressure policy (wraparound, partial fills,
typed errors, block / shed / spill, the all-or-nothing drain), ring-fed
ingestion bitwise equal to direct ingest over dtype x policy, the stream's
micro-batching (>= 3 batches, so each staging tensor is reused), its
backpressure callback and throttle, and its bf16 quantisation bit-equal to
the reference's ``ml_dtypes`` cast.  The same pushes through both packages'
rings give the same counters and the same bank rows.  Everything here is
exact: there is no float tolerance in this file.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import EngineSession as JSession
from repro.core import IngestBackpressure as JBackpressure
from repro.core import MultiQueryConfig
from repro.core import Predicate as JPredicate
from repro.core import fallback_decision_table
from repro.core.combine import default_combine_params
from repro.data.synthetic import make_corpus
from repro.ingest import IngestStream as JStream
from repro.ingest import PendingRing as JRing
from repro_torch import interop
from repro_torch.core.errors import CapacityError, SubstrateDtypeError
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate as TPredicate
from repro_torch.core.query import conjunction
from repro_torch.core.session import EngineSession as TSession
from repro_torch.ingest import IngestBackpressure, IngestStream, PendingRing
from test_torch_threads import one_torch_thread  # noqa: F401

P, F, N = 4, 4, 96


@functools.lru_cache(maxsize=None)
def _world():
    preds = [JPredicate(i, 1) for i in range(P)]
    corpus = make_corpus(
        jax.random.PRNGKey(0), N, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3, 0.4, 0.25, 0.35],
    )
    combine = default_combine_params(corpus.aucs)
    table = fallback_decision_table(P, F, corpus.aucs)
    return preds, corpus, combine, table


def _session(capacity=N, dtype="float32", max_tenants=2):
    _, corpus, combine, table = _world()
    return TSession(
        [TPredicate(i, 1) for i in range(P)],
        interop.decision_table_from_numpy(jax.device_get(table)),
        interop.combine_params_from_numpy(jax.device_get(combine)),
        np.array(corpus.costs), capacity=capacity, max_tenants=max_tenants, device="cpu",
        config=EngineConfig(plan_size=16, substrate_dtype=dtype),
    )


def _jsession(capacity=N, dtype="float32"):
    preds, corpus, combine, table = _world()
    return JSession(
        [p.positive() for p in preds], table, combine, corpus.costs, capacity=capacity,
        max_tenants=2, config=MultiQueryConfig(plan_size=16, substrate_dtype=dtype),
    )


def _outputs():
    return torch.from_numpy(np.array(_world()[1].func_probs))


def _rows(m, seed=1, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.05, 0.95, (m, P, F)).astype(np.float32)).to(dtype)


# ------------------------------------------------------------- ring basics --


def test_ring_wraparound_and_partial_fill():
    sess = _session()
    state = sess.init_state(_outputs()[:16])
    ring = PendingRing(sess, slot_rows=4, num_slots=2)
    num_rows, fed = 16, []
    for cycle in range(3):  # a 2-slot ring: the head wraps every cycle
        for j in range(2):
            batch = _rows(4, seed=10 * cycle + j)
            assert ring.push(batch)
            fed.append(batch)
        assert ring.occupied == 2 and ring.free_slots == 0 and ring.pending_rows == 8
        state, num_rows, drained = ring.drain_into(sess, state, num_rows)
        assert drained == 8 and ring.occupied == 0
    assert num_rows == 40 and int(state.num_rows) == 40
    assert torch.equal(state.bank_outputs[16:40], torch.cat(fed))
    c = ring.counters
    assert c["pushed_batches"] == c["drained_batches"] == 6
    assert c["pushed_rows"] == c["drained_rows"] == 24
    assert c["blocked"] == c["shed_rows"] == c["spilled_rows"] == 0
    # a trailing partial batch drains only its real rows (stale slot rows never land)
    ring2 = PendingRing(sess, slot_rows=8, num_slots=2)
    assert ring2.push(_rows(8, seed=3))
    state, num_rows, _ = ring2.drain_into(sess, state, num_rows)
    tail = _rows(3, seed=7)
    assert ring2.push(tail) and ring2.pending_rows == 3
    state, num_rows, drained = ring2.drain_into(sess, state, num_rows)
    assert (drained, num_rows) == (3, 51)
    assert torch.equal(state.bank_outputs[48:51], tail)
    assert torch.equal(state.bank_outputs[51:], torch.full((N - 51, P, F), 0.5))


def test_ring_rejects_bad_shapes_dtypes_and_options():
    sess = _session()
    ring = PendingRing(sess, slot_rows=4, num_slots=2)
    with pytest.raises(ValueError, match=r"\[1\.\.4, 4, 4\]"):
        ring.push(_rows(5))
    with pytest.raises(ValueError, match="ring batch"):
        ring.push(torch.zeros(2, P + 1, F))
    with pytest.raises(ValueError, match="ring batch"):
        ring.push(torch.zeros(P, F))
    with pytest.raises(ValueError, match="policy"):
        PendingRing(sess, slot_rows=4, num_slots=2, policy="drop")
    with pytest.raises(ValueError, match="slot_rows"):
        PendingRing(sess, slot_rows=0, num_slots=2)
    bf = PendingRing(_session(dtype="bfloat16"), slot_rows=4, num_slots=2)
    with pytest.raises(SubstrateDtypeError) as ei:
        bf.push(_rows(2))
    assert (ei.value.expected, ei.value.got, ei.value.where) == (
        "torch.bfloat16", "torch.float32", "PendingRing.push")
    assert bf.push(_rows(2, dtype=torch.bfloat16))


def test_block_shed_spill_policies():
    sess = _session()
    ring = PendingRing(sess, slot_rows=4, num_slots=2, policy="block")
    assert ring.push(_rows(4)) and ring.push(_rows(4))
    with pytest.raises(IngestBackpressure) as ei:
        ring.push(_rows(3))
    assert (ei.value.occupied, ei.value.capacity, ei.value.requested, ei.value.policy) == (
        2, 2, 3, "block")
    state = sess.init_state(_outputs()[:8])
    state, _, drained = ring.drain_into(sess, state, 8)
    assert drained == 8 and ring.push(_rows(3)) and ring.counters["blocked"] == 1

    shed = PendingRing(sess, slot_rows=4, num_slots=2, policy="shed")
    assert shed.push(_rows(4, seed=1)) and shed.push(_rows(4, seed=2))
    assert not shed.push(_rows(4, seed=3))
    assert (shed.counters["shed_batches"], shed.counters["shed_rows"]) == (1, 4)
    state = sess.init_state(_outputs()[:8])
    state, _, drained = shed.drain_into(sess, state, 8)
    assert drained == 8
    assert torch.equal(state.bank_outputs[8:16], torch.cat([_rows(4, seed=1), _rows(4, seed=2)]))

    spill = PendingRing(sess, slot_rows=4, num_slots=2, policy="spill")
    batches = [_rows(4, seed=s) for s in range(5)]
    for b in batches:
        assert spill.push(b)
    assert spill.occupied == 2 and spill.spilled_pending == 3
    assert (spill.counters["spilled_batches"], spill.counters["spilled_rows"]) == (3, 12)
    state = sess.init_state(_outputs()[:8])
    state, num_rows, drained = spill.drain_into(sess, state, 8)
    assert (drained, num_rows) == (20, 28) and spill.occupied == spill.spilled_pending == 0
    assert torch.equal(state.bank_outputs[8:28], torch.cat(batches))


@pytest.mark.parametrize("policy", ["block", "shed", "spill"])
def test_ring_counters_and_rows_match_the_reference(policy):
    """Five 4-row batches through a 2-slot ring, draining on backpressure:
    both packages count the same and land the same rows."""
    batches = [_rows(4, seed=s) for s in range(5)]

    def run(ring, push, drain, backpressure):
        landed = []
        for b in batches:
            try:
                ok = push(b)
            except backpressure:
                drain()
                ok = push(b)
            landed.append(ok)
        drain()
        return landed, dict(ring.counters)

    sess = _session()
    t_ring = PendingRing(sess, slot_rows=4, num_slots=2, policy=policy)
    box = {"st": sess.init_state(_outputs()[:8]), "rows": 8}

    def t_drain():
        box["st"], box["rows"], _ = t_ring.drain_into(sess, box["st"], box["rows"])

    t_landed, t_counters = run(t_ring, t_ring.push, t_drain, IngestBackpressure)
    js = _jsession()
    j_ring = JRing(js, slot_rows=4, num_slots=2, policy=policy)
    jbox = {"st": js.init_state(jnp.asarray(_outputs()[:8].numpy())), "rows": 8}

    def j_drain():
        jbox["st"], jbox["rows"], _ = j_ring.drain_into(js, jbox["st"], jbox["rows"])

    j_landed, j_counters = run(j_ring, lambda b: j_ring.push(jnp.asarray(b.numpy())), j_drain,
                               JBackpressure)
    assert t_landed == j_landed and t_counters == j_counters and box["rows"] == jbox["rows"]
    np.testing.assert_array_equal(box["st"].bank_outputs.numpy(),
                                  np.asarray(jbox["st"].bank_outputs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["block", "shed", "spill"])
def test_ring_fed_equals_direct_ingest(dtype, policy):
    """A refresh-free burst + one refresh is bitwise the direct per-batch
    ingest, for every policy x dtype (shed: only the batches that landed)."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def build():
        sess = _session(dtype=dtype)
        st = sess.init_state(_outputs()[:32])
        st, _ = sess.admit(st, conjunction(TPredicate(0, 1), TPredicate(1, 1)))
        return sess, st

    batches = [_rows(8, seed=s, dtype=tdt) for s in range(4)]
    sess_r, st_r = build()
    ring = PendingRing(sess_r, slot_rows=8, num_slots=2, policy=policy)
    num_rows, landed = 32, []
    for b in batches:
        try:
            ok = ring.push(b)
        except IngestBackpressure:
            st_r, num_rows, _ = ring.drain_into(sess_r, st_r, num_rows)
            ok = ring.push(b)
        if ok:
            landed.append(b)
    st_r, num_rows, _ = ring.drain_into(sess_r, st_r, num_rows)
    st_r, hist_r = sess_r.run(st_r, 3, stop_when_exhausted=False)
    sess_d, st_d = build()
    for b in landed:
        st_d = sess_d.ingest(st_d, b)
    st_d, hist_d = sess_d.run(st_d, 3, stop_when_exhausted=False)
    if policy == "shed":
        assert len(landed) == 2
    assert num_rows == 32 + 8 * len(landed)
    assert float(st_r.cost_spent).hex() == float(st_d.cost_spent).hex()
    assert torch.equal(st_r.derived.in_answer, st_d.derived.in_answer)
    assert torch.equal(st_r.bank_outputs, st_d.bank_outputs)
    assert [h.cost_spent for h in hist_r] == [h.cost_spent for h in hist_d]


def test_drain_is_all_or_nothing():
    sess = _session(capacity=32)
    state = sess.init_state(_outputs()[:30])
    ring = PendingRing(sess, slot_rows=4, num_slots=2, policy="spill")
    fed = [_rows(4, seed=40 + s) for s in range(3)]  # 2 slots + 1 spilled
    for b in fed:
        assert ring.push(b)
    before = dict(ring.counters)
    with pytest.raises(CapacityError) as ei:
        ring.drain_into(sess, state, 30)
    assert (ei.value.used, ei.value.capacity, ei.value.requested) == (30, 32, 12)
    assert ring.occupied == 2 and ring.pending_rows == 8 and ring.spilled_pending == 1
    assert ring.counters == before
    state2 = sess.init_state(_outputs()[:16])
    state2, num_rows, drained = ring.drain_into(sess, state2, 16)
    assert (drained, num_rows) == (12, 28)
    assert torch.equal(state2.bank_outputs[16:28], torch.cat(fed))


# -------------------------------------------------------------- the stream --


def test_stream_feeds_micro_batches_reusing_both_staging_tensors():
    """Five micro-batches through two staging tensors, then a second feed:
    every row lands in arrival order (the reuse gate of each tensor is an
    event after the write that consumed it; on the CPU the ring copies at
    once)."""
    sess = _session()
    state = sess.init_state(_outputs()[:8])
    ring = PendingRing(sess, slot_rows=4, num_slots=8)
    stream = IngestStream(ring, batch_rows=4)
    first = _rows(19, seed=9)  # 4 + 4 + 4 + 4 + 3
    assert stream.feed(first.numpy()) == 19
    assert stream.batches_fed == 5 and stream.rows_fed == 19 and ring.pending_rows == 19
    second = _rows(8, seed=10)
    assert stream.feed(second) == 8
    state, num_rows, drained = ring.drain_into(sess, state, 8)
    assert (drained, num_rows) == (27, 35)
    assert torch.equal(state.bank_outputs[8:35], torch.cat([first, second]))
    assert stream.bytes_staged == 27 * P * F * 4


def test_stream_backpressure_callback_and_without_one():
    sess = _session()
    box = {"state": sess.init_state(_outputs()[:16]), "rows": 16}
    ring = PendingRing(sess, slot_rows=8, num_slots=2, policy="block")

    def on_pressure():
        box["state"], box["rows"], _ = ring.drain_into(sess, box["state"], box["rows"])

    stream = IngestStream(ring, batch_rows=8, on_pressure=on_pressure)
    wave = _rows(40, seed=4)  # 5 micro-batches through 2 slots
    assert stream.feed(wave) == 40 and ring.counters["blocked"] >= 1
    on_pressure()
    assert box["rows"] == 56 and torch.equal(box["state"].bank_outputs[16:56], wave)
    tight = PendingRing(sess, slot_rows=4, num_slots=1, policy="block")
    with pytest.raises(IngestBackpressure):
        IngestStream(tight, batch_rows=4).feed(_rows(8, seed=5))


def test_stream_throttle_counts_waits():
    ring = PendingRing(_session(), slot_rows=4, num_slots=4)
    stream = IngestStream(ring, batch_rows=4, rate_rows_per_s=100.0)  # 40 ms a batch
    stream.feed(_rows(12, seed=6))
    assert stream.throttle_waits >= 1
    assert stream.counters()["throttle_waits"] == stream.throttle_waits
    with pytest.raises(ValueError, match="rate_rows_per_s"):
        IngestStream(ring, rate_rows_per_s=0.0)
    with pytest.raises(ValueError, match="batch_rows"):
        IngestStream(ring, batch_rows=9)


def test_stream_quantizes_bf16_like_the_references_cast():
    """f32 arrivals quantize in the staging tensor of a bf16 session, bit for
    bit as ``ml_dtypes`` (the reference's numpy cast), ties and subnormals
    included; the reference's own stream lands the same bits."""
    rng = np.random.default_rng(0)
    wave = rng.uniform(0, 1, (8, P, F)).astype(np.float32)
    # exact ties between two bf16 values round to even; plus tiny and huge values
    wave.reshape(-1)[:6] = np.array([1 + 2**-8, 1 + 3 * 2**-8, 2**-130, 1e-39, 3e38, 0.5],
                                    np.float32)
    sess = _session(dtype="bfloat16")
    state = sess.init_state(_outputs()[:8])
    ring = PendingRing(sess, slot_rows=4, num_slots=2)
    assert IngestStream(ring, batch_rows=4).feed(wave) == 8
    state, _, _ = ring.drain_into(sess, state, 8)
    got = interop.to_numpy(state.bank_outputs[8:16])
    want = wave.astype(ml_dtypes.bfloat16)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    js = _jsession(dtype="bfloat16")
    jst = js.init_state(jnp.asarray(_outputs()[:8].numpy()))
    j_ring = JRing(js, slot_rows=4, num_slots=2)
    assert JStream(j_ring, batch_rows=4).feed(wave) == 8
    jst, _, _ = j_ring.drain_into(js, jst, 8)
    assert np.asarray(jst.bank_outputs[8:16]).tobytes() == want.tobytes()
