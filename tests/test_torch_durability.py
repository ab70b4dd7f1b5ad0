"""Durability of the port: the checkpoint store and session checkpoints,
held against the JAX package.

The on-disk format is shared, so the bars are cross-package: the store's
leaf zoo round-trips bitwise whichever package wrote it, the leaf keys are
the reference's strings, the strictness errors read the same, and a
session checkpoint crosses packages bitwise both ways (every leaf), and a
run resumed from it in the other package ends with the uninterrupted run's
``answer_digest`` (f32 and bf16).  Spend and invoices across packages are
held within rtol 1e-6: each epoch's charged cost is an f32 sum over the
merged plan, which XLA and PyTorch accumulate in different orders (on this
trace the first epoch's 16 lanes of cost 0.01 already differ by one ulp).
Within the port every digest is bitwise: format 2 restores into an f32
session, restore onto a larger tier keeps growing, and a preempted serve
run resumes to the uninterrupted run's ``cost_hex``, ``bills_hex`` and
``answer_digest`` (lockstep and overlap).
"""

import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.core import EngineSession as JSession
from repro.core import MultiQueryConfig
from repro.core import Predicate as JPredicate
from repro.core import restore_session_checkpoint as j_restore
from repro.core import SessionCheckpointer as JCheckpointer
from repro.core.combine import default_combine_params
from repro.core.decision_table import learn_decision_table
from repro.data.synthetic import make_corpus
from repro.launch import serve as j_serve
from repro.runtime.fault_tolerance import PreemptionHandler as JPreemption
from repro_torch import interop
from repro_torch.checkpoint import store as t_store
from repro_torch.checkpoint.store import LeafSpec
from repro_torch.core.durability import (
    CHECKPOINT_FORMAT,
    SessionCheckpointer,
    restore_session_checkpoint,
    save_session_checkpoint,
    session_state_spec,
)
from repro_torch.core.errors import CapacityError
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate as TPredicate
from repro_torch.core.query import conjunction as t_conjunction
from repro_torch.core.session import EngineSession as TSession
from repro_torch.launch import serve as t_serve
from repro_torch.runtime.fault_tolerance import PreemptionHandler
from test_torch_threads import one_torch_thread  # noqa: F401

P, F, SLOTS = 4, 4, 4
TRACE = "admit:2;admit:3;run:4;ingest:64;admit:2;run:4;retire:0;run:4"
LEAF_KEYS = [
    ".substrate/.func_probs", ".substrate/.exec_mask", ".substrate/.cost_spent",
    ".derived/.pred_prob", ".derived/.uncertainty", ".derived/.joint_prob",
    ".derived/.in_answer", ".bank_outputs", ".pred_mask", ".active", ".num_rows",
    ".ledger/.attributed", ".ledger/.triples", ".ledger/.wanted", ".ledger/.unattributed",
    ".ledger/.archived", ".quarantined",
]
DIGESTS = ("cost_hex", "bills_hex", "answer_digest", "epochs_total")
SUM_RTOL = 1e-6  # f32 sums over plan lanes, XLA's order vs PyTorch's


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


def _jsession(dtype="float32", capacity=128, max_capacity=256):
    preds, corpus, combine, table, _ = _world()
    return JSession(
        [p.positive() for p in preds], table, combine, corpus.costs, capacity=capacity,
        max_tenants=SLOTS, max_capacity=max_capacity,
        config=MultiQueryConfig(plan_size=16, function_selection="best", substrate_dtype=dtype),
    )


def _tsession(dtype="float32", capacity=128, max_capacity=256):
    _, corpus, combine, table, _ = _world()
    return TSession(
        [TPredicate(i, 1) for i in range(P)],
        interop.decision_table_from_numpy(jax.device_get(table)),
        interop.combine_params_from_numpy(jax.device_get(combine)),
        np.array(corpus.costs), capacity=capacity, max_tenants=SLOTS,
        max_capacity=max_capacity, device="cpu",
        config=EngineConfig(plan_size=16, function_selection="best", substrate_dtype=dtype),
    )


def _serve(package, session, state=None, **kw):
    """TRACE through one package's server (chunks of 2, admit seed 3)."""
    _, _, _, _, outputs = _world()
    if package == "jax":
        preds = _world()[0]
        if state is None:
            state = session.init_state(jnp.asarray(outputs[:96]))
        return j_serve.serve_session_trace(
            session, state, j_serve.parse_trace(TRACE), pool=jnp.asarray(outputs[96:]),
            preds=preds, seed=3, chunk_size=2, **kw)
    if state is None:
        state = session.init_state(torch.from_numpy(outputs[:96]))
    return t_serve.serve_session_trace(
        session, state, t_serve.parse_trace(TRACE), pool=torch.from_numpy(outputs[96:]),
        preds=[TPredicate(i, 1) for i in range(P)], seed=3, chunk_size=2, **kw)


def _stop_at(handler, boundary):
    ticks = [0]

    def hook():
        ticks[0] += 1
        if ticks[0] == boundary:
            handler.request()

    return hook


def _assert_digests(a, b):
    for key in DIGESTS:
        assert getattr(a, key) == getattr(b, key), key


def _assert_cross_package(t, j):
    """A port report against a JAX report of the same run: answers and
    integer outputs exact, spend and invoices within ``SUM_RTOL``."""
    assert (t.answer_digest, t.epochs_total, t.events_done, t.num_rows) == (
        j.answer_digest, j.epochs_total, j.events_done, j.num_rows)
    np.testing.assert_allclose(float.fromhex(t.cost_hex), float.fromhex(j.cost_hex),
                               rtol=SUM_RTOL)
    np.testing.assert_allclose([float.fromhex(h) for h in t.bills_hex],
                               [float.fromhex(h) for h in j.bills_hex], rtol=SUM_RTOL, atol=1e-7)


def _leaf_bytes(tree):
    return {k: (tuple(v.shape), str(np.asarray(v).dtype), np.asarray(v).tobytes())
            for k, v in tree}


# ------------------------------------------------------------------ store --


def _zoo():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "bf16": np.linspace(-2, 2, 8, dtype=np.float32).astype(ml_dtypes.bfloat16).reshape(2, 4),
        "bf16_scalar": np.asarray(1.5, ml_dtypes.bfloat16),
        "want_words": np.asarray([0, 1, 0xFFFFFFFF, 7], np.uint32),
        "num_rows": np.asarray(37, np.int32),
        "cost": np.asarray(0.017, np.float32),
        "mask": np.asarray([[True, False], [False, True]]),
        "nested": {"i32": np.asarray([-3, 0, 2**31 - 1], np.int32)},
    }


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else interop.to_torch(v)
            for k, v in tree.items()}


def _flat_bytes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_bytes(v, prefix + k + "/"))
        else:
            arr = interop.to_numpy(v) if torch.is_tensor(v) else np.asarray(v)
            out[prefix + k] = (arr.shape, str(arr.dtype), np.ascontiguousarray(arr).tobytes())
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_leaf_zoo_round_trips_bitwise_across_packages(tmp_path, writer):
    zoo = _zoo()
    if writer == "port":
        t_store.save_checkpoint(tmp_path, 3, _to_torch(zoo))
    else:
        j_store.save_checkpoint(tmp_path, 3, jax.tree.map(jnp.asarray, zoo))
    like = jax.tree.map(lambda x: LeafSpec(x.shape, interop.to_torch(x).dtype), zoo)
    got, step = t_store.restore_checkpoint(tmp_path, None, like, device="cpu")
    assert step == 3 and got["num_rows"].shape == () and got["bf16_scalar"].shape == ()
    assert _flat_bytes(got) == _flat_bytes(zoo)
    jlike = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), zoo)
    jgot, _ = j_store.restore_checkpoint(tmp_path, None, jlike)
    assert _flat_bytes(jax.device_get(jgot)) == _flat_bytes(zoo)
    # the empty tree is a checkpoint like any other
    t_store.save_checkpoint(tmp_path / "empty", 0, {})
    assert t_store.restore_checkpoint(tmp_path / "empty", 0, {}, device="cpu") == ({}, 0)
    assert j_store.restore_checkpoint(tmp_path / "empty", 0, {}) == ({}, 0)


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def test_store_strictness_errors_read_as_the_reference(tmp_path):
    t_store.save_checkpoint(tmp_path, 0, {"w": torch.tensor([1, 2], dtype=torch.uint32),
                                          "b": torch.zeros(2)})
    cases = [
        ({"w": ((2,), "int32"), "b": ((2,), "float32")}, "dtype uint32 != int32"),
        ({"w": ((3,), "uint32"), "b": ((2,), "float32")}, "shape (2,) != (3,)"),
        ({"w": ((2,), "uint32")}, "present but unconsumed ['b']"),
        ({"w": ((2,), "uint32"), "b": ((2,), "float32"), "c": ((2,), "float32")},
         "missing from checkpoint ['c']"),
    ]
    for spec, fragment in cases:
        tlike = {k: LeafSpec(s, t_store._TORCH_DTYPES[d]) for k, (s, d) in spec.items()}
        jlike = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d)) for k, (s, d) in spec.items()}
        t_msg = _error(lambda: t_store.restore_checkpoint(tmp_path, 0, tlike, device="cpu"))
        j_msg = _error(lambda: j_store.restore_checkpoint(tmp_path, 0, jlike))
        assert t_msg == j_msg and fragment in t_msg


def test_prune_old_guards_and_checkpointer_cadence(tmp_path):
    for s in (1, 2, 3, 4):
        t_store.save_checkpoint(tmp_path, s, {"x": torch.tensor(float(s))})
    with pytest.raises(ValueError, match="keep"):
        t_store.prune_old(tmp_path, keep=0)
    (tmp_path / "step_00000099").mkdir()  # torn: no meta.json, never counts
    (tmp_path / "step_00000005.tmp").mkdir()  # in flight: protects the newest
    assert t_store.prune_old(tmp_path, keep=1) == [1, 2, 3]
    assert t_store.prune_old(tmp_path, keep=1) == []
    assert t_store.available_steps(tmp_path) == [4] and t_store.latest_step(tmp_path) == 4
    assert (tmp_path / "step_00000005.tmp").exists()
    extra = {"format": 1, "host": {"event_cursor": 4, "rng": [1, 2]}}
    t_store.save_checkpoint(tmp_path / "meta", 7, {"x": torch.zeros(1)}, extra=extra)
    assert t_store.load_meta(tmp_path / "meta") == j_store.load_meta(tmp_path / "meta")
    assert t_store.load_meta(tmp_path / "meta")["extra"] == extra

    sess = _tsession()
    st = sess.init_state(torch.from_numpy(_world()[4][:96]))
    root = tmp_path / "ck"
    ck = SessionCheckpointer(sess, root, every=2, keep=2)
    with pytest.raises(ValueError, match="every"):
        SessionCheckpointer(sess, root, every=0)
    assert ck.maybe_save(st, 1) is None
    assert ck.maybe_save(st, 2) is not None
    assert ck.maybe_save(st, 3) is None
    assert ck.maybe_save(st, 4, force=True) is not None
    assert ck.maybe_save(st, 5) is None
    assert ck.maybe_save(st, 6) is not None
    assert ck.saves == 3 and ck.last_step == 6
    assert t_store.available_steps(root) == [4, 6]
    assert ck.save_seconds > 0 and ck.bytes_written > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_keys_are_the_references(dtype):
    _, _, _, _, outputs = _world()
    jst = _jsession(dtype).init_state(jnp.asarray(outputs[:96]))
    tsess = _tsession(dtype)
    tst = tsess.init_state(torch.from_numpy(outputs[:96]))
    j_flat, _ = j_store._flatten_with_paths(jst)
    assert [k for k, _ in j_flat] == LEAF_KEYS
    assert [k for k, _ in t_store._flatten_with_paths(tst)] == LEAF_KEYS
    spec = t_store._flatten_with_paths(session_state_spec(tsess, tst.capacity))
    assert [(k, tuple(v.shape), t_store.dtype_name(v.dtype)) for k, v in spec] == [
        (k, tuple(v.shape), str(v.dtype)) for k, v in j_flat]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_checkpoints_cross_packages_both_ways(tmp_path, writer, dtype):
    """One package serves TRACE, is preempted at boundary 3 and checkpoints;
    the other restores every leaf bitwise and resumes, and its re-saved
    checkpoint restores bitwise in the writer; both packages' resumed runs
    end with the uninterrupted runs' answers."""
    j_control = _serve("jax", _jsession(dtype))
    t_control = _serve("port", _tsession(dtype))
    _assert_cross_package(t_control, j_control)
    js, ts = _jsession(dtype), _tsession(dtype)
    if writer == "jax":
        stop = JPreemption()
        first = _serve("jax", js, preemption=stop, boundary_hook=_stop_at(stop, 3),
                       checkpointer=JCheckpointer(js, tmp_path, every=2))
    else:
        stop = PreemptionHandler()
        first = _serve("port", ts, preemption=stop, boundary_hook=_stop_at(stop, 3),
                       checkpointer=SessionCheckpointer(ts, tmp_path, every=2))
    assert first.preempted and first.epochs_total == 6
    t_state, step, extra = restore_session_checkpoint(ts, tmp_path)
    j_state, j_step, j_extra = j_restore(js, tmp_path)
    assert step == j_step == 6 and extra == j_extra
    assert extra["format"] == CHECKPOINT_FORMAT and extra["substrate_dtype"] == dtype
    saved = _leaf_bytes(j_store._flatten_with_paths(j_state)[0])
    assert _leaf_bytes((k, interop.to_numpy(v)) for k, v in
                       t_store._flatten_with_paths(t_state)) == saved
    # the reader re-saves; the writer's package restores those bits unchanged
    other = tmp_path / "resaved"
    if writer == "jax":
        save_session_checkpoint(other, 6, ts, t_state, host_meta=extra["host"])
        back, _, _ = j_restore(_jsession(dtype), other)
        assert _leaf_bytes(j_store._flatten_with_paths(back)[0]) == saved
    else:
        from repro.core import save_session_checkpoint as j_save

        j_save(other, 6, js, j_state, host_meta=extra["host"])
        back, _, _ = restore_session_checkpoint(_tsession(dtype), other)
        assert _leaf_bytes((k, interop.to_numpy(v)) for k, v in
                           t_store._flatten_with_paths(back)) == saved
    t_resumed = _serve("port", ts, t_state, resume=extra["host"])
    j_resumed = _serve("jax", js, j_state, resume=j_extra["host"])
    assert t_resumed.restored_step == j_resumed.restored_step == 6
    _assert_cross_package(t_resumed, j_control)
    _assert_cross_package(j_resumed, j_control)
    if writer == "port":  # the port resuming its own checkpoint is bitwise
        _assert_digests(t_resumed, t_control)
    else:
        _assert_digests(j_resumed, j_control)


def test_format_2_restores_into_an_f32_session_only(tmp_path):
    sess = _tsession()
    st = sess.init_state(torch.from_numpy(_world()[4][:96]))
    path = save_session_checkpoint(tmp_path, 0, sess, st)
    meta = json.loads((path / "meta.json").read_text())
    meta["extra"]["format"] = 2
    del meta["extra"]["substrate_dtype"]
    (path / "meta.json").write_text(json.dumps(meta))
    rst, step, extra = restore_session_checkpoint(sess, tmp_path)
    assert step == 0 and extra["substrate_dtype"] == "float32"
    for (k, a), (_, b) in zip(t_store._flatten_with_paths(rst), t_store._flatten_with_paths(st)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    with pytest.raises(ValueError, match="substrate_dtype"):
        restore_session_checkpoint(_tsession("bfloat16"), tmp_path)
    _restore_onto_a_one_rank_mesh(sess, tmp_path, st)
    meta["extra"]["format"] = 1
    (path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format"):
        restore_session_checkpoint(sess, tmp_path)


def _restore_onto_a_one_rank_mesh(sess, root, want):
    """``restore_session_checkpoint(mesh=)`` on a one-rank gloo group in
    this process: every leaf restores bitwise, the row leaves sharded on
    their row axis and the rest replicated, as ``shard_session_state``
    places them."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), 1), rank=0,
                            world_size=1)
    try:
        placed, step, _ = restore_session_checkpoint(sess, root, mesh=make_host_mesh(
            device_type="cpu"))
        assert step == 0
        rows = {".substrate/.func_probs": 0, ".substrate/.exec_mask": 0, ".bank_outputs": 0,
                ".derived/.pred_prob": 0, ".derived/.uncertainty": 0,
                ".derived/.joint_prob": 1, ".derived/.in_answer": 1}
        for (k, a), (_, b) in zip(t_store._flatten_with_paths(placed),
                                  t_store._flatten_with_paths(want)):
            assert torch.equal(a.full_tensor(), b), k
            shard = [p.dim for p in a.placements if p.is_shard()]
            assert shard == ([rows[k]] if k in rows else []), (k, a.placements)
    finally:
        dist.destroy_process_group()


def _churn(sess, st, outputs, upto_checkpoint):
    if upto_checkpoint:
        st, _ = sess.admit(st, t_conjunction(TPredicate(0, 1), TPredicate(1, 1)))
        st, _ = sess.admit(st, t_conjunction(TPredicate(1, 1), TPredicate(2, 1)))
        st, _ = sess.run(st, 3)
        st = sess.ingest(st, torch.from_numpy(outputs[48:108]))
        st, _ = sess.run(st, 3)
        return st
    st = sess.ingest(st, torch.from_numpy(outputs[108:228]))
    st, _ = sess.admit(st, t_conjunction(TPredicate(3, 1)))
    st, _ = sess.run(st, 4)
    return st


def test_restore_onto_a_larger_tier_keeps_growing_bitwise(tmp_path):
    """Saved at tier 128 (108 rows); restored into a session whose first tier
    is 256; the trace then grows it like the uninterrupted run."""
    outputs = _world()[4]
    saver = _tsession(capacity=64, max_capacity=256)
    st = _churn(saver, saver.init_state(torch.from_numpy(outputs[:48])), outputs, True)
    assert st.capacity == 128
    save_session_checkpoint(tmp_path, 6, saver, st)
    bigger = _tsession(capacity=256, max_capacity=256)
    rst, _, extra = restore_session_checkpoint(bigger, tmp_path)
    assert rst.capacity == 256 and extra["capacity"] == 128 and int(rst.num_rows) == 108
    assert not rst.substrate.exec_mask[128:].any() and not rst.derived.in_answer[:, 128:].any()
    control = _tsession(capacity=64, max_capacity=256)
    cst = _churn(control, _churn(control, control.init_state(torch.from_numpy(outputs[:48])),
                                 outputs, True), outputs, False)
    rst = _churn(bigger, rst, outputs, False)
    assert cst.capacity == rst.capacity == 256 and control.growths == 2
    assert float(rst.cost_spent) == float(cst.cost_spent)
    assert torch.equal(rst.derived.in_answer, cst.derived.in_answer)
    for name in ("attributed", "triples", "wanted", "unattributed", "archived"):
        assert torch.equal(getattr(rst.ledger, name), getattr(cst.ledger, name)), name
    with pytest.raises(CapacityError, match="last tier"):
        restore_session_checkpoint(_tsession(capacity=64, max_capacity=64), tmp_path)


@pytest.mark.parametrize("overlap", [False, True])
def test_serve_preempt_checkpoint_resume_is_bitwise(tmp_path, overlap):
    control = _serve("port", _tsession("bfloat16"), overlap=overlap)
    sess = _tsession("bfloat16")
    stop = PreemptionHandler()
    ck = SessionCheckpointer(sess, tmp_path, every=2)
    first = _serve("port", sess, preemption=stop, boundary_hook=_stop_at(stop, 4),
                   checkpointer=ck, overlap=overlap)
    assert first.preempted and first.checkpoint_saves == ck.saves >= 1
    fresh = _tsession("bfloat16")
    state, step, extra = restore_session_checkpoint(fresh, tmp_path)
    assert step == first.epochs_total
    resumed = _serve("port", fresh, state, resume=extra["host"], overlap=overlap)
    assert resumed.restored_step == step and resumed.events_done == len(resumed.events)
    _assert_digests(resumed, control)
