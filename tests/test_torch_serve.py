"""The port's session server: trace parsing, the CPU serve path, its report.

The report's diff surface (``cost_hex``, ``bills_hex``, ``answer_digest``)
is held against the JAX server on one corpus: the answer digest exactly
(answer sets are exact), the spend within rtol 1e-6 (f32 sums accumulate in
another order than XLA's).
"""

import json

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
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate as TPredicate
from repro_torch.core.session import EngineSession as TSession
from repro_torch.launch import serve as t_serve
from test_torch_threads import one_torch_thread  # noqa: F401

TRACE = "admit:2;admit:3;run:3;ingest:64;admit:2;run:3;retire:0;run:3"


def _fold(state):
    acc = np.float32(np.float32(state.ledger.archived) + np.float32(state.ledger.unattributed))
    for b in state.ledger.bills(state.cost_spent):
        acc = np.float32(acc + b)
    return acc == np.float32(state.cost_spent)


@pytest.mark.parametrize("spec", [TRACE, "admit:1, run:2 ;retire:0", " ", "ingest:5;run:1"])
def test_parse_trace_matches_reference(spec):
    assert t_serve.parse_trace(spec) == j_serve.parse_trace(spec)


@pytest.mark.parametrize("spec", ["run:0", "ingest:-3", "retire:-1", "grow:2", "admit:x"])
def test_parse_trace_rejects_like_reference(spec):
    with pytest.raises(ValueError):
        j_serve.parse_trace(spec)
    with pytest.raises(ValueError):
        t_serve.parse_trace(spec)


def test_cpu_serve_trace_report():
    session, state, pool, preds = t_serve.build_session_server(
        num_objects=128, capacity=128, max_capacity=256, num_preds=4, max_tenants=4,
        plan_size=16, device="cpu",
    )
    report = t_serve.serve_session_trace(
        session, state, t_serve.parse_trace(TRACE), pool=pool, preds=preds, chunk_size=2
    )
    assert report.epochs == 9 and report.num_rows == 192 and report.capacity == 256
    assert report.growths == 1 and report.scan_lengths == [1, 2]
    assert report.superstep_traces == 4  # chunk lengths {2, 1} on each of two tiers
    assert report.cost_hex == report.cost_spent.hex() and report.cost_spent > 0
    assert len(report.bills_hex) == 4 and len(report.answer_digest) == 64
    assert report.device == "cpu" and _fold(report.state)
    bills = [float.fromhex(h) for h in report.bills_hex]
    np.testing.assert_allclose(sum(bills), report.cost_spent, rtol=1e-6)
    payload = report.payload()
    assert "state" not in payload and "history" not in payload
    json.dumps(payload)


def test_serve_main_writes_report(tmp_path):
    out = tmp_path / "report.json"
    rc = t_serve.main([
        "--session", "--objects", "64", "--preds", "3", "--max-tenants", "3",
        "--epochs", "8", "--device", "cpu", "--report", str(out),
    ])
    assert rc == 0
    rep = json.loads(out.read_text())
    for key in ("cost_hex", "bills_hex", "answer_digest", "superstep_traces", "epochs"):
        assert key in rep
    assert rep["epochs"] == 8 and rep["device"] == "cpu"
    # without --session the single-query operator serves (the reference's default mode)
    assert t_serve.main(["--objects", "64", "--epochs", "2", "--backbone", "",
                         "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):  # the cascade session serves a fixed corpus
        t_serve.main(["--session", "--bank", "cascade", "--capacity", "128", "--device", "cpu"])


def test_serve_trace_report_matches_jax_server():
    """One corpus, both servers: the same tenants are admitted (the admit RNG
    is the reference's), the answer digest matches exactly."""
    preds = [JPredicate(i, 1) for i in range(4)]
    corpus = make_corpus(
        jax.random.PRNGKey(5), 256 + 192, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3] * 4, aucs=[0.60, 0.88, 0.93, 0.97], costs=[0.01, 0.05, 0.2, 0.5],
    )
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:256], combine, num_bins=10)
    outputs = np.array(corpus.func_probs[256:])
    js = JSession(
        [p.positive() for p in preds], table, combine, corpus.costs, capacity=128,
        max_tenants=4, max_capacity=256,
        config=MultiQueryConfig(plan_size=16, function_selection="best", backend="pallas",
                                pallas_interpret=True),
    )
    ts = TSession(
        [TPredicate(i, 1) for i in range(4)],
        interop.decision_table_from_numpy(jax.device_get(table)),
        interop.combine_params_from_numpy(jax.device_get(combine)),
        np.array(corpus.costs), capacity=128, max_tenants=4, max_capacity=256, device="cpu",
        config=EngineConfig(plan_size=16, function_selection="best"),
    )
    events = t_serve.parse_trace(TRACE)
    jrep = j_serve.serve_session_trace(
        js, js.init_state(jnp.asarray(outputs[:128])), events,
        pool=jnp.asarray(outputs[128:]), preds=preds, seed=3,
    )
    trep = t_serve.serve_session_trace(
        ts, ts.init_state(torch.from_numpy(outputs[:128])), events,
        pool=torch.from_numpy(outputs[128:]), preds=[TPredicate(i, 1) for i in range(4)], seed=3,
    )
    assert trep.answer_digest == jrep.answer_digest
    assert (trep.epochs, trep.num_rows, trep.growths) == (jrep.epochs, jrep.num_rows, jrep.growths)
    np.testing.assert_allclose(trep.cost_spent, jrep.cost_spent, rtol=1e-6)
    np.testing.assert_allclose(
        [float.fromhex(h) for h in trep.bills_hex], [float.fromhex(h) for h in jrep.bills_hex],
        rtol=1e-6, atol=1e-7,
    )


# --------------------------------------------------- serving robustness CLI --
#
# ``main`` with the serving-robustness flags, on the CPU, against the JAX
# ``repro.launch.serve.main`` with the same flags.  Both server factories point
# at ONE world made by the reference's ``build_session_server`` (its corpus,
# combine weights and table, carried into the port with ``interop``), so the
# two reports describe the same run: answer digests, integer outputs, ingest
# counters and supervision summaries equal; spend within rtol 1e-6 (f32 sums
# over plan lanes in XLA's order there, PyTorch's here).  Within the port the
# overlap, streaming, restored and supervised runs are bitwise equal to the
# lockstep run.

import dataclasses  # noqa: E402
import functools  # noqa: E402
import signal  # noqa: E402

from repro_torch.runtime.fault_tolerance import PreemptionHandler  # noqa: E402

CLI = ["--session", "--objects", "64", "--preds", "4", "--epochs", "8", "--chunk-size", "1"]
SAME = ("epochs", "epochs_total", "events_done", "num_rows", "capacity", "growths",
        "scan_lengths", "preempted", "restored_step", "checkpoint_saves", "active_tenants",
        "quarantined", "degraded", "streaming", "substrate_dtype", "ring_drains",
        "ingest_counters", "answer_digest")
SUM_RTOL = 1e-6
_J_BUILD = j_serve.build_session_server  # the fixture below patches the module's name


@functools.lru_cache(maxsize=None)
def _reference_world(num_objects, capacity, num_preds, max_capacity, substrate_dtype):
    session, state, pool, preds = _J_BUILD(
        num_objects=num_objects, capacity=capacity, num_preds=num_preds, max_tenants=8,
        max_capacity=max_capacity, substrate_dtype=substrate_dtype)
    init = np.array(jax.device_get(state.bank_outputs[:num_objects]))
    return session, init, np.array(pool), preds


def _j_server(num_objects=256, capacity=None, num_preds=4, max_tenants=8, plan_shards=1,
               backend="jnp", max_capacity=None, substrate_dtype="float32", **_):
    ref, init, pool, preds = _reference_world(num_objects, capacity, num_preds, max_capacity,
                                              substrate_dtype)
    s = JSession(ref.global_predicates, ref.table, ref.combine_params, ref.costs,
                 capacity=ref.capacity, max_tenants=max_tenants, max_capacity=max_capacity,
                 config=dataclasses.replace(ref.config, num_shards=plan_shards, backend=backend))
    return s, s.init_state(jnp.asarray(init)), jnp.asarray(pool), preds


def _t_server(num_objects=256, capacity=None, num_preds=4, max_tenants=8, plan_shards=1,
               max_capacity=None, substrate_dtype="float32", device=None, **_):
    ref, init, pool, _ = _reference_world(num_objects, capacity, num_preds, max_capacity,
                                          substrate_dtype)
    s = TSession(
        [TPredicate(i, 1) for i in range(num_preds)],
        interop.decision_table_from_numpy(jax.device_get(ref.table)),
        interop.combine_params_from_numpy(jax.device_get(ref.combine_params)),
        np.array(ref.costs), capacity=ref.capacity, max_tenants=max_tenants,
        max_capacity=max_capacity, device=device,
        config=EngineConfig(plan_size=64, function_selection="best", num_shards=plan_shards,
                            substrate_dtype=substrate_dtype))
    return (s, s.init_state(interop.to_torch(init)), torch.from_numpy(pool),
            [TPredicate(i, 1) for i in range(num_preds)])


@pytest.fixture
def one_world(monkeypatch):
    monkeypatch.setattr(j_serve, "build_session_server", _j_server)
    monkeypatch.setattr(t_serve, "build_session_server", _t_server)


def _main(package, args, out):
    """-> the JSON report of one package's ``main`` (the JAX main installs a
    SIGTERM handler it never removes: put the old one back)."""
    if package == "port":
        assert t_serve.main(args + ["--device", "cpu", "--report", str(out)]) == 0
    else:
        before = signal.getsignal(signal.SIGTERM)
        try:
            assert j_serve.main(args + ["--report", str(out)]) == 0
        finally:
            signal.signal(signal.SIGTERM, before)
    return json.loads(out.read_text())


def _same_run(t, j):
    for key in SAME:
        assert t[key] == j[key], key
    np.testing.assert_allclose(float.fromhex(t["cost_hex"]), float.fromhex(j["cost_hex"]),
                               rtol=SUM_RTOL)
    np.testing.assert_allclose([float.fromhex(h) for h in t["bills_hex"]],
                               [float.fromhex(h) for h in j["bills_hex"]],
                               rtol=SUM_RTOL, atol=1e-7)


def _bitwise(a, b):
    for key in ("cost_hex", "bills_hex", "answer_digest", "epochs_total"):
        assert a[key] == b[key], key


def test_serve_main_overlap_matches_lockstep_and_the_reference(tmp_path, one_world):
    lock = _main("port", CLI, tmp_path / "lock.json")
    over = _main("port", CLI + ["--overlap"], tmp_path / "over.json")
    _bitwise(over, lock)
    assert over["overlap"] and over["superstep_traces"] <= lock["superstep_traces"]
    _same_run(over, _main("jax", CLI + ["--overlap"], tmp_path / "j.json"))


def test_serve_main_checkpoint_then_restore(tmp_path, one_world):
    """A checkpointed run, then ``--restore`` from its middle step: bitwise
    the uninterrupted run, as the reference's; and the port's ``--restore``
    resumes a checkpoint directory the JAX server wrote."""
    full = _main("port", CLI, tmp_path / "full.json")
    flags = CLI + ["--checkpoint-every", "2", "--checkpoint-keep", "8"]
    saved = _main("port", flags + ["--checkpoint-dir", str(tmp_path / "ck")], tmp_path / "s.json")
    _bitwise(saved, full)
    assert saved["checkpoint_saves"] == 5  # steps 2, 4, 6, 8 + the final restore point
    back = ["--restore", "--restore-step", "4"]
    resumed = _main("port", flags + ["--checkpoint-dir", str(tmp_path / "ck")] + back,
                    tmp_path / "r.json")
    assert resumed["restored_step"] == 4 and resumed["epochs"] == 4
    _bitwise(resumed, full)
    j_saved = _main("jax", flags + ["--checkpoint-dir", str(tmp_path / "jck")],
                    tmp_path / "js.json")
    _same_run(saved, j_saved)
    j_resumed = _main("jax", flags + ["--checkpoint-dir", str(tmp_path / "jck")] + back,
                      tmp_path / "jr.json")
    _same_run(resumed, j_resumed)
    crossed = _main("port", flags + ["--checkpoint-dir", str(tmp_path / "jck")] + back,
                    tmp_path / "x.json")
    _same_run(crossed, j_resumed)


@pytest.mark.parametrize("policy", ["block", "shed", "spill"])
def test_serve_main_streaming_policies_match_the_reference(tmp_path, one_world, policy):
    flags = CLI + ["--ingest-batch", "8", "--ring-capacity", "2", "--ingest-policy", policy]
    streamed = _main("port", flags, tmp_path / "t.json")
    c = streamed["ingest_counters"]
    assert streamed["streaming"] and c["rows_fed"] == 32 and c["batches_fed"] == 4
    assert (c["shed_rows"] > 0) == (policy == "shed")
    assert (c["spilled_rows"] > 0) == (policy == "spill")
    if policy != "shed":  # lossless policies: bitwise the direct ingest
        _bitwise(streamed, _main("port", CLI, tmp_path / "d.json"))
    _same_run(streamed, _main("jax", flags, tmp_path / "j.json"))


def test_serve_main_supervised_faults_match_the_reference(tmp_path, one_world):
    flags = CLI + ["--plan-shards", "2", "--supervise", "--inject-faults", "kill:w1@chunk:4",
                   "--checkpoint-every", "2"]
    sup = _main("port", flags + ["--checkpoint-dir", str(tmp_path / "t")], tmp_path / "t.json")
    ref = _main("jax", flags + ["--checkpoint-dir", str(tmp_path / "j")], tmp_path / "j.json")
    _same_run(sup, ref)
    s, js = sup["supervision"], ref["supervision"]
    assert s["final_state"] == "healthy" and s["shrinks"] == [[2, 1]]
    s.pop("recovery_latency_s"), js.pop("recovery_latency_s")
    assert s == js
    _bitwise(sup, _main("port", CLI + ["--plan-shards", "2"], tmp_path / "c.json"))


@pytest.mark.parametrize("extra", [
    ["--restore"],
    ["--inject-faults", "kill:w1@chunk:2"],
    ["--supervise"],
    ["--supervise", "--checkpoint-dir", "CK", "--restore"],
    ["--supervise", "--checkpoint-dir", "CK", "--ingest-batch", "8"],
    ["--bank", "cascade", "--ingest-batch", "8"],
    ["--bank", "cascade", "--supervise", "--checkpoint-dir", "CK"],
])
def test_serve_main_rejects_the_references_flag_combinations(tmp_path, extra):
    args = ["--session", "--objects", "64", "--device", "cpu"]
    args += [str(tmp_path) if a == "CK" else a for a in extra]
    with pytest.raises(SystemExit) as ei:
        t_serve.main(args)
    assert ei.value.code == 2


def test_single_and_multi_query_servers_stop_on_preemption():
    stop = PreemptionHandler()
    stop.request()
    op, *_ = t_serve.build_server(64, 1, None, device="cpu")
    assert t_serve.serve_query(op, 64, 5, stop).epochs == 0
    assert t_serve.serve_query(op, 64, 2, PreemptionHandler()).epochs == 2
    engine, *_ = t_serve.build_multi_server(64, 3, 2, None, device="cpu")
    assert t_serve.serve_queries(engine, 64, 5, stop).epochs == 0
