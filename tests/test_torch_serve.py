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
