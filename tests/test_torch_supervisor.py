"""The port's serving runtime: fault plans, heartbeats, straggler and
elastic policies, and the supervisor, held against the JAX package's
``repro.runtime``.

The same spec and seed schedule the same faults; the runtime units behave
the same on the same inputs; and the four supervised scenarios of the
reference's ``tests/test_chaos_supervisor.py`` (a killed worker, a raising
function, a transient raise, a short silence) end with ``summary()`` equal
to the JAX supervisor's in every key but the wall-clock latencies.  The
port's recovered runs are bitwise equal to its own uninterrupted control;
against the JAX run the answer digest is equal and the spend within rtol
1e-6 (f32 sums over plan lanes in XLA's order there, PyTorch's here).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineSession as JSession
from repro.core import MultiQueryConfig
from repro.core import Predicate as JPredicate
from repro.core import fallback_decision_table
from repro.core.combine import default_combine_params
from repro.data.synthetic import make_corpus
from repro.launch import serve as j_serve
from repro.runtime import chaos as j_chaos
from repro.runtime import fault_tolerance as j_ft
from repro.runtime.supervisor import Supervisor as JSupervisor
from repro.runtime.supervisor import SupervisorConfig as JSupervisorConfig
from repro_torch import interop
from repro_torch.core.errors import MeshShrinkError
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate as TPredicate
from repro_torch.core.session import EngineSession as TSession
from repro_torch.launch import serve as t_serve
from repro_torch.runtime import chaos, fault_tolerance as ft
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig
from test_torch_threads import one_torch_thread  # noqa: F401

P, F = 4, 4
TRACE = "admit:2;admit:2;run:12;ingest:60;run:6"
SUM_RTOL = 1e-6  # f32 sums over plan lanes, XLA's order vs PyTorch's
WALL_CLOCK = ("recovery_latency_s",)


# ------------------------------------------------------------ fault plans --


@pytest.mark.parametrize("spec,seed", [
    ("kill:w1@chunk:6; silence:w0@chunk:4+3;slow:w2*8@chunk:3+5; raise:p2.f1@chunk:5+2;"
     "raise:p0.f3@chunk:9", 0),
    ("kill:w0@chunk:auto; raise:p1.f2@chunk:auto+3; slow:w1@chunk:auto", 13),
    ("silence:w1@chunk:auto+2;slow:w0*2.5@chunk:auto", 14),
    (" ; ", 0),
])
def test_parse_fault_spec_gives_the_references_events(spec, seed):
    plan = chaos.parse_fault_spec(spec, seed=seed, horizon=10)
    ref = j_chaos.parse_fault_spec(spec, seed=seed, horizon=10)
    assert [dataclasses.asdict(e) for e in plan.events] == [
        dataclasses.asdict(e) for e in ref.events]
    assert plan.seed == ref.seed and len(plan) == len(ref)
    for b in range(12):
        assert [dataclasses.asdict(e) for e in plan.due(b)] == [
            dataclasses.asdict(e) for e in ref.due(b)]
        for w in range(3):
            assert plan.silenced(w, b) == ref.silenced(w, b)
            assert plan.slow_factor(w, b) == ref.slow_factor(w, b)
        for p in range(3):
            assert plan.raising(p, 1, b) == ref.raising(p, 1, b)


@pytest.mark.parametrize("bad", ["explode:w1@chunk:3", "kill:w1", "kill:w1@chunk:0",
                                 "raise:p1@chunk:3", "silence:w0@chunk:4+0",
                                 "kill:w1@epoch:3", "kill:w1@chunk:6+2"])
def test_malformed_fault_specs_are_rejected_like_the_reference(bad):
    with pytest.raises(ValueError) as ours:
        chaos.parse_fault_spec(bad)
    with pytest.raises(ValueError) as theirs:
        j_chaos.parse_fault_spec(bad)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="kind"):
        chaos.FaultEvent(kind="meteor", boundary=1)


# ----------------------------------------------------------- runtime units --


def test_heartbeat_matches_the_reference():
    clocks = {"t": [0.0], "j": [0.0]}
    ours = ft.Heartbeat(num_workers=3, timeout_s=2.0, clock=lambda: clocks["t"][0])
    theirs = j_ft.Heartbeat(num_workers=3, timeout_s=2.0, clock=lambda: clocks["j"][0])
    script = [("beat", 0), ("tick", 1.5), ("beat", 1), ("tick", 1.0), ("failed", None),
              ("remove", 2), ("failed", None), ("beat", 2), ("revive", 2), ("tick", 3.0),
              ("beat", 0), ("failed", None), ("revive", 5), ("beat", 7)]
    for op, arg in script:
        results = []
        for hb, clock in ((ours, clocks["t"]), (theirs, clocks["j"])):
            try:
                if op == "tick":
                    clock[0] += arg
                    results.append(None)
                elif op == "failed":
                    results.append((hb.failed_workers(), hb.healthy()))
                else:
                    results.append(getattr(hb, op)(arg))
            except KeyError as e:
                results.append(("KeyError", str(e)))
        assert results[0] == results[1], (op, arg, results)


def test_straggler_monitor_and_elastic_policy_match_the_reference():
    ours, theirs = ft.StragglerMonitor(num_shards=4), j_ft.StragglerMonitor(num_shards=4)
    rng = np.random.default_rng(0)
    for _ in range(20):
        shard, secs = int(rng.integers(0, 3)), float(rng.uniform(0.5, 3.0))
        ours.record(shard, secs)
        theirs.record(shard, secs)
        assert ours.speeds() == theirs.speeds()
        assert ours.partition_weights() == theirs.partition_weights()
        assert ours.stragglers(1.2) == theirs.stragglers(1.2)
        for n in (0, 7, 1000):
            bounds = ours.rebalance_objects(n)
            assert bounds == theirs.rebalance_objects(n)
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a <= b for a, b in bounds)
    assert list(ours.recent) == list(theirs.recent)
    for data, model, healthy in ((8, 1, 5), (2, 1, 1), (4, 2, 6), (8, 4, 4)):
        assert ft.ElasticPolicy(data, model).shrink_for_failures(healthy) == \
            j_ft.ElasticPolicy(data, model).shrink_for_failures(healthy)
    with pytest.raises(MeshShrinkError) as ei:
        ft.ElasticPolicy(data_axis=4, model_axis=4).shrink_for_failures(3)
    assert (ei.value.healthy_chips, ei.value.model_axis) == (3, 4)


def test_preemption_handler_is_cooperative():
    import signal

    h = ft.PreemptionHandler(signals=(signal.SIGUSR1,))
    before = signal.getsignal(signal.SIGUSR1)
    h.install()
    assert not h.should_stop
    signal.raise_signal(signal.SIGUSR1)
    assert h.should_stop
    h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == before
    manual = ft.PreemptionHandler()
    manual.request()
    assert manual.should_stop


# ------------------------------------------------------ supervised serving --


@functools.lru_cache(maxsize=None)
def _world():
    preds = [JPredicate(i, 1) for i in range(P)]
    corpus = make_corpus(
        jax.random.PRNGKey(0), 256, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3, 0.4, 0.25, 0.35],
    )
    combine = default_combine_params(corpus.aucs)
    table = fallback_decision_table(P, F, corpus.aucs)
    return preds, corpus, combine, table


def _jsession(shards):
    preds, corpus, combine, table = _world()
    return JSession([p.positive() for p in preds], table, combine, corpus.costs, capacity=64,
                    max_tenants=3, max_capacity=256,
                    config=MultiQueryConfig(plan_size=32, num_shards=shards))


def _tsession(shards):
    _, corpus, combine, table = _world()
    return TSession(
        [TPredicate(i, 1) for i in range(P)],
        interop.decision_table_from_numpy(jax.device_get(table)),
        interop.combine_params_from_numpy(jax.device_get(combine)),
        np.array(corpus.costs), capacity=64, max_tenants=3, max_capacity=256, device="cpu",
        config=EngineConfig(plan_size=32, num_shards=shards),
    )


def _pool():
    return np.array(_world()[1].func_probs)


def _control(shards):
    sess = _tsession(shards)
    return t_serve.serve_session_trace(
        sess, sess.init_state(torch.from_numpy(_pool()[:48])), t_serve.parse_trace(TRACE),
        pool=torch.from_numpy(_pool()[48:]), preds=[TPredicate(i, 1) for i in range(P)],
        seed=7, chunk_size=2)


def _supervised(package, root, spec, shards, timeout):
    if package == "port":
        sess = _tsession(shards)
        sup = Supervisor(
            sess, sess.init_state(torch.from_numpy(_pool()[:48])), t_serve.parse_trace(TRACE),
            pool=torch.from_numpy(_pool()[48:]), preds=[TPredicate(i, 1) for i in range(P)],
            seed=7, checkpoint_dir=root, chunk_size=2,
            fault_plan=chaos.parse_fault_spec(spec),
            config=SupervisorConfig(heartbeat_timeout=timeout, checkpoint_every=2,
                                    checkpoint_keep=3))
    else:
        sess = _jsession(shards)
        sup = JSupervisor(
            sess, sess.init_state(jnp.asarray(_pool()[:48])), j_serve.parse_trace(TRACE),
            pool=jnp.asarray(_pool()[48:]), preds=_world()[0], seed=7, checkpoint_dir=root,
            chunk_size=2, fault_plan=j_chaos.parse_fault_spec(spec),
            config=JSupervisorConfig(heartbeat_timeout=timeout, checkpoint_every=2,
                                     checkpoint_keep=3))
    return sup, sup.serve()


SCENARIOS = {
    "kill": ("kill:w1@chunk:4", 2, 2.0),
    "raise": ("raise:p1.f2@chunk:4", 1, 2.0),
    "transient": ("raise:p1.f2@chunk:4+2", 1, 2.0),
    "silence": ("silence:w1@chunk:4+2", 2, 3.0),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervised_scenarios_match_the_jax_supervisor(tmp_path, scenario):
    spec, shards, timeout = SCENARIOS[scenario]
    sup, rep = _supervised("port", tmp_path / "port", spec, shards, timeout)
    jsup, jrep = _supervised("jax", tmp_path / "jax", spec, shards, timeout)
    s, js = sup.summary(), jsup.summary()
    assert {k: v for k, v in s.items() if k not in WALL_CLOCK} == {
        k: v for k, v in js.items() if k not in WALL_CLOCK}
    assert len(s["recovery_latency_s"]) == len(js["recovery_latency_s"]) == s["restarts"]
    assert not rep.preempted and not jrep.preempted
    assert (rep.answer_digest, rep.epochs_total, rep.quarantined, rep.degraded) == (
        jrep.answer_digest, jrep.epochs_total, jrep.quarantined, jrep.degraded)
    np.testing.assert_allclose(rep.cost_spent, jrep.cost_spent, rtol=SUM_RTOL)
    names = [t[2] for t in s["transitions"]]
    if scenario == "kill":
        assert s["final_state"] == "healthy" and s["shrinks"] == [[2, 1]]
        assert s["failed_workers"] == [1] and s["plan_shards"] == 1
        assert names == ["draining", "restoring", "healthy"]
        control = _control(2)  # recovery on the resharded session is bitwise
        for key in ("cost_hex", "bills_hex", "answer_digest", "epochs_total"):
            assert getattr(rep, key) == getattr(control, key), key
    elif scenario == "raise":
        assert s["final_state"] == "degraded" and s["quarantined"] == [[1, 2]]
        assert rep.degraded and rep.quarantined == [[1, 2]] and rep.mean_expected_f > 0
        assert s["restarts"] == 1 and s["function_failures"]["p1.f2"] >= 2
    elif scenario == "transient":
        assert s["final_state"] == "healthy" and s["recovered"] == [[1, 2]]
        assert not rep.degraded and s["restarts"] == 2
    else:
        assert s["restarts"] == 0 and s["final_state"] == "healthy" and s["shrinks"] == []
