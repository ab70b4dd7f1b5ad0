"""Session parity: the port's ``EngineSession`` vs the JAX session, epoch by epoch.

Both sessions run one churn trace (admit -> run -> ingest with one tier
growth -> admit -> run -> retire -> run) over the same corpus, combine
parameters and learned decision table (carried over with
``repro_torch.interop``).  The JAX session scores with its Pallas kernels in
interpret mode; the port's CPU session with the kernels' plain versions.

Per epoch, EXACT: per-slot plans, the merged plan, want-bits, answer masks
and the merged-plan sizes.  Within a tolerance: ``cost_spent``, per-slot
attribution and E(F) (rtol 1e-6) — f32 sums over lanes and rows accumulate
in another order than XLA's reductions — and the derived probabilities
(atol 5e-7: XLA's and PyTorch's CPU log/exp differ by 1-2 ulp, an error of
up to ~1e-6 in a logit of magnitude <= 8, which the sigmoid scales by at
most 1/4).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EngineSession as JSession
from repro.core import MultiQueryConfig
from repro.core import Predicate as JPredicate
from repro.core import conjunction as j_conjunction
from repro.core.combine import default_combine_params
from repro.core.decision_table import learn_decision_table
from repro.data.synthetic import make_corpus
from repro_torch import interop
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate as TPredicate
from repro_torch.core.query import conjunction as t_conjunction
from repro_torch.core.session import EngineSession as TSession
from test_torch_threads import one_torch_thread  # noqa: F401

P, F, SLOTS = 4, 4, 4
QUERIES = [(0, 1), (1, 2, 3), (0, 2), (2, 3)]
TRACE = [("admit", 0), ("admit", 1), ("run", 4), ("ingest", 96), ("admit", 2),
         ("run", 4), ("retire", 0), ("run", 4)]
SUM_RTOL = 1e-6
REPO = Path(__file__).resolve().parents[1]


def _np(x):
    return np.asarray(jax.device_get(x))


@functools.lru_cache(maxsize=None)
def _world():
    preds = [JPredicate(i, 1) for i in range(P)]
    corpus = make_corpus(
        jax.random.PRNGKey(3), 256 + 192, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3] * P, aucs=[0.60, 0.88, 0.93, 0.97], costs=[0.01, 0.05, 0.2, 0.5],
    )
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:256], combine, num_bins=10)
    outputs = np.array(corpus.func_probs[256:])
    return preds, corpus, combine, table, outputs


def _sessions(mode, dtype, capacity=128, max_capacity=256):
    preds, corpus, combine, table, _ = _world()
    js = JSession(
        [p.positive() for p in preds], table, combine, corpus.costs,
        capacity=capacity, max_tenants=SLOTS, max_capacity=max_capacity,
        config=MultiQueryConfig(plan_size=16, function_selection=mode, backend="pallas",
                                pallas_interpret=True, substrate_dtype=dtype),
    )
    ts = _port_session(mode, dtype, capacity, max_capacity)
    return js, ts


def _port_session(mode, dtype, capacity=128, max_capacity=256, **cfg):
    _, corpus, combine, table, _ = _world()
    return TSession(
        [TPredicate(i, 1) for i in range(P)],
        interop.decision_table_from_numpy(jax.device_get(table)),
        interop.combine_params_from_numpy(jax.device_get(combine)),
        np.array(corpus.costs), capacity=capacity, max_tenants=SLOTS,
        max_capacity=max_capacity, device="cpu",
        config=EngineConfig(plan_size=16, function_selection=mode, substrate_dtype=dtype, **cfg),
    )


# ten tagging functions (chip_smoke's SESSION10_*): best mode's lane kernel at F 10 on the card
AUCS10 = (0.60, 0.66, 0.70, 0.74, 0.78, 0.84, 0.88, 0.91, 0.93, 0.97)
COSTS10 = (0.01, 0.015, 0.02, 0.035, 0.05, 0.08, 0.12, 0.2, 0.35, 0.5)
TRACE10 = [("admit", 0), ("admit", 1), ("run", 2), ("admit", 2), ("run", 2)]


@functools.lru_cache(maxsize=None)
def _world10():
    preds = [JPredicate(i, 1) for i in range(P)]
    corpus = make_corpus(
        jax.random.PRNGKey(5), 256 + 96, [p.tag_type for p in preds], [p.tag for p in preds],
        selectivity=[0.3] * P, aucs=list(AUCS10), costs=list(COSTS10),
    )
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:256], combine, num_bins=10)
    return preds, corpus, combine, table, np.array(corpus.func_probs[256:])


def _canon(plan, np_of):
    v = np_of(plan.valid)
    return [v] + [np.where(v, np_of(x).astype(np.int64), -1)
                  for x in (plan.object_idx, plan.pred_idx, plan.func_idx)]


def _port_trace(ts, st, outputs, chunk_size=None):
    """Run TRACE on a port session -> (final state, history)."""
    hist = []
    for kind, arg in TRACE:
        if kind == "admit":
            st, _ = ts.admit(st, t_conjunction(*[TPredicate(c, 1) for c in QUERIES[arg]]))
        elif kind == "ingest":
            st = ts.ingest(st, torch.from_numpy(outputs[96:96 + arg]))
        elif kind == "retire":
            st = ts.retire(st, arg)
        else:
            st, h = ts.run(st, arg, collect_masks=True, stop_when_exhausted=False,
                           chunk_size=chunk_size)
            hist.extend(h)
    return st, hist


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["best", "table"])
def test_churn_trace_matches_jax_epoch_by_epoch(mode, dtype):
    preds, _, _, _, outputs = _world()
    js, ts = _sessions(mode, dtype)
    jst = js.init_state(jnp.asarray(outputs[:96]))
    tst = ts.init_state(torch.from_numpy(outputs[:96]))
    j_plan_part = jax.jit(js.program._plan_part)
    epochs = 0
    for kind, arg in TRACE:
        if kind == "admit":
            cols = QUERIES[arg]
            jst, js_slot = js.admit(jst, j_conjunction(*[preds[c] for c in cols]))
            tst, ts_slot = ts.admit(tst, t_conjunction(*[TPredicate(c, 1) for c in cols]))
            assert ts_slot == js_slot
        elif kind == "ingest":
            jst = js.ingest(jst, jnp.asarray(outputs[96:96 + arg]))
            tst = ts.ingest(tst, torch.from_numpy(outputs[96:96 + arg]))
        elif kind == "retire":
            jst, tst = js.retire(jst, arg), ts.retire(tst, arg)
        else:
            for _ in range(arg):
                jplans, jmerged, jwant = j_plan_part(jst)
                tplans, tmerged, twant = ts.program._plan_part(tst)
                for a, b in zip(_canon(tplans, lambda x: x.numpy()), _canon(jplans, _np)):
                    np.testing.assert_array_equal(a, b)
                for a, b in zip(_canon(tmerged, lambda x: x.numpy()), _canon(jmerged, _np)):
                    np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(twant.numpy(), _np(jwant).astype(np.int64))
                jst, (jh,) = js.run(jst, 1, collect_masks=True, stop_when_exhausted=False)
                tst, (th,) = ts.run(tst, 1, collect_masks=True, stop_when_exhausted=False)
                np.testing.assert_array_equal(th.answer_mask, jh.answer_mask)
                assert (th.merged_valid, th.plan_valid, th.answer_size, th.num_rows) == (
                    jh.merged_valid, jh.plan_valid, jh.answer_size, jh.num_rows)
                np.testing.assert_allclose(th.cost_spent, jh.cost_spent, rtol=SUM_RTOL)
                np.testing.assert_allclose(th.attributed, jh.attributed, rtol=SUM_RTOL, atol=1e-7)
                np.testing.assert_allclose(th.expected_f, jh.expected_f, rtol=SUM_RTOL, atol=1e-7)
                np.testing.assert_allclose(
                    tst.derived.pred_prob.float().numpy(),
                    _np(jst.derived.pred_prob.astype(jnp.float32)), rtol=0, atol=5e-7,
                )
                epochs += 1
    assert epochs == 12 and tst.capacity == jst.capacity == 256 and ts.growths == 1
    assert ts.superstep_traces <= ts.retrace_bound
    # the port's invoices reconcile with its own spend bit for bit
    bills = tst.ledger.bills(tst.cost_spent)
    acc = np.float32(np.float32(tst.ledger.archived) + np.float32(tst.ledger.unattributed))
    for b in bills:
        acc = np.float32(acc + b)
    assert acc == np.float32(tst.cost_spent)


def test_ten_function_session_matches_jax_epoch_by_epoch():
    """Best mode with ten tagging functions (a table of 2^10 states: past the
    card's smem route, its global lane kernel at F 10), f32, 96 objects: per-slot plans,
    merged plans, want-bits and answers equal the reference's epoch by
    epoch, spend within SUM_RTOL."""
    preds, corpus, combine, table, outputs = _world10()
    assert table.delta_h_all.shape == (P, 2**10, 10, 10)
    cfg = dict(capacity=96, max_tenants=SLOTS, max_capacity=96)
    js = JSession([p.positive() for p in preds], table, combine, corpus.costs,
                  config=MultiQueryConfig(plan_size=16, function_selection="best",
                                          backend="pallas", pallas_interpret=True), **cfg)
    ts = TSession([TPredicate(i, 1) for i in range(P)],
                  interop.decision_table_from_numpy(jax.device_get(table)),
                  interop.combine_params_from_numpy(jax.device_get(combine)),
                  np.array(corpus.costs), device="cpu",
                  config=EngineConfig(plan_size=16, function_selection="best"), **cfg)
    jst = js.init_state(jnp.asarray(outputs))
    tst = ts.init_state(torch.from_numpy(outputs))
    j_plan_part = jax.jit(js.program._plan_part)
    epochs, picked = 0, set()
    for kind, arg in TRACE10:
        if kind == "admit":
            cols = QUERIES[arg]
            jst, js_slot = js.admit(jst, j_conjunction(*[preds[c] for c in cols]))
            tst, ts_slot = ts.admit(tst, t_conjunction(*[TPredicate(c, 1) for c in cols]))
            assert ts_slot == js_slot
            continue
        for _ in range(arg):
            jplans, jmerged, jwant = j_plan_part(jst)
            tplans, tmerged, twant = ts.program._plan_part(tst)
            for a, b in zip(_canon(tplans, lambda x: x.numpy()), _canon(jplans, _np)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(_canon(tmerged, lambda x: x.numpy()), _canon(jmerged, _np)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(twant.numpy(), _np(jwant).astype(np.int64))
            picked |= set(tmerged.func_idx[tmerged.valid].tolist())
            jst, (jh,) = js.run(jst, 1, collect_masks=True, stop_when_exhausted=False)
            tst, (th,) = ts.run(tst, 1, collect_masks=True, stop_when_exhausted=False)
            np.testing.assert_array_equal(th.answer_mask, jh.answer_mask)
            assert (th.merged_valid, th.plan_valid, th.answer_size) == (
                jh.merged_valid, jh.plan_valid, jh.answer_size)
            np.testing.assert_allclose(th.cost_spent, jh.cost_spent, rtol=SUM_RTOL)
            np.testing.assert_allclose(th.attributed, jh.attributed, rtol=SUM_RTOL, atol=1e-7)
            epochs += 1
    assert epochs == 4 and picked and all(0 <= f < 10 for f in picked)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grown_equals_preallocated_and_chunked_equals_monolithic(dtype):
    *_, outputs = _world()
    runs = []
    for capacity, chunk in ((128, None), (256, None), (128, 3)):
        ts = _port_session("best", dtype, capacity=capacity)
        st, hist = _port_trace(ts, ts.init_state(torch.from_numpy(outputs[:96])), outputs, chunk)
        runs.append((ts, st, hist))
    (g, gst, ghist), (pre, pst, phist), (ch, cst, chist) = runs
    assert g.growths == 1 and pre.growths == 0 and gst.capacity == pst.capacity == 256
    for a, b, c in zip(ghist, phist, chist):
        assert a.cost_spent == b.cost_spent == c.cost_spent
        assert a.attributed == b.attributed == c.attributed
        assert a.expected_f == b.expected_f == c.expected_f
        rows = a.num_rows
        np.testing.assert_array_equal(a.answer_mask[:, :rows], b.answer_mask[:, :rows])
        np.testing.assert_array_equal(a.answer_mask, c.answer_mask)
    for name in ("func_probs", "exec_mask"):
        assert torch.equal(getattr(gst.substrate, name), getattr(pst.substrate, name))
    assert torch.equal(gst.derived.in_answer, pst.derived.in_answer)
    # chunk programs: one per (tier, chunk length) actually dispatched
    assert ch.superstep_traces == 4  # lengths 3 and 1 on each of two tiers
    assert g.superstep_traces == 2 and pre.superstep_traces == 1


def test_session_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, corpus, combine, table, _ = _world()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSession(
            [TPredicate(i, 1) for i in range(P)],
            interop.decision_table_from_numpy(jax.device_get(table)),
            interop.combine_params_from_numpy(jax.device_get(combine)),
            np.array(corpus.costs), capacity=64, max_tenants=2,
        )


def test_session_state_round_trips_through_interop():
    *_, outputs = _world()
    ts = _port_session("best", "bfloat16")
    st, _ = _port_trace(ts, ts.init_state(torch.from_numpy(outputs[:96])), outputs)
    back = interop.session_state_from_numpy(interop.session_state_to_numpy(st))
    for a, b in ((st.substrate.func_probs, back.substrate.func_probs),
                 (st.derived.in_answer, back.derived.in_answer),
                 (st.ledger.attributed, back.ledger.attributed),
                 (st.num_rows, back.num_rows), (st.quarantined, back.quarantined)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.core.session, repro_torch.launch.serve, repro_torch.interop\n"
        "import repro_torch.enrich.cascade, repro_torch.models.transformer\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.launch.profile\n"
        "import repro_torch.core.operator, repro_torch.core.multi_query\n"
        "import repro_torch.core.baselines, repro_torch.enrich.simulated, repro_torch.quickstart\n"
        "import repro_torch.models.model, repro_torch.models.ssm, repro_torch.configs.archs\n"
        "import repro_torch.kernels.ssd_scan.ops, repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.checkpoint.store, repro_torch.core.durability, repro_torch.ingest\n"
        "import repro_torch.runtime.chaos, repro_torch.runtime.fault_tolerance\n"
        "import repro_torch.runtime.supervisor\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes']\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
