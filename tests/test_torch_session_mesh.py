"""The session mesh on 1- and 2-rank CPU gloo groups: a session state
placed over the object axis (``durability.shard_session_state``) runs
``TRACE`` (admit, admit, run 4, ingest with a tier growth, run 4, retire,
run 4) through the per-rank program, held against the port's one-device
program and the JAX reference's emulated ``num_shards`` program; session
checkpoints cross 1 <-> 2 ranks, one device and the reference; the
supervisor recovers a worker death on the mesh (the 4-rank group:
``test_torch_session_mesh_4.py``).

One spawn per world size runs every check of its world
(``_torch_session_mesh_worker.py``) over a ``FileStore`` under the test's
temporary directory; rank 0 hands back what it measured.  The world is
``tests/test_sharded_devices.py``'s (P 4, F 4, 2 slots, plan size 32, 128
-> 256 rows), drawn by the reference's ``make_corpus`` with a learned
decision table.

Contracts: against the one-device program, bitwise — every history value,
the plans before each run, every leaf of the final state and the report
digests — at ``num_shards`` equal to R, 2R and a count that does not nest
(3 on 2 ranks; at 132 -> 264 rows the derived probabilities only within
an ulp: ``_torch_session_mesh_worker.check_cpu_tail``).  Against the
reference: plans (their lanes and costs), want-bits, answer masks, answer
sizes, plan and merged sizes, row counts and the final substrate masks and
answer sets exact; spend, attribution and E(F) within rtol 1e-6 (f32 sums
over plan lanes in XLA's order there, PyTorch's here), and the plans'
benefits too (XLA's and PyTorch's CPU log / exp differ by an ulp).
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_session_mesh_worker as W
from repro.core import EngineSession as JSession
from repro.core import MultiQueryConfig
from repro.core import Predicate as JPredicate
from repro.core import conjunction as j_conjunction
from repro.core import restore_session_checkpoint as j_restore
from repro.core import save_session_checkpoint as j_save
from repro.core.combine import default_combine_params
from repro.core.decision_table import learn_decision_table
from repro.core.plan import canonicalize_plan as j_canonicalize
from repro.data.synthetic import make_corpus
from repro_torch import interop
from test_torch_threads import one_torch_thread  # noqa: F401

SUM_RTOL = 1e-6
REF_CASES = ((2, 2), (2, 4))  # (ranks, plan shards) held against the reference


@functools.lru_cache(maxsize=None)
def _world():
    preds = [JPredicate(i, 1) for i in range(W.P)]
    corpus = make_corpus(
        jax.random.PRNGKey(5), W.TRAIN_ROWS + W.ODD_MAX, [p.tag_type for p in preds],
        [p.tag for p in preds], selectivity=[0.3] * W.P, aucs=[0.60, 0.88, 0.93, 0.97],
        costs=[0.01, 0.05, 0.2, 0.5])
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:W.TRAIN_ROWS], combine, num_bins=10)
    given = {
        "table": interop.decision_table_to_numpy(
            interop.decision_table_from_numpy(jax.device_get(table))),
        "combine": interop.combine_params_to_numpy(
            interop.combine_params_from_numpy(jax.device_get(combine))),
        "costs": np.array(corpus.costs),
        "outputs": np.array(corpus.func_probs[W.TRAIN_ROWS:]),
    }
    return preds, corpus, combine, table, given


def _jsession(mode, shards):
    preds, corpus, combine, table, _ = _world()
    return JSession(
        [p.positive() for p in preds], table, combine, corpus.costs, capacity=W.CAPACITY,
        max_tenants=W.SLOTS, max_capacity=W.MAX_CAPACITY,
        config=MultiQueryConfig(plan_size=W.PLAN, function_selection=mode, num_shards=shards,
                                backend="pallas", pallas_interpret=True))


def _np(x):
    return np.asarray(jax.device_get(x))


def _reference(mode, shards):
    """TRACE through the reference's emulated ``num_shards`` program ->
    (session, final state, record in the worker's layout)."""
    preds, _, _, _, given = _world()
    js = _jsession(mode, shards)
    st = js.init_state(jnp.asarray(given["outputs"][:W.INIT_ROWS]))
    rec = {"plans": [], "history": []}
    off = W.INIT_ROWS
    for kind, arg in W.TRACE:
        if kind == "admit":
            st, _ = js.admit(st, j_conjunction(*[preds[c] for c in W.QUERIES[arg]]))
        elif kind == "ingest":
            st = js.ingest(st, jnp.asarray(given["outputs"][off:off + arg]))
            off += arg
        elif kind == "retire":
            st = js.retire(st, arg)
        else:
            plans, merged, want = js.program._plan_part(st)
            rec["plans"].append(
                [[_np(x) for x in j_canonicalize(p)] for p in (plans, merged)]
                + [np.where(_np(merged.valid)[:, None], _np(want).astype(np.int64), 0)])
            st, h = js.run(st, arg, collect_masks=True, stop_when_exhausted=False)
            rec["history"].extend(h)
    return js, st, rec


@functools.lru_cache(maxsize=None)
def _references():
    return {(mode, s): _reference(mode, s) for mode in W.MODES for _, s in REF_CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("session_mesh")
    with open(d / "given.pkl", "wb") as f:
        pickle.dump(_world()[4], f)
    js, jst, _ = _references()[("best", 2)]
    j_save(d / "jax_ckpt", 12, js, jst)
    out = {}
    for world, restore_from in ((2, d / "jax_ckpt"), (1, d / "root2" / "final")):
        path = d / f"out{world}.pkl"
        W.spawn(W.run, world, str(d / f"store{world}"), str(d / "given.pkl"), str(path),
                str(d / f"root{world}"), str(restore_from))
        with open(path, "rb") as f:
            out[world] = pickle.load(f)
    return d, out


CASES = [(1, mode, s) for mode in W.MODES for s in (1, 2)] + [
    (2, mode, s) for mode in W.MODES for s in (2, 4, 3)]


@pytest.mark.parametrize("world,mode,shards", CASES)
def test_placed_trace_is_bitwise_the_one_device_run(runs, world, mode, shards):
    W.check_mesh_vs_one(runs[1][world], mode, shards)


def test_rows_off_the_cpu_vector_loops_hold_answers_bitwise(runs):
    W.check_cpu_tail(runs[1][2])


@pytest.mark.parametrize("world", [1, 2])
def test_replicated_leaves_are_equal_on_every_rank_after_every_chunk(runs, world):
    W.check_replicated(runs[1][world])


@pytest.mark.parametrize("world,shards", REF_CASES)
@pytest.mark.parametrize("mode", W.MODES)
def test_placed_trace_matches_the_reference_emulated_program(runs, world, shards, mode):
    got = runs[1][world][("mesh", mode, shards)]
    _, jst, want = _references()[(mode, shards)]
    for i, (g, w) in enumerate(zip(got["plans"], want["plans"])):
        for gp, wp in zip(g[:2], w[:2]):  # canonical (object, pred, func, benefit, cost, valid)
            for j, (a, b) in enumerate(zip(gp, wp)):
                if j == 3:
                    np.testing.assert_allclose(a, b, rtol=SUM_RTOL, err_msg=f"run {i}")
                else:
                    np.testing.assert_array_equal(a, np.asarray(b, a.dtype), err_msg=f"run {i}")
        np.testing.assert_array_equal(g[2], w[2])
    assert len(got["history"]) == len(want["history"]) == 12
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_array_equal(g["answer_mask"], w.answer_mask)
        assert (g["answer_size"], g["plan_valid"], g["merged_valid"], g["num_rows"],
                g["active"]) == (w.answer_size, w.plan_valid, w.merged_valid, w.num_rows,
                                 w.active)
        np.testing.assert_allclose(g["cost_spent"], w.cost_spent, rtol=SUM_RTOL)
        np.testing.assert_allclose(g["attributed"], w.attributed, rtol=SUM_RTOL, atol=1e-7)
        np.testing.assert_allclose(g["expected_f"], w.expected_f, rtol=SUM_RTOL, atol=1e-7)
    st = got["state"]
    for group, name in (("substrate", "exec_mask"), ("derived", "in_answer"),
                        ("ledger", "wanted")):
        np.testing.assert_array_equal(st[group][name], _np(getattr(getattr(jst, group), name)))
    np.testing.assert_array_equal(st["substrate"]["func_probs"], _np(jst.substrate.func_probs))
    assert int(st["num_rows"]) == int(jst.num_rows) == W.INIT_ROWS + W.INGEST_ROWS


def _leaves(tree, prefix=""):
    """{path: numpy} of a worker's numpy state or a reference state."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}.{name}").items()}
    if hasattr(tree, "__dataclass_fields__"):
        return {k: v for name in tree.__dataclass_fields__
                for k, v in _leaves(getattr(tree, name), f"{prefix}.{name}").items()}
    return {} if tree is None else {prefix: np.asarray(jax.device_get(tree))}


def _same_bits(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), (what, k)


def test_checkpoint_from_two_ranks_restores_on_one_rank_one_device_and_the_reference(runs):
    from repro_torch.core.durability import restore_session_checkpoint

    d, out = runs
    saved = _leaves(out[2][("mesh", "best", 2)]["state"])  # what the 2-rank run saved
    step, restored, placements = out[1]["restored"]
    assert step == 12
    W.check_placements(placements)
    _same_bits(_leaves(restored), saved, "2 ranks -> 1 rank")
    sess = W.session(_world()[4], "best", 1)
    one, step, _ = restore_session_checkpoint(sess, d / "root2" / "final")
    assert step == 12
    _same_bits(_leaves(interop.session_state_to_numpy(one)), saved, "2 ranks -> one device")
    jst, j_step, _ = j_restore(_jsession("best", 1), d / "root2" / "final")
    assert j_step == 12
    _same_bits(_leaves(jst), saved, "2 ranks -> the reference")


def test_reference_checkpoint_restores_onto_two_ranks(runs):
    _, jst, _ = _references()[("best", 2)]
    step, restored, placements = runs[1][2]["restored"]
    assert step == 12
    W.check_placements(placements)
    _same_bits(_leaves(restored), _leaves(jst), "the reference -> 2 ranks")


def test_a_tier_the_mesh_cannot_split_runs_the_one_device_program_on_every_rank(runs):
    W.check_odd_tier(runs[1][2])


def test_supervisor_on_a_two_rank_mesh_recovers_like_the_mesh_free_run(runs):
    W.check_supervised(runs[1][2])
