"""The port's core building blocks vs ``repro.core``, on the same numpy inputs.

Parity contract, with the reason for every tolerance:

* bit-identical: the 4096-bin inverse-entropy LUT (the same numpy code on
  both sides), decision-table lookups, the analytic fallback table, query
  evaluation (the same multiplications in the same order), state packing,
  padding, ingest and the typed errors' payloads;
* a few ulps: anything through ``log`` / ``log1p`` / ``exp`` / ``pow`` —
  XLA's CPU transcendentals and PyTorch's differ by 1-2 ulp on ~15% of f32
  inputs — so binary entropy, the combine function and AUC carry rtol 1e-5;
* learned artefacts (``fit_combine_weights``, ``learn_decision_table``)
  compound those ulps through gradient steps and per-bin means: atol 1e-4
  on the fitted parameters and the tables' deltas; the Platt fit
  (``calibrate_platt``: two parameters, 300 steps over one mean NLL)
  carries atol 1e-5 on (a, b);
* the lower entropy root is ``1 - `` the upper one, bitwise within the
  port; against the reference it carries the upper root's lerp drift
  (4 ulp of a value <= 1) as atol 5e-7.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import combine as j_combine
from repro.core import decision_table as j_dt
from repro.core import entropy as j_entropy
from repro.core import errors as j_errors
from repro.core import query as j_query
from repro.core import state as j_state
from repro_torch import interop
from repro_torch.core import combine as t_combine
from repro_torch.core import decision_table as t_dt
from repro_torch.core import entropy as t_entropy
from repro_torch.core import errors as t_errors
from repro_torch.core import query as t_query
from repro_torch.core import state as t_state
from test_torch_threads import one_torch_thread  # noqa: F401

TRANSCENDENTAL_RTOL = 1e-5
LEARNED_ATOL = 1e-4
PLATT_ATOL = 1e-5


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return interop.to_torch(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _train(seed=0, n=256, p=2, f=3):
    """numpy training outputs [N, P, F] + labels [N, P] from a seed."""
    rng = np.random.default_rng(seed)
    labels = (rng.uniform(size=(n, p)) < 0.35).astype(np.float32)
    mu = np.linspace(0.2, 1.2, f)[None, None, :]
    score = mu * (2 * labels[:, :, None] - 1) + rng.normal(size=(n, p, f))
    probs = (1 / (1 + np.exp(-2 * mu * score))).astype(np.float32)
    for a in (probs, labels):
        a.setflags(write=False)
    return probs, labels


# ---------------------------------------------------------------- entropy --


def test_inverse_entropy_lut_bit_identical():
    for bins in (4096, 513):
        j = j_entropy._inverse_entropy_table(bins)
        t = t_entropy._inverse_entropy_table(bins)
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))


def test_binary_entropy_and_inverse_match():
    rng = np.random.default_rng(0)
    p = np.concatenate([[0.0, 1.0, 0.5, 1e-30], rng.uniform(size=4000)]).astype(np.float32)
    np.testing.assert_allclose(
        t_entropy.binary_entropy(_t(p)).numpy(), _np(j_entropy.binary_entropy(jnp.asarray(p))),
        rtol=TRANSCENDENTAL_RTOL, atol=1e-7,
    )
    h = rng.uniform(-0.1, 1.1, size=4000).astype(np.float32)
    # the same f32 lerp on both sides; XLA may contract it into an FMA (4 ulp)
    np.testing.assert_allclose(
        t_entropy.inverse_entropy_upper(_t(h)).numpy(),
        _np(j_entropy.inverse_entropy_upper(jnp.asarray(h))),
        rtol=5e-7, atol=0,
    )
    for bins in (10, 7):
        np.testing.assert_array_equal(
            t_entropy.uncertainty_bin(_t(h), bins).numpy(),
            _np(j_entropy.uncertainty_bin(jnp.asarray(h), bins)),
        )


def test_inverse_entropy_lower_matches():
    rng = np.random.default_rng(3)
    h = np.concatenate([[0.0, 1.0, 0.5], rng.uniform(-0.1, 1.1, size=4000)]).astype(np.float32)
    for bins in (4096, 513):
        t = t_entropy.inverse_entropy_lower(_t(h), bins).numpy()
        np.testing.assert_array_equal(
            t, (1.0 - t_entropy.inverse_entropy_upper(_t(h), bins)).numpy())
        np.testing.assert_allclose(
            t, _np(j_entropy.inverse_entropy_lower(jnp.asarray(h), bins)), rtol=0, atol=5e-7)
        assert (t <= 0.5).all() and (t >= 0.0).all()


# ---------------------------------------------------------------- combine --


def test_combine_probabilities_match():
    rng = np.random.default_rng(1)
    n, p, f = 300, 3, 4
    auc = rng.uniform(0.55, 0.95, size=(p, f)).astype(np.float32)
    jp = j_combine.default_combine_params(jnp.asarray(auc))
    tp = t_combine.default_combine_params(_t(auc))
    np.testing.assert_allclose(tp.weights.numpy(), _np(jp.weights), rtol=TRANSCENDENTAL_RTOL)
    probs = rng.uniform(size=(n, p, f)).astype(np.float32)
    mask = rng.uniform(size=(n, p, f)) < 0.5
    mask[:10] = False  # empty state -> prior
    for prior in (0.5, 0.3):
        j = j_combine.combine_probabilities(jp, jnp.asarray(probs), jnp.asarray(mask), prior)
        t = t_combine.combine_probabilities(tp, _t(probs), _t(mask), prior)
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=TRANSCENDENTAL_RTOL, atol=1e-7)
        np.testing.assert_array_equal(t.numpy()[:10], np.float32(prior))


def test_fit_combine_weights_matches():
    probs, labels = _train()
    j = j_combine.fit_combine_weights(jnp.asarray(probs), jnp.asarray(labels), steps=60)
    t = t_combine.fit_combine_weights(_t(probs), _t(labels), steps=60)
    for name in ("weights", "bias", "rho"):
        np.testing.assert_allclose(
            getattr(t, name).numpy(), _np(getattr(j, name)), rtol=0, atol=LEARNED_ATOL
        )


def test_calibrate_and_apply_platt_match():
    """Overconfident scores (the reference's own Platt test), numpy-made."""
    rng = np.random.default_rng(4)
    n = 4096
    y = (rng.uniform(size=n) < 0.4).astype(np.float32)
    raw = (1 / (1 + np.exp(-(6.0 * (2 * y - 1) + 3.0 * rng.normal(size=n))))).astype(np.float32)
    ja, jb = j_combine.calibrate_platt(jnp.asarray(raw), jnp.asarray(y))
    ta, tb = t_combine.calibrate_platt(_t(raw), _t(y))
    np.testing.assert_allclose([float(ta), float(tb)], [float(ja), float(jb)], rtol=0,
                               atol=PLATT_ATOL)
    got = t_combine.apply_platt(_t(raw), ta, tb).numpy()
    want = _np(j_combine.apply_platt(jnp.asarray(raw), ja, jb))
    np.testing.assert_allclose(got, want, rtol=TRANSCENDENTAL_RTOL, atol=PLATT_ATOL)

    def nll(p):
        p = np.clip(p.astype(np.float64), 1e-6, 1 - 1e-6)
        return -np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))

    assert nll(got) < nll(raw)


def test_auc_score_matches():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=500).astype(np.float32)
    labels = rng.uniform(size=500) < 0.4
    np.testing.assert_allclose(
        float(t_combine.auc_score(_t(scores), _t(labels))),
        float(j_combine.auc_score(jnp.asarray(scores), jnp.asarray(labels))),
        rtol=TRANSCENDENTAL_RTOL,
    )


# --------------------------------------------------------- decision table --


def test_fallback_table_bit_identical_and_lookups_exact():
    p, f = 3, 4
    auc = np.linspace(0.6, 0.9, f).astype(np.float32)
    jt = j_dt.fallback_decision_table(p, f, jnp.asarray(auc))
    tt = t_dt.fallback_decision_table(p, f, _t(auc))
    np.testing.assert_array_equal(tt.next_fn.numpy(), _np(jt.next_fn))
    np.testing.assert_array_equal(tt.delta_h.numpy(), _np(jt.delta_h))
    np.testing.assert_array_equal(tt.delta_h_all.numpy(), _np(jt.delta_h_all))
    np.testing.assert_array_equal(t_dt.enumerate_states(f), j_dt.enumerate_states(f))
    rng = np.random.default_rng(3)
    pred = rng.integers(0, p, size=200).astype(np.int32)
    sid = rng.integers(0, 2**f, size=200).astype(np.int32)
    unc = rng.uniform(0, 1, size=200).astype(np.float32)
    jn, jd = jt.lookup(jnp.asarray(pred), jnp.asarray(sid), jnp.asarray(unc))
    tn, td = tt.lookup(_t(pred), _t(sid), _t(unc))
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_array_equal(
        tt.lookup_all(_t(pred), _t(sid), _t(unc)).numpy(),
        _np(jt.lookup_all(jnp.asarray(pred), jnp.asarray(sid), jnp.asarray(unc))),
    )


@pytest.mark.parametrize("cost_normalized", [False, True])
def test_learn_decision_table_matches(cost_normalized):
    probs, labels = _train()
    auc = np.full((2, 3), 0.8, np.float32)
    costs = np.array([0.02, 0.1, 0.6], np.float32)
    jt = j_dt.learn_decision_table(
        jnp.asarray(probs), j_combine.default_combine_params(jnp.asarray(auc)),
        num_bins=10, costs=jnp.asarray(costs), cost_normalized=cost_normalized,
    )
    tt = t_dt.learn_decision_table(
        _t(probs), t_combine.default_combine_params(_t(auc)),
        num_bins=10, costs=_t(costs), cost_normalized=cost_normalized,
    )
    np.testing.assert_allclose(tt.delta_h.numpy(), _np(jt.delta_h), atol=LEARNED_ATOL)
    jall, tall = _np(jt.delta_h_all), tt.delta_h_all.numpy()
    np.testing.assert_array_equal(np.isinf(tall), np.isinf(jall))
    fin = np.isfinite(jall)
    np.testing.assert_allclose(tall[fin], jall[fin], atol=LEARNED_ATOL)
    # the argmin choice is exact wherever the scores' margin exceeds the tolerance
    score = np.where(fin, jall, np.inf)
    if cost_normalized:
        score = score / costs
    srt = np.sort(score, axis=-1)
    with np.errstate(invalid="ignore"):  # inf - inf: no learnable function, a fixed fallback
        margin = np.nan_to_num(srt[..., 1] - srt[..., 0], nan=np.inf)
    clear = margin > 10 * LEARNED_ATOL
    np.testing.assert_array_equal(tt.next_fn.numpy()[clear], _np(jt.next_fn)[clear])
    assert clear.mean() > 0.5


# ------------------------------------------------------------------ query --


def _queries(mod):
    P = mod.Predicate
    return [
        mod.conjunction(P(0, 1), P(1, 2), P(2, 0)),
        mod.compile_query(mod.Or(P(0, 1), P(1, 1))),
        mod.compile_query(mod.Or(P(0, 1), P(0, 2))),  # mutually exclusive
        mod.compile_query(mod.And(P(0, 1), mod.Not(P(2, 3)))),
        mod.compile_query(mod.And(P(0, 1), P(0, 2))),  # exclusive conjuncts -> 0
        mod.compile_query(P(1, 1, "!=")),
    ]


def test_query_compile_and_reindex_match():
    rng = np.random.default_rng(4)
    jqs, tqs = _queries(j_query), _queries(t_query)
    for jq, tq in zip(jqs, tqs):
        assert tq.is_conjunctive == jq.is_conjunctive
        assert [dataclasses.astuple(p) for p in tq.predicates] == [
            dataclasses.astuple(p) for p in jq.predicates
        ]
        pp = rng.uniform(size=(50, tq.num_predicates)).astype(np.float32)
        np.testing.assert_array_equal(tq.evaluate(_t(pp)).numpy(), _np(jq.evaluate(jnp.asarray(pp))))
    jspace = j_query.global_predicate_space(jqs)
    tspace = t_query.global_predicate_space(tqs)
    assert [dataclasses.astuple(p) for p in tspace] == [dataclasses.astuple(p) for p in jspace]
    pg = rng.uniform(size=(50, len(tspace))).astype(np.float32)
    for jq, tq in zip(jqs, tqs):
        jr, tr = j_query.reindex_query(jq, jspace), t_query.reindex_query(tq, tspace)
        np.testing.assert_array_equal(tr.evaluate(_t(pg)).numpy(), _np(jr.evaluate(jnp.asarray(pg))))
    with pytest.raises(ValueError):
        t_query.reindex_query(tqs[0], tspace[:1])
    old = rng.uniform(0, 1, size=40).astype(np.float32)
    old[:5] = 0.0
    args = [rng.uniform(size=40).astype(np.float32), old, rng.uniform(size=40).astype(np.float32)]
    np.testing.assert_array_equal(
        t_query.conjunctive_joint_update(*map(_t, args)).numpy(),
        _np(j_query.conjunctive_joint_update(*map(jnp.asarray, args))),
    )


# ------------------------------------------------------- errors and state --


@pytest.mark.parametrize(
    "name,kw",
    [
        ("CapacityError", dict(used=3, capacity=8, requested=9)),
        ("SlotActiveError", dict(slot=2)),
        ("MeshShrinkError", dict(healthy_chips=3, model_axis=2)),
        ("SubstrateDtypeError", dict(expected="a", got="b", where="w")),
        ("IngestBackpressure", dict(occupied=4, capacity=4, requested=7, policy="block")),
        ("SlotsExhaustedError", dict(used=8, capacity=8, requested=1)),
    ],
)
def test_typed_errors_carry_the_same_payload(name, kw):
    j = getattr(j_errors, name)("msg", **kw)
    t = getattr(t_errors, name)("msg", **kw)
    assert type(t).__mro__[1].__name__ == type(j).__mro__[1].__name__
    assert {k: getattr(t, k) for k in kw} == {k: getattr(j, k) for k in kw}


def test_substrate_helpers_match():
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=(20, 3, 4)) < 0.5
    np.testing.assert_array_equal(
        t_state._pack_state_id(_t(mask)).numpy(), _np(j_state._pack_state_id(jnp.asarray(mask)))
    )
    assert t_state.substrate_hbm_bytes(1 << 20, 4, 4, torch.bfloat16) == (
        j_state.substrate_hbm_bytes(1 << 20, 4, 4, jnp.bfloat16)
    )
    js = j_state.init_substrate(5, 3, 4, prior=0.5, capacity=8)
    ts = t_state.init_substrate(5, 3, 4, prior=0.5, capacity=8)
    np.testing.assert_array_equal(ts.func_probs.numpy(), _np(js.func_probs))
    np.testing.assert_array_equal(
        t_state.row_validity(8, torch.tensor(5, dtype=torch.int32)).numpy(),
        _np(j_state.row_validity(8, jnp.int32(5))),
    )
    x = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_state.pad_axis(_t(x), 9, 0.25, axis=0).numpy(), _np(j_state.pad_axis(jnp.asarray(x), 9, 0.25))
    )
    buf = rng.uniform(size=(10, 3, 4)).astype(np.float32)
    new = rng.uniform(size=(3, 3, 4)).astype(np.float32)
    jb, jn = j_state.ingest_rows(jnp.asarray(buf), jnp.int32(4), jnp.asarray(new))
    tb, tn = t_state.ingest_rows(_t(buf), torch.tensor(4, dtype=torch.int32), _t(new))
    np.testing.assert_array_equal(tb.numpy(), _np(jb))
    assert int(tn) == int(jn) == 7
    with pytest.raises(t_errors.SubstrateDtypeError) as ei:
        t_state.ingest_rows(_t(buf).to(torch.bfloat16), torch.tensor(0, dtype=torch.int32), _t(new))
    assert ei.value.where == "ingest_rows"


def test_interop_round_trips_reference_params_and_tables():
    """The reference's pytrees (as ``jax.device_get`` returns them) go into the
    port's types and back out bit for bit, bf16 leaves included."""
    auc = np.linspace(0.6, 0.9, 4).astype(np.float32)
    jt = jax.device_get(j_dt.fallback_decision_table(3, 4, jnp.asarray(auc)))
    jc = jax.device_get(j_combine.default_combine_params(jnp.asarray(np.tile(auc, (3, 1)))))
    tt = interop.decision_table_from_numpy(jt)
    tc = interop.combine_params_from_numpy(jc)
    for name, back in interop.decision_table_to_numpy(tt).items():
        if name == "num_bins":
            assert back == jt.num_bins
        else:
            np.testing.assert_array_equal(back, np.asarray(getattr(jt, name)))
    for name, back in interop.combine_params_to_numpy(tc).items():
        np.testing.assert_array_equal(back, np.asarray(getattr(jc, name)))
    bf = np.asarray(jnp.asarray(np.linspace(0, 1, 7, dtype=np.float32)).astype(jnp.bfloat16))
    t = interop.to_torch(bf)
    assert t.dtype == torch.bfloat16 and t.shape == (7,)
    np.testing.assert_array_equal(interop.to_numpy(t).view(np.uint16), bf.view(np.uint16))
    assert interop.to_torch(np.float32(2.5)).shape == ()
