"""Planning, ledger, answers and substrate writes: the port vs ``repro.core``.

Parity contract: plans, merged plans, want-bits, answer masks, substrate
bits and probabilities are compared EXACTLY (integer order contracts; the
same f32 values move).  Sums over lanes or rows (``cost_spent``, per-slot
attribution, E(F)) accumulate in another order than XLA's reductions — the
port's E(F) prefix sums in f64 — so they carry rtol 1e-6, and the port's own
invoices still reconcile with its ``cost_spent`` bit for bit.  One answer
set is held to exact arithmetic instead of to the reference, whose f32
prefix sums decide it by rounding (ROADMAP.md queue 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import benefit as j_benefit
from repro.core import executor as j_exec
from repro.core import ledger as j_ledger
from repro.core import plan as j_plan
from repro.core import state as j_state
from repro.core import threshold as j_thr
from repro_torch import interop
from repro_torch.core import benefit as t_benefit
from repro_torch.core import executor as t_exec
from repro_torch.core import ledger as t_ledger
from repro_torch.core import plan as t_plan
from repro_torch.core import state as t_state
from repro_torch.core import threshold as t_thr
from test_torch_threads import one_torch_thread  # noqa: F401

SUM_RTOL = 1e-6


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return interop.to_torch(np.asarray(x))


def _benefits(seed, lead, n, p, f=4, levels=None):
    """numpy TripleBenefits leaves; ``levels`` quantizes benefits to force ties."""
    rng = np.random.default_rng(seed)
    shape = (*lead, n, p)
    ben = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    if levels:
        ben = (np.floor(ben * levels) / levels).astype(np.float32)
    nf = rng.integers(-1, f, size=shape).astype(np.int32)
    ben[nf < 0] = -np.inf
    ben[rng.uniform(size=shape) < 0.2] = -np.inf
    est = rng.uniform(size=shape).astype(np.float32)
    cost = rng.choice(np.float32([0.25, 0.5, 1.0]), size=shape).astype(np.float32)
    return ben, nf, est, cost


def _plans_equal(tp, jp, lanes="all"):
    """Compare plans: every lane, or valid lanes only (after canonicalizing)."""
    if lanes == "valid":
        tp = t_plan.canonicalize_plan(tp)
        jp = j_plan.canonicalize_plan(jp)
    for name in ("object_idx", "pred_idx", "func_idx", "benefit", "cost", "valid"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), _np(getattr(jp, name)).astype(getattr(tp, name).numpy().dtype),
            err_msg=name,
        )


# ------------------------------------------------------------------ plans --


@pytest.mark.parametrize("budget", [None, 4.0])
def test_select_plan_tie_order(budget):
    """Quantized benefits tie often: order is benefit desc, flat index asc."""
    leaves = _benefits(0, (), 60, 3, levels=4)
    j = j_plan.select_plan(j_benefit.TripleBenefits(*map(jnp.asarray, leaves)), 40, budget)
    t = t_plan.select_plan(t_benefit.TripleBenefits(*map(_t, leaves)), 40, budget)
    _plans_equal(t, j)
    assert len(np.unique(leaves[0][np.isfinite(leaves[0])])) < 10  # ties were exercised


def test_select_plans_batched_sharded_matches():
    leaves = _benefits(1, (3,), 64, 2, levels=8)
    for shards in (1, 2):
        j = j_exec.select_plans_batched(
            j_benefit.TripleBenefits(*map(jnp.asarray, leaves)), 16, shards, 2
        )
        t = t_exec.select_plans_batched(t_benefit.TripleBenefits(*map(_t, leaves)), 16, shards, 2)
        _plans_equal(t, j, lanes="valid")


def test_merge_sharded_plans_exact_two_shards():
    leaves = _benefits(2, (2,), 32, 3, levels=4)  # shard-major halves of 64 objects
    jl = jax.vmap(lambda *x: j_plan.select_plan(j_benefit.TripleBenefits(*x), 20))(
        *map(jnp.asarray, leaves)
    )
    jl = jl._replace(object_idx=jl.object_idx + jnp.arange(2, dtype=jnp.int32)[:, None] * 32)
    plans_np = [_np(x) for x in jl]
    j = j_plan.merge_sharded_plans_exact(j_plan.Plan(*map(jnp.asarray, plans_np)), 20, 3)
    t = t_plan.merge_sharded_plans_exact(
        t_plan.Plan(*(_t(x.astype(np.int64) if x.dtype == np.int32 else x) for x in plans_np)), 20, 3
    )
    _plans_equal(t, j, lanes="valid")
    # ... and equal to the unsharded selection over the concatenated matrix
    whole = [np.concatenate(list(x), axis=0) for x in leaves]
    u = t_plan.select_plan(t_benefit.TripleBenefits(*map(_t, whole)), 20)
    _plans_equal(t_plan.canonicalize_plan(t), j_plan.canonicalize_plan(
        j_plan.Plan(*(jnp.asarray(x.numpy()) for x in u))), lanes="all")


@functools.lru_cache(maxsize=None)
def _slot_plans(slots=33, k=12, n=20, p=2, f=3):
    """[S, K] plans over a small triple space, so many slots share triples."""
    rng = np.random.default_rng(3)
    obj = rng.integers(0, n, size=(slots, k)).astype(np.int32)
    prd = rng.integers(0, p, size=(slots, k)).astype(np.int32)
    fn = rng.integers(0, f, size=(slots, k)).astype(np.int32)
    # one slot's plan never holds a triple twice (select_plan's distinct lanes)
    for s in range(slots):
        key = (obj[s] * p + prd[s]) * f + fn[s]
        _, first = np.unique(key, return_index=True)
        dup = np.ones(k, bool)
        dup[first] = False
        obj[s, dup] = n - 1 - np.arange(dup.sum()) % n
        fn[s, dup] = -1
    ben = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), size=(slots, k)).astype(np.float32)
    valid = (fn >= 0) & (rng.uniform(size=(slots, k)) < 0.9)
    ben[~valid] = -np.inf
    cost = rng.choice(np.float32([0.25, 0.5]), size=(slots, k)).astype(np.float32)
    return obj, prd, fn, ben, cost, valid


def _both_plans(arrays):
    j = j_plan.Plan(*map(jnp.asarray, arrays))
    t = t_plan.Plan(*(_t(a.astype(np.int64) if a.dtype == np.int32 else a) for a in arrays))
    return j, t


@pytest.mark.parametrize("capacity,budget", [(None, None), (64, None), (None, 20.0)])
def test_merge_plans_dedup_wants_two_words(capacity, budget):
    """33 slots: want-bits span two 32-bit words."""
    j, t = _both_plans(_slot_plans())
    jm, jw = j_plan.merge_plans_dedup_wants(j, 2, 3, num_slots=33, capacity=capacity,
                                            cost_budget=budget, num_objects=20)
    tm, tw = t_plan.merge_plans_dedup_wants(t, 2, 3, num_slots=33, capacity=capacity,
                                            cost_budget=budget, num_objects=20)
    _plans_equal(tm, jm)
    assert tw.shape == (jw.shape[0], 2) and tw.dtype == torch.int64
    np.testing.assert_array_equal(tw.numpy(), _np(jw).astype(np.int64))
    assert (tw.numpy()[:, 1] != 0).any()  # slot 32 lives in the second word
    _plans_equal(t_plan.merge_plans_dedup(t, 2, 3, capacity, budget, 20),
                 j_plan.merge_plans_dedup(j, 2, 3, capacity, budget, 20))
    np.testing.assert_array_equal(
        t_ledger.want_matrix(tw, 33).numpy(), _np(j_ledger.want_matrix(jw, 33))
    )


def test_quarantine_filter_and_gather_idx_match():
    j, t = _both_plans(_slot_plans())
    jm, _ = j_plan.merge_plans_dedup_wants(j, 2, 3)
    tm, _ = t_plan.merge_plans_dedup_wants(t, 2, 3)
    q = np.zeros((2, 3), bool)
    q[1, 2] = q[0, 0] = True
    _plans_equal(t_plan.quarantine_filter(tm, _t(q)), j_plan.quarantine_filter(jm, jnp.asarray(q)))
    np.testing.assert_array_equal(
        t_plan.gather_object_idx(tm, 20).numpy(), _np(j_plan.gather_object_idx(jm, 20))
    )


# ----------------------------------------------------------------- ledger --


def test_attribute_epoch_and_bills_reconcile():
    j, t = _both_plans(_slot_plans())
    jm, jw = j_plan.merge_plans_dedup_wants(j, 2, 3, num_slots=40)
    tm, tw = t_plan.merge_plans_dedup_wants(t, 2, 3, num_slots=40)
    rng = np.random.default_rng(4)
    cost = rng.uniform(0.01, 1.0, size=tm.cost.shape).astype(np.float32)  # non-dyadic
    jm, tm = jm._replace(cost=jnp.asarray(cost)), tm._replace(cost=_t(cost))
    charge = rng.uniform(size=cost.shape) < 0.8
    jl = j_ledger.attribute_epoch(j_ledger.init_ledger(40), jm, jw, jnp.asarray(charge))
    tl = t_ledger.attribute_epoch(t_ledger.init_ledger(40), tm, tw, _t(charge))
    tl = t_ledger.attribute_epoch(tl, tm, tw, _t(~charge))
    jl = j_ledger.attribute_epoch(jl, jm, jw, jnp.asarray(~charge))
    np.testing.assert_array_equal(tl.wanted.numpy(), _np(jl.wanted))
    for name in ("attributed", "triples", "unattributed"):
        np.testing.assert_allclose(getattr(tl, name).numpy(), _np(getattr(jl, name)),
                                   rtol=SUM_RTOL, atol=1e-7)
    spent = np.float32(0)
    for c in np.where(tm.valid.numpy(), cost, 0).tolist() * 2:
        spent = np.float32(spent + np.float32(c))
    bills = tl.bills(torch.tensor(spent))
    acc = np.float32(np.float32(tl.archived) + np.float32(tl.unattributed))
    for b in bills:
        acc = np.float32(acc + b)
    assert acc == spent  # invoices fold to cost_spent bitwise
    reset = t_ledger.reset_slot(tl, 3)
    jreset = j_ledger.reset_slot(jl, 3)
    assert float(reset.attributed[3]) == 0.0 and int(reset.wanted[3]) == 0
    np.testing.assert_allclose(float(reset.archived), float(jreset.archived), rtol=SUM_RTOL)
    assert t_ledger.migrate_ledger(tl, 40) is tl
    with pytest.raises(ValueError):
        t_ledger.migrate_ledger(tl, 41)


# ---------------------------------------------------------------- answers --


def test_select_answer_tie_rule():
    rng = np.random.default_rng(5)
    joint = (np.floor(rng.uniform(size=(4, 200)) * 6) / 6).astype(np.float32)  # heavy ties
    joint[3] = 0.0  # an idle slot
    j = jax.vmap(j_thr.select_answer)(jnp.asarray(joint))
    t = t_thr.select_answer(_t(joint))
    np.testing.assert_array_equal(t.mask.numpy(), _np(j.mask))
    np.testing.assert_array_equal(t.size.numpy(), _np(j.size))
    np.testing.assert_array_equal(t.threshold.numpy(), _np(j.threshold))
    for name in ("expected_f", "expected_precision", "expected_recall"):
        np.testing.assert_allclose(getattr(t, name).numpy(), _np(getattr(j, name)),
                                   rtol=SUM_RTOL)
    s = rng.uniform(size=300).astype(np.float32)
    np.testing.assert_allclose(
        t_thr.expected_f_curve(_t(np.sort(s)[::-1].copy())).numpy(),
        _np(j_thr.expected_f_curve(jnp.asarray(np.sort(s)[::-1]))), rtol=SUM_RTOL,
    )
    ja, ta = j_thr.select_answer_approx(jnp.asarray(s)), t_thr.select_answer_approx(_t(s))
    np.testing.assert_array_equal(ta.mask.numpy(), _np(ja.mask))
    assert float(ta.threshold) == float(ja.threshold)


def test_expected_f_of_mask_matches():
    """Eq. 6 over arbitrary masks: random, empty, full, a block of tied
    joints, and a [Q, N] batch (summed over every element, as the reference
    sums); f32 sums in another order: SUM_RTOL."""
    rng = np.random.default_rng(8)
    joint = rng.uniform(size=500).astype(np.float32)
    joint[100:300] = np.float32(0.375)  # a tied block
    tied = joint == np.float32(0.375)
    masks = [rng.uniform(size=500) < 0.3, np.zeros(500, bool), np.ones(500, bool), tied,
             tied | (joint > 0.9)]
    for alpha in (1.0, 0.5):
        for mask in masks:
            t = t_thr.expected_f_of_mask(_t(joint), _t(mask), alpha)
            j = j_thr.expected_f_of_mask(jnp.asarray(joint), jnp.asarray(mask), alpha)
            assert t.dtype == torch.float32
            np.testing.assert_allclose(float(t), float(j), rtol=SUM_RTOL)
        assert float(t_thr.expected_f_of_mask(_t(joint), _t(masks[1]), alpha)) == 0.0
    batch = rng.uniform(size=(3, 200)).astype(np.float32)
    bmask = rng.uniform(size=(3, 200)) < 0.5
    np.testing.assert_allclose(
        float(t_thr.expected_f_of_mask(_t(batch), _t(bmask))),
        float(j_thr.expected_f_of_mask(jnp.asarray(batch), jnp.asarray(bmask))), rtol=SUM_RTOL)
    # the selected answer's own E(F), through the mask
    sel = t_thr.select_answer(_t(joint))
    np.testing.assert_allclose(float(t_thr.expected_f_of_mask(_t(joint), sel.mask)),
                               float(sel.expected_f), rtol=SUM_RTOL)


def test_candidate_mask_and_restrict_match():
    rng = np.random.default_rng(6)
    s, n, p = 3, 50, 4
    unc = rng.uniform(size=(n, p)).astype(np.float32)
    in_ans = rng.uniform(size=(s, n)) < 0.5
    pm = rng.uniform(size=(s, p)) < 0.6
    pm[:, 0] = True
    rv = np.arange(n) < 37
    for strategy in ("auto", "outside_answer", "all"):
        j = jax.vmap(lambda a, m: j_benefit.candidate_mask(
            jnp.asarray(unc), a, strategy, pred_mask=m, row_valid=jnp.asarray(rv)))(
            jnp.asarray(in_ans), jnp.asarray(pm))
        t = t_benefit.candidate_mask(_t(unc), _t(in_ans), strategy, pred_mask=_t(pm),
                                     row_valid=_t(rv))
        np.testing.assert_array_equal(t.numpy(), _np(j))
    np.testing.assert_array_equal(
        t_benefit.candidate_mask(_t(unc), _t(in_ans[0]), "auto").numpy(),
        _np(j_benefit.candidate_mask(jnp.asarray(unc), jnp.asarray(in_ans[0]), "auto")),
    )
    vals = rng.uniform(size=n).astype(np.float32)
    for valid in (rv, np.ones(n, bool)):
        assert float(t_benefit._masked_median(_t(vals), _t(valid))) == float(
            j_benefit._masked_median(jnp.asarray(vals), jnp.asarray(valid)))
    ben = _benefits(7, (s,), n, p)[0]
    cand = rng.uniform(size=(s, n)) < 0.1
    cand[1] = True
    for plan_size in (5, 400):
        j = jax.vmap(lambda b, c: j_benefit.restrict_benefits(b, c, plan_size))(
            jnp.asarray(ben), jnp.asarray(cand))
        np.testing.assert_array_equal(
            t_benefit.restrict_benefits(_t(ben), _t(cand), plan_size).numpy(), _np(j))


# -------------------------------------------------------------- substrate --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_outputs_invalid_lanes_never_clobber(dtype):
    """Invalid lanes aimed at rows valid lanes also write (row 0 included) and
    out of range: the valid writes land, invalid lanes drop, charging is
    write-once."""
    n, p, f = 12, 2, 3
    rng = np.random.default_rng(8)
    probs0 = rng.uniform(size=(n, p, f)).astype(np.float32)
    mask0 = rng.uniform(size=(n, p, f)) < 0.3
    obj = np.array([0, 0, 5, 5, 11, 3, 12, 0, 7], np.int32)
    prd = np.array([0, 0, 1, 1, 1, 0, 0, 1, 1], np.int32)
    fn = np.array([2, 2, 0, 0, 1, 1, 2, -1, 0], np.int32)
    valid = np.array([1, 0, 0, 1, 1, 1, 0, 0, 1], bool)
    out = rng.uniform(size=obj.shape).astype(np.float32)
    cost = rng.uniform(0.01, 1.0, size=obj.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    js = j_state.SharedSubstrate(jnp.asarray(probs0).astype(jdt), jnp.asarray(mask0),
                                 jnp.float32(1.5))
    ts = t_state.SharedSubstrate(_t(probs0).to(tdt), _t(mask0), torch.tensor(1.5))
    args = (obj, prd, fn)
    jr = j_state.apply_outputs_to_substrate(js, *map(jnp.asarray, args), jnp.asarray(out).astype(jdt),
                                            jnp.asarray(cost), jnp.asarray(valid))
    tr = t_state.apply_outputs_to_substrate(ts, *map(_t, args), _t(out).to(tdt), _t(cost),
                                            _t(valid))
    np.testing.assert_array_equal(tr.func_probs.float().numpy(), _np(jr.func_probs.astype(jnp.float32)))
    np.testing.assert_array_equal(tr.exec_mask.numpy(), _np(jr.exec_mask))
    np.testing.assert_allclose(float(tr.cost_spent), float(jr.cost_spent), rtol=SUM_RTOL)
    np.testing.assert_array_equal(
        t_state.chargeable_mask(ts, *map(_t, args), _t(valid)).numpy(),
        _np(j_state.chargeable_mask(js, *map(jnp.asarray, args), jnp.asarray(valid))),
    )
    assert float(tr.func_probs[0, 0, 2]) == float(torch.tensor(out[0]).to(tdt))
    with pytest.raises(t_state.SubstrateDtypeError):
        t_state.apply_outputs_to_substrate(ts, *map(_t, args), _t(out).to(torch.float64),
                                           _t(cost), _t(valid))


def _exact_answer_size(joint):
    """Theorem-1 prefix length by exact rational arithmetic (first maximum)."""
    from fractions import Fraction

    s = sorted((Fraction(float(x)) for x in joint), reverse=True)
    total, cs, best, arg = sum(s), Fraction(0), None, 0
    for m, x in enumerate(s):
        cs += x
        v = 2 * cs / (total + m + 1)
        if best is None or v > best:
            best, arg = v, m
    return arg + 1


def test_select_answer_flat_tied_block_matches_exact_argmax():
    """A block of tied joints whose E(F) curve is nearly flat: the port's f64
    prefix sums pick the exact argmax; the reference's f32 prefix sums pick a
    prefix decided by rounding (fault logged in ROADMAP.md queue 3)."""
    rng = np.random.default_rng(0)
    hi = rng.uniform(0.6, 1.0, size=rng.integers(50, 400)).astype(np.float32)
    low = rng.uniform(0.0, 0.05, size=1500).astype(np.float32)
    block, s0, m0 = 3000, float(hi.sum()), len(hi)
    b = s0 + float(low.sum()) + m0  # p * (S0 + p*B + L + m0) == S0: flat within the block
    p = np.float32((-b + np.sqrt(b * b + 4 * block * s0)) / (2 * block))
    joint = np.concatenate([hi, np.full(block, p, np.float32), low])
    rng.shuffle(joint)
    exact = _exact_answer_size(joint)
    port = t_thr.select_answer(_t(joint))
    assert int(port.size) == exact == int(port.mask.sum())
    ref = j_thr.select_answer(jnp.asarray(joint))
    assert int(ref.size) != exact  # the reference's answer is decided by f32 rounding
    np.testing.assert_allclose(float(port.expected_f), float(ref.expected_f), rtol=1e-5)
