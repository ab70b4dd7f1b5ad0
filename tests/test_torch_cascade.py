"""Model-cascade bank and session parity: the port vs the JAX package on the CPU.

Banks are built by the reference (``tests/test_cascade_fused.py``'s
fixtures, or its cascade server) and carried into the port with
``repro_torch.interop``.  The port's forwards run the trunk's attention
(qwen3) or SSD (mamba2) through the ``"kernel"`` route (its plain twin
here); the reference's run its ``"auto"`` (dense) engine.  Tolerances:

* probabilities, f32 trunk or probes: atol 1e-5 (the reference's own
  fused-vs-host contract; matmul sums run in another order);
* probabilities, bf16 trunk: atol 2e-3 (bf16 rounds at other places in the
  dense and the flash route: the reference rounds the softmax to bf16 before
  P.V, the flash route keeps it in f32);
* the session: plans, merged plans and answer sets EXACT epoch by epoch;
  spend and per-tenant attribution within rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_cascade_fused import FEATURE_DIM, _probe_bank, _random_plan

from repro.configs.archs import get_config as j_get_config
from repro.core import conjunction as j_conjunction
from repro.enrich import cascade as j_cascade
from repro.launch import serve as j_serve
from repro_torch import interop
from repro_torch.configs.archs import get_config
from repro_torch.core.combine import default_combine_params
from repro_torch.core.decision_table import fallback_decision_table
from repro_torch.core.executor import EngineConfig, EpochProgram
from repro_torch.core.plan import Plan
from repro_torch.core.query import Predicate, conjunction
from repro_torch.core.session import EngineSession
from repro_torch.enrich import cascade
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve
from test_torch_threads import one_torch_thread  # noqa: F401

PROB_ATOL = {"float32": 1e-5, "bfloat16": 2e-3}
SUM_RTOL = 1e-5


def _port_plan(plan) -> Plan:
    return Plan(*(torch.from_numpy(np.array(getattr(plan, k))).to(
        torch.bool if k == "valid" else torch.float32 if k in ("cost", "benefit") else torch.int64)
        for k in Plan._fields))


def _port_bank(jbank):
    return interop.cascade_bank_from_numpy(jbank.cascades, np.asarray(jbank.features))


def _backbone_jbank(dtype, num_preds=2, n=24, seed=0, arch="qwen3-1.7b"):
    cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    suite = j_cascade.build_cascade_suite(jax.random.PRNGKey(seed), num_preds, FEATURE_DIM,
                                          backbone_cfg=cfg)
    feats = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, FEATURE_DIM))
    return j_cascade.ModelCascadeBank(cascades=suite, features=feats)


@pytest.mark.parametrize("kind", ["single_query", "partial", "empty"])
def test_probe_bank_execute_matches_jax(kind):
    """Merged deduplicated plans of a real session: the session test below."""
    jbank = _probe_bank(seed=3)
    m = 40 if kind != "single_query" else 16
    jplan = _random_plan(jbank, m=m, seed=5, all_invalid=kind == "empty")
    if kind == "single_query":  # one query's plan: every lane valid, no duplicates
        jplan = jplan._replace(valid=jnp.ones(m, bool),
                               object_idx=jnp.arange(m, dtype=jnp.int32) % 48)
    bank, plan = _port_bank(jbank), _port_plan(jplan)
    want = np.asarray(jbank.execute(jplan))
    for got in (bank.execute(plan), bank.execute_host(plan)):
        assert got.dtype == torch.float32 and got.shape == (plan.valid.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL["float32"], rtol=0)
    assert torch.all(bank.execute(plan)[~plan.valid] == 0.5)
    assert bank.bank_syncs == 0  # no backbone level, no host read


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_bank_execute_matches_jax(dtype):
    jbank = _backbone_jbank(dtype)
    jplan = _random_plan(jbank, m=24, seed=1)
    bank, plan = _port_bank(jbank), _port_plan(jplan)
    trunk = bank.cascades[0][2].params[0]
    assert all(c[2].params[0] is trunk for c in bank.cascades)  # still ONE trunk
    fa_ops.reset_counts()
    fused, host = bank.execute(plan), bank.execute_host(plan)
    want = np.asarray(jbank.execute(jplan))
    np.testing.assert_allclose(fused.numpy(), want, atol=PROB_ATOL[dtype], rtol=0)
    np.testing.assert_allclose(host.numpy(), want, atol=PROB_ATOL[dtype], rtol=0)
    np.testing.assert_allclose(fused.numpy(), host.numpy(), atol=1e-5, rtol=0)
    # the trunk ran through the flash route (its plain twin on the CPU): once
    # per layer in execute, once per layer and predicate group in execute_host
    groups = {(int(p), int(f)) for p, f, v in zip(plan.pred_idx, plan.func_idx, plan.valid)
              if v and f == 2}
    assert fa_ops.PLAIN_CALLS["flash_attention"] == 2 * (1 + len(groups))
    assert bank.bank_syncs == 1
    # an epoch without backbone lanes skips the trunk after its one host read
    no_bb = plan._replace(valid=plan.valid & (plan.func_idx < 2))
    fa_ops.reset_counts()
    np.testing.assert_allclose(bank.execute(no_bb).numpy(),
                               np.asarray(jbank.execute(jplan._replace(valid=jnp.asarray(
                                   no_bb.valid.numpy())))), atol=1e-5, rtol=0)
    assert fa_ops.PLAIN_CALLS["flash_attention"] == 0 and bank.bank_syncs == 2


ZOO_TRUNKS = ["grok-1-314b", "arctic-480b", "gemma2-9b", "nemotron-4-15b", "h2o-danube-1.8b",
              "seamless-m4t-large-v2", "hymba-1.5b", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", ZOO_TRUNKS)
def test_backbone_bank_over_every_zoo_trunk_matches_jax(arch):
    """A backbone level over each of the model zoo's other trunks (f32
    smoke): the bank carried across (``cascade_bank_from_numpy`` holds its
    FLOP cost, 2 x active parameters x 8 tokens, to the reference's) gives
    the reference's probabilities.  The trunk passes no encoder output, so a
    seamless trunk skips its cross blocks; the MoE aux is dropped."""
    jbank = _backbone_jbank("float32", arch=arch)
    jplan = _random_plan(jbank, m=24, seed=1)
    bank, plan = _port_bank(jbank), _port_plan(jplan)
    level = bank.cascades[0][2]
    cfg = get_config(arch, smoke=True)
    assert level.flops_per_object == 2.0 * cfg.param_counts()["active"] * cascade.N_BACKBONE_TOKENS
    assert level.flops_per_object == float(jbank.cascades[0][2].flops_per_object)
    np.testing.assert_allclose(bank.execute(plan).numpy(), np.asarray(jbank.execute(jplan)),
                               atol=PROB_ATOL["float32"], rtol=0)


def test_bank_to_another_dtype_runs_the_same_weights():
    """``ModelCascadeBank.to(device, dtype=)``: a bf16 bank's trunk run in f32
    is the reference's f32 bank of the same seed (its weights do not depend
    on the activation dtype), with the trunk still shared."""
    jb16, jb32 = _backbone_jbank("bfloat16"), _backbone_jbank("float32")
    bank = _port_bank(jb16).to("cpu", dtype="float32")
    assert {c[2].cfg.dtype for c in bank.cascades} == {"float32"}
    assert all(c[2].params[0] is bank.cascades[0][2].params[0] for c in bank.cascades)
    got = bank.execute(_port_plan(_random_plan(jb16, m=24, seed=1)))
    want = np.asarray(jb32.execute(_random_plan(jb32, m=24, seed=1)))
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL["float32"], rtol=0)


def test_ragged_bank_sentinel_cost_opens_in_quarantine():
    jbank = _probe_bank(num_preds=2, n=24, ragged_pred=0)
    bank = _port_bank(jbank)
    np.testing.assert_array_equal(bank.costs.numpy(), np.asarray(jbank.costs))
    np.testing.assert_array_equal(bank.available.numpy(), np.asarray(jbank.available))
    assert bank.costs[0, 1] == cascade.SENTINEL_COST_S and not bank.available[0, 1]
    aucs = torch.tensor([[0.7, 0.9], [0.7, 0.9]])
    table, combine = fallback_decision_table(2, 2, aucs), default_combine_params(aucs)
    session = EngineSession([Predicate(i, 1) for i in range(2)], table, combine, bank.costs,
                            capacity=24, max_tenants=2, device="cpu", bank=bank)
    np.testing.assert_array_equal(session._initial_quarantine().numpy(), ~bank.available.numpy())
    state = session.init_state(torch.full((24, 2, 2), 0.5))
    assert torch.equal(state.quarantined, ~bank.available)
    # a bank without supports_scan cannot run inside the superstep
    with pytest.raises(ValueError, match="supports_scan"):
        EpochProgram(table, combine, bank.costs, EngineConfig(), bank=object())


def test_backbone_stack_requires_shared_trunk():
    cfg = get_config("qwen3-1.7b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    cascades = [cascade.build_cascade(gen, FEATURE_DIM, backbone_cfg=cfg) for _ in range(2)]
    with pytest.raises(ValueError, match="shared trunk"):
        cascade.ModelCascadeBank(cascades=cascades, features=torch.zeros(8, FEATURE_DIM))
    suite = cascade.build_cascade_suite(gen, 2, FEATURE_DIM, backbone_cfg=cfg)
    bank = cascade.ModelCascadeBank(cascades=suite, features=torch.zeros(8, FEATURE_DIM))
    assert bank.cascades[0][2].params[0] is bank.cascades[1][2].params[0]
    assert bank.costs[0, 2].item() == pytest.approx(
        2.0 * cfg.param_counts()["active"] * cascade.N_BACKBONE_TOKENS / 197e12, rel=1e-6)


@pytest.mark.parametrize("level_idx", [0, 1, 2])
def test_train_level_matches_jax(level_idx):
    """A few descent steps from the same start give the same parameters (the
    backbone head trains through the frozen f32 trunk, dense engine; its
    minimum of 50 steps accumulates f32 reassociation to ~3e-6)."""
    jbank = _backbone_jbank("float32", num_preds=1)
    jlvl = jbank.cascades[0][level_idx]
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((24, FEATURE_DIM)).astype(np.float32)
    labels = rng.random(24) < 0.4
    want = j_cascade.train_level(jlvl, jnp.asarray(feats), jnp.asarray(labels), steps=6)
    lvl = _port_bank(jbank).cascades[0][level_idx]
    got = cascade.train_level(lvl, torch.from_numpy(feats), torch.from_numpy(labels), steps=6)
    w_params = want.params[1] if level_idx == 2 else want.params
    g_params = got.params[1] if level_idx == 2 else got.params
    for k in w_params:
        np.testing.assert_allclose(g_params[k].numpy(), np.asarray(w_params[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    moved = {k: float(np.abs(np.asarray(w_params[k]) - np.asarray(
        (jlvl.params[1] if level_idx == 2 else jlvl.params)[k])).max()) for k in w_params}
    assert max(moved.values()) > 1e-4, moved  # the steps did move the parameters


def test_mamba2_backbone_head_training_matches_jax():
    """The head trains through the frozen mamba2 trunk on the dense SSD
    engine (plain PyTorch, differentiable) as the reference trains through
    its jnp SSD: the same parameters after the minimum of 50 steps."""
    jbank = _backbone_jbank("float32", num_preds=1, arch="mamba2-370m")
    jlvl = jbank.cascades[0][2]
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((24, FEATURE_DIM)).astype(np.float32)
    labels = rng.random(24) < 0.4
    want = j_cascade.train_level(jlvl, jnp.asarray(feats), jnp.asarray(labels), steps=6)
    lvl = _port_bank(jbank).cascades[0][2]
    ssd_ops.reset_counts()
    got = cascade.train_level(lvl, torch.from_numpy(feats), torch.from_numpy(labels), steps=6)
    assert ssd_ops.PLAIN_CALLS["ssd_intra_chunk"] == 0  # the dense engine, not the kernel route
    for k in want.params[1]:
        np.testing.assert_allclose(got.params[1][k].numpy(), np.asarray(want.params[1][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------------- the session --

TRACE = [("admit", (0, 1)), ("admit", (1,)), ("run", 5), ("retire", 0), ("admit", (0,)),
         ("run", 6)]


# the kernel each backbone's trunk runs through (its plain twin here), one
# call per layer of the reduced two-layer trunk
TRUNK_KERNEL = {"qwen3-1.7b": (fa_ops, "flash_attention"),
                "mamba2-370m": (ssd_ops, "ssd_intra_chunk")}


@pytest.fixture(scope="module", params=sorted(TRUNK_KERNEL))
def jax_cascade_server(request):
    """The reference's cascade server (its offline phase trains every level)."""
    return request.param, j_serve.build_cascade_session_server(
        num_objects=48, num_preds=2, max_tenants=3, backbone_arch=request.param, plan_size=16)


def test_cascade_session_matches_jax_epoch_by_epoch(jax_cascade_server):
    arch, (js, jst, jpreds, _) = jax_cascade_server
    kernel_ops, kernel_name = TRUNK_KERNEL[arch]
    bank = _port_bank(js.bank)
    preds = [Predicate(i, 1) for i in range(2)]
    ts, tst = serve.open_cascade_session(
        preds, bank, interop.combine_params_from_numpy(jax.device_get(js.combine_params)),
        interop.decision_table_from_numpy(jax.device_get(js.table)), max_tenants=3,
        plan_size=16, device="cpu")
    np.testing.assert_array_equal(ts.costs.numpy(), np.asarray(js.costs))
    j_plan_part = jax.jit(js.program._plan_part)
    epochs = trunk_epochs = checked = 0
    for kind, arg in TRACE:
        if kind == "admit":
            jst, js_slot = js.admit(jst, j_conjunction(*[jpreds[c] for c in arg]))
            tst, ts_slot = ts.admit(tst, conjunction(*[preds[c] for c in arg]))
            assert ts_slot == js_slot
        elif kind == "retire":
            jst, tst = js.retire(jst, arg), ts.retire(tst, arg)
        else:
            for _ in range(arg):
                jplans, jmerged, _ = j_plan_part(jst)
                tplans, tmerged, _ = ts.program._plan_part(tst)
                for a, b in ((tplans, jplans), (tmerged, jmerged)):
                    v = a.valid.numpy()
                    np.testing.assert_array_equal(v, np.asarray(b.valid))
                    for x, y in zip(a[:3], b[:3]):
                        np.testing.assert_array_equal(np.where(v, x.numpy(), -1),
                                                      np.where(v, np.asarray(y), -1))
                trunk_epoch = bool((tmerged.valid & (tmerged.func_idx == 2)).any())
                if epochs == 0 or (trunk_epoch and trunk_epochs == 0):
                    # the bank on this epoch's REAL merged deduplicated plan
                    want = np.asarray(js.bank.execute(jmerged))
                    for got in (bank.execute(tmerged), bank.execute_host(tmerged)):
                        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                                   atol=PROB_ATOL["bfloat16"])
                    checked += 1
                trunk_epochs += trunk_epoch
                jst, (jh,) = js.run(jst, 1, collect_masks=True, stop_when_exhausted=False)
                kernel_ops.reset_counts()
                tst, (th,) = ts.run(tst, 1, collect_masks=True, stop_when_exhausted=False)
                # the trunk (2 layers) ran through the kernel route iff the plan
                # held a backbone lane
                assert kernel_ops.PLAIN_CALLS[kernel_name] == 2 * trunk_epoch
                np.testing.assert_array_equal(th.answer_mask, jh.answer_mask)
                assert th.answer_size == jh.answer_size and th.merged_valid == jh.merged_valid
                np.testing.assert_allclose(th.cost_spent, jh.cost_spent, rtol=SUM_RTOL)
                np.testing.assert_allclose(th.attributed, jh.attributed, rtol=SUM_RTOL, atol=1e-12)
                epochs += 1
    assert epochs == 11 and trunk_epochs >= 2, trunk_epochs
    assert ts.superstep_traces <= ts.retrace_bound
    assert bank.bank_syncs == epochs + checked  # one host read per execute


def test_port_cascade_server_serves_a_churn_trace_on_cpu():
    fa_ops.reset_counts()
    session, state, preds, qualities = serve.build_cascade_session_server(
        num_objects=64, num_preds=2, max_tenants=3, backbone_arch="qwen3-1.7b", plan_size=16,
        train_size=128, device="cpu")
    assert len(qualities) == 2 and all(0.0 <= q <= 1.0 for qs in qualities for q in qs)
    report = serve.serve_session_trace(session, state, serve.parse_trace(
        "admit:2;run:6;admit:1;run:4;retire:0;run:3"), preds=preds)
    # one chunk program per distinct run length (6, 4, 3) on the one tier
    assert report.epochs == 13 and report.superstep_traces == len(report.scan_lengths) == 3
    assert session.bank.bank_syncs == 13
    spent = [h.cost_spent for h in report.history]
    assert spent[-1] > 0 and all(b >= a for a, b in zip(spent, spent[1:]))
    st = report.state
    acc = np.float32(np.float32(st.ledger.archived) + np.float32(st.ledger.unattributed))
    for b in st.ledger.bills(st.cost_spent):
        acc = np.float32(acc + b)
    assert acc == np.float32(st.cost_spent)  # the invoices fold to cost_spent bit for bit
    probs = st.substrate.func_probs
    assert torch.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()
    with pytest.raises(SystemExit):
        serve.main(["--session", "--bank", "cascade", "--device", "cpu", "--trace",
                    "admit:1;ingest:4;run:1"])


def test_port_cascade_server_serves_with_a_mamba2_backbone_on_cpu():
    ssd_ops.reset_counts()
    fa_ops.reset_counts()
    rc = serve.main(["--session", "--bank", "cascade", "--backbone", "mamba2-370m", "--device",
                     "cpu", "--objects", "64", "--preds", "2", "--max-tenants", "3",
                     "--trace", "admit:2;run:6;admit:1;run:10;retire:0;run:6"])
    assert rc == 0
    assert not fa_ops.PLAIN_CALLS["flash_attention"]  # an attention-free trunk
    # head training ran the dense engine; the offline phase's evaluation and
    # the session's trunk epochs ran the kernel route, 2 layers a forward
    calls = ssd_ops.PLAIN_CALLS["ssd_intra_chunk"]
    assert calls > 0 and calls % 2 == 0, calls
