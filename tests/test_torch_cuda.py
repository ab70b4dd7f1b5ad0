"""The hand-written CUDA kernels on the card (skipped without an NVIDIA GPU).

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each ``enrich_score`` kernel is held BITWISE against its plain PyTorch
version on the same card tensors — all four outputs — because both round
every f32 op on its own (the kernels are built with ``--fmad=false``); the
single-query kernel also drives a small operator run on the card.  The
flash-attention kernel is held against its plain twin within the reference
tests' tolerances (2e-5 f32, 2e-2 bf16: the online softmax sums in another
order), and a small model-cascade session serves through it on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.combine import default_combine_params
from repro_torch.core.decision_table import fallback_decision_table, learn_decision_table
from repro_torch.core.entropy import binary_entropy
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate, conjunction
from repro_torch.core.session import EngineSession
from repro_torch.core.state import EnrichmentState
from repro_torch.data.synthetic import make_corpus
from repro_torch.kernels.enrich_score import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rows(dev, seed, n, p, f, q, edge=False):
    rng = np.random.default_rng(seed)
    pp = rng.uniform(0.02, 0.98, size=(n, p)).astype(np.float32)
    sid = rng.integers(0, 2**f, size=(n, p)).astype(np.int32)
    if edge:  # h ~ 0 (saturated), h ~ 1 (coin flips), exhausted rows
        pp[: n // 3] = rng.uniform(1e-6, 1e-4, size=(n // 3, p))
        pp[n // 3: 2 * n // 3] = 0.5 + rng.uniform(-1e-5, 1e-5, size=(n // 3, p))
        sid[2 * n // 3:] = 2**f - 1
    joint = rng.uniform(0.0, 1.0, size=(q, n)).astype(np.float32)
    pp_t = torch.from_numpy(pp).to(dev)
    return pp_t, binary_entropy(pp_t), torch.from_numpy(sid).to(dev), torch.from_numpy(joint).to(dev)


def _tables(dev, p, f):
    costs = torch.tensor(np.tile(np.linspace(0.05, 0.9, f), (p, 1)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    corpus = make_corpus(gen, 256, list(range(p)), [1] * p, aucs=[0.6, 0.8, 0.9, 0.95][:f])
    learned = learn_decision_table(corpus.func_probs, default_combine_params(corpus.aucs))
    fallback = fallback_decision_table(p, f, torch.linspace(0.6, 0.9, f))
    return [(t.to(dev), costs.to(dev)) for t in (fallback, learned)]


def _plain(mode, pp, unc, sid, joint, table, costs):
    lut = ops._lut(4096, pp.device)
    if mode == "best":
        return ref.enrich_score_best_ref(pp, unc, sid, joint, table.delta_h_all, costs, lut)
    return ref.enrich_score_table_ref(pp, unc, sid, joint, table.delta_h, table.next_fn, costs, lut)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["table", "best"])
@pytest.mark.parametrize("n,p,f,q,edge", [(130, 3, 4, 5, False), (96, 2, 4, 3, True),
                                          (4099, 4, 4, 8, False), (40, 1, 3, 1, False)])
def test_kernel_matches_plain_bitwise(cuda_device, mode, dtype, n, p, f, q, edge):
    name = ops.KERNELS[mode == "best"]
    for table, costs in _tables(cuda_device, p, f):
        pp, unc, sid, joint = _rows(cuda_device, n, n, p, f, q, edge)
        pp, unc, joint = pp.to(dtype), unc.to(dtype), joint.to(dtype)
        before = ops.LAUNCHES[name]
        out = ops.fused_benefits_batched(pp, unc, sid, joint, table, costs, mode)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] == before + 1
        for a, b in zip(out, _plain(mode, pp, unc, sid, joint, table, costs)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if edge:
            assert (out.next_fn[:, 2 * n // 3:] == -1).all()


@pytest.mark.cuda
def test_wrapper_refuses_bad_operands(cuda_device):
    (table, costs), _ = _tables(cuda_device, 2, 4)
    pp, unc, sid, joint = _rows(cuda_device, 0, 64, 2, 4, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_benefits_batched(pp.t().contiguous().t(), unc, sid, joint, table, costs)
    with pytest.raises(ValueError, match="expected cuda"):
        ops.fused_benefits_batched(pp, unc, sid.cpu(), joint, table, costs)
    with pytest.raises(TypeError, match="dtype"):
        ops.fused_benefits_batched(pp, unc, sid.long(), joint, table, costs)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["best", "table"])
def test_cuda_session_scores_through_the_kernel(cuda_device, mode):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    preds = [Predicate(i, 1) for i in range(4)]
    corpus = make_corpus(gen, 512, list(range(4)), [1] * 4, selectivity=[0.3] * 4)
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:256], combine)
    session = EngineSession(preds, table, combine, corpus.costs, capacity=128, max_capacity=256,
                            max_tenants=4, device=cuda_device,
                            config=EngineConfig(plan_size=16, function_selection=mode))
    st = session.init_state(corpus.func_probs[256:384])
    st, _ = session.admit(st, conjunction(preds[0], preds[1]))
    ops.reset_counts()
    st = session.ingest(st, corpus.func_probs[384:512])
    st, hist = session.run(st, 5, stop_when_exhausted=False)
    name = ops.KERNELS[mode == "best"]
    assert ops.LAUNCHES[name] == 5 and ops.PLAIN_CALLS[name] == 0
    assert st.capacity == 256 and hist[-1].cost_spent > 0


def _single_state(dev, seed, n, p, f):
    """A random single-query state on the card with ~30% of objects in the
    answer (so ~30% are no candidates under the default ~in_answer)."""
    rng = np.random.default_rng(seed)
    pp, unc, sid, joint = _rows(dev, seed, n, p, f, 1)
    mask = (sid[..., None] >> torch.arange(f, device=dev)) & 1
    return EnrichmentState(
        func_probs=torch.full((n, p, f), 0.5, device=dev), exec_mask=mask.bool(),
        pred_prob=pp, uncertainty=unc, joint_prob=joint[0],
        in_answer=torch.from_numpy(rng.uniform(size=n) < 0.3).to(dev),
        cost_spent=torch.zeros((), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,f", [(1, 1, 4), (257, 1, 3), (1000, 3, 4), (4099, 2, 4)])
def test_single_query_kernel_matches_plain_bitwise(cuda_device, n, p, f):
    query = conjunction(*[Predicate(i, 1) for i in range(p)])
    for table, costs in _tables(cuda_device, p, f):
        st = _single_state(cuda_device, n + p, n, p, f)
        before = ops.LAUNCHES["enrich_score_single"]
        out = ops.fused_benefits(st, query, table, costs)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["enrich_score_single"] == before + 1
        lut = ops._lut(4096, cuda_device)
        want = ref.enrich_score_single_ref(st.pred_prob, st.uncertainty, st.state_id(),
                                           st.joint_prob, ~st.in_answer, table.delta_h,
                                           table.next_fn, costs, lut)
        for a, b in zip(out, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.isneginf(out.benefit[st.in_answer]).all()
        pred = torch.arange(p, device=cuda_device)[None, :]
        assert torch.equal(out.cost, costs[pred, out.next_fn.clamp_min(0).long()])  # unfloored
        # the launcher alone writes what the wrapper returns
        raw = tuple(torch.empty_like(x) for x in want)
        from repro_torch.kernels.enrich_score import kernel

        kernel.launch_single(st.pred_prob, st.uncertainty, st.state_id(), st.joint_prob,
                             (~st.in_answer).contiguous(), table.delta_h, table.next_fn,
                             costs, lut, raw)
        torch.cuda.synchronize()
        for a, b in zip(raw, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_single_query_wrapper_refuses_mixed_devices(cuda_device):
    (table, costs), _ = _tables(cuda_device, 2, 4)
    st = _single_state(cuda_device, 0, 64, 2, 4)
    query = conjunction(Predicate(0, 1), Predicate(1, 1))
    with pytest.raises(ValueError, match="expected cuda"):
        ops.fused_benefits(st, query, table, costs.cpu())
    with pytest.raises(ValueError, match="expected cuda"):
        ops.fused_benefits(st, query, table, costs,
                           candidate_mask=torch.ones(64, dtype=torch.bool))


@pytest.mark.cuda
def test_cuda_operator_scores_through_the_single_query_kernel(cuda_device):
    from repro_torch.quickstart import quickstart_operator, quickstart_world

    world = quickstart_world(2048, train_size=512, device="cpu")
    hist = {}
    for device in ("cpu", cuda_device):
        op, st = quickstart_operator(world, fused=True, device=device)
        ops.reset_counts()
        st, hist[str(device)] = op.run(2048, 6, state=st)
        key = "enrich_score_single"
        assert (ops.LAUNCHES if device != "cpu" else ops.PLAIN_CALLS)[key] == 6
        assert not (ops.PLAIN_CALLS if device != "cpu" else ops.LAUNCHES)[key]
    cpu, gpu = hist["cpu"], hist[str(cuda_device)]
    assert [h.answer_size for h in cpu] == [h.answer_size for h in gpu]
    np.testing.assert_allclose([h.cost_spent for h in gpu], [h.cost_spent for h in cpu],
                               rtol=1e-5)


# ------------------------------------------------------------ flash attention --

# b, sq, skv, h, kv, d, causal, window, softcap, kv_len, q_offset_from_kv_len
FA_CASES = [
    (1, 128, 128, 4, 2, 32, True, None, None, None, False),
    (2, 256, 256, 4, 4, 64, True, None, 50.0, None, False),
    (1, 128, 128, 8, 2, 32, True, 48, None, None, False),
    (2, 128, 128, 4, 1, 64, False, None, None, None, False),
    (1, 64, 256, 4, 2, 32, True, None, None, 100, True),  # partial kv_len
    (64, 8, 8, 16, 8, 128, False, None, None, None, True),  # the backbone's shape
    (3, 37, 53, 6, 3, 48, True, 20, 30.0, 41, True),  # ragged tails, D = 48
    (2, 19, 19, 2, 2, 256, True, None, None, None, False),  # D = 256
    (1, 5, 9, 2, 1, 16, True, None, None, 3, True),  # rows with no live key
]


def _fa_inputs(dev, dtype, seed, b, sq, skv, h, kv, d):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
               for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_kernel_matches_plain_twin(cuda_device, case, dtype, tol):
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off = case
    q, k, v = _fa_inputs(cuda_device, dtype, sq * skv + d, b, sq, skv, h, kv, d)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    before = fa_ops.LAUNCHES["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_wrapper_refuses_bad_operands(cuda_device):
    q, k, v = _fa_inputs(cuda_device, torch.float32, 0, 1, 8, 8, 4, 2, 32)
    with pytest.raises(ValueError, match="expected|on cpu|q on"):
        fa_ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple of 16"):
        qq, kk, vv = _fa_inputs(cuda_device, torch.float32, 0, 1, 8, 8, 4, 2, 40)
        fa_ops.flash_attention(qq, kk, vv)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


@pytest.mark.cuda
def test_cuda_cascade_session_runs_the_trunk_through_the_kernel(cuda_device):
    from repro_torch.launch import serve

    session, state, preds, _ = serve.build_cascade_session_server(
        num_objects=64, num_preds=2, max_tenants=3, backbone_arch="qwen3-1.7b", plan_size=16,
        train_size=128, device=cuda_device)
    bank = session.bank
    ops.reset_counts()
    fa_ops.reset_counts()
    trunk0 = bank.trunk_runs
    report = serve.serve_session_trace(session, state, serve.parse_trace(
        "admit:2;run:8;admit:1;run:8"), preds=preds)
    trunk_epochs = bank.trunk_runs - trunk0
    assert report.epochs == 16 and trunk_epochs > 0
    # the reduced trunk has 2 layers: one flash launch per layer per trunk epoch
    assert fa_ops.LAUNCHES["flash_attention"] == 2 * trunk_epochs
    assert ops.LAUNCHES["enrich_score_best"] == 16
    assert not fa_ops.PLAIN_CALLS["flash_attention"] and not any(ops.PLAIN_CALLS.values())
    probs = report.state.substrate.func_probs
    assert torch.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()
