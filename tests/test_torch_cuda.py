"""The hand-written CUDA kernels on the card (skipped without an NVIDIA GPU).

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each ``enrich_score`` kernel is held BITWISE against its plain PyTorch
version on the same card tensors — all four outputs — because both round
every f32 op on its own (the kernels are built with ``--fmad=false``).
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
from repro_torch.data.synthetic import make_corpus
from repro_torch.kernels.enrich_score import ops, ref


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
