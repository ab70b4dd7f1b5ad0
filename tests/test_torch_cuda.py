"""The hand-written CUDA kernels on the card (skipped without an NVIDIA GPU).

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each ``enrich_score`` kernel is held BITWISE against its plain PyTorch
version on the same card tensors — all four outputs — because both round
every f32 op on its own (the kernels are built with ``--fmad=false``); the
single-query kernel also drives a small operator run on the card, and the
best-mode kernel (templated on F and on P <= 4) is held bitwise over P 1-5,
F 1-8, Q 1-8 and ragged C.  The
flash-attention kernels — "simt", and for bf16 the tensor-core "tc" kernel
(>= 64 query rows, D 64, 80, 128 or 256) and "short" kernel (fewer rows, D
64 or 128), as ``kernel.route`` picks them — are
held against their plain twin within the reference tests' tolerances (2e-5
f32, 2e-2 bf16: the online softmax sums in another order, and the tensor-core
kernels round P to bf16 before P.V), each call counted on its route; the
"split" kernel (at most 8 query rows a kv head over more than 64 keys, D 64
or 128: a cross-attention decode) against its own twin (the shares of the
live keys, then the combine) and the whole-softmax twin; and a
small model-cascade session with a bf16 head_dim-128 trunk serves through
the short kernel on the card, whose probabilities stay within 2x the bf16
CPU run's distance from f32.
The SSD intra-chunk kernels — "tc" (bf16 on the tensor cores, chunks of 64
to 256), "packed" (chunks of 4 to 32) and "simt" — are held against their
plain twin within 1e-4 (f32 products summed over the chunk and the state in
another order, the cumsum scanned in another order; the tc kernel's f32
operands split into bf16 hi + lo lose ~2^-16) on ragged chunks, strided
model-layout operands and both state forms (the tc kernel at N 16 too:
hymba's 50 heads, a ragged head group); the decode partials kernel within
2e-5 (f32 sums in another order), dead splits and an empty cache
included, in both forms — "tc" (bf16 at D 64 / 80 / 128 / 256: P split
into bf16 hi + lo for P.V) and "simt" — and at G 6 / 7 (nemotron, grok-1,
arctic: the simt form in row sub-groups), and the fused decode kernel
within 2e-5 of its twin in f32 and 2e-2 of the oracle in bf16 (bf16 at D
64 / 80 / 128 / 256 on its tensor-core form, each launch counted by form,
the simt form held on the same inputs); the reduced f32 qwen3 and mamba2
models
prefill and decode on the card as on the CPU, and the reduced bf16 ones
(head_dim 128, SSM chunk 256) through the bf16 routes.  The model zoo:
the flash kernels at its non-causal encoder and cross-attention shapes, a
group of 5 heads and head dims 80 / 256 ("tc"), the fused decode at its
groups and head dims, hymba's SSD at state 16; its reduced bf16 gemma2,
h2o-danube, hymba and seamless CPU vs card through those routes; the MoE
smoke models in f32 with the router's choices equal CPU vs card, and the
MoE's top-k keeping ties in index order on the card.  Serving
robustness: a session pipeline's event staging makes no host sync under
``set_sync_debug_mode("error")`` and ends bitwise equal to lockstep; a
pinned, double-buffered ``IngestStream`` feed of eight micro-batches on a
side stream equals direct ingest bitwise; and a checkpoint saved from the
card restores on the CPU bitwise, and back.  Softcaps where they bind (q
drawn x12 / x16 against caps of 30 / 50): the fused decode kernel (tc and
simt forms), the partials kernel, the short, split and simt flash kernels, each
within its tolerance and, without its cap, beyond it.  Training: every
kernel wrapper refuses an input that requires grad on the card too, and
two AdamW steps of the f32 smoke models match the CPU's (losses and grad
norms within rtol 1e-4, parameters within 2 * lr a step and all but 0.1%
within 0.01 * lr).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core.combine import default_combine_params
from repro_torch.core.decision_table import (DecisionTable, fallback_decision_table,
                                              learn_decision_table)
from repro_torch.core.entropy import binary_entropy
from repro_torch.core.executor import EngineConfig
from repro_torch.core.query import Predicate, conjunction
from repro_torch.core.session import EngineSession
from repro_torch.core.state import EnrichmentState
from repro_torch.data.synthetic import make_corpus
from repro_torch.kernels.enrich_score import kernel as es_kernel
from repro_torch.kernels.enrich_score import ops, ref
from repro_torch.kernels.enrich_score.kernel import SMEM_LIMIT
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssm_mixer import ops as ssm_mixer_ops
from repro_torch.kernels.ssm_mixer import ref as ssm_mixer_ref
from repro_torch.launch.serve import state_digests
from _torch_screen_world import SCREEN_KINDS, screen_world
from _torch_ulps import ulps


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


@functools.lru_cache(maxsize=None)
def _best_tables(p, f):
    """(fallback, learned) tables for the best-mode sweep, on the CPU, with
    as many entropy bins (<= 10) as the kernel's shared memory holds."""
    lut_bins = 4096
    bins = min(10, (SMEM_LIMIT // 4 - lut_bins - p * f) // (p * 2**f * f))
    costs = torch.tensor(np.tile(np.linspace(0.05, 0.9, f), (p, 1)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    corpus = make_corpus(gen, 256, list(range(p)), [1] * p, aucs=np.linspace(0.6, 0.95, f),
                         costs=np.linspace(0.05, 0.9, f))
    learned = learn_decision_table(corpus.func_probs, default_combine_params(corpus.aucs),
                                   num_bins=bins)
    fallback = fallback_decision_table(p, f, torch.linspace(0.6, 0.9, f), num_bins=bins)
    return [(t, costs) for t in (fallback, learned)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("f", [1, 3, 4, 8])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
def test_best_kernel_matches_plain_bitwise_over_shapes(cuda_device, p, f, q, n, dtype):
    """The best-mode kernel's forms (one thread an object for P <= 4, one a
    lane for P > 4; F 1-8 unrolled; Q 1, 3 and 8 tenants)
    against the plain version: all four outputs bitwise, learned and
    fallback tables, plain and edge-bin rows."""
    for table, costs in _best_tables(p, f):
        table, costs = table.to(cuda_device), costs.to(cuda_device)
        for edge in (False, True):
            pp, unc, sid, joint = _rows(cuda_device, n + p + f + q, n, p, f, q, edge)
            pp, unc, joint = pp.to(dtype), unc.to(dtype), joint.to(dtype)
            before = ops.LAUNCHES["enrich_score_best"]
            out = ops.fused_benefits_batched(pp, unc, sid, joint, table, costs, "best")
            torch.cuda.synchronize()
            assert ops.LAUNCHES["enrich_score_best"] == before + 1
            for a, b in zip(out, _plain("best", pp, unc, sid, joint, table, costs)):
                assert a.dtype == b.dtype and torch.equal(a, b)
            if edge:
                assert (out.next_fn[:, 2 * n // 3:] == -1).all()


@functools.lru_cache(maxsize=None)
def _default_bin_tables(p, f, dev):
    """(fallback, learned) tables at the default 10 bins on ``dev``, learned
    there (2^F states: F 12 takes most of a minute on a few CPU cores)."""
    costs = torch.tensor(np.tile(np.linspace(0.05, 0.9, f), (p, 1)), dtype=torch.float32)
    gen = torch.Generator().manual_seed(13)
    corpus = make_corpus(gen, 256, list(range(p)), [1] * p, aucs=np.linspace(0.6, 0.95, f),
                         costs=np.linspace(0.05, 0.9, f))
    learned = learn_decision_table(corpus.func_probs.to(dev),
                                   default_combine_params(corpus.aucs).to(dev))
    fallback = fallback_decision_table(p, f, torch.linspace(0.6, 0.9, f))
    return [(t.to(dev), costs.to(dev)) for t in (fallback, learned)]


GLOBAL_CASES = ([("best", p, f, dt) for p in (1, 2, 3, 4, 5) for f in (8, 9, 12)
                 for dt in ("float32", "bfloat16")]
                + [("table", 11, 8, "float32"), ("table", 16, 8, "bfloat16"),
                   ("single", 11, 8, "float32")])
# each side of each mode's crossover (kernel.GLOBAL_FROM): the last ladder
# rung on "smem", the first on "global"
CROSSOVER_SMEM = (("best", 2, 6), ("table", 4, 6), ("single", 4, 5))
CROSSOVER_CASES = [(m, p, f, "float32") for m, p, f in
                   CROSSOVER_SMEM + (("best", 1, 7), ("table", 5, 6), ("single", 3, 6))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,p,f,dtype", GLOBAL_CASES + CROSSOVER_CASES)
def test_global_table_route_matches_plain_bitwise(cuda_device, mode, p, f, dtype):
    """Tables at the default 10 bins that a block's shared memory does not
    hold, that reach the mode's crossover, or best mode past F 8: the
    "global" route (the table read from device memory), and the last shape
    below each crossover on "smem"; all four
    outputs bitwise against the plain version, plain and edge-bin rows, each
    launch counted on the route ``kernel.table_route`` names."""
    name = {"table": "enrich_score_table", "best": "enrich_score_best",
            "single": "enrich_score_single"}[mode]
    route = "smem" if (mode, p, f) in CROSSOVER_SMEM else "global"
    assert es_kernel.table_route(mode, p, 2**f, 10, f, 4096) == route
    other = "smem" if route == "global" else "global"
    dt = getattr(torch, dtype)
    for table, costs in _default_bin_tables(p, f, cuda_device):
        assert table.num_bins == 10
        for edge in (False, True):
            n = 1030  # ragged (not a multiple of 4), thirds for the edge rows
            pp, unc, sid, joint = _rows(cuda_device, n + p + f, n, p, f, 3, edge)
            past8 = mode == "best" and f > 8 and not edge
            if past8:  # functions 0-7 ran on these rows: only the later chunks remain
                sid[: n // 8] = 2**8 - 1
            before = dict(ops.TABLE_ROUTES)
            if mode == "single":
                st = _single_state(cuda_device, n + p + f, n, p, f)
                query = conjunction(*[Predicate(i, 1) for i in range(p)])
                out = ops.fused_benefits(st, query, table, costs)
                want = ref.enrich_score_single_ref(
                    st.pred_prob, st.uncertainty, st.state_id(), st.joint_prob, ~st.in_answer,
                    table.delta_h, table.next_fn, costs, ops._lut(4096, cuda_device))
            else:
                pp, unc, joint = pp.to(dt), unc.to(dt), joint.to(dt)
                out = ops.fused_benefits_batched(pp, unc, sid, joint, table, costs, mode)
                want = _plain(mode, pp, unc, sid, joint, table, costs)
            torch.cuda.synchronize()
            assert ops.TABLE_ROUTES[(name, route)] == before[(name, route)] + 1
            assert ops.TABLE_ROUTES[(name, other)] == before[(name, other)]
            for a, b in zip(out, want):
                assert a.dtype == b.dtype and torch.equal(a, b)
            if past8:
                assert (out.next_fn[:, : n // 8] >= 8).all()
            if edge and mode != "single":
                assert (out.next_fn[:, 2 * n // 3:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,p,f", [(k, p, f) for k in SCREEN_KINDS for p in (1, 4, 5)
                                      for f in (3, 8, 10)]
                         + [("random", p, f) for p in (1, 2, 3, 4, 5) for f in range(9, 17)]
                         + [("random", 1, 20), ("random", 2, 17)])
def test_best_screen_holds_bitwise_on_both_routes(cuda_device, kind, p, f, dtype):
    """The lane kernels' division screen (best mode: one thread a lane, the
    global route and the smem route at P > 4) where it is pressed hardest —
    exact ties, benefits an ulp apart, zero and subnormal joints, pred_prob
    0, every function exhausted — and F 9-16 at P 1-5 (F 9 and 10 on the
    unrolled lane kernels past F 8, F 11-16 on the wide kernel), F 17 and 20
    (the wide kernel):
    all four outputs bitwise against the plain version on each route that
    takes the shape, the wrapper's launch counted on the route
    ``table_route`` names."""
    dt = getattr(torch, dtype)
    pp, unc, sid, joint, delta, costs = screen_world(cuda_device, kind, p, f, dt,
                                                     p * 100 + f * 7 + len(kind))
    lut = ops._lut(4096, cuda_device)
    want = ref.enrich_score_best_ref(pp, unc, sid, joint, delta, costs, lut)
    # best mode reads delta_h_all alone
    table = DecisionTable(next_fn=torch.zeros((p, 1, 1), dtype=torch.int32, device=cuda_device),
                          delta_h=torch.zeros((p, 1, 1), device=cuda_device), delta_h_all=delta,
                          num_bins=delta.shape[2])
    route = es_kernel.table_route("best", p, 2**f, delta.shape[2], f, 4096)
    before = ops.TABLE_ROUTES[("enrich_score_best", route)]
    outs = {route: ops.fused_benefits_batched(pp, unc, sid, joint, table, costs, "best")}
    assert ops.TABLE_ROUTES[("enrich_score_best", route)] == before + 1
    fits = es_kernel.best_smem_bytes(p, 2**f, delta.shape[2], f, 4096) <= SMEM_LIMIT
    if f <= es_kernel.SMEM_MAX_FUNCTIONS and fits:  # the other route, uncounted
        other = "global" if route == "smem" else "smem"
        outs[other] = tuple(torch.empty_like(x) for x in want)
        es_kernel.launch_best(pp, unc, sid, joint, delta, costs, lut, outs[other], other)
    torch.cuda.synchronize()
    for r, out in outs.items():
        for name, a, b in zip(("benefit", "next_fn", "est_joint", "cost"), out, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (r, name)
    if kind == "exhausted":
        assert (want[1] == -1).all()
    if kind == "tie":  # exact ties keep the first remaining function
        first = torch.isfinite(delta[torch.arange(p, device=cuda_device)[None, :], sid.long(),
                                     ref._bins(unc.float(), delta.shape[2])]).int().argmax(-1)
        live = want[1] >= 0
        assert torch.equal(want[1][live], first.to(torch.int32).expand_as(want[1])[live])


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
    # best mode reads an object's [P] row as one vector: a row start off its
    # width (a contiguous view one element into its storage) is refused
    shifted = torch.empty(1 + pp.numel(), device=cuda_device)[1:].view_as(pp).copy_(pp)
    with pytest.raises(ValueError, match="boundary"):
        ops.fused_benefits_batched(shifted, unc, sid, joint, table, costs, "best")


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
        es_kernel.launch_single(st.pred_prob, st.uncertainty, st.state_id(), st.joint_prob,
                                (~st.in_answer).contiguous(), table.delta_h, table.next_fn,
                                costs, lut, raw, "smem")
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
    route = fa_kernel.route(dtype, sq, d, h // kv, skv)
    before, routed = fa_ops.LAUNCHES["flash_attention"], fa_ops.ROUTES[route]
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    assert fa_ops.ROUTES[route] == routed + 1
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


# bf16 cases the tensor-core kernel takes (Sq >= 64, D 64, 80, 128 or 256);
# same columns
FA_TC_CASES = [
    (1, 64, 64, 2, 1, 128, False, None, None, None, False),  # Sq 64, GQA 2
    (1, 128, 128, 4, 1, 64, True, None, None, None, False),  # D 64, GQA 4, causal
    (2, 200, 333, 4, 2, 128, True, 100, 30.0, 300, True),  # ragged; window, softcap, kv_len
    (1, 128, 512, 4, 2, 128, True, None, None, 200, True),  # key tiles 2-3 past kv_len
    (1, 200, 256, 2, 1, 64, True, None, None, 100, True),  # rows 0-99 have no live key
    (2, 128, 300, 4, 2, 128, False, 64, None, None, True),  # window without causal
    (1, 64, 1024, 2, 2, 64, True, 200, 20.0, None, True),  # window + softcap, long cache
    (2, 200, 150, 4, 4, 128, False, None, 50.0, None, False),  # Sq > Skv, softcap
    (3, 384, 384, 16, 4, 128, False, None, None, None, False),  # 144 blocks: the grid wraps
    (2, 512, 512, 8, 4, 128, True, None, None, None, False),  # 64 causal blocks, 4 tiles
    (1, 200, 232, 48, 8, 128, True, None, None, 200, True),  # G 6 (nemotron, grok-1)
    (1, 200, 232, 56, 8, 128, True, None, None, 200, True),  # G 7 (arctic)
    (1, 328, 360, 32, 8, 128, True, None, None, 328, True),  # G 4, a 72-row tail (llava)
    (1, 200, 232, 16, 16, 64, True, None, None, 200, True),  # G 1, causal (seamless)
    (2, 200, 333, 4, 2, 80, True, 100, 30.0, 300, True),  # D 80: zero-padded tiles
    (2, 200, 333, 4, 2, 256, True, 100, 30.0, 300, True),  # D 256: 64-key tiles
    (1, 200, 256, 2, 1, 80, True, None, None, 100, True),  # rows 0-99 have no live key
    (1, 200, 256, 2, 1, 256, True, None, None, 100, True),
    (2, 128, 300, 4, 2, 80, False, 64, 20.0, None, True),  # window without causal
    (2, 512, 512, 8, 4, 256, True, None, None, None, False),  # 8 key tiles through the ring
    (1, 200, 256, 2, 1, 128, True, None, None, 100, True),  # rows 0-99 have no live key
]
# the pipeline's edges at D 64 and 128 (two products in flight in each
# consumer warpgroup, the warpgroups' turns on named barriers)
for _d in (64, 128):
    FA_TC_CASES += [
        (1, 128, 128, 4, 2, _d, False, None, None, None, False),  # 1 live key tile
        (1, 128, 256, 4, 2, _d, False, None, None, None, False),  # 2
        (1, 128, 384, 4, 2, _d, False, None, None, None, False),  # 3
        (1, 200, 200, 4, 2, _d, True, None, None, None, False),  # 8 live rows in warpgroup 1
        # rows 0-139 see no key: query tiles with no live key tile beside tiles with four
        (1, 640, 640, 2, 1, _d, True, None, None, 500, True),
        (1, 64, 256, 4, 2, _d, True, 64, None, None, True),  # the window leaves one tile
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_TC_CASES)
def test_flash_tc_kernel_matches_plain_twin(cuda_device, case):
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off = case
    assert fa_kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "tc"
    q, k, v = _fa_inputs(cuda_device, torch.bfloat16, sq * skv + d, b, sq, skv, h, kv, d)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    fa_ops.reset_counts()
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {"tc": 1, "short": 0, "split": 0, "simt": 0}
    assert fa_ops.LAUNCHES["flash_attention"] == 1
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


# tc cases whose scores reach the softcap: q drawn unit-normal times q_scale,
# so s ~ N(0, q_scale^2) against the cap (|s / cap| up to ~2); same columns,
# then q_scale.  Unit-normal q and k give scores near N(0, 1), which a cap of
# 20-50 barely moves, so only these cases tell a right softcap from none.
FA_TC_CAPPED_CASES = [
    (2, 200, 333, 4, 2, 64, True, 100, 20.0, 300, True, 8.0),
    (2, 200, 333, 4, 2, 64, True, 100, 30.0, 300, True, 12.0),
    (2, 200, 333, 4, 2, 80, True, 100, 30.0, 300, True, 12.0),
    (2, 200, 333, 4, 2, 128, True, 100, 30.0, 300, True, 12.0),
    (2, 200, 333, 4, 2, 256, True, 100, 30.0, 300, True, 12.0),
    (1, 512, 544, 16, 8, 256, True, None, 50.0, 512, True, 16.0),  # gemma2 global, G 2
    (2, 128, 300, 4, 2, 80, False, 64, 20.0, None, True, 8.0),  # window without causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_TC_CAPPED_CASES)
def test_flash_tc_softcap_holds_where_it_binds(cuda_device, case):
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off, q_scale = case
    assert fa_kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "tc"
    q, k, v = _fa_inputs(cuda_device, torch.float32, sq * skv + d, b, sq, skv, h, kv, d)
    q, k, v = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    fa_ops.reset_counts()
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {"tc": 1, "short": 0, "split": 0, "simt": 0}
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    # the control: the same kernel without the cap misses the capped twin
    uncapped = torch.empty_like(q)
    fa_kernel.launch(q, k, v, kl, uncapped, causal=causal, window=window, softcap=None,
                     q_offset_from_kv_len=q_off, kind="tc")
    torch.cuda.synchronize()
    assert not torch.allclose(uncapped.float(), want.float(), rtol=2e-2, atol=2e-2)


# bf16 cases the short kernel takes (Sq < 64, D 64 or 128); same columns
FA_SHORT_CASES = [
    (64, 8, 8, 16, 8, 128, False, None, None, None, True),  # the cascade: G * Sq = 16
    (32, 8, 8, 2, 1, 128, False, None, None, None, False),  # the bf16 check's trunk: G 2
    (16, 8, 8, 8, 4, 64, False, None, None, None, True),  # D 64
    (2, 33, 77, 8, 2, 128, True, 24, 30.0, 60, True),  # G * Sq = 132: ragged last tile
    (2, 33, 77, 8, 2, 64, True, 24, 30.0, 60, True),
    (3, 8, 300, 8, 4, 128, True, 100, None, 250, True),  # G 2: 7 key tiles through the ring
    (2, 63, 63, 2, 2, 64, True, None, None, None, False),  # Sq 63, G 1
    (1, 5, 9, 2, 1, 128, True, None, None, 3, True),  # rows with no live key
    (2, 12, 16, 6, 2, 128, False, 5, 20.0, None, False),  # window without causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_SHORT_CASES)
def test_flash_short_kernel_matches_plain_twin(cuda_device, case):
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off = case
    assert fa_kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "short"
    q, k, v = _fa_inputs(cuda_device, torch.bfloat16, sq * skv + d, b, sq, skv, h, kv, d)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    fa_ops.reset_counts()
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {"tc": 0, "short": 1, "split": 0, "simt": 0}
    assert fa_ops.LAUNCHES["flash_attention"] == 1
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


# bf16 cases the split kernel takes (G * Sq <= 8 rows over > 64 keys, D 64 or
# 128); same columns
FA_SPLIT_CASES = [
    (1, 1, 1024, 16, 16, 64, False, None, None, None, True),  # seamless's cross decode
    (2, 1, 200, 4, 4, 64, False, None, None, None, True),  # a ragged last tile
    (3, 8, 300, 4, 4, 128, True, 100, None, 250, True),  # G 1 x Sq 8: causal rows, window
    (2, 4, 300, 8, 4, 128, True, 100, 30.0, 250, True),  # G 2 x Sq 4, softcap
    (1, 1, 4096, 8, 1, 128, False, None, None, 3000, True),  # G 8, kv_len < Skv
    (4, 2, 777, 16, 4, 64, True, None, None, 700, False),  # G 4 x Sq 2 at positions 0-1
    (1, 8, 256, 1, 1, 64, True, None, None, 4, True),  # rows 0-3 have no live key
    (1, 1, 128, 4, 4, 64, False, None, None, 0, True),  # kv_len 0: every row 0
    (1, 1, 65, 2, 2, 64, False, None, None, None, True),  # 65 keys: one split
    (64, 1, 512, 8, 8, 64, False, 100, None, 400, True),  # 512 (b, kv head)s: one split each
    (2, 2, 999, 6, 2, 128, False, 300, 20.0, None, True),  # G 3 x Sq 2, window without causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_SPLIT_CASES)
def test_flash_split_kernel_matches_plain_twin(cuda_device, case):
    """Within the bf16 tolerance of its own twin (partials over the same
    shares of the live keys, then the combine) and of the whole-softmax
    twin; a row with no live key writes 0."""
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off = case
    assert fa_kernel.route(torch.bfloat16, sq, d, h // kv, skv) == "split"
    q, k, v = _fa_inputs(cuda_device, torch.bfloat16, sq * skv + d + 1, b, sq, skv, h, kv, d)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    fa_ops.reset_counts()
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {"tc": 0, "short": 0, "split": 1, "simt": 0}
    assert fa_ops.LAUNCHES["flash_attention"] == 1
    ns = fa_kernel.split_num_splits(b * kv, skv)
    twin = fa_ops.plain_bshd(q, k, v, kl, num_splits=ns, **kw)
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), twin.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)
    if kv_len is not None and kv_len < sq and q_off:  # rows before key 0: 0
        assert (out[:, :sq - kv_len] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,sq,d", [(torch.float32, 128, 128), (torch.float32, 200, 64),
                                        (torch.float32, 8, 128), (torch.bfloat16, 8, 96),
                                        (torch.bfloat16, 128, 32), (torch.bfloat16, 32, 256)])
def test_flash_f32_short_blocks_and_other_head_dims_take_simt(cuda_device, dtype, sq, d):
    q, k, v = _fa_inputs(cuda_device, dtype, sq + d, 2, sq, sq, 4, 2, d)
    fa_ops.reset_counts()
    out = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {"tc": 0, "short": 0, "split": 0, "simt": 1}
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), fa_ops.plain_bshd(
        q, k, v, None, causal=True, window=None, logit_softcap=None,
        q_offset_from_kv_len=False).float(), rtol=tol, atol=tol)


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
    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve

    # the reduced bf16 qwen3 (head_dim 128, 2 query heads over 1 KV head): 16
    # query rows a (lane, kv head) at 8 tokens, the short kernel's tile
    preds, _, bank, combine, table, _ = serve._offline_phase(
        64, 2, get_config("qwen3-1.7b", bf16_check=True), seed=0, train_size=128,
        device=cuda_device)
    session, state = serve.open_cascade_session(preds, bank, combine, table, max_tenants=3,
                                                plan_size=16, device=cuda_device)
    ops.reset_counts()
    fa_ops.reset_counts()
    trunk0 = bank.trunk_runs
    report = serve.serve_session_trace(session, state, serve.parse_trace(
        "admit:2;run:8;admit:1;run:8"), preds=preds)
    trunk_epochs = bank.trunk_runs - trunk0
    assert report.epochs == 16 and trunk_epochs > 0
    # the reduced trunk has 2 layers: one flash launch per layer per trunk epoch
    assert fa_ops.LAUNCHES["flash_attention"] == 2 * trunk_epochs
    assert fa_ops.ROUTES == {"tc": 0, "short": 2 * trunk_epochs, "split": 0,
                             "simt": 0}  # 8 tokens a lane
    assert ops.LAUNCHES["enrich_score_best"] == 16
    assert not fa_ops.PLAIN_CALLS["flash_attention"] and not any(ops.PLAIN_CALLS.values())
    probs = report.state.substrate.func_probs
    assert torch.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()


def _cascade_plans(n, p, f, dev, lanes=96, count=3, seed=7):
    """Merged plans over every (pred, level) of a cascade bank, a few lanes
    invalid, made with numpy from a seed."""
    from repro_torch.core.plan import Plan

    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(count):
        idx = [torch.from_numpy(rng.integers(0, hi, lanes)).to(dev) for hi in (n, p, f)]
        zero = torch.zeros(lanes, device=dev)
        valid = torch.from_numpy(rng.uniform(size=lanes) < 0.9).to(dev)
        plans.append(Plan(*idx, zero, zero, valid))
    return plans


@pytest.mark.cuda
def test_cuda_bf16_cascade_bank_routes_the_short_kernel(cuda_device):
    """The cascade bank with the reduced bf16 qwen3 trunk (head_dim 128, 2
    query heads over 1 KV head), built on the CPU and copied to the card:
    ``execute`` over the same merged plans on both runs every trunk
    attention through the short kernel, and the card's probabilities stay
    within 2x the bf16 CPU run's own distance from an f32 run of the same
    weights (the two bf16 runs round at other places)."""
    from repro_torch.configs.archs import get_config
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b", bf16_check=True)
    _, _, bank, _, _, _ = serve._offline_phase(128, 3, cfg, seed=0, train_size=128,
                                               device="cpu")
    f32_bank, gpu_bank = bank.to("cpu", dtype="float32"), bank.to(cuda_device)
    plans = _cascade_plans(128, 3, bank.num_levels, "cpu")
    fa_ops.reset_counts()
    gpu = [gpu_bank.execute(pl.map(lambda t: t.to(cuda_device))).cpu() for pl in plans]
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {"tc": 0, "short": cfg.num_layers * len(plans), "split": 0,
                             "simt": 0}, fa_ops.ROUTES
    assert not fa_ops.PLAIN_CALLS["flash_attention"]
    cpu = [bank.execute(pl) for pl in plans]
    ref = [f32_bank.execute(pl) for pl in plans]
    bf16_err = max((c - r).abs().max().item() for c, r in zip(cpu, ref))
    err = max((g - c).abs().max().item() for g, c in zip(gpu, cpu))
    assert 0.0 < bf16_err and err <= 2.0 * bf16_err, (err, bf16_err)
    assert all(torch.isfinite(g).all() and ((g >= 0) & (g <= 1)).all() for g in gpu)


# ------------------------------------------------------------------ SSD ----

# b, s, h, p, n, chunk, dtype, final_state
SSD_CASES = [
    (2, 8, 32, 64, 128, 8, torch.bfloat16, False),  # the cascade's 8 tokens
    (2, 8, 32, 64, 128, 8, torch.float32, True),
    (1, 512, 4, 64, 128, 256, torch.bfloat16, True),  # the prefill chunk
    (2, 100, 3, 20, 12, 50, torch.float32, True),  # ragged tile edges
    (1, 96, 2, 128, 64, 32, torch.float32, False),  # two head-dim blocks
    (3, 64, 2, 16, 16, 16, torch.bfloat16, True),  # the smoke config: a part-filled block
    (1, 12, 5, 8, 8, 4, torch.float32, True),  # 16 heads a block, 5 of them live
    (2, 64, 3, 32, 24, 32, torch.float32, True),
    (1, 512, 50, 64, 16, 256, torch.bfloat16, True),  # hymba's prefill: N 16 on "tc"
    (16, 8, 50, 64, 16, 8, torch.bfloat16, False),  # hymba's cascade trunk: "packed"
]


def _ssd_inputs(dev, dtype, seed, b, s, h, p, n):
    """Model-layout operands: x, B, C slices of one projection, a with a batch
    stride of 0."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    xbc = xbc.to(dev, dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)).to(dev)
    a = -torch.from_numpy(rng.uniform(1.0, 32.0, h).astype(np.float32)).to(dev)
    return x, dt, a[None].expand(b, h), bm, cm


def _ssd_check(args, chunk, final, route):
    """One counted launch on ``route``, every output within 1e-4 of the twin."""
    b, s, h, p = args[0].shape
    before, routes = ssd_ops.LAUNCHES["ssd_intra_chunk"], dict(ssd_ops.ROUTES)
    got = ssd_ops.intra_chunk(*args, chunk=chunk, final_state=final)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_intra_chunk"] == before + 1
    assert ssd_ops.ROUTES[route] == routes[route] + 1, (route, ssd_ops.ROUTES)
    want = ssd_ref.intra_chunk_bshp(*args, chunk=chunk, final_state=final)
    nc = s // chunk
    assert got[1].shape == (b, h, nc if final else nc - 1, p, args[3].shape[2])
    for name, g, w in zip(("y_intra", "s_contrib", "cumexp"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_twin(cuda_device, case):
    b, s, h, p, n, chunk, dtype, final = case
    args = _ssd_inputs(cuda_device, dtype, s + p, b, s, h, p, n)
    _ssd_check(args, chunk, final, ssd_kernel.route(dtype, chunk, p, n))
    y, hf = ssd_ops.ssd_bshp(*args, chunk=chunk, final_state=final)
    assert (hf is not None) == final and torch.isfinite(y).all()


@pytest.mark.cuda
@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("p,n", [(64, 64), (64, 128), (128, 64), (128, 128), (64, 16),
                                 (128, 16)])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_tc_kernel_matches_plain_twin(cuda_device, chunk, p, n, final):
    """The tensor-core route on the model's strided slices, 5 heads (a group
    of 4 and a group of 1; at N 16 groups of heads_a_block(P, 16), the last
    ragged), two chunks."""
    args = _ssd_inputs(cuda_device, torch.bfloat16, chunk + p + n, 2, 2 * chunk, 5, p, n)
    assert ssd_kernel.route(torch.bfloat16, chunk, p, n) == "tc"
    _ssd_check(args, chunk, final, "tc")


@pytest.mark.cuda
@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_tc_kernel_at_state_dim_16_holds_hymbas_heads(cuda_device, chunk, final):
    """hymba-1.5b's SSD (H 50, P 64, N 16) on "tc": x, B and C as strided
    views of its conv output ([B, S, 50 * 64 + 2 * 16] = 3,232 halves a row,
    B and C at 6,400 / 6,432 bytes), 50 heads, so that a group of 4 (and of
    3 or 1) heads is ragged; held against the twin, then the simt kernel on
    the same inputs (uncounted) against the same twin within 1e-4 of each
    output's largest magnitude (chip_smoke.py's SSD_TOL: the simt kernel's
    state sums run in another order)."""
    args = _ssd_inputs(cuda_device, torch.bfloat16, chunk + 50, 1, 4 * chunk, 50, 64, 16)
    assert args[0].stride()[1] == 3232 and args[3].storage_offset() == 3200
    assert ssd_kernel.route(torch.bfloat16, chunk, 64, 16) == "tc"
    _ssd_check(args, chunk, final, "tc")
    want = ssd_ref.intra_chunk_bshp(*args, chunk=chunk, final_state=final)
    out = [torch.empty(t.shape, device=cuda_device) for t in want]  # the kernel's layouts
    ssd_kernel.launch(*args, *out, chunk=chunk, kind="simt")
    torch.cuda.synchronize()
    for name, g, w in zip(("y_intra", "s_contrib", "cumexp"), out, want):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= 1e-4 * max(scale, 1.0), (f"simt {name}", err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("chunk,h", [(4, 33), (8, 7), (16, 5), (32, 3)])
def test_ssd_packed_kernel_matches_plain_twin(cuda_device, chunk, h, dtype):
    """One block a lane over all heads, H not a multiple of the old head group."""
    args = _ssd_inputs(cuda_device, dtype, chunk + h, 3, 2 * chunk, h, 64, 128)
    for final in (True, False):
        _ssd_check(args, chunk, final, "packed")


@pytest.mark.cuda
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args = _ssd_inputs(cuda_device, torch.float32, 0, 1, 512, 2, 16, 16)
    with pytest.raises(ValueError, match="chunk <= 256"):
        ssd_ops.intra_chunk(*args, chunk=512)
    x, dt, a, bm, cm = args
    with pytest.raises(TypeError, match="f32 dt"):
        ssd_ops.intra_chunk(x, dt.bfloat16(), a, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="on cpu|x on"):
        ssd_ops.intra_chunk(x, dt.cpu(), a, bm, cm, chunk=64)
    # the tc route reads 16-byte rows: a projection 4 halves wider misaligns them
    x, dt, a, bm, cm = _ssd_inputs(cuda_device, torch.bfloat16, 1, 1, 128, 2, 64, 66)
    bm, cm = bm[..., :64], cm[..., 2:]
    assert ssd_kernel.route(x.dtype, 64, 64, 64) == "tc"
    with pytest.raises(ValueError, match="16-byte rows"):
        ssd_ops.intra_chunk(x, dt, a, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="does not take chunk"):
        out = [torch.empty(1, device=cuda_device)] * 3
        ssd_kernel.launch(x, dt, a, bm, bm, *out, chunk=64, kind="packed")



# the inter-chunk kernel: b, s, chunk, h, p, n, dtype, h0 given, final_state
INTER_CASES = [
    (2, 4096, 256, 32, 64, 128, torch.bfloat16, True, True),  # the mamba2 prefill
    (1, 2048, 256, 50, 64, 16, torch.bfloat16, True, True),  # hymba's: H 50, N 16
    (512, 8, 8, 32, 64, 128, torch.bfloat16, True, True),  # a packed cascade block, a state
    (64, 64, 8, 50, 64, 16, torch.bfloat16, False, False),  # 8 packed chunks, no h0 or state
    (2, 1024, 256, 32, 64, 128, torch.bfloat16, True, False),  # h0, no final state
    (2, 96, 96, 4, 16, 16, torch.float32, True, True),  # f32 C at smoke widths: 64 + 32 rows
    (3, 160, 32, 5, 48, 8, torch.bfloat16, False, True),  # P 48, N 8 padded to 16, no h0
    (2, 128, 64, 3, 16, 12, torch.bfloat16, True, True),  # N 12: C rows not 16-byte aligned
]


def _inter_inputs(dev, case):
    """The intra-chunk kernel's outputs on model-layout operands, C a strided
    slice of the projection, and h0 (or None)."""
    b, s, chunk, h, p, n, dtype, with_h0, final = case
    args = _ssd_inputs(dev, dtype, s + h + n, b, s, h, p, n)
    y_intra, s_contrib, cumexp = ssd_ops.intra_chunk(*args, chunk=chunk, final_state=final)
    rng = np.random.default_rng(s + n)
    h0 = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(np.float32)).to(dev)
          if with_h0 else None)
    return y_intra, s_contrib, cumexp, args[4], h0


def _inter_hold(got, want) -> None:
    """y and the final state within 1e-4 of each one's largest magnitude (the
    state's products split into bf16 hi + lo lose ~2^-16 of |h|; sums in
    another order)."""
    for name, g, w in zip(("y", "h_final"), got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= 1e-4 * max(scale, 1.0), (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", INTER_CASES)
def test_ssd_inter_chunk_kernel_matches_plain_twin(cuda_device, case):
    """One counted launch, y_intra updated in place, y and the final state
    within 1e-4 of the twin (``ref.inter_chunk_bshp``, the loop over chunks)."""
    chunk, final = case[2], case[8]
    y_intra, s_contrib, cumexp, c, h0 = _inter_inputs(cuda_device, case)
    assert c.stride(-1) == 1 and not c.is_contiguous()
    want = ssd_ref.inter_chunk_bshp(y_intra, s_contrib, cumexp, c, h0, chunk=chunk,
                                    final_state=final)
    y = y_intra.clone()
    before = ssd_ops.LAUNCHES["ssd_inter_chunk"]
    got = ssd_ops.inter_chunk(y, s_contrib, cumexp, c, h0, chunk=chunk, final_state=final)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd_inter_chunk"] == before + 1
    assert got[0].data_ptr() == y.data_ptr()  # in place
    _inter_hold(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(1, 1), (2, 1), (4, 1), (4, 4)])
def test_ssd_inter_chunk_kernel_holds_every_block_layout(cuda_device, layout):
    """1, 2 and 4 warps a block over 16 columns of P each, and 4 warps over
    the same 16 columns splitting a tile's rows (uncounted launches), on P
    48 (at 4 column warps one has no column of P; 160 rows: a last tile of
    32 rows leaves two row warps idle) and hymba's P 64 x 50 heads."""
    for case in (INTER_CASES[6], (1, 512, 256, 50, 64, 16, torch.bfloat16, True, True)):
        chunk, final = case[2], case[8]
        y_intra, s_contrib, cumexp, c, h0 = _inter_inputs(cuda_device, case)
        want = ssd_ref.inter_chunk_bshp(y_intra, s_contrib, cumexp, c, h0, chunk=chunk,
                                        final_state=final)
        b, _, h, p = y_intra.shape
        hf = torch.empty((b, h, p, c.shape[2]), device=cuda_device) if final else None
        ssd_kernel.launch_inter(y_intra, s_contrib, cumexp, c, h0, hf, chunk=chunk,
                                layout=layout)
        torch.cuda.synchronize()
        _inter_hold((y_intra, hf), want)


@pytest.mark.cuda
def test_ssd_inter_chunk_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    y_intra, s_contrib, cumexp, c, h0 = _inter_inputs(cuda_device, INTER_CASES[7])
    before = ssd_ops.LAUNCHES["ssd_inter_chunk"]
    # one chunk and no h0: no state enters it, y is y_intra and nothing launches
    one = _inter_inputs(cuda_device, (2, 64, 64, 3, 16, 12, torch.bfloat16, False, True))
    y, h = ssd_ops.inter_chunk(*one[:4], None, chunk=64)
    assert y is one[0] and torch.equal(h, one[1][:, :, 0])
    assert ssd_ops.LAUNCHES["ssd_inter_chunk"] == before
    with pytest.raises(ValueError, match="state_dim <= 128"):
        wide = _inter_inputs(cuda_device, (1, 128, 64, 2, 16, 132, torch.bfloat16, True, True))
        ssd_ops.inter_chunk(*wide, chunk=64)
    with pytest.raises(ValueError, match="contiguous f32 y_intra"):
        ssd_ops.inter_chunk(y_intra.transpose(1, 2).contiguous().transpose(1, 2), s_contrib,
                            cumexp, c, h0, chunk=64)
    with pytest.raises(ValueError, match="bf16 or f32 c"):
        ssd_ops.inter_chunk(y_intra, s_contrib, cumexp, c.half(), h0, chunk=64)
    with pytest.raises(ValueError, match="s_contrib"):
        ssd_ops.inter_chunk(y_intra, s_contrib, cumexp, c, h0, chunk=64, final_state=False)
    with pytest.raises(ValueError, match="on cpu"):
        ssd_ops.inter_chunk(y_intra, s_contrib, cumexp.cpu(), c, h0, chunk=64)
    assert ssd_ops.LAUNCHES["ssd_inter_chunk"] == before


# ---------------------------------------------------- the Mamba-2 mixer --

# (d_inner, state_dim, heads, head_dim) of mamba2-370m and hymba-1.5b
MIXER_WIDTHS = {"mamba2-370m": (2048, 128, 32, 64), "hymba-1.5b": (3200, 16, 50, 64)}
# arch, b, s, dtype, a conv tail given, extra values a projection row (1: an
# odd row stride, which the kernels' loads do not fit)
MIXER_CASES = [
    ("mamba2-370m", 2, 300, torch.bfloat16, False, 0),  # a prefill: tiles past 32 rows
    ("mamba2-370m", 3, 1, torch.bfloat16, True, 0),  # a decode step
    ("mamba2-370m", 2, 40, torch.bfloat16, True, 0),  # a prefill into a cache
    ("hymba-1.5b", 1, 300, torch.bfloat16, False, 0),  # rows of 6,482 values: 4-byte loads
    ("hymba-1.5b", 4, 1, torch.bfloat16, True, 0),
    ("hymba-1.5b", 16, 8, torch.bfloat16, False, 0),  # the cascade trunk's 8 tokens
    ("mamba2-370m", 2, 70, torch.float32, True, 0),
    ("hymba-1.5b", 2, 33, torch.float32, True, 0),
]
MIXER_MISFITS = [("mamba2-370m", 2, 50, torch.bfloat16, True, 1),
                 ("hymba-1.5b", 1, 2, torch.float32, True, 1)]


def _mixer_front_inputs(dev, case):
    """proj (a slice of wider rows where asked), conv_w [4, C], conv_b, dt_bias
    and the tail (or None), drawn with numpy from the case."""
    arch, b, s, dtype, tail, pad = case
    di, n, h, _ = MIXER_WIDTHS[arch]
    c, width = di + 2 * n, 2 * di + 2 * n + h
    rng = np.random.default_rng(b * s + h)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dev)

    proj = (draw(b, s, width + pad, scale=2.0).to(dtype))[..., :width]
    dt_bias = draw(h, scale=3.0)
    dt_bias[0] = 25.0  # softplus's threshold
    return (proj, draw(4, c, scale=0.5), draw(c, scale=0.1), dt_bias,
            draw(b, 3, c).to(dtype) if tail else None)


def _bitwise(name, got, want):
    """got equal to want bit for bit (the count and size of any difference in
    the message)."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    apart = ulps(got, want)
    assert not apart.any(), (f"{name}: {int((apart > 0).sum())} of {apart.numel()} values "
                             f"differ, up to {int(apart.max())} ulps")


@pytest.mark.cuda
@pytest.mark.parametrize("case", MIXER_CASES)
def test_ssm_mixer_front_kernel_matches_plain_twin_bitwise(cuda_device, case):
    """One counted launch; xbc, the gate, dt and the new tail bitwise the
    twin's on the card (the eager chain's roundings and formulas)."""
    arch, dtype = case[0], case[3]
    di, n = MIXER_WIDTHS[arch][:2]
    proj, w, b, dt_bias, tail = _mixer_front_inputs(cuda_device, case)
    want = ssm_mixer_ref.front(proj, w, b, dt_bias, di, n, tail)
    before = ssm_mixer_ops.LAUNCHES["ssm_mixer_front"]
    got = ssm_mixer_ops.front(proj, w, b, dt_bias, d_inner=di, state_dim=n, cache_tail=tail,
                              new_tail=True)
    torch.cuda.synchronize()
    assert ssm_mixer_ops.LAUNCHES["ssm_mixer_front"] == before + 1
    for name, g, wt in zip(("xbc", "gate", "dt", "new_tail"), got, want):
        _bitwise(f"{arch} {case[1:]} {name}", g, wt)


def _mixer_norm_inputs(dev, case):
    """y [B, S, H, P], x a strided view of an xbc, D, the gate, norm_w."""
    arch, b, s, dtype, _, pad = case
    di, n, h, p = MIXER_WIDTHS[arch]
    rng = np.random.default_rng(b * s + p)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    xbc = draw(b, s, pad + di + 2 * n).to(dtype)
    x = xbc[..., pad:pad + di].reshape(b, s, h, p)
    return draw(b, s, h, p).to(dtype), x, draw(h), draw(b, s, di).to(dtype), draw(di)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MIXER_CASES)
def test_ssm_mixer_gated_norm_kernel_matches_plain_twin(cuda_device, case):
    """One counted launch; the normed rows within one ulp of the twin's in
    bf16 and four in f32 (the sum of squares in another order than
    ``torch.mean``'s)."""
    dtype = case[3]
    most = 1 if dtype == torch.bfloat16 else 4
    y, x, d, gate, w = _mixer_norm_inputs(cuda_device, case)
    want = ssm_mixer_ref.gated_norm(y, x, d, gate, w, 1e-5)
    before = ssm_mixer_ops.LAUNCHES["ssm_mixer_gated_norm"]
    got = ssm_mixer_ops.gated_norm(y, x, d, gate, w, 1e-5)
    torch.cuda.synchronize()
    assert ssm_mixer_ops.LAUNCHES["ssm_mixer_gated_norm"] == before + 1
    apart = ulps(got, want)
    assert int(apart.max()) <= most, (case, int(apart.max()), int((apart > 0).sum()))


@pytest.mark.cuda
def test_ssm_mixer_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from repro_torch.kernels.autograd import NoBackwardError

    case = ("mamba2-370m", 1, 4, torch.bfloat16, True, 0)
    di, n = MIXER_WIDTHS["mamba2-370m"][:2]
    proj, w, b, dt_bias, tail = _mixer_front_inputs(cuda_device, case)
    before = dict(ssm_mixer_ops.LAUNCHES)
    with pytest.raises(NoBackwardError):
        ssm_mixer_ops.front(proj.float().requires_grad_(True), w, b, dt_bias, d_inner=di,
                            state_dim=n)
    with pytest.raises(ValueError, match="conv width of 4"):
        ssm_mixer_ops.front(proj, torch.zeros((5, w.shape[1]), device=cuda_device), b, dt_bias,
                            d_inner=di, state_dim=n)
    with pytest.raises(ValueError, match="on cpu"):
        ssm_mixer_ops.front(proj, w, b, dt_bias, d_inner=di, state_dim=n, cache_tail=tail.cpu())
    with pytest.raises(TypeError, match="one dtype"):
        ssm_mixer_ops.front(proj.half(), w, b, dt_bias, d_inner=di, state_dim=n)
    y, x, d, gate, nw = _mixer_norm_inputs(cuda_device, case)
    with pytest.raises(ValueError, match="one row"):
        ssm_mixer_ops.gated_norm(y.transpose(2, 3).contiguous().transpose(2, 3), x, d, gate, nw,
                                 1e-5)
    with pytest.raises(TypeError, match="one dtype"):
        ssm_mixer_ops.gated_norm(y, x.float(), d, gate, nw, 1e-5)
    for misfit in MIXER_MISFITS:  # an odd row stride: the loads do not fit
        arch = misfit[0]
        di, n = MIXER_WIDTHS[arch][:2]
        proj, w, b, dt_bias, tail = _mixer_front_inputs(cuda_device, misfit)
        with pytest.raises(ValueError, match="loads 2 values"):
            ssm_mixer_ops.front(proj, w, b, dt_bias, d_inner=di, state_dim=n, cache_tail=tail)
        y, x, d, gate, nw = _mixer_norm_inputs(cuda_device, misfit)
        with pytest.raises(ValueError, match="loads 16 bytes"):
            ssm_mixer_ops.gated_norm(y, x, d, gate, nw, 1e-5)
    assert dict(ssm_mixer_ops.LAUNCHES) == before


# --------------------------------------------------------- decode attention --

# b, skv, h, kv, d, kv_len, window, softcap, num_splits (of the partials route)
DA_CASES = [
    (8, 4096, 16, 8, 128, 2048, None, None, 16),  # qwen3-1.7b decode
    (2, 256, 4, 2, 32, 192, None, None, 4),  # the reference tests' cases
    (1, 512, 8, 2, 64, 384, None, 30.0, 8),
    (2, 256, 4, 4, 32, 192, 128, None, 4),
    (3, 200, 8, 1, 48, 77, 20, 50.0, 8),  # ragged: ns halves to 8, D = 48, G = 8
    (2, 64, 4, 2, 256, 33, None, None, 2),  # D = 256
    (2, 128, 4, 2, 16, 0, None, None, 4),  # an empty cache
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", DA_CASES)
def test_decode_kernel_matches_plain_twin(cuda_device, case, dtype, tol):
    """The partials kernel (splits over the cache length) within 2e-5 of its
    twin, and the fused route (the wrapper's default splits) within the
    flash tolerances of the oracle."""
    b, skv, h, kv, d, kv_len, window, cap, ns = case
    q, k, v = _fa_inputs(cuda_device, dtype, skv + d, b, 1, skv, h, kv, d)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    g = h // kv
    qm = q.reshape(b * kv, g, d)
    km, vm = (t.transpose(1, 2).reshape(b * kv, skv, d).contiguous() for t in (k, v))
    before = dict(da_ops.LAUNCHES)
    got = da_ops.decode_attention_partials(qm, km, vm, kl, softcap=cap, window=window,
                                           num_splits=ns)
    torch.cuda.synchronize()
    assert da_ops.LAUNCHES == {**before, "decode_attention_partials":
                               before["decode_attention_partials"] + 1}
    want = da_ref.decode_attention_partials(qm, km, vm, kl, softcap=cap, window=window,
                                            num_splits=ns)
    for name, x, y in zip(("m", "l", "acc"), got, want):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5, msg=name)
    if kv_len == 0:
        assert (got[0] == da_ref.NEG_INF).all() and (got[1] == 0).all()
    out = da_ops.decode_attention(q, k, v, kl, softcap=cap, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    assert da_ops.LAUNCHES["decode_attention_fused"] == before["decode_attention_fused"] + 1
    ref_out = da_ref.reference_decode(q, k, v, kl, softcap=cap, window=window)
    if kv_len == 0:
        assert (out == 0).all()
    else:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)


# then the groups of more than 512 values (the simt form's sub-groups): G 6 /
# 7 at D 128 (nemotron, grok-1, arctic), D 80 and D 256
PARTIALS_CASES = DA_CASES + [
    (1, 2080, 48, 8, 128, 2056, None, None, 16),  # nemotron: G 6, D 128
    (1, 544, 56, 8, 128, 520, None, None, 8),  # arctic: G 7, D 128
    (2, 600, 48, 8, 80, 577, 257, None, 8),  # G 6 at D 80: a window, a ragged split
    (1, 640, 56, 8, 80, 0, None, None, 8),  # G 7 at D 80: an empty cache
    (1, 512, 48, 8, 256, 300, None, 50.0, 8),  # G 6 at D 256, a softcap
    (1, 512, 56, 8, 256, 511, 100, None, 4),  # G 7 at D 256, a window
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PARTIALS_CASES)
def test_partials_kernel_forms_match_their_twin(cuda_device, case, dtype):
    """Both forms of the partials kernel within 2e-5 of the twin: the form
    ``partials_route`` names (counted in ``PARTIAL_ROUTES``), and where that
    is "tc" the simt form on the same inputs (uncounted); then
    ``decode_attention_split`` on the cache's [B, S, KV, D] layout (the
    mesh decode's call) against the same partials.  Every group of <= 8
    rows is taken: G 6 / 7 at D 128 raised before the simt form ran its
    rows in sub-groups."""
    b, skv, h, kv, d, kv_len, window, cap, ns = case
    q, k, v = _fa_inputs(cuda_device, dtype, skv + d + h, b, 1, skv, h, kv, d)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    g = h // kv
    assert da_kernel.supports_partials(g, d, dtype)
    qm = q.reshape(b * kv, g, d)
    km, vm = (t.transpose(1, 2).reshape(b * kv, skv, d).contiguous() for t in (k, v))
    kw = dict(softcap=cap, window=window)
    form, forms = da_kernel.partials_route(dtype, d), dict(da_ops.PARTIAL_ROUTES)
    got = da_ops.decode_attention_partials(qm, km, vm, kl, num_splits=ns, **kw)
    torch.cuda.synchronize()
    assert da_ops.PARTIAL_ROUTES == {**forms, form: forms[form] + 1}, da_ops.PARTIAL_ROUTES
    want = da_ref.decode_attention_partials(qm, km, vm, kl, num_splits=ns, **kw)
    outs = {form: got}
    if form == "tc":
        outs["simt"] = [torch.empty_like(t) for t in got]
        da_kernel.launch(qm, km[:, :, None], vm[:, :, None], kl, *outs["simt"], form="simt",
                         **kw)
    split = da_ops.decode_attention_split(q, k, v, kl, num_splits=ns, **kw)
    torch.cuda.synchronize()
    outs["split"] = [t.reshape(w.shape) for t, w in zip(split, want)]
    for label, out in outs.items():
        for name, x, y in zip(("m", "l", "acc"), out, want):
            torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5, msg=f"{label} {name}")
    if kv_len == 0:
        assert (got[0] == da_ref.NEG_INF).all() and (got[1] == 0).all() and (got[2] == 0).all()


# b, skv, h, kv, d, kv_len, window, softcap, num_splits (the fused route's)
FUSED_CASES = [
    (8, 4096, 16, 8, 128, 2048, None, None, 8),  # qwen3-1.7b decode
    (2, 64, 4, 2, 64, 0, None, None, 8),  # an empty cache: 0
    (2, 64, 4, 2, 64, 1, None, None, 8),  # one live key
    (1, 128, 8, 1, 64, 5, None, None, 8),  # fewer live keys than splits; GQA 8
    (2, 100, 4, 4, 128, 77, None, None, 6),  # S_max and kv_len not multiples of ns; GQA 1
    (2, 4100, 16, 8, 128, 4099, 512, 50.0, 8),  # window + softcap over a ragged cache
    (1, 999, 16, 2, 64, 999, None, 30.0, 7),  # GQA 8, a full cache, 7 splits
    (3, 333, 4, 2, 128, 300, 100, None, 3),
    (2, 96, 4, 2, 256, 90, None, None, 4),  # D 256
    (1, 600, 32, 8, 80, 580, 257, None, 8),  # h2o-danube: G 4, D 80 (64 values a thread)
    (1, 600, 16, 8, 256, 580, 257, 50.0, 8),  # gemma2: G 2, D 256, window + softcap
    (1, 700, 25, 5, 64, 650, None, None, 8),  # hymba: G 5
    (1, 300, 56, 8, 128, 280, None, None, 4),  # arctic: G 7
    (1, 300, 48, 8, 128, 280, None, None, 4),  # nemotron, grok-1: G 6
    (1, 300, 32, 8, 128, 280, None, None, 4),  # llava: G 4, D 128
    (1, 300, 16, 16, 64, 280, None, None, 4),  # seamless's self-attention: G 1
    (1, 600, 16, 8, 256, 580, None, 50.0, 8),  # gemma2's global layers: softcap, no window
    (1, 700, 64, 8, 256, 650, None, 30.0, 8),  # D 256, G 8: the tc form's largest smem
    (2, 300, 8, 8, 80, 0, None, None, 4),  # D 80: an empty cache
    (1, 333, 8, 1, 80, 300, 100, None, 3),  # D 80, G 8, a window, 3 splits
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_decode_kernel_matches_its_twin(cuda_device, case, dtype):
    """One launch, no PyTorch combine: within 2e-5 of the twin in f32 (the
    same splits, f32 sums in another order) and within the flash kernel's
    bf16 tolerance 2e-2 of the oracle in bf16 (the output rounds to bf16),
    counted on the form ``fused_route`` names (bf16 at D 64 / 80 / 128 /
    256: "tc"); where the simt form also takes a bf16 group, it is held to
    the same tolerance on the same inputs (uncounted).  A group the simt
    form cannot hold in f32 (G 6 / 7 / 8 at D 80 / 128 / 256: the models
    serve these in bf16, on the tc form) is refused, launching nothing."""
    b, skv, h, kv, d, kv_len, window, cap, ns = case
    q, k, v = _fa_inputs(cuda_device, dtype, skv + d + ns, b, 1, skv, h, kv, d)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(softcap=cap, window=window)
    before = dict(da_ops.LAUNCHES)
    if not da_kernel.supports_fused(h // kv, d, dtype):
        assert dtype == torch.float32 and h // kv * d > 512
        with pytest.raises(ValueError, match="G \\* D <= 512"):
            da_ops.decode_attention(q, k, v, kl, num_splits=ns, **kw)
        assert da_ops.LAUNCHES == before
        return
    form, forms = da_kernel.fused_route(dtype, d), dict(da_ops.ROUTES)
    out = da_ops.decode_attention(q, k, v, kl, num_splits=ns, **kw)
    torch.cuda.synchronize()
    assert da_ops.LAUNCHES == {**before, "decode_attention_fused":
                               before["decode_attention_fused"] + 1}
    assert da_ops.ROUTES == {**forms, form: forms[form] + 1}
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    twin = da_ref.decode_attention_fused(q, k, v, kl, num_splits=ns, **kw)
    oracle = da_ref.reference_decode(q, k, v, kl, **kw)
    if kv_len == 0:
        assert (out == 0).all() and (twin == 0).all()
    elif dtype == torch.float32:
        torch.testing.assert_close(out, twin, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(out, oracle, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(out.float(), oracle.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(out.float(), twin.float(), rtol=2e-2, atol=2e-2)
    g = h // kv
    if form == "tc" and da_kernel.fits_simt(g, d, dtype):
        simt = torch.empty_like(out).reshape(b * kv, g, d)
        da_kernel.launch_fused(q.reshape(b * kv, g, d), k, v, kl, simt, num_splits=ns,
                               form="simt", **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(simt.reshape(out.shape).float(), twin.float(), rtol=2e-2,
                                   atol=2e-2)  # the twin: 0 for an empty cache


@pytest.mark.cuda
def test_decode_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _fa_inputs(cuda_device, torch.float32, 0, 1, 1, 64, 32, 2, 64)
    kl = torch.tensor([8], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="G \\* D <= 512"):
        da_ops.decode_attention(q, k, v, kl)  # G = 16
    with pytest.raises(ValueError, match="kv_len is on"):
        da_ops.decode_attention(q[:, :, :2], k, v, kl.cpu())
    with pytest.raises(ValueError, match="1 to 8 splits"):
        da_ops.decode_attention(q[:, :, :2], k, v, kl, num_splits=16)
    with pytest.raises(ValueError, match="aligned rows"):  # rows 16-byte aligned for cp.async
        wide = torch.zeros((1, 64, 2, 66), device=cuda_device)
        da_ops.decode_attention(q[:, :, :2], wide[..., 2:], wide[..., 2:], kl)
    with pytest.raises(TypeError, match="decode attention takes"):
        da_ops.decode_attention(*(t[:, :, :2].half() if t is q else t.half() for t in (q, k, v)),
                                kl)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_cuda_model_prefill_and_decode_run_the_kernels(cuda_device, arch):
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.models.model import random_model

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32 (the default)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model, cpu_params = random_model(cfg, seed=0, device="cpu")
    params = map_tree(lambda t: t.to(cuda_device), cpu_params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 68)))
    for counts in (fa_ops, da_ops, ssd_ops):
        counts.reset_counts()
    results = []
    for p, dev in ((cpu_params, "cpu"), (params, cuda_device)):
        logits, cache = model.prefill(p, {"tokens": tokens[:, :64].to(dev)}, max_len=72)
        outs = [logits.cpu()]
        for t in range(64, 68):  # teacher-forced: no near-tie argmax can fork the runs
            logits, cache = model.decode_step(p, tokens[:, t:t + 1].to(dev), cache)
            outs.append(logits.cpu())
        results.append(outs)
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    launches = {**fa_ops.LAUNCHES, **da_ops.LAUNCHES, **ssd_ops.LAUNCHES}
    if arch == "mamba2-370m":
        assert launches == {"flash_attention": 0, "decode_attention_partials": 0,
                            "decode_attention_fused": 0, "ssd_intra_chunk": 2,
                            "ssd_inter_chunk": 2}, launches
        assert ssd_ops.ROUTES == {"tc": 0, "simt": 0, "packed": 2}  # f32, chunk 16
    else:
        assert launches == {"flash_attention": 2, "decode_attention_partials": 0,
                            "decode_attention_fused": 8, "ssd_intra_chunk": 0,
                            "ssd_inter_chunk": 0}, launches


# reduced bf16 models that route the bf16 kernels: prompt, teacher-forced steps
BF16_CHECK = {"qwen3-1.7b": (96, 4), "mamba2-370m": (512, 4)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_cuda_bf16_models_route_the_bf16_kernels(cuda_device, arch):
    """The reduced bf16 configs (head_dim 128, GQA; SSM chunk 256) on the CPU
    (plain twins) and the card (kernels), fed the same tokens, with the
    routes asserted: the flash "tc" kernel and the fused decode for qwen3,
    the SSD "tc" kernel for mamba2.  The card's logits stay within 2x the
    bf16 CPU run's own distance from an f32 run of the same weights: the
    kernels add no more error than bf16 rounding makes (the CPU and the card
    round at other places, so two bf16 runs lie ~sqrt(2) of one run's error
    apart)."""
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.models.model import random_model, teacher_forced

    torch.backends.cuda.matmul.allow_tf32 = False
    prompt, steps = BF16_CHECK[arch]
    cfg = get_config(arch, bf16_check=True)
    model, cpu_params = random_model(cfg, seed=5, device="cpu")
    seq = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size,
                                                             (2, prompt + steps)))
    max_len = prompt + steps + 8
    cpu, _ = teacher_forced(model, cpu_params, seq, prompt, max_len)
    f32_model = random_model(dataclasses.replace(cfg, dtype="float32"), seed=5, device="cpu")[0]
    ref, _ = teacher_forced(f32_model, map_tree(lambda t: t.float(), cpu_params), seq, prompt,
                            max_len)
    for counts in (fa_ops, da_ops, ssd_ops, ssm_mixer_ops):
        counts.reset_counts()
    gpu, cache = teacher_forced(model, map_tree(lambda t: t.to(cuda_device), cpu_params),
                                seq.to(cuda_device), prompt, max_len)
    torch.cuda.synchronize()
    n = cfg.num_layers
    mixer = n * (1 + steps) if arch == "mamba2-370m" else 0  # the prefill and every step
    assert ssm_mixer_ops.LAUNCHES == {"ssm_mixer_front": mixer,
                                      "ssm_mixer_gated_norm": mixer}, ssm_mixer_ops.LAUNCHES
    if arch == "qwen3-1.7b":
        assert fa_ops.ROUTES == {"tc": n, "short": 0, "split": 0, "simt": 0}, fa_ops.ROUTES
        assert da_ops.LAUNCHES == {"decode_attention_partials": 0,
                                   "decode_attention_fused": n * steps}, da_ops.LAUNCHES
        assert da_ops.ROUTES == {"tc": n * steps, "simt": 0, "split": 0}, da_ops.ROUTES
    else:
        assert ssd_ops.ROUTES == {"tc": n, "simt": 0, "packed": 0}, ssd_ops.ROUTES
    assert not any({**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS,
                    **ssm_mixer_ops.PLAIN_CALLS}.values())
    assert int(cache.length) == prompt + steps
    bf16_err = max((c - r).abs().max().item() for c, r in zip(cpu, ref))
    err = max((g.cpu() - c).abs().max().item() for g, c in zip(gpu, cpu))
    assert err <= 2.0 * bf16_err, (err, bf16_err)


# the model zoo's non-causal and odd-group attention: b, sq, skv, h, kv, d,
# causal, window, softcap, kv_len (bf16; the route as kernel.route picks it)
ZOO_FA_CASES = [
    (1, 256, 256, 16, 16, 64, False, None, None, None),  # seamless's encoder (tc)
    (2, 96, 200, 4, 4, 64, False, None, None, None),  # cross-attention prefill (tc)
    (2, 1, 200, 4, 4, 64, False, None, None, None),  # cross-attention decode (split)
    (64, 8, 8, 25, 5, 64, False, None, None, None),  # hymba's cascade trunk, G 5 (short)
    (1, 200, 232, 25, 5, 64, True, None, None, 200),  # hymba's prefill, G 5 (tc)
    (1, 300, 320, 32, 8, 80, True, 128, None, 300),  # h2o-danube, D 80 (tc)
    (1, 300, 320, 16, 8, 256, True, 128, 50.0, 300),  # gemma2's local layers, D 256 (tc)
    (1, 300, 320, 16, 8, 256, True, None, 50.0, 300),  # gemma2's global layers (tc)
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZOO_FA_CASES)
def test_flash_zoo_shapes_match_plain_twin(cuda_device, case):
    """Cross-attention (Sq != Skv, no kv_len, non-causal: the offset the
    kernels derive bounds no key), a group of 5 heads, and head dims 80 and
    256 (the tc kernel's padded and 64-key tiles), within the bf16 tolerance
    of the twin."""
    b, sq, skv, h, kv, d, causal, window, cap, kv_len = case
    q, k, v = _fa_inputs(cuda_device, torch.bfloat16, sq + skv + d, b, sq, skv, h, kv, d)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32,
                                                  device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=True)
    route = fa_kernel.route(torch.bfloat16, sq, d, h // kv, skv)
    assert route == ("tc" if sq >= 64 else "split" if h // kv * sq <= 8 else "short")
    before = dict(fa_ops.ROUTES)
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    torch.cuda.synchronize()
    assert fa_ops.ROUTES == {**before, route: before[route] + 1}
    want = fa_ops.plain_bshd(q, k, v, kl, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


def _teacher_forced_pair(cuda_device, cfg, prompt, steps, seed):
    """The same weights and tokens through the CPU (plain twins) and the card
    (kernels), teacher-forced -> (cpu logits, card logits, the card's cache)."""
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.models.model import random_model, teacher_forced

    model, params = random_model(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, prompt + steps)))
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32))
    max_len = prompt + steps + 8
    cpu, _ = teacher_forced(model, params, seq, prompt, max_len, extra)
    for counts in (fa_ops, da_ops, ssd_ops, ssm_mixer_ops):
        counts.reset_counts()
    gpu, cache = teacher_forced(model, map_tree(lambda t: t.to(cuda_device), params),
                                seq.to(cuda_device), prompt, max_len,
                                {k: v.to(cuda_device) for k, v in extra.items()})
    torch.cuda.synchronize()
    assert not any({**fa_ops.PLAIN_CALLS, **da_ops.PLAIN_CALLS, **ssd_ops.PLAIN_CALLS}.values())
    return cpu, [g.cpu() for g in gpu], cache, (model, params, seq, max_len, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-9b", "h2o-danube-1.8b", "hymba-1.5b",
                                  "seamless-m4t-large-v2"])
def test_cuda_zoo_bf16_models_route_the_kernels(cuda_device, arch):
    """The zoo's reduced bf16 configs (``bf16_check``: head_dim 256 with both
    softcaps, head_dim 80, GQA 5 beside SSD heads of state 16 on the tc SSD
    kernel, an encoder
    with cross-attention) CPU vs card, the routes asserted; the card within
    2x the bf16 CPU run's own distance from an f32 run of the same weights."""
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.enrich.cascade import map_tree
    from repro_torch.models.model import Model, teacher_forced

    torch.backends.cuda.matmul.allow_tf32 = False
    prompt, steps = (512 if arch == "hymba-1.5b" else 96), 4
    cfg = get_config(arch, bf16_check=True)
    cpu, gpu, cache, (model, params, seq, max_len, extra) = _teacher_forced_pair(
        cuda_device, cfg, prompt, steps, seed=5)
    n = cfg.num_layers
    if arch == "seamless-m4t-large-v2":  # encoder + self + cross tc; a split cross a step
        assert fa_ops.ROUTES == {"tc": 3 * n, "short": 0, "split": n * steps, "simt": 0}, (
            fa_ops.ROUTES)
    else:  # the prefill on tc at every head dim (64, 80, 256)
        assert fa_ops.ROUTES == {"tc": n, "short": 0, "split": 0, "simt": 0}, fa_ops.ROUTES
    assert da_ops.LAUNCHES == {"decode_attention_partials": 0,
                               "decode_attention_fused": n * steps}, da_ops.LAUNCHES
    assert da_ops.ROUTES == {"tc": n * steps, "simt": 0, "split": 0}, da_ops.ROUTES  # D 64 / 80 / 256
    assert ssd_ops.ROUTES == {"tc": n if arch == "hymba-1.5b" else 0, "simt": 0, "packed": 0}
    mixer = n * (1 + steps) if arch == "hymba-1.5b" else 0  # the prefill and every step
    assert ssm_mixer_ops.LAUNCHES == {"ssm_mixer_front": mixer,
                                      "ssm_mixer_gated_norm": mixer}, ssm_mixer_ops.LAUNCHES
    assert int(cache.length) == prompt + steps
    f32 = Model(dataclasses.replace(model.cfg, dtype="float32"))
    ref, _ = teacher_forced(f32, map_tree(lambda t: t.float(), params), seq, prompt, max_len,
                            extra)
    bf16_err = max((c - r).abs().max().item() for c, r in zip(cpu, ref))
    err = max((g - c).abs().max().item() for g, c in zip(gpu, cpu))
    assert err <= 2.0 * bf16_err, (err, bf16_err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_cuda_moe_models_route_equally_in_f32(cuda_device, arch):
    """The MoE smoke models in f32, CPU vs card: the router's choices (the
    stable top-k) equal on every layer and step, the logits within 2e-4."""
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.models.moe import recording_routes

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    with recording_routes() as seen:
        cpu, gpu, cache, _ = _teacher_forced_pair(cuda_device, cfg, 64, 4, seed=9)
    half = len(seen) // 2
    assert half == cfg.num_layers * 5
    for a, c in zip(seen[:half], seen[half:]):
        assert torch.equal(a, c)
    assert max((g - c).abs().max().item() for g, c in zip(gpu, cpu)) <= 2e-4


@pytest.mark.cuda
def test_cuda_moe_top_k_keeps_index_order_on_ties(cuda_device):
    """``torch.topk`` promises no order among equal values on the card; the
    MoE's selection (a stable sort) gives the CPU's, ``jax.lax.top_k``'s,
    order: ties to the lower index, over a mostly-zero gate matrix."""
    from repro_torch.models import moe

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.choice(np.array([0.0, 0.0, 0.0, 0.5, 1.0], np.float32),
                                    size=(4, 8, 4096)))
    for k in (2, 8, 640):
        vals, idx = moe._top_k(x.to(cuda_device), k)
        want_vals, want_idx = moe._top_k(x, k)
        assert torch.equal(vals.cpu(), want_vals) and torch.equal(idx.cpu(), want_idx)


# ------------------------------------------------------- serving robustness --


def _robust_session(dev, dtype="bfloat16", capacity=2048, max_capacity=4096):
    gen = torch.Generator().manual_seed(3)
    preds = [Predicate(i, 1) for i in range(4)]
    corpus = make_corpus(gen, 4096 + 512, list(range(4)), [1] * 4, selectivity=[0.3] * 4,
                         aucs=[0.60, 0.88, 0.93, 0.97], costs=[0.01, 0.05, 0.2, 0.5])
    combine = default_combine_params(corpus.aucs)
    table = learn_decision_table(corpus.func_probs[:512], combine, num_bins=10)
    outputs = corpus.func_probs[512:]
    sess = EngineSession(preds, table, combine, corpus.costs, capacity=capacity, max_tenants=4,
                         max_capacity=max_capacity, device=dev,
                         config=EngineConfig(plan_size=64, function_selection="best",
                                             substrate_dtype=dtype))
    return sess, outputs, preds


@pytest.mark.cuda
def test_cuda_pipeline_staging_makes_no_host_sync(cuda_device):
    """Admit, ingest (host rows: the pinned copy path), run and retire
    staged on a pipeline under ``set_sync_debug_mode("error")``; the result
    is bitwise the lockstep run's."""
    def trace(events):
        events.admit(conjunction(Predicate(0, 1), Predicate(1, 1)))
        events.admit(conjunction(Predicate(1, 1), Predicate(2, 1), Predicate(3, 1)))
        events.run(3)
        events.ingest(host[2048:3072])
        events.run(3)
        events.retire(0)
        events.run(2)

    sess, outputs, _ = _robust_session(cuda_device)
    host = outputs.cpu()

    class Lockstep:
        def __init__(self):
            self.st = sess.init_state(host[:2048])

        def admit(self, q):
            self.st, _ = sess.admit(self.st, q)

        def ingest(self, rows):
            self.st = sess.ingest(self.st, rows)

        def run(self, n):
            self.st, _ = sess.run(self.st, n, stop_when_exhausted=False)

        def retire(self, slot):
            self.st = sess.retire(self.st, slot)

    lock = Lockstep()
    trace(lock)  # also builds the scoring LUT and loads the kernel library
    sess2, _, _ = _robust_session(cuda_device)
    pipe = sess2.pipeline(sess2.init_state(host[:2048]), chunk_size=2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trace(pipe)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    state, history = pipe.finish()
    assert len(history) == 8 and pipe.num_rows == int(state.num_rows) == 3072
    assert state_digests(state) == state_digests(lock.st)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["block", "spill"])
def test_cuda_pinned_double_buffered_feed_equals_direct_ingest(cuda_device, policy):
    """Eight micro-batches through two pinned staging tensors and a side
    stream (each tensor reused three times), drained by the backpressure
    callback: bitwise the direct ingest of the same rows."""
    from repro_torch.ingest import IngestStream, PendingRing

    sess, outputs, _ = _robust_session(cuda_device)
    host = outputs.cpu()
    direct = sess.ingest(sess.init_state(host[:2048]), host[2048:2048 + 1800])
    box = {"st": sess.init_state(host[:2048]), "rows": 2048}
    ring = PendingRing(sess, slot_rows=256, num_slots=2, policy=policy)

    def drain():
        box["st"], box["rows"], _ = ring.drain_into(sess, box["st"], box["rows"])

    stream = IngestStream(ring, batch_rows=256, on_pressure=drain)
    assert stream._staging[0].is_pinned() and stream._copy_stream is not None
    assert stream.feed(host[2048:2048 + 1800]) == 1800  # 8 batches, the last of 8 rows
    drain()
    assert box["rows"] == 3848 and stream.batches_fed == 8
    assert torch.equal(box["st"].bank_outputs, direct.bank_outputs)
    assert state_digests(box["st"]) == state_digests(direct)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_checkpoints_restore_on_the_cpu_and_back(cuda_device, dtype, tmp_path):
    from repro_torch.checkpoint import store
    from repro_torch.core.durability import restore_session_checkpoint, save_session_checkpoint

    card, outputs, preds = _robust_session(cuda_device, dtype)
    st = card.init_state(outputs[:2048])
    st, _ = card.admit(st, conjunction(preds[0], preds[2]))
    st, _ = card.run(st, 3)
    save_session_checkpoint(tmp_path / "card", 3, card, st)
    cpu, _, _ = _robust_session("cpu", dtype)
    on_cpu, _, _ = restore_session_checkpoint(cpu, tmp_path / "card")
    for (k, a), (_, b) in zip(store._flatten_with_paths(st), store._flatten_with_paths(on_cpu)):
        assert b.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a.cpu(), b), k
    save_session_checkpoint(tmp_path / "cpu", 3, cpu, on_cpu)
    back, _, _ = restore_session_checkpoint(card, tmp_path / "cpu")
    for (k, a), (_, b) in zip(store._flatten_with_paths(st), store._flatten_with_paths(back)):
        assert b.device.type == "cuda" and torch.equal(a, b), k
    a, _ = card.run(st, 2)
    b, _ = card.run(back, 2)
    assert state_digests(a) == state_digests(b)


# ----------------------------------------------- softcaps that bind (card) --
# Scores of unit-normal q and k sit near N(0, 1), which a cap of 30-50 barely
# moves: these cases draw q times 12 or 16, so |s / cap| reaches ~2, and each
# carries the control — the same kernel without its cap must miss the capped
# oracle beyond the tolerance.

# b, skv, h, kv, d, kv_len, window, softcap, num_splits, q_scale (fused decode)
FUSED_BINDING = [
    (2, 4100, 16, 8, 128, 4099, 512, 50.0, 8, 16.0),  # tc form in bf16 (D 128)
    (1, 999, 16, 2, 64, 999, None, 30.0, 7, 12.0),  # tc form in bf16 (D 64, G 8)
    (2, 256, 4, 2, 128, 200, None, 30.0, 4, 12.0),  # simt at D 128 in f32
    (1, 600, 32, 8, 80, 580, 257, 30.0, 8, 12.0),  # D 80 (G 4): tc in bf16, simt in f32
    (1, 600, 16, 8, 256, 580, 257, 50.0, 8, 16.0),  # gemma2 local: G 2, D 256 (the same)
    (1, 600, 16, 8, 256, 580, None, 50.0, 8, 16.0),  # gemma2 global
    (1, 333, 16, 4, 80, 300, 100, 30.0, 3, 12.0),  # D 80, 3 splits: tc in bf16, simt in f32
]


def _binding_decode(dev, case, dtype):
    b, skv, h, kv, d, kv_len, window, cap, ns, q_scale = case
    q, k, v = _fa_inputs(dev, torch.float32, skv + d + 7, b, 1, skv, h, kv, d)
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    return q, k, v, kl, dict(softcap=cap, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_BINDING)
def test_fused_decode_softcap_holds_where_it_binds(cuda_device, case, dtype):
    q, k, v, kl, kw = _binding_decode(cuda_device, case, dtype)
    ns = case[8]
    if not da_kernel.supports_fused(case[2] // case[3], case[4], dtype):
        pytest.skip("a group the simt form does not hold in f32 (the models serve it in bf16)")
    out = da_ops.decode_attention(q, k, v, kl, num_splits=ns, **kw)
    uncapped = da_ops.decode_attention(q, k, v, kl, num_splits=ns, window=kw["window"])
    torch.cuda.synchronize()
    oracle = da_ref.reference_decode(q, k, v, kl, **kw).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), oracle, rtol=tol, atol=tol)
    if dtype == torch.float32:
        twin = da_ref.decode_attention_fused(q, k, v, kl, num_splits=ns, **kw)
        torch.testing.assert_close(out, twin, rtol=tol, atol=tol)
    assert not torch.allclose(uncapped.float(), oracle, rtol=tol, atol=tol), (
        f"the cap does not bind: uncapped misses by {(uncapped.float() - oracle).abs().max()}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_BINDING)
def test_partials_decode_softcap_holds_where_it_binds(cuda_device, case, dtype):
    """The partials kernel in the form ``partials_route`` names (bf16 at D
    64 / 80 / 128 / 256: "tc") and, on the tc form's inputs, the simt form,
    each within 2e-5 of the twin where the cap binds, and each without its
    cap beyond it (the running max sees the cap)."""
    q, k, v, kl, kw = _binding_decode(cuda_device, case, dtype)
    b, skv, h, kv, d = case[:5]
    qm = q.reshape(b * kv, h // kv, d)
    km, vm = (t.transpose(1, 2).reshape(b * kv, skv, d).contiguous() for t in (k, v))
    want = da_ref.decode_attention_partials(qm, km, vm, kl, num_splits=8, **kw)
    route = da_kernel.partials_route(dtype, d)
    for form in (route, "simt") if route == "tc" else (route,):
        got, uncapped = ([torch.empty(t.shape, device=cuda_device) for t in want]
                         for _ in range(2))
        for out, cap in ((got, kw["softcap"]), (uncapped, None)):
            da_kernel.launch(qm, km[:, :, None], vm[:, :, None], kl, *out, softcap=cap,
                             window=kw["window"], form=form)
        torch.cuda.synchronize()
        for name, x, y in zip(("m", "l", "acc"), got, want):
            torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-5, msg=f"{form} {name}")
        assert (uncapped[0] - want[0]).abs().max() > 1.0, form  # the running max sees the cap


# b, sq, skv, h, kv, d, causal, window, softcap, kv_len, q_offset, q_scale, dtype
FLASH_BINDING = [
    (2, 33, 77, 8, 2, 128, True, 24, 30.0, 60, True, 12.0, torch.bfloat16),  # short, D 128
    (2, 33, 77, 8, 2, 64, True, 24, 30.0, 60, True, 12.0, torch.bfloat16),  # short, D 64
    (64, 8, 8, 16, 8, 128, False, None, 50.0, None, True, 16.0, torch.bfloat16),  # short
    (2, 256, 256, 4, 4, 64, True, None, 50.0, None, False, 16.0, torch.float32),  # simt
    (3, 37, 53, 6, 3, 48, True, 20, 30.0, 41, True, 12.0, torch.float32),  # simt, D 48
    (3, 37, 53, 6, 3, 48, True, 20, 30.0, 41, True, 12.0, torch.bfloat16),  # simt in bf16
    (2, 4, 300, 8, 4, 128, True, 100, 30.0, 250, True, 12.0, torch.bfloat16),  # split, D 128
    (1, 1, 1024, 16, 16, 64, False, None, 30.0, None, True, 12.0, torch.bfloat16),  # split
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BINDING)
def test_flash_short_and_simt_softcap_holds_where_it_binds(cuda_device, case):
    b, sq, skv, h, kv, d, causal, window, cap, kv_len, q_off, q_scale, dtype = case
    route = fa_kernel.route(dtype, sq, d, h // kv, skv)
    short = "split" if h // kv * sq <= 8 and skv > 64 else "short"
    assert route == (short if dtype == torch.bfloat16 and d in (64, 128) else "simt")
    q, k, v = _fa_inputs(cuda_device, torch.float32, sq * skv + d + 3, b, sq, skv, h, kv, d)
    q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset_from_kv_len=q_off)
    fa_ops.reset_counts()
    out = fa_ops.flash_attention(q, k, v, kl, **kw)
    uncapped = fa_ops.flash_attention(q, k, v, kl, **{**kw, "logit_softcap": None})
    torch.cuda.synchronize()
    assert fa_ops.ROUTES[route] == 2
    want = fa_ops.plain_bshd(q, k, v, kl, **kw).float()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
    assert not torch.allclose(uncapped.float(), want, rtol=tol, atol=tol)


# ------------------------------------------------------- training (card) --

@pytest.mark.cuda
def test_kernel_wrappers_refuse_grad_on_the_card(cuda_device):
    from repro_torch.kernels.autograd import NoBackwardError

    q = torch.randn(1, 64, 2, 64, device=cuda_device, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=cuda_device)
    kl = torch.tensor([64], dtype=torch.int32, device=cuda_device)
    before = (dict(fa_ops.LAUNCHES), dict(da_ops.LAUNCHES), dict(ssd_ops.LAUNCHES))
    with pytest.raises(NoBackwardError):
        fa_ops.flash_attention(q, k, k)
    with pytest.raises(NoBackwardError):
        da_ops.decode_attention(q[:, :1], k, k, kl)
    x = torch.randn(1, 64, 2, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NoBackwardError):
        ssd_ops.intra_chunk(x, torch.rand(1, 64, 2, device=cuda_device),
                            -torch.ones(1, 2, device=cuda_device),
                            torch.randn(1, 64, 16, device=cuda_device),
                            torch.randn(1, 64, 16, device=cuda_device), chunk=32)
    assert (dict(fa_ops.LAUNCHES), dict(da_ops.LAUNCHES), dict(ssd_ops.LAUNCHES)) == before
    with torch.no_grad():
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.LAUNCHES["flash_attention"] == before[0]["flash_attention"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m", "grok-1-314b"])
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """Two AdamW steps of an f32 smoke model from the same weights and
    batches on the CPU and the card: losses and grad norms within rtol
    1e-4 (matmul sums in another order), parameters within 2 * lr a step
    (a near-zero gradient whose sign differs moves AdamW's early update by
    about 2 * lr) and all but 0.1% of them within 0.01 * lr."""
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokenStream, TokenStreamConfig, to_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    built = build_train_step(cfg, ShapeSpec("t", "train", 32, 4), num_microbatches=2)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0))
    stream = SyntheticTokenStream(TokenStreamConfig(cfg.vocab_size, 32, 4))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev, copy=True), params)  # the step donates
        s = built.optimizer.init(p)
        hist = []
        for step in range(2):
            p, s, m = built.fn(p, s, to_device(stream.batch(step), dev))
            hist.append((m["loss"].item(), m["grad_norm"].item()))
        runs[str(dev)] = (hist, [t.cpu() for t in leaves(p)])
    (h_cpu, p_cpu), (h_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(h_gpu, h_cpu, rtol=1e-4)
    lr, loose, total = built.optimizer.lr, 0, 0
    for a, b in zip(p_gpu, p_cpu):
        d = (a - b).abs()
        assert d.max().item() <= 2 * lr * 2
        loose += int((d > 0.01 * lr).sum())
        total += d.numel()
    assert loose <= 1e-3 * total


@pytest.mark.cuda
def test_one_rank_mesh_steps_on_the_card(cuda_device):
    """The model mesh on a one-rank NCCL group, (1, 1) ("data", "model"): a
    reduced bf16 qwen3 (head_dim 128, the kernel route) through
    ``build_prefill_step`` (tc flash on the local heads) and
    ``build_decode_step`` (the cache sharded on its rows: the partials
    kernel, then the combine) against the mesh-free prefill and fused
    decode on the same weights: logits within 2e-2 of their scale, every
    launch counted on its kernel and no plain twin run."""
    import socket

    import torch.distributed as dist

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.rules import rules_for_cell
    from repro_torch.models.model import random_model

    if not dist.is_nccl_available():
        pytest.fail("a card mesh runs on NCCL, which this torch lacks")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, device_type="cuda")
        model, params = random_model(get_config("qwen3-1.7b", bf16_check=True), seed=0,
                                     device=cuda_device)
        cfg, b, prompt, max_len, steps = model.cfg, 2, 128, 256, 3
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt + steps), device=cuda_device,
                               generator=torch.Generator(device=cuda_device).manual_seed(1))
        want, cache = [], None
        logits, cache = model.prefill(params, {"tokens": tokens[:, :prompt]}, max_len)
        want.append(logits.float())
        for t in range(prompt, prompt + steps):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
            want.append(logits.float())
        pshape = ShapeSpec("p", "prefill", max_len, b)
        dshape = ShapeSpec("d", "decode", max_len, b)
        dparams = st.distribute_params(params, model.param_axes(),
                                       rules_for_cell(cfg, mesh, "prefill", b), mesh)
        for ops in (fa_ops, da_ops):
            ops.reset_counts()
        prefill, decode = st.build_prefill_step(cfg, pshape, mesh), st.build_decode_step(
            cfg, dshape, mesh)
        logits, cache = prefill.fn(dparams, st.distribute_batch(
            {"tokens": tokens[:, :prompt]}, cfg, pshape, mesh))
        got = [logits.full_tensor().float()]
        for t in range(prompt, prompt + steps):
            tok = st.distribute_batch({"token": tokens[:, t:t + 1]}, cfg, dshape, mesh)["token"]
            logits, cache = decode.fn(dparams, tok, cache)
            got.append(logits.full_tensor().float())
        n = cfg.num_layers
        assert fa_ops.ROUTES["tc"] == n and not fa_ops.PLAIN_CALLS[fa_ops.KERNEL]
        assert da_ops.LAUNCHES[da_ops.KERNEL] == n * steps and da_ops.LAUNCHES[da_ops.FUSED] == 0
        assert not any(da_ops.PLAIN_CALLS.values())
        for w, g in zip(want, got):
            assert (w - g).abs().max().item() <= 2e-2 * w.abs().max().item()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 4097], ids=["global", "local"])
def test_long_decode_reads_the_last_rows_of_a_2_30_element_slice(cuda_device, window):
    """The index audit's cases (``chip_smoke.py`` phase 9b): gemma2-9b's
    global and local layers at long_500k, K and V [1, 524,288, 8, 256] bf16
    (2^30 elements, the last row's bytes just under 2^31; the local layer's
    window of 4,096 keys at their end).  Kv head j's key at row 524,287 - j
    points along its queries (scores ~16x the others' spread, past the
    softcap of 50) and its value is 4 + j: both mesh-free decode routes (the
    model's — "split" by ``decode_route`` for the global layer, "fused" for
    the window — and the fused kernel at 8 splits) must read those rows, as
    the plain twin does."""
    b, skv, h, kv, d, cap = 1, 524288, 16, 8, 256, 50.0
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((b, 1, h, d), generator=g, device=cuda_device, dtype=torch.bfloat16)
    k, v = (torch.randn((b, skv, kv, d), generator=g, device=cuda_device, dtype=torch.bfloat16)
            for _ in range(2))
    assert k.numel() == 2**30
    qg = q[:, 0].float().reshape(b, kv, h // kv, d).mean(dim=2)
    for j in range(kv):
        k[:, skv - 1 - j, j] = (8.0 * qg[:, j]).to(k.dtype)
        v[:, skv - 1 - j, j] = 4.0 + j
    want_rows = (4.0 + torch.arange(kv, device=cuda_device)).repeat_interleave(h // kv)
    kl = torch.full((1,), skv, dtype=torch.int32, device=cuda_device)
    kw = dict(softcap=cap, window=window)
    oracle = da_ref.reference_decode(q, k, v, kl, **kw).float()
    assert (oracle[0, 0, :, 0] - want_rows).abs().max().item() <= 2e-2
    route = da_ops.decode_route(torch.bfloat16, d, b * kv, skv, window)
    assert route == ("split" if window is None else "fused")
    da_ops.reset_counts()
    routed = da_ops.decode_attention(q, k, v, kl, **kw)
    fused = da_ops.decode_attention(q, k, v, kl, num_splits=8, **kw)
    torch.cuda.synchronize()
    assert da_ops.ROUTES == ({"tc": 1, "simt": 0, "split": 1} if route == "split"
                             else {"tc": 2, "simt": 0, "split": 0}), da_ops.ROUTES
    for name, out in ((route, routed), ("fused", fused)):
        out = out.float()
        assert (out - oracle).abs().max().item() <= 2e-2, name
        assert (out[0, 0, :, 0] - want_rows).abs().max().item() <= 2e-2, name


@pytest.mark.cuda
def test_rope_on_the_card_is_the_cpus_at_long_positions(cuda_device):
    """``rope_frequencies`` on the card is the CPU's bitwise (the card's pow
    rounded D 64's an ulp apart, ~2e-3 of the rotation at 524,287), and
    ``apply_rope`` agrees within 2e-5 of its input's scale at the long
    cells' positions."""
    from repro_torch.models.layers import apply_rope, rope_frequencies

    pos = torch.tensor([0, 4095, 32767, 524287])
    for d, theta in ((64, 1e4), (80, 1e4), (128, 1e6), (256, 1e4), (256, 1e6)):
        assert torch.equal(rope_frequencies(d, theta, cuda_device).cpu(),
                           rope_frequencies(d, theta))
        x = torch.randn((2, 4, 3, d), generator=torch.Generator().manual_seed(d))
        err = (apply_rope(x.to(cuda_device), pos.to(cuda_device), theta).cpu()
               - apply_rope(x, pos, theta)).abs().max().item()
        assert err <= 2e-5 * x.abs().max().item(), (d, theta, err)
