"""Wrappers: enrichment state -> ``TripleBenefits`` via the scoring kernels.

Both keep the reference's signatures (``repro/kernels/enrich_score/ops.py``):
``fused_benefits`` scores one conjunctive query's ``EnrichmentState`` (the
operator's ``benefit_fn`` route, ``[N, P]`` leaves) and
``fused_benefits_batched`` a shared substrate for Q queries (``[Q, N, P]``
leaves).  They route by the device of their tensors: on the CPU they run
the plain PyTorch versions (``ref.py``); on CUDA tensors they launch the
hand-written kernels or raise — they never fall back, read no environment
switch, and refuse tensors on mixed devices.  The kernels have no backward
pass: an input that requires grad under grad mode is refused
(``kernels.autograd``).

Every table the reference scores is taken: ``kernel.table_route`` picks
the "smem" route (the table staged in shared memory) or the "global" route
(the table read from device memory) from the shapes alone.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` plain-path calls,
one plain integer per kernel, so a run can show that its main path went
through the kernels; ``TABLE_ROUTES[(kernel, route)]`` counts the launches
by table route (``reset_counts`` zeroes all three).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.benefit import TripleBenefits
from repro_torch.core.decision_table import DecisionTable
from repro_torch.core.entropy import inverse_entropy_table
from repro_torch.core.errors import SubstrateDtypeError
from repro_torch.kernels.autograd import refuse_grad
from repro_torch.kernels.enrich_score import kernel, ref

KERNELS = ("enrich_score_table", "enrich_score_best", "enrich_score_single")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
TABLE_ROUTES = {(k, route): 0 for k in KERNELS for route in kernel.ROUTES}
PROB_DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS, TABLE_ROUTES):
        for k in counts:
            counts[k] = 0


def _pick_route(name, mode, p, s, b, f, lut_bins) -> str:
    if mode == "best" and f > kernel.WIDE_MAX_FUNCTIONS:
        raise ValueError(f"{name}: best mode takes at most {kernel.WIDE_MAX_FUNCTIONS} "
                         f"functions, not {f}")
    route = kernel.table_route(mode, p, s, b, f, lut_bins)
    smem = kernel.global_smem_bytes(p, f, lut_bins)
    if route == "global" and smem > kernel.SMEM_LIMIT:
        raise ValueError(
            f"{name}: the global route's costs and LUT need {smem} bytes of shared memory, more "
            f"than the {kernel.SMEM_LIMIT} a Hopper block can use"
        )
    return route


@functools.lru_cache(maxsize=8)
def _lut(bins: int, device: torch.device) -> torch.Tensor:
    return inverse_entropy_table(bins, device)


def _check_cuda_operands(device, named: dict) -> None:
    for name, (t, dtypes, shape) in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_devices(device, named: dict) -> None:
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def fused_benefits(
    state,  # EnrichmentState (f32 rows)
    query,  # CompiledQuery, conjunctive
    table: DecisionTable,
    costs: torch.Tensor,  # [P, F] f32
    candidate_mask=None,  # [N] bool; None: ~state.in_answer
    lut_bins: int = 4096,
) -> TripleBenefits:
    """Single-query table-mode Eq. 11 -> [N, P] leaves (the reference's
    ``fused_benefits``, a drop-in for ``core.benefit.compute_benefits`` on
    conjunctive queries, passed to the operator as ``benefit_fn``).

    The benefit is -inf where no function remains or the object is no
    candidate.  ``cost`` is UNFLOORED, ``costs[p, max(fn, 0)]``, as the
    reference returns it; the benefit divides by the floored cost.
    Rows are scored as f32, as the reference's wrapper casts them.
    """
    if not query.is_conjunctive:
        raise ValueError("fused_benefits covers the conjunctive fast path only")
    name = "enrich_score_single"
    refuse_grad(name, state.pred_prob, state.uncertainty, state.joint_prob, costs)
    n, p = state.pred_prob.shape
    if candidate_mask is None:
        candidate_mask = ~state.in_answer
    dev = state.pred_prob.device
    _check_devices(dev, {
        "uncertainty": state.uncertainty, "joint_prob": state.joint_prob,
        "exec_mask": state.exec_mask, "candidate_mask": candidate_mask, "costs": costs,
        "delta_h": table.delta_h, "next_fn": table.next_fn,
    })
    pp, unc, joint = (x.to(torch.float32) for x in
                      (state.pred_prob, state.uncertainty, state.joint_prob))
    sid = state.state_id()
    cand = candidate_mask.to(torch.bool)
    lut = _lut(lut_bins, dev)
    if dev.type == "cpu":
        PLAIN_CALLS[name] += 1
        benefit, nf, est, cost = ref.enrich_score_single_ref(
            pp, unc, sid, joint, cand, table.delta_h, table.next_fn, costs, lut
        )
    elif dev.type == "cuda":
        f = costs.shape[1]
        s, b = table.delta_h.shape[1], table.delta_h.shape[2]
        pp, unc, joint, cand = (x.contiguous() for x in (pp, unc, joint, cand))
        _check_cuda_operands(dev, {
            "pred_prob": (pp, (torch.float32,), (n, p)),
            "uncertainty": (unc, (torch.float32,), (n, p)),
            "state_id": (sid, (torch.int32,), (n, p)),
            "joint_prob": (joint, (torch.float32,), (n,)),
            "candidate_mask": (cand, (torch.bool,), (n,)),
            "costs": (costs, (torch.float32,), (p, f)),
            "lut": (lut, (torch.float32,), (lut_bins,)),
            "delta_h": (table.delta_h, (torch.float32,), (p, s, b)),
            "next_fn": (table.next_fn, (torch.int32,), (p, s, b)),
        })
        route = _pick_route(name, "single", p, s, b, f, lut_bins)
        out = (
            torch.empty((n, p), dtype=torch.float32, device=dev),
            torch.empty((n, p), dtype=torch.int32, device=dev),
            torch.empty((n, p), dtype=torch.float32, device=dev),
            torch.empty((n, p), dtype=torch.float32, device=dev),
        )
        kernel.launch_single(pp, unc, sid, joint, cand, table.delta_h, table.next_fn,
                             costs, lut, out, route)
        LAUNCHES[name] += 1
        TABLE_ROUTES[(name, route)] += 1
        benefit, nf, est, cost = out
    else:
        raise ValueError(f"fused_benefits runs on cpu or cuda, not {dev}")
    return TripleBenefits(benefit=benefit, next_fn=nf, est_joint=est, cost=cost)


def fused_benefits_batched(
    pred_prob: torch.Tensor,  # [N, P] shared predicate probabilities (f32 | bf16)
    uncertainty: torch.Tensor,  # [N, P] same dtype
    state_id: torch.Tensor,  # [N, P] int32
    joint_prob: torch.Tensor,  # [Q, N] same dtype
    table: DecisionTable,
    costs: torch.Tensor,  # [P, F] f32
    function_selection: str = "table",  # "table" | "best"
    lut_bins: int = 4096,
) -> TripleBenefits:
    """Multi-query Eq. 11 over a shared substrate -> [Q, N, P] leaves.

    Validity/candidate masking beyond exhausted triples is the caller's job.
    Probability operands stay at their storage dtype (bf16 is upcast
    exactly inside the kernel); mixed probability dtypes raise
    ``SubstrateDtypeError`` rather than promote.
    """
    refuse_grad(KERNELS[function_selection == "best"], pred_prob, uncertainty, joint_prob,
                costs)
    if not (pred_prob.dtype == uncertainty.dtype == joint_prob.dtype):
        raise SubstrateDtypeError(
            f"fused scoring needs one probability dtype; got pred_prob="
            f"{pred_prob.dtype}, uncertainty={uncertainty.dtype}, "
            f"joint_prob={joint_prob.dtype}",
            expected=str(pred_prob.dtype),
            got=f"{uncertainty.dtype}/{joint_prob.dtype}",
            where="fused_benefits_batched",
        )
    if function_selection not in ("table", "best"):
        raise ValueError(f"unknown function_selection: {function_selection!r}")
    best = function_selection == "best"
    if best and table.delta_h_all is None:
        raise ValueError("best-mode scoring needs a table learned with delta_h_all")
    name = KERNELS[best]
    dev = pred_prob.device
    lut = _lut(lut_bins, dev)

    if dev.type == "cpu":
        PLAIN_CALLS[name] += 1
        if best:
            out = ref.enrich_score_best_ref(
                pred_prob, uncertainty, state_id, joint_prob, table.delta_h_all, costs, lut
            )
        else:
            out = ref.enrich_score_table_ref(
                pred_prob, uncertainty, state_id, joint_prob,
                table.delta_h, table.next_fn, costs, lut,
            )
        return TripleBenefits(*out)
    if dev.type != "cuda":
        raise ValueError(f"fused_benefits_batched runs on cpu or cuda, not {dev}")

    n, p = pred_prob.shape
    q = joint_prob.shape[0]
    f = costs.shape[1]
    tab = table.delta_h_all if best else table.delta_h
    s, b = tab.shape[1], tab.shape[2]
    operands = {
        "pred_prob": (pred_prob, PROB_DTYPES, (n, p)),
        "uncertainty": (uncertainty, PROB_DTYPES, (n, p)),
        "state_id": (state_id, (torch.int32,), (n, p)),
        "joint_prob": (joint_prob, PROB_DTYPES, (q, n)),
        "costs": (costs, (torch.float32,), (p, f)),
        "lut": (lut, (torch.float32,), (lut_bins,)),
    }
    if best:
        operands["delta_h_all"] = (tab, (torch.float32,), (p, s, b, f))
    else:
        operands["delta_h"] = (tab, (torch.float32,), (p, s, b))
        operands["next_fn"] = (table.next_fn, (torch.int32,), (p, s, b))
    _check_cuda_operands(dev, operands)
    route = _pick_route(name, function_selection, p, s, b, f, lut_bins)
    if best and route == "smem" and p in (2, 4):
        # the smem route's kernel reads an object's [P] row as one vector
        for label, t in (("pred_prob", pred_prob), ("uncertainty", uncertainty),
                         ("state_id", state_id)):
            width = p * t.element_size()
            if t.data_ptr() % width:
                raise ValueError(f"{name}: {label} must start on a {width}-byte boundary")

    out = (
        torch.empty((q, n, p), dtype=torch.float32, device=dev),
        torch.empty((q, n, p), dtype=torch.int32, device=dev),
        torch.empty((q, n, p), dtype=torch.float32, device=dev),
        torch.empty((q, n, p), dtype=torch.float32, device=dev),
    )
    if best:
        kernel.launch_best(pred_prob, uncertainty, state_id, joint_prob, tab, costs, lut, out,
                           route)
    else:
        kernel.launch_table(
            pred_prob, uncertainty, state_id, joint_prob, tab, table.next_fn, costs, lut, out,
            route,
        )
    LAUNCHES[name] += 1
    TABLE_ROUTES[(name, route)] += 1
    return TripleBenefits(*out)
