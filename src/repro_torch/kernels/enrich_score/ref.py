"""Plain PyTorch versions of the three ``enrich_score`` kernels.

They compute, op for op and rounding for rounding, what the CUDA kernels in
``csrc/enrich_score.cu`` compute, which is what the reference's Pallas
kernels compute (``repro/kernels/enrich_score/kernel.py``
``_score_table_tile`` / ``_score_best_tile``) without their TPU encodings:
``next_fn`` is int32 and an invalid lane's benefit is ``-inf``.  Every
elementwise op rounds to f32 on its own (eager PyTorch never contracts a
multiply-add), matching the kernels built with ``--fmad=false``.

Scoring reads the STORED uncertainty ``h`` (not a recomputed entropy) for
both the bin and ``h_hat``, like the kernels.  Inputs may be bf16; the first
touch upcasts exactly to f32.

Shapes: ``pred_prob``/``unc``/``state_id`` [C, P], ``joint`` [Q, C];
outputs ``(benefit, next_fn, est_joint, cost)`` each [Q, C, P].  The
single-query twin takes ``joint`` [C] and a candidate mask ``cand`` [C] and
returns [C, P] leaves.
"""

from __future__ import annotations

import torch

from repro_torch.core.entropy import lut_lerp

CLIP_HI = 1.0 - 1e-7  # rounds to the f32 bin-clip bound when applied to f32
MIN_P = 1e-12
MIN_COST = 1e-9


def _bins(h: torch.Tensor, num_bins: int) -> torch.Tensor:
    return torch.floor(torch.clamp(h, 0.0, CLIP_HI) * num_bins).long()


def _est_joint(joint: torch.Tensor, p: torch.Tensor, p_hat: torch.Tensor) -> torch.Tensor:
    """clip(where(p > 0, joint / max(p, 1e-12) * p_hat, 0), 0, 1) -> [Q, C, P]."""
    est = torch.where(
        p > 0, joint[:, :, None] / torch.clamp_min(p, MIN_P) * p_hat, 0.0
    )
    return torch.clamp(est, 0.0, 1.0)


def enrich_score_table_ref(
    pred_prob: torch.Tensor,  # [C, P] f32 | bf16
    unc: torch.Tensor,  # [C, P] same dtype
    state_id: torch.Tensor,  # [C, P] int32
    joint: torch.Tensor,  # [Q, C] same dtype
    delta_tab: torch.Tensor,  # [P, S, B] f32
    next_tab: torch.Tensor,  # [P, S, B] int32
    costs: torch.Tensor,  # [P, F] f32
    lut: torch.Tensor,  # [L] f32
):
    """Table-mode Eq. 11 (the paper's decision-table function choice)."""
    h, p, j = unc.float(), pred_prob.float(), joint.float()
    q = j.shape[0]
    c, np_ = p.shape
    pred = torch.arange(np_, device=p.device)[None, :]
    sid = state_id.long()
    b = _bins(h, delta_tab.shape[2])
    delta = delta_tab[pred, sid, b]
    fn = next_tab[pred, sid, b]
    p_hat = lut_lerp(torch.clamp(h + delta, 0.0, 1.0), lut)
    cost = torch.clamp_min(costs[pred, torch.clamp_min(fn, 0).long()], MIN_COST)
    est = _est_joint(j, p, p_hat)
    benefit = torch.where(fn >= 0, j[:, :, None] * est / cost, float("-inf"))
    return (
        benefit,
        fn.to(torch.int32).expand(q, c, np_).contiguous(),
        est,
        cost.expand(q, c, np_).contiguous(),
    )


def enrich_score_single_ref(
    pred_prob: torch.Tensor,  # [C, P] f32
    unc: torch.Tensor,  # [C, P] f32
    state_id: torch.Tensor,  # [C, P] int32
    joint: torch.Tensor,  # [C] f32
    cand: torch.Tensor,  # [C] bool: candidate objects
    delta_tab: torch.Tensor,  # [P, S, B] f32
    next_tab: torch.Tensor,  # [P, S, B] int32
    costs: torch.Tensor,  # [P, F] f32
    lut: torch.Tensor,  # [L] f32
):
    """Single-query table mode (the reference's ``enrich_score_tiles``):
    the table-mode lane math for one query, with the benefit of a
    non-candidate object set to -inf.  ``next_fn``, ``est_joint`` and
    ``cost`` are returned as computed for every lane; ``cost`` is the
    UNFLOORED table entry ``costs[p, max(fn, 0)]``, while the benefit divides
    by the floored one."""
    benefit, fn, est, _ = (
        x[0] for x in enrich_score_table_ref(
            pred_prob, unc, state_id, joint[None], delta_tab, next_tab, costs, lut)
    )
    benefit = torch.where(cand[:, None], benefit, float("-inf"))
    pred = torch.arange(fn.shape[1], device=fn.device)[None, :]
    return benefit, fn, est.contiguous(), costs[pred, torch.clamp_min(fn, 0).long()]


def enrich_score_best_ref(
    pred_prob: torch.Tensor,  # [C, P] f32 | bf16
    unc: torch.Tensor,  # [C, P]
    state_id: torch.Tensor,  # [C, P] int32
    joint: torch.Tensor,  # [Q, C]
    delta_all: torch.Tensor,  # [P, S, B, F] f32, +inf where unavailable
    costs: torch.Tensor,  # [P, F] f32
    lut: torch.Tensor,  # [L] f32
):
    """Best mode: Eq. 11 for every remaining function, first strict maximum."""
    h, p, j = unc.float(), pred_prob.float(), joint.float()
    q = j.shape[0]
    c, np_ = p.shape
    f = costs.shape[1]
    pred = torch.arange(np_, device=p.device)[None, :]
    deltas = delta_all[pred, state_id.long(), _bins(h, delta_all.shape[2])]  # [C, P, F]
    cost_pf = torch.clamp_min(costs, MIN_COST)
    best_ben = torch.full((q, c, np_), float("-inf"), device=p.device)
    best_fn = torch.full((q, c, np_), -1, dtype=torch.int32, device=p.device)
    best_ej = torch.zeros((q, c, np_), device=p.device)
    for fi in range(f):
        d = deltas[..., fi]
        invalid = torch.isinf(d)
        p_hat = lut_lerp(torch.clamp(h + torch.where(invalid, 0.0, d), 0.0, 1.0), lut)
        est = _est_joint(j, p, p_hat)
        ben = torch.where(invalid, float("-inf"), j[:, :, None] * est / cost_pf[:, fi])
        better = ben > best_ben  # strict: ties keep the FIRST maximum
        best_ben = torch.where(better, ben, best_ben)
        best_fn = torch.where(better, fi, best_fn)
        best_ej = torch.where(better, est, best_ej)
    cost = torch.clamp_min(costs[pred, torch.clamp_min(best_fn, 0).long()], MIN_COST)
    return best_ben, best_fn, best_ej, cost
