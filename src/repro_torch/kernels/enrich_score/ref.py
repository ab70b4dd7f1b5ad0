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
# the lane kernels' screen (csrc/enrich_score.cu, header): margin and range
SCREEN = 1.0 - 2.0**-20
SCREEN_LO, SCREEN_HI, SCREEN_COST_HI = 2.0**-125, 2.0**125, 2.0**126


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


def best_screen(
    pred_prob: torch.Tensor,  # [C, P] f32 | bf16
    unc: torch.Tensor,  # [C, P]
    state_id: torch.Tensor,  # [C, P] int32
    joint: torch.Tensor,  # [Q, C]
    delta_all: torch.Tensor,  # [P, S, B, F] f32, +inf where unavailable
    costs: torch.Tensor,  # [P, F] f32
    lut: torch.Tensor,  # [L] f32
):
    """Best mode the way the lane kernels compute it (``best_screened`` in
    ``csrc/enrich_score.cu``), op for op: per (tenant, lane) and function in
    order the estimate ``e = (j * est) * inv`` (``inv`` = RN(1 / cost), -inf
    where the function no longer remains), the largest ``e1`` (its first
    function ``g``) and the runner-up ``e2 = fmax(e2, fmin(e, e1))``; where
    every ``j * est`` is zero, or ``e2 < e1 * (1 - 2^-20)`` with ``e1`` in
    [2^-125, 2^125] and every floored cost <= 2^126, one division for ``g``,
    else the exact fold.  -> ((benefit, next_fn, est_joint, cost), benefit
    divisions).  Bitwise ``enrich_score_best_ref`` wherever the screen's
    proof holds, which the CPU tests check; the count is the kernels' exact
    divisions on these inputs."""
    h, p, j = unc.float(), pred_prob.float(), joint.float()
    np_, f = p.shape[1], costs.shape[1]
    pred = torch.arange(np_, device=p.device)[None, :]
    deltas = delta_all[pred, state_id.long(), _bins(h, delta_all.shape[2])]  # [C, P, F]
    ok = ~torch.isinf(deltas)
    p_hat = lut_lerp(torch.clamp(h[..., None] + torch.where(ok, deltas, 0.0), 0.0, 1.0), lut)
    cost_pf = torch.clamp_min(costs, MIN_COST)
    inv = torch.where(ok, 1.0 / cost_pf, float("-inf"))  # [C, P, F]
    live = p > 0
    jq = j[:, :, None].expand(-1, -1, np_)  # [Q, C, P]
    r = jq / torch.clamp_min(p, MIN_P)
    e1 = torch.full_like(r, float("-inf"))
    e2, a1, est1 = e1.clone(), torch.zeros_like(r), torch.zeros_like(r)
    g = torch.full(r.shape, -1, dtype=torch.long, device=p.device)
    for fi in range(f):
        est = torch.where(live, torch.clamp(r * p_hat[..., fi], 0.0, 1.0), 0.0)
        a = jq * est
        e = a * inv[..., fi]
        e2 = torch.fmax(e2, torch.fmin(e, e1))
        up = e > e1
        e1, a1, est1 = torch.where(up, e, e1), torch.where(up, a, a1), torch.where(up, est, est1)
        g = torch.where(up, fi, g)
    screen = bool((cost_pf <= SCREEN_COST_HI).all())
    zero = (jq == 0) | (~live & torch.isfinite(jq))
    decided = ok.any(-1) & (g >= 0) & (zero | (screen & (e1 >= SCREEN_LO) & (e1 <= SCREEN_HI)
                                              & (e2 < e1 * SCREEN)))
    exact = enrich_score_best_ref(pred_prob, unc, state_id, joint, delta_all, costs, lut)
    cost_g = cost_pf[pred, g.clamp_min(0)]
    screened = (a1 / cost_g, g.to(torch.int32), est1, cost_g)
    out = tuple(torch.where(decided, s_, x) for s_, x in zip(screened, exact))
    divisions = torch.where(decided, 1, ok.sum(-1).expand_as(g)).sum()
    return out, int(divisions)
