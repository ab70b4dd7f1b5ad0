"""Answer-set selection (paper section 3.3, Theorem 1, Lemma 1).

Port of ``repro.core.threshold``.  Sorting objects by joint probability
descending, expected F_alpha of the prefix answer set peaks once, so the
optimal answer is the argmax prefix of

    E(F_a)(m) = (1 + a) * cumsum(P)[m] / (a * sum(P) + m + 1)        (Eq. 6)

computed with one sort + one prefix sum.  Batched over any leading axes
(one row per tenant slot).

The prefix sums and totals accumulate in f64.  Over a block of tied joint
probabilities (every cold row of a tenant shares one prior joint) the curve
is mathematically monotone but nearly flat, and f32 prefix sums over
thousands of rows carry more rounding than the curve's step: the argmax —
and so the answer set — would then be decided by summation order, which
differs between the CPU, the card and XLA.  In f64 the rounding sits ~9
orders of magnitude below that step, so every device picks the same prefix.
E(F) and the other statistics are returned in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AnswerSelection(NamedTuple):
    mask: torch.Tensor  # [..., N] bool membership of Answer_i
    threshold: torch.Tensor  # [...] f32, P_tau of Lemma 1
    expected_f: torch.Tensor  # [...] f32, E(F_alpha) of the selected set
    expected_precision: torch.Tensor  # [...] f32
    expected_recall: torch.Tensor  # [...] f32
    size: torch.Tensor  # [...] int


def expected_f_curve(sorted_desc: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """E(F_alpha)(m) for every prefix length m+1 of a descending-sorted P
    vector, accumulated and returned in f64."""
    x = sorted_desc.to(torch.float64)
    cs = torch.cumsum(x, dim=-1)
    k = x.sum(-1, keepdim=True)
    m = torch.arange(1, x.shape[-1] + 1, dtype=torch.float64, device=x.device)
    return (1.0 + alpha) * cs / (alpha * k + m)


def select_answer(joint_prob: torch.Tensor, alpha: float = 1.0) -> AnswerSelection:
    """Exact Theorem-1 selection via full sort + argmax prefix.

    Ties at the threshold are filled lowest index first, so membership is
    deterministic.
    """
    sorted_desc = torch.sort(joint_prob, dim=-1, descending=True).values
    curve = expected_f_curve(sorted_desc, alpha)
    m_star = torch.argmax(curve, dim=-1, keepdim=True)  # first maximum
    threshold = torch.gather(sorted_desc, -1, m_star)
    above = joint_prob > threshold
    equal = joint_prob == threshold
    need = (m_star + 1) - above.sum(-1, keepdim=True)
    eq_rank = torch.cumsum(equal.to(torch.int64), dim=-1) - 1
    mask = above | (equal & (eq_rank < need))
    k = joint_prob.to(torch.float64).sum(-1)
    s = torch.where(mask, joint_prob.to(torch.float64), 0.0).sum(-1)
    n_sel = mask.sum(-1)
    size = torch.clamp_min(n_sel, 1)
    return AnswerSelection(
        mask=mask,
        threshold=threshold[..., 0],
        expected_f=torch.gather(curve, -1, m_star)[..., 0].to(torch.float32),
        expected_precision=(s / size).to(torch.float32),
        expected_recall=(s / torch.clamp_min(k, 1e-9)).to(torch.float32),
        size=n_sel,
    )


def select_answer_approx(
    joint_prob: torch.Tensor, alpha: float = 1.0, bins: int = 4096
) -> AnswerSelection:
    """Histogram-sketch Theorem-1 selection over a 1-D ``joint_prob``: the E(F)
    curve at bin granularity, thresholded at the best bin's lower edge."""
    p = torch.clamp(joint_prob, 0.0, 1.0)
    idx = torch.clamp((p * bins).to(torch.int64), 0, bins - 1)
    counts = torch.zeros(bins, device=p.device).index_add_(0, idx, torch.ones_like(p))
    sums = torch.zeros(bins, device=p.device).index_add_(0, idx, p)
    c_cum = torch.cumsum(counts.flip(0), 0)
    s_cum = torch.cumsum(sums.flip(0), 0)
    k = p.sum()
    curve = (1.0 + alpha) * s_cum / (alpha * k + torch.clamp_min(c_cum, 1.0))
    curve = torch.where(c_cum > 0, curve, float("-inf"))
    b_star = torch.argmax(curve)
    threshold = (bins - 1 - b_star).to(torch.float32) / bins
    mask = p >= threshold
    s = torch.where(mask, p, 0.0).sum()
    n_sel = mask.sum()
    size = torch.clamp_min(n_sel, 1)
    return AnswerSelection(
        mask=mask,
        threshold=threshold,
        expected_f=(1.0 + alpha) * s / (alpha * k + size),
        expected_precision=s / size,
        expected_recall=s / torch.clamp_min(k, 1e-9),
        size=n_sel,
    )


def expected_f_of_mask(
    joint_prob: torch.Tensor, mask: torch.Tensor, alpha: float = 1.0
) -> torch.Tensor:
    """E(F_alpha) of an arbitrary candidate answer set (Eq. 6), summed at
    ``joint_prob``'s dtype over all its elements, as the reference sums."""
    mask = mask.to(torch.bool)
    s = torch.where(mask, joint_prob, 0.0).sum()
    size = torch.clamp_min(mask.sum(), 1)
    k = joint_prob.sum()
    return (1.0 + alpha) * s / (alpha * k + size)
