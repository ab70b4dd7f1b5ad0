"""Quality metrics (paper Eq. 2, 3, 14, 15).

Port of ``repro.core.metrics``: ``true_f_alpha`` against ground truth (Eq. 2)
in torch, and the numpy curve helpers — Eq. 14 gain, Eq. 15 linear-decay
weight, Eq. 3 progressiveness — copied as they are.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def true_precision_recall_f(answer_mask, truth_mask, alpha: float = 1.0):
    """Eq. 2 with the paper's F_alpha = (1+a) Pre Rec / (a Pre + Rec).

    Reduces over the last axis, so [S, N] masks give [S] results.
    """
    a = answer_mask.to(torch.float32)
    g = truth_mask.to(torch.float32)
    inter = (a * g).sum(-1)
    pre = inter / torch.clamp_min(a.sum(-1), 1.0)
    rec = inter / torch.clamp_min(g.sum(-1), 1.0)
    f = (1.0 + alpha) * pre * rec / torch.clamp_min(alpha * pre + rec, 1e-9)
    return pre, rec, f


def true_f_alpha(answer_mask, truth_mask, alpha: float = 1.0) -> torch.Tensor:
    return true_precision_recall_f(answer_mask, truth_mask, alpha)[2]


def gain_curve(f_values: np.ndarray) -> np.ndarray:
    """Eq. 14: gain(t) = (F1(t) - F1_min) / (F1_max - F1_min)."""
    f = np.asarray(f_values, dtype=np.float64)
    lo, hi = float(f.min()), float(f.max())
    if hi - lo < 1e-12:
        return np.ones_like(f)
    return (f - lo) / (hi - lo)


def linear_decay_weight(t: np.ndarray, budget: float) -> np.ndarray:
    """Eq. 15: W(t) = max(1 - (t-1)/budget, 0)."""
    return np.maximum(1.0 - (np.asarray(t, np.float64) - 1.0) / budget, 0.0)


def progressive_qty(
    costs: Sequence[float], f_values: Sequence[float], budget: float | None = None
) -> float:
    """Eq. 3: Qty = sum_i W(v_i) * Imp(v_i) over sampled cost points v_i.

    ``costs`` must be ascending; Imp(v_i) = F(v_i) - F(v_{i-1}) with F(v_0)=F[0].
    """
    c = np.asarray(costs, np.float64)
    f = np.asarray(f_values, np.float64)
    if budget is None:
        budget = float(c[-1]) if len(c) else 1.0
    w = linear_decay_weight(c, budget)
    imp = np.diff(np.concatenate([[f[0]], f]))
    return float(np.sum(w * imp))


def area_under_quality_curve(costs, f_values) -> float:
    """Trapezoid AUC of quality-vs-cost, normalized by the cost span."""
    c = np.asarray(costs, np.float64)
    f = np.asarray(f_values, np.float64)
    if len(c) < 2:
        return float(f[0]) if len(f) else 0.0
    span = c[-1] - c[0]
    if span <= 0:
        return float(f[-1])
    return float(np.trapezoid(f, c) / span)
