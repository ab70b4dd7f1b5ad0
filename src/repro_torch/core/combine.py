"""Combine functions M_j (paper Eq. 1): fuse tagging-function outputs.

Port of ``repro.core.combine``: masked logistic pooling

    logit(p) = (sum_f m_f * w_f * logit(p_f) + b) / max(1, sum_f m_f)^rho

with per-function reliability weights ``w_f``, learned offline by gradient
descent on NLL (``fit_combine_weights``, ``torch.autograd`` in a plain loop)
or set from AUCs in closed form (``default_combine_params``); and Platt
scaling of one function's raw scores (``calibrate_platt`` / ``apply_platt``).
"""

from __future__ import annotations

import dataclasses

import torch


def _logit(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.clamp(p, eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


@dataclasses.dataclass
class CombineParams:
    """Parameters of M for one query: weights [P, F], bias [P], rho [P]."""

    weights: torch.Tensor  # [P, F] positive reliabilities
    bias: torch.Tensor  # [P]
    rho: torch.Tensor  # [P] normalization exponent in [0, 1]

    def to(self, device) -> "CombineParams":
        return CombineParams(*(x.to(device) for x in (self.weights, self.bias, self.rho)))


def reliability_weights_from_auc(auc: torch.Tensor, prior_default: float = 0.75) -> torch.Tensor:
    """w_f = logit(AUC_f), clipped; AUC 0.5 (noise) -> weight ~0."""
    auc = torch.where(torch.isfinite(auc), auc, prior_default)
    return torch.clamp_min(_logit(torch.clamp(auc, 0.5 + 1e-3, 1 - 1e-3)), 1e-3)


def default_combine_params(auc: torch.Tensor) -> CombineParams:
    """auc: [P, F] per-(predicate, function) quality -> prior combine params."""
    auc = torch.as_tensor(auc, dtype=torch.float32)
    p = auc.shape[0]
    return CombineParams(
        weights=reliability_weights_from_auc(auc),
        bias=torch.zeros(p, dtype=torch.float32, device=auc.device),
        rho=torch.full((p,), 0.5, dtype=torch.float32, device=auc.device),
    )


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (small) axis as a left fold, one rounding per add."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def combine_probabilities(
    params: CombineParams,
    func_probs: torch.Tensor,  # [..., P, F] raw outputs (garbage where unexecuted)
    exec_mask: torch.Tensor,  # [..., P, F] bool
    prior: float = 0.5,
) -> torch.Tensor:
    """M over executed functions only; objects with empty state get ``prior``.

    Returns [..., P] predicate probabilities.
    """
    m = exec_mask.to(torch.float32)
    logits = _logit(func_probs) * m * params.weights
    denom = torch.clamp_min(_fold_sum(m * params.weights), 1e-9)
    n_exec = _fold_sum(m)
    pooled = _fold_sum(logits) / denom
    sharp = torch.pow(torch.clamp_min(n_exec, 1.0), params.rho)
    out = torch.sigmoid(pooled * sharp + params.bias)
    return torch.where(n_exec > 0, out, torch.full_like(out, prior))


def fit_combine_weights(
    func_probs: torch.Tensor,  # [N, P, F] training outputs (all functions executed)
    labels: torch.Tensor,  # [N, P] in {0, 1}
    steps: int = 400,
    lr: float = 0.05,
) -> CombineParams:
    """Learn M offline by NLL descent (paper: "learned offline ... labeled data").

    Plain gradient descent from zero parameters, one ``torch.autograd.grad``
    per step — the same update the reference runs under ``lax.scan``.
    """
    func_probs = func_probs.to(torch.float32)
    labels = labels.to(torch.float32)
    n, p, f = func_probs.shape
    dev = func_probs.device
    full_mask = torch.ones((n, p, f), dtype=torch.bool, device=dev)
    theta = [
        torch.zeros((p, f), device=dev, requires_grad=True),
        torch.zeros((p,), device=dev, requires_grad=True),
        torch.zeros((p,), device=dev, requires_grad=True),
    ]

    def unpack(w, b, r):
        return CombineParams(
            weights=torch.nn.functional.softplus(w) + 1e-3, bias=b, rho=torch.sigmoid(r)
        )

    for _ in range(steps):
        pred = combine_probabilities(unpack(*theta), func_probs, full_mask)
        pred = torch.clamp(pred, 1e-6, 1 - 1e-6)
        nll = -(labels * torch.log(pred) + (1 - labels) * torch.log(1 - pred))
        grads = torch.autograd.grad(nll.mean(), theta)
        with torch.no_grad():
            theta = [(t - lr * g).requires_grad_(True) for t, g in zip(theta, grads)]
    with torch.no_grad():
        return unpack(*(t.detach() for t in theta))


def calibrate_platt(
    raw_scores: torch.Tensor, labels: torch.Tensor, steps: int = 300, lr: float = 0.1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Platt scaling (paper section 6.1 calibrates functions this way).

    Fits (a, b) minimizing the NLL of sigmoid(a * logit(s) + b) by plain
    gradient descent from (1, 0), one ``torch.autograd.grad`` per step, as
    the reference runs it under ``lax.scan``.  Returns (a, b).
    """
    raw_scores = raw_scores.to(torch.float32)
    labels = labels.to(torch.float32)
    logit = _logit(raw_scores)
    ab = torch.tensor([1.0, 0.0], device=raw_scores.device, requires_grad=True)
    for _ in range(steps):
        p = torch.clamp(torch.sigmoid(ab[0] * logit + ab[1]), 1e-6, 1 - 1e-6)
        nll = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p)).mean()
        (g,) = torch.autograd.grad(nll, ab)
        with torch.no_grad():
            ab = (ab - lr * g).requires_grad_(True)
    ab = ab.detach()
    return ab[0], ab[1]


def apply_platt(raw_scores: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(a * _logit(raw_scores) + b)


def auc_score(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Area under ROC via the rank statistic (ties unhandled, as the reference)."""
    scores = scores.reshape(-1)
    labels = labels.reshape(-1).to(torch.float32)
    order = torch.argsort(scores, stable=True)
    ranked = labels[order]
    n_pos = ranked.sum()
    n_neg = ranked.shape[0] - n_pos
    ranks = torch.arange(1, ranked.shape[0] + 1, dtype=torch.float32, device=scores.device)
    rank_sum = (ranks * ranked).sum()
    auc = (rank_sum - n_pos * (n_pos + 1) / 2.0) / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, 0.5)
