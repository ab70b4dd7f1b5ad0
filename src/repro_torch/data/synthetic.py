"""Synthetic corpora with planted ground truth + AUC-calibrated tagging
functions (stand-ins for the paper's image/tweet corpora, section 6.1).

Port of ``repro.data.synthetic``, drawing from a seeded ``torch.Generator``
on the target device (the numbers differ from ``jax.random``'s; the
statistical structure is the same):

* each object has one true tag per tag type (selectivity-controllable);
* a function of target quality AUC_f scores ``s = mu_f (2y - 1) + eps``,
  ``eps ~ N(0, 1)``, ``mu_f = Phi^-1(AUC_f) / sqrt(2)``, and outputs the
  calibrated posterior ``p = sigmoid(2 mu_f s + logit(prior))``;
* function costs follow the paper's Table-1 spread.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

# Paper Table 1 (MUCT): DT / GNB / (RF) / SVM — cost seconds, quality AUC.
TABLE1_COSTS = (0.023, 0.114, 0.420, 0.949)
TABLE1_AUCS_MUCT = (0.61, 0.67, 0.69, 0.71)
TABLE1_AUCS_MULTIPIE = (0.53, 0.84, 0.86, 0.89)


@dataclasses.dataclass
class SyntheticCorpus:
    """Planted-truth corpus + materialized tagging-function outputs."""

    truth_tags: torch.Tensor  # [N, T] int32 true tag per tag type
    func_probs: torch.Tensor  # [N, P, F] calibrated outputs of every function
    func_scores: torch.Tensor  # [N, P, F] raw (uncalibrated) scores
    truth_pred: torch.Tensor  # [N, P] bool: does the object satisfy predicate j
    features: torch.Tensor  # [N, D] object features (for model cascades)
    aucs: torch.Tensor  # [P, F] target qualities
    costs: torch.Tensor  # [P, F] function costs (seconds)
    priors: torch.Tensor  # [P] P(predicate true)


def _mu_for_auc(auc: torch.Tensor) -> torch.Tensor:
    """Separation mu such that N(mu,1) vs N(-mu,1) scores give the target AUC."""
    return torch.special.ndtri(torch.clamp(auc, 0.5 + 1e-4, 1 - 1e-4)) / math.sqrt(2.0)


def make_corpus(
    generator: torch.Generator,
    num_objects: int,
    predicate_tag_types: Sequence[int],
    predicate_tags: Sequence[int],
    tags_per_type: int = 4,
    num_tag_types: int | None = None,
    aucs=TABLE1_AUCS_MUCT,
    costs=TABLE1_COSTS,
    selectivity=0.25,
    feature_dim: int = 64,
) -> SyntheticCorpus:
    """Draw a corpus on ``generator.device`` (pass a seeded generator)."""
    dev = generator.device
    p = len(predicate_tag_types)
    aucs = np.asarray(aucs, np.float32)
    if aucs.ndim == 1:
        aucs = np.broadcast_to(aucs[None, :], (p, aucs.shape[0]))
    costs = np.asarray(costs, np.float32)
    if costs.ndim == 1:
        costs = np.broadcast_to(costs[None, :], (p, costs.shape[0]))
    f = aucs.shape[1]
    if num_tag_types is None:
        num_tag_types = max(predicate_tag_types) + 1
    sel = torch.tensor(
        np.broadcast_to(np.asarray(selectivity, np.float32), (p,)).copy(), device=dev
    )
    aucs_t = torch.tensor(np.ascontiguousarray(aucs), device=dev)
    costs_t = torch.tensor(np.ascontiguousarray(costs), device=dev)

    # Plant truth per predicate at the requested selectivity, then derive
    # per-tag-type tags consistent with it.
    truth_pred = torch.rand((num_objects, p), generator=generator, device=dev) < sel[None, :]
    alt = torch.randint(
        0, max(tags_per_type - 1, 1), (num_objects, p), generator=generator, device=dev
    )
    truth_tags = torch.zeros((num_objects, num_tag_types), dtype=torch.int32, device=dev)
    for j, (tt, tg) in enumerate(zip(predicate_tag_types, predicate_tags)):
        other = torch.where(alt[:, j] >= tg, alt[:, j] + 1, alt[:, j])
        other = torch.clamp(other, 0, tags_per_type - 1)
        truth_tags[:, tt] = torch.where(truth_pred[:, j], tg, other).to(torch.int32)

    y = truth_pred.to(torch.float32)
    mu = _mu_for_auc(aucs_t)  # [P, F]
    eps = torch.randn((num_objects, p, f), generator=generator, device=dev)
    scores = mu[None] * (2.0 * y[:, :, None] - 1.0) + eps
    prior_logit = torch.log(sel) - torch.log1p(-sel)
    probs = torch.sigmoid(2.0 * mu[None] * scores + prior_logit[None, :, None])

    # Features: class-conditional Gaussian mixture so real models can learn.
    proto = torch.randn(
        (num_tag_types, tags_per_type, feature_dim), generator=generator, device=dev
    )
    feats = torch.zeros((num_objects, feature_dim), device=dev)
    for tt in range(num_tag_types):
        feats = feats + proto[tt, truth_tags[:, tt].long()]
    feats = feats + 0.8 * torch.randn(
        (num_objects, feature_dim), generator=generator, device=dev
    )
    return SyntheticCorpus(
        truth_tags=truth_tags,
        func_probs=probs,
        func_scores=scores,
        truth_pred=truth_pred,
        features=feats,
        aucs=aucs_t,
        costs=costs_t,
        priors=sel,
    )


def truth_answer_mask(corpus: SyntheticCorpus, query) -> torch.Tensor:
    """Ground-truth membership for a compiled query (exact boolean semantics)."""
    return query.evaluate(corpus.truth_pred.to(torch.float32)) > 0.5


def split_corpus(corpus: SyntheticCorpus, n_train: int):
    """Train/eval split along the object axis."""

    def part(sl):
        return SyntheticCorpus(
            truth_tags=corpus.truth_tags[sl],
            func_probs=corpus.func_probs[sl],
            func_scores=corpus.func_scores[sl],
            truth_pred=corpus.truth_pred[sl],
            features=corpus.features[sl],
            aucs=corpus.aucs,
            costs=corpus.costs,
            priors=corpus.priors,
        )

    return part(slice(None, n_train)), part(slice(n_train, None))
