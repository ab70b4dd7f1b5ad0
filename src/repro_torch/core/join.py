"""Restricted probabilistic joins (paper section 5, Eq. 13).

Port of ``repro.core.join``.  For an equi-join on tag type T_l between
corpora O and V, under the independence assumption of probabilistic
databases:

    p_join(o_k) = p_l(o_k) * mean_i p_l(v_i)                        (Eq. 13)

so the join predicate behaves like an extra predicate column; benefits then
flow through Eq. 11 unchanged.
"""

from __future__ import annotations

import torch


def join_predicate_probability(
    own_pred_prob: torch.Tensor,  # [N] p of each o_k containing the join tag
    partner_pred_prob: torch.Tensor,  # [M] p of each v_i containing the join tag
) -> torch.Tensor:
    """Eq. 13, vectorized over the left corpus."""
    return own_pred_prob * partner_pred_prob.mean()


def join_predicate_probability_sharded(
    own_pred_prob: torch.Tensor,
    partner_shard_sums: torch.Tensor,  # [S] sum of partner probabilities per shard
    partner_global_count: int,
) -> torch.Tensor:
    """Eq. 13 with the partner corpus split over shards: the partner mean is
    the sum of the per-shard sums over the global count (the reference's
    ``psum`` over a mesh axis, here a plain reduction over the shard axis)."""
    return own_pred_prob * (partner_shard_sums.sum() / partner_global_count)
