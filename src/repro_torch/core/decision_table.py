"""Decision table (paper section 4.2, Table 3): (state, uncertainty-bin) ->
(next tagging function, expected delta-uncertainty).

Port of ``repro.core.decision_table``.  Storage is dense: ``next_fn [P, 2^F,
BINS]`` int32, ``delta_h [P, 2^F, BINS]`` f32 and, for the best-benefit
variant, ``delta_h_all [P, 2^F, BINS, F]`` f32 with +inf where a function is
already executed or unlearnable.  The scoring kernels stage these tables in
shared memory (``kernels/enrich_score``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import combine as combine_lib
from repro_torch.core import entropy as entropy_lib


@dataclasses.dataclass
class DecisionTable:
    next_fn: torch.Tensor  # [P, S, B] int32; -1 where no function remains
    delta_h: torch.Tensor  # [P, S, B] f32 (<= 0: expected uncertainty reduction)
    delta_h_all: Optional[torch.Tensor] = None  # [P, S, B, F] f32, +inf = unavailable
    num_bins: int = 10

    @property
    def num_states(self) -> int:
        return self.next_fn.shape[1]

    def to(self, device) -> "DecisionTable":
        return DecisionTable(
            next_fn=self.next_fn.to(device),
            delta_h=self.delta_h.to(device),
            delta_h_all=None if self.delta_h_all is None else self.delta_h_all.to(device),
            num_bins=self.num_bins,
        )

    def lookup(self, pred_idx, state_id, uncertainty):
        """Gather -> (next function idx [...], delta_h [...])."""
        b = entropy_lib.uncertainty_bin(uncertainty, self.num_bins)
        pred_idx, state_id = pred_idx.long(), state_id.long()
        return self.next_fn[pred_idx, state_id, b], self.delta_h[pred_idx, state_id, b]

    def lookup_all(self, pred_idx, state_id, uncertainty) -> torch.Tensor:
        """Per-function deltas [..., F] (inf where executed / unlearnable)."""
        if self.delta_h_all is None:
            raise ValueError("table learned without delta_h_all")
        b = entropy_lib.uncertainty_bin(uncertainty, self.num_bins)
        return self.delta_h_all[pred_idx.long(), state_id.long(), b]


def enumerate_states(num_functions: int) -> np.ndarray:
    """[2^F, F] bool table of state bitmask -> executed-function indicator."""
    s = np.arange(2**num_functions)[:, None]
    return ((s >> np.arange(num_functions)[None, :]) & 1).astype(bool)


def learn_decision_table(
    train_func_probs: torch.Tensor,  # [Ntr, P, F] outputs of ALL functions on train set
    combine_params: combine_lib.CombineParams,
    num_bins: int = 10,
    costs: Optional[torch.Tensor] = None,  # [P, F] or [F]; used if cost_normalized
    cost_normalized: bool = False,
    min_count: int = 1,
) -> DecisionTable:
    """Offline learning pass (paper "Learning the Decision Table").

    For each state s, combine the executed subset, bin its entropy, then for
    each remaining f combine (s | f) and take the per-(predicate, bin) mean
    entropy delta; the argmin function is the table's choice.
    """
    train_func_probs = train_func_probs.to(torch.float32)
    ntr, p, f = train_func_probs.shape
    dev = train_func_probs.device
    states = torch.as_tensor(enumerate_states(f), device=dev)  # [S, F] bool
    if costs is not None:
        costs = torch.as_tensor(costs, dtype=torch.float32, device=dev)
        if costs.ndim == 1:
            costs = costs[None, :].expand(p, f)

    next_fns, delta_hs, delta_all = [], [], []
    for state_row in states:
        mask = state_row[None, None, :].expand(ntr, p, f)
        h_s = entropy_lib.binary_entropy(
            combine_lib.combine_probabilities(combine_params, train_func_probs, mask)
        )  # [Ntr, P]
        bins = entropy_lib.uncertainty_bin(h_s, num_bins)
        onehot = torch.nn.functional.one_hot(bins, num_bins).to(torch.float32)  # [Ntr,P,B]
        cnts = onehot.sum(0)  # [P, B]
        deltas = []
        for f_idx in range(f):
            row2 = state_row.clone()
            row2[f_idx] = True
            prob_sf = combine_lib.combine_probabilities(
                combine_params, train_func_probs, row2[None, None, :].expand(ntr, p, f)
            )
            dh = entropy_lib.binary_entropy(prob_sf) - h_s
            mean = torch.einsum("np,npb->pb", dh, onehot) / torch.clamp_min(cnts, 1.0)
            if bool(state_row[f_idx]):
                mean = torch.full_like(mean, float("inf"))
            mean = torch.where(cnts >= min_count, mean, float("inf"))
            deltas.append(mean)
        deltas = torch.stack(deltas)  # [F, P, B]
        if cost_normalized and costs is not None:
            score = deltas / torch.clamp_min(costs.T[:, :, None], 1e-9)
        else:
            score = deltas
        best = torch.argmin(score, dim=0)  # [P, B] (most negative delta wins)
        best_delta = torch.gather(deltas, 0, best[None])[0]
        no_data = ~torch.isfinite(score.min(0).values)
        fallback_fn = int(torch.argmax((~state_row).to(torch.int32)))  # first unexecuted
        best = torch.where(no_data, fallback_fn, best)
        exhausted = bool(state_row.all())
        if exhausted:
            best = torch.full_like(best, -1)
        best_delta = torch.where(
            torch.isfinite(best_delta), torch.clamp_max(best_delta, 0.0), 0.0
        )
        if exhausted:
            best_delta = torch.zeros_like(best_delta)
        clean = torch.where(torch.isfinite(deltas), torch.clamp_max(deltas, 0.0), float("inf"))
        next_fns.append(best.to(torch.int32))
        delta_hs.append(best_delta.to(torch.float32))
        delta_all.append(clean.to(torch.float32))
    return DecisionTable(
        next_fn=torch.stack(next_fns).permute(1, 0, 2).contiguous(),  # [S,P,B]->[P,S,B]
        delta_h=torch.stack(delta_hs).permute(1, 0, 2).contiguous(),
        delta_h_all=torch.stack(delta_all).permute(2, 0, 3, 1).contiguous(),  # [S,F,P,B]->[P,S,B,F]
        num_bins=num_bins,
    )


def fallback_decision_table(
    num_predicates: int,
    num_functions: int,
    auc,  # [P, F] or [F]
    num_bins: int = 10,
    device=None,
) -> DecisionTable:
    """Analytic prior table: pick the highest-AUC unexecuted function; expected
    delta-h proportional to (AUC-0.5) * h."""
    auc = torch.as_tensor(auc, dtype=torch.float32, device=device)
    dev = auc.device
    if auc.ndim == 1:
        auc = auc[None, :].expand(num_predicates, num_functions)
    s_count = 2**num_functions
    states = torch.as_tensor(enumerate_states(num_functions), device=dev)  # [S, F]
    q = torch.where(states[None], float("-inf"), auc[:, None, :])  # [P, S, F]
    best = torch.argmax(q, dim=-1).to(torch.int32)  # [P, S]
    best_q = q.max(-1).values
    exhausted = states.all(-1)[None, :]  # [1, S]
    best = torch.where(exhausted, -1, best)
    bins_mid = (torch.arange(num_bins, dtype=torch.float32, device=dev) + 0.5) / num_bins
    frac = torch.clamp(2.0 * (best_q - 0.5), 0.0, 1.0)  # [P, S]
    delta = -frac[:, :, None] * bins_mid[None, None, :]
    delta = torch.where(exhausted[:, :, None], 0.0, delta)
    frac_all = torch.clamp(2.0 * (auc[:, None, :] - 0.5), 0.0, 1.0)  # [P, 1, F]
    delta_all = -frac_all[:, :, None, :] * bins_mid[None, None, :, None]
    delta_all = delta_all.expand(num_predicates, s_count, num_bins, num_functions)
    delta_all = torch.where(states[None, :, None, :], float("inf"), delta_all)
    return DecisionTable(
        next_fn=best[:, :, None].expand(num_predicates, s_count, num_bins).contiguous(),
        delta_h=delta.contiguous(),
        delta_h_all=delta_all.contiguous(),
        num_bins=num_bins,
    )
