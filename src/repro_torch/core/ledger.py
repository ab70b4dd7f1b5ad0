"""Per-tenant cost ledger: fair-share attribution of deduplicated spend.

Port of ``repro.core.ledger``.  A triple charged this epoch splits its cost
across every tenant slot whose plan wanted it (the want-bits of
``plan.merge_plans_dedup_wants``); the k-th of n wanters is billed
``cost*fl(k/n) - cost*fl((k-1)/n)``, which telescopes to exactly ``cost``.
``CostLedger.bills`` folds the remaining f32 accumulation residue into the
last billed slot so the invoices sum to ``cost_spent`` bit for bit (left-to-
right f32 fold: archived, unattributed, then slots in ascending order).

All updates are tensor ops with no host sync; only ``bills`` reads the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.plan import Plan


@dataclasses.dataclass
class CostLedger:
    """Cumulative fair-share enrichment spend per tenant slot."""

    attributed: torch.Tensor  # [S] f32: cost attributed to each slot
    triples: torch.Tensor  # [S] f32: fractional triple count (1/n_want shares)
    wanted: torch.Tensor  # [S] int32: chargeable triples each slot's plans wanted
    unattributed: torch.Tensor  # [] f32: charged cost with no wanting tenant
    archived: torch.Tensor  # [] f32: bills of departed tenants whose slot was recycled

    @property
    def num_slots(self) -> int:
        return self.attributed.shape[0]

    def total(self) -> torch.Tensor:
        return self.attributed.sum() + self.unattributed + self.archived

    def reconcile(self, cost_spent: torch.Tensor) -> torch.Tensor:
        """[] f32 residual vs the substrate's cumulative spend (0 == exact)."""
        return cost_spent - self.total()

    def bills(self, cost_spent) -> np.ndarray:
        """[S] f32 invoice-grade per-slot bills that reconcile BITWISE with
        ``cost_spent`` (see the module docstring for the fold order)."""
        att = self.attributed.detach().cpu().numpy().astype(np.float32).copy()
        unatt = np.float32(self.unattributed.item())
        arch = np.float32(self.archived.item())
        target = np.float32(float(cost_spent))
        billed = np.flatnonzero(self.wanted.cpu().numpy() > 0)
        j = int(billed[-1]) if billed.size else att.shape[0] - 1

        def fold(bills):
            acc = np.float32(arch + unatt)
            for v in bills:
                acc = np.float32(acc + np.float32(v))
            return acc

        # Newton step to within an ulp, then a single-ulp walk on slot j
        att[j] = np.float32(att[j] + np.float32(target - fold(att)))
        for _ in range(4096):
            f = fold(att)
            if f == target:
                break
            toward = np.float32(np.inf) if f < target else np.float32(-np.inf)
            att[j] = np.nextafter(att[j], toward, dtype=np.float32)
        return att


def init_ledger(num_slots: int, dtype=torch.float32, device=None) -> CostLedger:
    return CostLedger(
        attributed=torch.zeros(num_slots, dtype=dtype, device=device),
        triples=torch.zeros(num_slots, dtype=dtype, device=device),
        wanted=torch.zeros(num_slots, dtype=torch.int32, device=device),
        unattributed=torch.zeros((), dtype=dtype, device=device),
        archived=torch.zeros((), dtype=dtype, device=device),
    )


def reset_slot(ledger: CostLedger, slot: int) -> CostLedger:
    """Zero a tenant slot's accumulators, archiving its outstanding bill so
    ``total() == cost_spent`` survives the recycle."""

    def zeroed(x):
        out = x.clone()
        out[slot:slot + 1] = 0  # a fill: ``out[slot] = 0`` copies a host scalar (a sync)
        return out

    return CostLedger(
        attributed=zeroed(ledger.attributed),
        triples=zeroed(ledger.triples),
        wanted=zeroed(ledger.wanted),
        unattributed=ledger.unattributed,
        archived=ledger.archived + ledger.attributed[slot],
    )


def want_matrix(want_bits: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Expand [..., W] want-bit words (32 bits per int64 word) into [..., S] bool."""
    q = torch.arange(num_slots, device=want_bits.device)
    words = want_bits[..., q // 32]
    return ((words >> (q % 32)) & 1).to(torch.bool)


def attribute_epoch(
    ledger: CostLedger,
    merged: Plan,  # [M] deduplicated epoch plan
    want_bits: torch.Tensor,  # [M, W] from merge_plans_dedup_wants
    chargeable: torch.Tensor,  # [M] bool: lanes the substrate newly charged
) -> CostLedger:
    """Fold one executed epoch plan into the ledger (rank-based exact split;
    lanes the write-once substrate did not charge attribute nothing)."""
    want = want_matrix(want_bits, ledger.num_slots)  # [M, S]
    n_want = want.sum(-1)  # [M]
    live = chargeable & merged.valid
    split = (live & (n_want > 0))[:, None]
    dtype = merged.cost.dtype
    nf = torch.clamp_min(n_want, 1).to(dtype)[:, None]
    rank = torch.cumsum(want.to(torch.int32), dim=-1)  # 1-based at set bits
    hi = rank.to(dtype) / nf  # fl(k/n); fl(n/n) == 1 exactly
    lo = (rank - 1).to(dtype) / nf
    cost = merged.cost[:, None]
    billed = want & split
    bills = torch.where(billed, cost * hi - cost * lo, 0.0)
    frac = torch.where(billed, hi - lo, 0.0)
    orphan = torch.where(live & (n_want == 0), merged.cost, 0.0).sum()
    return CostLedger(
        attributed=ledger.attributed + bills.sum(0),
        triples=ledger.triples + frac.sum(0),
        wanted=ledger.wanted + (live[:, None] & want).sum(0, dtype=torch.int32),
        unattributed=ledger.unattributed + orphan,
        archived=ledger.archived,
    )


def migrate_ledger(ledger: CostLedger, num_slots: int) -> CostLedger:
    """Carry a ledger across a capacity-tier migration (no row axis: the books
    cross unchanged; a slot-count change fails loudly)."""
    if ledger.num_slots != num_slots:
        raise ValueError(
            f"ledger has {ledger.num_slots} slots but the session has "
            f"{num_slots}; tier growth must not change the tenant-slot axis"
        )
    return ledger
