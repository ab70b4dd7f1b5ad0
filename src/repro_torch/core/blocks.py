"""Memory-tier extension (paper section 5 "Dealing with Large Dataset" +
Appendix B).

Port of ``repro.core.blocks``.  Objects live in ``num_blocks`` equal
blocks; only ``resident_blocks`` fit in the fast tier.  The benefit of a
triple whose object is not resident pays the block load cost (Eq. 12):

    Benefit = dE(F) / (c_load / block_size + c_fn)

Block selection (Appendix B): BlockBenefit(b) = sum of the triple benefits
falling in b; the best non-resident block is swapped in each epoch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.benefit import TripleBenefits


class BlockState(NamedTuple):
    block_of_object: torch.Tensor  # [N] int32
    resident: torch.Tensor  # [num_blocks] bool
    load_cost: torch.Tensor  # [] f32 cost to load one block


def make_block_state(
    num_objects: int, num_blocks: int, resident_blocks: int, load_cost: float, device=None
) -> BlockState:
    block = (torch.arange(num_objects, device=device) * num_blocks // num_objects).to(torch.int32)
    resident = torch.arange(num_blocks, device=device) < resident_blocks
    return BlockState(block, resident, torch.tensor(load_cost, dtype=torch.float32, device=device))


def per_object_load_cost(bs: BlockState, num_objects: int) -> torch.Tensor:
    """Eq. 12 load term amortized per object: c_load / block_size if not resident."""
    block_size = num_objects / bs.resident.shape[0]
    nonresident = ~bs.resident[bs.block_of_object.long()]
    return torch.where(nonresident, bs.load_cost / block_size, 0.0)


def block_benefits(bs: BlockState, benefits: TripleBenefits) -> torch.Tensor:
    """Appendix-B BlockBenefit: per-block sum of finite triple benefits."""
    per_obj = torch.where(torch.isfinite(benefits.benefit), benefits.benefit, 0.0).sum(-1)
    out = torch.zeros(bs.resident.shape[0], dtype=per_obj.dtype, device=per_obj.device)
    return out.index_add_(0, bs.block_of_object.long(), per_obj)


def swap_best_block(bs: BlockState, benefits: TripleBenefits) -> BlockState:
    """Evict the lowest-benefit resident block for the best non-resident one."""
    bb = block_benefits(bs, benefits)
    best_out = torch.argmax(torch.where(bs.resident, float("-inf"), bb))
    worst_in = torch.argmin(torch.where(bs.resident, bb, float("inf")))
    should_swap = bb[best_out] > bb[worst_in]
    resident = bs.resident.clone()
    resident[best_out] = should_swap | bs.resident[best_out]
    resident[worst_in] = ~should_swap & bs.resident[worst_in]
    return bs._replace(resident=resident)
