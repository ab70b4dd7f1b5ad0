"""Units in the last place between two tensors: the card checks' measure of
a kernel against its plain twin (imports no JAX)."""

import torch


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two tensors of one dtype (bf16 or f32),
    elementwise, as int64 (0 where bitwise, 1 for neighbouring values across
    zero too)."""
    if got.dtype != want.dtype or got.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ulps takes two bf16 or two f32 tensors, got {got.dtype}, {want.dtype}")
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    top = -(1 << (8 * got.element_size() - 1))

    def ordered(t):  # sign-magnitude bits -> integers in the values' order
        i = t.contiguous().view(bits).long()
        return torch.where(i >= 0, i, top - i)

    return (ordered(got) - ordered(want)).abs()
