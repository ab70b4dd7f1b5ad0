"""The guard every kernel wrapper runs first: the hand-written kernels have
no backward pass.

A wrapper fills its output through a ``ctypes`` launch, which autograd does
not see: a loss computed through it would carry no gradient for the
kernel's inputs (the attention projections, the SSD operands) and still be
returned.  So a wrapper refuses, on any device, an input that requires grad
while grad mode is on.  Serving runs without grad or on tensors that need
none, and training takes the plain engines (``attn_impl`` "auto", "dense"
or "chunked"), which autograd differentiates.
"""

from __future__ import annotations

import torch


class NoBackwardError(RuntimeError):
    """A kernel was asked to take part in a backward pass."""


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``NoBackwardError`` when grad mode is on and one of ``tensors``
    (None entries are skipped) requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{kernel}: the hand-written kernel has no backward pass and an input requires "
            "grad; train with attn_impl 'auto', 'dense' or 'chunked' (the plain engines), "
            "or call the kernel under torch.no_grad()")
