"""Gradient compression with error feedback (port of
``repro.optim.compress``): what is dropped or rounded away in one step is
carried in ``CompressState.error`` and added back to the next step's
gradient.

* ``topk_compress`` keeps each leaf's ``fraction`` of largest magnitudes
  (a dense carrier with zeros elsewhere; on a wire only the values and
  their indices would move).  Equal magnitudes are taken in index order,
  as ``jax.lax.top_k`` takes them (``torch.topk`` promises no order among
  ties), through a stable sort.
* ``int8_compress`` quantises each leaf to symmetric int8 with stochastic
  rounding, the noise drawn from a ``torch.Generator`` (the reference draws
  it from a JAX key); ``quantize_int8`` is the quantiser on given noise.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten


class CompressState(NamedTuple):
    error: Any  # tree of f32 residuals (the error feedback)


def init_error_feedback(params) -> CompressState:
    return CompressState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def _topk_one(g: torch.Tensor, e: torch.Tensor, fraction: float):
    g32 = g.float() + e
    flat = g32.reshape(-1)
    k = max(1, int(flat.shape[0] * fraction))
    idx = torch.sort(-torch.abs(flat), stable=True).indices[:k]
    mask = torch.zeros_like(flat).index_fill_(0, idx, 1.0)
    kept = (flat * mask).reshape(g32.shape)
    return kept.to(g.dtype), g32 - kept


def topk_compress(grads, state: CompressState, fraction: float = 0.01):
    """-> (sparse grads, new state)."""
    out = [_topk_one(g, e, fraction) for g, e in zip(leaves(grads), leaves(state.error))]
    return (unflatten(grads, [o[0] for o in out]),
            CompressState(error=unflatten(grads, [o[1] for o in out])))


def quantize_int8(g: torch.Tensor, e: torch.Tensor, noise: torch.Tensor):
    """One leaf: ``g + e`` in symmetric int8 steps of max|g + e| / 127,
    rounded after adding ``noise`` (uniform in [-0.5, 0.5)) -> (the
    dequantised leaf in g's dtype, the new f32 residual)."""
    g32 = g.float() + e
    scale = torch.clamp(torch.amax(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale + noise), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), g32 - deq


def int8_compress(grads, state: CompressState, gen: torch.Generator):
    """-> (dequantised grads, new state); the wire format would be (int8,
    scale) per leaf."""
    out = []
    for g, e in zip(leaves(grads), leaves(state.error)):
        noise = torch.rand(g.shape, generator=gen, device=g.device) - 0.5
        out.append(quantize_int8(g, e, noise))
    return (unflatten(grads, [o[0] for o in out]),
            CompressState(error=unflatten(grads, [o[1] for o in out])))


def compression_ratio_topk(num_elements: int, fraction: float) -> float:
    """Wire bytes ratio: (k * (4 + 4)) / (n * 4)."""
    k = max(1, int(num_elements * fraction))
    return (k * 8) / (num_elements * 4)
