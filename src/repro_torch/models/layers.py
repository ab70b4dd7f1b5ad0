"""Shared neural layers: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro.models.layers``.  Parameters are plain dicts of tensors;
initialisers draw from a ``torch.Generator`` (the reference's JAX keys give
other numbers: tests carry weights across with ``repro_torch.interop``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


# Where ``_dense_init`` hands the matrices it draws: unset, it returns them
# as drawn; ``transformer.stack_init`` sets a sink (for the current thread or
# task only) while it builds a stack in the serving dtype, so that each
# matrix goes into its slot of a preallocated stack as soon as it is drawn.
_SINK: contextvars.ContextVar = contextvars.ContextVar("matrix_sink", default=None)


@contextlib.contextmanager
def matrices_into(sink: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, every ``_dense_init`` result goes through ``sink``
    (which returns what the initialiser hands on)."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def _dense_init(gen: torch.Generator, shape, in_axis=0, dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[in_axis] if isinstance(in_axis, int) else math.prod(shape[a] for a in in_axis)
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: one f32 buffer per draw (an Arctic expert stack is 17.8 GB)
    w = torch.randn(shape, generator=gen, device=gen.device).mul_(scale).to(dtype)
    sink = _SINK.get()
    return w if sink is None else sink(w)


# ---------------------------------------------------------------- rmsnorm ---


def rmsnorm_init(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(dt)


# ------------------------------------------------------------------- rope ---


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S]).  Split halves, not
    interleaved pairs, as the reference."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# -------------------------------------------------------------------- mlp ---


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str) -> dict:
    if mlp_type in ("swiglu", "geglu"):
        return {
            "wg": _dense_init(gen, (d_model, d_ff)),
            "wu": _dense_init(gen, (d_model, d_ff)),
            "wd": _dense_init(gen, (d_ff, d_model)),
        }
    return {"wu": _dense_init(gen, (d_model, d_ff)), "wd": _dense_init(gen, (d_ff, d_model))}


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh approximation, so gelu here is
    ``approximate="tanh"`` in both the geglu and the plain gelu MLP."""
    dt = x.dtype
    if mlp_type in ("swiglu", "geglu"):
        g = x @ params["wg"].to(dt)
        u = x @ params["wu"].to(dt)
        act = F.silu(g) if mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        return (act * u) @ params["wd"].to(dt)
    h = x @ params["wu"].to(dt)
    if mlp_type == "squared_relu":
        h = torch.square(F.relu(h))
    elif mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ params["wd"].to(dt)


# -------------------------------------------------------------- embedding ---


def embedding_init(gen: torch.Generator, vocab: int, d_model: int) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen, device=gen.device) * (1.0 / math.sqrt(d_model))


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return emb[tokens].to(dtype)


def unembed(emb_or_w: torch.Tensor, x: torch.Tensor, cap: Optional[float] = None) -> torch.Tensor:
    """-> f32 logits, softcapped when ``cap`` is set."""
    logits = x @ emb_or_w.to(x.dtype).T
    return softcap(logits.float(), cap)
