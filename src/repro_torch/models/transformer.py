"""The transformer stack (port of ``repro.models.transformer``, no caches).

Layers follow ``cfg.layer_pattern`` cycled over depth and are stored
period-grouped as in the reference: a tuple over pattern positions of dicts
whose leaves carry a leading ``[G]`` group axis (``G = num_layers /
period``).  ``stack_apply`` walks the groups in a Python loop — the
reference's ``lax.scan`` — and applies one full pattern period per group.
Remat only matters under grad, so the serving stack has none.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as nn
from repro_torch.models.config import ModelConfig


def block_init(gen: torch.Generator, cfg: ModelConfig, mixer: str) -> dict:
    cfg.check_supported()
    params = {"ln1": nn.rmsnorm_init(cfg.d_model, gen.device),
              "ln2": nn.rmsnorm_init(cfg.d_model, gen.device)}
    params["attn"] = attn_lib.attn_init(gen, cfg)
    if cfg.mlp_type != "none" and cfg.d_ff > 0:
        params["mlp"] = nn.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return params


def block_apply(params: dict, cfg: ModelConfig, mixer: str, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    h = nn.rmsnorm(x, params["ln1"], cfg.rmsnorm_eps)
    x = x + attn_lib.attn_apply(
        params["attn"], cfg, h, positions, "local" if mixer == "local" else "global",
        causal=causal,
    )
    if "mlp" in params:
        x = x + nn.mlp_apply(params["mlp"], nn.rmsnorm(x, params["ln2"], cfg.rmsnorm_eps),
                             cfg.mlp_type)
    return x


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _slice(tree, g: int):
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    return tree[g]


def stack_init(gen: torch.Generator, cfg: ModelConfig, num_layers: int) -> tuple:
    """Period-grouped stacked params: a tuple over pattern positions of dicts
    whose leaves carry a leading [G] group axis."""
    period = len(cfg.layer_pattern)
    if num_layers % period:
        raise ValueError(f"{num_layers} layers do not cycle pattern {cfg.layer_pattern}")
    groups = num_layers // period
    return tuple(
        _stack([block_init(gen, cfg, cfg.layer_pattern[pos]) for _ in range(groups)])
        for pos in range(period)
    )


def stack_apply(stacked_params: tuple, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, num_layers: int, causal: bool = True) -> torch.Tensor:
    """Apply the period-grouped stack -> x [B, S, d]."""
    cfg.check_supported()
    period = len(cfg.layer_pattern)
    for g in range(num_layers // period):
        for pos in range(period):
            x = block_apply(_slice(stacked_params[pos], g), cfg, cfg.layer_pattern[pos], x,
                            positions, causal=causal)
    return x


def cast_matrices(stacked_params: tuple, dtype: torch.dtype) -> tuple:
    """A copy of the stack with every projection matrix in ``dtype`` and the
    norm weights left f32 — bitwise what the per-call ``.to(dtype)`` of the
    projections gives, made once instead of per forward."""

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype) if tree.ndim >= 3 else tree  # [G, ...] matrices

    return tuple(cast(p) for p in stacked_params)
