"""The transformer stack (port of ``repro.models.transformer``).

Layers follow ``cfg.layer_pattern`` cycled over depth and are stored
period-grouped as in the reference: a tuple over pattern positions of dicts
whose leaves carry a leading ``[G]`` group axis (``G = num_layers /
period``).  ``stack_apply`` walks the groups in a Python loop — the
reference's ``lax.scan`` — and applies one full pattern period per group.
Remat only matters under grad, so the serving stack has none.

Caches: ``ModelCache`` carries, per pattern position, group-stacked KV and/or
SSM state tensors plus one length counter (an int32 tensor on the device, so
a decode step reads nothing back to the host).  ``stack_apply(cache=...,
update_cache=True)`` writes each layer's new K/V rows and SSM state INTO the
stacks in place (the reference returns updated copies; its scan carries
them for the same reason, to avoid double-buffering the cache) and returns
a ``ModelCache`` over the same tensors with the new length.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as nn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig

ATTN_MIXERS = ("global", "local")


def block_init(gen: torch.Generator, cfg: ModelConfig, mixer: str) -> dict:
    cfg.check_supported()
    params = {"ln1": nn.rmsnorm_init(cfg.d_model, gen.device),
              "ln2": nn.rmsnorm_init(cfg.d_model, gen.device)}
    if mixer in ATTN_MIXERS:
        params["attn"] = attn_lib.attn_init(gen, cfg)
    if mixer == "mamba":
        params["ssm"] = ssm_lib.ssm_init(gen, cfg)
    if cfg.mlp_type != "none" and cfg.d_ff > 0:
        params["mlp"] = nn.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return params


def block_apply(params: dict, cfg: ModelConfig, mixer: str, x: torch.Tensor,
                positions: torch.Tensor, kv_cache: Optional[attn_lib.KVCache] = None,
                ssm_cache: Optional[ssm_lib.SSMCache] = None, update_cache: bool = False,
                causal: bool = True):
    """-> (x, new_ssm_cache); attention writes its K/V rows into
    ``kv_cache`` in place."""
    h = nn.rmsnorm(x, params["ln1"], cfg.rmsnorm_eps)
    new_ssm = ssm_cache
    if mixer in ATTN_MIXERS:
        mix, _ = attn_lib.attn_apply(
            params["attn"], cfg, h, positions, "local" if mixer == "local" else "global",
            cache=kv_cache, update_cache=update_cache, causal=causal,
        )
    else:
        mix, new_ssm = ssm_lib.ssm_apply(params["ssm"], cfg, h, cache=ssm_cache,
                                         update_cache=update_cache)
    x = x + mix
    if "mlp" in params:
        x = x + nn.mlp_apply(params["mlp"], nn.rmsnorm(x, params["ln2"], cfg.rmsnorm_eps),
                             cfg.mlp_type)
    return x, new_ssm


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _slice(tree, g: int):
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    return tree[g]


@dataclasses.dataclass
class ModelCache:
    """Group-stacked caches per pattern position + one global length."""

    kv_k: tuple  # per position: [G, B, S, KV, D] or None
    kv_v: tuple
    ssm_conv: tuple  # per position: [G, B, W-1, C] or None
    ssm_h: tuple  # per position: [G, B, H, P, N] or None
    length: torch.Tensor  # [] int32, on the cache's device


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
                positions: torch.Tensor, num_layers: int,
                cache: Optional[ModelCache] = None, update_cache: bool = False,
                causal: bool = True):
    """Apply the period-grouped stack -> (x [B, S, d], new_cache or None)."""
    cfg.check_supported()
    period = len(cfg.layer_pattern)
    for g in range(num_layers // period):
        for pos in range(period):
            kv_c = ssm_c = None
            if cache is not None and cache.kv_k[pos] is not None:
                kv_c = attn_lib.KVCache(cache.kv_k[pos][g], cache.kv_v[pos][g], cache.length)
            if cache is not None and cache.ssm_conv[pos] is not None:
                ssm_c = ssm_lib.SSMCache(cache.ssm_conv[pos][g], cache.ssm_h[pos][g])
            x, nssm = block_apply(_slice(stacked_params[pos], g), cfg, cfg.layer_pattern[pos],
                                  x, positions, kv_cache=kv_c, ssm_cache=ssm_c,
                                  update_cache=update_cache, causal=causal)
            if ssm_c is not None and update_cache:
                cache.ssm_conv[pos][g].copy_(nssm.conv)
                cache.ssm_h[pos][g].copy_(nssm.h)
    if cache is None:
        return x, None
    new_len = cache.length + (x.shape[1] if update_cache else 0)
    return x, dataclasses.replace(cache, length=new_len)


def init_model_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None) -> ModelCache:
    period = len(cfg.layer_pattern)
    groups = cfg.num_layers // period
    kv_k, kv_v, ssm_conv, ssm_h = [], [], [], []
    s = cfg.ssm
    for pos in range(period):
        mixer = cfg.layer_pattern[pos]
        if mixer in ATTN_MIXERS:
            shape = (groups, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            kv_k.append(torch.zeros(shape, dtype=dtype, device=device))
            kv_v.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            kv_k.append(None)
            kv_v.append(None)
        if mixer == "mamba":
            di, nh = s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)
            ssm_conv.append(torch.zeros((groups, batch, s.conv_width - 1, di + 2 * s.state_dim),
                                        dtype=dtype, device=device))
            ssm_h.append(torch.zeros((groups, batch, nh, s.head_dim, s.state_dim),
                                     dtype=torch.float32, device=device))
        else:
            ssm_conv.append(None)
            ssm_h.append(None)
    return ModelCache(kv_k=tuple(kv_k), kv_v=tuple(kv_v), ssm_conv=tuple(ssm_conv),
                      ssm_h=tuple(ssm_h),
                      length=torch.zeros((), dtype=torch.int32, device=device))


def cast_matrices(stacked_params: tuple, dtype: torch.dtype) -> tuple:
    """A copy of the stack with every matrix in ``dtype`` (projections, and
    the SSM's depthwise ``conv_w``, which the mixer casts to the activation
    dtype itself) and the per-channel vectors left f32 (norm weights, the
    SSM's ``A_log``, ``D``, ``dt_bias``, ``norm_w``, ``conv_b``) — bitwise
    what the per-call ``.to(dtype)`` gives, made once instead of per forward."""

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype) if tree.ndim >= 3 else tree  # [G, ...] matrices

    return tuple(cast(p) for p in stacked_params)
