"""The transformer stack (port of ``repro.models.transformer``).

Layers follow ``cfg.layer_pattern`` cycled over depth and are stored
period-grouped as in the reference: a tuple over pattern positions of dicts
whose leaves carry a leading ``[G]`` group axis (``G = num_layers /
period``).  ``stack_apply`` walks the groups in a Python loop — the
reference's ``lax.scan`` — and applies one full pattern period per group.
Under autograd (a parameter or the input requires grad) with
``cfg.remat`` and no cache, each group runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its scan
body: the backward pass recomputes the group's activations instead of
keeping them.  The serving stack runs without grad, so it has none.

A block is a mixer — attention ("global", "local"), the Mamba-2 SSM
("mamba") or both in parallel on the same normed input, mean-fused
("hymba") — then, in an encoder-decoder's decoder, cross-attention over the
encoder output, then an MLP or a mixture of experts (with Arctic's dense
residual MLP beside it).  The reference's caveats are kept: a hymba layer
calls its attention as "global", so its ``sliding_window`` is never
applied; blocks run their cross-attention only when given ``enc_out`` (the
cascade trunk gives none).  ``stack_apply`` returns the MoE aux losses
(``BlockAux``: load balance and router z, summed over blocks and groups) for
the training loss; serving reads none.

Caches: ``ModelCache`` carries, per pattern position, group-stacked KV and/or
SSM state tensors, one length counter (an int32 tensor on the device, so a
decode step reads nothing back to the host) and an encoder-decoder's
encoder output.  ``stack_apply(cache=..., update_cache=True)`` writes each
layer's new K/V rows and SSM state INTO the stacks in place (the reference
returns updated copies; its scan carries them for the same reason, to avoid
double-buffering the cache) and returns a ``ModelCache`` over the same
tensors with the new length.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import activation_sharding as act_sh
from repro_torch.models.activation_sharding import shard_act
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig

ATTN_MIXERS = ("global", "local", "hymba")
SSM_MIXERS = ("mamba", "hymba")


class BlockAux(NamedTuple):
    lb_loss: torch.Tensor
    z_loss: torch.Tensor


def _add_aux(total: Optional[BlockAux], aux: Optional[BlockAux]) -> Optional[BlockAux]:
    if aux is None or total is None:
        return total if aux is None else aux
    return BlockAux(total.lb_loss + aux.lb_loss, total.z_loss + aux.z_loss)


def block_init(gen: torch.Generator, cfg: ModelConfig, mixer: str, cross: bool = False) -> dict:
    cfg.check_supported()
    dev = gen.device
    params = {"ln1": nn.rmsnorm_init(cfg.d_model, dev), "ln2": nn.rmsnorm_init(cfg.d_model, dev)}
    if mixer in ATTN_MIXERS:
        params["attn"] = attn_lib.attn_init(gen, cfg)
    if mixer in SSM_MIXERS:
        params["ssm"] = ssm_lib.ssm_init(gen, cfg)
    if cross:
        params["ln_cross"] = nn.rmsnorm_init(cfg.d_model, dev)
        params["cross"] = attn_lib.attn_init(gen, cfg)
    if cfg.moe is not None:
        params["moe"] = moe_lib.moe_init(gen, cfg)
        if cfg.moe.dense_residual:
            params["mlp"] = nn.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    elif cfg.mlp_type != "none" and cfg.d_ff > 0:
        params["mlp"] = nn.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return params


def block_axes(cfg: ModelConfig, mixer: str, cross: bool = False) -> dict:
    """Logical axes of ``block_init``'s tree."""
    axes = {"ln1": nn.RMSNORM_AXES, "ln2": nn.RMSNORM_AXES}
    if mixer in ATTN_MIXERS:
        axes["attn"] = attn_lib.attn_axes(cfg)
    if mixer in SSM_MIXERS:
        axes["ssm"] = ssm_lib.ssm_axes()
    if cross:
        axes["ln_cross"] = nn.RMSNORM_AXES
        axes["cross"] = attn_lib.attn_axes(cfg)
    if cfg.moe is not None:
        axes["moe"] = moe_lib.moe_axes(cfg)
        if cfg.moe.dense_residual:
            axes["mlp"] = nn.mlp_axes(cfg.mlp_type)
    elif cfg.mlp_type != "none" and cfg.d_ff > 0:
        axes["mlp"] = nn.mlp_axes(cfg.mlp_type)
    return axes


def _seq_whole(h: torch.Tensor) -> torch.Tensor:
    return shard_act(h, "batch", "act_seq", "act_embed")


def block_apply(params: dict, cfg: ModelConfig, mixer: str, x: torch.Tensor,
                positions: torch.Tensor, kv_cache: Optional[attn_lib.KVCache] = None,
                ssm_cache: Optional[ssm_lib.SSMCache] = None, update_cache: bool = False,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True):
    """-> (x, new_ssm_cache, the MoE's ``BlockAux`` or None); attention
    writes its K/V rows into ``kv_cache`` in place."""
    aux = None
    # Under a mesh whose rules shard the residual's seq (training's sequence
    # parallelism), each mixer and MLP takes its input with the seq whole:
    # the all-gather XLA inserts before them is stated here (a no-op where
    # seq is not sharded, and without a mesh).
    h = _seq_whole(nn.rmsnorm(x, params["ln1"], cfg.rmsnorm_eps))
    new_ssm = ssm_cache
    parts = []
    if mixer in ATTN_MIXERS:
        a, _ = attn_lib.attn_apply(
            params["attn"], cfg, h, positions, "local" if mixer == "local" else "global",
            cache=kv_cache, update_cache=update_cache, causal=causal,
        )
        parts.append(a)
    if mixer in SSM_MIXERS:
        s, new_ssm = ssm_lib.ssm_apply(params["ssm"], cfg, h, cache=ssm_cache,
                                       update_cache=update_cache)
        parts.append(s)
    mix = parts[0] if len(parts) == 1 else (parts[0] + parts[1]) / len(parts)  # Hymba: mean
    x = x + mix

    if enc_out is not None and "cross" in params:
        hc = _seq_whole(nn.rmsnorm(x, params["ln_cross"], cfg.rmsnorm_eps))
        c, _ = attn_lib.attn_apply(params["cross"], cfg, hc, positions, "global", xk=enc_out)
        x = x + c

    h2 = _seq_whole(nn.rmsnorm(x, params["ln2"], cfg.rmsnorm_eps))
    if "moe" in params:
        ff, moe_aux = moe_lib.moe_apply(params["moe"], cfg, h2)
        aux = BlockAux(moe_aux.load_balance_loss, moe_aux.router_z_loss)
        if "mlp" in params:  # Arctic's dense residual
            ff = ff + nn.mlp_apply(params["mlp"], h2, cfg.mlp_type)
        x = x + ff
    elif "mlp" in params:
        x = x + nn.mlp_apply(params["mlp"], h2, cfg.mlp_type)
    return x, new_ssm, aux


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
    enc_out: Optional[torch.Tensor] = None  # [B, S_enc, d] (enc-dec only)


def _stack_drawn(make_block, groups: int, dtype: torch.dtype):
    """``groups`` blocks from ``make_block`` stacked: every drawn matrix
    written in ``dtype`` into its slot of a stack allocated at its first
    draw (one f32 matrix alive at a time: ``cast_matrices`` of the f32
    stack, bitwise), the rest (norms, SSM vectors) stacked f32."""
    stacks, slot = [], {}  # the drawn matrices' stacks in draw order; id(group 0 view) -> index

    def sink_of(g: int):
        count = itertools.count()

        def sink(w):
            j = next(count)
            if g == 0:
                stacks.append(torch.empty((groups,) + tuple(w.shape), dtype=dtype,
                                          device=w.device))
            stacks[j][g].copy_(w)
            view = stacks[j][g]
            if g == 0:
                slot[id(view)] = j
            return view

        return sink

    blocks = []
    for g in range(groups):
        with nn.matrices_into(sink_of(g)):
            blocks.append(make_block())
    return _stack(blocks, stacks, slot)


def _stack(trees: list, stacks: list, slot: dict):
    """The groups' trees leaf by leaf: a drawn leaf is its stack, the others
    are stacked.  (A module function: a nested recursive closure would hold
    the stacks in a reference cycle until the cycle collector ran.)"""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stacks, slot) for k in trees[0]}
    j = slot.get(id(trees[0]))
    return torch.stack(trees) if j is None else stacks[j]


def stack_init(gen: torch.Generator, cfg: ModelConfig, num_layers: int, cross: bool = False,
               dtype: Optional[torch.dtype] = None) -> tuple:
    """Period-grouped stacked params: a tuple over pattern positions of dicts
    whose leaves carry a leading [G] group axis, f32; with ``dtype`` the
    serving copy (``cast_matrices(stack_init(...), dtype)``) from the same
    draws, without the f32 stack."""
    period = len(cfg.layer_pattern)
    if num_layers % period:
        raise ValueError(f"{num_layers} layers do not cycle pattern {cfg.layer_pattern}")
    groups = num_layers // period
    dtype = torch.float32 if dtype is None else dtype
    return tuple(_stack_drawn(lambda: block_init(gen, cfg, mixer, cross), groups, dtype)
                 for mixer in cfg.layer_pattern)


def stack_axes(cfg: ModelConfig, cross: bool = False) -> tuple:
    """Logical axes of ``stack_init``'s tree: every leaf leads with "layers"."""
    def lead(tree):
        if isinstance(tree, dict):
            return {k: lead(v) for k, v in tree.items()}
        return ("layers",) + tree

    return tuple(lead(block_axes(cfg, mixer, cross)) for mixer in cfg.layer_pattern)


def _any_requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_any_requires_grad(v) for v in tree.values())
    if isinstance(tree, tuple):
        return any(_any_requires_grad(v) for v in tree)
    return tree.requires_grad


def _group_apply(group_params: tuple, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, enc_out: Optional[torch.Tensor], causal: bool):
    """One pattern period without a cache -> (x, its summed ``BlockAux`` or
    None): the unit the backward pass recomputes under remat."""
    total = None
    x = shard_act(x, "batch", "seq", "act_embed")
    for pos, params in enumerate(group_params):
        x, _, aux = block_apply(params, cfg, cfg.layer_pattern[pos], x, positions,
                                enc_out=enc_out, causal=causal)
        total = _add_aux(total, aux)
    return x, total


def stack_apply(stacked_params: tuple, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, num_layers: int,
                cache: Optional[ModelCache] = None, update_cache: bool = False,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True):
    """Apply the period-grouped stack -> (x [B, S, d], new_cache or None,
    ``BlockAux`` summed over every block: zeros without a mixture of
    experts)."""
    cfg.check_supported()
    period = len(cfg.layer_pattern)
    groups = num_layers // period
    total = None
    if cache is None:
        remat = cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or _any_requires_grad(stacked_params))
        for g in range(groups):
            group_params = tuple(_slice(stacked_params[pos], g) for pos in range(period))
            args = (group_params, cfg, x, positions, enc_out, causal)
            x, aux = (checkpoint(_group_apply, *args, use_reentrant=False) if remat
                      else _group_apply(*args))
            total = _add_aux(total, aux)
    else:
        for g in range(groups):
            x = shard_act(x, "batch", "seq", "act_embed")
            for pos in range(period):
                kv_c = ssm_c = None
                if cache.kv_k[pos] is not None:
                    kv_c = attn_lib.KVCache(cache.kv_k[pos][g], cache.kv_v[pos][g], cache.length)
                if cache.ssm_conv[pos] is not None:
                    ssm_c = ssm_lib.SSMCache(cache.ssm_conv[pos][g], cache.ssm_h[pos][g])
                x, nssm, aux = block_apply(
                    _slice(stacked_params[pos], g), cfg, cfg.layer_pattern[pos], x, positions,
                    kv_cache=kv_c, ssm_cache=ssm_c, update_cache=update_cache, enc_out=enc_out,
                    causal=causal)
                if ssm_c is not None and update_cache:
                    cache.ssm_conv[pos][g].copy_(nssm.conv)
                    cache.ssm_h[pos][g].copy_(nssm.h)
                total = _add_aux(total, aux)
    aux = total if total is not None else BlockAux(
        *torch.zeros((2,), dtype=torch.float32, device=x.device))
    if cache is None:
        return x, None, aux
    new_len = cache.length + (x.shape[1] if update_cache else 0)
    return x, dataclasses.replace(cache, length=new_len), aux


def init_model_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None, enc_out: Optional[torch.Tensor] = None) -> ModelCache:
    """Zeroed caches: K / V for every attention position (hymba's too), the
    conv tail and f32 state for every SSM position (hymba's too).  Under an
    active mesh (``activation_sharding``) every leaf is a DTensor of zeros in
    the placements the rules give ``model_cache_axes(cfg, shard_kv_seq=True)``
    (the decode layout, so a prefill's cache feeds the decode step), and only
    the local shards are allocated."""
    period = len(cfg.layer_pattern)
    groups = cfg.num_layers // period
    kv_k, kv_v, ssm_conv, ssm_h = [], [], [], []
    s = cfg.ssm
    axes = model_cache_axes(cfg, shard_kv_seq=True)

    def zeros(shape, dtype, ax):
        if act_sh.active() is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        import torch.distributed.tensor as dtensor

        return dtensor.zeros(shape, dtype=dtype, device_mesh=act_sh.active()[0],
                             placements=act_sh.placements(*ax))

    for pos in range(period):
        mixer = cfg.layer_pattern[pos]
        if mixer in ATTN_MIXERS:
            shape = (groups, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            kv_k.append(zeros(shape, dtype, axes.kv_k[pos]))
            kv_v.append(zeros(shape, dtype, axes.kv_v[pos]))
        else:
            kv_k.append(None)
            kv_v.append(None)
        if mixer in SSM_MIXERS:
            di, nh = s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)
            ssm_conv.append(zeros((groups, batch, s.conv_width - 1, di + 2 * s.state_dim), dtype,
                                  axes.ssm_conv[pos]))
            ssm_h.append(zeros((groups, batch, nh, s.head_dim, s.state_dim), torch.float32,
                               axes.ssm_h[pos]))
        else:
            ssm_conv.append(None)
            ssm_h.append(None)
    return ModelCache(kv_k=tuple(kv_k), kv_v=tuple(kv_v), ssm_conv=tuple(ssm_conv),
                      ssm_h=tuple(ssm_h),
                      length=torch.zeros((), dtype=torch.int32, device=device), enc_out=enc_out)


def model_cache_axes(cfg: ModelConfig, shard_kv_seq: bool = False) -> ModelCache:
    """Logical axes matching ``init_model_cache``'s tree."""
    kv_ax = ("layers", "batch", "kv_seq" if shard_kv_seq else None, "kv_heads", "head_dim")
    conv_ax = ("layers", "batch", None, "ssm_inner")
    h_ax = ("layers", "batch", "ssm_heads", None, "state")
    att = [m in ATTN_MIXERS for m in cfg.layer_pattern]
    ssm = [m in SSM_MIXERS for m in cfg.layer_pattern]
    return ModelCache(
        kv_k=tuple(kv_ax if a else None for a in att),
        kv_v=tuple(kv_ax if a else None for a in att),
        ssm_conv=tuple(conv_ax if s else None for s in ssm),
        ssm_h=tuple(h_ax if s else None for s in ssm),
        length=(),
        enc_out=("batch", None, "act_embed") if cfg.encoder is not None else None,
    )


def cast_matrices(stacked_params: tuple, dtype: torch.dtype) -> tuple:
    """A copy of the stack with every matrix in ``dtype`` (projections, the
    MoE's router and expert stacks, which the reference casts at use, and
    the SSM's depthwise ``conv_w``, which the mixer casts to the activation
    dtype itself) and the per-channel vectors left f32 (norm weights, the
    SSM's ``A_log``, ``D``, ``dt_bias``, ``norm_w``, ``conv_b``) — bitwise
    what the per-call ``.to(dtype)`` gives, made once instead of per forward."""

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype) if tree.ndim >= 3 else tree  # [G, ...] matrices

    return tuple(cast(p) for p in stacked_params)
