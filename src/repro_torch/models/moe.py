"""Mixture-of-Experts layer (port of ``repro.models.moe``): grok-1's 8
experts top-2, Arctic's 128 top-2 beside a dense residual MLP.

Token-choice top-k gating with expert-capacity truncation, as the
reference: tokens are grouped along (batch, sequence chunk); in each group
every expert takes its top-C tokens by gate weight (over-capacity tokens are
dropped for that expert).  Dispatch is one gather, batched expert GEMMs
(``torch.einsum``: the reference computes them outside any kernel) and one
scatter-add.

Selections follow ``jax.lax.top_k``'s order: values descending, ties to the
lower index.  ``torch.topk`` promises no order among equal values on the
card, and the top-C selection runs over a gate matrix that is mostly zeros,
where ties are the rule, so both selections here are a stable sort of the
negated values (``_top_k``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.activation_sharding import (is_dtensor, on_local_shards, pin,
                                                      placements, shard_act, whole)
from repro_torch.models.layers import _dense_init, matmul


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor


def moe_init(gen: torch.Generator, cfg) -> dict:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    params = {
        "router": _dense_init(gen, (d, m.num_experts)),
        "wu": _dense_init(gen, (m.num_experts, d, f), in_axis=1),
        "wd": _dense_init(gen, (m.num_experts, f, d), in_axis=1),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        params["wg"] = _dense_init(gen, (m.num_experts, d, f), in_axis=1)
    return params


def moe_axes(cfg) -> dict:
    """Logical axes of ``moe_init``'s tree."""
    axes = {
        "router": ("embed", None),
        "wu": ("experts", "expert_embed", "mlp"),
        "wd": ("experts", "mlp", "expert_embed"),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        axes["wg"] = ("experts", "expert_embed", "mlp")
    return axes


def expert_capacity(tokens: int, num_experts: int, top_k: int, factor: float) -> int:
    c = int(math.ceil(factor * tokens * top_k / num_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _group_len(s: int, target: int = 4096) -> int:
    """Largest divisor of s that is <= target (dispatch group length)."""
    if s <= target:
        return s
    best = 1
    for cand in range(1, target + 1):
        if s % cand == 0:
            best = cand
    return best


_ROUTE_LOG = None  # the list ``recording_routes`` fills, or None


@contextlib.contextmanager
def recording_routes():
    """Within the block, each router choice (every token's top-k experts,
    sorted, copied to the CPU: a device read each) is appended to the list
    this yields, so two runs can be held to the same routing."""
    global _ROUTE_LOG
    _ROUTE_LOG = []
    try:
        yield _ROUTE_LOG
    finally:
        _ROUTE_LOG = None


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices,
    descending, equal values in index order (``jax.lax.top_k``'s order)."""
    neg, idx = torch.sort(-x, dim=-1, stable=True)
    return -neg[..., :k], idx[..., :k]


def _dispatch(xg: torch.Tensor, logits: torch.Tensor, top_k: int, cap: int):
    """Routing within each group: xg [G, T, d], router logits [G, T, E] f32
    -> (probs [G, T, E], the live selections' gate weights [G, E, C] (0 where
    a slot is empty), their in-group token ids [G, E, C], the selected tokens
    [G, E, C, d], the one-hot top-k choices [G, T, E] f32)."""
    ng, gl, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, top_k)  # [G, T, k]
    if _ROUTE_LOG is not None:
        _ROUTE_LOG.append(top_idx.sort(dim=-1).values.cpu())
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    # gate matrix [G, T, E]: the renormalized top-k weights, zero elsewhere
    gates = torch.zeros((ng, gl, e), dtype=torch.float32, device=logits.device)
    gates.scatter_(-1, top_idx, top_vals)

    # --- capacity-truncated dispatch: top-C tokens per (group, expert) ------
    sel_w, sel_idx = _top_k(gates.transpose(1, 2), cap)  # [G, E, C]
    live = (sel_w > 0.0).float()
    g_ar = torch.arange(ng, device=logits.device)[:, None, None]
    xe = xg[g_ar, sel_idx]  # [G, E, C, d]
    routed = torch.zeros_like(gates).scatter_(-1, top_idx, 1.0)
    return probs, sel_w * live, sel_idx, xe, routed


def _experts(xe: torch.Tensor, *w: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The selected tokens [G, E, C, d] through their experts' MLPs (the
    weights ``wg, wu, wd`` for a gated MLP, else ``wu, wd``: [E, d, f],
    [E, f, d]) -> [G, E, C, d]."""
    if mlp_type in ("swiglu", "geglu"):
        wg, wu, wd = w
        gproj = torch.einsum("gecd,edf->gecf", xe, wg)
        uproj = torch.einsum("gecd,edf->gecf", xe, wu)
        act = F.silu(gproj) if mlp_type == "swiglu" else F.gelu(gproj, approximate="tanh")
        h = act * uproj
    else:
        wu, wd = w
        h = torch.einsum("gecd,edf->gecf", xe, wu)
        h = torch.square(F.relu(h)) if mlp_type == "squared_relu" else F.gelu(
            h, approximate="tanh")
    h = shard_act(h, "batch", None, None, "act_ff")
    return torch.einsum("gecf,efd->gecd", h, wd)  # [G, E, C, d]


def _combine(out_e: torch.Tensor, sel_idx: torch.Tensor, gl: int) -> torch.Tensor:
    """The experts' weighted outputs [G, E, C, d] summed back onto their
    tokens -> [G, T, d].  A token receives at most top_k nonzero terms (the
    other picks add an exact zero), so for top-2 the unordered accumulation
    on the card sums the same two numbers the reference does, in either
    order."""
    ng, d = out_e.shape[0], out_e.shape[-1]
    g_ar = torch.arange(ng, device=out_e.device)[:, None, None]
    y = torch.zeros((ng, gl, d), dtype=out_e.dtype, device=out_e.device)
    y.index_put_((g_ar.expand_as(sel_idx), sel_idx), out_e, accumulate=True)
    return y


def moe_apply(params: dict, cfg, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], MoEAux).  Serving discards the aux."""
    m = cfg.moe
    dt = x.dtype
    b, s, d = x.shape
    e = m.num_experts
    gl = _group_len(s)
    ng = b * (s // gl)
    xg = shard_act(x.reshape(ng, gl, d), "batch", None, "act_embed")

    logits = matmul(xg, params["router"].to(dt)).float()  # [G, T, E]
    cap = min(expert_capacity(gl, e, m.top_k, m.capacity_factor), gl)
    dispatch = functools.partial(_dispatch, top_k=m.top_k, cap=cap)
    if is_dtensor(xg):  # per group: the sorts and scatters on each rank's groups
        g3 = placements("batch", None, None)
        probs, sel_w, sel_idx, xe, routed = on_local_shards(
            dispatch, (g3, g3, g3, placements("batch", None, None, None), g3), (g3, g3),
            xg, logits)
    else:
        probs, sel_w, sel_idx, xe, routed = dispatch(xg, logits)
    xe = shard_act(xe, "batch", None, None, "act_embed")
    w = tuple(params[k].to(dt) for k in ("wg", "wu", "wd") if k in params)
    experts = functools.partial(_experts, mlp_type=cfg.mlp_type)
    if is_dtensor(xe):
        # Each rank: its groups through every expert, the hidden width split as
        # the "mlp" rule splits it.  The expert weights come whole over their
        # expert and embed axes (an all-gather where "experts" / "expert_embed"
        # shard them: no expert-parallel all-to-all); the down projection's
        # sum over the split hidden width is left partial.
        from torch.distributed.tensor import Partial

        w_in, w_out = placements(None, None, "mlp"), placements(None, "mlp", None)
        out_pl = tuple(Partial() if p.is_shard(3) else p
                       for p in placements("batch", None, None, "mlp"))
        out_e = on_local_shards(
            experts, out_pl, (placements("batch", None, None, None),)
            + (w_in,) * (len(w) - 1) + (w_out,), xe, *w)
    else:
        out_e = experts(xe, *w)
    out_e = shard_act(out_e, "batch", None, None, "act_embed")
    out_e = out_e * sel_w[..., None].to(dt)
    if is_dtensor(out_e):
        y = on_local_shards(_combine, placements("batch", None, None),
                            (placements("batch", None, None, None), placements("batch", None, None),
                             None), out_e, sel_idx, gl)
    else:
        y = _combine(out_e, sel_idx, gl)

    # --- aux losses (Switch-style) ------------------------------------------
    me = whole(probs.mean(dim=(0, 1)))  # mean router prob per expert
    ce = whole(routed.mean(dim=(0, 1)))  # fraction of tokens per expert
    lb = e * torch.sum(me * ce)
    z = whole(torch.mean(torch.square(torch.logsumexp(logits, dim=-1))))
    return pin(y.reshape(b, s, d)), MoEAux(lb, z)
