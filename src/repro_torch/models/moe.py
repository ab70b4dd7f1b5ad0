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
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init


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


def moe_apply(params: dict, cfg, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], MoEAux).  Serving discards the aux."""
    m = cfg.moe
    dt = x.dtype
    b, s, d = x.shape
    e = m.num_experts
    gl = _group_len(s)
    ng = b * (s // gl)
    xg = x.reshape(ng, gl, d)

    logits = (xg @ params["router"].to(dt)).float()  # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, m.top_k)  # [G, T, k]
    if _ROUTE_LOG is not None:
        _ROUTE_LOG.append(top_idx.sort(dim=-1).values.cpu())
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    # gate matrix [G, T, E]: the renormalized top-k weights, zero elsewhere
    gates = torch.zeros((ng, gl, e), dtype=torch.float32, device=x.device)
    gates.scatter_(-1, top_idx, top_vals)

    # --- capacity-truncated dispatch: top-C tokens per (group, expert) ------
    cap = min(expert_capacity(gl, e, m.top_k, m.capacity_factor), gl)
    sel_w, sel_idx = _top_k(gates.transpose(1, 2), cap)  # [G, E, C]
    live = (sel_w > 0.0).float()
    g_ar = torch.arange(ng, device=x.device)[:, None, None]
    xe = xg[g_ar, sel_idx]  # [G, E, C, d]
    if cfg.mlp_type in ("swiglu", "geglu"):
        gproj = torch.einsum("gecd,edf->gecf", xe, params["wg"].to(dt))
        uproj = torch.einsum("gecd,edf->gecf", xe, params["wu"].to(dt))
        act = F.silu(gproj) if cfg.mlp_type == "swiglu" else F.gelu(gproj, approximate="tanh")
        h = act * uproj
    else:
        h = torch.einsum("gecd,edf->gecf", xe, params["wu"].to(dt))
        h = torch.square(F.relu(h)) if cfg.mlp_type == "squared_relu" else F.gelu(
            h, approximate="tanh")
    out_e = torch.einsum("gecf,efd->gecd", h, params["wd"].to(dt))  # [G, E, C, d]
    out_e = out_e * (sel_w * live)[..., None].to(dt)
    # A token receives at most top_k nonzero terms (the other picks add an
    # exact zero), so for top-2 the unordered accumulation on the card sums
    # the same two numbers the reference does, in either order.
    y = torch.zeros((ng, gl, d), dtype=dt, device=x.device)
    y.index_put_((g_ar.expand_as(sel_idx), sel_idx), out_e, accumulate=True)

    # --- aux losses (Switch-style) ------------------------------------------
    me = probs.mean(dim=(0, 1))  # mean router prob per expert
    routed = torch.zeros_like(gates).scatter_(-1, top_idx, 1.0)
    ce = routed.mean(dim=(0, 1))  # fraction of tokens per expert
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return y.reshape(b, s, d), MoEAux(lb, z)
