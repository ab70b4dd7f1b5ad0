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

from repro_torch.models.activation_sharding import is_dtensor, pin, shard_act


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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., n] @ w [n, m]``.  A DTensor ``x`` is folded to [-1, n] first,
    as ``torch.matmul`` folds a plain contiguous one, and the product's rows
    are put back in ``x``'s row placements before it is unfolded: DTensor's
    views can give a unit dim a stride that stops ``torch.matmul`` folding
    (the batched product it takes then rounds otherwise), and its product
    may split the rows over a mesh dim ``x`` did not, which the unfold's
    backward view cannot take apart."""
    if x.ndim < 3 or not is_dtensor(x):
        return x @ w
    from torch.distributed.tensor import Replicate

    x2 = x.reshape(-1, x.shape[-1])
    y2 = x2 @ w
    rows = tuple(xp if xp.is_shard(0) else (yp if not yp.is_shard(0) else Replicate())
                 for yp, xp in zip(y2.placements, x2.placements))
    if rows != tuple(y2.placements):
        y2 = y2.redistribute(y2.device_mesh, rows)
    return pin(y2.reshape(x.shape[:-1] + (w.shape[-1],)))


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


_FREQUENCIES = {}  # (head_dim, theta, device) -> the frequencies there


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta^(-i / half), i < half, in f32: computed on the CPU and copied to
    ``device`` once per (head_dim, theta, device) (a plain tensor is kept and
    shared: do not write into it).  The card's ``pow`` rounds an ulp away
    from the CPU's at some of these (D 64 at theta 1e4 among them), and
    position 524,287 turns one ulp of a frequency near 1 into a rotation
    ~2e-3 off; computed on the CPU, the card's are the CPU's bitwise."""
    dev = torch.device("cpu" if device is None else device)
    key = (head_dim, float(theta), dev)
    freqs = _FREQUENCIES.get(key)
    if freqs is None:
        half = head_dim // 2
        freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32) / half))
        freqs = freqs.to(dev)
        if type(freqs) is torch.Tensor and dev.type != "meta":  # not a fake or meta stand-in
            _FREQUENCIES[key] = freqs
    return freqs


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


def mlp_axes(mlp_type: str) -> dict:
    """Logical axes of ``mlp_init``'s tree."""
    if mlp_type in ("swiglu", "geglu"):
        return {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"), "wd": ("mlp", "embed")}
    return {"wu": ("embed", "mlp"), "wd": ("mlp", "embed")}


def mlp_apply(params: dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh approximation, so gelu here is
    ``approximate="tanh"`` in both the geglu and the plain gelu MLP."""
    dt = x.dtype
    if mlp_type in ("swiglu", "geglu"):
        g = shard_act(matmul(x, params["wg"].to(dt)), "batch", "act_seq", "act_ff")
        u = shard_act(matmul(x, params["wu"].to(dt)), "batch", "act_seq", "act_ff")
        act = F.silu(g) if mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        return matmul(act * u, params["wd"].to(dt))
    h = shard_act(matmul(x, params["wu"].to(dt)), "batch", "act_seq", "act_ff")
    if mlp_type == "squared_relu":
        h = torch.square(F.relu(h))
    elif mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return matmul(h, params["wd"].to(dt))


# -------------------------------------------------------------- embedding ---


def embedding_init(gen: torch.Generator, vocab: int, d_model: int) -> torch.Tensor:
    return torch.randn((vocab, d_model), generator=gen, device=gen.device) * (1.0 / math.sqrt(d_model))


EMBEDDING_AXES = ("vocab", "embed")
RMSNORM_AXES = ("embed_unsharded",)


def embed_tokens(emb: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if is_dtensor(emb):
        return _embed_on_mesh(emb, tokens, dtype)
    return emb[tokens].to(dtype)


def _embed_on_mesh(emb, tokens, dtype):
    """A vocab-parallel gather: each rank takes the rows of its vocab slice
    (the table's embed dim gathered whole: the FSDP all-gather) for every
    token it holds (the tokens gathered over the vocab's mesh dims), 0 for
    the others, and the sum over the slices is left partial (one nonzero
    term a token: exact)."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.models.activation_sharding import on_local_shards, sharded_dims
    from repro_torch.models.sharding import local_box

    mesh = emb.device_mesh
    emb_pl = tuple(p if getattr(p, "dim", None) == 0 else Replicate() for p in emb.placements)
    vocab = sharded_dims(emb_pl, 0)
    shape, offset = local_box(emb.shape, mesh, emb_pl)
    off, n = offset[0], shape[0]
    tok_pl = tuple(Replicate() if i in vocab else p for i, p in enumerate(tokens.placements))
    out_pl = tuple(Partial() if i in vocab else p for i, p in enumerate(tok_pl))

    def local(e, t):
        t = t.long() - off
        here = (t >= 0) & (t < n)
        rows = e[t.clamp(0, max(n - 1, 0))]
        return torch.where(here[..., None], rows, torch.zeros((), dtype=e.dtype,
                                                              device=e.device)).to(dtype)

    return on_local_shards(local, out_pl, (emb_pl, tok_pl), emb, tokens)


def unembed(emb_or_w: torch.Tensor, x: torch.Tensor, cap: Optional[float] = None) -> torch.Tensor:
    """-> f32 logits, softcapped when ``cap`` is set."""
    logits = matmul(x, emb_or_w.to(x.dtype).T)
    return softcap(logits.float(), cap)
