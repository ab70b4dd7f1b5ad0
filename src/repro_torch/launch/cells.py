"""The reference's serve cells on one card: ``configs/shapes.py``'s
``prefill_32k`` (32,768 tokens), ``decode_32k`` (a 32,768-row cache) and
``long_500k`` (524,288 rows at batch 1), each at the largest batch and depth
that one 80 GB card holds.

``one_card_cell(arch, shape)`` reckons bytes: the serving weights (the tree
``models.model.random_model`` builds, counted on the meta device), the KV /
SSM cache exactly as ``transformer.init_model_cache`` allocates it at
``max_len = shape.seq_len`` (the reference's prefill step, and the decode
step's cache), and an activation margin (``activation_bytes``).  It takes
the largest batch among the reference's global batch and its halvings that
fits ``CARD_BYTES``; where one row does not fit at full depth it cuts the
depth to the largest multiple of the layer pattern's period that does.
Every cut is listed in ``Cell.reduced``.

``fill_cache(cache, gen, length)`` writes seeded normal values in place, on
the cache's own device (no host copy, no temporary larger than one batch
row of one layer), into every K / V row below ``length`` and into the SSM
conv tail and state, and returns the cache at that length: a decode cell's
stand-in for a prompt of ``length`` tokens.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.archs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, shape_applicable
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.optim.tree import leaves

GIB = 1 << 30
# What the allocator may hold on an 80 GB H100 (torch sees 79.2 GiB), less
# room for fragmentation, cuBLAS workspaces and the kernels' own buffers.
CARD_BYTES = 76 * GIB
# A prefill's live activations, in bytes a token per unit of its widest
# per-token activation (``widest_activation``: a gated MLP's hidden width,
# the SSM's input projection, the query heads), by family: the peak measured
# on an H100 80GB HBM3 (700 W) in a process of its own, less the weights and
# the cache.  The attention family: the qwen3-1.7b prefill at B 8 peaked at
# 12.7 (a gated MLP's gate, up and product beside RoPE's f32 halves).  The
# SSM family: the mamba2-370m prefill at B 32 peaked at 47.73 GB, 9.87 (8.94
# at B 16: 22.10 GB; ``launch/profile.py --shape prefill_32k --batch 32``),
# with the SSD's recurrence a kernel that adds into the intra-chunk output
# in place and the mixer freeing its projection and conv output once
# consumed; with the recurrence a PyTorch loop it peaked at 15.2 (72.07 GB).
# A model with both kinds of layer takes the larger.
PREFILL_BYTES_PER_WIDTH = {"attention": 12.7, "ssm": 9.9}
# Room for the allocator's fragmentation on top of a family's peak: run
# after chip_smoke.py's earlier phases, the B 32 mamba2 prefill once ran out
# of memory with 10.9 GiB of the allocator's segments reserved but free
# (2.5 bytes a token and unit at B 32); about five bytes are kept.
PREFILL_ROOM_BYTES_PER_WIDTH = 5.0
# A decode step's activations: per-layer vectors of B rows and the logits
# [B, V] f32 (three copies: the unembedding's f32 output, its softcap, the
# argmax's input), on top of a fixed margin.
DECODE_FIXED_BYTES = 1 * GIB
DECODE_LOGIT_COPIES = 3


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeSpec  # the reference's cell
    cfg: ModelConfig  # full width, depth as run
    batch: int
    reduced: tuple  # the cuts, in words
    weight_bytes: int
    cache_bytes: int
    activation_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.cache_bytes + self.activation_bytes


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of the serving tree (matrices in the activation dtype, norms and
    SSM vectors f32), counted on the meta device."""
    from repro_torch.launch.steps import abstract_params_and_axes

    params, _ = abstract_params_and_axes(Model(cfg), dtype=cfg.activation_dtype)
    return sum(t.numel() * t.element_size() for t in leaves(params) if t is not None)


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of ``init_model_cache(cfg, batch, max_len, activation dtype)``."""
    cache = tf.init_model_cache(cfg, batch, max_len, cfg.activation_dtype, device="meta")
    return sum(t.numel() * t.element_size()
               for t in cache.kv_k + cache.kv_v + cache.ssm_conv + cache.ssm_h if t is not None)


def widest_activation(cfg: ModelConfig) -> int:
    """The widest per-token activation of a layer, in elements."""
    widths = [cfg.d_model, cfg.num_heads * cfg.head_dim]
    if cfg.mlp_type != "none":
        widths.append(cfg.d_ff)
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        widths.append(2 * di + 2 * s.state_dim + s.num_heads(cfg.d_model))
    return max(widths)


def prefill_bytes_per_width(cfg: ModelConfig) -> float:
    """A prefill's bytes a token and unit of width: the measured peak of the
    families its layers belong to (the larger), plus the room."""
    kinds = {"mamba": ("ssm",), "hymba": ("attention", "ssm")}  # else attention alone
    families = {f for mixer in cfg.layer_pattern for f in kinds.get(mixer, ("attention",))}
    return (max(PREFILL_BYTES_PER_WIDTH[f] for f in families)
            + PREFILL_ROOM_BYTES_PER_WIDTH)


def activation_bytes(cfg: ModelConfig, shape: ShapeSpec, batch: int) -> int:
    """The margin for a step's activations (see the constants above)."""
    if shape.kind == "prefill":
        return int(batch * shape.seq_len * prefill_bytes_per_width(cfg)
                   * widest_activation(cfg))
    return DECODE_FIXED_BYTES + batch * cfg.vocab_size * 4 * DECODE_LOGIT_COPIES


def _bytes(cfg: ModelConfig, shape: ShapeSpec, batch: int) -> tuple:
    return (weight_bytes(cfg), cache_bytes(cfg, batch, shape.seq_len),
            activation_bytes(cfg, shape, batch))


def one_card_cell(arch: str, shape: str) -> Cell:
    """The reference's cell ``(arch, shape)`` at full width, sized to one
    card (see the module docstring)."""
    spec = SHAPES[shape]
    if spec.kind not in ("prefill", "decode"):
        raise ValueError(f"{shape} is a {spec.kind} cell; one_card_cell sizes serve cells")
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape}: {reason}")
    batch = spec.global_batch
    while batch >= 1:
        sizes = _bytes(cfg, spec, batch)
        if sum(sizes) <= CARD_BYTES:
            break
        batch //= 2
    reduced = []
    if batch >= 1:
        if batch < spec.global_batch:
            over = _bytes(cfg, spec, 2 * batch)
            why = (f" (of it {over[2] / 1e9:.1f} GB of activations at "
                   f"{prefill_bytes_per_width(cfg):g} bytes a token and unit of width: the "
                   f"family's measured peak plus room for the allocator's fragmentation)"
                   if spec.kind == "prefill" else "")
            reduced.append(f"global batch {spec.global_batch} -> {batch}: {sum(over) / 1e9:.1f} "
                           f"GB reckoned at batch {2 * batch}{why} exceeds the card's "
                           f"{CARD_BYTES / 1e9:.1f} GB")
        return Cell(arch, spec, cfg, batch, tuple(reduced), *sizes)
    # One row does not fit at full depth: cut the depth by whole pattern periods.
    batch, period = 1, len(cfg.layer_pattern)
    full = sum(_bytes(cfg, spec, 1)) / 1e9
    full_cache = cache_bytes(cfg, 1, spec.seq_len) / 1e9
    layers = cfg.num_layers - cfg.num_layers % period
    while layers >= period:
        cut = dataclasses.replace(cfg, num_layers=layers)
        sizes = _bytes(cut, spec, batch)
        if sum(sizes) <= CARD_BYTES:
            break
        layers -= period
    if layers < period:
        raise ValueError(f"{arch} x {shape}: one pattern period does not fit one card")
    if spec.global_batch > 1:
        reduced.append(f"global batch {spec.global_batch} -> 1")
    reduced.append(f"layers {cfg.num_layers} -> {layers} (multiple of the period {period}): "
                   f"{full:.1f} GB at full depth ({full_cache:.1f} GB of cache) exceeds the "
                   f"card's {CARD_BYTES / 1e9:.1f} GB")
    return Cell(arch, spec, cut, batch, tuple(reduced), *sizes)


# The reference's serve cells the card runs: every (arch, shape) of
# chip_smoke's long-context phase, in its order.
SERVE_CELLS = (("qwen3-1.7b", "prefill_32k"), ("mamba2-370m", "prefill_32k"),
               ("qwen3-1.7b", "decode_32k"), ("mamba2-370m", "decode_32k"),
               ("hymba-1.5b", "long_500k"), ("h2o-danube-1.8b", "long_500k"),
               ("gemma2-9b", "long_500k"), ("mamba2-370m", "long_500k"))


def fill_cache(cache: tf.ModelCache, gen: torch.Generator, length: int) -> tf.ModelCache:
    """Seeded normal values written in place into every K / V row below
    ``length`` (one contiguous [length, KV, D] block a layer and batch row)
    and into the SSM conv tails and states, on the cache's device from
    ``gen`` (a generator on that device) -> the cache at ``length``."""
    for stack in cache.kv_k + cache.kv_v:
        if stack is None:
            continue
        if length > stack.shape[2]:
            raise ValueError(f"length {length} exceeds the cache's {stack.shape[2]} rows")
        for g in range(stack.shape[0]):
            for b in range(stack.shape[1]):
                stack[g, b, :length].normal_(generator=gen)
    for stack in cache.ssm_conv + cache.ssm_h:
        if stack is not None:
            stack.normal_(generator=gen)
    length_t = torch.full((), length, dtype=torch.int32, device=cache.length.device)
    return dataclasses.replace(cache, length=length_t)

