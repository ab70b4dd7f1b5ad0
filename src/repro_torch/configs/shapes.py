"""The assigned input shapes (the four LM-family cells) and which
architectures run them (port of ``repro.configs.shapes``).

    train_4k     seq 4096,   global batch 256   -> train step
    prefill_32k  seq 32768,  global batch 32    -> serve prefill
    decode_32k   KV 32768,   global batch 128   -> serve decode (1 new token)
    long_500k    KV 524288,  global batch 1     -> long-context decode

``long_500k`` runs only for sub-quadratic architectures
(``cfg.subquadratic``); pure full-attention ones skip it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """-> (runnable, the reason when skipped)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch — 500k context requires a "
                       "sub-quadratic path (DESIGN.md §Arch-applicability)")
    return True, ""


def smoke_shape(spec: ShapeSpec) -> ShapeSpec:
    """A tiny shape of the same kind for CPU smoke runs."""
    return ShapeSpec(spec.name + "-smoke", spec.kind, seq_len=64, global_batch=2)


def all_cells() -> list:
    """The 40 (arch x shape) cells, each with its applicability."""
    from repro_torch.configs.archs import ARCHS

    cells = []
    for arch, fn in ARCHS.items():
        cfg = fn()
        for sname in SHAPES:
            ok, reason = shape_applicable(cfg, sname)
            cells.append(dict(arch=arch, shape=sname, runnable=ok, reason=reason))
    return cells
