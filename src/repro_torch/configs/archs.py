"""Architecture configs (port of ``repro.configs.archs``, this slice's subset).

``qwen3_1_7b()`` is the full published configuration and
``qwen3_1_7b_smoke()`` the reduced same-family one the reference serves its
cascade backbone with.  The reference's other nine architectures come with
the model-zoo slice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


def qwen3_1_7b() -> ModelConfig:
    """[hf:Qwen/Qwen3-8B family] 28L d2048 16H kv8 ff6144 v151936 — qk_norm."""
    return ModelConfig(
        name="qwen3-1.7b", num_layers=28, d_model=2048, num_heads=16,
        num_kv_heads=8, head_dim=128, d_ff=6144, vocab_size=151936,
        mlp_type="swiglu", layer_pattern=("global",), qk_norm=True,
        rope_theta=1e6, tie_embeddings=True, subquadratic=False,
    )


def qwen3_1_7b_smoke() -> ModelConfig:
    return dataclasses.replace(
        qwen3_1_7b(), name="qwen3-1.7b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    )


ARCHS = {"qwen3-1.7b": qwen3_1_7b}
SMOKES = {"qwen3-1.7b": qwen3_1_7b_smoke}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(table)}")
    return table[arch]()
