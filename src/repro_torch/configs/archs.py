"""Architecture configs (port of ``repro.configs.archs``, the port's subset).

``qwen3_1_7b()`` and ``mamba2_370m()`` are the full published
configurations, ``*_smoke()`` the reduced same-family ones the reference
serves its cascade backbone and its arch smoke tests with.  ``bf16_check``
gives reduced bf16 configurations that keep the widths the card's bf16
kernels route on (head_dim 128; SSM head_dim 64, state 128, chunk 256), for
comparing a model on the CPU and the card through those kernels.  The
reference's other eight architectures come with the model-zoo slice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, SSMConfig


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


def mamba2_370m() -> ModelConfig:
    """[arXiv:2405.21060] 48L d1024 attn-free v50280 ssm_state=128 — SSD."""
    return ModelConfig(
        name="mamba2-370m", num_layers=48, d_model=1024, num_heads=0,
        num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        mlp_type="none", layer_pattern=("mamba",),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
        tie_embeddings=True, subquadratic=True,
    )


def mamba2_370m_smoke() -> ModelConfig:
    return dataclasses.replace(
        mamba2_370m(), name="mamba2-370m-smoke", num_layers=2, d_model=64,
        vocab_size=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=16),
    )


def qwen3_1_7b_bf16_check() -> ModelConfig:
    """2 layers, head_dim 128, 2 query heads over 1 KV head (GQA), bf16."""
    return dataclasses.replace(
        qwen3_1_7b(), name="qwen3-1.7b-bf16-check", num_layers=2, d_model=256,
        num_heads=2, num_kv_heads=1, d_ff=512, vocab_size=512,
    )


def mamba2_370m_bf16_check() -> ModelConfig:
    """2 layers, 4 SSM heads of head_dim 64, state 128, chunk 256, bf16."""
    return dataclasses.replace(
        mamba2_370m(), name="mamba2-370m-bf16-check", num_layers=2, d_model=128,
        vocab_size=512,
    )


ARCHS = {"qwen3-1.7b": qwen3_1_7b, "mamba2-370m": mamba2_370m}
SMOKES = {"qwen3-1.7b": qwen3_1_7b_smoke, "mamba2-370m": mamba2_370m_smoke}
BF16_CHECKS = {"qwen3-1.7b": qwen3_1_7b_bf16_check, "mamba2-370m": mamba2_370m_bf16_check}


def get_config(arch: str, smoke: bool = False, bf16_check: bool = False) -> ModelConfig:
    table = BF16_CHECKS if bf16_check else SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(table)}")
    return table[arch]()
