"""Architecture configs (port of ``repro.configs.archs``): the published
dimensions of the ten assigned architectures and their reduced smoke twins.

Each ``<arch>()`` returns the FULL config and ``<arch>_smoke()`` the reduced
same-family config the reference runs its arch smoke tests and serves its
cascade backbone with, value for value the reference's.  ``bf16_check``
gives reduced bf16 configurations that keep the widths the card's bf16
kernels route on (a head_dim of 80, 128 or 256, a GQA group of 2, 4 or 5;
an SSM head_dim 64 with state 128 or 16 and chunk 256; an encoder over
non-causal frames), for comparing a model on the CPU and the card through
those kernels.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import EncoderConfig, ModelConfig, MoEConfig, SSMConfig

# ---------------------------------------------------------------- grok-1 ---


def grok_1_314b() -> ModelConfig:
    """[hf:xai-org/grok-1] 64L d6144 48H kv8 ff32768 v131072, MoE 8e top-2."""
    return ModelConfig(
        name="grok-1-314b", num_layers=64, d_model=6144, num_heads=48,
        num_kv_heads=8, head_dim=128, d_ff=32768, vocab_size=131072,
        mlp_type="geglu", layer_pattern=("global",),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32768),
        tie_embeddings=True, subquadratic=False,
    )


def grok_1_314b_smoke() -> ModelConfig:
    return dataclasses.replace(
        grok_1_314b(), name="grok-1-314b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )


# ---------------------------------------------------------------- arctic ---


def arctic_480b() -> ModelConfig:
    """[hf:Snowflake/snowflake-arctic-base] 35L d7168 56H kv8 ff4864 v32000,
    MoE 128e top-2 + dense residual."""
    return ModelConfig(
        name="arctic-480b", num_layers=35, d_model=7168, num_heads=56,
        num_kv_heads=8, head_dim=128, d_ff=4864, vocab_size=32000,
        mlp_type="swiglu", layer_pattern=("global",),
        moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                      dense_residual=True),
        tie_embeddings=True, subquadratic=False,
    )


def arctic_480b_smoke() -> ModelConfig:
    return dataclasses.replace(
        arctic_480b(), name="arctic-480b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                      dense_residual=True),
    )


# --------------------------------------------------------------- gemma-2 ---


def gemma2_9b() -> ModelConfig:
    """[arXiv:2408.00118] 42L d3584 16H kv8 ff14336 v256000 — alternating
    local(4096)/global attention, attn softcap 50, final softcap 30."""
    return ModelConfig(
        name="gemma2-9b", num_layers=42, d_model=3584, num_heads=16,
        num_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
        mlp_type="gelu", layer_pattern=("local", "global"),
        sliding_window=4096, attn_logit_softcap=50.0, final_logit_softcap=30.0,
        tie_embeddings=True,
        subquadratic=True,  # local layers sub-quadratic; global layers O(L)/tok at decode
    )


def gemma2_9b_smoke() -> ModelConfig:
    return dataclasses.replace(
        gemma2_9b(), name="gemma2-9b-smoke", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=16,
    )


# ------------------------------------------------------------- nemotron-4 --


def nemotron_4_15b() -> ModelConfig:
    """[arXiv:2402.16819] 32L d6144 48H kv8 ff24576 v256000 — squared-ReLU."""
    return ModelConfig(
        name="nemotron-4-15b", num_layers=32, d_model=6144, num_heads=48,
        num_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=256000,
        mlp_type="squared_relu", layer_pattern=("global",),
        tie_embeddings=False, subquadratic=False,
    )


def nemotron_4_15b_smoke() -> ModelConfig:
    return dataclasses.replace(
        nemotron_4_15b(), name="nemotron-4-15b-smoke", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256,
        vocab_size=256,
    )


# ------------------------------------------------------------- h2o-danube --


def h2o_danube_1_8b() -> ModelConfig:
    """[arXiv:2401.16818] 24L d2560 32H kv8 ff6912 v32000 — SWA (llama/mistral
    mix; window 4096)."""
    return ModelConfig(
        name="h2o-danube-1.8b", num_layers=24, d_model=2560, num_heads=32,
        num_kv_heads=8, head_dim=80, d_ff=6912, vocab_size=32000,
        mlp_type="swiglu", layer_pattern=("local",), sliding_window=4096,
        tie_embeddings=False, subquadratic=True,
    )


def h2o_danube_1_8b_smoke() -> ModelConfig:
    return dataclasses.replace(
        h2o_danube_1_8b(), name="h2o-danube-1.8b-smoke", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256, sliding_window=16,
    )


# ----------------------------------------------------------------- qwen3 ---


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


# ------------------------------------------------------------ seamless-m4t --


def seamless_m4t_large_v2() -> ModelConfig:
    """[arXiv:2308.11596] enc-dec 24L(+24L enc) d1024 16H kv16 ff8192 v256206
    — multimodal; speech frontend is a stub (precomputed frame embeddings)."""
    return ModelConfig(
        name="seamless-m4t-large-v2", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, head_dim=64, d_ff=8192,
        vocab_size=256206, mlp_type="swiglu", layer_pattern=("global",),
        encoder=EncoderConfig(num_layers=24, seq_len=1024),
        frontend="audio", tie_embeddings=True, subquadratic=False,
    )


def seamless_m4t_large_v2_smoke() -> ModelConfig:
    return dataclasses.replace(
        seamless_m4t_large_v2(), name="seamless-m4t-large-v2-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, encoder=EncoderConfig(num_layers=2, seq_len=32),
    )


# ----------------------------------------------------------------- hymba ---


def hymba_1_5b() -> ModelConfig:
    """[arXiv:2411.13676] 32L d1600 25H kv5 ff5504 v32001 ssm_state=16 —
    parallel attention + mamba heads in every layer."""
    return ModelConfig(
        name="hymba-1.5b", num_layers=32, d_model=1600, num_heads=25,
        num_kv_heads=5, head_dim=64, d_ff=5504, vocab_size=32001,
        mlp_type="swiglu", layer_pattern=("hymba",),
        ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk_size=256),
        sliding_window=2048,  # Hymba uses SWA on most attention layers
        tie_embeddings=True, subquadratic=True,
    )


def hymba_1_5b_smoke() -> ModelConfig:
    return dataclasses.replace(
        hymba_1_5b(), name="hymba-1.5b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, chunk_size=16),
        sliding_window=16,
    )


# ------------------------------------------------------------- llava-next --


def llava_next_mistral_7b() -> ModelConfig:
    """[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L d4096 32H kv8 ff14336
    v32000 — anyres tiling (vision stub: precomputed patch embeddings,
    up to 5 tiles x 576 patches = 2880 prefix tokens)."""
    return ModelConfig(
        name="llava-next-mistral-7b", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=32000, mlp_type="swiglu", layer_pattern=("global",),
        frontend="vision", num_image_tokens=2880, tie_embeddings=False,
        subquadratic=False,
    )


def llava_next_mistral_7b_smoke() -> ModelConfig:
    return dataclasses.replace(
        llava_next_mistral_7b(), name="llava-next-mistral-7b-smoke",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_image_tokens=8,
    )


# ---------------------------------------------------------------- mamba-2 --


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


# ------------------------------------------------ reduced bf16 checks ------


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


def gemma2_9b_bf16_check() -> ModelConfig:
    """A local and a global layer, head_dim 256, 2 query heads over 1 KV
    head, both softcaps, a window of 64 (so a 96-token prompt crosses it)."""
    return dataclasses.replace(
        gemma2_9b(), name="gemma2-9b-bf16-check", num_layers=2, d_model=256,
        num_heads=2, num_kv_heads=1, d_ff=512, vocab_size=512, sliding_window=64,
    )


def h2o_danube_1_8b_bf16_check() -> ModelConfig:
    """2 local layers, head_dim 80, 4 query heads over 1 KV head, window 64."""
    return dataclasses.replace(
        h2o_danube_1_8b(), name="h2o-danube-1.8b-bf16-check", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=1, d_ff=512, vocab_size=512, sliding_window=64,
    )


def hymba_1_5b_bf16_check() -> ModelConfig:
    """2 hymba layers: 5 query heads over 1 KV head of 64 beside 4 SSM heads
    of head_dim 64, state 16, chunk 256."""
    return dataclasses.replace(
        hymba_1_5b(), name="hymba-1.5b-bf16-check", num_layers=2, d_model=128,
        num_heads=5, num_kv_heads=1, d_ff=256, vocab_size=512,
    )


def seamless_m4t_large_v2_bf16_check() -> ModelConfig:
    """2 decoder layers over a 2-layer encoder of 128 frames, head_dim 64,
    4 heads over 4 KV heads."""
    return dataclasses.replace(
        seamless_m4t_large_v2(), name="seamless-m4t-large-v2-bf16-check", num_layers=2,
        d_model=256, num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        encoder=EncoderConfig(num_layers=2, seq_len=128),
    )


ARCHS = {
    "grok-1-314b": grok_1_314b,
    "arctic-480b": arctic_480b,
    "gemma2-9b": gemma2_9b,
    "nemotron-4-15b": nemotron_4_15b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "qwen3-1.7b": qwen3_1_7b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "hymba-1.5b": hymba_1_5b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "mamba2-370m": mamba2_370m,
}

SMOKES = {
    "grok-1-314b": grok_1_314b_smoke,
    "arctic-480b": arctic_480b_smoke,
    "gemma2-9b": gemma2_9b_smoke,
    "nemotron-4-15b": nemotron_4_15b_smoke,
    "h2o-danube-1.8b": h2o_danube_1_8b_smoke,
    "qwen3-1.7b": qwen3_1_7b_smoke,
    "seamless-m4t-large-v2": seamless_m4t_large_v2_smoke,
    "hymba-1.5b": hymba_1_5b_smoke,
    "llava-next-mistral-7b": llava_next_mistral_7b_smoke,
    "mamba2-370m": mamba2_370m_smoke,
}

BF16_CHECKS = {
    "qwen3-1.7b": qwen3_1_7b_bf16_check,
    "mamba2-370m": mamba2_370m_bf16_check,
    "gemma2-9b": gemma2_9b_bf16_check,
    "h2o-danube-1.8b": h2o_danube_1_8b_bf16_check,
    "hymba-1.5b": hymba_1_5b_bf16_check,
    "seamless-m4t-large-v2": seamless_m4t_large_v2_bf16_check,
}


def get_config(arch: str, smoke: bool = False, bf16_check: bool = False) -> ModelConfig:
    table = BF16_CHECKS if bf16_check else SMOKES if smoke else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(table)}")
    return table[arch]()
