"""Model configuration (port of ``repro.models.config``).

One composable transformer family; every architectural lever is a field.
Layer mixers are a per-layer pattern cycled across depth:

    "global"  — full GQA attention
    "local"   — sliding-window GQA attention (window = sliding_window)
    "mamba"   — Mamba-2 SSD mixer (attention-free)
    "hymba"   — parallel attention and Mamba-2 heads

MLPs: "swiglu" | "geglu" | "squared_relu" | "gelu" | "none" (mamba2 has
no MLP), or a mixture of experts (``moe=MoEConfig(...)``, Arctic's with a
dense residual MLP); ``encoder=EncoderConfig(...)`` adds an encoder tower
and a cross-attention block to every decoder layer (seamless), and
``frontend="vision"`` a projected image-embedding prefix (llava).  The port
serves and trains all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# "kernel" is the port's counterpart of the reference's "pallas": the
# hand-written CUDA kernels on the card (flash attention, decode attention for
# one query token over a cache, the SSD intra-chunk term of the Mamba-2
# mixer), their plain twins on the CPU; the kernels have no backward, so
# training cannot take it.  "dense" and "chunked" are the reference's plain
# engines (the SSD mixer runs its plain closed form under both), and "auto"
# picks between them by size as the reference does: the routes training
# differentiates through.
ATTN_IMPLS = ("auto", "dense", "chunked", "kernel")
MIXERS = ("global", "local", "mamba", "hymba")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    d_ff_expert: int = 0  # per-expert hidden size
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec archs (seamless).  Frontend is a stub:
    inputs are precomputed frame embeddings [B, S_enc, d_model]."""

    num_layers: int = 24
    seq_len: int = 1024  # default encoder length (audio frames)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"
    layer_pattern: tuple = ("global",)  # cycled over layers
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: str = "text"  # "text" | "audio" | "vision"
    num_image_tokens: int = 0
    dtype: str = "bfloat16"
    remat: bool = True  # recompute each layer group in the backward pass (training)
    scan_layers: bool = True
    attn_impl: str = "auto"  # "auto" | "dense" | "chunked" | "kernel" (the reference's "pallas")
    subquadratic: bool = False

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def mixer_of_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def check_supported(self) -> None:
        """Raise ``NotImplementedError`` for what the port does not run."""
        if self.attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(f"attn_impl={self.attn_impl!r}: the port runs {ATTN_IMPLS}")
        odd = sorted(set(self.layer_pattern) - set(MIXERS))
        if odd:
            raise ValueError(f"unknown mixers {odd}; the zoo has {MIXERS}")
        if {"mamba", "hymba"} & set(self.layer_pattern) and self.ssm is None:
            raise ValueError("the mamba and hymba mixers need ssm=SSMConfig(...)")

    # ---- parameter counting (for the cascade's FLOP costs) ----

    def _attn_params(self) -> int:
        qkv = self.d_model * self.head_dim * (self.num_heads + 2 * self.num_kv_heads)
        out = self.num_heads * self.head_dim * self.d_model
        return qkv + out

    def _mlp_params(self) -> int:
        if self.mlp_type == "none" or self.d_ff == 0:
            return 0
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def _moe_params(self) -> tuple[int, int]:
        """(total, active per token)."""
        if self.moe is None:
            return 0, 0
        m = self.moe
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        per_expert = mult * self.d_model * m.d_ff_expert
        router = self.d_model * m.num_experts
        total = m.num_experts * per_expert + router
        active = m.top_k * per_expert + router
        if m.dense_residual:
            dense = mult * self.d_model * self.d_ff
            total += dense
            active += dense
        return total, active

    def _ssm_params(self) -> int:
        if self.ssm is None:
            return 0
        s = self.ssm
        di = s.d_inner(self.d_model)
        nh = s.num_heads(self.d_model)
        in_proj = self.d_model * (2 * di + 2 * s.state_dim + nh)
        conv = s.conv_width * (di + 2 * s.state_dim)
        out_proj = di * self.d_model
        return in_proj + conv + out_proj + di + 2 * nh

    def param_counts(self) -> dict:
        """dict(total=..., active=...) parameter counts, embeddings once."""
        embed = self.vocab_size * self.d_model
        unembed = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        total = active = embed + unembed
        enc_layers = self.encoder.num_layers if self.encoder else 0
        for i in range(self.num_layers):
            mixer = self.mixer_of_layer(i)
            layer_t = 0
            if mixer in ("global", "local", "hybrid", "hymba"):
                layer_t += self._attn_params()
            if mixer in ("mamba", "hymba"):
                layer_t += self._ssm_params()
            layer_a = layer_t
            if self.moe is not None:
                mt, ma = self._moe_params()
                layer_t += mt
                layer_a += ma
            else:
                layer_t += self._mlp_params()
                layer_a += self._mlp_params()
            total += layer_t
            active += layer_a
        for _ in range(enc_layers):
            lt = self._attn_params() + self._mlp_params()
            total += lt + self._attn_params()  # + decoder cross-attention
            active += lt + self._attn_params()
        return dict(total=total, active=active)
