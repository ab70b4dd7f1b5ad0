"""Model facade (port of ``repro.models.model``): parameters and serving.

    init_params(gen)                    -> params
    prefill(params, batch, max_len)     -> (logits_last, cache)  [serve prefill]
    decode_step(params, token, cache)   -> (logits, cache)       [serve decode]

``init_params`` gives the reference's parameter layout — ``embed``,
``final_ln`` and the period-grouped ``layers`` stack — which the
model-cascade bank also uses as its shared backbone trunk.  Batches are
text only, ``{"tokens": [B, S] int}``; vision, audio and encoder inputs
wait for the model-zoo slice, ``loss_fn`` for the training slice.

``prefill`` and ``decode_step`` run on the device of their parameters.
The cache's K/V rows and SSM state are written in place
(``transformer.stack_apply``): a ``decode_step`` advances the cache it is
given.  ``serving_params`` makes the copy of a parameter tree that serving
reads, every matrix stored once in the activation dtype (bitwise what the
per-call casts give), and ``random_model`` builds a model with random
weights from a seed on the card (or, when asked, the CPU).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig


class Model:
    def __init__(self, cfg: ModelConfig):
        cfg.check_supported()
        if not cfg.tie_embeddings or cfg.frontend != "text":
            raise NotImplementedError("untied embeddings and frontends wait for the model-zoo slice")
        self.cfg = cfg

    def init_params(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        return {
            "embed": nn.embedding_init(gen, cfg.vocab_size, cfg.d_model),
            "final_ln": nn.rmsnorm_init(cfg.d_model, gen.device),
            "layers": tf.stack_init(gen, cfg, cfg.num_layers),
        }

    # ------------------------------------------------------------- embed ---

    def _embed_inputs(self, params: dict, batch: dict):
        """-> (x [B, S, d], positions [B, S])."""
        if set(batch) - {"tokens", "targets"}:
            raise NotImplementedError(
                f"inputs {sorted(set(batch) - {'tokens', 'targets'})} wait for the model-zoo slice")
        cfg = self.cfg
        x = nn.embed_tokens(params["embed"], batch["tokens"], cfg.activation_dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = nn.rmsnorm(x, params["final_ln"], cfg.rmsnorm_eps)
        return nn.unembed(params["embed"], x, cfg.final_logit_softcap)

    # -------------------------------------------------------------- serve --

    def prefill(self, params: dict, batch: dict, max_len: int):
        """Run the prompt, materialize caches sized ``max_len`` ->
        (logits of the last position [B, 1, V] f32, cache)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch)
        cache = tf.init_model_cache(cfg, x.shape[0], max_len, cfg.activation_dtype,
                                    device=x.device)
        x, cache = tf.stack_apply(params["layers"], cfg, x, positions, cfg.num_layers,
                                  cache=cache, update_cache=True, causal=True)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache: tf.ModelCache):
        """token: [B, 1] int.  One autoregressive step -> (logits [B, 1, V]
        f32, cache one token longer)."""
        cfg = self.cfg
        x = nn.embed_tokens(params["embed"], token, cfg.activation_dtype)
        b = x.shape[0]
        positions = cache.length.to(torch.int64).reshape(1, 1).expand(b, 1)
        x, cache = tf.stack_apply(params["layers"], cfg, x, positions, cfg.num_layers,
                                  cache=cache, update_cache=True, causal=True)
        return self._logits(params, x), cache


def teacher_forced(model: Model, params: dict, tokens: torch.Tensor, prompt: int, max_len: int):
    """Prefill ``tokens[:, :prompt]``, then feed ``tokens[:, t]`` for each
    ``t >= prompt`` as one decode step -> (logits after the prefill and after
    each step, each [B, 1, V] f32; the cache)."""
    logits, cache = model.prefill(params, {"tokens": tokens[:, :prompt]}, max_len)
    out = [logits]
    for t in range(prompt, tokens.shape[1]):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        out.append(logits)
    return out, cache


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """The tree serving reads: the embedding and the stack's matrices stored
    in the activation dtype, norms and SSM vectors f32."""
    dt = cfg.activation_dtype
    return dict(params, embed=params["embed"].to(dt),
                layers=tf.cast_matrices(params["layers"], dt))


def random_model(cfg: ModelConfig, seed: int = 0, device=None):
    """A model with random weights from ``seed`` on ``device`` (None means
    the card; no GPU raises unless ``device="cpu"``) -> (Model, serving
    params).  Its attention and SSD run the kernel route: the hand-written
    kernels on the card, their plain twins on the CPU."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, attn_impl="kernel")
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    return model, serving_params(params, cfg)
