"""Model facade (port of ``repro.models.model``, the parameters only).

``Model(cfg).init_params(gen)`` gives the reference's parameter layout —
``embed``, ``final_ln`` and the period-grouped ``layers`` stack — which the
model-cascade bank uses as its shared backbone trunk.  ``loss_fn``,
``prefill`` and ``decode_step`` come with the decode and training slices.
"""

from __future__ import annotations

import torch

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
