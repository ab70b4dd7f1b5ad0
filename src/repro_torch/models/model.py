"""Model facade (port of ``repro.models.model``): parameters, the training
loss and serving.

    init_params(gen)                    -> params
    loss_fn(params, batch)              -> (loss, metrics)       [train step]
    prefill(params, batch, max_len)     -> (logits_last, cache)  [serve prefill]
    decode_step(params, token, cache)   -> (logits, cache)       [serve decode]

``init_params`` gives the reference's parameter layout — ``embed``,
``final_ln``, the period-grouped ``layers`` stack, and where the config asks
for them an untied ``unembed``, an encoder's ``enc_layers`` / ``enc_ln``
and a vision projector ``img_proj`` — which the model-cascade bank also uses
as its shared backbone trunk.  Batches are dicts, as the reference's:

    text    {"tokens": [B, S] int, "targets": [B, S] int (the loss only)}
    vision  + {"image_embeds": [B, n_img, d]} (anyres patch stub: projected
              by ``img_proj`` and put before the tokens)
    audio   + {"frames": [B, S_enc, d]} (the encoder's input: non-causal,
              no cache; its output rides in the cache for decode)

``loss_fn`` is the reference's next-token cross-entropy, differentiated by
autograd: the vision prefix carries no loss, the logits are made one
``loss_chunk`` of positions at a time (each chunk recomputed in the
backward pass, so no [B, S, V] logits are kept), and a mixture of experts
adds its load-balance and router-z losses.  ``prefill`` and ``decode_step``
run on the device of their parameters.  The cache's K/V rows and SSM state
are written in place (``transformer.stack_apply``): a ``decode_step``
advances the cache it is given.  ``serving_params`` makes the copy of a
parameter tree that serving reads, every matrix stored once in the
activation dtype (bitwise what the per-call casts give), and
``random_model`` builds that copy directly from a seed on the card (or,
when asked, the CPU), one f32 matrix alive at a time, so a model whose f32
tree does not fit beside it (nemotron-4-15b: 62.5 GB f32 + 31.3 GB bf16 on
an 80 GB card) still builds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as nn
from repro_torch.models import activation_sharding as act_sh
from repro_torch.models import transformer as tf
from repro_torch.models.activation_sharding import shard_act
from repro_torch.models.config import ModelConfig


def _encoder_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, layer_pattern=("global",), moe=None)


class Model:
    def __init__(self, cfg: ModelConfig):
        cfg.check_supported()
        self.cfg = cfg

    def init_params(self, gen: torch.Generator, dtype: Optional[torch.dtype] = None) -> dict:
        """The f32 tree, or with ``dtype`` the serving tree
        (``serving_params(init_params(gen), cfg)`` for ``dtype =
        cfg.activation_dtype``: the same draws, cast as they are made)."""
        cfg = self.cfg
        dev = gen.device

        def top(w):  # a top-level matrix, cast at once in the serving build
            return w if dtype is None else w.to(dtype)

        params = {"embed": top(nn.embedding_init(gen, cfg.vocab_size, cfg.d_model)),
                  "final_ln": nn.rmsnorm_init(cfg.d_model, dev)}
        is_encdec = cfg.encoder is not None
        params["layers"] = tf.stack_init(gen, cfg, cfg.num_layers, cross=is_encdec, dtype=dtype)
        if not cfg.tie_embeddings:
            params["unembed"] = top(nn.embedding_init(gen, cfg.vocab_size, cfg.d_model))
        if is_encdec:
            params["enc_layers"] = tf.stack_init(gen, _encoder_config(cfg), cfg.encoder.num_layers,
                                                 dtype=dtype)
            params["enc_ln"] = nn.rmsnorm_init(cfg.d_model, dev)
        if cfg.frontend == "vision":
            # anyres tile projector stub: patch embeds arrive pre-projected; a
            # single linear adapts them (LLaVA's mm_projector, simplified)
            params["img_proj"] = top(nn._dense_init(gen, (cfg.d_model, cfg.d_model)))
        return params

    def param_axes(self) -> dict:
        """The logical axes of ``init_params``' tree (the reference's
        ``init_params(key)[1]``), leaf for leaf."""
        cfg = self.cfg
        is_encdec = cfg.encoder is not None
        axes = {"embed": nn.EMBEDDING_AXES, "final_ln": nn.RMSNORM_AXES,
                "layers": tf.stack_axes(cfg, cross=is_encdec)}
        if not cfg.tie_embeddings:
            axes["unembed"] = ("vocab", "embed")
        if is_encdec:
            axes["enc_layers"] = tf.stack_axes(_encoder_config(cfg))
            axes["enc_ln"] = nn.RMSNORM_AXES
        if cfg.frontend == "vision":
            axes["img_proj"] = ("embed", "act_embed")
        return axes

    # ------------------------------------------------------------ encoder --

    def _encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S_enc, d] -> the encoder output [B, S_enc, d] (non-causal)."""
        cfg = self.cfg
        b, s, _ = frames.shape
        pos = torch.arange(s, device=frames.device)[None].expand(b, s)
        x = frames.to(cfg.activation_dtype)
        x, _, _ = tf.stack_apply(params["enc_layers"], _encoder_config(cfg), x, pos,
                                 cfg.encoder.num_layers, causal=False)
        return shard_act(nn.rmsnorm(x, params["enc_ln"], cfg.rmsnorm_eps), "batch", None,
                         "act_embed")

    # ------------------------------------------------------------- embed ---

    def _embed_inputs(self, params: dict, batch: dict):
        """-> (x [B, S, d], positions [B, S]); a vision batch's image embeds
        come first."""
        cfg = self.cfg
        x = nn.embed_tokens(params["embed"], batch["tokens"], cfg.activation_dtype)
        if cfg.frontend == "vision" and "image_embeds" in batch:
            img = batch["image_embeds"].to(cfg.activation_dtype)
            img = nn.matmul(img, params["img_proj"].to(img.dtype))
            x = torch.cat([img, x], dim=1)
        b, s, _ = x.shape
        x = shard_act(x, "batch", "seq", "act_embed")
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = nn.rmsnorm(x, params["final_ln"], cfg.rmsnorm_eps)
        w = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return nn.unembed(w, x, cfg.final_logit_softcap)

    # -------------------------------------------------------------- train --

    def loss_fn(self, params: dict, batch: dict, loss_chunk: int = 1024):
        """Mean next-token cross-entropy over ``batch["targets"]`` (plus the
        MoE aux losses) -> (loss, metrics: ``ce``, ``lb_loss`` / ``z_loss``
        for a mixture of experts, ``loss``), all f32 scalars."""
        cfg = self.cfg
        enc_out = None
        if cfg.encoder is not None:
            enc_out = self._encode(params, batch["frames"])
        x, positions = self._embed_inputs(params, batch)
        x, _, aux = tf.stack_apply(params["layers"], cfg, x, positions, cfg.num_layers,
                                   enc_out=enc_out, causal=True)
        x = nn.rmsnorm(x, params["final_ln"], cfg.rmsnorm_eps)
        x = shard_act(x, "batch", "act_seq", "act_embed")  # a mesh's sequence parallelism ends

        targets = batch["targets"]
        n_img = x.shape[1] - targets.shape[1]
        if n_img > 0:  # the vision prefix carries no LM loss
            x = x[:, n_img:]
        w = params["embed"] if cfg.tie_embeddings else params["unembed"]
        b, s, _ = x.shape
        chunk = min(loss_chunk, s)
        if s % chunk:
            raise ValueError(f"loss_chunk {chunk} does not divide the sequence length {s}")
        remat = torch.is_grad_enabled()
        total = None
        for i in range(0, s, chunk):
            args = (w, x[:, i:i + chunk], targets[:, i:i + chunk], cfg.final_logit_softcap)
            part = (checkpoint(_ce_sum, *args, use_reentrant=False) if remat
                    else _ce_sum(*args))
            total = part if total is None else total + part
        ce = total / (b * s)
        loss = ce
        metrics = {"ce": ce}
        if cfg.moe is not None:
            loss = loss + cfg.moe.load_balance_loss * aux.lb_loss \
                + cfg.moe.router_z_loss * aux.z_loss
            metrics["lb_loss"] = aux.lb_loss
            metrics["z_loss"] = aux.z_loss
        metrics["loss"] = loss
        return loss, metrics

    # -------------------------------------------------------------- serve --

    def prefill(self, params: dict, batch: dict, max_len: int):
        """Run the prompt, materialize caches sized ``max_len`` ->
        (logits of the last position [B, 1, V] f32, cache)."""
        cfg = self.cfg
        enc_out = None
        if cfg.encoder is not None:
            enc_out = self._encode(params, batch["frames"])
        x, positions = self._embed_inputs(params, batch)
        cache = tf.init_model_cache(cfg, x.shape[0], max_len, cfg.activation_dtype,
                                    device=x.device, enc_out=enc_out)
        x, cache, _ = tf.stack_apply(params["layers"], cfg, x, positions, cfg.num_layers,
                                     cache=cache, update_cache=True, enc_out=enc_out,
                                     causal=True)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params: dict, token: torch.Tensor, cache: tf.ModelCache):
        """token: [B, 1] int.  One autoregressive step -> (logits [B, 1, V]
        f32, cache one token longer)."""
        cfg = self.cfg
        x = nn.embed_tokens(params["embed"], token, cfg.activation_dtype)
        b = x.shape[0]
        positions = cache.length.to(torch.int64).reshape(1, 1).expand(b, 1)
        x, cache, _ = tf.stack_apply(params["layers"], cfg, x, positions, cfg.num_layers,
                                     cache=cache, update_cache=True, enc_out=cache.enc_out,
                                     causal=True)
        return self._logits(params, x), cache


def _ce_sum(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
            cap: Optional[float]) -> torch.Tensor:
    """Summed cross-entropy of one chunk of positions: x [B, c, d] against
    the unembedding ``w`` [V, d] -> logsumexp minus the gold logit, f32."""
    logits = shard_act(nn.unembed(w, x, cap), "batch", None, "act_ff")  # [B, c, V] f32
    lse = torch.logsumexp(logits, dim=-1)
    if act_sh.is_dtensor(logits):
        gold = _gold_on_mesh(logits, targets)
    else:
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.sum(lse - gold)


def _gold_on_mesh(logits, targets):
    """The gold logit of vocab-sharded logits: each rank gathers the targets
    that fall in its vocab slice (0 for the others), and the sum over the
    slices is left partial (one nonzero term a position: exact)."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.models.sharding import local_box

    rows = act_sh.placements("batch", None)
    lg_pl = tuple(p if getattr(p, "dim", None) in (0, 2) else Replicate()
                  for p in logits.placements)
    vocab = act_sh.sharded_dims(lg_pl, 2)
    shape, offset = local_box(logits.shape, logits.device_mesh, lg_pl)
    off, n = offset[2], shape[2]
    out_pl = tuple(Partial() if i in vocab else p for i, p in enumerate(rows))

    def local(lg, tg):
        t = tg.long() - off
        here = (t >= 0) & (t < n)
        picked = torch.gather(lg, -1, t.clamp(0, max(n - 1, 0))[..., None])[..., 0]
        return torch.where(here, picked, torch.zeros((), dtype=lg.dtype, device=lg.device))

    return act_sh.on_local_shards(local, out_pl, (lg_pl, rows), logits, targets)


def teacher_forced(model: Model, params: dict, tokens: torch.Tensor, prompt: int, max_len: int,
                   extra: Optional[dict] = None):
    """Prefill ``tokens[:, :prompt]`` (with the batch's ``extra`` inputs:
    image embeds, frames), then feed ``tokens[:, t]`` for each ``t >=
    prompt`` as one decode step -> (logits after the prefill and after each
    step, each [B, 1, V] f32; the cache)."""
    logits, cache = model.prefill(params, {"tokens": tokens[:, :prompt], **(extra or {})},
                                  max_len)
    out = [logits]
    for t in range(prompt, tokens.shape[1]):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
        out.append(logits)
    return out, cache


_TOP_MATRICES = ("embed", "unembed", "img_proj")


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """The tree serving reads: the embeddings, the projector and the stacks'
    matrices stored in the activation dtype, norms and SSM vectors f32."""
    dt = cfg.activation_dtype
    out = dict(params, layers=tf.cast_matrices(params["layers"], dt))
    out.update({k: params[k].to(dt) for k in _TOP_MATRICES if k in params})
    if "enc_layers" in params:
        out["enc_layers"] = tf.cast_matrices(params["enc_layers"], dt)
    return out


def random_model(cfg: ModelConfig, seed: int = 0, device=None):
    """A model with random weights from ``seed`` on ``device`` (None means
    the card; no GPU raises unless ``device="cpu"``) -> (Model, serving
    params), bitwise ``serving_params(init_params(gen), cfg)`` for the same
    seed, built without the f32 tree.  Its attention and SSD run the kernel
    route: the hand-written kernels on the card, their plain twins on the
    CPU."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, attn_impl="kernel")
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model, model.init_params(gen, dtype=cfg.activation_dtype)
