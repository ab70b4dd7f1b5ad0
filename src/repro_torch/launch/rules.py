"""Per-(config, mesh, shape) sharding rules with divisibility fallbacks
(port of ``repro.launch.rules``).

TP axes only shard dims divisible by the model-axis size; otherwise the rule
falls back (e.g. arctic's 56 heads are not divisible by 16 -> attention
shards head_dim instead; seamless' 256206 vocab stays unsharded while its
embedding dim FSDPs).  Decode shapes shard the KV cache sequence dim across
whatever axes the batch cannot use (long_500k: batch=1 -> kv_seq over
(pod, data, model) — flash-decoding across shards).  ``mesh`` is a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` dict.
"""

from __future__ import annotations

import math

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (FSDP_AXES, ShardingRules, mesh_axis_names,
                                         mesh_axis_sizes)


def rules_for_cell(cfg: ModelConfig, mesh, shape_kind: str, global_batch: int) -> ShardingRules:
    names = set(mesh_axis_names(mesh))
    sizes = mesh_axis_sizes(mesh)
    fsdp = tuple(a for a in FSDP_AXES if a in names)
    dp = math.prod(sizes[a] for a in fsdp) if fsdp else 1
    tp = sizes["model"] if "model" in names else 1

    def div(n: int) -> bool:
        return n > 0 and n % tp == 0

    # attention head sharding strategy
    heads_rule = "model" if div(cfg.num_heads) else None
    head_dim_rule = None
    if heads_rule is None and div(cfg.head_dim):
        head_dim_rule = "model"
    kv_heads_rule = "model" if div(cfg.num_kv_heads) else None
    if kv_heads_rule is None and head_dim_rule == "model":
        # keep q/k/v contraction layout consistent
        kv_heads_rule = None

    vocab_rule = "model" if div(cfg.vocab_size) else None
    mlp_rule = "model" if div(cfg.d_ff) or cfg.d_ff == 0 else None

    # ssm dims
    ssm_inner_rule = None
    ssm_heads_rule = None
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.d_inner(cfg.d_model)
        nh = s.num_heads(cfg.d_model)
        proj_out = 2 * di + 2 * s.state_dim + nh
        conv_ch = di + 2 * s.state_dim
        if div(proj_out) and div(conv_ch) and div(di):
            ssm_inner_rule = "model"
        ssm_heads_rule = "model" if div(nh) else None

    # experts
    expert_rule = None
    expert_embed = fsdp
    if cfg.moe is not None and "data" in names and cfg.moe.num_experts % sizes["data"] == 0:
        expert_rule = "data"
        expert_embed = tuple(a for a in fsdp if a != "data")

    # batch/data-parallel activations
    batch_rule: tuple | None = fsdp
    if global_batch % max(dp, 1) != 0 or global_batch < dp:
        batch_rule = None

    # decode KV-seq sharding: use the axes batch does not occupy
    kv_seq_rule = None
    if shape_kind == "decode":
        if batch_rule is None:
            kv_seq_rule = tuple(a for a in (*fsdp, "model") if a in names)
        else:
            kv_seq_rule = "model"
    elif shape_kind == "prefill":
        kv_seq_rule = "model"

    # Sequence parallelism (Megatron-SP style) for training: the residual
    # stream between blocks shards its seq dim over "model"; the all-gather
    # before attention / MLP (whose activations shard over heads / ff on the
    # same axis) and a reduce-scatter after follow from the redistributes.
    seq_rule = "model" if shape_kind == "train" else None

    rules = {
        "batch": batch_rule,
        "seq": seq_rule,
        "act_seq": None,
        "kv_seq": kv_seq_rule,
        "act_embed": None,
        "act_heads": heads_rule,
        "act_ff": mlp_rule,
        "embed": fsdp,
        "embed_unsharded": None,
        "heads": heads_rule,
        "kv_heads": kv_heads_rule,
        "head_dim": head_dim_rule,
        "mlp": mlp_rule,
        "vocab": vocab_rule,
        "experts": expert_rule,
        "expert_embed": expert_embed,
        "layers": None,
        "conv": None,
        "state": None,
        "ssm_heads": ssm_heads_rule,
        "ssm_inner": ssm_inner_rule,
    }
    return ShardingRules(rules=rules)
