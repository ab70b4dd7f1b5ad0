"""Model-cascade tagging bank: PIQUE's tagging functions as real models.

Port of ``repro.enrich.cascade``.  Each tag type gets a cascade of
classifiers over object feature vectors, cheap -> expensive:

    level 0: linear probe                 (the pre-executed cheapest function)
    level 1: 2-layer MLP probe
    level 2: transformer-backbone head    (one trunk shared by every predicate)

Costs are analytic FLOPs divided by the REFERENCE's cost scale
(``REFERENCE_COST_SCALE``, 197e12 FLOP/s): a unit of the cost model that sets
the planner's benefit / cost ranking, not a rate of the card this runs on.
Both probes cost less than the scoring kernels' 1e-9 s cost floor, so
another scale would change plans; keeping the reference's keeps them equal.

``ModelCascadeBank`` stacks the per-(predicate, level) parameters into
``[P]``-leading tensors at construction (the backbone level is ONE shared
trunk with stacked per-predicate heads).  ``execute`` sorts the merged plan's
lanes by (pred, level) key, runs each level as one masked batched forward
over the whole lane vector and scatters back through the inverse
permutation.  The reference skips the trunk inside its trace with
``lax.cond``; eager PyTorch has no device-side branch, so ``execute`` reads
once per epoch on the host whether any lane is at a backbone level
(counted in ``bank_syncs``) — the one host sync in the port's superstep.  The
trunk then runs over all M lanes, as the reference's fixed shape does.

Every forward-only pass (``execute``, ``execute_host``, evaluation) runs the
trunk's sequence mixers through the ``"kernel"`` route: the CUDA
flash-attention kernel for a qwen3 trunk, the CUDA SSD intra-chunk kernel
for a mamba2 one (its final state is never computed: nothing reads it),
both in every layer of a hymba one.  Any of the ten architectures can be
the trunk, as in the reference: a MoE trunk's aux losses are dropped, and
a seamless trunk skips its cross-attention blocks (the trunk passes no
encoder output).
Head training goes through the ``"dense"`` engine with the trunk frozen:
the reference's own route there, since no kernel has a backward.  At any
width the trunk keeps ONE copy of its projection matrices in the activation
dtype (``compute_layers``), bitwise what the reference's per-call casts
give.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.plan import Plan
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

# The reference's cost scale (its chip's peak FLOP/s), used as a unit only.
REFERENCE_COST_SCALE = 197e12

# Cost padding for (pred, level) slots a ragged bank does not have: Eq. 11
# ranks triples by benefit / cost, so a missing level must look prohibitively
# expensive, never free.
SENTINEL_COST_S = 1e9

# The backbone head tiles each projected feature vector into this many token
# positions before the trunk (a "patch sequence" stand-in).
N_BACKBONE_TOKENS = 8


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _linear_probe_init(gen, d, width=0):
    return {"w": _normal(gen, (d, 1), 1 / math.sqrt(d)),
            "b": torch.zeros((1,), device=gen.device)}


def _linear_probe_apply(params, x):
    return torch.sigmoid(x @ params["w"] + params["b"])[:, 0]


def _mlp_probe_init(gen, d, width=256):
    return {
        "w1": _normal(gen, (d, width), 1 / math.sqrt(d)),
        "b1": torch.zeros((width,), device=gen.device),
        "w2": _normal(gen, (width, 1), 1 / math.sqrt(width)),
        "b2": torch.zeros((1,), device=gen.device),
    }


def _mlp_probe_apply(params, x):
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="tanh")  # jax.nn.gelu's default
    return torch.sigmoid(h @ params["w2"] + params["b2"])[:, 0]


@dataclasses.dataclass
class CascadeLevel:
    name: str
    params: object
    apply_fn: Callable  # (params, features [B, D]) -> probs [B]
    flops_per_object: float
    cfg: Optional[ModelConfig] = None  # backbone levels carry their config
    cost_scale: float = REFERENCE_COST_SCALE

    @property
    def cost_seconds(self) -> float:
        return self.flops_per_object / self.cost_scale


def with_compute_copy(trunk: dict, cfg: ModelConfig) -> dict:
    """The trunk plus ``compute_layers``: its stack with the projection
    matrices in the activation dtype (the same tensors when that is f32)."""
    return dict(trunk, compute_layers=tf.cast_matrices(trunk["layers"], cfg.activation_dtype))


def _backbone_apply(cfg: ModelConfig, trunk: dict, head: dict, feats: torch.Tensor):
    """Features -> token patches -> backbone -> mean-pool -> sigmoid head."""
    b = feats.shape[0]
    x = feats @ head["proj"]  # [B, d_model]
    x = x[:, None, :].expand(b, N_BACKBONE_TOKENS, cfg.d_model).to(cfg.activation_dtype)
    pos = torch.arange(N_BACKBONE_TOKENS, device=feats.device)[None].expand(b, N_BACKBONE_TOKENS)
    h, _, _ = tf.stack_apply(trunk["compute_layers"], cfg, x.contiguous(), pos,
                             cfg.num_layers, causal=False)
    pooled = torch.mean(h.float(), dim=1)
    return torch.sigmoid(pooled @ head["out"])[:, 0]


def backbone_level(cfg: ModelConfig, trunk: dict, head: dict) -> CascadeLevel:
    """A backbone tagging level over ``trunk`` (with its ``compute_layers``)
    and a (proj, out) ``head``; its forward runs the ``"kernel"`` route."""
    fwd_cfg = dataclasses.replace(cfg, attn_impl="kernel")

    def apply_fn(p, feats):
        trunk_params, head_params = p
        return _backbone_apply(fwd_cfg, trunk_params, head_params, feats)

    # FLOP-honest cost: 2 * active params per token, N_BACKBONE_TOKENS tokens
    flops = 2.0 * cfg.param_counts()["active"] * N_BACKBONE_TOKENS
    return CascadeLevel(name=f"backbone:{cfg.name}", params=(trunk, head), apply_fn=apply_fn,
                        flops_per_object=flops, cfg=fwd_cfg)


def _backbone_level(gen: torch.Generator, cfg: ModelConfig, feature_dim: int,
                    trunk: Optional[dict] = None) -> CascadeLevel:
    """Transformer-backbone tagging head.  ``trunk`` shares ONE trunk across
    predicates (per-predicate heads only) — the layout the bank requires;
    when omitted a private trunk is initialised."""
    if trunk is None:
        trunk = with_compute_copy(Model(cfg).init_params(gen), cfg)
    head = {
        "proj": _normal(gen, (feature_dim, cfg.d_model), 0.05),
        "out": _normal(gen, (cfg.d_model, 1), 0.05),
    }
    return backbone_level(cfg, trunk, head)


def build_cascade(gen: torch.Generator, feature_dim: int,
                  backbone_cfg: Optional[ModelConfig] = None,
                  backbone_trunk: Optional[dict] = None) -> list:
    levels = [
        CascadeLevel("linear", _linear_probe_init(gen, feature_dim), _linear_probe_apply,
                     2.0 * feature_dim),
        CascadeLevel("mlp", _mlp_probe_init(gen, feature_dim), _mlp_probe_apply,
                     2.0 * feature_dim * 256 * 2),
    ]
    if backbone_cfg is not None:
        levels.append(_backbone_level(gen, backbone_cfg, feature_dim, trunk=backbone_trunk))
    return levels


def build_cascade_suite(gen: torch.Generator, num_preds: int, feature_dim: int,
                        backbone_cfg: Optional[ModelConfig] = None) -> list:
    """One cascade per predicate: private linear / MLP probes, one SHARED
    backbone trunk with per-predicate heads."""
    trunk = None
    if backbone_cfg is not None:
        trunk = with_compute_copy(Model(backbone_cfg).init_params(gen), backbone_cfg)
    return [build_cascade(gen, feature_dim, backbone_cfg=backbone_cfg, backbone_trunk=trunk)
            for _ in range(num_preds)]


def _nll(pr: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pr = torch.clamp(pr, 1e-6, 1 - 1e-6)
    return -torch.mean(y * torch.log(pr) + (1 - y) * torch.log(1 - pr))


def _sgd(params: dict, loss_of, steps: int, lr: float) -> dict:
    """``steps`` of plain gradient descent on every leaf of ``params``."""
    keys = list(params)
    theta = [params[k].detach().clone().requires_grad_(True) for k in keys]
    for _ in range(steps):
        grads = torch.autograd.grad(loss_of(dict(zip(keys, theta))), theta)
        with torch.no_grad():
            theta = [(t - lr * g).requires_grad_(True) for t, g in zip(theta, grads)]
    return {k: t.detach() for k, t in zip(keys, theta)}


def train_level(level: CascadeLevel, feats: torch.Tensor, labels: torch.Tensor,
                steps: int = 200, lr: float = 0.05) -> CascadeLevel:
    """Fit a level to planted labels by NLL descent.  Backbone levels train
    only the (proj, out) head, with the trunk frozen, its attention on the
    dense engine and no remat (the trunk's activations are kept)."""
    y = labels.to(torch.float32)
    if level.name.startswith("backbone"):
        trunk, head = level.params
        train_cfg = dataclasses.replace(level.cfg, attn_impl="dense", remat=False)
        head = _sgd(head, lambda h: _nll(_backbone_apply(train_cfg, trunk, h, feats), y),
                    max(steps // 2, 50), lr)
        return dataclasses.replace(level, params=(trunk, head))
    params = _sgd(level.params, lambda p: _nll(level.apply_fn(p, feats), y), steps, lr)
    return dataclasses.replace(level, params=params)


def map_tree(fn, tree):
    """``fn`` on every tensor leaf of nested dicts / tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def _stack_trees(trees: list) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@dataclasses.dataclass
class ModelCascadeBank:
    """Tagging bank backed by model cascades (one per predicate).

    ``execute`` runs a merged plan as one fixed-shape batched pass per level
    (the session's bank boundary); ``execute_host`` groups the lanes on the
    host and runs one forward per (pred, level) group — the parity oracle.
    """

    cascades: Sequence[Sequence[CascadeLevel]]  # [P][<=F]
    features: torch.Tensor  # [N, D]
    costs: torch.Tensor = None  # [P, F] seconds (filled in __post_init__)
    available: torch.Tensor = None  # [P, F] bool (filled in __post_init__)

    # the session superstep may run this bank's execute (see core.executor)
    supports_scan = True

    def __post_init__(self):
        p = len(self.cascades)
        f = max(len(c) for c in self.cascades)
        # missing levels of a ragged bank: sentinel cost, unavailable —
        # NEVER zero cost (a free level would have infinite benefit/cost)
        costs = np.full((p, f), SENTINEL_COST_S, np.float32)
        avail = np.zeros((p, f), bool)
        for i, c in enumerate(self.cascades):
            for j, lvl in enumerate(c):
                costs[i, j] = lvl.cost_seconds
                avail[i, j] = True
        dev = self.features.device
        self.costs = torch.from_numpy(costs).to(dev)
        self.available = torch.from_numpy(avail).to(dev)
        self.bank_syncs = 0  # host reads of "any backbone lane?" (one per execute)
        self.trunk_runs = 0  # executes that ran the backbone trunk
        self._stack = self._build_stack(p, f)

    @property
    def num_levels(self) -> int:
        return self.costs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def _build_stack(self, p: int, f: int) -> list:
        """Per level: one homogeneous [P]-leading parameter stack.  Predicates
        missing a level get zero placeholders, masked out by ``available``;
        backbone levels must share ONE trunk, only the heads stack."""
        stack = []
        for j in range(f):
            present = {i: c[j] for i, c in enumerate(self.cascades) if len(c) > j}
            template = next(iter(present.values()))
            if template.name.startswith("backbone"):
                trunks = {id(lvl.params[0]) for lvl in present.values()}
                if len(trunks) != 1:
                    raise ValueError(
                        "backbone cascade level requires one shared trunk with "
                        "per-predicate heads (build_cascade_suite); got "
                        f"{len(trunks)} distinct trunks at level {j}"
                    )
                zero_head = {k: torch.zeros_like(t) for k, t in template.params[1].items()}
                heads = [present[i].params[1] if i in present else zero_head for i in range(p)]
                stack.append(dict(kind="backbone", cfg=template.cfg, trunk=template.params[0],
                                  heads=_stack_trees(heads)))
            else:
                fns = {lvl.apply_fn for lvl in present.values()}
                if len(fns) != 1:
                    raise ValueError(
                        f"cascade level {j} mixes apply functions; stacked dispatch "
                        "needs one architecture per level"
                    )
                zero = {k: torch.zeros_like(t) for k, t in template.params.items()}
                params = [present[i].params if i in present else zero for i in range(p)]
                stack.append(dict(kind="probe", apply=template.apply_fn,
                                  params=_stack_trees(params)))
        return stack

    def to(self, device, dtype: Optional[str] = None) -> "ModelCascadeBank":
        """A copy of the bank on ``device`` (the shared trunk stays shared,
        its compute copy is remade there).  ``dtype`` ("float32" /
        "bfloat16") sets the backbone's activation dtype over the same
        weights; None keeps it."""
        trunks = {}

        def move(lvl: CascadeLevel) -> CascadeLevel:
            if not lvl.name.startswith("backbone"):
                return dataclasses.replace(lvl, params=map_tree(lambda t: t.to(device), lvl.params))
            trunk, head = lvl.params
            cfg = lvl.cfg if dtype is None else dataclasses.replace(lvl.cfg, dtype=dtype)
            if id(trunk) not in trunks:
                kept = {k: v for k, v in trunk.items() if k != "compute_layers"}
                trunks[id(trunk)] = with_compute_copy(map_tree(lambda t: t.to(device), kept), cfg)
            moved = backbone_level(cfg, trunks[id(trunk)], map_tree(lambda t: t.to(device), head))
            return dataclasses.replace(lvl, params=moved.params, apply_fn=moved.apply_fn,
                                       cfg=moved.cfg)

        return ModelCascadeBank(cascades=[[move(lvl) for lvl in c] for c in self.cascades],
                                features=self.features.to(device))

    def subset(self, cols) -> "ModelCascadeBank":
        """Bank restricted to a subset of predicate columns (shares cascade
        parameters and features)."""
        return ModelCascadeBank(cascades=[self.cascades[int(c)] for c in cols],
                                features=self.features)

    # ---- execution ----------------------------------------------------------

    def execute(self, plan: Plan) -> torch.Tensor:
        """Every unique (object, pred, level) triple of a merged plan -> [M]
        f32 probabilities; invalid and unmatched lanes return the 0.5 prior,
        lane for lane as ``execute_host``."""
        p_num, f_num = len(self.cascades), self.num_levels
        m = plan.object_idx.shape[0]
        n = self.features.shape[0]
        valid = plan.valid
        zero = torch.zeros((), dtype=torch.int64, device=valid.device)
        obj = torch.where(valid, torch.clamp(plan.object_idx, 0, n - 1), zero)
        prd = torch.where(valid, torch.clamp(plan.pred_idx, 0, p_num - 1), zero)
        fns = torch.where(valid, torch.clamp(plan.func_idx, 0, f_num - 1), zero)

        # stable lane sort by (pred, level); invalid lanes sort past P*F
        key = torch.where(valid, prd * f_num + fns, p_num * f_num)
        order = torch.argsort(key, stable=True)
        inv = torch.argsort(order, stable=True)
        s_obj, s_prd, s_fn, s_valid = obj[order], prd[order], fns[order], valid[order]
        feats = self.features[s_obj].float()  # [M, D]
        lane = torch.arange(m, device=valid.device)

        ons = [s_valid & (s_fn == j) & self.available[s_prd, j] for j in range(len(self._stack))]
        backbone = [j for j, e in enumerate(self._stack) if e["kind"] == "backbone"]
        run = {}
        if backbone:  # the reference's lax.cond, as ONE host read per epoch
            self.bank_syncs += 1
            run = dict(zip(backbone, torch.stack([ons[j].any() for j in backbone]).tolist()))

        out = torch.full((m,), 0.5, dtype=torch.float32, device=valid.device)
        for j, entry in enumerate(self._stack):
            if entry["kind"] == "backbone":
                if not run[j]:
                    continue  # no lane at this level: the trunk is skipped
                self.trunk_runs += 1
                cfg, heads = entry["cfg"], entry["heads"]
                x_all = torch.einsum("md,pdk->pmk", feats, heads["proj"])
                x = x_all[s_prd, lane]  # [M, d_model]
                x = x[:, None, :].expand(m, N_BACKBONE_TOKENS, cfg.d_model)
                x = x.to(cfg.activation_dtype).contiguous()
                pos = torch.arange(N_BACKBONE_TOKENS, device=x.device)[None].expand(
                    m, N_BACKBONE_TOKENS)
                h, _, _ = tf.stack_apply(entry["trunk"]["compute_layers"], cfg, x, pos,
                                         cfg.num_layers, causal=False)
                pooled = torch.mean(h.float(), dim=1)
                logits = torch.einsum("mk,pko->pmo", pooled, heads["out"])
                probs = torch.sigmoid(logits[s_prd, lane, 0])
            else:
                per_pred = torch.func.vmap(entry["apply"], in_dims=(0, None))(
                    entry["params"], feats)  # [P, M]
                probs = per_pred[s_prd, lane]
            out = torch.where(ons[j], probs.float(), out)
        return out[inv]

    def execute_host(self, plan: Plan) -> torch.Tensor:
        """Host dispatch: group triples by (pred, level) on the host and run
        one forward per non-empty group (the parity oracle for ``execute``)."""
        obj = plan.object_idx.cpu().numpy()
        prd = plan.pred_idx.cpu().numpy()
        fns = plan.func_idx.cpu().numpy()
        valid = plan.valid.cpu().numpy()
        out = np.full(obj.shape, 0.5, np.float32)
        for p in range(len(self.cascades)):
            for f in range(len(self.cascades[p])):
                sel = valid & (prd == p) & (fns == f)
                if not sel.any():
                    continue
                lvl = self.cascades[p][f]
                idx = torch.from_numpy(obj[sel]).to(self.device)
                out[sel] = lvl.apply_fn(lvl.params, self.features[idx]).float().cpu().numpy()
        return torch.from_numpy(out).to(self.device)
