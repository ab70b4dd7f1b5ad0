"""Carry parameters and session state between numpy and the port's types.

The reference's pytrees come out of ``jax.device_get`` as numpy leaves (or
hold arrays that ``numpy.array`` converts); this module turns such trees —
dicts of numpy arrays, or objects with the same attribute names — into the
port's ``CombineParams``, ``DecisionTable``, ``SessionState``,
``EnrichmentState``, ``MultiQueryState``, ``SimulatedBank``, model
parameters (the ``[G]``-stacked ``layers`` of ``stack_init`` with every leaf
the model zoo adds — ``moe``, ``cross`` / ``ln_cross``, ``enc_layers`` /
``enc_ln``, ``unembed``, ``img_proj`` — probes, backbone heads) and whole
``ModelCascadeBank``s over any of the ten trunks, and the optimisers' states
(``AdamWState``, ``AdafactorState``: a JAX train checkpoint's ``opt_state``),
and back into nested dicts of numpy arrays.  It imports neither JAX nor the
reference package: bf16 leaves travel as their raw 16-bit patterns
(``ml_dtypes.bfloat16`` numpy arrays on the numpy side).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.combine import CombineParams
from repro_torch.core.decision_table import DecisionTable
from repro_torch.core.executor import SessionDerived, SessionState
from repro_torch.core.ledger import CostLedger
from repro_torch.core.multi_query import MultiQueryState
from repro_torch.core.state import EnrichmentState, PerQueryState, SharedSubstrate
from repro_torch.enrich import cascade as cascade_lib
from repro_torch.enrich.simulated import SimulatedBank
from repro_torch.models.config import EncoderConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState


def _field(obj, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def to_torch(x, device=None) -> torch.Tensor:
    """numpy (f32/int/bool, or ml_dtypes bf16) -> tensor, dtype preserved."""
    a = np.array(x, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy, dtype preserved (bf16 needs ``ml_dtypes``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def combine_params_from_numpy(obj, device=None) -> CombineParams:
    return CombineParams(
        *(to_torch(_field(obj, k), device).to(torch.float32) for k in ("weights", "bias", "rho"))
    )


def combine_params_to_numpy(params: CombineParams) -> dict:
    return {k: to_numpy(getattr(params, k)) for k in ("weights", "bias", "rho")}


def decision_table_from_numpy(obj, device=None) -> DecisionTable:
    dha = _field(obj, "delta_h_all")
    return DecisionTable(
        next_fn=to_torch(_field(obj, "next_fn"), device).to(torch.int32),
        delta_h=to_torch(_field(obj, "delta_h"), device).to(torch.float32),
        delta_h_all=None if dha is None else to_torch(dha, device).to(torch.float32),
        num_bins=int(_field(obj, "num_bins")),
    )


def decision_table_to_numpy(table: DecisionTable) -> dict:
    return {
        "next_fn": to_numpy(table.next_fn),
        "delta_h": to_numpy(table.delta_h),
        "delta_h_all": None if table.delta_h_all is None else to_numpy(table.delta_h_all),
        "num_bins": table.num_bins,
    }


_SUBSTRATE = ("func_probs", "exec_mask", "cost_spent")
_DERIVED = ("pred_prob", "uncertainty", "joint_prob", "in_answer")
_LEDGER = ("attributed", "triples", "wanted", "unattributed", "archived")
_STATE = ("bank_outputs", "pred_mask", "active", "num_rows")


def session_state_from_numpy(tree, device=None) -> SessionState:
    """A numpy ``SessionState`` tree -> the port's ``SessionState`` on ``device``."""

    def group(obj, names):
        return {k: to_torch(_field(obj, k), device) for k in names}

    quarantined = _field(tree, "quarantined")
    return SessionState(
        substrate=SharedSubstrate(**group(_field(tree, "substrate"), _SUBSTRATE)),
        derived=SessionDerived(**group(_field(tree, "derived"), _DERIVED)),
        ledger=CostLedger(**group(_field(tree, "ledger"), _LEDGER)),
        quarantined=None if quarantined is None else to_torch(quarantined, device),
        **group(tree, _STATE),
    )


def session_state_to_numpy(state: SessionState) -> dict:
    """The port's ``SessionState`` -> nested dict of numpy arrays."""

    def group(obj, names):
        return {k: to_numpy(getattr(obj, k)) for k in names}

    return {
        "substrate": group(state.substrate, _SUBSTRATE),
        "derived": group(state.derived, _DERIVED),
        "ledger": group(state.ledger, _LEDGER),
        "quarantined": None if state.quarantined is None else to_numpy(state.quarantined),
        **group(state, _STATE),
    }


_ENRICHMENT = _SUBSTRATE[:2] + _DERIVED + _SUBSTRATE[2:]


def enrichment_state_from_numpy(tree, device=None) -> EnrichmentState:
    """A numpy ``EnrichmentState`` tree -> the port's, on ``device``."""
    return EnrichmentState(**{k: to_torch(_field(tree, k), device) for k in _ENRICHMENT})


def enrichment_state_to_numpy(state: EnrichmentState) -> dict:
    return {k: to_numpy(getattr(state, k)) for k in _ENRICHMENT}


def multi_query_state_from_numpy(tree, device=None) -> MultiQueryState:
    """A numpy ``MultiQueryState`` tree (substrate + per_query) -> the port's."""
    sub, per = _field(tree, "substrate"), _field(tree, "per_query")
    return MultiQueryState(
        substrate=SharedSubstrate(**{k: to_torch(_field(sub, k), device) for k in _SUBSTRATE}),
        per_query=PerQueryState(**{k: to_torch(_field(per, k), device) for k in _DERIVED}),
    )


def multi_query_state_to_numpy(state: MultiQueryState) -> dict:
    return {
        "substrate": {k: to_numpy(getattr(state.substrate, k)) for k in _SUBSTRATE},
        "per_query": {k: to_numpy(getattr(state.per_query, k)) for k in _DERIVED},
    }


def simulated_bank_from_numpy(obj, device=None) -> SimulatedBank:
    """Anything with ``outputs`` [N, P, F] and ``costs`` [P, F] -> a bank."""
    return SimulatedBank(outputs=to_torch(_field(obj, "outputs"), device),
                         costs=to_torch(_field(obj, "costs"), device).to(torch.float32))


def simulated_bank_to_numpy(bank: SimulatedBank) -> dict:
    return {"outputs": to_numpy(bank.outputs), "costs": to_numpy(bank.costs)}


# ------------------------------------------------------- model parameters --


def tree_from_numpy(tree, device=None):
    """Nested dicts / tuples of arrays -> the same nesting of tensors (tuples
    stay tuples: the period-grouped ``layers`` stack is a tuple of dicts)."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_from_numpy(v, device) for v in tree)
    return to_torch(tree, device)


def params_from_numpy(tree, mesh=None, rules=None, axes=None, device=None):
    """The reference's model parameters as numpy -> the port's tree on
    ``device``; with a ``mesh`` (and the ``rules`` and logical ``axes`` of
    the tree: ``Model.param_axes()``) DTensors in the placements the rules
    give each leaf's axes, every rank passing the same arrays."""
    params = tree_from_numpy(tree, device)
    if mesh is None:
        return params
    if rules is None or axes is None:
        raise ValueError("params_from_numpy over a mesh needs the rules and the axes tree")
    from repro_torch.launch.steps import distribute_params

    return distribute_params(params, axes, rules, mesh)


def tree_to_numpy(tree):
    return cascade_lib.map_tree(to_numpy, tree)


_NESTED_CONFIGS = {"moe": MoEConfig, "ssm": SSMConfig, "encoder": EncoderConfig}


def _config_of(cls, obj):
    """An object with ``cls``'s field names -> a ``cls`` of plain values."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def model_config_from(obj) -> ModelConfig:
    """Any object with ``ModelConfig``'s field names (the reference's config
    is one) -> the port's ``ModelConfig``; the nested ``moe`` / ``ssm`` /
    ``encoder`` configs are rebuilt as the port's dataclasses."""
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(ModelConfig)}
    for name, cls in _NESTED_CONFIGS.items():
        if fields[name] is not None:
            fields[name] = _config_of(cls, fields[name])
    return ModelConfig(**fields)


_PROBES = {"linear": cascade_lib._linear_probe_apply, "mlp": cascade_lib._mlp_probe_apply}


def cascade_bank_from_numpy(cascades, features, device=None) -> cascade_lib.ModelCascadeBank:
    """Levels with the reference's ``CascadeLevel`` attributes (``name``,
    ``params``, ``flops_per_object``, ``cfg``), one list per predicate, and
    the [N, D] features -> the port's bank.  A trunk shared by several levels
    (one object) stays one trunk."""
    trunks = {}

    def level(lvl) -> cascade_lib.CascadeLevel:
        if lvl.name in _PROBES:
            return cascade_lib.CascadeLevel(
                lvl.name, tree_from_numpy(lvl.params, device), _PROBES[lvl.name],
                float(lvl.flops_per_object))
        trunk_np, head_np = lvl.params
        cfg = model_config_from(lvl.cfg)
        if id(trunk_np) not in trunks:
            trunks[id(trunk_np)] = cascade_lib.with_compute_copy(
                tree_from_numpy(trunk_np, device), cfg)
        out = cascade_lib.backbone_level(cfg, trunks[id(trunk_np)], tree_from_numpy(head_np, device))
        if out.flops_per_object != float(lvl.flops_per_object):
            raise ValueError(f"{lvl.name}: cost {lvl.flops_per_object} != {out.flops_per_object}")
        return out

    return cascade_lib.ModelCascadeBank(
        cascades=[[level(lvl) for lvl in casc] for casc in cascades],
        features=to_torch(features, device).to(torch.float32),
    )


# ------------------------------------------------------ optimiser states --

_OPT_STATES = {AdamWState: ("mu", "nu"), AdafactorState: ("v_row", "v_col", "v_full")}


def opt_state_from_numpy(cls, obj, device=None):
    """A numpy optimiser state (the reference's ``AdamWState`` /
    ``AdafactorState`` after ``jax.device_get``, or a dict with its field
    names) -> the port's ``cls`` on ``device``."""
    return cls(step=to_torch(_field(obj, "step"), device),
               **{k: tree_from_numpy(_field(obj, k), device) for k in _OPT_STATES[cls]})


def opt_state_to_numpy(state) -> dict:
    """The port's ``AdamWState`` / ``AdafactorState`` -> a dict of numpy trees
    keyed by its field names."""
    return {"step": to_numpy(state.step),
            **{k: tree_to_numpy(getattr(state, k)) for k in _OPT_STATES[type(state)]}}
