"""PIQUE core in PyTorch: the session main path (port of ``repro.core``)."""

from repro_torch.core.combine import (
    CombineParams,
    combine_probabilities,
    default_combine_params,
    fit_combine_weights,
)
from repro_torch.core.decision_table import (
    DecisionTable,
    fallback_decision_table,
    learn_decision_table,
)
from repro_torch.core.executor import EngineConfig, EpochProgram, SessionState
from repro_torch.core.query import Predicate, compile_query, conjunction
from repro_torch.core.session import EngineSession

__all__ = [
    "CombineParams",
    "DecisionTable",
    "EngineConfig",
    "EngineSession",
    "EpochProgram",
    "Predicate",
    "SessionState",
    "combine_probabilities",
    "compile_query",
    "conjunction",
    "default_combine_params",
    "fallback_decision_table",
    "fit_combine_weights",
    "learn_decision_table",
]
