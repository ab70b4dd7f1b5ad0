"""PIQUE core in PyTorch (port of ``repro.core``): the session main path,
the paper's single-query operator and the multi-query facade."""

from repro_torch.core.baselines import StaticOrderEvaluator
from repro_torch.core.benefit import compute_benefits
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
from repro_torch.core.multi_query import (
    MultiEpochStats,
    MultiQueryConfig,
    MultiQueryEngine,
    MultiQueryState,
    QuerySet,
    build_query_set,
)
from repro_torch.core.operator import EpochStats, OperatorConfig, ProgressiveQueryOperator
from repro_torch.core.plan import Plan, merge_plans_dedup, select_plan
from repro_torch.core.query import (
    And,
    Not,
    Or,
    Predicate,
    compile_query,
    conjunction,
    global_predicate_space,
    reindex_query,
)
from repro_torch.core.session import EngineSession, SessionPipeline
from repro_torch.core.state import (
    EnrichmentState,
    PerQueryState,
    SharedSubstrate,
    init_state,
    init_substrate,
    refresh_derived,
)
from repro_torch.core.threshold import select_answer, select_answer_approx
from repro_torch.core.durability import (
    SessionCheckpointer,
    restore_session_checkpoint,
    save_session_checkpoint,
    session_state_spec,
    shard_session_state,
)

__all__ = [
    "And", "Not", "Or", "Predicate", "compile_query", "conjunction",
    "global_predicate_space", "reindex_query",
    "EnrichmentState", "PerQueryState", "SharedSubstrate",
    "init_state", "init_substrate", "refresh_derived",
    "CombineParams", "combine_probabilities", "default_combine_params", "fit_combine_weights",
    "DecisionTable", "fallback_decision_table", "learn_decision_table",
    "select_answer", "select_answer_approx", "compute_benefits",
    "Plan", "select_plan", "merge_plans_dedup",
    "OperatorConfig", "EpochStats", "ProgressiveQueryOperator",
    "EngineConfig", "EpochProgram", "SessionState", "EngineSession", "SessionPipeline",
    "SessionCheckpointer", "save_session_checkpoint", "restore_session_checkpoint",
    "session_state_spec", "shard_session_state",
    "MultiQueryEngine", "MultiQueryConfig", "MultiQueryState", "MultiEpochStats",
    "QuerySet", "build_query_set",
    "StaticOrderEvaluator",
]
