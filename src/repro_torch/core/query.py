"""Query model: SPJ predicates over tag types, compiled to tensor evaluators.

Port of ``repro.core.query``.  A query is a boolean combination (AND / OR /
NOT) of predicates ``Value(T_i) == t_j`` / ``!=`` with the paper's
probabilistic semantics (independent across tag types, mutually exclusive
within one, ``!=`` as complement).  ``compile_query`` lowers the AST to a
closure mapping a ``[..., P]`` tensor of predicate probabilities to joint
probabilities ``[...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

EQ = "=="
NEQ = "!="


@dataclasses.dataclass(frozen=True)
class Predicate:
    """``Value(tag_type) op tag`` (paper section 2, "Query")."""

    tag_type: int
    tag: int
    op: str = EQ

    def __post_init__(self):
        if self.op not in (EQ, NEQ):
            raise ValueError(f"bad predicate op: {self.op}")

    def positive(self) -> "Predicate":
        return Predicate(self.tag_type, self.tag, EQ)


@dataclasses.dataclass(frozen=True)
class And:
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class Or:
    children: tuple

    def __init__(self, *children):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class Not:
    child: object


Node = object  # Predicate | And | Or | Not


def _collect_predicates(node: Node, acc: list) -> None:
    if isinstance(node, Predicate):
        pos = node.positive()
        if pos not in acc:
            acc.append(pos)
    elif isinstance(node, (And, Or)):
        for c in node.children:
            _collect_predicates(c, acc)
    elif isinstance(node, Not):
        _collect_predicates(node.child, acc)
    else:
        raise TypeError(f"bad query node: {node!r}")


def _mutually_exclusive(a: Node, b: Node) -> bool:
    """True when a and b are single predicates on the same tag type w/ different tags."""
    return (
        isinstance(a, Predicate)
        and isinstance(b, Predicate)
        and a.op == EQ
        and b.op == EQ
        and a.tag_type == b.tag_type
        and a.tag != b.tag
    )


def _any_exclusive(children: Sequence[Node]) -> bool:
    return any(
        _mutually_exclusive(children[i], children[j])
        for i in range(len(children))
        for j in range(i + 1, len(children))
    )


def _all_pairwise_exclusive(children: Sequence[Node]) -> bool:
    if len(children) < 2:
        return False
    return all(
        _mutually_exclusive(children[i], children[j])
        for i in range(len(children))
        for j in range(i + 1, len(children))
    )


@dataclasses.dataclass(frozen=True)
class CompiledQuery:
    """A query lowered to evaluators over predicate-probability tensors."""

    ast: Node
    predicates: tuple  # tuple[Predicate]: distinct positive predicates, index order
    is_conjunctive: bool
    evaluate: Callable[[torch.Tensor], torch.Tensor]  # [..., P] -> [...]

    @property
    def num_predicates(self) -> int:
        return len(self.predicates)

    def evaluate_with_column(
        self, pred_probs: torch.Tensor, col: int, new_col: torch.Tensor
    ) -> torch.Tensor:
        """Joint probability with predicate column ``col`` replaced by ``new_col``."""
        sub = pred_probs.clone()
        sub[..., col] = new_col
        return self.evaluate(sub)

    def conjunctive_update(
        self, joint: torch.Tensor, old_col: torch.Tensor, new_col: torch.Tensor
    ) -> torch.Tensor:
        """O(1) joint update for pure conjunctions: joint / old * new (guarded)."""
        return conjunctive_joint_update(joint, old_col, new_col)


def conjunctive_joint_update(
    joint: torch.Tensor, old_col: torch.Tensor, new_col: torch.Tensor
) -> torch.Tensor:
    """O(1) conjunctive joint update: joint / old * new (guarded at old == 0)."""
    safe = torch.clamp_min(old_col, 1e-12)
    return torch.where(old_col > 0, joint / safe * new_col, 0.0)


def compile_query(ast: Node) -> CompiledQuery:
    preds: list = []
    _collect_predicates(ast, preds)
    index = {p: i for i, p in enumerate(preds)}

    def build(node: Node) -> Callable[[torch.Tensor], torch.Tensor]:
        if isinstance(node, Predicate):
            i = index[node.positive()]
            if node.op == EQ:
                return lambda pp: pp[..., i]
            return lambda pp: 1.0 - pp[..., i]
        if isinstance(node, Not):
            f = build(node.child)
            return lambda pp: 1.0 - f(pp)
        if isinstance(node, And):
            fns = [build(c) for c in node.children]
            if _any_exclusive(node.children):
                # Mutually-exclusive conjuncts can never both hold.
                return lambda pp: torch.zeros_like(fns[0](pp))

            def f_and(pp):
                out = fns[0](pp)
                for g in fns[1:]:
                    out = out * g(pp)
                return out

            return f_and
        if isinstance(node, Or):
            fns = [build(c) for c in node.children]

            def f_or_excl(pp):
                out = fns[0](pp)
                for g in fns[1:]:
                    out = out + g(pp)
                return torch.clamp(out, 0.0, 1.0)

            def f_or_indep(pp):
                out = fns[0](pp)
                for g in fns[1:]:
                    q = g(pp)
                    out = out + q - out * q
                return out

            return f_or_excl if _all_pairwise_exclusive(node.children) else f_or_indep
        raise TypeError(f"bad query node: {node!r}")

    return CompiledQuery(
        ast=ast,
        predicates=tuple(preds),
        is_conjunctive=_is_pure_conjunction(ast),
        evaluate=build(ast),
    )


def _is_pure_conjunction(node: Node) -> bool:
    """AND of positive predicates over distinct tag types (paper queries Q1-Q5)."""
    if isinstance(node, Predicate):
        return node.op == EQ
    if isinstance(node, And):
        if not all(isinstance(c, Predicate) and c.op == EQ for c in node.children):
            return False
        types = [c.tag_type for c in node.children]
        return len(types) == len(set(types))
    return False


def conjunction(*predicates: Predicate) -> CompiledQuery:
    """Convenience constructor for the paper's experimental queries (Q1-Q5)."""
    if len(predicates) == 1:
        return compile_query(predicates[0])
    return compile_query(And(*predicates))


def global_predicate_space(queries: Sequence[CompiledQuery]) -> tuple:
    """Union of distinct positive predicates across queries, first-seen order."""
    out: list = []
    for q in queries:
        for p in q.predicates:
            if p not in out:
                out.append(p)
    return tuple(out)


def reindex_query(
    query: CompiledQuery, global_predicates: Sequence[Predicate]
) -> CompiledQuery:
    """Re-home a compiled query onto a global predicate space.

    The returned query evaluates over ``[..., P_global]`` tensors by
    gathering its own columns first; every predicate of ``query`` must
    appear in ``global_predicates``.
    """
    index = {p: i for i, p in enumerate(global_predicates)}
    cols = []
    for p in query.predicates:
        if p not in index:
            raise ValueError(f"query predicate {p} missing from global space")
        cols.append(index[p])
    inner = query.evaluate

    def evaluate_global(pred_probs: torch.Tensor) -> torch.Tensor:
        return inner(pred_probs[..., cols])

    return CompiledQuery(
        ast=query.ast,
        predicates=tuple(global_predicates),
        is_conjunctive=query.is_conjunctive,
        evaluate=evaluate_global,
    )
