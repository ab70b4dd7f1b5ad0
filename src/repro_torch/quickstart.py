"""The quickstart query, corpus and operator at any size.

The setup of the reference's ``examples/quickstart.py``: the query "Gender
== Male AND Expression == Smile" (2 predicates), selectivity 0.4 / 0.35,
and 4 functions with the paper's Table 1 qualities and costs, on a
synthetic corpus made from a seed.  ``chip_smoke.py``, the profiler and the
GPU tests build their operator runs from here.
"""

from __future__ import annotations

import torch

from repro_torch.core.combine import fit_combine_weights
from repro_torch.core.decision_table import learn_decision_table
from repro_torch.core.operator import OperatorConfig, ProgressiveQueryOperator
from repro_torch.core.query import Predicate, conjunction
from repro_torch.data.synthetic import make_corpus, split_corpus, truth_answer_mask
from repro_torch.device import resolve_device
from repro_torch.enrich.simulated import SimulatedBank, preprocess_cheapest
from repro_torch.kernels.enrich_score import ops as es_ops

QUICKSTART_AUCS = (0.61, 0.84, 0.9, 0.95)
QUICKSTART_COSTS = (0.023, 0.114, 0.42, 0.949)


def quickstart_world(num_objects: int, train_size: int = 1024, seed: int = 0,
                     device=None) -> dict:
    """The quickstart corpus on ``device``: combine weights and decision
    table learned on ``train_size`` training rows, the bank over the
    ``num_objects`` evaluation rows, the query and its ground truth."""
    dev = resolve_device(device)
    query = conjunction(Predicate(0, 1), Predicate(1, 2))
    gen = torch.Generator(device=dev).manual_seed(seed)
    corpus = make_corpus(gen, num_objects + train_size, [0, 1], [1, 2],
                         selectivity=[0.4, 0.35], aucs=QUICKSTART_AUCS, costs=QUICKSTART_COSTS)
    train, evalc = split_corpus(corpus, train_size)
    combine = fit_combine_weights(train.func_probs, train.truth_pred.to(torch.float32), steps=150)
    table = learn_decision_table(train.func_probs, combine, num_bins=10)
    return dict(query=query, table=table, combine=combine, costs=evalc.costs,
                bank=SimulatedBank(outputs=evalc.func_probs, costs=evalc.costs),
                truth=truth_answer_mask(evalc, query), num_objects=num_objects)


def quickstart_operator(world: dict, fused: bool, config: OperatorConfig = OperatorConfig(),
                        device=None):
    """The operator over ``world`` on ``device`` (its bank copied there),
    warm-started by the paper's initialization step -> (operator, state).
    ``fused`` scores through ``ops.fused_benefits`` (the legacy per-epoch
    loop); otherwise the default scoring runs through the session facade."""
    dev = resolve_device(device)
    bank = world["bank"].to(dev)
    op = ProgressiveQueryOperator(
        world["query"], world["table"], world["combine"], world["costs"], bank, config,
        truth_mask=world["truth"], benefit_fn=es_ops.fused_benefits if fused else None,
        device=dev,
    )
    pre_p, pre_m, _ = preprocess_cheapest(bank.outputs, bank.costs)
    return op, op.warm_start(op.init_state(world["num_objects"]), pre_p, pre_m)
