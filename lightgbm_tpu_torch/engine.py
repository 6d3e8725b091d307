"""Training entry point: ``train()``.

The port of lightgbm_tpu's ``engine.train`` for the slice: parameter
munging, validation sets (with their query groups and init scores) and the
evaluation record (``ndcg@k`` / ``map@k`` one entry a position); the
Booster takes the boosting type ``boosting`` names
(``models/boosting.create_boosting``). Callbacks, early stopping,
``init_model``, custom objectives and ``cv`` wait for ROADMAP.md Queue 1
item 12.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from .basic import Dataset
from .booster import Booster
from .config import PARAM_ALIASES


def _resolve_num_boost_round(params: Dict[str, Any],
                             num_boost_round: int) -> int:
    for alias, canonical in PARAM_ALIASES.items():
        if canonical == "num_iterations" and alias in params:
            return int(params.pop(alias))
    return int(params.pop("num_iterations", num_boost_round))


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          evals_result: Optional[dict] = None,
          categorical_feature="auto") -> Booster:
    """Train a booster (reference: python-package engine.py:14-278).
    ``evals_result`` collects ``{valid_name: {metric: [value per
    iteration]}}``; ``categorical_feature`` (indices or names), when not
    "auto", replaces the training Dataset's before it is constructed."""
    params = copy.deepcopy(params)
    if categorical_feature != "auto":
        train_set.categorical_feature = categorical_feature
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if not train_set._constructed:
        merged = dict(train_set.params or {})
        merged.update(params)
        train_set.params = merged
        train_set.construct()
    booster = Booster(params=params, train_set=train_set)
    valid_sets = valid_sets or []
    valid_names = valid_names or []
    for i, vs in enumerate(valid_sets):
        if vs is train_set:
            booster._boosting.config.is_provide_training_metric = True
            continue
        if vs.reference is None:
            vs.reference = train_set
        booster.add_valid(vs, valid_names[i] if i < len(valid_names)
                          else f"valid_{i}")
    for _ in range(num_boost_round):
        booster.update()
        if evals_result is not None and (
                valid_sets or booster._boosting.config
                .is_provide_training_metric):
            for ds_name, metric, value, _ in booster.eval_set():
                evals_result.setdefault(ds_name, {}).setdefault(
                    metric, []).append(value)
    return booster
