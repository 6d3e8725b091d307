"""Booster: the user-facing handle of a trained or loaded model.

The port of lightgbm_tpu's ``booster.py`` for the slice: training updates,
evaluation, prediction (raw and converted) and model text. A Booster is
built from a training Dataset, from a model file or string, or from trees
carried across as numpy arrays (``convert.booster_from_numpy``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .basic import Dataset
from .config import Config
from .models.gbdt import GBDT


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        self.best_iteration = -1
        self._train_set = train_set
        if model_file is not None or model_str is not None:
            from .io.model_text import load_model
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._boosting = load_model(model_str, self.config)
        elif train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            merged = dict(train_set.params or {})
            merged.update(self.params)
            train_set.params = merged
            self._boosting = GBDT(self.config, train_set)
        else:
            raise ValueError("need at least one of train_set, model_file or "
                             "model_str")

    # ------------------------------------------------------------ training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._boosting.add_valid(data, name)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when it added no split."""
        return self._boosting.train_one_iter()

    def current_iteration(self) -> int:
        return self._boosting.current_iteration()

    def num_trees(self) -> int:
        return self._boosting.num_trees

    @property
    def rows_streamed_per_tree(self) -> float:
        """Rows the histogram passes read per tree (the compaction ladder's
        effect; the full pass reads N rows)."""
        return self._boosting.rows_streamed_per_tree

    # ---------------------------------------------------------------- eval
    def eval_set(self):
        return self._boosting.eval_set()

    def eval_train(self):
        old = self.config.is_provide_training_metric
        self.config.is_provide_training_metric = True
        try:
            return [r for r in self._boosting.eval_set()
                    if r[0] == "training"]
        finally:
            self.config.is_provide_training_metric = old

    def eval_valid(self):
        return [r for r in self._boosting.eval_set() if r[0] != "training"]

    # ------------------------------------------------------------- predict
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        return self._boosting.predict(data, raw_score=raw_score,
                                      num_iteration=num_iteration,
                                      start_iteration=start_iteration)

    # ------------------------------------------------------------ model IO
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .io.model_text import dump_model_text
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        return dump_model_text(self._boosting, num_iteration, start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        text = self.model_to_string(num_iteration, start_iteration)
        with open(filename, "w") as fh:
            fh.write(text)
        return self

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        imp = self._boosting.feature_importance(importance_type)
        return imp.astype(np.int32) if importance_type == "split" else imp
