"""Random Forest mode (reference: src/boosting/rf.hpp).

The port of lightgbm_tpu's ``models/rf.py``. Against GBDT:

- no shrinkage (rf.hpp:48);
- the gradients are computed once, from the constant boost-from-average
  score (rf.hpp:85-104);
- bagging is required (rf.hpp:35);
- each tree carries its class's init score as a bias (rf.hpp:135), and
  the score caches hold the running mean of the tree outputs
  (rf.hpp:139-141): ``(score * m + tree) / (m + 1)``;
- prediction averages the tree outputs (``average_output``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import log
from .gbdt import GBDT
from .tree import TreeArrays, predict_value_bins


class RF(GBDT):
    """reference: rf.hpp:25 ``class RF : public GBDT``."""

    name = "rf"
    average_output = True

    def __init__(self, config, train_set=None, objective=None):
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            log.fatal("RF mode requires bagging "
                      "(bagging_freq > 0 and 0 < bagging_fraction < 1)")
        if not (0.0 < config.feature_fraction <= 1.0):
            log.fatal("RF mode requires 0 < feature_fraction <= 1")
        super().__init__(config, train_set, objective)

    def _init_train(self, train_set) -> None:
        if train_set.init_score is not None:
            log.fatal("Cannot use init_score in RF mode")
        super()._init_train(train_set)
        if self.objective is None:
            log.fatal("RF mode does not support custom objective functions")
        self.shrinkage_rate = 1.0
        # the caches start at zero: the init score lives in the trees
        self.train_score = torch.zeros_like(self.train_score)
        self._const_score = self._score_cache(self._n_score_rows)
        self._fixed_grad, self._fixed_hess = \
            self.objective.get_grad_hess(self._const_score)

    def reset_config(self, config) -> None:
        super().reset_config(config)
        self.shrinkage_rate = 1.0

    def add_valid(self, valid_set, name: str) -> None:
        """A valid set's cache: the mean of the trees so far (rf.hpp
        AddValidDataset), zero before the first."""
        super().add_valid(valid_set, name)
        acc = torch.zeros_like(self._valid_scores[-1])
        k = self.num_tree_per_iteration
        mb = valid_set.missing_bin.to(valid_set.device)
        for i, tree in enumerate(self.trees):
            acc = self._class_add(acc, i % k, predict_value_bins(
                tree, valid_set.binsT, mb))
        self._valid_scores[-1] = acc / float(self.iter) if self.iter else acc

    def _gradients(self):
        return self._fixed_grad, self._fixed_hess

    def _renew_score(self, class_idx: int) -> np.ndarray:
        s = (self._const_score if self.num_tree_per_iteration == 1
             else self._const_score[:, class_idx])
        return s.cpu().numpy().astype(np.float64)

    def _finalize_tree(self, tree: TreeArrays, leaf_id, class_idx: int
                       ) -> Tuple[TreeArrays, bool]:
        """GBDT's renewal (no shrinkage), then the class's init score as
        the tree's bias, before the running mean takes it in
        (rf.hpp:131-137; a splitless tree becomes the constant tree)."""
        tree, had_split = super()._finalize_tree(tree, leaf_id, class_idx)
        bias = self.init_scores[class_idx]
        if abs(bias) > 1e-15:
            if had_split:
                tree = tree._replace(leaf_value=tree.leaf_value + bias,
                                     node_value=tree.node_value + bias)
            else:
                lv = tree.leaf_value.clone()
                lv[0] = bias
                tree = tree._replace(leaf_value=lv)
        return tree, had_split

    def _bias_after_score(self, class_idx: int, had_split: bool) -> None:
        """The bias went in with the tree (_finalize_tree)."""
        self.tree_bias.append(0.0)

    def _mean_add(self, score: torch.Tensor, class_idx: int,
                  delta: torch.Tensor, m: float) -> torch.Tensor:
        """``(score * m + delta) / (m + 1)`` in class ``class_idx``'s
        column."""
        if self.num_tree_per_iteration == 1:
            return (score * m + delta) / (m + 1.0)
        score = score.clone()
        score[:, class_idx] = (score[:, class_idx] * m + delta) / (m + 1.0)
        return score

    def _add_tree(self, tree: TreeArrays, leaf_id, class_idx: int,
                  linear=None) -> None:
        """Running-mean score update (rf.hpp:139-141); ``linear`` is always
        None (RF refuses linear trees)."""
        m = float(self.iter)
        delta = tree.leaf_value.to(self.device)[leaf_id.long()]
        self.train_score = self._mean_add(self.train_score, class_idx,
                                          delta, m)
        for i, vs in enumerate(self.valid_sets):
            vdelta = predict_value_bins(tree, vs.binsT,
                                        vs.missing_bin.to(vs.device))
            self._valid_scores[i] = self._mean_add(self._valid_scores[i],
                                                   class_idx, vdelta, m)
        self.trees.append(tree)
        self.host_trees.append(self._make_host_tree(tree))

    def rollback_one_iter(self) -> None:
        """The running mean without the last iteration's trees (reference:
        rf.hpp:168-184 RollbackOneIter): ``(score * m - tree) / (m - 1)``,
        zero when m == 1."""
        if self.iter <= 0:
            return
        m = float(self.iter)
        k = self.num_tree_per_iteration
        ts = self.train_set
        for c in range(k):
            tree = self.trees.pop()
            self.host_trees.pop()
            if self.tree_bias:
                self.tree_bias.pop()
            class_idx = k - 1 - c
            self.train_score = self._mean_drop(
                self.train_score, class_idx,
                predict_value_bins(tree, ts.binsT,
                                   ts.missing_bin.to(self.device)), m)
            for i, vs in enumerate(self.valid_sets):
                self._valid_scores[i] = self._mean_drop(
                    self._valid_scores[i], class_idx,
                    predict_value_bins(tree, vs.binsT,
                                       vs.missing_bin.to(vs.device)), m)
        self.iter -= 1

    def _mean_drop(self, score: torch.Tensor, class_idx: int,
                   delta: torch.Tensor, m: float) -> torch.Tensor:
        """``(score * m - delta) / (m - 1)`` in class ``class_idx``'s
        column; all of the score zero when m == 1."""
        if m <= 1:
            return torch.zeros_like(score)
        if self.num_tree_per_iteration == 1:
            return (score * m - delta) / (m - 1.0)
        score = score.clone()
        score[:, class_idx] = (score[:, class_idx] * m - delta) / (m - 1.0)
        return score
