"""DART boosting: Dropouts meet Multiple Additive Regression Trees
(reference: src/boosting/dart.hpp).

The port of lightgbm_tpu's ``models/dart.py``. Each iteration

1. selects a drop set of earlier iterations (``skip_drop`` /
   ``drop_rate`` / ``uniform_drop`` / ``max_drop``, dart.hpp:97-148
   DroppingTrees) from ``np.random.RandomState(drop_seed)``, draw for
   draw as the JAX package does;
2. takes the dropped trees' outputs off the training score, so the
   gradients see the thinned ensemble;
3. trains the new trees at ``learning_rate / (1 + k)`` (xgboost mode:
   ``learning_rate / (learning_rate + k)``);
4. normalizes: each dropped tree's values shrink by ``k / (k + 1)``
   (xgboost mode ``k / (k + learning_rate)``), and the score caches get
   the same change (dart.hpp:150-199 Normalize), as one multiply of the
   stored contribution, the JAX package's collapsed form of the
   reference's three shrinkage steps.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .gbdt import GBDT
from .tree import predict_value_bins


class DART(GBDT):
    """reference: dart.hpp:23 ``class DART: public GBDT``."""

    name = "dart"

    def __init__(self, config, train_set=None, objective=None):
        super().__init__(config, train_set, objective)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []   # per iteration (dart.hpp:201)
        self.sum_weight = 0.0
        self.drop_sets: List[List[int]] = []    # each iteration's drop set

    def reset_config(self, config) -> None:
        """GBDT's, then a drop generator started again from ``drop_seed``
        and the weight sum recomputed, as the JAX package does."""
        super().reset_config(config)
        self._drop_rng = np.random.RandomState(config.drop_seed)
        self.sum_weight = sum(self.tree_weight)

    # ------------------------------------------------- checkpoint/resume
    def get_trainer_state(self) -> dict:
        """GBDT's, plus the drop generator's full numpy state, the
        per-iteration tree weights (dart.hpp:201) and the drop sets:
        without them a resume would draw another drop set."""
        state = super().get_trainer_state()
        state["dart"] = {"drop_rng_state": self._drop_rng.get_state(),
                         "tree_weight": list(self.tree_weight),
                         "sum_weight": float(self.sum_weight),
                         "drop_sets": [list(d) for d in self.drop_sets]}
        return state

    def set_trainer_state(self, state: dict) -> None:
        super().set_trainer_state(state)
        d = state["dart"]
        self._drop_rng.set_state(d["drop_rng_state"])
        self.tree_weight = list(d["tree_weight"])
        self.sum_weight = float(d["sum_weight"])
        self.drop_sets = [list(x) for x in d.get("drop_sets", [])]

    def _select_drop_iters(self) -> List[int]:
        """reference: dart.hpp:97-134 DroppingTrees (the selection)."""
        cfg = self.config
        if self._drop_rng.rand() < cfg.skip_drop:
            return []
        drop = []
        if not cfg.uniform_drop and self.sum_weight > 0:
            drop_rate = cfg.drop_rate
            inv_avg = len(self.tree_weight) / self.sum_weight
            if cfg.max_drop > 0:
                drop_rate = min(drop_rate,
                                cfg.max_drop * inv_avg / self.sum_weight)
            for i in range(self.iter):
                if self._drop_rng.rand() < \
                        drop_rate * self.tree_weight[i] * inv_avg:
                    drop.append(i)
                    if len(drop) >= cfg.max_drop > 0:
                        break
        else:
            drop_rate = cfg.drop_rate
            if cfg.max_drop > 0 and self.iter > 0:
                drop_rate = min(drop_rate, cfg.max_drop / float(self.iter))
            for i in range(self.iter):
                if self._drop_rng.rand() < drop_rate:
                    drop.append(i)
                    if len(drop) >= cfg.max_drop > 0:
                        break
        return drop

    def _tree_contribs(self, it: int):
        """Iteration ``it``'s trees' outputs on the train rows and on each
        valid set, by class."""
        k = self.num_tree_per_iteration
        ts = self.train_set
        mb = ts.missing_bin.to(self.device)
        out = []
        for c in range(k):
            tree = self.trees[it * k + c]
            out.append((predict_value_bins(tree, ts.binsT, mb),
                        [predict_value_bins(tree, vs.binsT,
                                            vs.missing_bin.to(vs.device))
                         for vs in self.valid_sets]))
        return out

    def _scale_stored_tree(self, idx: int, factor: float) -> None:
        tree = self.trees[idx]
        self.trees[idx] = tree._replace(
            leaf_value=tree.leaf_value * factor,
            node_value=tree.node_value * factor,
            shrinkage=tree.shrinkage * factor)
        self.host_trees[idx] = self.host_trees[idx].scaled(factor)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        cfg = self.config
        k_cls = self.num_tree_per_iteration
        drop = self._select_drop_iters()
        self.drop_sets.append(drop)
        k = float(len(drop))
        # take the dropped trees' outputs off the train score
        contribs = {}
        for it in drop:
            contribs[it] = self._tree_contribs(it)
            for c in range(k_cls):
                self.train_score = self._class_add(
                    self.train_score, c, -contribs[it][c][0])
        # the new trees' shrinkage (dart.hpp:136-147)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        else:
            self.shrinkage_rate = cfg.learning_rate if not drop else \
                cfg.learning_rate / (cfg.learning_rate + k)
        if super().train_one_iter(grad, hess):
            # no split: put the dropped outputs back; the splitless trees
            # are stored and the weights kept in step with them
            for it in drop:
                for c in range(k_cls):
                    self.train_score = self._class_add(
                        self.train_score, c, contribs[it][c][0])
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
            return True
        # normalize (dart.hpp:150-199)
        factor = (k / (k + 1.0)) if not cfg.xgboost_dart_mode else \
            (k / (k + cfg.learning_rate))
        for it in drop:
            for c in range(k_cls):
                delta, vdeltas = contribs[it][c]
                self.train_score = self._class_add(self.train_score, c,
                                                   factor * delta)
                for i, vd in enumerate(vdeltas):
                    self._valid_scores[i] = self._class_add(
                        self._valid_scores[i], c, (factor - 1.0) * vd)
                self._scale_stored_tree(it * k_cls + c, factor)
            self.sum_weight -= self.tree_weight[it] * (1.0 - factor)
            self.tree_weight[it] *= factor
        self.tree_weight.append(self.shrinkage_rate)
        self.sum_weight += self.shrinkage_rate
        return False
