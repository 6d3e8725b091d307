"""Evaluation metrics, on the host in float64.

The port of lightgbm_tpu's ``metrics.py`` for the slice: l2, rmse,
binary_logloss and auc (reference: src/metric/regression_metric.hpp,
src/metric/binary_metric.hpp). Metrics take RAW scores and apply the
objective's output conversion where the reference does; everything runs in
numpy float64 (the JAX package converts binary scores in float32 first, so
its logloss agrees to float32 rounding).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Metric:
    name = "base"
    bigger_is_better = False

    def __init__(self, config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray]) -> None:
        self.label = np.asarray(label, dtype=np.float64)
        self.weight = (np.asarray(weight, dtype=np.float64)
                       if weight is not None else None)
        self.sum_weight = (float(np.sum(self.weight)) if self.weight is not None
                           else float(len(self.label)))

    def _wavg(self, values: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(values * self.weight) / self.sum_weight)
        return float(np.mean(values))

    def _convert(self, score: np.ndarray, objective) -> np.ndarray:
        score = np.asarray(score, dtype=np.float64)
        return objective.convert_output(score) if objective is not None \
            else score

    def eval(self, score: np.ndarray, objective=None) -> float:
        raise NotImplementedError


class L2Metric(Metric):
    """reference: regression_metric.hpp L2Metric (mean squared loss)."""
    name = "l2"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        return self._wavg((score - self.label) ** 2)


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, score, objective=None):
        return float(np.sqrt(super().eval(score, objective)))


class BinaryLoglossMetric(Metric):
    """reference: binary_metric.hpp BinaryLoglossMetric."""
    name = "binary_logloss"

    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        eps = 1e-15
        prob = np.clip(prob, eps, 1.0 - eps)
        y = (self.label > 0).astype(np.float64)
        return self._wavg(-(y * np.log(prob) + (1 - y) * np.log(1 - prob)))


class AUCMetric(Metric):
    """Weighted AUC by a descending-score sweep with tied scores grouped
    (reference: binary_metric.hpp:159-268 AUCMetric)."""
    name = "auc"
    bigger_is_better = True

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-score, kind="stable")
        ys, ws, ss = y[order], w[order], score[order]
        boundary = np.concatenate([[True], ss[1:] != ss[:-1]])
        grp = np.cumsum(boundary) - 1
        npos_g = np.bincount(grp, weights=ys * ws)
        ntot_g = np.bincount(grp, weights=ws)
        nneg_g = ntot_g - npos_g
        total_pos = np.sum(ys * ws)
        total_neg = np.sum(ws) - total_pos
        # positives pair with the negatives ranked strictly below plus half
        # of their tied group
        neg_below = total_neg - np.cumsum(nneg_g)
        auc_sum = np.sum(npos_g * (neg_below + nneg_g * 0.5))
        if total_pos <= 0 or total_neg <= 0:
            return 1.0
        return float(auc_sum / (total_pos * total_neg))


_REGISTRY = {c.name: c for c in (L2Metric, RMSEMetric, BinaryLoglossMetric,
                                 AUCMetric)}


def create_metric(name: str, config) -> Metric:
    """reference: src/metric/metric.cpp Metric::CreateMetric (the slice's
    metrics; Config rejects the others)."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"metric {name!r} is not ported to lightgbm_tpu_torch yet; it "
            f"arrives with ROADMAP.md Queue 1 item 10")
    return _REGISTRY[name](config)


def default_metric_for_objective(objective: str) -> List[str]:
    """Objective -> default metric (reference: config.cpp GetMetricType)."""
    return {"regression": ["l2"], "binary": ["binary_logloss"]}.get(
        objective, [])
