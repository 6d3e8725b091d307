"""Evaluation metrics, on the host in float64.

The port of lightgbm_tpu's ``metrics.py`` (reference:
src/metric/regression_metric.hpp, binary_metric.hpp, multiclass_metric.hpp,
xentropy_metric.hpp; ranking's ndcg and map live in ``ranking.py``).
Metrics take RAW scores and apply the objective's output conversion where
the reference does (which, as the JAX package's, works on the scores cast
to float32); everything else runs in numpy float64, the JAX package's
formulas in its order. Multiclass scores are ``[N, K]``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .utils import log


class Metric:
    name = "base"
    bigger_is_better = False

    def __init__(self, config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             groups: Optional[np.ndarray] = None) -> None:
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


# ----------------------------------------------------------- regression
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


class L1Metric(Metric):
    name = "l1"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        return self._wavg(np.abs(score - self.label))


class QuantileMetric(Metric):
    """reference: regression_metric.hpp QuantileMetric."""
    name = "quantile"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        alpha = self.config.alpha
        delta = self.label - score
        loss = np.where(delta < 0, (alpha - 1.0) * delta, alpha * delta)
        return self._wavg(loss)


class HuberMetric(Metric):
    name = "huber"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        a = self.config.alpha
        d = np.abs(score - self.label)
        loss = np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))
        return self._wavg(loss)


class FairMetric(Metric):
    name = "fair"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        c = self.config.fair_c
        x = np.abs(score - self.label)
        loss = c * x - c * c * np.log1p(x / c)
        return self._wavg(loss)


class PoissonMetric(Metric):
    """reference: regression_metric.hpp PoissonMetric: score is the mean
    (converted); loss = score - label*log(score)."""
    name = "poisson"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        eps = 1e-10
        return self._wavg(score - self.label * np.log(np.maximum(score, eps)))


class MAPEMetric(Metric):
    name = "mape"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        return self._wavg(np.abs((self.label - score)
                                 / np.maximum(1.0, np.abs(self.label))))


class GammaMetric(Metric):
    """reference: regression_metric.hpp GammaMetric (negative
    log-likelihood)."""
    name = "gamma"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        eps = 1e-10
        psi = 1.0
        theta = -1.0 / np.maximum(score, eps)
        a = psi
        b = -np.log(-theta)
        c = (1.0 / psi * np.log(self.label / psi)
             - np.log(self.label) - 0.0)  # lgamma(1/psi)=0 for psi=1
        return self._wavg(-((self.label * theta - b) / a + c))


class GammaDevianceMetric(Metric):
    """reference: regression_metric.hpp GammaDevianceMetric."""
    name = "gamma_deviance"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        # reference: LossOnPoint = tmp - log(tmp) - 1 per row, but the
        # AverageLoss override (regression_metric.hpp:291-293) returns
        # sum_loss * 2 and IGNORES sum_weights — i.e. 2x the weighted SUM,
        # not a mean.
        frac = self.label / (score + 1e-9)
        loss = -np.log(np.maximum(frac, 1e-300)) + frac - 1.0
        if self.weight is not None:
            loss = loss * self.weight
        return 2.0 * float(np.sum(loss))


class TweedieMetric(Metric):
    name = "tweedie"

    def eval(self, score, objective=None):
        score = self._convert(score, objective)
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        s = np.maximum(score, eps)
        a = self.label * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return self._wavg(-a + b)


# --------------------------------------------------------------- binary
class BinaryLoglossMetric(Metric):
    """reference: binary_metric.hpp BinaryLoglossMetric."""
    name = "binary_logloss"

    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        eps = 1e-15
        prob = np.clip(prob, eps, 1.0 - eps)
        y = (self.label > 0).astype(np.float64)
        return self._wavg(-(y * np.log(prob) + (1 - y) * np.log(1 - prob)))


class BinaryErrorMetric(Metric):
    """reference: binary_metric.hpp BinaryErrorMetric."""
    name = "binary_error"

    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        y = (self.label > 0).astype(np.float64)
        pred = (prob > 0.5).astype(np.float64)
        return self._wavg((pred != y).astype(np.float64))


class AUCMetric(Metric):
    """Weighted AUC via descending-score sweep
    (reference: binary_metric.hpp:159-268 AUCMetric)."""
    name = "auc"
    bigger_is_better = True

    def eval(self, score, objective=None):
        score = np.asarray(score, dtype=np.float64)
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-score, kind="stable")
        ys, ws = y[order], w[order]
        # group ties by score value
        ss = score[order]
        boundary = np.concatenate([[True], ss[1:] != ss[:-1]])
        grp = np.cumsum(boundary) - 1
        npos_g = np.bincount(grp, weights=ys * ws)
        ntot_g = np.bincount(grp, weights=ws)
        nneg_g = ntot_g - npos_g
        total_pos = np.sum(ys * ws)
        total_neg = np.sum(ws) - total_pos
        # positives pair with negatives ranked strictly below (later groups in
        # the descending sweep) plus half of the tied group
        cum_neg_incl = np.cumsum(nneg_g)
        neg_below = total_neg - cum_neg_incl
        auc_sum = np.sum(npos_g * (neg_below + nneg_g * 0.5))
        if total_pos <= 0 or total_neg <= 0:
            return 1.0
        return float(auc_sum / (total_pos * total_neg))


class AveragePrecisionMetric(Metric):
    """reference: binary_metric.hpp:270+ AveragePrecisionMetric."""
    name = "average_precision"
    bigger_is_better = True

    def eval(self, score, objective=None):
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-score, kind="stable")
        ys, ws, ss = y[order], w[order], np.asarray(score)[order]
        # tied scores form ONE threshold group whose precision is taken
        # AFTER including the whole group (binary_metric.hpp:270+ sweep)
        boundary = np.concatenate([[True], ss[1:] != ss[:-1]])
        grp = np.cumsum(boundary) - 1
        pos_g = np.bincount(grp, weights=ys * ws)
        tot_g = np.bincount(grp, weights=ws)
        cum_pos = np.cumsum(pos_g)
        cum_tot = np.cumsum(tot_g)
        total_pos = cum_pos[-1]
        if total_pos <= 0 or total_pos == np.sum(ws):
            return 1.0
        accum = float(np.sum(pos_g * (cum_pos / cum_tot)))
        return accum / float(total_pos)


# ------------------------------------------------------------ multiclass
class MultiLoglossMetric(Metric):
    """reference: multiclass_metric.hpp MultiSoftmaxLoglossMetric."""
    name = "multi_logloss"

    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        eps = 1e-15
        yi = self.label.astype(np.int64)
        p = np.clip(prob[np.arange(len(yi)), yi], eps, 1.0)
        return self._wavg(-np.log(p))


class MultiErrorMetric(Metric):
    """reference: multiclass_metric.hpp MultiErrorMetric (top-k)."""
    name = "multi_error"

    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        yi = self.label.astype(np.int64)
        k = self.config.multi_error_top_k
        true_p = prob[np.arange(len(yi)), yi][:, None]
        # error when the true class's prob is not among the top-k
        # (reference counts ties in favor of correctness)
        rank = np.sum(prob > true_p, axis=1)
        return self._wavg((rank >= k).astype(np.float64))


class AucMuMetric(Metric):
    """reference: multiclass_metric.hpp:138-183 auc_mu (pairwise class AUC
    averaged over class pairs)."""
    name = "auc_mu"
    bigger_is_better = True

    def eval(self, score, objective=None):
        # the reference ranks by RAW score distances from the separating
        # hyperplane (multiclass_metric.hpp:238-266) — no softmax; with
        # auc_mu_weights the decision value is (W_i - W_j) . score
        s_raw = np.asarray(score)
        yi = self.label.astype(np.int64)
        k = s_raw.shape[1]
        w = self.weight if self.weight is not None else np.ones(len(yi))
        amw = list(self.config.auc_mu_weights or [])
        if amw:
            if len(amw) != k * k:
                log.fatal(f"auc_mu_weights must have {k * k} elements")
            W = np.asarray(amw, np.float64).reshape(k, k)
        else:
            W = 1.0 - np.eye(k)
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                mask = (yi == a) | (yi == b)
                if not mask.any():
                    continue
                curr_v = W[a] - W[b]
                t1 = curr_v[a] - curr_v[b]
                d = t1 * (s_raw[mask] @ curr_v)
                sub = AUCMetric(self.config)
                sub.init((yi[mask] == a).astype(np.float64), w[mask])
                aucs.append(sub.eval(d, None))
        return float(np.mean(aucs)) if aucs else 1.0


# ---------------------------------------------------------- cross-entropy
class CrossEntropyMetric(Metric):
    """reference: xentropy_metric.hpp CrossEntropyMetric."""
    name = "cross_entropy"

    def eval(self, score, objective=None):
        p = self._convert(score, objective)
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        y = self.label
        return self._wavg(-(y * np.log(p) + (1 - y) * np.log(1 - p)))


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score, objective=None):
        hhat = np.log1p(np.exp(score))  # converted output
        eps = 1e-15
        p = np.clip(1.0 - np.exp(-hhat), eps, 1 - eps)
        y = self.label
        return self._wavg(-(y * np.log(p) + (1 - y) * np.log(1 - p)))


class KLDivMetric(Metric):
    """reference: xentropy_metric.hpp KullbackLeiblerDivergence."""
    name = "kullback_leibler"

    def eval(self, score, objective=None):
        p = self._convert(score, objective)
        eps = 1e-15
        p = np.clip(p, eps, 1 - eps)
        y = np.clip(self.label, eps, 1 - eps)
        ce = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        ent = -(y * np.log(y) + (1 - y) * np.log(1 - y))
        return self._wavg(ce - ent)


_REGISTRY = {}
for _cls in [L2Metric, RMSEMetric, L1Metric, QuantileMetric, HuberMetric,
             FairMetric, PoissonMetric, MAPEMetric, GammaMetric,
             GammaDevianceMetric, TweedieMetric, BinaryLoglossMetric,
             BinaryErrorMetric, AUCMetric, AveragePrecisionMetric,
             MultiLoglossMetric, MultiErrorMetric, AucMuMetric,
             CrossEntropyMetric, CrossEntropyLambdaMetric, KLDivMetric]:
    _REGISTRY[_cls.name] = _cls


def create_metric(name: str, config) -> Optional[Metric]:
    """reference: src/metric/metric.cpp Metric::CreateMetric. An unknown
    name is skipped with a warning, as the JAX package does; ranking's
    metrics (ndcg, map) live in ``ranking.py``."""
    if name in ("ndcg", "map"):
        from .ranking import create_ranking_metric
        return create_ranking_metric(name, config)
    if name in _REGISTRY:
        return _REGISTRY[name](config)
    log.warning(f"Unknown metric: {name}")
    return None


def default_metric_for_objective(objective: str) -> List[str]:
    """Objective -> default metric (reference: config.cpp GetMetricType)."""
    mapping = {
        "regression": ["l2"], "regression_l1": ["l1"], "huber": ["huber"],
        "fair": ["fair"], "poisson": ["poisson"], "quantile": ["quantile"],
        "mape": ["mape"], "gamma": ["gamma"], "tweedie": ["tweedie"],
        "binary": ["binary_logloss"],
        "multiclass": ["multi_logloss"], "multiclassova": ["multi_logloss"],
        "cross_entropy": ["cross_entropy"],
        "cross_entropy_lambda": ["cross_entropy_lambda"],
        "lambdarank": ["ndcg"], "rank_xendcg": ["ndcg"],
    }
    return mapping.get(objective, [])
