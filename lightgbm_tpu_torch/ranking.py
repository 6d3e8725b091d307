"""Learning-to-rank objectives and metrics.

The port of lightgbm_tpu's ``ranking.py`` (reference:
src/objective/rank_objective.hpp, src/metric/rank_metric.hpp,
src/metric/map_metric.hpp, src/metric/dcg_calculator.cpp).

- ``LambdarankNDCG``: the pairwise lambdas and hessians come from
  ``ops/rank.lambdarank_grads``, the hand-written CUDA kernel on the card
  (a query a block, each document walking its real partners; no
  ``[Q, M, M]`` pair tensor) and the JAX package's arithmetic over the
  padded pair tensor on the CPU, bitwise its gradients.
- ``RankXENDCG``: plain torch over the padded ``[Q, M]`` block, as the
  JAX package's ``jnp``: the softmax, the three Taylor terms, XLA:CPU's
  sum order (``ops/rank.xla_sum``) and flush-to-zero. Its gamma is drawn
  on the host every iteration from ``np.random.RandomState(seed)``, the
  JAX package's numbers.
- ``NDCGMetric`` and ``MapMetric``: the JAX package's host numpy loops in
  float64.

Queries are padded into ``[Q, M]`` blocks (``_PaddedQueries``, M the
longest query rounded up to a multiple of 8, the shape of rank_xendcg's
draw). Padded slots hold document 0's index, so the JAX scatter adds
their masked zeros into document 0; the port writes each document's value
plus +0, the same bits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .objectives import (ObjectiveFunction, _c32, _fma, _ftz, exp2_f32,
                         exp_f32)
from .ops.rank import (K_EPSILON, PAD_SCORE, RankLayout, lambdarank_grads,
                       xla_sum)
from .utils import log


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """reference: dcg_calculator.cpp:33-41 DefaultLabelGain (2^i - 1)."""
    gains = [0.0]
    for i in range(1, max_label):
        gains.append(float((1 << i) - 1))
    return np.asarray(gains, dtype=np.float64)


def _resolve_label_gain(config) -> np.ndarray:
    if config.label_gain:
        return np.asarray(config.label_gain, dtype=np.float64)
    return default_label_gain()


def group_boundaries(groups: np.ndarray) -> np.ndarray:
    """Query sizes -> boundary offsets [Q+1] (reference:
    Metadata::SetQuery)."""
    groups = np.asarray(groups, dtype=np.int64).reshape(-1)
    return np.concatenate([[0], np.cumsum(groups)])


def _max_dcg_at_k(k: int, labels: np.ndarray, gains: np.ndarray) -> float:
    """reference: dcg_calculator.cpp:55-78 CalMaxDCGAtK."""
    lab = np.sort(labels.astype(np.int64))[::-1][:k]
    disc = 1.0 / np.log2(2.0 + np.arange(len(lab)))
    return float(np.sum(gains[lab] * disc))


class _PaddedQueries:
    """Host-side padding plan: [N] document arrays into [Q, M] blocks, M the
    longest query rounded up to a multiple of 8."""

    def __init__(self, groups: np.ndarray):
        bounds = group_boundaries(groups)
        self.num_queries = len(bounds) - 1
        sizes = np.diff(bounds)
        m = int(max(sizes.max(), 1))
        self.m = int((m + 7) // 8 * 8)
        self.sizes = sizes
        self.bounds = bounds
        slot = np.arange(self.m)[None, :]
        self.mask = slot < sizes[:, None]                       # [Q, M]
        self.doc_index = np.where(self.mask, bounds[:-1, None] + slot,
                                  0).astype(np.int64)           # [Q, M]

    def gather(self, x: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full((self.num_queries, self.m), fill, dtype=np.float64)
        out[self.mask] = np.asarray(x, dtype=np.float64)[
            self.doc_index[self.mask]]
        return out


# ---------------------------------------------------------------- objectives
class RankingObjective(ObjectiveFunction):
    """reference: rank_objective.hpp:25 RankingObjective."""

    def init(self, label, weight, groups=None, device="cpu") -> None:
        super().init(label, weight, groups, device)
        if groups is None:
            log.fatal("Ranking tasks require query information "
                      "(set group on the Dataset)")
        self.padding = p = _PaddedQueries(groups)
        if p.bounds[-1] != self.num_data:
            log.fatal(f"the query sizes add up to {p.bounds[-1]} documents, "
                      f"the data has {self.num_data}")
        self.layout = RankLayout(p.bounds, p.doc_index, p.mask, self.device)

    def _scatter_grads(self, lam_pad: torch.Tensor, hess_pad: torch.Tensor):
        """[Q, M] padded -> [N] documents (each value plus the scatter's +0),
        then the document weights."""
        mask, idx = self.layout.mask, self.layout.doc_index[self.layout.mask]
        lam = torch.zeros((self.num_data,), dtype=torch.float32,
                          device=self.device)
        hess = torch.zeros_like(lam)
        lam[idx] = lam_pad[mask] + 0.0
        hess[idx] = hess_pad[mask] + 0.0
        return self._apply_weight(lam, hess)


class LambdarankNDCG(RankingObjective):
    """reference: rank_objective.hpp:98 LambdarankNDCG."""

    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0.0:
            log.fatal(f"Sigmoid param {self.sigmoid} should be greater than "
                      f"zero")
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        self.gains = _resolve_label_gain(config)

    def init(self, label, weight, groups=None, device="cpu") -> None:
        super().init(label, weight, groups, device)
        b = self.padding.bounds
        inv = np.zeros((self.padding.num_queries,), dtype=np.float64)
        for i in range(self.padding.num_queries):
            mx = _max_dcg_at_k(self.truncation_level,
                               self.label_np[b[i]:b[i + 1]], self.gains)
            inv[i] = 1.0 / mx if mx > 0 else 0.0
        self.inv_max_dcg = torch.as_tensor(inv.astype(np.float32),
                                           device=self.device)
        self.gain = torch.as_tensor(
            self.gains[self.label_np.astype(np.int64)].astype(np.float32),
            device=self.device)

    def get_grad_hess(self, score: torch.Tensor):
        lam, hess = lambdarank_grads(
            score.to(torch.float32).contiguous(), self.label, self.gain,
            self.inv_max_dcg, self.layout, self.sigmoid,
            self.truncation_level, self.norm)
        return self._apply_weight(lam, hess)


class RankXENDCG(RankingObjective):
    """reference: rank_objective.hpp:285 RankXENDCG (arxiv 1911.09798)."""

    name = "rank_xendcg"

    def init(self, label, weight, groups=None, device="cpu") -> None:
        super().init(label, weight, groups, device)
        p = self.padding
        self._rng = np.random.RandomState(self.config.seed)
        self.q_mask = self.layout.mask
        self.q_label = torch.as_tensor(p.gather(self.label_np)
                                       .astype(np.float32), device=self.device)

    def _padded_grads(self, q_score: torch.Tensor, gamma: torch.Tensor):
        """reference: rank_objective.hpp:306-355, the JAX package's
        operations in order (ranking.py ``RankXENDCG._padded_grads``)."""
        mask = self.q_mask
        zero = torch.zeros((), dtype=torch.float32, device=q_score.device)
        eps = _c32(K_EPSILON)
        s = torch.where(mask, q_score, _c32(PAD_SCORE))
        un = exp_f32(_ftz(s - torch.amax(s, dim=1, keepdim=True)))
        rho = _ftz(un / xla_sum(un, [1])[:, None])
        rho = torch.where(mask, rho, zero)
        phi = torch.where(mask, _ftz(exp2_f32(torch.trunc(self.q_label))
                                     - gamma), zero)
        inv_den = _ftz(1.0 / torch.clamp(xla_sum(phi, [1]), min=eps))[:, None]
        den = torch.clamp(_ftz(1.0 - rho), min=eps)
        # XLA:CPU contracts this multiply-add into one fused multiply-add
        t1 = torch.where(mask, _ftz(_fma(-phi, inv_den, rho)), zero)
        lam = t1
        params = torch.where(mask, _ftz(t1 / den), zero)
        sum_l1 = xla_sum(params, [1])[:, None]
        t2 = torch.where(mask, _ftz(rho * _ftz(sum_l1 - params)), zero)
        lam = _ftz(lam + t2)
        params = torch.where(mask, _ftz(t2 / den), zero)
        sum_l2 = xla_sum(params, [1])[:, None]
        lam = _ftz(lam + torch.where(mask, _ftz(rho * _ftz(sum_l2 - params)),
                                     zero))
        hess = torch.where(mask, _ftz(rho * _ftz(1.0 - rho)), zero)
        few = mask.sum(dim=1, keepdim=True) <= 1
        return (torch.where(few, zero, lam), torch.where(few, zero, hess))

    def get_grad_hess(self, score: torch.Tensor):
        q_score = score.to(torch.float32)[self.layout.doc_index]
        gamma = torch.as_tensor(
            self._rng.uniform(size=tuple(self.q_mask.shape))
            .astype(np.float32), device=self.device)
        return self._scatter_grads(*self._padded_grads(q_score, gamma))


def create_ranking_objective(config) -> RankingObjective:
    if config.objective == "lambdarank":
        return LambdarankNDCG(config)
    if config.objective == "rank_xendcg":
        return RankXENDCG(config)
    log.fatal(f"Unknown ranking objective: {config.objective}")


# ------------------------------------------------------------------- metrics
def _query_weights(weight, bounds) -> Optional[np.ndarray]:
    """Per-query weight = MEAN of its doc weights (reference:
    src/io/metadata.cpp:467-471 query_weights_)."""
    if weight is None:
        return None
    w = np.asarray(weight, dtype=np.float64)
    nq = len(bounds) - 1
    return np.array([np.sum(w[bounds[i]:bounds[i + 1]]) /
                     max(bounds[i + 1] - bounds[i], 1) for i in range(nq)])


class NDCGMetric:
    """reference: rank_metric.hpp:19 NDCGMetric. Host-side (numpy)."""

    bigger_is_better = True

    def __init__(self, config):
        self.eval_at = list(config.eval_at) if config.eval_at \
            else [1, 2, 3, 4, 5]
        self.gains = _resolve_label_gain(config)
        self.name = [f"ndcg@{k}" for k in self.eval_at]

    def init(self, label, weight, groups=None) -> None:
        if groups is None:
            log.fatal("The NDCG metric requires query information")
        self.label = np.asarray(label, dtype=np.float64)
        self.bounds = group_boundaries(groups)
        self.num_queries = len(self.bounds) - 1
        self.query_weights = _query_weights(weight, self.bounds)
        self.inv_max = np.zeros((self.num_queries, len(self.eval_at)))
        for i in range(self.num_queries):
            lab = self.label[self.bounds[i]:self.bounds[i + 1]]
            for j, k in enumerate(self.eval_at):
                mx = _max_dcg_at_k(k, lab, self.gains)
                self.inv_max[i, j] = 1.0 / mx if mx > 0 else -1.0

    def eval(self, score: np.ndarray, objective=None) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(-1)
        res = np.zeros(len(self.eval_at))
        total_w = 0.0
        for i in range(self.num_queries):
            w = 1.0 if self.query_weights is None else self.query_weights[i]
            total_w += w
            lab = self.label[self.bounds[i]:self.bounds[i + 1]]
            sc = score[self.bounds[i]:self.bounds[i + 1]]
            if self.inv_max[i, 0] <= 0:
                res += w  # all-negative query counts as NDCG=1
                continue
            order = np.argsort(-sc, kind="stable")
            disc = 1.0 / np.log2(2.0 + np.arange(len(lab)))
            g = self.gains[lab[order].astype(np.int64)]
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(lab))
                res[j] += w * np.sum(g[:kk] * disc[:kk]) * self.inv_max[i, j]
        return list(res / max(total_w, K_EPSILON))


class MapMetric:
    """reference: map_metric.hpp:20 MapMetric (mean average precision @ k)."""

    bigger_is_better = True

    def __init__(self, config):
        self.eval_at = list(config.eval_at) if config.eval_at \
            else [1, 2, 3, 4, 5]
        self.name = [f"map@{k}" for k in self.eval_at]

    def init(self, label, weight, groups=None) -> None:
        if groups is None:
            log.fatal("The MAP metric requires query information")
        self.label = np.asarray(label, dtype=np.float64)
        self.bounds = group_boundaries(groups)
        self.num_queries = len(self.bounds) - 1
        self.query_weights = _query_weights(weight, self.bounds)

    def eval(self, score: np.ndarray, objective=None) -> List[float]:
        """reference: map_metric.hpp:58-84 CalMapAtK per query."""
        score = np.asarray(score, dtype=np.float64).reshape(-1)
        res = np.zeros(len(self.eval_at))
        total_w = 0.0
        for i in range(self.num_queries):
            w = 1.0 if self.query_weights is None else self.query_weights[i]
            total_w += w
            lab = self.label[self.bounds[i]:self.bounds[i + 1]]
            sc = score[self.bounds[i]:self.bounds[i + 1]]
            order = np.argsort(-sc, kind="stable")
            rel = lab[order] > 0.5
            npos_total = int(np.count_nonzero(rel))
            hits = np.cumsum(rel)
            prec = hits / (1.0 + np.arange(len(rel)))
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(rel))
                if npos_total > 0:
                    # reference: map_metric.hpp sum_ap / min(npos, k)
                    res[j] += w * np.sum(prec[:kk] * rel[:kk]) \
                        / min(npos_total, kk)
                else:
                    res[j] += w  # queries without positives count as 1
        return list(res / max(total_w, K_EPSILON))


def create_ranking_metric(name: str, config):
    if name == "ndcg":
        return NDCGMetric(config)
    if name == "map":
        return MapMetric(config)
    return None
