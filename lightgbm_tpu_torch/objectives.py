"""Objective functions: per-row gradients/hessians on the device.

The port of lightgbm_tpu's ``objectives.py`` (reference:
src/objective/regression_objective.hpp, binary_objective.hpp,
multiclass_objective.hpp, xentropy_objective.hpp; ranking's lambdarank and
rank_xendcg live in ``ranking.py``). Gradients are float32
tensors on the run's device, each operation the JAX package's in its
order (a scalar parameter enters as a float32 constant, as JAX's weak
types do); ``boost_from_score`` and the L1-family leaf renewal
(``renew_tree_output``) run on the host in float64 exactly as the JAX
package does. ``exp`` is XLA:CPU's float32 ``exp`` written out in PyTorch
operations (``exp_f32``; ``torch.exp`` rounds differently), and ``log1p``
XLA:CPU's (``log1p_f32``), so gradients and converted outputs are bitwise
the JAX package's on the CPU, and the card computes the same bits.
Multiclass scores are ``[N, K]``; softmax sums its K terms left to right.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .utils import log

K_EPSILON = 1e-15

# XLA:CPU's float32 exp (the Cephes scheme): the input clamped below at
# -88.376, range reduction by ln 2 with a hi/lo split of the constant, a
# degree-5 polynomial in fused multiply-adds, scaling by 2^n with n capped
# at 127, results below FLT_MIN flushed to 0
_EXP_LO = -88.3762626647949
_EXP_LOG2E = 1.44269504088896341
_EXP_LN2_HI = 0.693359375
_EXP_LN2_LO = -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding: the product of two float32
    values is exact in float64, so only the add rounds before the cast."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _c32(v: float) -> float:
    """A constant as the float32 value XLA embeds, carried as a double."""
    return float(np.float32(v))


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush a float32 result below FLT_MIN to a zero of its sign, as
    XLA:CPU's flush-to-zero mode does for every operation it runs."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, bit for bit as XLA computes it on the
    CPU (``jnp.exp``), on any device: every step is an IEEE operation that
    eager PyTorch runs as written (no contraction), each fused multiply-add
    evaluated in float64 and rounded once."""
    x = x.to(torch.float32).clamp(min=_c32(_EXP_LO))
    n = torch.floor(_fma(x, _c32(_EXP_LOG2E), 0.5)).clamp(max=127.0)
    r = _fma(n, -_c32(_EXP_LN2_HI), x)
    r = _fma(n, -_c32(_EXP_LN2_LO), r)
    z = r * r
    y = _fma(r, _c32(_EXP_POLY[0]), _c32(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        y = _fma(y, r, _c32(c))
    y = _fma(y, z, r) + 1.0
    # 2^n built from its bits (exact on every device), the product exact
    two_n = ((n.to(torch.int64) + 1023) << 52).view(torch.float64)
    out = (y.to(torch.float64) * two_n).to(torch.float32)
    out = torch.where(out < _FLT_MIN, torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), x, out)


def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of float32, as XLA:CPU computes it: ``exp(x * ln 2)``
    with ``ln 2`` a float32 constant."""
    return exp_f32(x * _c32(np.log(2.0)))


# XLA:CPU's float32 log (Cephes, as Eigen's plog): the mantissa brought
# into [sqrt(1/2), sqrt(2)), a degree-8 polynomial in fused multiply-adds,
# the exponent added back through the hi/lo split of ln 2
_LOG_SQRTHF = 0.707106781186547524
_LOG_POLY = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
             -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
             2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's log1p below sqrt(2) - 1: Cephes' rational approximation, both
# polynomials in Horner form from the highest power
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``log`` of a float32 tensor, bit for bit as XLA computes it on the
    CPU (``jnp.log``): 0 gives -inf, a negative input NaN, +inf +inf;
    a subnormal input counts as 0."""
    x = _ftz(x.to(torch.float32))
    t = torch.clamp(x, min=_FLT_MIN)
    b = t.view(torch.int32)
    e = 1.0 + ((b >> 23) - 0x7F).to(torch.float32)
    t = ((b & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = t < _c32(_LOG_SQRTHF)
    e = e - small.to(torch.float32)
    t = (t - 1.0) + torch.where(small, t, torch.zeros_like(t))
    x2 = t * t
    x3 = x2 * t
    c = [_c32(v) for v in _LOG_POLY]
    y = _fma(_fma(t, c[0], c[1]), t, c[2])
    y1 = _fma(_fma(t, c[3], c[4]), t, c[5])
    y2 = _fma(_fma(t, c[6], c[7]), t, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _c32(_LOG_Q1))
    t = _fma(x2, -0.5, t) + y
    out = _fma(e, _c32(_LOG_Q2), t)
    out = torch.where(x == 0, torch.full_like(out, float("-inf")), out)
    out = torch.where(x < 0, torch.full_like(out, float("nan")), out)
    out = torch.where(torch.isposinf(x), x, out)
    return torch.where(torch.isnan(x), x, out)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` of a float32 tensor, bit for bit as XLA computes it on the
    CPU (``jnp.log1p``): ``log_f32(1 + x)``, or below sqrt(2) - 1 in
    magnitude x - x^2 / 2 + x^3 * P(x) / Q(x)."""
    x = _ftz(x.to(torch.float32))
    x2 = x * x

    def horner(coeffs):
        p = torch.zeros_like(x)
        for v in coeffs:
            p = _fma(p, x, _c32(v))
        return p

    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    return torch.where(torch.abs(x) < _c32(_LOG1P_SMALL), small,
                       log_f32(x + 1.0))


def _percentile(data: np.ndarray, alpha: float) -> float:
    """reference: regression_objective.hpp:17-47 PercentileFun (unweighted)."""
    cnt = len(data)
    if cnt <= 1:
        return float(data[0]) if cnt else 0.0
    d = np.sort(data)[::-1]  # descending; pos counts from the top
    float_pos = (1.0 - alpha) * cnt
    pos = int(float_pos)
    if pos < 1:
        return float(d[0])
    if pos >= cnt:
        return float(d[-1])
    bias = float_pos - pos
    v1, v2 = float(d[pos - 1]), float(d[pos])
    return v1 - (v1 - v2) * bias


def _weighted_percentile(data: np.ndarray, weight: np.ndarray,
                         alpha: float) -> float:
    """reference: regression_objective.hpp:49-87 WeightedPercentileFun."""
    cnt = len(data)
    if cnt <= 1:
        return float(data[0]) if cnt else 0.0
    order = np.argsort(data, kind="stable")
    d = data[order]
    cdf = np.cumsum(weight[order])
    threshold = cdf[-1] * alpha
    pos = int(np.searchsorted(cdf, threshold, side="right"))
    pos = min(pos, cnt - 1)
    if pos == 0 or pos == cnt - 1:
        return float(d[pos])
    v1, v2 = float(d[pos - 1]), float(d[pos])
    if pos + 1 < cnt and cdf[pos + 1] - cdf[pos] >= 1.0:
        return (threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos]) * (v2 - v1) \
            + v1
    return v2


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the float32 constant JAX's weak typing makes of
    it, on ``like``'s device."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


def _as_f32(raw) -> torch.Tensor:
    """Raw scores for an output conversion: float32, as the JAX package
    converts them; a tensor stays on its device (a predict converts on the
    card before its one fetch)."""
    if isinstance(raw, torch.Tensor):
        return raw.to(torch.float32)
    return torch.as_tensor(np.asarray(raw)).to(torch.float32)


def _sigmoid(raw, scale: float) -> np.ndarray:
    """``1 / (1 + exp(-scale * raw))`` on float32 raw scores."""
    r = _as_f32(raw)
    return _ftz(1.0 / (1.0 + exp_f32(_f32(-scale, r) * r))).cpu().numpy()


class ObjectiveFunction:
    """Base objective (reference: include/LightGBM/objective_function.h)."""

    name = "base"
    num_model_per_iteration = 1
    need_renew_tree_output = False

    def __init__(self, config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             groups: Optional[np.ndarray] = None, device="cpu") -> None:
        self.label_np = np.asarray(label, dtype=np.float64)
        self.weight_np = (np.asarray(weight, dtype=np.float64)
                          if weight is not None else None)
        self.num_data = len(self.label_np)
        self.device = torch.device(device)
        self.label = torch.as_tensor(self.label_np.astype(np.float32),
                                     device=self.device)
        self.weight = (torch.as_tensor(self.weight_np.astype(np.float32),
                                       device=self.device)
                       if weight is not None else None)

    def _apply_weight(self, grad, hess):
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess

    def get_grad_hess(self, score: torch.Tensor):
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw):
        """Raw score -> output space (the identity here)."""
        return raw

    def renew_tree_output(self, pred_leaf: np.ndarray, score: np.ndarray,
                          num_leaves: int) -> Optional[np.ndarray]:
        """Per-leaf output refresh of the L1 family (reference:
        objective_function.h:46 RenewTreeOutput): new leaf values
        [num_leaves] in float64, or None."""
        return None


# ------------------------------------------------------------- regression
class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:93-201 (RegressionL2loss)."""
    name = "regression"

    def init(self, label, weight, groups=None, device="cpu"):
        if self.config.reg_sqrt:
            label = np.sign(label) * np.sqrt(np.abs(label))
        super().init(label, weight, groups, device)

    def get_grad_hess(self, score):
        return self._apply_weight(score - self.label, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        # reference: regression_objective.hpp:173-198 (weighted mean label)
        if self.weight_np is not None:
            return float(np.sum(self.label_np * self.weight_np)
                         / np.sum(self.weight_np))
        return float(np.mean(self.label_np))

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            r = _as_f32(raw)
            return (torch.sign(r) * r * r).cpu().numpy()
        return raw


class RegressionL1(RegressionL2):
    """reference: regression_objective.hpp:207-290 (RegressionL1loss)."""
    name = "regression_l1"
    need_renew_tree_output = True

    def get_grad_hess(self, score):
        diff = score - self.label
        if self.weight is not None:
            return torch.sign(diff) * self.weight, self.weight.clone()
        return torch.sign(diff), torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weight_np is not None:
            return _weighted_percentile(self.label_np, self.weight_np, 0.5)
        return _percentile(self.label_np, 0.5)

    def _renew_alpha(self) -> float:
        return 0.5

    def renew_tree_output(self, pred_leaf, score, num_leaves):
        # reference: regression_objective.hpp:253-263 -- leaf value := the
        # percentile of (label - score) over the leaf's rows
        residual = self.label_np - score
        alpha = self._renew_alpha()
        out = np.zeros(num_leaves)
        for leaf in range(num_leaves):
            mask = pred_leaf == leaf
            if not mask.any():
                continue
            r = residual[mask]
            if self.weight_np is not None:
                out[leaf] = _weighted_percentile(r, self.weight_np[mask],
                                                 alpha)
            else:
                out[leaf] = _percentile(r, alpha)
        return out


class RegressionHuber(RegressionL2):
    """reference: regression_objective.hpp:293-348 (RegressionHuberLoss)."""
    name = "huber"

    def get_grad_hess(self, score):
        diff = score - self.label
        alpha = _f32(self.config.alpha, diff)
        g = torch.where(torch.abs(diff) <= alpha, diff,
                        torch.sign(diff) * alpha)
        return self._apply_weight(g, torch.ones_like(score))


class RegressionFair(RegressionL2):
    """reference: regression_objective.hpp:351-395 (RegressionFairLoss)."""
    name = "fair"

    def get_grad_hess(self, score):
        c = self.config.fair_c
        x = score - self.label
        den = torch.abs(x) + _f32(c, x)
        g = _f32(c, x) * x / den
        h = _f32(c * c, x) / (den * den)
        return self._apply_weight(_ftz(g), _ftz(h))


class RegressionPoisson(RegressionL2):
    """reference: regression_objective.hpp:398-477 (RegressionPoissonLoss).
    The score is the log-mean: grad = exp(s) - y, hess = exp(s +
    poisson_max_delta_step)."""
    name = "poisson"

    def init(self, label, weight, groups=None, device="cpu"):
        if np.any(np.asarray(label) < 0):
            log.fatal("[poisson]: at least one target label is negative")
        super().init(label, weight, groups, device)

    def get_grad_hess(self, score):
        g = exp_f32(score) - self.label
        h = exp_f32(score + _f32(self.config.poisson_max_delta_step, score))
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = RegressionL2.boost_from_score(self, class_id)
        return float(np.log(max(mean, 1e-300)))

    def convert_output(self, raw):
        return exp_f32(_as_f32(raw)).cpu().numpy()


class RegressionQuantile(RegressionL2):
    """reference: regression_objective.hpp:478-573 (RegressionQuantileloss)."""
    name = "quantile"
    need_renew_tree_output = True

    def get_grad_hess(self, score):
        alpha = self.config.alpha
        delta = score - self.label
        g = torch.where(delta >= 0, _f32(1.0 - alpha, delta),
                        _f32(-alpha, delta))
        return self._apply_weight(g, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weight_np is not None:
            return _weighted_percentile(self.label_np, self.weight_np,
                                        self.config.alpha)
        return _percentile(self.label_np, self.config.alpha)

    def _renew_alpha(self) -> float:
        return self.config.alpha

    renew_tree_output = RegressionL1.renew_tree_output


class RegressionMAPE(RegressionL1):
    """reference: regression_objective.hpp:576-672 (RegressionMAPELOSS)."""
    name = "mape"

    def init(self, label, weight, groups=None, device="cpu"):
        super().init(label, weight, groups, device)
        lw = 1.0 / np.maximum(1.0, np.abs(self.label_np))
        if self.weight_np is not None:
            lw = lw * self.weight_np
        self.label_weight_np = lw
        self.label_weight = torch.as_tensor(lw.astype(np.float32),
                                            device=self.device)

    def get_grad_hess(self, score):
        diff = score - self.label
        g = torch.sign(diff) * self.label_weight
        h = (self.weight.clone() if self.weight is not None
             else torch.ones_like(score))
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self.label_np, self.label_weight_np, 0.5)

    def renew_tree_output(self, pred_leaf, score, num_leaves):
        # reference: regression_objective.hpp:640-652 -- the weighted median
        # of the residual with label_weight_
        residual = self.label_np - score
        out = np.zeros(num_leaves)
        for leaf in range(num_leaves):
            mask = pred_leaf == leaf
            if mask.any():
                out[leaf] = _weighted_percentile(
                    residual[mask], self.label_weight_np[mask], 0.5)
        return out


class RegressionGamma(RegressionPoisson):
    """reference: regression_objective.hpp:677-707 (RegressionGammaLoss)."""
    name = "gamma"

    def get_grad_hess(self, score):
        e = exp_f32(-score)
        g = 1.0 - _ftz(self.label * e)
        h = _ftz(self.label * e)
        return self._apply_weight(g, h)


class RegressionTweedie(RegressionPoisson):
    """reference: regression_objective.hpp:712-751 (RegressionTweedieLoss)."""
    name = "tweedie"

    def get_grad_hess(self, score):
        rho = self.config.tweedie_variance_power
        e1 = exp_f32(_f32(1.0 - rho, score) * score)
        e2 = exp_f32(_f32(2.0 - rho, score) * score)
        g = _ftz(-self.label * e1) + e2
        h = (_ftz(-self.label * _f32(1.0 - rho, score) * e1)
             + _ftz(_f32(2.0 - rho, score) * e2))
        return self._apply_weight(_ftz(g), _ftz(h))


# ----------------------------------------------------------------- binary
class BinaryLogloss(ObjectiveFunction):
    """reference: src/objective/binary_objective.hpp:21-199. ``is_pos``
    picks the positive rows from the labels (one class of
    ``multiclassova``)."""
    name = "binary"

    def __init__(self, config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid parameter {self.sigmoid} should be greater "
                      f"than zero")
        self._is_pos = is_pos if is_pos is not None else (lambda y: y > 0)

    def init(self, label, weight, groups=None, device="cpu"):
        super().init(label, weight, groups, device)
        is_pos = self._is_pos(self.label_np)
        cnt_pos = int(np.sum(is_pos))
        cnt_neg = self.num_data - cnt_pos
        self.need_train = not (cnt_pos == 0 or cnt_neg == 0)
        if not self.need_train:
            log.warning("Contains only one class")
        # label weights (binary_objective.hpp:88-102)
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        self._is_pos_np = is_pos
        self.label_sign = torch.as_tensor(
            np.where(is_pos, 1.0, -1.0).astype(np.float32), device=self.device)
        self.label_weight = torch.as_tensor(
            np.where(is_pos, w_pos, w_neg).astype(np.float32),
            device=self.device)
        log.info(f"Number of positive: {cnt_pos}, number of negative: "
                 f"{cnt_neg}")

    def get_grad_hess(self, score):
        # reference: binary_objective.hpp:110-136
        if not self.need_train:
            return torch.zeros_like(score), torch.zeros_like(score)
        sig = torch.tensor(self.sigmoid, dtype=torch.float32,
                           device=score.device)
        # every result that can fall below FLT_MIN is flushed, as XLA does
        response = _ftz(-self.label_sign * sig / (
            1.0 + exp_f32(self.label_sign * sig * score)))
        abs_response = torch.abs(response)
        g = _ftz(response * self.label_weight)
        h = _ftz(_ftz(abs_response * (sig - abs_response))
                 * self.label_weight)
        g, h = self._apply_weight(g, h)
        return _ftz(g), _ftz(h)

    def boost_from_score(self, class_id: int = 0) -> float:
        # reference: binary_objective.hpp:139-161
        if self.weight_np is not None:
            pavg = float(np.sum(self._is_pos_np * self.weight_np)
                         / np.sum(self.weight_np))
        else:
            pavg = float(np.mean(self._is_pos_np))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info(f"[binary:BoostFromScore]: pavg={pavg:.6f} -> "
                 f"initscore={initscore:.6f}")
        return initscore

    def convert_output(self, raw):
        """Probabilities as float32 numpy: the raw scores are cast to
        float32 first, as the JAX package's conversion does."""
        return _sigmoid(raw, self.sigmoid)


# -------------------------------------------------------------- multiclass
def softmax_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(x, axis=-1)`` on float32: exp(x - max) over the sum
    of the K terms taken left to right."""
    un = exp_f32(x - x.amax(-1, keepdim=True))
    tot = torch.zeros_like(un[..., :1])
    for k in range(un.shape[-1]):
        tot = tot + un[..., k:k + 1]
    return _ftz(un / tot)


class MulticlassSoftmax(ObjectiveFunction):
    """reference: src/objective/multiclass_objective.hpp:20-180."""
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = self.num_class
        self.factor = self.num_class / (self.num_class - 1.0)

    def init(self, label, weight, groups=None, device="cpu"):
        super().init(label, weight, groups, device)
        li = self.label_np.astype(np.int32)
        if np.any((li < 0) | (li >= self.num_class)):
            log.fatal("Label must be in [0, num_class)")
        self.onehot = torch.nn.functional.one_hot(
            torch.as_tensor(li.astype(np.int64), device=self.device),
            self.num_class).to(torch.float32)
        # class_init_probs_: weighted class frequencies
        w = (self.weight_np if self.weight_np is not None
             else np.ones(self.num_data))
        self.class_init_probs = np.array(
            [np.sum(w * (li == k)) / np.sum(w)
             for k in range(self.num_class)])

    def get_grad_hess(self, score):
        # score [N, K]; reference: multiclass_objective.hpp:90-127
        p = softmax_f32(score)
        g = p - self.onehot
        h = _ftz(_ftz(_f32(self.factor, p) * p) * (1.0 - p))
        if self.weight is not None:
            g = g * self.weight[:, None]
            h = h * self.weight[:, None]
        return _ftz(g), _ftz(h)

    def boost_from_score(self, class_id: int = 0) -> float:
        # reference: multiclass_objective.hpp:154-156
        return float(np.log(max(K_EPSILON, self.class_init_probs[class_id])))

    def convert_output(self, raw):
        return softmax_f32(_as_f32(raw)).cpu().numpy()


class MulticlassOVA(ObjectiveFunction):
    """reference: multiclass_objective.hpp:184-280 (one binary objective a
    class)."""
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = self.num_class
        self.binaries = [
            BinaryLogloss(config,
                          is_pos=(lambda y, k=k: y.astype(np.int32) == k))
            for k in range(self.num_class)]

    def init(self, label, weight, groups=None, device="cpu"):
        super().init(label, weight, groups, device)
        for b in self.binaries:
            b.init(label, weight, device=device)

    def get_grad_hess(self, score):
        gs, hs = zip(*(b.get_grad_hess(score[:, k].contiguous())
                       for k, b in enumerate(self.binaries)))
        return torch.stack(gs, 1), torch.stack(hs, 1)

    def boost_from_score(self, class_id: int = 0) -> float:
        return self.binaries[class_id].boost_from_score(0)

    def convert_output(self, raw):
        return _sigmoid(raw, self.config.sigmoid)


# ------------------------------------------------------------ cross-entropy
class CrossEntropy(ObjectiveFunction):
    """reference: src/objective/xentropy_objective.hpp:44-147 (labels in
    [0, 1])."""
    name = "cross_entropy"

    def init(self, label, weight, groups=None, device="cpu"):
        if np.any((np.asarray(label) < 0) | (np.asarray(label) > 1)):
            log.fatal("[cross_entropy]: labels must be in [0, 1]")
        super().init(label, weight, groups, device)

    def get_grad_hess(self, score):
        z = _ftz(1.0 / (1.0 + exp_f32(-score)))
        g = z - self.label
        h = _ftz(z * (1.0 - z))
        return self._apply_weight(g, h)

    def boost_from_score(self, class_id: int = 0) -> float:
        w = (self.weight_np if self.weight_np is not None
             else np.ones(self.num_data))
        pavg = float(np.sum(self.label_np * w) / np.sum(w))
        pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, raw):
        return _sigmoid(raw, 1.0)


class CrossEntropyLambda(CrossEntropy):
    """reference: xentropy_objective.hpp:152-260 (the weighted 'lambda'
    variant). Unweighted it reduces to plain cross-entropy (:195-197); the
    weighted form uses z = 1 - exp(-w * log1p(exp(s)))."""
    name = "cross_entropy_lambda"

    def get_grad_hess(self, score):
        if self.weight is None:
            z = _ftz(1.0 / (1.0 + exp_f32(-score)))
            return z - self.label, _ftz(z * (1.0 - z))
        w, y = self.weight, self.label
        eps = _f32(K_EPSILON, score)
        es = exp_f32(score)
        enf = exp_f32(-score)
        hhat = log1p_f32(es)
        z = 1.0 - exp_f32(-w * hhat)
        zc = torch.maximum(z, eps)
        g = _ftz(_ftz((1.0 - y / zc) * w) / (1.0 + enf))
        c = 1.0 / (1.0 - zc)
        d = 1.0 + es
        a = _ftz(_ftz(w * es) / _ftz(d * d))
        b = _ftz(_ftz((c - 1.0) * w) / d) - c + 1.0
        h = _ftz(a * (1.0 + _ftz(y * b)))
        return g, h

    def boost_from_score(self, class_id: int = 0) -> float:
        w = (self.weight_np if self.weight_np is not None
             else np.ones(self.num_data))
        havg = float(np.sum(self.label_np * w) / np.sum(w))
        havg = max(havg, K_EPSILON)
        return (float(np.log(np.expm1(havg))) if havg > K_EPSILON
                else float(np.log(K_EPSILON)))

    def convert_output(self, raw):
        return log1p_f32(exp_f32(_as_f32(raw))).cpu().numpy()


_REGISTRY = {c.name: c for c in (
    RegressionL2, RegressionL1, RegressionHuber, RegressionFair,
    RegressionPoisson, RegressionQuantile, RegressionMAPE, RegressionGamma,
    RegressionTweedie, BinaryLogloss, MulticlassSoftmax, MulticlassOVA,
    CrossEntropy, CrossEntropyLambda)}


def create_objective(config) -> Optional[ObjectiveFunction]:
    """reference: src/objective/objective_function.cpp
    CreateObjectiveFunction. ``none``, ``null``, ``custom`` and ``na``
    name no built-in objective: None, the gradients then come from the
    caller (``train(..., fobj=...)``)."""
    if config.objective in ("none", "null", "custom", "na"):
        return None
    if config.objective in ("lambdarank", "rank_xendcg"):
        from .ranking import create_ranking_objective
        return create_ranking_objective(config)
    if config.objective not in _REGISTRY:
        raise NotImplementedError(
            f"objective={config.objective!r} is not ported to "
            f"lightgbm_tpu_torch; a custom objective is passed to train() "
            f"as fobj")
    return _REGISTRY[config.objective](config)
