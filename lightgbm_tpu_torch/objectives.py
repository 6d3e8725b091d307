"""Objective functions: per-row gradients/hessians on the device.

The port of lightgbm_tpu's ``objectives.py`` for the slice's two
objectives (reference: src/objective/regression_objective.hpp RegressionL2loss,
src/objective/binary_objective.hpp BinaryLogloss). Gradients are float32
tensors on the run's device; ``boost_from_score`` is computed on the host
in float64 exactly as the JAX package does. ``exp`` is XLA:CPU's float32
``exp`` written out in PyTorch operations (``exp_f32``; ``torch.exp``
rounds differently), so binary gradients and converted outputs are bitwise
the JAX package's on the CPU, and the card computes the same bits.
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


class ObjectiveFunction:
    """Base objective (reference: include/LightGBM/objective_function.h)."""

    name = "base"
    num_model_per_iteration = 1

    def __init__(self, config):
        self.config = config

    def init(self, label: np.ndarray, weight: Optional[np.ndarray],
             device="cpu") -> None:
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


class RegressionL2(ObjectiveFunction):
    """reference: regression_objective.hpp:93-201 (RegressionL2loss)."""
    name = "regression"

    def get_grad_hess(self, score):
        return self._apply_weight(score - self.label, torch.ones_like(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        # reference: regression_objective.hpp:173-198 (weighted mean label)
        if self.weight_np is not None:
            return float(np.sum(self.label_np * self.weight_np)
                         / np.sum(self.weight_np))
        return float(np.mean(self.label_np))


class BinaryLogloss(ObjectiveFunction):
    """reference: src/objective/binary_objective.hpp:21-199."""
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid parameter {self.sigmoid} should be greater "
                      f"than zero")

    def init(self, label, weight, device="cpu"):
        super().init(label, weight, device)
        is_pos = self.label_np > 0
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
        r = torch.as_tensor(np.asarray(raw)).to(torch.float32)
        sig = torch.tensor(-self.sigmoid, dtype=torch.float32)
        return _ftz(1.0 / (1.0 + exp_f32(sig * r))).numpy()


_REGISTRY = {c.name: c for c in (RegressionL2, BinaryLogloss)}


def create_objective(config) -> ObjectiveFunction:
    """reference: src/objective/objective_function.cpp
    CreateObjectiveFunction (regression and binary in this slice; Config
    rejects the others)."""
    if config.objective not in _REGISTRY:
        raise NotImplementedError(
            f"objective={config.objective!r} is not ported to "
            f"lightgbm_tpu_torch yet; it arrives with ROADMAP.md Queue 1 "
            f"item 10 (boosting modes and objectives)")
    return _REGISTRY[config.objective](config)
