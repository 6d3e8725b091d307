"""Gradient-based One-Side Sampling (reference: src/boosting/goss.hpp).

The port of lightgbm_tpu's ``models/goss.py``. Rows are ranked by
|grad * hess| (summed over classes); the ``top_rate`` fraction with the
largest values is kept, ``other_rate`` of the rest is drawn and its
gradients amplified by ``(n - top_k) / other_k`` (goss.hpp:119-121), the
others are dropped for the iteration. No sampling happens in the first
``int(1 / learning_rate)`` iterations (goss.hpp:158-160).

The selection is the JAX package's, draw for draw: the threshold is the
k-th largest score; ties at it are broken by 31-bit draws of
``bits(fold_in(PRNGKey(bagging_seed), iter), [N])`` and the rest sampled
by the draws of ``fold_in(key, 1)``, each ranked by a stable sort (draw
collisions resolved by row index), so exactly ``top_k`` and
``min(other_k, n - top_k)`` rows are kept.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..utils import log
from ..utils.random import bits, fold_in, prng_key, stable_ranks
from .gbdt import GBDT

_MAXU = 0xFFFFFFFF


def goss_weights(score: torch.Tensor, key: torch.Tensor, top_k: int,
                 other_k: int) -> torch.Tensor:
    """Per-row weights [N] float32: 1 for the top rows, the amplification
    for the sampled rest, 0 for the dropped (JAX ``goss_weights_impl``)."""
    n = score.shape[0]
    dev = score.device
    t = torch.sort(score).values[n - top_k]     # the k-th largest value
    strict = score > t
    c1 = int(strict.sum())
    tie = score == t
    r = bits(key, (n,), device=dev) >> 1
    rt = torch.where(tie, r, torch.full_like(r, _MAXU))
    is_top = strict | (tie & (stable_ranks(rt) < top_k - c1))
    rest = ~is_top
    r2 = bits(fold_in(key, 1), (n,), device=dev) >> 1
    rr = torch.where(rest, r2, torch.full_like(r2, _MAXU))
    kk = min(other_k, n - top_k)
    pick = rest & (stable_ranks(rr) < kk)
    multiply = torch.tensor((n - top_k) / other_k, dtype=torch.float32,
                            device=dev)
    return is_top.to(torch.float32) + pick.to(torch.float32) * multiply


class GOSS(GBDT):
    """reference: goss.hpp:25 ``class GOSS: public GBDT``."""

    name = "goss"

    def __init__(self, config, train_set=None, objective=None):
        if config.top_rate + config.other_rate > 1.0:
            log.fatal("top_rate + other_rate cannot be larger than 1.0")
        if config.top_rate <= 0.0 or config.other_rate <= 0.0:
            log.fatal("top_rate and other_rate must be positive")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        log.info("Using GOSS")
        super().__init__(config, train_set, objective)
        self.sampled_iterations: List[int] = []   # iterations that sampled

    # ------------------------------------------------- checkpoint/resume
    def get_trainer_state(self) -> dict:
        """GOSS adds nothing stateful: its key is ``fold_in(PRNGKey(
        bagging_seed), iter)`` and its warm-up depends on ``iter`` alone.
        The seed is recorded so a tampered sidecar cannot resample."""
        state = super().get_trainer_state()
        state["goss"] = {"bagging_seed": int(self.config.bagging_seed),
                         "sampled_iterations": list(self.sampled_iterations)}
        return state

    def set_trainer_state(self, state: dict) -> None:
        super().set_trainer_state(state)
        g = state.get("goss", {})
        seed = g.get("bagging_seed")
        if seed is not None and int(seed) != int(self.config.bagging_seed):
            log.fatal(f"checkpoint GOSS bagging_seed {seed} does not match "
                      f"this run's {self.config.bagging_seed}")
        self.sampled_iterations = list(g.get("sampled_iterations", []))

    def _sample_weights(self, g, h) -> Optional[torch.Tensor]:
        """reference: goss.hpp:105-150 BaggingHelper."""
        cfg = self.config
        if self.iter < int(1.0 / cfg.learning_rate):
            return None
        if g.dim() > 1:
            a = torch.abs(g * h)
            score = torch.zeros_like(a[:, 0])
            for c in range(a.shape[1]):       # the K terms left to right
                score = score + a[:, c]
        else:
            score = torch.abs(g * h)
        n = score.shape[0]
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        key = fold_in(prng_key(cfg.bagging_seed), self.iter)
        self.sampled_iterations.append(self.iter)
        return goss_weights(score, key, top_k, other_k)
