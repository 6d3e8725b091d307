"""Boosting factory (reference: src/boosting/boosting.cpp
CreateBoosting)."""

from __future__ import annotations

from ..utils import log
from .gbdt import GBDT


def create_boosting(config, train_set=None):
    """The booster ``config.boosting`` names: gbdt, goss, dart or rf."""
    name = config.boosting
    if name == "gbdt":
        return GBDT(config, train_set)
    if name == "dart":
        from .dart import DART
        return DART(config, train_set)
    if name == "goss":
        from .goss import GOSS
        return GOSS(config, train_set)
    if name == "rf":
        from .rf import RF
        return RF(config, train_set)
    log.fatal(f"Unknown boosting type: {name}")
