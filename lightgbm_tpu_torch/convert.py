"""Carry trained models and bin mappers across as plain numpy arrays.

A model trained elsewhere (the JAX package, or an earlier run) comes in as
numpy: one dict per tree with the fields of ``HostTree`` (``num_leaves``,
``split_feature`` as used-feature indices, ``threshold_bin``,
``threshold``, ``default_left``, ``left_child``, ``right_child``,
``leaf_value``, ``leaf_weight``, ``leaf_count``, ``split_gain``,
``internal_value``/``_weight``/``_count``, ``leaf_depth``,
``leaf_parent``, ``shrinkage``, the per-node ``missing_type``, and for
categorical nodes ``is_cat`` and the bin bitset ``cat_bitset`` [nodes,
words]), plus the bin mappers (categorical ones with their
``bin_2_categorical``) and the objective. The port never sees a foreign object:
the caller converts to numpy first.

    booster = booster_from_numpy(trees, {
        "mappers": mappers_from_numpy(bounds, missing_types),
        "used_features": used, "objective": "binary", "sigmoid": 1.0,
        "device_type": "cuda"})
    booster.predict(X)

Prediction bins ``X`` with the carried mappers and traverses the carried
bin thresholds, accumulating in float64 in tree order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Dataset
from .binning import BIN_TYPE_CATEGORICAL, BinMapper
from .booster import Booster
from .config import Config
from .models.gbdt import GBDT
from .models.tree import HostTree, tree_from_host_fields


def mappers_from_numpy(bin_upper_bounds: Sequence[Sequence[float]],
                       missing_types: Sequence[int],
                       min_vals: Optional[Sequence[float]] = None,
                       max_vals: Optional[Sequence[float]] = None,
                       bin_2_categoricals: Optional[Sequence] = None
                       ) -> List[BinMapper]:
    """BinMappers from their bin upper bounds (the NaN bin's NaN bound
    included) and missing types; a one-bin mapper is trivial. A column
    whose ``bin_2_categoricals`` entry is a sequence (bin 0 = -1, then the
    category of each bin) is categorical, and its bounds are ignored."""
    out = []
    for j, (ub, mt) in enumerate(zip(bin_upper_bounds, missing_types)):
        m = BinMapper()
        cats = (None if bin_2_categoricals is None
                else bin_2_categoricals[j])
        if cats is not None:
            m.bin_type = BIN_TYPE_CATEGORICAL
            m.bin_2_categorical = [int(c) for c in cats]
            m.categorical_2_bin = {c: b for b, c in
                                   enumerate(m.bin_2_categorical)}
            m.num_bin = len(m.bin_2_categorical)
        else:
            m.bin_upper_bound = np.asarray(ub, np.float64)
            m.num_bin = len(m.bin_upper_bound)
        m.missing_type = int(mt)
        m.is_trivial = m.num_bin <= 1
        if not m.is_trivial:
            m.default_bin = m.value_to_bin(0.0)
        if min_vals is not None:
            m.min_val = float(min_vals[j])
        if max_vals is not None:
            m.max_val = float(max_vals[j])
        out.append(m)
    return out


def booster_from_numpy(trees: Sequence[Dict[str, Any]],
                       meta: Dict[str, Any]) -> Booster:
    """A port Booster over carried-across trees (see the module docstring).
    ``meta``: ``mappers`` (BinMapper list over all columns),
    ``used_features`` (column of each used-feature index; default: the
    non-trivial mappers), ``objective`` ("regression" or "binary"),
    optional ``sigmoid``, ``feature_names``, ``device_type`` and
    ``params``."""
    params = dict(meta.get("params") or {})
    params["objective"] = meta["objective"]
    if "sigmoid" in meta:
        params["sigmoid"] = meta["sigmoid"]
    if "device_type" in meta:
        params["device_type"] = meta["device_type"]
    config = Config.from_params(params)
    mappers = list(meta["mappers"])
    used = meta.get("used_features")
    if used is None:
        used = [j for j, m in enumerate(mappers) if not m.is_trivial]
    ds = Dataset.from_mappers(mappers, np.asarray(used, np.int32),
                              meta.get("feature_names"), params)
    gbdt = GBDT(config)
    gbdt.train_set = ds
    gbdt.device = ds.device
    from .objectives import create_objective
    gbdt.objective = create_objective(config)
    for fields in trees:
        arrays = tree_from_host_fields(fields)
        n = int(fields["num_leaves"]) - 1
        thr = np.zeros(arrays.node_threshold_bin.shape[0], np.float64)
        thr[:n] = np.asarray(fields["threshold"], np.float64)[:n]
        gbdt.trees.append(arrays)
        gbdt.host_trees.append(HostTree(
            arrays, thr, np.asarray(used, np.int32),
            np.asarray(fields.get("missing_type", np.zeros(n)), np.int8)))
    booster = Booster.__new__(Booster)
    booster.params = params
    booster.config = config
    booster.best_iteration = -1
    booster._train_set = None
    booster._boosting = gbdt
    return booster
