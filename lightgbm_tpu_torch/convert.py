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
``bin_2_categorical``) and the objective. A model of K trees an iteration
(``multiclass``/``multiclassova`` with ``num_class`` K) lists its trees
iteration by iteration, class by class; an RF model's
``average_output`` averages its iterations. The port never sees a foreign
object: the caller converts to numpy first.

    booster = booster_from_numpy(trees, {
        "mappers": mappers_from_numpy(bounds, missing_types),
        "used_features": used, "objective": "binary", "sigmoid": 1.0,
        "device_type": "cuda"})
    booster.predict(X)

Prediction bins ``X`` with the carried mappers and traverses the carried
bin thresholds, accumulating in float64 in tree order.

``booster_to_numpy`` is the inverse for a booster the port trained on
unbundled data: its trees and mappers as the same numpy fields, e.g. to
carry a card booster's trees to a ``device_type="cpu"`` twin.
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
    non-trivial mappers), ``objective`` (any objective the port has),
    optional ``num_class``, ``sigmoid``, ``average_output``,
    ``feature_names``, ``device_type`` and ``params`` (the objective's
    own, e.g. ``alpha``)."""
    params = dict(meta.get("params") or {})
    params["objective"] = meta["objective"]
    for key in ("sigmoid", "num_class"):
        if key in meta:
            params[key] = meta[key]
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
    gbdt.num_tree_per_iteration = (
        gbdt.objective.num_model_per_iteration
        if gbdt.objective is not None else max(config.num_class, 1))
    gbdt.average_output = bool(meta.get("average_output", False))
    for fields in trees:
        arrays = tree_from_host_fields(fields)
        n = int(fields["num_leaves"]) - 1
        thr = np.zeros(arrays.node_threshold_bin.shape[0], np.float64)
        thr[:n] = np.asarray(fields["threshold"], np.float64)[:n]
        gbdt.trees.append(arrays)
        gbdt.host_trees.append(HostTree(
            arrays, thr, np.asarray(used, np.int32),
            np.asarray(fields.get("missing_type", np.zeros(n)), np.int8)))
    return Booster._wrap(params, config, gbdt)


_TREE_FIELDS = ("split_feature", "threshold_bin", "threshold", "default_left",
                "left_child", "right_child", "leaf_value", "leaf_weight",
                "leaf_count", "split_gain", "internal_value",
                "internal_weight", "internal_count", "leaf_depth",
                "leaf_parent", "missing_type", "is_cat", "cat_bitset")


def booster_to_numpy(booster: Booster, device_type: Optional[str] = None
                     ) -> tuple:
    """(trees, meta) of a booster the port trained, for
    ``booster_from_numpy``: each tree's HostTree fields as numpy, the bin
    mappers, used features, objective and parameters (``device_type``:
    where the carried booster runs; default the same device). A model of
    EFB bundles or linear leaves has no such form."""
    g = booster._boosting
    ds = g.train_set
    if ds.bundles is not None or g.config.linear_tree or g.loaded is not None:
        raise ValueError("booster_to_numpy carries plain trees only (no EFB "
                         "bundles, linear leaves or init model)")
    trees = []
    for ht in g.host_trees:
        fields = {k: np.array(getattr(ht, k)) for k in _TREE_FIELDS}
        fields["num_leaves"] = int(ht.num_leaves)
        fields["shrinkage"] = float(ht.shrinkage)
        trees.append(fields)
    cfg = g.config
    meta = {"mappers": list(ds.mappers),
            "used_features": np.asarray(ds.used_features, np.int32),
            "objective": cfg.objective, "num_class": cfg.num_class,
            "sigmoid": cfg.sigmoid, "average_output": g.average_output,
            "feature_names": ds.get_feature_names(),
            "params": cfg.to_params(),
            "device_type": device_type or cfg.device_type}
    return trees, meta
