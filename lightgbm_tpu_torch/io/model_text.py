"""Model text serialization (v3 format), numerical and categorical trees.

The port of lightgbm_tpu's ``io/model_text.py`` for the slice: dump and
load of the reference's ``version=v3`` text (reference:
src/boosting/gbdt_model_text.cpp:311-520, src/io/tree.cpp:336-410 and
:653+): header key=values, per-tree blocks with real-valued thresholds and
packed ``decision_type`` bytes (categorical bit | default-left bit |
missing-type << 2, reference tree.h:19-20,269), the categorical nodes'
category-value bitsets (``cat_boundaries``/``cat_threshold``, built from
the mappers' ``bin_2_categorical``), feature importances and the echoed
parameters block. The dump is character for character the JAX package's
for the same trees. A loaded model predicts by traversing real thresholds
and category bitsets over raw features, with no bin mappers, like the
reference. Multiclass models hold K trees an iteration (tree i is class
i % K) and an RF model (``average_output``) averages its iterations. A
categorical node's bitset has as many words as its largest category
needs; a model trained on a DataFrame with ``category`` columns ends with
the ``pandas_categorical:`` line (the category lists as JSON, the
reference python package's last line), which a loaded model reads back to
code a DataFrame's categories as training did. A linear tree
(``is_linear=1``) carries each leaf's const, its original feature indices
and coefficients (``leaf_const``, ``num_features``, ``leaf_features``,
``leaf_coeff``, with the JAX package's spacing) and predicts const +
coeff . x, a row with NaN or inf in one of its leaf's features taking the
plain leaf value. A continued model's text opens with its init model's
tree blocks as loaded; ``dump_model_json`` gives the reference's JSON
dump (``Booster.dump_model``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..binning import (BIN_TYPE_CATEGORICAL, K_ZERO_THRESHOLD, MISSING_NAN,
                       MISSING_NONE, MISSING_ZERO)
from ..config import Config
from ..utils import log

K_MODEL_VERSION = "v3"   # reference: gbdt_model_text.cpp:19 kModelVersion
_CAT_MASK = 1            # reference: tree.h:19 kCategoricalMask
_DEFAULT_LEFT_MASK = 2   # reference: tree.h:20 kDefaultLeftMask


def _d2s(v: float) -> str:
    """Shortest round-trip decimal for a double."""
    return repr(float(v))


def _join(arr, fmt=str) -> str:
    return " ".join(fmt(x) for x in arr)


class ModelTree:
    """One tree in model-text (real-value) space: original feature indices,
    real thresholds, packed decision types; numpy arrays throughout."""

    def __init__(self):
        self.num_leaves = 1
        self.num_cat = 0
        self.split_feature = np.zeros(0, np.int32)
        self.split_gain = np.zeros(0, np.float64)
        self.threshold = np.zeros(0, np.float64)
        self.decision_type = np.zeros(0, np.int8)
        self.left_child = np.zeros(0, np.int32)
        self.right_child = np.zeros(0, np.int32)
        self.leaf_value = np.zeros(1, np.float64)
        self.leaf_weight = np.zeros(1, np.float64)
        self.leaf_count = np.zeros(1, np.int64)
        self.internal_value = np.zeros(0, np.float64)
        self.internal_weight = np.zeros(0, np.float64)
        self.internal_count = np.zeros(0, np.int64)
        self.cat_boundaries = np.zeros(1, np.int32)   # [num_cat + 1]
        self.cat_threshold = np.zeros(0, np.uint32)
        self.is_linear = False
        self.leaf_const = np.zeros(0, np.float64)
        self.leaf_features: List[List[int]] = []
        self.leaf_coeff: List[List[float]] = []
        self.shrinkage = 1.0

    @classmethod
    def from_host(cls, ht, mappers) -> "ModelTree":
        """A trained HostTree (bin space) in model space. ``mappers``: the
        dataset's BinMappers by original feature; a categorical node's
        bin bitset becomes a bitset over category values (the reference's
        cat_threshold, tree.h:349-360)."""
        t = cls()
        n = ht.num_leaves - 1
        t.num_leaves = ht.num_leaves
        t.split_feature = np.array(
            [int(ht.feature_indices[f]) for f in ht.split_feature], np.int32)
        t.split_gain = np.asarray(ht.split_gain, np.float64)
        t.threshold = np.asarray(ht.threshold, np.float64).copy()
        t.left_child = np.asarray(ht.left_child, np.int32)
        t.right_child = np.asarray(ht.right_child, np.int32)
        t.leaf_value = np.asarray(ht.leaf_value, np.float64)
        t.leaf_weight = np.asarray(ht.leaf_weight, np.float64)
        t.leaf_count = np.asarray(np.round(ht.leaf_count), np.int64)
        t.internal_value = np.asarray(ht.internal_value, np.float64)
        t.internal_weight = np.asarray(ht.internal_weight, np.float64)
        t.internal_count = np.asarray(np.round(ht.internal_count), np.int64)
        t.shrinkage = ht.shrinkage
        dt = np.zeros(n, np.int8)
        cat_boundaries, cat_words = [0], []
        for i in range(n):
            d = 0
            if bool(ht.is_cat[i]):
                d |= _CAT_MASK
                mapper = mappers[t.split_feature[i]]
                nbits = min(mapper.num_bin, ht.cat_bitset.shape[1] * 32)
                cats = [mapper.bin_2_categorical[b] for b in range(nbits)
                        if (int(ht.cat_bitset[i, b >> 5]) >> (b & 31)) & 1
                        and mapper.bin_2_categorical[b] >= 0]
                words = [0] * ((max(cats) if cats else 0) // 32 + 1)
                for cval in cats:
                    words[cval >> 5] |= 1 << (cval & 31)
                t.threshold[i] = t.num_cat      # index into cat_boundaries
                t.num_cat += 1
                cat_words.extend(words)
                cat_boundaries.append(len(cat_words))
            if bool(ht.default_left[i]):
                d |= _DEFAULT_LEFT_MASK
            dt[i] = d | (int(ht.missing_type[i]) << 2)
        t.decision_type = dt
        t.cat_boundaries = np.asarray(cat_boundaries, np.int32)
        t.cat_threshold = np.asarray(cat_words, np.uint32)
        if ht.is_linear:
            t.is_linear = True
            t.leaf_const = np.asarray(ht.leaf_const, np.float64)
            t.leaf_coeff = [list(map(float, c)) for c in ht.leaf_coeff]
            t.leaf_features = [list(map(int, fs))
                               for fs in ht.leaf_features_raw]
        return t

    def to_string(self) -> str:
        """Tree block body (reference: tree.cpp:336-410 Tree::ToString)."""
        n = self.num_leaves - 1
        lines = [
            f"num_leaves={self.num_leaves}",
            f"num_cat={self.num_cat}",
            "split_feature=" + _join(self.split_feature),
            "split_gain=" + _join(self.split_gain, _d2s),
            "threshold=" + _join(self.threshold, _d2s),
            "decision_type=" + _join(self.decision_type),
            "left_child=" + _join(self.left_child),
            "right_child=" + _join(self.right_child),
            "leaf_value=" + _join(self.leaf_value[:self.num_leaves], _d2s),
            "leaf_weight=" + _join(self.leaf_weight[:self.num_leaves], _d2s),
            "leaf_count=" + _join(self.leaf_count[:self.num_leaves]),
            "internal_value=" + _join(self.internal_value[:n], _d2s),
            "internal_weight=" + _join(self.internal_weight[:n], _d2s),
            "internal_count=" + _join(self.internal_count[:n]),
        ]
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + _join(self.cat_boundaries))
            lines.append("cat_threshold=" + _join(self.cat_threshold))
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            lines.append("leaf_const=" + _join(self.leaf_const, _d2s))
            lines.append("num_features=" + _join(
                [len(f) for f in self.leaf_features]))
            lines.append("leaf_features=" + " ".join(
                (_join(f) + " ") if f else ""
                for f in self.leaf_features).rstrip() + " ")
            lines.append("leaf_coeff=" + " ".join(
                (_join(c, _d2s) + " ") if c else ""
                for c in self.leaf_coeff).rstrip() + " ")
        lines.append(f"shrinkage={_d2s(self.shrinkage)}")
        return "\n".join(lines) + "\n\n"

    @classmethod
    def from_kv(cls, kv: Dict[str, str]) -> "ModelTree":
        """Parse one tree block (reference: tree.cpp:653+); every section is
        checked for presence, length and parseability."""
        t = cls()
        if "num_leaves" not in kv:
            raise ValueError("missing 'num_leaves' section")
        t.num_leaves = int(kv["num_leaves"])
        if t.num_leaves < 1:
            raise ValueError(f"invalid num_leaves={t.num_leaves}")
        t.num_cat = int(kv.get("num_cat", "0"))
        n = t.num_leaves - 1

        def arr(key, dtype, count):
            s = kv.get(key, "")
            if not s.strip():
                return np.zeros(count, dtype)
            try:
                out = np.asarray(s.split(), dtype=dtype)
            except (ValueError, OverflowError) as e:
                raise ValueError(f"unparseable '{key}' section: {e}")
            if len(out) != count:
                raise ValueError(f"'{key}' section has {len(out)} values, "
                                 f"expected {count}")
            return out

        t.split_feature = arr("split_feature", np.int32, n)
        t.split_gain = arr("split_gain", np.float64, n)
        t.threshold = arr("threshold", np.float64, n)
        t.decision_type = arr("decision_type", np.int8, n)
        t.left_child = arr("left_child", np.int32, n)
        t.right_child = arr("right_child", np.int32, n)
        t.leaf_value = arr("leaf_value", np.float64, t.num_leaves)
        t.leaf_weight = arr("leaf_weight", np.float64, t.num_leaves)
        t.leaf_count = arr("leaf_count", np.int64, t.num_leaves)
        t.internal_value = arr("internal_value", np.float64, n)
        t.internal_weight = arr("internal_weight", np.float64, n)
        t.internal_count = arr("internal_count", np.int64, n)
        if t.num_cat > 0:
            t.cat_boundaries = arr("cat_boundaries", np.int32, t.num_cat + 1)
            if "cat_threshold" not in kv:
                raise ValueError("missing 'cat_threshold' section")
            t.cat_threshold = np.asarray(kv["cat_threshold"].split(),
                                         dtype=np.uint64).astype(np.uint32)
        t.is_linear = bool(int(kv.get("is_linear", "0")))
        if t.is_linear:
            t.leaf_const = arr("leaf_const", np.float64, t.num_leaves)
            nf = arr("num_features", np.int32, t.num_leaves)
            feats = kv.get("leaf_features", "").split()
            coefs = kv.get("leaf_coeff", "").split()
            total = int(np.sum(nf))
            if len(feats) < total or len(coefs) < total:
                raise ValueError(
                    f"'leaf_features'/'leaf_coeff' sections hold "
                    f"{len(feats)}/{len(coefs)} values, expected {total}")
            pos = 0
            for c in nf:
                t.leaf_features.append([int(x) for x in feats[pos:pos + c]])
                t.leaf_coeff.append([float(x) for x in coefs[pos:pos + c]])
                pos += c
        t.shrinkage = float(kv.get("shrinkage", "1"))
        return t

    def _go_left(self, nd: np.ndarray, fval: np.ndarray) -> np.ndarray:
        """Split decision for nodes ``nd`` on raw values ``fval``
        (reference: tree.h:320-360 NumericalDecision and
        CategoricalDecision)."""
        dt = self.decision_type[nd]
        missing_type = (dt.astype(np.int32) >> 2) & 3
        default_left = (dt & _DEFAULT_LEFT_MASK) > 0
        is_cat = (dt & _CAT_MASK) > 0
        # NaN with non-NaN missing handling is treated as 0.0 (tree.h:330)
        fv = np.where(np.isnan(fval) & (missing_type != MISSING_NAN), 0.0,
                      fval)
        is_missing = (((missing_type == MISSING_ZERO)
                       & (np.abs(fv) <= K_ZERO_THRESHOLD))
                      | ((missing_type == MISSING_NAN) & np.isnan(fv)))
        with np.errstate(invalid="ignore"):
            num_left = np.where(is_missing, default_left,
                                fv <= self.threshold[nd])
        if not is_cat.any():
            return num_left
        # categorical: int(fval) in the node's category bitset; NaN and
        # negative values go right
        cat_left = np.zeros(len(nd), dtype=bool)
        for i in np.nonzero(is_cat)[0]:
            ci = int(self.threshold[nd[i]])
            lo, hi = self.cat_boundaries[ci], self.cat_boundaries[ci + 1]
            v = fval[i]
            if np.isnan(v) or v < 0:
                continue
            iv = int(v)
            if (iv >> 5) < hi - lo:
                cat_left[i] = bool((int(self.cat_threshold[lo + (iv >> 5)])
                                    >> (iv & 31)) & 1)
        return np.where(is_cat, cat_left, num_left)

    def leaf_index(self, X: np.ndarray) -> np.ndarray:
        """Per-row leaf index over raw features [N, F]."""
        n = X.shape[0]
        out = np.zeros(n, np.int32)
        if self.num_leaves <= 1:
            return out
        cur = np.zeros(n, np.int32)
        active = np.ones(n, dtype=bool)
        while active.any():
            idx = np.nonzero(active)[0]
            nd = cur[idx]
            left = self._go_left(nd, X[idx, self.split_feature[nd]])
            nxt = np.where(left, self.left_child[nd], self.right_child[nd])
            cur[idx] = nxt
            done = nxt < 0
            out[idx[done]] = ~nxt[done]
            active[idx[done]] = False
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaf = self.leaf_index(X)
        out = self.leaf_value[leaf]
        if not self.is_linear:
            return out
        # linear leaves: const + sum(coeff * feature); a row with NaN or inf
        # in one of its leaf's features takes the plain leaf value
        # (linear_tree_learner.cpp:19-41)
        lin = np.asarray(self.leaf_const)[leaf].copy()
        ok = np.ones(len(leaf), dtype=bool)
        for li in range(self.num_leaves):
            rows = leaf == li
            if not rows.any() or not self.leaf_features[li]:
                continue
            feats = np.asarray(self.leaf_features[li], np.int64)
            coefs = np.asarray(self.leaf_coeff[li], np.float64)
            vals = X[np.ix_(rows, feats)]
            bad = np.isnan(vals).any(axis=1) | np.isinf(vals).any(axis=1)
            lin[rows] += np.where(bad, 0.0, vals @ coefs)
            ok[rows] &= ~bad
        return np.where(ok, lin, out)

    def to_json_node(self, index: int = 0) -> dict:
        """Nested node dict (reference: tree.cpp:412-520 Tree::ToJSON)."""
        if self.num_leaves == 1:
            return {"leaf_value": float(self.leaf_value[0])}
        if index < 0:
            li = ~index
            return {"leaf_index": int(li),
                    "leaf_value": float(self.leaf_value[li]),
                    "leaf_weight": float(self.leaf_weight[li]),
                    "leaf_count": int(self.leaf_count[li])}
        dt = int(self.decision_type[index])
        is_cat = bool(dt & _CAT_MASK)
        return {
            "split_index": int(index),
            "split_feature": int(self.split_feature[index]),
            "split_gain": float(self.split_gain[index]),
            "threshold": (self._cat_json_threshold(index) if is_cat
                          else float(self.threshold[index])),
            "decision_type": "==" if is_cat else "<=",
            "default_left": bool(dt & _DEFAULT_LEFT_MASK),
            "missing_type": {MISSING_NONE: "None", MISSING_ZERO: "Zero",
                             MISSING_NAN: "NaN"}[(dt >> 2) & 3],
            "internal_value": float(self.internal_value[index]),
            "internal_weight": float(self.internal_weight[index]),
            "internal_count": int(self.internal_count[index]),
            "left_child": self.to_json_node(int(self.left_child[index])),
            "right_child": self.to_json_node(int(self.right_child[index])),
        }

    def _cat_json_threshold(self, index: int) -> str:
        """A categorical node's categories, ``||``-joined."""
        ci = int(self.threshold[index])
        lo, hi = int(self.cat_boundaries[ci]), int(self.cat_boundaries[ci + 1])
        return "||".join(str((w - lo) * 32 + b) for w in range(lo, hi)
                         for b in range(32)
                         if (int(self.cat_threshold[w]) >> b) & 1)


# ===================================================================== dump
def _objective_string(config: Config) -> Optional[str]:
    """The model text's ``objective=`` line (the JAX package's)."""
    obj = config.objective
    if obj in ("none", "", None):
        return None
    args = {"binary": f"sigmoid:{config.sigmoid:g}",
            "multiclass": f"num_class:{config.num_class}",
            "multiclassova": f"num_class:{config.num_class} "
                             f"sigmoid:{config.sigmoid:g}",
            "quantile": f"alpha:{config.alpha:g}",
            "huber": f"alpha:{config.alpha:g}",
            "fair": f"c:{config.fair_c:g}",
            "tweedie": f"tweedie_variance_power:"
                       f"{config.tweedie_variance_power:g}"}.get(obj)
    return obj if args is None else f"{obj} {args}"


def _parse_objective(obj_str: str, config: Config) -> None:
    """Apply a model's ``objective=`` line to the config (the inverse of
    ``_objective_string``)."""
    from ..config import _OBJECTIVE_ALIASES
    toks = obj_str.split()
    if not toks:
        return
    config.objective = _OBJECTIVE_ALIASES.get(toks[0], toks[0])
    for tok in toks[1:]:
        key, _, val = tok.partition(":")
        key = {"c": "fair_c"}.get(key, key)     # fair's dump writes `c:`
        if key == "num_class":
            config.num_class = int(val)
        elif key in ("sigmoid", "alpha", "fair_c", "tweedie_variance_power"):
            setattr(config, key, float(val))


def _feature_infos(mappers) -> List[str]:
    """Per-feature info strings (reference: bin.h:190-199): the value
    range, or the categories of a categorical feature."""
    infos = []
    for m in mappers:
        if m.is_trivial:
            infos.append("none")
        elif m.bin_type == BIN_TYPE_CATEGORICAL:
            infos.append(":".join(str(c) for c in m.bin_2_categorical
                                  if c >= 0))
        else:
            infos.append(f"[{m.min_val:.17g}:{m.max_val:.17g}]")
    return infos


def _collect(boosting, num_iteration: int = -1, start_iteration: int = 0
             ) -> Tuple[dict, List[ModelTree]]:
    """Header metadata + ModelTree list of a trained GBDT (an init model's
    trees first) or a LoadedGBDT, cut to the [start, start + num) iteration
    window (reference: gbdt_model_text.cpp:343-356)."""
    if isinstance(boosting, LoadedGBDT):
        meta = dict(boosting.meta)
        all_trees = list(boosting.trees)
    else:
        cfg = boosting.config
        ds = boosting.train_set
        meta = {
            "num_class": boosting.num_class,
            "num_tree_per_iteration": boosting.num_tree_per_iteration,
            "label_index": 0,
            "max_feature_idx": ds.num_total_features - 1,
            "objective": _objective_string(cfg),
            "average_output": boosting.average_output,
            "feature_names": ds.get_feature_names(),
            "monotone_constraints": list(cfg.monotone_constraints),
            "feature_infos": _feature_infos(ds.mappers),
            "parameters": cfg.to_params(),
            "pandas_categorical": {int(k): list(v) for k, v in
                                   ds.pandas_categorical.items()},
        }
        all_trees = list(boosting.loaded.trees) if boosting.loaded \
            is not None else []
        all_trees += [ModelTree.from_host(ht, ds.mappers)
                      for ht in boosting.host_trees]
    k = max(meta["num_tree_per_iteration"], 1)
    total = len(all_trees) // k
    start = min(max(start_iteration, 0), total)
    end = (min(start + num_iteration, total)
           if num_iteration is not None and num_iteration > 0 else total)
    return meta, all_trees[start * k:end * k]


def dump_model_text(boosting, num_iteration: int = -1,
                    start_iteration: int = 0) -> str:
    """Serialize to the v3 text format (gbdt_model_text.cpp:311-403)."""
    meta, trees = _collect(boosting, num_iteration, start_iteration)
    out = ["tree", f"version={K_MODEL_VERSION}",
           f"num_class={meta['num_class']}",
           f"num_tree_per_iteration={meta['num_tree_per_iteration']}",
           f"label_index={meta['label_index']}",
           f"max_feature_idx={meta['max_feature_idx']}"]
    if meta.get("objective"):
        out.append(f"objective={meta['objective']}")
    if meta.get("average_output"):
        out.append("average_output")
    out.append("feature_names=" + " ".join(meta["feature_names"]))
    if meta.get("monotone_constraints"):
        out.append("monotone_constraints=" + " ".join(
            str(m) for m in meta["monotone_constraints"]))
    out.append("feature_infos=" + " ".join(meta["feature_infos"]))
    tree_strs = [f"Tree={i}\n" + t.to_string() + "\n"
                 for i, t in enumerate(trees)]
    out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    out.append("")
    body = "\n".join(out) + "\n" + "".join(tree_strs) + "end of trees\n"

    # feature importances, sorted descending (gbdt_model_text.cpp:370-392)
    imp = np.zeros(meta["max_feature_idx"] + 1, np.float64)
    for t in trees:
        for f in t.split_feature:
            imp[f] += 1
    pairs = [(int(imp[i]), meta["feature_names"][i])
             for i in range(len(imp)) if imp[i] > 0]
    pairs.sort(key=lambda p: -p[0])
    body += "\nfeature_importances:\n"
    for cnt, name in pairs:
        body += f"{name}={cnt}\n"

    params = meta.get("parameters")
    if params:
        body += "\nparameters:\n"
        for key, val in params.items():
            if isinstance(val, (list, tuple)):
                val = ",".join(str(v) for v in val)
            body += f"[{key}: {val}]\n"
        body += "end of parameters\n"
    pc = meta.get("pandas_categorical")
    if pc:
        import json
        body += "\npandas_categorical:" + json.dumps(
            {str(k): v for k, v in pc.items()}) + "\n"
    return body


def dump_model_json(boosting, num_iteration: int = -1,
                    start_iteration: int = 0) -> dict:
    """JSON model dump (reference: gbdt_model_text.cpp:26-116 DumpModel)."""
    meta, trees = _collect(boosting, num_iteration, start_iteration)
    return {
        "name": "tree",
        "version": K_MODEL_VERSION,
        "num_class": meta["num_class"],
        "num_tree_per_iteration": meta["num_tree_per_iteration"],
        "label_index": meta["label_index"],
        "max_feature_idx": meta["max_feature_idx"],
        "objective": meta.get("objective") or "",
        "average_output": bool(meta.get("average_output")),
        "feature_names": meta["feature_names"],
        "monotone_constraints": meta.get("monotone_constraints", []),
        "feature_infos": dict(zip(meta["feature_names"],
                                  meta["feature_infos"])),
        "tree_info": [{"tree_index": i, "num_leaves": t.num_leaves,
                       "num_cat": t.num_cat, "shrinkage": t.shrinkage,
                       "tree_structure": t.to_json_node(0)}
                      for i, t in enumerate(trees)],
    }


# ===================================================================== load
class LoadedGBDT:
    """A model restored from text: predicts over raw features through real
    thresholds (reference: GBDT::LoadModelFromString)."""

    def __init__(self, meta: dict, trees: List[ModelTree], config: Config):
        from ..objectives import create_objective
        self.meta = meta
        self.trees = trees
        self.config = config
        self.num_class = meta["num_class"]
        self.num_tree_per_iteration = max(meta["num_tree_per_iteration"], 1)
        self.average_output = bool(meta.get("average_output"))
        self.feature_names = meta["feature_names"]
        self.max_feature_idx = meta["max_feature_idx"]
        try:
            self.objective = create_objective(config)
        except NotImplementedError:
            self.objective = None

    @property
    def num_iteration(self) -> int:
        return len(self.trees) // self.num_tree_per_iteration

    @property
    def num_trees(self) -> int:
        return len(self.trees)

    def current_iteration(self) -> int:
        return self.num_iteration

    def _check_features(self, X) -> np.ndarray:
        """Raw rows as a float64 matrix of the model's width: a DataFrame's
        category columns as the training codes (the model's
        ``pandas_categorical`` lists; an unseen category is NaN), sparse
        rows densified."""
        pc = self.meta.get("pandas_categorical") or {}
        if hasattr(X, "dtypes") and pc:
            import pandas as pd
            X = X.copy()
            for ci, col in enumerate(X.columns):
                cats = pc.get(ci)
                if cats is not None and str(X[col].dtype) == "category":
                    codes = np.asarray(pd.Categorical(X[col],
                                                      categories=cats).codes)
                    X[col] = np.where(codes >= 0, codes.astype(np.float64),
                                      np.nan)
        if hasattr(X, "values"):
            X = X.values
        if hasattr(X, "toarray"):
            X = X.toarray()
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] != self.max_feature_idx + 1:
            log.fatal(f"The number of features in data ({X.shape[1]}) is not "
                      f"the same as it was in training data "
                      f"({self.max_feature_idx + 1}).")
        return X

    def _window(self, num_iteration, start_iteration) -> Tuple[int, int]:
        total = self.num_iteration
        start = min(max(start_iteration, 0), total)
        end = (min(start + num_iteration, total)
               if num_iteration is not None and num_iteration > 0 else total)
        return start, end

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Raw scores over raw rows on the host, tree by tree in float64,
        with margin-based early stop (none for an averaged model)."""
        from ..models.gbdt import _accumulate_active, _early_stop_mask
        X = self._check_features(X)
        k = self.num_tree_per_iteration
        start, end = self._window(num_iteration, start_iteration)
        out = np.zeros((X.shape[0], k), np.float64)
        active = np.ones(X.shape[0], dtype=bool)
        es = pred_early_stop and not self.average_output
        for it in range(start, end):
            for c in range(k):
                _accumulate_active(out, c, self.trees[it * k + c].predict(X),
                                   active, es)
            if es and (it - start + 1) % pred_early_stop_freq == 0:
                active &= ~_early_stop_mask(out, k, pred_early_stop_margin)
                if not active.any():
                    break
        if self.average_output:
            out /= max(end - start, 1)
        return out if k > 1 else out[:, 0]

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                start_iteration: int = 0, **kwargs) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration, start_iteration, **kwargs)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw.astype(np.float32))

    def predict_leaf(self, X, num_iteration: Optional[int] = None,
                     start_iteration: int = 0) -> np.ndarray:
        """[N, trees] leaf index of every row in every tree of the window."""
        X = self._check_features(X)
        k = self.num_tree_per_iteration
        start, end = self._window(num_iteration, start_iteration)
        cols = [t.leaf_index(X) for t in self.trees[start * k:end * k]]
        return (np.stack(cols, axis=1) if cols
                else np.zeros((X.shape[0], 0), np.int32))

    def predict_contrib(self, X, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> np.ndarray:
        """SHAP contributions [N, (F + 1) * K] of the window's trees, the
        DP in float64 on the CPU (a file-loaded model lives on the
        host)."""
        from .shap import predict_contrib_trees
        X = self._check_features(X)
        k = self.num_tree_per_iteration
        start, end = self._window(num_iteration, start_iteration)
        return predict_contrib_trees(self.trees[start * k:end * k], X,
                                     self.max_feature_idx + 1, k,
                                     average=self.average_output)

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        imp = np.zeros(self.max_feature_idx + 1, np.float64)
        for t in self.trees:
            for i in range(t.num_leaves - 1):
                imp[t.split_feature[i]] += (
                    1.0 if importance_type == "split"
                    else max(float(t.split_gain[i]), 0.0))
        return imp

    def eval_set(self, feval=None):
        log.fatal("Booster loaded from a model file has no attached data to "
                  "evaluate")

    def train_one_iter(self, grad=None, hess=None):
        log.fatal("Cannot continue training a loaded Booster directly; pass "
                  "it as init_model to train()")


def load_model(model_str: str, config: Optional[Config] = None) -> LoadedGBDT:
    """Parse a v3 model text (gbdt_model_text.cpp:417-520). Truncated or
    garbled input fails naming the tree block and section."""
    config = config or Config()
    lines = model_str.split("\n")
    kv: Dict[str, str] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree=") or line == "end of trees":
            break
        if line and "=" in line:
            key, val = line.split("=", 1)
            kv[key] = val
        elif line == "average_output":
            kv["average_output"] = "1"
        i += 1
    trees: List[ModelTree] = []
    saw_end = False
    while i < len(lines):
        line = lines[i].strip()
        if line == "end of trees":
            saw_end = True
            break
        if not line.startswith("Tree="):
            i += 1
            continue
        tree_line = i + 1
        tkv: Dict[str, str] = {}
        i += 1
        while i < len(lines):
            tl = lines[i].strip()
            if not tl or tl.startswith("Tree=") or tl == "end of trees":
                break
            if "=" in tl:
                key, val = tl.split("=", 1)
                tkv[key] = val
            i += 1
        try:
            trees.append(ModelTree.from_kv(tkv))
        except ValueError as e:
            log.fatal(f"corrupt or truncated model file: tree block "
                      f"{len(trees)} (line {tree_line}): {e}")
    if not saw_end:
        log.fatal(f"corrupt or truncated model file: missing the 'end of "
                  f"trees' sentinel after {len(trees)} complete tree blocks")
    params: Dict[str, str] = {}
    pandas_categorical: Dict[int, list] = {}
    in_params = False
    for line in lines[i:]:
        line = line.strip()
        if line == "parameters:":
            in_params = True
        elif line == "end of parameters":
            in_params = False
        elif in_params and line.startswith("[") and ":" in line:
            key, val = line[1:-1].split(":", 1)
            params[key.strip()] = val.strip()
        elif line.startswith("pandas_categorical:"):
            import json
            try:
                parsed = json.loads(line[len("pandas_categorical:"):])
            except ValueError:
                parsed = None
            if isinstance(parsed, dict):
                pandas_categorical = {int(k): v for k, v in parsed.items()}
    try:
        if "objective" in kv:
            _parse_objective(kv["objective"], config)
        if "num_class" in kv:
            config.num_class = int(kv["num_class"])
        meta = {
            "num_class": int(kv.get("num_class", "1")),
            "num_tree_per_iteration": int(kv.get("num_tree_per_iteration",
                                                 "1")),
            "label_index": int(kv.get("label_index", "0")),
            "max_feature_idx": int(kv.get("max_feature_idx", "0")),
            "objective": kv.get("objective"),
            "average_output": "average_output" in kv,
            "feature_names": kv.get("feature_names", "").split(),
            "monotone_constraints": [int(x) for x in kv.get(
                "monotone_constraints", "").split()],
            "feature_infos": kv.get("feature_infos", "").split(),
            "parameters": params,
            "pandas_categorical": pandas_categorical,
        }
    except ValueError as e:
        log.fatal(f"corrupt or truncated model file: header: {e}")
    return LoadedGBDT(meta, trees, config)
