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
reference. Linear leaves wait for ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..binning import (BIN_TYPE_CATEGORICAL, K_ZERO_THRESHOLD, MISSING_NAN,
                       MISSING_ZERO)
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
        lines += ["is_linear=0", f"shrinkage={_d2s(self.shrinkage)}"]
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
        if int(kv.get("is_linear", "0")):
            raise NotImplementedError(
                "linear-leaf trees are not ported to lightgbm_tpu_torch yet; "
                "they arrive with ROADMAP.md Queue 1 item 11")
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
        return self.leaf_value[self.leaf_index(X)]


# ===================================================================== dump
def _objective_string(config: Config) -> Optional[str]:
    if config.objective == "binary":
        return f"binary sigmoid:{config.sigmoid:g}"
    return config.objective or None


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
    """Header metadata + ModelTree list of a trained GBDT or a LoadedGBDT,
    cut to the [start, start + num) iteration window
    (reference: gbdt_model_text.cpp:343-356)."""
    if isinstance(boosting, LoadedGBDT):
        meta = dict(boosting.meta)
        all_trees = list(boosting.trees)
    else:
        cfg = boosting.config
        ds = boosting.train_set
        meta = {
            "num_class": 1, "num_tree_per_iteration": 1, "label_index": 0,
            "max_feature_idx": ds.num_total_features - 1,
            "objective": _objective_string(cfg),
            "feature_names": ds.get_feature_names(),
            "feature_infos": _feature_infos(ds.mappers),
            "parameters": cfg.to_params(),
        }
        all_trees = [ModelTree.from_host(ht, ds.mappers)
                     for ht in boosting.host_trees]
    total = len(all_trees)
    start = min(max(start_iteration, 0), total)
    end = (min(start + num_iteration, total)
           if num_iteration is not None and num_iteration > 0 else total)
    return meta, all_trees[start:end]


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
    out.append("feature_names=" + " ".join(meta["feature_names"]))
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
    return body


# ===================================================================== load
class LoadedGBDT:
    """A model restored from text: predicts over raw features through real
    thresholds (reference: GBDT::LoadModelFromString)."""

    def __init__(self, meta: dict, trees: List[ModelTree], config: Config):
        from ..objectives import create_objective
        self.meta = meta
        self.trees = trees
        self.config = config
        self.num_tree_per_iteration = 1
        self.feature_names = meta["feature_names"]
        self.max_feature_idx = meta["max_feature_idx"]
        self.objective = (create_objective(config)
                          if config.objective in ("regression", "binary")
                          else None)

    @property
    def num_trees(self) -> int:
        return len(self.trees)

    def current_iteration(self) -> int:
        return len(self.trees)

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> np.ndarray:
        X = np.asarray(X.values if hasattr(X, "values") else X, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] != self.max_feature_idx + 1:
            log.fatal(f"The number of features in data ({X.shape[1]}) is not "
                      f"the same as it was in training data "
                      f"({self.max_feature_idx + 1}).")
        total = len(self.trees)
        start = min(max(start_iteration, 0), total)
        end = (min(start + num_iteration, total)
               if num_iteration is not None and num_iteration > 0 else total)
        out = np.zeros(X.shape[0], np.float64)
        for t in self.trees[start:end]:
            out += t.predict(X)
        return out

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                start_iteration: int = 0) -> np.ndarray:
        raw = self.predict_raw(X, num_iteration, start_iteration)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw.astype(np.float32))


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
    obj = kv.get("objective", "").split()
    if obj:
        config.objective = obj[0]
        for tok in obj[1:]:
            key, _, val = tok.partition(":")
            if key == "sigmoid":
                config.sigmoid = float(val)
    try:
        meta = {
            "num_class": int(kv.get("num_class", "1")),
            "num_tree_per_iteration": int(kv.get("num_tree_per_iteration",
                                                 "1")),
            "label_index": int(kv.get("label_index", "0")),
            "max_feature_idx": int(kv.get("max_feature_idx", "0")),
            "objective": kv.get("objective"),
            "feature_names": kv.get("feature_names", "").split(),
            "feature_infos": kv.get("feature_infos", "").split(),
            "parameters": params,
        }
    except ValueError as e:
        log.fatal(f"corrupt or truncated model file: header: {e}")
    if meta["num_tree_per_iteration"] != 1:
        raise NotImplementedError(
            "multi-tree-per-iteration models are not ported to "
            "lightgbm_tpu_torch yet; they arrive with ROADMAP.md Queue 1 "
            "item 10")
    return LoadedGBDT(meta, trees, config)
