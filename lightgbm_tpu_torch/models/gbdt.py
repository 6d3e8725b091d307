"""Gradient Boosting Decision Tree: the boosting loop.

The port of lightgbm_tpu's ``models/gbdt.py`` for the slice: the unfused
iteration (``train_one_iter``: gradients, one tree, shrinkage, the train
and valid score updates, the boost-from-average bias fold), evaluation,
and raw prediction as a float64 accumulation in tree order. The grower
takes the fused split path unless ``_split_fusion_on`` finds a reason not
to (categorical features, sparse device columns, ``split_fusion=off``),
as the JAX package resolves it. ``quantized_grad`` (or
``histogram_method=pallas_q8``) grows every tree in the q8 mode, each tree
keyed ``fold_in(PRNGKey(extra_seed), iter * k + c)`` as in the JAX
package. The JAX
package's fused one-program iteration, K-block dispatch, compile cache,
sentinels, flight recorder and OOM ladder wait for later ROADMAP items;
its fused and unfused iterations give the same trees, so the port runs the
unfused one whatever ``fused_iteration`` says.

Per-row state (scores, gradients, leaf ids) lives on the run's device; the
trees come back to the host once per iteration (the grower keeps them
there), so the model text needs no further transfer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import Dataset
from ..metrics import Metric, create_metric, default_metric_for_objective
from ..objectives import ObjectiveFunction, create_objective
from ..ops.histogram import resolve_method
from ..ops.split import SplitParams
from ..utils.random import fold_in, prng_key
from .grower import grow_tree
from .tree import HostTree, TreeArrays, empty_tree, predict_leaf_bins


def _shrink_tree(tree: TreeArrays, lr: float) -> TreeArrays:
    """Apply the learning rate to a tree's value-bearing fields
    (Tree::Shrinkage, tree.h:187)."""
    return tree._replace(leaf_value=tree.leaf_value * lr,
                         node_value=tree.node_value * lr,
                         shrinkage=tree.shrinkage * lr)


class GBDT:
    """Gradient Boosting Decision Tree (reference: gbdt.h:42)."""

    name = "gbdt"
    average_output = False

    def __init__(self, config, train_set: Optional[Dataset] = None,
                 objective: Optional[ObjectiveFunction] = None):
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.trees: List[TreeArrays] = []       # host trees, leaf_value shrunk
        self.host_trees: List[HostTree] = []
        self.tree_bias: List[float] = []
        self.init_scores: List[float] = [0.0]
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.iter = 0
        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self._valid_scores: List[torch.Tensor] = []
        self.metric_names: List[str] = []
        self._metric_cache: Dict[Tuple[str, int], Metric] = {}
        self._rows_streamed = 0.0
        if train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------ setup
    def _init_train(self, train_set: Dataset) -> None:
        train_set.construct()
        cfg = self.config
        self.device = train_set.device
        if self.objective is None:
            self.objective = create_objective(cfg)
        self.objective.init(train_set.get_label(), train_set.get_weight(),
                            self.device)
        n = train_set.num_data
        # boost_from_average init score (gbdt.cpp:333-367), folded as a bias
        # into the first tree (gbdt.cpp:414-416 AddBias)
        self.init_scores = [0.0]
        if cfg.boost_from_average:
            self.init_scores[0] = float(self.objective.boost_from_score(0))
        self._fold_init_bias = bool(cfg.boost_from_average)
        self.train_score = torch.full((n,), self.init_scores[0],
                                      dtype=torch.float32, device=self.device)
        self.shrinkage_rate = cfg.learning_rate
        self.split_params = SplitParams.from_config(cfg)
        self._extra_rng_key = prng_key(cfg.extra_seed)
        if cfg.quantized_grad and cfg.gpu_use_dp:
            raise ValueError(
                "quantized_grad and gpu_use_dp are exclusive: int8 "
                "histograms with stochastic rounding and f64 accumulation "
                "contradict each other — pick one precision model")
        self._hist_method = resolve_method(cfg.histogram_method, self.device,
                                           cfg.quantized_grad)
        self.metric_names = list(cfg.metric or
                                 default_metric_for_objective(cfg.objective))
        self._metric_cache = {}
        self._rows_streamed = 0.0

    def _compaction_ladder(self) -> tuple:
        """Row-buffer sizes of the compaction ladder: each
        ``hist_compaction_ladder`` fraction of N rounded up to 64 rows;
        rungs that do not undercut N are dropped (the full pass is always
        the fallback)."""
        cfg = self.config
        if not cfg.hist_compaction or self.train_set is None:
            return ()
        base = self.train_set.num_data
        rungs = set()
        for fr in (cfg.hist_compaction_ladder or []):
            m = -(-max(int(round(base * float(fr))), 1) // 64) * 64
            if 0 < m < base:
                rungs.add(m)
        return tuple(sorted(rungs))

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        valid_set.construct()
        self.valid_sets.append(valid_set)
        self.valid_names.append(name)
        self._valid_scores.append(torch.full(
            (valid_set.num_data,), self.init_scores[0], dtype=torch.float32,
            device=valid_set.device))

    # --------------------------------------------------------- training
    def _grow_one(self, g: torch.Tensor, h: torch.Tensor):
        cfg = self.config
        ts = self.train_set
        if len(ts.used_features) == 0:
            # every feature trivial: a splitless constant tree
            return (empty_tree(cfg.num_leaves),
                    torch.zeros((ts.num_data,), dtype=torch.int32,
                                device=self.device), 0.0)
        sp = ((ts.sp_cols, ts.sp_rows, ts.sp_bins, ts.sp_default)
              if ts.has_sparse_cols else None)
        # one tree per iteration (k = 1, c = 0): fold_in(key, iter * k + c)
        iter_key = fold_in(self._extra_rng_key, self.iter)
        return grow_tree(
            ts.binsT, g, h, ts.feature_meta, self.split_params,
            ts.missing_bin, max_leaves=cfg.num_leaves,
            num_bins=ts.max_num_bins, max_depth=cfg.max_depth,
            exact=cfg.tree_growth_mode == "exact",
            tile_leaves=cfg.tile_leaves,
            hist_subtraction=cfg.hist_subtraction,
            compaction_ladder=self._compaction_ladder(),
            split_fusion=self._split_fusion_on(),
            with_categorical=ts.has_categorical, sp=sp,
            hist_method=self._hist_method, rng_key=iter_key)

    def _split_fusion_on(self) -> bool:
        """Resolve ``split_fusion`` as the JAX package does: "auto" fuses
        the split search into the tile passes unless the classic search
        has to run -- categorical features or sparse device columns (the
        reasons the port has); "on" raises with either; "off" never
        fuses."""
        mode = self.config.split_fusion
        if mode == "off" or self.train_set is None:
            return False
        ts = self.train_set
        reasons = []
        if ts.has_categorical:
            reasons.append("categorical features")
        if ts.has_sparse_cols:
            reasons.append("sparse device columns")
        if mode == "on" and reasons:
            raise ValueError(
                "split_fusion=on is unsupported with " + ", ".join(reasons)
                + " (these split semantics live in the classic search; use "
                "split_fusion=auto to fall back automatically)")
        return not reasons

    def train_one_iter(self) -> bool:
        """One boosting iteration (gbdt.cpp:369-452). Returns True when the
        iteration added no tree with a split."""
        g, h = self.objective.get_grad_hess(self.train_score)
        tree, leaf_id, streamed = self._grow_one(g, h)
        self._rows_streamed += streamed
        had_split = int(tree.num_leaves) > 1
        tree = _shrink_tree(tree, self.shrinkage_rate)
        self._add_tree(tree, leaf_id)
        self._bias_after_score(had_split)
        self.iter += 1
        return not had_split

    def _add_tree(self, tree: TreeArrays, leaf_id: torch.Tensor) -> None:
        """Score updates: train through the grower's leaf ids, valid sets
        through a traversal of their bin matrices."""
        lv = tree.leaf_value.to(self.device)
        self.train_score = self.train_score + lv[leaf_id.long()]
        self.trees.append(tree)
        self.host_trees.append(self._make_host_tree(tree))
        for i, vs in enumerate(self.valid_sets):
            leaf = predict_leaf_bins(tree, vs.binsT,
                                     vs.missing_bin.to(vs.device))
            self._valid_scores[i] = (self._valid_scores[i]
                                     + tree.leaf_value.to(vs.device)[leaf])

    def _bias_after_score(self, had_split: bool) -> None:
        """Fold the boost-from-average init score into the first tree AFTER
        the score update (gbdt.cpp:404-435: AddBias for a tree with splits,
        AsConstantTree(init) for a splitless first tree)."""
        first = len(self.trees) <= self.num_tree_per_iteration
        bias = self.init_scores[0] if (first and self._fold_init_bias) else 0.0
        if abs(bias) <= 1e-15:
            self.tree_bias.append(0.0)
            return
        tree = self.trees[-1]
        if had_split:
            tree = tree._replace(leaf_value=tree.leaf_value + bias,
                                 node_value=tree.node_value + bias)
        else:
            lv = tree.leaf_value.clone()
            lv[0] = bias
            tree = tree._replace(leaf_value=lv)
        self.trees[-1] = tree
        self.host_trees[-1] = self._make_host_tree(tree)
        self.tree_bias.append(bias)

    def _make_host_tree(self, tree: TreeArrays) -> HostTree:
        """Host view with real thresholds from the bin mappers."""
        ds = self.train_set
        n_nodes = max(int(tree.num_leaves) - 1, 0)
        feats = tree.node_feature[:n_nodes].numpy()
        bins_thr = tree.node_threshold_bin[:n_nodes].numpy()
        real_thr = np.zeros(tree.node_threshold_bin.shape[0], np.float64)
        missing = np.zeros(n_nodes, np.int8)
        used = ds.used_features
        for i in range(n_nodes):
            mapper = ds.mappers[used[feats[i]]]
            real_thr[i] = mapper.bin_to_value(int(bins_thr[i]))
            missing[i] = mapper.missing_type
        return HostTree(tree, real_thr, used, missing)

    # ----------------------------------------------------- telemetry
    @property
    def rows_streamed_total(self) -> float:
        """Rows read by the histogram passes of every tree so far."""
        return float(self._rows_streamed)

    @property
    def rows_streamed_per_tree(self) -> float:
        return self.rows_streamed_total / max(len(self.trees), 1)

    # ---------------------------------------------------------- eval
    def eval_set(self) -> List[Tuple[str, str, float, bool]]:
        """(dataset_name, metric_name, value, bigger_is_better) for the
        train set (if configured) and every valid set (gbdt.cpp:517-575)."""
        sets = []
        if self.config.is_provide_training_metric:
            sets.append(("training", self.train_set, self.train_score))
        sets.extend(zip(self.valid_names, self.valid_sets,
                        self._valid_scores))
        out = []
        for ds_name, ds, score in sets:
            score_np = score.detach().cpu().numpy().astype(np.float64)
            for name in self.metric_names:
                key = (name, id(ds))
                mm = self._metric_cache.get(key)
                if mm is None:
                    mm = create_metric(name, self.config)
                    mm.init(ds.get_label(), ds.get_weight())
                    self._metric_cache[key] = mm
                out.append((ds_name, mm.name, mm.eval(score_np, self.objective),
                            mm.bigger_is_better))
        return out

    # ------------------------------------------------------- predict
    def _iter_range(self, num_iteration, start_iteration) -> Tuple[int, int]:
        total = len(self.trees) // self.num_tree_per_iteration
        start = min(max(start_iteration, 0), total)
        if num_iteration is None or num_iteration <= 0:
            return start, total
        return start, min(start + num_iteration, total)

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> np.ndarray:
        """Raw scores for raw-feature rows: bin with the train mappers on
        the device, traverse each tree over the bins, accumulate the float32
        tree outputs in float64 in tree order (the boost-from-average score
        lives in the first tree's leaves)."""
        ts = self.train_set
        binsT = ts.bin_new_data(X)
        mb = ts.missing_bin.to(binsT.device)
        start, end = self._iter_range(num_iteration, start_iteration)
        out = torch.zeros((binsT.shape[1],), dtype=torch.float64,
                          device=binsT.device)
        for tree in self.trees[start:end]:
            leaf = predict_leaf_bins(tree, binsT, mb)
            out += tree.leaf_value.to(binsT.device)[leaf].to(torch.float64)
        return out.cpu().numpy()

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                start_iteration: int = 0) -> np.ndarray:
        """Raw scores (float64), or the objective's output computed from
        the raw scores cast to float32, as the JAX package converts."""
        raw = self.predict_raw(X, num_iteration, start_iteration)
        return raw if raw_score else self.objective.convert_output(
            raw.astype(np.float32))

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        imp = np.zeros(self.train_set.num_total_features, np.float64)
        for ht in self.host_trees:
            for f, gain in zip(ht.split_feature, ht.split_gain):
                j = int(ht.feature_indices[f])
                imp[j] += 1.0 if importance_type == "split" \
                    else max(float(gain), 0.0)
        return imp

    @property
    def num_trees(self) -> int:
        return len(self.trees)

    def current_iteration(self) -> int:
        return len(self.trees) // self.num_tree_per_iteration
