"""Gradient Boosting Decision Tree: the boosting loop.

The port of lightgbm_tpu's ``models/gbdt.py``: the unfused iteration
(``train_one_iter``: gradients, row sampling, one tree per class, leaf
renewal, shrinkage, the train and valid score updates, the
boost-from-average bias fold), evaluation, and raw prediction as a
float64 accumulation in tree order. A multiclass objective grows
``num_tree_per_iteration`` = K trees an iteration over scores of shape
[N, K], tree c keyed ``fold_in(PRNGKey(extra_seed), iter * K + c)`` (the
q8 mode's rounding draw) as in the JAX package.

Learning to rank: the objective takes the train set's query sizes
(``Dataset.group``) and each metric its dataset's. A Dataset's
``init_score`` starts its score cache (train and valid) and, on the train
set, turns off the boost-from-average bias fold, as in the JAX package.

Row sampling, as the JAX package does it:

- bagging (``bagging_fraction``/``bagging_freq``, or the pos/neg
  fractions): a 0/1 mask from ``uniform(fold_in(PRNGKey(bagging_seed),
  period_start), [N]) < fraction`` (per row with pos/neg fractions), or,
  for a plain fraction <= 0.5 without sparse device columns, the subset
  mode: the ``round(N * fraction)`` rows of the smallest
  ``bits(key, [N])`` draws, in draw order, whose bin columns are copied
  once a period and alone histogrammed (the ladder's rungs are fractions
  of the subset then);
- ``_sample_weights`` (GOSS): per-row weights that scale the gradients,
  their 0/1 support the mask;
- by-tree ``feature_fraction``: ``round(F * fraction)`` features a tree
  from ``np.random.RandomState(feature_fraction_seed)``.

The split constraints (``_setup_learner_features``): monotone
constraints in the basic, intermediate or advanced mode, interaction
constraints, feature_contri, extra_trees and by-node feature sampling;
and the data layer's: CEGB (its used-feature state carried across trees)
and forced splits (``_load_forced_splits``). A train set with EFB bundles
hands the grower its segment tables; its model trees map each (bundle
column, bin) back to the original feature and threshold
(``_make_host_tree``), and such a model predicts from raw features
through them, in row chunks. The grower takes the fused split path unless
``_split_fusion_on`` finds a reason not to (categorical features, EFB
bundles, forced splits, CEGB, extra_trees, by-node sampling, intermediate
or advanced monotone constraints, a non-positive feature_contri, sparse
device columns, ``split_fusion=off``, f64 histograms), as the JAX package
resolves it. ``quantized_grad`` (or ``histogram_method=pallas_q8``) grows
every tree in the q8 mode; ``gpu_use_dp`` grows every tree on the classic
path with float64 histograms and leaf state (always: the JAX package's
x64 mode, which the port has no switch to leave). The
JAX package's fused one-program iteration, K-block dispatch, compile
cache, sentinels, flight recorder and OOM ladder wait for later ROADMAP
items; its fused and unfused iterations give the same trees (its fused
tweedie and gamma gradients excepted: XLA contracts their multiply-adds
there), so the port runs the unfused one whatever ``fused_iteration``
says.

Linear leaves (``linear_tree``, ``linear_lambda``): after each tree grows,
``_fit_linear_leaves`` fits every leaf's ridge model on the raw values of
the numerical features on its branch, on the host in numpy as the JAX
package does; the train score adds the per-row linear outputs, the valid
scores take them from the raw features on the device
(``_linear_valid_delta``), and prediction walks the model trees over raw
features. Linear trees take the bagging mask, never the subset copy, and
are refused with DART, RF, leaf-renewal objectives and a Dataset that did
not keep its raw features.

Training control, as the JAX package does it: ``train_one_iter(grad,
hess)`` takes a custom objective's gradients (objective ``none``: no
built-in objective, ``num_class`` trees an iteration, no boost-from-average
bias, raw predictions); ``reset_config`` applies new parameters between
iterations; ``rollback_one_iter`` takes the last iteration's trees off the
scores; ``eval_set(feval)`` adds a user's metrics; an init model
(``loaded``, a LoadedGBDT) supplies the first ``loaded_iters`` iterations
of prediction, importance and model text.

Per-row state (scores, gradients, leaf ids) lives on the run's device; the
trees come back to the host once per tree (the grower keeps them there),
so the model text needs no further transfer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import Dataset, _to_2d_float
from ..binning import BIN_TYPE_NUMERICAL, K_ZERO_THRESHOLD
from ..metrics import Metric, create_metric, default_metric_for_objective
from ..objectives import ObjectiveFunction, create_objective
from ..ops.histogram import resolve_method
from ..ops.split import SplitParams
from ..utils import log
from ..utils.ordered import linear_row_sum
from ..utils.random import bits, fold_in, prng_key, stable_argsort, uniform
from .grower import CegbSpec, grow_tree
from .tree import (HostTree, TreeArrays, empty_tree, predict_leaf_bins,
                   predict_value_bins)


_RAW_CHUNK = 65536      # rows a bundled model's raw predict densifies at once


def _linear_valid_delta(leaf: torch.Tensor, leaf_value: torch.Tensor,
                        const: torch.Tensor, W: torch.Tensor,
                        used: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Linear-leaf tree output of valid rows on their device (the JAX
    package's ``_linear_valid_delta``, ModelTree.predict's linear branch):
    const + coeff . x in float32, a row with NaN/inf in any of its leaf's
    linear features keeping the plain leaf value
    (linear_tree_learner.cpp:19-41). The JAX package's one-hot ``HIGHEST``
    products select a row of ``W`` and ``used`` exactly, so they are
    gathers here; const + the row sum adds in XLA:CPU's order
    (``linear_row_sum``)."""
    finite = torch.isfinite(raw)
    raw0 = torch.where(finite, raw, torch.zeros((), dtype=raw.dtype,
                                                device=raw.device))
    bad = ((used[leaf] > 0) & ~finite).any(1)
    return torch.where(bad, leaf_value[leaf],
                       linear_row_sum(const[leaf], W[leaf], raw0))


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
        self.num_class = max(config.num_class, 1)
        self.num_tree_per_iteration = 1
        self.init_scores: List[float] = [0.0]
        self.iter = 0
        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self._valid_scores: List[torch.Tensor] = []
        self.metric_names: List[str] = []
        self._metric_cache: Dict[Tuple[str, int], Optional[Metric]] = {}
        self._rows_streamed = 0.0
        self._hist_counters: Dict[str, float] = {}
        self._valid_raw_cache: Dict[int, torch.Tensor] = {}
        # continued training: a LoadedGBDT whose iterations precede this
        # booster's own (reference: gbdt.h num_init_iteration_)
        self.loaded = None
        self.loaded_iters = 0
        if train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------ setup
    def _init_train(self, train_set: Dataset) -> None:
        train_set.construct()
        cfg = self.config
        self.device = train_set.device
        if cfg.linear_tree and self.name in ("dart", "rf"):
            log.fatal(f"linear_tree is not supported with boosting={self.name}")
        if cfg.linear_tree and train_set.raw_data_np is None:
            log.fatal("linear_tree requires the Dataset's raw data: construct "
                      "the Dataset with linear_tree in its params (a Dataset "
                      "constructed without it did not retain raw features)")
        if self.objective is None:
            self.objective = create_objective(cfg)
        obj = self.objective
        if obj is not None:
            obj.init(train_set.get_label(), train_set.get_weight(),
                     train_set.get_group(), device=self.device)
            if cfg.linear_tree and obj.need_renew_tree_output:
                log.fatal(f"objective {cfg.objective} is not supported with "
                          f"linear_tree")
        # objective none (custom gradients): num_class trees an iteration
        self.num_tree_per_iteration = k = (
            obj.num_model_per_iteration if obj is not None
            else max(cfg.num_class, 1))
        n = train_set.num_data
        # boost_from_average init scores (gbdt.cpp:333-367), folded as a
        # bias into the first tree of each class (gbdt.cpp:414-416 AddBias)
        # unless the train set has an init score (gbdt.cpp:348)
        self.init_scores = [0.0] * k
        if obj is not None and cfg.boost_from_average:
            self.init_scores = [float(obj.boost_from_score(c))
                                for c in range(k)]
        self._fold_init_bias = (train_set.init_score is None
                                and bool(cfg.boost_from_average)
                                and obj is not None)
        self.train_score = self._score_cache(n, train_set.init_score)
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
        self._hist_counters = {}
        # feature-fraction draws (seed per config.h:307); bagging draws are
        # keyed on bagging_seed and the period start
        self._feat_rng = np.random.RandomState(cfg.feature_fraction_seed)
        self._bag_mask: Optional[torch.Tensor] = None
        self._bag_sub: Optional[tuple] = None
        self._bag_frac = None
        self._need_bagging = (
            (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0)
            or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0)
        self._setup_learner_features(train_set)

    def reset_config(self, config) -> None:
        """Apply new parameters mid-training (reference: GBDT::ResetConfig;
        the JAX package's ``reset_config``, which ``reset_parameter`` and
        ``learning_rates`` reach): the learning rate, the split parameters
        (packed into the epilogue's scan parameters at every tree), the
        learner features (CEGB's used-feature record carries over) and the
        bagging state."""
        self.config = config
        self.shrinkage_rate = config.learning_rate
        self.split_params = SplitParams.from_config(config)
        if self.train_set is not None:
            cegb = self._cegb
            self._setup_learner_features(self.train_set)
            if cegb is not None and self._cegb is not None:
                self._cegb.state = cegb.state
            self._extra_rng_key = prng_key(config.extra_seed)
            self._hist_method = resolve_method(
                config.histogram_method, self.device, config.quantized_grad)
        self._need_bagging = (
            (config.bagging_freq > 0 and config.bagging_fraction < 1.0)
            or config.pos_bagging_fraction < 1.0
            or config.neg_bagging_fraction < 1.0)
        self._bag_frac = None           # the fractions may have changed
        if not self._need_bagging:
            # bagging switched off: drop the period's subset or mask
            self._bag_sub = None
            self._bag_mask = None

    def _setup_learner_features(self, train_set: Dataset) -> None:
        """The split constraints and the randomised search (the JAX
        package's ``_setup_learner_features``): the monotone mode, the
        interaction groups in used-feature space, CEGB, by-node sampling
        and the forced splits. Intermediate and advanced monotone
        constraints grow one split per phase."""
        cfg = self.config
        self._with_monotone = any(int(m) != 0
                                  for m in (cfg.monotone_constraints or []))
        self._mono_mode = "basic"
        if self._with_monotone:
            method = cfg.monotone_constraints_method
            if method in ("intermediate", "advanced"):
                self._mono_mode = method
                log.warning(
                    f"monotone_constraints_method={method} forces strict "
                    "one-split-per-phase growth: one histogram round per "
                    "split, ~num_leaves/log2(num_leaves) x the batched "
                    "mode's data passes (use 'basic' for speed)")
            elif method != "basic":
                log.warning(f"monotone_constraints_method={method} is not "
                            f"implemented; falling back to basic")
        self._interaction_groups = None
        if cfg.interaction_constraints:
            used = {int(j): i for i, j in
                    enumerate(train_set.used_features)}
            groups = np.zeros((len(cfg.interaction_constraints),
                               len(used)), bool)
            for gi, grp in enumerate(cfg.interaction_constraints):
                for j in grp:
                    if int(j) in used:
                        groups[gi, used[int(j)]] = True
            self._interaction_groups = groups
        self._use_bynode = cfg.feature_fraction_bynode < 1.0
        self._setup_cegb(train_set)
        self._forced_splits = self._load_forced_splits(train_set)

    def _setup_cegb(self, train_set: Dataset) -> None:
        """CEGB's penalties in used-feature space (reference:
        cost_effective_gradient_boosting.hpp:26-33 enables it); the
        used-feature state lasts across trees and iterations."""
        cfg = self.config
        self._cegb = None
        if not (cfg.cegb_tradeoff < 1.0 or cfg.cegb_penalty_split > 0.0
                or cfg.cegb_penalty_feature_coupled
                or cfg.cegb_penalty_feature_lazy):
            return
        f = train_set.num_used_features()
        pen = {}
        for name in ("cegb_penalty_feature_coupled",
                     "cegb_penalty_feature_lazy"):
            lst = getattr(cfg, name)
            if lst and len(lst) != train_set.num_total_features:
                log.fatal(f"{name} should be the same size as feature "
                          f"number ({train_set.num_total_features})")
            pen[name] = None
            if lst:
                arr = np.zeros((f,), np.float32)
                for i, j in enumerate(train_set.used_features[:f]):
                    if j < len(lst):
                        arr[i] = lst[j]
                pen[name] = arr
        lazy = pen["cegb_penalty_feature_lazy"]
        state = {"used_split": np.zeros((f,), bool),
                 "row_used": (torch.zeros((train_set.num_data, f),
                                          dtype=torch.bool,
                                          device=self.device)
                              if lazy is not None else None)}
        self._cegb = CegbSpec(cfg.cegb_tradeoff, cfg.cegb_penalty_split,
                              pen["cegb_penalty_feature_coupled"], lazy,
                              state)

    def _load_forced_splits(self, ts: Dataset) -> Optional[tuple]:
        """``forcedsplits_filename``'s JSON tree ({"feature": i,
        "threshold": v, "left": {...}, "right": {...}}) as preorder arrays
        (device column, threshold bin, left node, right node) for the
        grower's forced phase (reference: serial_tree_learner.cpp:450
        ForceSplits). A node on an unused, bundled or categorical feature
        is left out with a warning, its subtree with it."""
        fn = self.config.forcedsplits_filename
        if not fn:
            return None
        import json
        from .. import binning
        try:
            with open(fn) as fh:
                data = json.load(fh)
        except OSError:
            log.warning(f"Could not open forced splits file {fn}. "
                        f"Will ignore.")
            return None
        if not data:
            return None
        if ts.bundles is not None:
            col_of = {int(ts.used_features[bd.members[0]]): gi
                      for gi, bd in enumerate(ts.bundles)
                      if len(bd.members) == 1}
        else:
            col_of = {int(j): i for i, j in enumerate(ts.used_features)}
        nodes: List[List[int]] = []

        def rec(node) -> int:
            orig = int(node["feature"])
            col = col_of.get(orig)
            m = ts.mappers[orig] if orig < len(ts.mappers) else None
            if (col is None or m is None
                    or m.bin_type != binning.BIN_TYPE_NUMERICAL):
                log.warning(f"forced split on feature {orig} ignored "
                            f"(unused, bundled or categorical)")
                return -1
            idx = len(nodes)
            nodes.append([col, m.value_to_bin(float(node["threshold"])),
                          -1, -1])
            if node.get("left"):
                nodes[idx][2] = rec(node["left"])
            if node.get("right"):
                nodes[idx][3] = rec(node["right"])
            return idx

        if rec(data) != 0 or not nodes:
            return None
        arr = np.asarray(nodes, np.int64)
        return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]

    def _score_cache(self, n: int, init_score=None) -> torch.Tensor:
        """A score cache of ``n`` rows at the init scores, or at a Dataset's
        ``init_score`` (as float32): [n], or [n, K] with K trees an
        iteration."""
        k = self.num_tree_per_iteration
        if init_score is not None:
            return torch.as_tensor(np.ascontiguousarray(
                np.asarray(init_score, np.float32).reshape(
                    (n, k) if k > 1 else (n,))), device=self.device)
        base = torch.tensor(np.asarray(self.init_scores, np.float32),
                            device=self.device)
        return (base.expand(n, k).contiguous() if k > 1
                else base[0].expand(n).contiguous())

    def _compaction_ladder(self) -> tuple:
        """Row-buffer sizes of the compaction ladder: each
        ``hist_compaction_ladder`` fraction of the histogram row count (the
        bagging subset's k rows in the subset mode) rounded up to 64 rows;
        rungs that do not undercut it are dropped (the full pass is always
        the fallback)."""
        cfg = self.config
        if not cfg.hist_compaction or self.train_set is None:
            return ()
        base = (self._subset_rows() if self._bagging_mode() == "subset"
                else self.train_set.num_data)
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
        self._valid_scores.append(self._score_cache(
            valid_set.num_data, valid_set.init_score).to(valid_set.device))

    # ---------------------------------------------------------- sampling
    def _bagging_mode(self) -> str:
        """"off", "mask" or "subset" (gbdt.cpp:810-818's compact-copy rule
        as the JAX package words it: a plain fraction <= 0.5 copies the
        in-bag rows, unless sparse device columns hold rows by their
        original ids or linear leaves fit on all rows)."""
        cfg = self.config
        if not self._need_bagging or cfg.bagging_freq <= 0:
            return "off"
        use_subset = (cfg.bagging_fraction <= 0.5
                      and cfg.pos_bagging_fraction >= 1.0
                      and cfg.neg_bagging_fraction >= 1.0
                      and not cfg.linear_tree
                      and not self.train_set.has_sparse_cols)
        return "subset" if use_subset else "mask"

    def _subset_rows(self) -> int:
        """Rows of the bagging subset copy."""
        return max(1, int(round(self.train_set.num_data
                                * self.config.bagging_fraction)))

    def _bagging_fraction(self):
        """The mask mode's keep-probability: per row (float32 [N]) with the
        pos/neg fractions (config.h:268-280), else a float32 scalar."""
        cfg = self.config
        if self._bag_frac is None:
            if cfg.pos_bagging_fraction < 1.0 or \
                    cfg.neg_bagging_fraction < 1.0:
                pos = (self.objective.label_np if self.objective is not None
                       else self.train_set.get_label()) > 0
                frac = np.where(pos, cfg.pos_bagging_fraction,
                                cfg.neg_bagging_fraction)
            else:
                frac = np.float64(cfg.bagging_fraction)
            self._bag_frac = torch.as_tensor(
                np.asarray(frac).astype(np.float32), device=self.device)
        return self._bag_frac

    def _update_bagging(self) -> None:
        """Draw the period's bag (reference: gbdt.cpp:228-262 Bagging),
        keyed on the period's first iteration."""
        cfg = self.config
        mode = self._bagging_mode()
        if mode == "off" or self.iter % cfg.bagging_freq != 0:
            return
        period_start = (self.iter // cfg.bagging_freq) * cfg.bagging_freq
        key = fold_in(prng_key(cfg.bagging_seed), period_start)
        ts = self.train_set
        n = ts.num_data
        if mode == "subset":
            r = bits(key, (n,), device=self.device)
            sub_idx = stable_argsort(r)[:self._subset_rows()]
            self._bag_sub = (sub_idx, ts.binsT[:, sub_idx].contiguous())
            self._bag_mask = None
            return
        # gpu_use_dp is the JAX package's x64 mode, whose draws are float64
        u = uniform(key, (n,), device=self.device,
                    dtype=torch.float64 if cfg.gpu_use_dp else torch.float32)
        self._bag_sub = None
        self._bag_mask = (u < self._bagging_fraction()).to(torch.float32)

    def _feature_mask(self) -> Optional[np.ndarray]:
        """By-tree column sampling (reference: col_sampler.hpp:20-50):
        [F] bool, or None when every feature is in."""
        f = self.train_set.num_used_features()
        frac = self.config.feature_fraction
        if frac >= 1.0:
            return None
        k = max(1, int(round(f * frac)))
        mask = np.zeros((f,), bool)
        mask[self._feat_rng.choice(f, size=k, replace=False)] = True
        return mask

    def _sample_weights(self, g, h) -> Optional[torch.Tensor]:
        """Per-row weights of a reweighted sampling (GOSS); None: the bag
        mask, if any."""
        return None

    # --------------------------------------------------------- training
    def _gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.objective.get_grad_hess(self.train_score)

    def _grow_one(self, g: torch.Tensor, h: torch.Tensor,
                  mask: Optional[torch.Tensor], fmask: Optional[np.ndarray],
                  iter_key: torch.Tensor):
        cfg = self.config
        ts = self.train_set
        if len(ts.used_features) == 0:
            # every feature trivial: a splitless constant tree
            return (empty_tree(cfg.num_leaves),
                    torch.zeros((ts.num_data,), dtype=torch.int32,
                                device=self.device), 0.0)
        sp = ((ts.sp_cols, ts.sp_rows, ts.sp_bins, ts.sp_default)
              if ts.has_sparse_cols else None)
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
            hist_method=self._hist_method, rng_key=iter_key,
            counters=self._hist_counters, sample_mask=mask,
            subset=self._bag_sub, feature_mask=fmask,
            mono_mode=self._mono_mode if self._with_monotone else "",
            interaction_groups=self._interaction_groups,
            extra_trees=cfg.extra_trees,
            bynode_fraction=(cfg.feature_fraction_bynode
                             if self._use_bynode else None),
            bundle=ts.bundle_meta, cegb=self._cegb,
            forced=self._forced_splits, hist_dp=cfg.gpu_use_dp)

    def _split_fusion_on(self) -> bool:
        """Resolve ``split_fusion`` as the JAX package does: "auto" fuses
        the split search into the tile passes unless the classic search
        has to run -- categorical features, EFB bundles, forced splits,
        CEGB, extra_trees, by-node sampling, intermediate or advanced
        monotone constraints, a non-positive feature_contri, f64 histograms
        (``gpu_use_dp``) or sparse device columns (the reasons the port
        has, in the JAX package's order); "on" raises with any; "off" never
        fuses. Basic monotone constraints, interaction constraints
        and a positive feature_contri stay fused."""
        cfg = self.config
        mode = cfg.split_fusion
        if mode == "off" or self.train_set is None:
            return False
        ts = self.train_set
        reasons = []
        if ts.has_categorical:
            reasons.append("categorical features")
        if ts.bundle_meta is not None:
            reasons.append("EFB bundles")
        if self._forced_splits is not None:
            reasons.append("forced splits")
        if self._cegb is not None:
            reasons.append("CEGB")
        if cfg.extra_trees:
            reasons.append("extra_trees")
        if self._use_bynode:
            reasons.append("feature_fraction_bynode")
        if self._with_monotone and self._mono_mode != "basic":
            reasons.append(f"{self._mono_mode} monotone constraints")
        if cfg.feature_contri and min(cfg.feature_contri) <= 0:
            # the fused path applies the multiplier after the scan's
            # within-feature pick, which commutes with it only when it is
            # positive
            reasons.append("non-positive feature_contri")
        if cfg.gpu_use_dp:
            reasons.append("f64 histograms")
        if ts.has_sparse_cols:
            reasons.append("sparse device columns")
        if mode == "on" and reasons:
            raise ValueError(
                "split_fusion=on is unsupported with " + ", ".join(reasons)
                + " (these split semantics live in the classic search; use "
                "split_fusion=auto to fall back automatically)")
        return not reasons

    def _custom_gradients(self, grad, hess):
        """Gradients given by the caller (``fobj``; reference:
        c_api.cpp:1645 LGBM_BoosterUpdateOneIterCustom), reshaped
        row-major to the score's shape, [N] or [N, K], as float32 on the
        run's device (one copy each)."""
        shape = tuple(self.train_score.shape)
        return tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, dtype=np.float32).reshape(shape))).to(self.device)
            for a in (grad, hess))

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration (gbdt.cpp:369-452): K trees with K
        classes, from the objective's gradients or from ``grad`` and
        ``hess`` (a custom objective). Returns True when no tree of the
        iteration has a split."""
        k = self.num_tree_per_iteration
        self._update_bagging()
        mask = self._bag_mask
        if grad is None:
            g, h = self._gradients()
        else:
            g, h = self._custom_gradients(grad, hess)
        w = self._sample_weights(g, h)
        if w is not None:
            # GOSS: gradients amplified, the 0/1 support keeps the count
            # channel exact (reference: goss.hpp:103-150)
            g = g * (w[:, None] if k > 1 else w)
            h = h * (w[:, None] if k > 1 else w)
            mask = (w > 0).to(torch.float32)
        no_split = True
        for c in range(k):
            gc = g[:, c].contiguous() if k > 1 else g
            hc = h[:, c].contiguous() if k > 1 else h
            fmask = self._feature_mask()
            iter_key = fold_in(self._extra_rng_key, self.iter * k + c)
            tree, leaf_id, streamed = self._grow_one(gc, hc, mask, fmask,
                                                     iter_key)
            self._rows_streamed += streamed
            lin = None
            if self.config.linear_tree:
                # the first tree counts an init model's trees too
                # (reference: models_.size() < num_tree_per_iteration_)
                lin = self._fit_linear_leaves(
                    tree, leaf_id, gc, hc, mask,
                    len(self.trees) < k and self.loaded_iters == 0)
            tree, had_split = self._finalize_tree(tree, leaf_id, c)
            no_split = no_split and not had_split
            self._add_tree(tree, leaf_id, c, lin)
            self._bias_after_score(c, had_split)
        self.iter += 1
        return no_split

    def _finalize_tree(self, tree: TreeArrays, leaf_id: torch.Tensor,
                       class_idx: int) -> Tuple[TreeArrays, bool]:
        """RenewTreeOutput + Shrinkage (gbdt.cpp:411-433): the L1 family's
        leaf values become percentiles of the residuals over all rows;
        returns the tree and whether it has a split."""
        num_leaves = int(tree.num_leaves)
        had_split = num_leaves > 1
        if (had_split and self.objective is not None
                and self.objective.need_renew_tree_output):
            new_values = self.objective.renew_tree_output(
                leaf_id.cpu().numpy(), self._renew_score(class_idx),
                num_leaves)
            if new_values is not None:
                lv = tree.leaf_value.clone()
                lv[:num_leaves] = torch.as_tensor(
                    np.asarray(new_values, np.float32))
                tree = tree._replace(leaf_value=lv)
        return _shrink_tree(tree, self.shrinkage_rate), had_split

    def _renew_score(self, class_idx: int) -> np.ndarray:
        """The scores leaf renewal measures residuals from (RF: the
        constant init score, rf.hpp:133-136)."""
        s = (self.train_score if self.num_tree_per_iteration == 1
             else self.train_score[:, class_idx])
        return s.cpu().numpy().astype(np.float64)

    def _class_add(self, score: torch.Tensor, class_idx: int,
                   delta: torch.Tensor) -> torch.Tensor:
        """``score`` with ``delta`` added to class ``class_idx``'s
        column."""
        if self.num_tree_per_iteration == 1:
            return score + delta
        score = score.clone()
        score[:, class_idx] += delta
        return score

    def _add_tree(self, tree: TreeArrays, leaf_id: torch.Tensor,
                  class_idx: int, linear: Optional[dict] = None) -> None:
        """Score updates: train through the grower's leaf ids, valid sets
        through a traversal of their bin matrices. ``linear``
        (``_fit_linear_leaves``): the train delta is its per-row linear
        output times the learning rate (numpy float32, as the JAX package
        scales it), the host tree takes the const and coeff tables times
        the learning rate, and the valid sets add their linear outputs
        (reference: Tree::AddPredictionToScore's linear branch)."""
        lr = self.shrinkage_rate
        if linear is not None:
            delta = torch.from_numpy(linear["train_delta"] * lr).to(
                self.device)
        else:
            delta = tree.leaf_value.to(self.device)[leaf_id.long()]
        self.train_score = self._class_add(self.train_score, class_idx, delta)
        self.trees.append(tree)
        self.host_trees.append(self._make_host_tree(tree))
        lin_tables = None
        if linear is not None:
            ht = self.host_trees[-1]
            ht.is_linear = True
            ht.leaf_const = linear["const"] * lr
            ht.leaf_coeff = [[c * lr for c in cs] for cs in linear["coeff"]]
            ht.leaf_features_raw = linear["features"]
            if self.valid_sets:
                lin_tables = self._linear_tables(ht)
        for i, vs in enumerate(self.valid_sets):
            leaf = predict_leaf_bins(tree, vs.traversal_binsT(),
                                     vs.missing_bin.to(vs.device))
            if lin_tables is None:
                vdelta = tree.leaf_value.to(vs.device)[leaf]
            else:
                raw = self._valid_raw_cache.get(i)
                if raw is None:
                    raw = torch.from_numpy(vs.raw_data_np).to(vs.device)
                    self._valid_raw_cache[i] = raw
                vdelta = _linear_valid_delta(
                    leaf, *(t.to(vs.device) for t in lin_tables), raw)
            self._valid_scores[i] = self._class_add(
                self._valid_scores[i], class_idx, vdelta)

    def _linear_tables(self, ht: HostTree) -> Tuple[torch.Tensor, ...]:
        """The device tables of a linear tree's valid scoring, padded to
        ``num_leaves`` leaves: leaf values, consts [L] and the dense
        coefficients and used-feature mask [L, F_total], float32."""
        if any(vs.raw_data_np is None for vs in self.valid_sets):
            log.fatal("linear_tree scores a valid set from its raw features: "
                      "construct it with reference=<train Dataset>")
        L = self.config.num_leaves
        nl = len(ht.leaf_value)
        ftot = self.train_set.num_total_features
        W = np.zeros((L, ftot), np.float32)
        used = np.zeros((L, ftot), np.float32)
        for li, (feats, coefs) in enumerate(zip(ht.leaf_features_raw,
                                                ht.leaf_coeff)):
            for fj, cj in zip(feats, coefs):
                W[li, int(fj)] = np.float32(cj)
                used[li, int(fj)] = 1.0
        lv = np.zeros((L,), np.float32)
        lv[:nl] = np.asarray(ht.leaf_value, np.float32)
        lc = np.zeros((L,), np.float32)
        lc[:nl] = np.asarray(ht.leaf_const, np.float32)
        return tuple(torch.from_numpy(a) for a in (lv, lc, W, used))

    def _fit_linear_leaves(self, tree: TreeArrays, leaf_id: torch.Tensor,
                           grad: torch.Tensor, hess: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           first_tree: bool) -> dict:
        """Fit a linear model per leaf on the raw values of its branch's
        numerical features, on the host (the JAX package's
        ``_fit_linear_leaves``; reference: linear_tree_learner.cpp:173-380
        CalculateLinear): coefficients -(X^T H X + lambda)^-1 X^T g (Eq. 3
        of arXiv:1802.05640) over the leaf's in-bag rows with no NaN or inf
        in those features, ``np.linalg.solve`` or, for a singular system,
        ``pinv``; coefficients with |c| <= kZeroThreshold dropped. A leaf
        with fewer such rows than features + 1 keeps its plain output, and
        the first tree of a model keeps every leaf plain. Returns the
        pre-shrinkage const and coeff tables, each leaf's original feature
        indices and the per-row train deltas (float32)."""
        ts = self.train_set
        raw = ts.raw_data_np
        ht = self._make_host_tree(tree)
        L = ht.num_leaves
        leaf_np = leaf_id.cpu().numpy()
        g = grad.cpu().numpy().astype(np.float64)
        h = hess.cpu().numpy().astype(np.float64)
        m = (np.ones(leaf_np.shape, bool) if mask is None
             else mask.cpu().numpy() > 0)
        lam = self.config.linear_lambda

        # the branch features of each leaf: the sorted distinct numerical
        # original features on its path (linear_tree_learner.cpp:195-225)
        leaf_feats: List[List[int]] = [[] for _ in range(L)]
        if L > 1:
            stack = [(0, [])]
            while stack:
                node, path = stack.pop()
                orig = int(ht.feature_indices[int(ht.split_feature[node])])
                is_num = ts.mappers[orig].bin_type == BIN_TYPE_NUMERICAL
                npath = path + ([orig] if is_num else [])
                for child in (int(ht.left_child[node]),
                              int(ht.right_child[node])):
                    if child >= 0:
                        stack.append((child, npath))
                    else:
                        leaf_feats[~child] = sorted(set(npath))

        leaf_value = np.asarray(ht.leaf_value[:L], np.float64)
        consts = leaf_value.copy()
        coeffs: List[List[float]] = [[] for _ in range(L)]
        features: List[List[int]] = [[] for _ in range(L)]
        train_delta = leaf_value[leaf_np]
        if not first_tree:
            # each leaf's rows in row order, as the JAX package's boolean
            # masks give them (a stable sort by leaf), so every array the
            # fit reads holds the same values in the same order; one sort
            # instead of a mask over all N rows a leaf
            order = np.argsort(leaf_np, kind="stable")
            bounds = np.searchsorted(leaf_np[order], np.arange(L + 1))
            for leaf in range(L):
                feats = leaf_feats[leaf]
                if not feats:
                    continue
                all_rows = order[bounds[leaf]:bounds[leaf + 1]]
                rows = all_rows[m[all_rows]]
                Xl = raw[rows][:, feats].astype(np.float64)
                okr = ~np.isnan(Xl).any(axis=1) & ~np.isinf(Xl).any(axis=1)
                if okr.sum() < len(feats) + 1:
                    continue            # the plain leaf output stays const
                Xl = Xl[okr]
                gl = g[rows][okr]
                hl = h[rows][okr]
                X1 = np.concatenate([Xl, np.ones((len(Xl), 1))], axis=1)
                A = X1.T @ (X1 * hl[:, None])
                A[np.arange(len(feats)), np.arange(len(feats))] += lam
                b = X1.T @ gl
                try:
                    sol = -np.linalg.solve(A, b)
                except np.linalg.LinAlgError:
                    sol = -(np.linalg.pinv(A) @ b)
                keep = [i for i in range(len(feats))
                        if abs(sol[i]) > K_ZERO_THRESHOLD]
                features[leaf] = [feats[i] for i in keep]
                coeffs[leaf] = [float(sol[i]) for i in keep]
                consts[leaf] = float(sol[-1])
                # every row of the leaf, bagged out or not; a row with NaN
                # or inf in a kept feature keeps the plain leaf output
                if features[leaf]:
                    Xa = raw[all_rows][:, features[leaf]].astype(np.float64)
                    bad = np.isnan(Xa).any(axis=1) | np.isinf(Xa).any(axis=1)
                    pred = consts[leaf] + Xa @ np.asarray(coeffs[leaf])
                else:
                    bad = np.zeros(len(all_rows), bool)
                    pred = consts[leaf]
                train_delta[all_rows] = np.where(bad, leaf_value[leaf], pred)
        return {"const": consts, "coeff": coeffs, "features": features,
                "train_delta": train_delta.astype(np.float32)}

    def _bias_after_score(self, class_idx: int, had_split: bool) -> None:
        """Fold the boost-from-average init score into the class's first
        tree AFTER the score update (gbdt.cpp:404-435: AddBias for a tree
        with splits, AsConstantTree(init) for a splitless first tree)."""
        first = len(self.trees) <= self.num_tree_per_iteration
        bias = (self.init_scores[class_idx]
                if (first and self._fold_init_bias) else 0.0)
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
        old_ht = self.host_trees[-1]
        new_ht = self._make_host_tree(tree)
        if old_ht.is_linear:
            # AddBias reaches leaf_const too (tree.h:212-231)
            new_ht.is_linear = True
            new_ht.leaf_const = old_ht.leaf_const + bias
            new_ht.leaf_coeff = old_ht.leaf_coeff
            new_ht.leaf_features_raw = old_ht.leaf_features_raw
        self.host_trees[-1] = new_ht
        self.tree_bias.append(bias)

    def _make_host_tree(self, tree: TreeArrays) -> HostTree:
        """Host view with real thresholds from the bin mappers. On a
        bundled train set each node's (bundle column, bin) maps back to its
        original feature and that feature's own bin (the direction decides
        which: ``_thr_rev`` or ``_thr_fwd``), so model trees reference
        original features, as the reference's do."""
        ds = self.train_set
        n_nodes = max(int(tree.num_leaves) - 1, 0)
        feats = tree.node_feature[:n_nodes].numpy()
        bins_thr = tree.node_threshold_bin[:n_nodes].numpy()
        real_thr = np.zeros(tree.node_threshold_bin.shape[0], np.float64)
        missing = np.zeros(n_nodes, np.int8)
        if ds.bundles is not None:
            seg_lo = tree.node_seg_lo[:n_nodes].numpy()
            dleft = tree.node_default_left[:n_nodes].numpy()
            orig = np.zeros(n_nodes, np.int32)
            for i in range(n_nodes):
                g, t = int(feats[i]), int(bins_thr[i])
                orig[i] = int(ds._owner_orig[g, t])
                mapper = ds.mappers[orig[i]]
                missing[i] = mapper.missing_type
                if seg_lo[i] >= 0:
                    thr = ds._thr_rev if dleft[i] else ds._thr_fwd
                    t = int(thr[g, t])
                real_thr[i] = mapper.bin_to_value(t)
            ht = HostTree(tree, real_thr,
                          np.arange(ds.num_total_features, dtype=np.int32),
                          missing)
            ht.split_feature = orig
            return ht
        used = ds.used_features
        for i in range(n_nodes):
            mapper = ds.mappers[used[feats[i]]]
            real_thr[i] = mapper.bin_to_value(int(bins_thr[i]))
            missing[i] = mapper.missing_type
        return HostTree(tree, real_thr, used, missing)

    def rollback_one_iter(self) -> None:
        """Take the last iteration's trees off (reference: gbdt.cpp:454-470
        RollbackOneIter): each tree's output, re-traversed over the train
        and valid bins, less the boost-from-average bias folded in after
        its score update (``_bias_after_score``), comes off the scores in
        float32, class K-1 first, as the JAX package does."""
        if self.iter <= 0:
            return
        if self.train_set.has_sparse_cols:
            # the traversal needs the full-width bin matrix, which sparse
            # storage no longer holds
            log.fatal("rollback_one_iter is not supported with sparse "
                      "device storage (construct with enable_sparse=false)")
        k = self.num_tree_per_iteration
        ts = self.train_set
        for c in range(k):
            tree = self.trees.pop()
            self.host_trees.pop()
            bias = self.tree_bias.pop() if self.tree_bias else 0.0
            class_idx = k - 1 - c
            delta = predict_value_bins(tree, ts.binsT,
                                       ts.missing_bin.to(self.device)) - bias
            self.train_score = self._class_add(self.train_score, class_idx,
                                               -delta)
            for i, vs in enumerate(self.valid_sets):
                vdelta = predict_value_bins(
                    tree, vs.traversal_binsT(),
                    vs.missing_bin.to(vs.device)) - bias
                self._valid_scores[i] = self._class_add(
                    self._valid_scores[i], class_idx, -vdelta)
        self.iter -= 1

    # ----------------------------------------------------- telemetry
    @property
    def rows_streamed_total(self) -> float:
        """Rows read by the histogram passes of every tree so far."""
        return float(self._rows_streamed)

    @property
    def rows_streamed_per_tree(self) -> float:
        return self.rows_streamed_total / max(len(self.trees), 1)

    @property
    def rows_real_per_tree(self) -> float:
        """Rows the histogram passes added per tree: the rows streamed less
        the compaction rungs' padding."""
        return (self._hist_counters.get("rows_real", 0.0)
                / max(len(self.trees), 1))

    # ---------------------------------------------------------- eval
    def eval_set(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        """(dataset_name, metric_name, value, bigger_is_better) for the
        train set (if configured) and every valid set (gbdt.cpp:517-575),
        the metrics' and then ``feval``'s."""
        sets = []
        if self.config.is_provide_training_metric:
            sets.append(("training", self.train_set, self.train_score))
        sets.extend(zip(self.valid_names, self.valid_sets,
                        self._valid_scores))
        out = []
        for ds_name, ds, score in sets:
            score_np = score.detach().cpu().numpy().astype(np.float64)
            out.extend(self.eval_metrics(score_np, ds, ds_name, feval,
                                         cache=True))
        return out

    def eval_metrics(self, score_np: np.ndarray, ds: Dataset, ds_name: str,
                     feval=None, cache: bool = False):
        """Every configured metric, then ``feval``, over one dataset's raw
        scores (float64, [N] or [N, K]); the loop ``eval_set`` and
        ``Booster.eval`` share. ``cache`` keeps each dataset's initialized
        metrics (the booster's own train and valid sets)."""
        out = []
        for name in self.metric_names:
            key = (name, id(ds))
            if cache and key in self._metric_cache:
                mm = self._metric_cache[key]
            else:
                mm = create_metric(name, self.config)
                if mm is not None:
                    mm.init(ds.get_label(), ds.get_weight(), ds.get_group())
                if cache:
                    self._metric_cache[key] = mm
            if mm is None:
                continue
            val = mm.eval(score_np, self.objective)
            if isinstance(val, (list, tuple)):
                # ndcg@k / map@k: one entry a position
                out.extend((ds_name, nm, float(v), mm.bigger_is_better)
                           for nm, v in zip(mm.name, val))
            else:
                out.append((ds_name, mm.name, val, mm.bigger_is_better))
        if feval is not None:
            out.extend(_call_feval(feval, score_np, ds, ds_name))
        return out

    # ------------------------------------------------------- predict
    def _iter_range(self, num_iteration, start_iteration) -> Tuple[int, int]:
        """[start, end) over every iteration, an init model's first."""
        total = self.loaded_iters + len(self.trees) // \
            self.num_tree_per_iteration
        start = min(max(start_iteration, 0), total)
        if num_iteration is None or num_iteration <= 0:
            return start, total
        return start, min(start + num_iteration, total)

    def _raw_matrix(self, X) -> np.ndarray:
        """Raw rows as a dense matrix of the training width (pandas
        categories as the training codes; scipy-sparse rows densified)."""
        from ..basic import _is_scipy_sparse
        ts = self.train_set
        X = (np.asarray(X.toarray(), np.float64) if _is_scipy_sparse(X)
             else _to_2d_float(ts._pandas_to_codes(X)))
        if X.shape[1] != ts.num_total_features:
            log.fatal(f"The number of features in data ({X.shape[1]}) is not "
                      f"the same as it was in training data "
                      f"({ts.num_total_features}).")
        return X

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> np.ndarray:
        """Raw scores for raw-feature rows: bin with the train mappers on
        the device, traverse each tree over the bins, accumulate the float32
        tree outputs in float64 in tree order (the boost-from-average score
        lives in the first trees' leaves); [N], or [N, K] with K classes.
        An init model's iterations come first, its trees walked over the
        raw rows (their thresholds are real values). An averaged model
        (RF) divides by the iterations used. A model trained on EFB
        bundles predicts from the raw features through its model trees
        (new rows need not keep the training rows' exclusivity, and the
        reference predicts from real thresholds too), in chunks of
        ``_RAW_CHUNK`` rows, densifying one chunk at a time. A linear model
        (``linear_tree``) predicts through its model trees too: its leaves
        read raw features, and a NaN in a leaf's linear feature takes the
        plain leaf output."""
        ts = self.train_set
        k = self.num_tree_per_iteration
        start, end = self._iter_range(num_iteration, start_iteration)
        lo = self.loaded_iters
        base = None
        if start < min(end, lo):
            Xd = self._raw_matrix(X)
            base = np.zeros((Xd.shape[0], k), np.float64)
            for it in range(start, min(end, lo)):
                for c in range(k):
                    base[:, c] += self.loaded.trees[it * k + c].predict(Xd)
        own = (max(start - lo, 0), max(end - lo, 0))
        if ts.bundles is not None or self.config.linear_tree:
            out = self._predict_model_trees(X, *own, base)
        else:
            out = self._traverse(ts.bin_new_data(X), *own, base)
        if self.average_output:
            out /= max(end - start, 1)
        return out if k > 1 else out[:, 0]

    def _traverse(self, binsT: torch.Tensor, start: int, end: int,
                  base: Optional[np.ndarray] = None,
                  use_bias: bool = False) -> np.ndarray:
        """[N, K] float64 sums over a train-aligned bin matrix of the trees
        of iterations [start, end), in tree order from ``base`` (zeros by
        default); ``use_bias`` takes each tree's folded boost-from-average
        bias off its value first, as the JAX package's predict engine
        does."""
        k = self.num_tree_per_iteration
        dev = binsT.device
        mb = self.train_set.missing_bin.to(dev)
        out = (torch.zeros((binsT.shape[1], k), dtype=torch.float64,
                           device=dev) if base is None
               else torch.as_tensor(base, dtype=torch.float64, device=dev))
        for i, tree in enumerate(self.trees[start * k:end * k]):
            leaf = predict_leaf_bins(tree, binsT, mb)
            v = tree.leaf_value.to(dev)[leaf].to(torch.float64)
            if use_bias:
                v = v - self.tree_bias[start * k + i]
            out[:, i % k] += v
        return out.cpu().numpy()

    def _predict_model_trees(self, X, start: int, end: int,
                             base: Optional[np.ndarray] = None) -> np.ndarray:
        """[N, K] float64 sums of the model trees (real thresholds, original
        features) over raw rows, chunk by chunk, from ``base`` (zeros by
        default)."""
        from ..basic import _is_scipy_sparse, _to_2d_float
        from ..io.model_text import ModelTree
        ts = self.train_set
        k = self.num_tree_per_iteration
        if _is_scipy_sparse(X):
            X = X.tocsr()
        else:
            X = _to_2d_float(ts._pandas_to_codes(X))
        if X.shape[1] != ts.num_total_features:
            log.fatal(f"The number of features in data ({X.shape[1]}) is not "
                      f"the same as it was in training data "
                      f"({ts.num_total_features}).")
        mts = [ModelTree.from_host(ht, ts.mappers)
               for ht in self.host_trees[start * k:end * k]]
        out = (np.zeros((X.shape[0], k), np.float64) if base is None
               else base)
        for r0 in range(0, X.shape[0], _RAW_CHUNK):
            xc = X[r0:r0 + _RAW_CHUNK]
            xc = (np.asarray(xc.toarray(), np.float64)
                  if _is_scipy_sparse(xc) else xc)
            for i, mt in enumerate(mts):
                out[r0:r0 + xc.shape[0], i % k] += mt.predict(xc)
        return out

    def score_dataset(self, ds: Dataset) -> np.ndarray:
        """Raw scores of a train-aligned Dataset from its bin matrix (the
        JAX package's ``score_dataset``, which ``Booster.eval`` uses): the
        init scores (or the set's ``init_score``) plus every tree, traversed
        over the full-width bins (``Dataset.traversal_binsT``: a
        sparse-stored set's stream columns rebuilt; a bundled set's bundle
        columns, which the trees' segments read). A linear model predicts
        from the set's raw features."""
        ds.construct()
        ts = self.train_set
        if ds is not ts and ds.reference is not ts \
                and ds.mappers is not ts.mappers:
            log.fatal("eval dataset was not binned against the training "
                      "set; construct it with reference=<train Dataset>")
        if self.loaded_iters > 0 or self.config.linear_tree:
            # an init model's trees and linear leaves read raw features
            from ..basic import _is_scipy_sparse
            raw = ds.raw_data_np
            if raw is None and ds.data is not None:
                raw = (ds.data if _is_scipy_sparse(ds.data)
                       else _to_2d_float(ds._pandas_to_codes(ds.data)))
            if raw is None:
                log.fatal("eval with a loaded init_model or linear trees "
                          "needs raw features (construct the Dataset with "
                          "free_raw_data=False)")
            return self.predict_raw(raw)
        k = self.num_tree_per_iteration
        n = ds.num_data
        base = np.broadcast_to(np.asarray(self.init_scores, np.float64),
                               (n, k)).copy()
        if ds.init_score is not None:
            base = np.asarray(ds.init_score, np.float64).reshape(n, k).copy()
        if self.trees:
            # the first trees carry the folded init score, which the base
            # holds already: each tree's bias comes off its value
            base = self._traverse(ds.traversal_binsT(), 0,
                                  len(self.trees) // k, base, use_bias=True)
        return base if k > 1 else base[:, 0]

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                start_iteration: int = 0) -> np.ndarray:
        """Raw scores (float64), or the objective's output computed from
        the raw scores cast to float32, as the JAX package converts."""
        raw = self.predict_raw(X, num_iteration, start_iteration)
        if raw_score or self.objective is None:
            return raw
        return self.objective.convert_output(raw.astype(np.float32))

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        imp = np.zeros(self.train_set.num_total_features, np.float64)
        if self.loaded is not None:
            imp += self.loaded.feature_importance(importance_type)
        for ht in self.host_trees:
            for f, gain in zip(ht.split_feature, ht.split_gain):
                j = int(ht.feature_indices[f])
                imp[j] += 1.0 if importance_type == "split" \
                    else max(float(gain), 0.0)
        return imp

    @property
    def num_trees(self) -> int:
        return len(self.trees) + self.loaded_iters * \
            self.num_tree_per_iteration

    def current_iteration(self) -> int:
        return len(self.trees) // self.num_tree_per_iteration \
            + self.loaded_iters


def _call_feval(feval, score_np, ds, ds_name="valid"):
    """Results of a user eval function (or a list of them), each returning
    (name, value, is_higher_better) or a list of such tuples (reference:
    engine.py feval protocol)."""
    results = []
    for fe in (feval if isinstance(feval, (list, tuple)) else [feval]):
        ret = fe(score_np, ds)
        for name, val, bigger in (ret if isinstance(ret, list) else [ret]):
            results.append((ds_name, name, float(val), bool(bigger)))
    return results
