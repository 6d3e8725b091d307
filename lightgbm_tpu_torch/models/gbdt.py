"""Gradient Boosting Decision Tree: the boosting loop.

The port of lightgbm_tpu's ``models/gbdt.py``: the unfused iteration
(``train_one_iter``: gradients, row sampling, one tree per class, leaf
renewal, shrinkage, the train and valid score updates, the
boost-from-average bias fold), evaluation, and prediction: raw,
converted, leaves, early-stopped and SHAP, through the device engine
(``models/predict_engine.py``) with its float64 accumulation in tree
order, the input checks and an init model's host prefix first. A multiclass objective grows
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
cache and in-program sentinels wait for later ROADMAP items; its fused
and unfused iterations give the same trees (its fused tweedie and gamma
gradients excepted: XLA contracts their multiply-adds there), so the port
runs the unfused one whatever ``fused_iteration`` says.

Telemetry, as the JAX package wires it: ``_init_train`` builds the run's
flight recorder (``telemetry.configure``), each ``train_one_iter``
appends one record from values the host already holds (``_record_flight``:
no synchronise, no launch), and the OOM ladder's exhaustion flushes it;
the phases are ``profiling`` scopes (``gradients``, ``grow_tree``,
``finalize_tree``, ``score_update``, the grower's ``hist_pass`` /
``split_search`` / ``apply_split``). ``enable_serve_mode`` puts the
booster's predict engines in serve mode (``models/predict_engine.py``).

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

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import Dataset, _to_2d_float
from ..binning import BIN_TYPE_NUMERICAL, K_ZERO_THRESHOLD
from ..metrics import Metric, create_metric, default_metric_for_objective
from ..objectives import ObjectiveFunction, create_objective
from ..ops import cuda_hist
from ..ops.histogram import resolve_method
from ..ops.split import SplitParams
from ..utils import log, profiling
from ..utils.ordered import linear_row_sum
from ..utils.random import bits, fold_in, prng_key, stable_argsort, uniform
from .grower import CegbSpec, grow_tree
from .predict_engine import (PredictEngine, host_tree_depth, slice_rows,
                             tensor_rows)
from .tree import (HostTree, TreeArrays, empty_tree, predict_leaf_bins,
                   predict_value_bins, stack_trees)


_RAW_CHUNK = 65536      # rows a bundled model's raw predict densifies at once

# bit -> source name of the numerics sentinel flag word (the JAX package's
# table; the port's grower raises bit 2, the histogram sums)
_SENTINEL_SOURCES = (
    (0, "gradients"),
    (1, "hessians"),
    (2, "histogram sums (in-program, Pallas/XLA histogram path)"),
    (3, "leaf outputs"),
    (4, "score delta"),
)


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
        # prediction: the stacked trees, the engines over them and the
        # model trees of the host paths and pred_contrib (each checked
        # against the tree objects it was built from)
        self._stacked_cache = None
        self._engine_cache: Dict[tuple, tuple] = {}
        self._engine_lock = threading.Lock()
        # a sharded predict's devices (predict_sharded): None = every
        # visible device; a list of several entries for one device shards
        # on it alone (no parameter: the engine's constructor argument)
        self.predict_devices: Optional[list] = None
        self._mt_cache: Dict[int, tuple] = {}
        # the OOM ladder's position (_maybe_degrade_oom): rungs 1-2 set the
        # feature-blocked pass's column width, rung 3 (and the predict
        # rung) the predict chunk. It rides the trainer state, so a resumed
        # run trains with the same degraded configuration
        self._oom_level = 0
        self._oom_block = 0
        self._oom_predict_chunk = 0
        # the measured histogram geometry (_hist_tuning); rides the trainer
        # state with its epilogue key
        self._hist_tuned: Optional[dict] = None
        self._warned_pool = False
        if train_set is not None:
            self._init_train(train_set)

    # ------------------------------------------------------------ setup
    _fault_plan = None           # set per training run (utils/faults)
    _bag_stale = False           # a restore marks the bag for re-derivation
    _parallel = None             # the distributed learner (tree_learner)
    _pre_part = False            # a pre-partitioned train set
    _flight = None               # the run's flight recorder (telemetry.py);
                                 # None for loaded boosters or when off
    _mem_telemetry = True        # memory in every flight record
                                 # (telemetry_memory)
    _serve_mode = False          # a ServeFrontend registered the booster

    def enable_serve_mode(self, on: bool = True) -> None:
        """Serve mode for this booster's predict engines: their flushes go
        through per-bucket slots of preallocated buffers
        (``PredictEngine._serve_chunk``). Applied to the engines already
        built too; turning it off releases their slots."""
        self._serve_mode = bool(on)
        with self._engine_lock:
            for _, eng in self._engine_cache.values():
                eng.serve_mode = self._serve_mode
                if not self._serve_mode:
                    eng.release_serve_slots()

    def _init_train(self, train_set: Dataset) -> None:
        from .. import distributed
        from ..utils import faults
        train_set.construct()
        cfg = self.config
        self._fault_plan = faults.plan_from(cfg)
        # a fresh training run starts with a clean degradation log: its
        # health snapshots and checkpoint manifests must not inherit an
        # earlier booster's OOM events
        distributed.reset_degradations()
        # a fresh flight-recorder ring a training run, fed host values only
        # (train_one_iter); the context header fills after the first step
        from .. import telemetry
        self._flight = telemetry.configure(cfg)
        self._mem_telemetry = bool(getattr(cfg, "telemetry_memory", True))
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
        # pre-partitioned (distributed.load_partitioned): the scores,
        # gradients and metrics cover this rank's rows only (the
        # reference's per-machine score partition, score_updater.hpp)
        self._pre_part = bool(getattr(train_set, "is_pre_partitioned", False))
        if self._pre_part and cfg.tree_learner not in ("data", "voting"):
            log.fatal("pre-partitioned Datasets shard rows: set "
                      "tree_learner=data or voting")
        n = train_set.num_local_data if self._pre_part else train_set.num_data
        self._n_score_rows = n
        # boost_from_average init scores (gbdt.cpp:333-367), folded as a
        # bias into the first tree of each class (gbdt.cpp:414-416 AddBias)
        # unless the train set has an init score (gbdt.cpp:348)
        self.init_scores = [0.0] * k
        if obj is not None and cfg.boost_from_average:
            self.init_scores = [float(obj.boost_from_score(c))
                                for c in range(k)]
            if self._pre_part:
                # the mean of the ranks' local init scores, in float64
                # (GlobalSyncUpByMean, gbdt.cpp:338-341)
                from ..distributed import allgather_f64
                self.init_scores = [float(v) for v in allgather_f64(
                    np.asarray(self.init_scores)).mean(axis=0)]
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
        self._setup_tree_learner()

    def _setup_tree_learner(self) -> None:
        """tree_learner dispatch (reference: TreeLearner factory,
        tree_learner.h:104; the JAX package's ``_setup_tree_learner`` and
        its refusals): a distributed learner runs ``ParallelGrower`` over
        the calling thread's or process's network
        (``network.current()``)."""
        from .. import network
        cfg = self.config
        mode = cfg.tree_learner
        if mode in ("serial", None, ""):
            self._parallel = None
            return
        from ..parallel.learners import PARALLEL_MODES, ParallelGrower
        if mode not in PARALLEL_MODES:
            log.fatal(f"Unknown tree learner type {mode}")
        unsupported = []
        if self.train_set.has_sparse_cols:
            unsupported.append("sparse device storage (construct the "
                               "Dataset with enable_sparse=false)")
        if self._cegb is not None:
            unsupported.append("CEGB")
        if self._interaction_groups is not None:
            unsupported.append("interaction_constraints")
        if self._use_bynode:
            unsupported.append("feature_fraction_bynode")
        if cfg.linear_tree:
            unsupported.append("linear_tree")
        if mode == "voting" and self._forced_splits is not None:
            # voting keeps histograms local; a forced threshold's sums
            # would come from one rank only
            unsupported.append("forced splits (voting)")
        if unsupported:
            log.fatal(f"tree_learner={mode} does not support: "
                      f"{', '.join(unsupported)}")
        net = network.current()
        existing = getattr(self, "_parallel", None)
        if existing is not None and existing.mode == mode \
                and existing.net is net:
            return
        if net.world == 1:
            # a gang of 1 runs no collective: its device is the Dataset's
            # (a process that joined no gang trains on the card too)
            log.info(f"tree_learner={mode} with a single rank: running the "
                     f"distributed learner on a gang of 1")
        elif net.device.type != self.device.type:
            log.fatal(f"tree_learner={mode}: the network's ranks hold "
                      f"{net.device} but the Dataset lives on {self.device}")
        self._parallel = ParallelGrower(mode, net)

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
        if self._parallel is not None:
            return ()       # serial-only (the JAX package's rule)
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
                      and self._parallel is None
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
        keyed on the period's first iteration, at a period start or after
        a restore (``_bag_stale``, the JAX package's rule)."""
        cfg = self.config
        mode = self._bagging_mode()
        if mode == "off" or (self.iter % cfg.bagging_freq != 0
                             and not self._bag_stale):
            return
        # keyed on the period's first iteration: a restored run re-derives
        # the exact mid-period bag (_restore_bagging)
        self._bag_stale = False
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
        if self._pre_part:
            # one draw over the gang's rows, this rank's block of it: the
            # bag does not depend on how the rows are partitioned
            start = ts.local_row_start
            u = u[start:start + self._n_score_rows]
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
                    torch.zeros((self._n_score_rows,), dtype=torch.int32,
                                device=self.device), 0.0)
        if self._parallel is not None:
            return self._parallel(
                ts.binsT, g, h, mask, ts.feature_meta, self.split_params,
                fmask, ts.missing_bin, pre_part=self._pre_part,
                bundle=ts.bundle_meta, forced=self._forced_splits,
                counters=self._hist_counters, max_leaves=cfg.num_leaves,
                num_bins=ts.max_num_bins, max_depth=cfg.max_depth,
                exact=cfg.tree_growth_mode == "exact",
                tile_leaves=cfg.tile_leaves,
                hist_subtraction=cfg.hist_subtraction,
                with_categorical=ts.has_categorical,
                hist_method=self._hist_method, rng_key=iter_key,
                mono_mode=self._mono_mode if self._with_monotone else "",
                extra_trees=cfg.extra_trees, hist_dp=cfg.gpu_use_dp,
                numerics_sentinels=cfg.check_numerics,
                vote_top_k=cfg.top_k)
        sp = ((ts.sp_cols, ts.sp_rows, ts.sp_bins, ts.sp_default)
              if ts.has_sparse_cols else None)
        fb = self._feature_block()
        fused = self._split_fusion_on(fb)
        tile, geometry = self._hist_tuning(fused, fb)
        return grow_tree(
            ts.binsT, g, h, ts.feature_meta, self.split_params,
            ts.missing_bin, max_leaves=cfg.num_leaves,
            num_bins=ts.max_num_bins, max_depth=cfg.max_depth,
            exact=cfg.tree_growth_mode == "exact",
            tile_leaves=tile, hist_geometry=geometry,
            hist_subtraction=cfg.hist_subtraction and fb == 0,
            compaction_ladder=() if fb else self._compaction_ladder(),
            split_fusion=fused,
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
            forced=self._forced_splits, hist_dp=cfg.gpu_use_dp,
            feature_block=fb, numerics_sentinels=cfg.check_numerics)

    def _hist_tuning(self, epilogue: bool, feature_block: int = 0):
        """(tile_leaves, hist_tile geometry) of the serial learner's passes
        (the JAX package's ``_hist_tuning``): an explicit ``hist_block``
        wins (rows a block, the rest default, no sweep); with
        ``hist_autotune`` the measured winner of ``ops/cuda_hist
        .autotune_hist`` for this shape bucket (the defaults off the card);
        else the defaults (None). The feature-blocked pass
        (``feature_block`` > 0) keeps the defaults: the sweep would copy
        every column of its sample, the memory that pass exists to save,
        at a width its passes never launch. ``tile_leaves`` stays
        structural. The winner is kept on the booster and rides the
        trainer state; a dict
        whose ``epilogue`` key is not this pass's form (a resume across
        ``split_fusion``) is discarded and measured again. Every geometry
        gives the same planes, so none of this changes a bit."""
        cfg = self.config
        if cfg.hist_block:
            return cfg.tile_leaves, cuda_hist.HistGeometry(cfg.hist_block)
        if not cfg.hist_autotune or self.train_set is None or feature_block:
            return cfg.tile_leaves, None
        hit = self._hist_tuned
        if hit is not None and hit.get("epilogue", False) != epilogue:
            log.info(f"hist_tile autotune: the kept geometry was tuned with "
                     f"epilogue={hit.get('epilogue', False)}; re-tuning for "
                     f"epilogue={epilogue}")
            hit = None
        if hit is None:
            ts = self.train_set
            hit = cuda_hist.autotune_hist(
                ts.binsT, ts.max_num_bins,
                q8=self._hist_method.endswith("_q8"), epilogue=epilogue)
            self._hist_tuned = hit
        return (cfg.tile_leaves or hit["tile_leaves"],
                cuda_hist.tuned_geometry(hit))

    # ------------------------------------------------ memory-bounded growth
    def _resident_hist_bytes(self) -> int:
        """Bytes of the resident [L, F, B, 3] float32 histogram state."""
        ts = self.train_set
        return (self.config.num_leaves * ts.num_used_features()
                * ts.max_num_bins * 3 * 4)

    def _blocked_refusal(self) -> Optional[str]:
        """Why the feature-blocked pass cannot run this configuration (the
        JAX package's list: CEGB, forced splits, intermediate and advanced
        monotone constraints, the bagging subset copy, f64 and q8
        histograms, sparse device columns), or None."""
        cfg = self.config
        subset_possible = (cfg.bagging_freq > 0
                           and cfg.bagging_fraction <= 0.5
                           and cfg.pos_bagging_fraction >= 1.0
                           and cfg.neg_bagging_fraction >= 1.0
                           and self._cegb is None
                           and not cfg.linear_tree)
        for cond, why in (
                (self._cegb is not None, "CEGB"),
                (self._forced_splits is not None, "forced splits"),
                (self._with_monotone and self._mono_mode != "basic",
                 f"{self._mono_mode} monotone constraints"),
                (subset_possible, "the bagging subset copy"),
                (cfg.gpu_use_dp, "f64 histograms"),
                (self._hist_method.endswith("_q8"), "q8 histograms"),
                (self.train_set.has_sparse_cols, "sparse device columns")):
            if cond:
                return why
        return None

    def _block_width(self, cap: int) -> int:
        """Columns a blocked pass takes under a cap of ``cap`` bytes (the
        JAX package's formula, P the tile's slots): each column's
        transient is the [P, B, 3] tile plus ~8 search-sized temporaries,
        at least 16 columns a block."""
        cfg = self.config
        ts = self.train_set
        f_cols = ts.num_used_features()
        P = min(cfg.tile_leaves or cuda_hist.structural_tile_leaves(),
                cfg.num_leaves)
        per_f = P * ts.max_num_bins * 4 * (3 + 8)
        return max(16, min(f_cols, cap // per_f))

    def _feature_block(self) -> int:
        """Column-block width of the grower's memory-bounded mode, or 0 to
        keep the resident [L, F, B, 3] histogram state (the JAX package's
        ``_feature_block``). Engages when that state would exceed
        ``histogram_pool_size`` (MB; <= 0 means a 2 GiB cap, not
        unlimited), the analog of the reference's HistogramPool
        (feature_histogram.hpp:1095-1290): over-cap leaves pay
        recomputation instead of residency. The OOM ladder's rungs 1-2
        (``_oom_block``) narrow it further, or engage it below the cap."""
        cfg = self.config
        if self._parallel is not None:
            return 0        # the learners keep resident planes (JAX's rule)
        hist_bytes = self._resident_hist_bytes()
        pool = cfg.histogram_pool_size
        cap = int(pool * 1024 * 1024) if pool and pool > 0 else 2 << 30
        fb = 0
        if hist_bytes > cap:
            if self._blocked_refusal() is not None:
                if not self._warned_pool:
                    self._warned_pool = True
                    log.warning(
                        f"histogram state ({hist_bytes / 2**20:.0f} MB) "
                        f"exceeds the pool cap ({cap / 2**20:.0f} MB) but "
                        "the memory-bounded mode does not support "
                        "CEGB/forced-splits/box-monotone/subset-bagging/"
                        "f64/q8 here; keeping the resident state (may OOM)")
            else:
                fb = self._block_width(cap)
                if not self._warned_pool:
                    self._warned_pool = True
                    log.warning(
                        f"histogram state ({hist_bytes / 2**20:.0f} MB) "
                        f"exceeds the pool cap ({cap / 2**20:.0f} MB): "
                        f"memory-bounded growth engaged ({fb} feature "
                        "columns per pass, no histogram subtraction — ~2x "
                        "the histogram passes)")
        if self._oom_block:
            fb = min(fb, self._oom_block) if fb else self._oom_block
        return fb

    def _split_fusion_on(self, fb: int = 0) -> bool:
        """Resolve ``split_fusion`` as the JAX package does: "auto" fuses
        the split search into the tile passes unless the classic search
        has to run -- categorical features, EFB bundles, forced splits,
        CEGB, extra_trees, by-node sampling, intermediate or advanced
        monotone constraints, a non-positive feature_contri, f64 histograms
        (``gpu_use_dp``), sparse device columns or the feature-blocked
        pass (``fb`` > 0; the reasons the port has, in the JAX package's
        order); "on" raises with any; "off" never fuses. Basic monotone
        constraints, interaction constraints and a positive feature_contri
        stay fused."""
        cfg = self.config
        mode = cfg.split_fusion
        if mode == "off" or self.train_set is None:
            return False
        ts = self.train_set
        reasons = []
        if self._parallel is not None:
            reasons.append("parallel learner")
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
        if fb:
            reasons.append("memory-bounded (feature-blocked) growth")
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
        iteration has a split.

        It hosts the OOM ladder, as the JAX package's does: a device
        allocation failure (``faults.is_resource_exhausted``) takes the
        booster one rung down (``_maybe_degrade_oom``) and retries the
        iteration, which is safe while the failed attempt added no tree."""
        from .. import distributed
        from ..utils import faults
        it = self.iter
        # flight-recorder bookkeeping (host snapshots only; the record is
        # built in the finally, so a failed step leaves an in-flight one)
        flight = self._flight
        t_rec = time.time() if flight is not None else 0.0
        disp0 = profiling.dispatch_stats() if flight is not None else None
        sc0 = profiling.scopes() \
            if flight is not None and profiling.enabled() else None
        distributed.notify_step_begin(it)
        try:
            while True:
                ntrees_before = len(self.trees)
                try:
                    stop = self._train_one_iter_impl(grad, hess)
                    break
                except Exception as e:
                    if not self._maybe_degrade_oom(e, ntrees_before):
                        raise
                    # the retry runs under a fresh clock, with the first
                    # step's watchdog exemption
                    distributed.notify_step_retry(it)
        finally:
            distributed.notify_step_end(it if self.iter > it else it - 1)
            if flight is not None:
                # telemetry must not end the run it observes, and an error
                # escaping this finally would replace a real training
                # exception: a failing recorder disarms itself with one
                # warning, as in the JAX package
                try:
                    self._record_flight(flight, it, t_rec, disp0, sc0)
                except Exception as e:     # noqa: BLE001 -- see above
                    self._flight = None
                    log.warning(f"flight recorder disabled after record "
                                f"failure: {e}")
        if self._fault_plan is not None:
            # the silent-corruption fault: one score-cache bit flipped on
            # one rank after the iteration completed
            flipped = faults.maybe_flip_score(self._fault_plan, it,
                                              self.train_score)
            if flipped is not None:
                self.train_score = flipped
        return stop

    def _train_one_iter_impl(self, grad=None, hess=None) -> bool:
        from ..utils import faults
        cfg = self.config
        k = self.num_tree_per_iteration
        # the simulated OOM raises before any state changes, so the retry
        # in train_one_iter is safe
        faults.maybe_oom(self._fault_plan, self.iter)
        self._update_bagging()
        mask = self._bag_mask
        with profiling.timer("gradients", sync=self.device):
            if grad is None:
                g, h = self._gradients()
            else:
                g, h = self._custom_gradients(grad, hess)
        if self._fault_plan is not None:
            g, h = faults.maybe_nan_grad(self._fault_plan, self.iter, g, h)
            g, h = faults.maybe_nan_hist(self._fault_plan, self.iter, g, h)
        if cfg.check_numerics:
            self._check_numerics_grad(g, h)
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
            coll0 = (self._coll_bytes() if profiling.enabled() else 0)
            with profiling.timer_sync("grow_tree") as grow_scope:
                tree, leaf_id, streamed = self._grow_one(gc, hc, mask, fmask,
                                                         iter_key)
                grow_scope.sync(leaf_id)
            if cfg.check_numerics and self._hist_counters.pop("sentinel", 0):
                self._check_sentinel_flags(1 << 2)
            self._rows_streamed += streamed
            if profiling.enabled():
                # the tree's histogram rows and collective bytes (host
                # values the grower and the network already hold)
                profiling.counter("hist_rows_streamed", float(streamed))
                profiling.counter("hist_coll_bytes",
                                  float(self._coll_bytes() - coll0))
            lin = None
            if cfg.linear_tree:
                # the first tree counts an init model's trees too
                # (reference: models_.size() < num_tree_per_iteration_)
                lin = self._fit_linear_leaves(
                    tree, leaf_id, gc, hc, mask,
                    len(self.trees) < k and self.loaded_iters == 0)
            with profiling.timer("finalize_tree", sync=self.device):
                tree, had_split = self._finalize_tree(tree, leaf_id, c)
            no_split = no_split and not had_split
            with profiling.timer("score_update", sync=self.device):
                self._add_tree(tree, leaf_id, c, lin)
                self._bias_after_score(c, had_split)
        self.iter += 1
        return no_split

    # ---------------------------------------------------- numerics guard
    def _check_numerics_grad(self, g: torch.Tensor, h: torch.Tensor) -> None:
        """check_numerics fail-fast: NaN/Inf gradients or hessians poison
        every histogram they touch and surface much later as garbage
        splits, so name the iteration and the count now."""
        bad_g = int((~torch.isfinite(g)).sum())
        bad_h = int((~torch.isfinite(h)).sum())
        if bad_g or bad_h:
            log.fatal(
                f"check_numerics: iteration {self.iter}: {bad_g} non-finite "
                f"gradient and {bad_h} non-finite hessian values out of "
                f"{int(np.prod(tuple(g.shape)))} — failing fast before they "
                f"poison the histograms (check the objective / custom fobj, "
                f"learning_rate, and input features)")

    def _check_numerics_leaves(self, tree: TreeArrays,
                               num_leaves: int) -> None:
        """check_numerics on a finalized tree's leaf outputs."""
        lv = tree.leaf_value[:max(num_leaves, 1)].detach().cpu().numpy()
        bad = int(np.sum(~np.isfinite(lv)))
        if bad:
            log.fatal(
                f"check_numerics: iteration {self.iter}: {bad} of "
                f"{max(num_leaves, 1)} leaf outputs in the new tree are "
                f"non-finite — failing fast before the score caches are "
                f"poisoned")

    def _check_sentinel_flags(self, flags: int,
                              iteration: Optional[int] = None) -> None:
        """Judge a sentinel flag word: nonzero bits name which sources
        carried NaN/Inf (``_SENTINEL_SOURCES``); the grower raises bit 2
        when its final state's leaf sums, outputs or resident planes hold
        one."""
        if not flags:
            return
        it = self.iter if iteration is None else iteration
        sources = [name for bit, name in _SENTINEL_SOURCES
                   if flags & (1 << bit)]
        log.fatal(
            f"check_numerics: iteration {it}: in-program sentinels "
            f"flagged non-finite values in {', '.join(sources)} "
            f"(flag word 0b{flags:05b}) — failing fast before they poison "
            f"the model on disk (check the objective / custom fobj, "
            f"learning_rate, and input features)")

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
        tree = _shrink_tree(tree, self.shrinkage_rate)
        if self.config.check_numerics:
            self._check_numerics_leaves(tree, num_leaves)
        return tree, had_split

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
        if self._pre_part:
            log.fatal("rollback_one_iter is not supported with "
                      "pre-partitioned Datasets")
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

    # ------------------------------------------------ OOM degradation
    def _maybe_degrade_oom(self, exc: BaseException,
                           ntrees_before: int) -> bool:
        """Take the booster ONE rung down the OOM ladder and say whether
        the failed iteration may be retried. The JAX package's rungs are
        TPU rungs (a smaller VMEM row block, then the XLA scatter); on the
        card each rung frees device memory instead:

          1. the feature-blocked pass (no [L, F, B, 3] state; the column
             blocks histogrammed and searched one at a time), at the width
             ``_feature_block`` gives for a cap of a quarter of the
             resident state's bytes;
          2. the same pass at the 16-column floor;
          3. a quarter of the predict chunk (the eval and predict
             engines hold fewer rows).

        Every rung is recorded (``distributed.record_degradation``, so
        ``health_snapshot()`` and every later checkpoint manifest) and
        logged as a WARNING, and the degraded configuration rides the
        trainer state. False (the error re-raises) when the gate
        ``hist_oom_fallback`` is off, the error is not an allocation
        failure, the failed attempt already added a tree, the ladder is
        spent, or the configuration refuses the blocked pass (rungs 1-2:
        the warning says why)."""
        from .. import distributed
        from ..utils import faults
        if not self.config.hist_oom_fallback \
                or not faults.is_resource_exhausted(exc):
            return False
        if len(self.trees) != ntrees_before:
            return False
        if self._oom_level >= 3:
            # the ladder is spent: the error re-raises and ends the run;
            # the flushed ring is the post-mortem naming every rung taken
            self._flush_flight(
                f"oom-exhausted: ladder spent at iteration {self.iter} "
                f"(level {self._oom_level}/3)")
            return False
        if self._oom_level < 2:
            why = self._blocked_refusal()
            if why is not None:
                log.warning(
                    f"out of device memory in boosting iteration "
                    f"{self.iter}: OOM ladder rung {self._oom_level + 1} is "
                    f"the feature-blocked pass, which this configuration "
                    f"refuses ({why}); re-raising")
                return False
        self._oom_level += 1
        if self._oom_level == 1:
            self._oom_block = self._block_width(
                self._resident_hist_bytes() // 4)
            action = f"feature_block -> {self._oom_block}"
        elif self._oom_level == 2:
            self._oom_block = 16
            action = f"feature_block -> {self._oom_block} (floor)"
        else:
            base = self.config.predict_chunk_rows or (1 << 22)
            self._oom_predict_chunk = max(1 << 14, base // 4)
            action = f"predict_chunk_rows -> {self._oom_predict_chunk}"
        with self._engine_lock:
            self._engine_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        distributed.record_degradation({
            "kind": "oom", "iteration": int(self.iter),
            "level": int(self._oom_level), "action": action,
            "error": str(exc)[:200], **self._oom_memory_evidence()})
        profiling.set_gauge("hist_oom_degrade_level", self._oom_level)
        log.warning(
            f"RESOURCE_EXHAUSTED in boosting iteration {self.iter}: "
            f"degrading ({action}; ladder rung {self._oom_level}/3) and "
            f"retrying — the job continues DEGRADED (recorded in "
            f"health_snapshot() and checkpoint manifests)")
        return True

    def _oom_memory_evidence(self) -> dict:
        """What every OOM degradation event carries, as in the JAX
        package: the memory sample at the failure (``profiling
        .sample_memory``: device fields null on the CPU) and the bytes
        the traffic model's bytes for one histogram pass
        (``predicted_hist_bytes``: ``ops/cuda_hist.traffic_model``'s full
        form at this shape, a static count) and the resident [L, F, B, 3]
        state's (``resident_hist_bytes``)."""
        ts = self.train_set
        p = min(self.config.tile_leaves
                or cuda_hist.structural_tile_leaves(), self.config.num_leaves)
        mode = "q8" if self._hist_method.endswith("_q8") else "f32"
        one_pass = cuda_hist.traffic_model(
            int(ts.num_data), ts.num_used_features(), int(ts.max_num_bins),
            p, mode=mode, bin_bytes=ts.binsT.element_size())["full"]
        return {"memory": profiling.sample_memory(),
                "predicted_hist_bytes": int(one_pass),
                "resident_hist_bytes": int(self._resident_hist_bytes())}

    def _maybe_degrade_predict_oom(self, exc: BaseException) -> bool:
        """The predict path's entry to rung 3: halve the effective predict
        chunk (again and again, floor 16k rows) and retry. It leaves
        ``_oom_level`` alone: chunking is exact, and a predict OOM must not
        spend the rungs a later training OOM may need."""
        from .. import distributed
        from ..utils import faults
        nxt = faults.next_predict_chunk(
            exc, self._oom_predict_chunk or self.config.predict_chunk_rows,
            self.config.hist_oom_fallback)
        if nxt is None:
            return False
        with self._engine_lock:
            self._oom_predict_chunk = nxt
            self._engine_cache.clear()
        action = f"predict_chunk_rows -> {self._oom_predict_chunk}"
        distributed.record_degradation({
            "kind": "oom_predict", "iteration": int(self.iter),
            "level": int(self._oom_level), "action": action,
            "error": str(exc)[:200], **self._oom_memory_evidence()})
        profiling.set_gauge("predict_oom_chunk_rows",
                            float(self._oom_predict_chunk))
        log.warning(f"RESOURCE_EXHAUSTED in predict: degrading ({action}) "
                    f"and retrying")
        return True

    def _coll_bytes(self) -> int:
        """This rank's collective input bytes so far (the network's
        counters; 0 in a gang of one)."""
        from .. import network
        return int(network.current().totals()["bytes"])

    # --------------------------------------------------- flight recorder
    def _flush_flight(self, reason: str) -> Optional[str]:
        """Flush this booster's flight recorder (not the process's: in a
        process of several boosters, cv folds, the module slot holds the
        last one's ring)."""
        if self._flight is None:
            return None
        return self._flight.flush(reason)

    def _record_flight(self, flight, it: int, t0: float, disp0,
                       sc0) -> None:
        """Append the flight record of the update() that began at
        iteration ``it`` (completed False when the step failed). Reads host
        state only: the phase deltas from the profiling scopes and the
        cumulative rows and collective bytes of the histogram passes from
        its counters (both empty when profiling is off), the OOM rung,
        heartbeat ages and, with ``telemetry_memory``, a memory sample (an
        allocator query and a /proc read), which also feeds the memory
        gauges."""
        from .. import distributed
        consumed = self.iter - it
        phases = None
        if sc0 is not None:
            phases = {}
            for name, sc in profiling.scopes().items():
                d = sc["total_s"] - sc0.get(name, {}).get("total_s", 0.0)
                if d > 0:
                    phases[name] = round(d, 6)
        # the unfused iteration judges its numerics inside the step (a
        # failure raises and the train-error flush names it)
        sentinel = "ok" if self.config.check_numerics else "off"
        counters = profiling.counters() if sc0 is not None else {}
        hb = distributed.heartbeat_ages()
        mem = None
        if self._mem_telemetry:
            mem = profiling.sample_memory()
            for key, val in mem.items():
                if val is not None:
                    profiling.set_gauge(key, float(val))
            rss_peak = profiling.host_rss_peak_bytes()
            if rss_peak is not None:
                profiling.set_gauge("host_rss_peak_bytes", float(rss_peak))
        flight.record(
            iteration=it, iters=max(consumed, 1), completed=consumed > 0,
            wall_s=time.time() - t0, phases=phases,
            dispatch=profiling.dispatch_delta(disp0) if disp0 else None,
            sentinel=sentinel, oom_level=self._oom_level,
            coll_bytes=counters.get("hist_coll_bytes"),
            rows_streamed=counters.get("hist_rows_streamed"),
            heartbeat_age=(max(hb.values()) if hb else None), mem=mem)
        if not flight.has_context:
            # the resolved execution context, after the first step
            flight.set_context(
                backend=self.device.type, boosting=self.name,
                hist_method=self._hist_method,
                split_fusion=bool(self._split_fusion_on(
                    self._feature_block())),
                quantized_grad=bool(getattr(self.config, "quantized_grad",
                                            False)),
                rounds_per_dispatch=1,
                num_leaves=int(self.config.num_leaves),
                tree_learner=self.config.tree_learner)
            # a streamed training set's construct numbers, from the
            # dataset itself: a later construct cannot wipe them
            construct = getattr(self.train_set, "construct_stats", None)
            if construct:
                flight.set_context(construct=dict(construct))

    def _predict_chunk_rows(self) -> int:
        """``predict_chunk_rows`` under the predict rung's override."""
        chunk = self.config.predict_chunk_rows
        if self._oom_predict_chunk:
            chunk = (self._oom_predict_chunk if not chunk
                     else min(chunk, self._oom_predict_chunk))
        return chunk

    # ------------------------------------------------ checkpoint/resume
    def get_trainer_state(self) -> dict:
        """Complete trainer state for a checkpoint (``checkpoint.py``):
        everything a resume needs to continue bit-identically, as numpy
        arrays and plain Python -- the exact float32 score caches (one
        ``.cpu()`` each), the trees, the model trees, the biases and init
        scores, the feature-fraction generator, the rows streamed, an
        init model's text and the OOM ladder's position. The bagging and
        GOSS draws are keyed on the iteration and need no state."""
        cegb = None
        if self._cegb is not None:
            ru = self._cegb.state["row_used"]
            cegb = {"used_split": np.array(self._cegb.state["used_split"]),
                    "row_used": None if ru is None else ru.cpu().numpy()}
        state = {
            "name": self.name,
            "iter": int(self.iter),
            "trees": [t.numpy() for t in self.trees],
            "host_trees": list(self.host_trees),
            "tree_bias": list(self.tree_bias),
            "init_scores": list(self.init_scores),
            "train_score": (self.train_score.detach().cpu().numpy()
                            if self.train_score is not None else None),
            "valid_scores": [s.detach().cpu().numpy()
                             for s in self._valid_scores],
            "feat_rng_state": self._feat_rng.get_state(),
            "rows_streamed": float(self._rows_streamed),
            "hist_counters": dict(self._hist_counters),
            # no counterpart in the port: the measured histogram method
            # (one histogram path) and the collective bytes (one process)
            "measured_hm": None,
            "hist_tuned": self._hist_tuned,
            "coll_bytes": None,
            "oom_degrade": ({"level": self._oom_level,
                             "block": self._oom_block,
                             "predict_chunk": self._oom_predict_chunk}
                            if (self._oom_level or self._oom_predict_chunk)
                            else None),
            "cegb_state": cegb,
            "loaded_iters": self.loaded_iters,
            "loaded_model_text": None,
        }
        if self.loaded is not None:
            from ..io.model_text import dump_model_text
            state["loaded_model_text"] = dump_model_text(self.loaded)
        return state

    def set_trainer_state(self, state: dict) -> None:
        """Inverse of :meth:`get_trainer_state`, applied to a freshly
        constructed booster over the same dataset and params."""
        if state.get("name") != self.name:
            log.fatal(f"checkpoint was written by "
                      f"boosting={state.get('name')!r}; this booster is "
                      f"boosting={self.name!r}")
        if len(state["valid_scores"]) != len(self._valid_scores):
            log.fatal(f"checkpoint was written with "
                      f"{len(state['valid_scores'])} validation sets; this "
                      f"run has {len(self._valid_scores)} — pass the same "
                      f"valid_sets in the same order")
        self.iter = int(state["iter"])
        self.trees = [TreeArrays(*(torch.as_tensor(np.asarray(a))
                                   for a in t)) for t in state["trees"]]
        self.host_trees = list(state["host_trees"])
        self.tree_bias = list(state["tree_bias"])
        self.init_scores = list(state["init_scores"])
        if state["train_score"] is not None:
            self.train_score = torch.from_numpy(
                np.ascontiguousarray(state["train_score"])).to(self.device)
        self._valid_scores = [
            torch.from_numpy(np.ascontiguousarray(s)).to(vs.device)
            for s, vs in zip(state["valid_scores"], self.valid_sets)]
        self._feat_rng.set_state(state["feat_rng_state"])
        self._rows_streamed = float(state["rows_streamed"])
        self._hist_counters = dict(state.get("hist_counters", {}))
        if state.get("hist_tuned") is not None:
            self._hist_tuned = dict(state["hist_tuned"])
        od = state.get("oom_degrade")
        if od:
            self._oom_level = int(od.get("level", 0))
            self._oom_block = int(od.get("block", 0))
            self._oom_predict_chunk = int(od.get("predict_chunk", 0))
        cs = state.get("cegb_state")
        if cs is not None and self._cegb is not None:
            self._cegb.state["used_split"] = np.array(cs["used_split"])
            if cs["row_used"] is not None:
                self._cegb.state["row_used"] = torch.from_numpy(
                    cs["row_used"]).to(self.device)
        if state.get("loaded_model_text"):
            from ..io.model_text import load_model
            self.loaded = load_model(state["loaded_model_text"], self.config)
            self.loaded_iters = int(state["loaded_iters"])
        self._stacked_cache = None
        with self._engine_lock:
            self._engine_cache.clear()
        self._mt_cache.clear()
        self._bag_frac = None
        self._restore_bagging()

    def _restore_bagging(self) -> None:
        """Recreate the bag active at the restored iteration: the draw is
        keyed on the period's first iteration (``_update_bagging``), so
        marking it stale makes the next iteration re-derive the exact
        mid-period mask or subset; no generator state to keep."""
        self._bag_stale = True

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
        """[start, end) over every iteration, an init model's first;
        ``num_iteration`` counts from ``start_iteration`` (reference: c_api
        predict semantics, gbdt.h num_iteration_for_pred_)."""
        total = self.loaded_iters + len(self.trees) // \
            self.num_tree_per_iteration
        if num_iteration is None or num_iteration <= 0:
            return start_iteration, total
        return start_iteration, min(start_iteration + num_iteration, total)

    def _prep_predict_X(self, X):
        """The predict-time feature matrix: pandas category columns mapped
        through the training category lists first; scipy-sparse input
        passes through (binned column by column, not densified). A wrong
        feature count, a non-numeric column, or a non-finite value the
        trained bin mappers cannot route (NaN in a feature trained without
        missing values; +-Inf in a feature whose range never saw it) raises
        a ValueError naming the column and row; NaN in a feature trained
        with missing values, and in a categorical feature, stays valid.
        ``predict_disable_shape_check`` turns every check off."""
        from ..basic import _is_scipy_sparse
        validate = not self.config.predict_disable_shape_check
        if _is_scipy_sparse(X):
            if validate:
                self._validate_predict_matrix(X, sparse=True)
            return X
        raw = X
        X = self.train_set._pandas_to_codes(X)
        try:
            X = _to_2d_float(X)
        except (ValueError, TypeError) as e:
            self._raise_bad_dtype(raw, e)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if validate:
            self._validate_predict_matrix(X, sparse=False)
        return X

    def _raise_bad_dtype(self, raw, cause) -> None:
        """Name the first non-numeric column of a failed conversion."""
        cols = None
        if hasattr(raw, "dtypes"):
            for ci, dt in enumerate(raw.dtypes):
                if dt == object or str(dt).startswith(("datetime", "str")):
                    cols = ci
                    break
        elif getattr(raw, "ndim", 0) == 2:
            for ci in range(raw.shape[1]):
                try:
                    np.asarray(raw[:, ci], dtype=np.float64)
                except (ValueError, TypeError):
                    cols = ci
                    break
        where = f"feature column {cols}" if cols is not None \
            else "the input"
        raise ValueError(
            f"predict input has non-numeric data in {where}: {cause}. "
            f"Convert categoricals to codes (or pandas category dtype) "
            f"before predicting.") from cause

    def _validate_predict_matrix(self, X, sparse: bool) -> None:
        """Shape and finiteness checks against the trained mappers."""
        expected = self.train_set.num_total_features
        if X.shape[1] != expected:
            raise ValueError(
                f"predict input has {X.shape[1]} feature columns but the "
                f"model was trained with {expected} (set "
                f"predict_disable_shape_check=true to bypass)")
        mappers = self.train_set.mappers
        if sparse:
            data = getattr(X, "data", None)
            flat = (data is not None and hasattr(data, "dtype")
                    and data.dtype.kind in "fiu")
            if flat and (data.size == 0 or bool(np.isfinite(data).all())):
                return
            coo = X.tocoo()
            vals = np.asarray(coo.data, dtype=np.float64) \
                if coo.nnz else np.zeros(0)
            bad = ~np.isfinite(vals)
            for r, c, v in zip(coo.row[bad], coo.col[bad], vals[bad]):
                self._check_nonfinite(float(v), int(r), int(c), mappers)
            return
        # one reduction finds any NaN/Inf; only then walk the columns, one
        # representative row per kind (NaN, +inf, -inf route differently)
        with np.errstate(over="ignore", invalid="ignore"):
            total = float(np.sum(X, dtype=np.float64))
        if np.isfinite(total):
            return
        for c in range(X.shape[1]):
            col = X[:, c]
            if np.isfinite(col).all():
                continue
            nan_rows = np.flatnonzero(np.isnan(col))
            if nan_rows.size:
                self._check_nonfinite(np.nan, int(nan_rows[0]), c, mappers)
            for sign in (np.inf, -np.inf):
                rows = np.flatnonzero(col == sign)
                if rows.size:
                    self._check_nonfinite(sign, int(rows[0]), c, mappers)

    def _check_nonfinite(self, v: float, row: int, col: int,
                         mappers) -> None:
        """Raise unless the trained mapper can route this non-finite value
        (NaN: the missing bin, a categorical's other bin, a linear leaf's
        fallback; Inf: only if the training data held it)."""
        from ..binning import BIN_TYPE_CATEGORICAL, MISSING_NONE
        m = mappers[col] if mappers and col < len(mappers) else None
        if m is None or m.bin_type == BIN_TYPE_CATEGORICAL:
            return
        if np.isnan(v):
            if self.config.linear_tree:
                return
            if m.missing_type == MISSING_NONE and not m.is_trivial:
                raise ValueError(
                    f"predict input has NaN at row {row}, feature column "
                    f"{col}, but the model was trained without missing "
                    f"values in that feature — there is no bin to route "
                    f"it to (set predict_disable_shape_check=true to "
                    f"bin it arbitrarily)")
            return
        if m.is_trivial:
            return
        seen = m.max_val if v > 0 else m.min_val
        if not np.isinf(seen):
            raise ValueError(
                f"predict input has {v:+g} at row {row}, feature column "
                f"{col}; the training data for that feature was bounded "
                f"([{m.min_val:g}, {m.max_val:g}]) — an infinite value "
                f"would bin to an arbitrary edge bin (set "
                f"predict_disable_shape_check=true to allow)")

    # ------------------------------------------------- inference engine
    def _stacked(self, n_trees: int) -> Optional[TreeArrays]:
        """The first ``n_trees`` trees stacked, kept while the tree list
        holds the same tree objects (new trees, DART's rescaling, rollback
        and shuffles each replace or drop some)."""
        if n_trees == 0:
            return None
        trees = self.trees[:n_trees]
        hit = self._stacked_cache
        if hit is not None and len(hit[0]) == n_trees and all(
                a is b for a, b in zip(hit[0], trees)):
            return hit[1]
        stacked = stack_trees(trees)
        self._stacked_cache = (list(trees), stacked)
        return stacked

    def _ensemble_depth(self, n_trees: int) -> int:
        """True max leaf depth over the first n_trees trees: the
        depth-bounded traversal's trip count, measured once an engine."""
        d = 0
        for ht in self.host_trees[:n_trees]:
            d = max(d, host_tree_depth(ht.left_child, ht.right_child,
                                       ht.num_leaves))
        return d

    def _predict_engine(self, num_iteration: Optional[int] = None
                        ) -> Optional[PredictEngine]:
        """The engine over the own trees of the first ``num_iteration``
        iterations (all by default), kept while the stacked trees, their
        biases and the predict parameters stay the same; two engines at
        most. The lock makes concurrent first calls build one engine."""
        with self._engine_lock:
            k = self.num_tree_per_iteration
            total = len(self.trees) // k
            use = total if num_iteration is None or num_iteration <= 0 \
                else min(num_iteration, total)
            nt = use * k
            stacked = self._stacked(nt)
            if stacked is None:
                return None
            cfg = self.config
            b = np.asarray(self.tree_bias[:nt], np.float64)
            biases = b if (len(b) == nt and b.size and np.any(b)) else None
            chunk = self._predict_chunk_rows()
            devices = (None if self.predict_devices is None
                       else tuple(str(d) for d in self.predict_devices))
            key = (nt, cfg.predict_accum, chunk,
                   None if biases is None else biases.tobytes(),
                   bool(cfg.predict_sharded), devices)
            hit = self._engine_cache.get(key)
            if hit is not None and hit[0] is stacked:
                return hit[1]
            eng = PredictEngine(
                stacked, k, nt, self._ensemble_depth(nt), biases=biases,
                accum=cfg.predict_accum, chunk_rows=chunk,
                device=self.device,
                bucket_min_rows=cfg.predict_bucket_min_rows,
                sharded=cfg.predict_sharded, devices=devices)
            eng.serve_mode = self._serve_mode
            if len(self._engine_cache) >= 2:
                self._engine_cache.pop(next(iter(self._engine_cache)))
            self._engine_cache[key] = (stacked, eng)
            return eng

    def _convert_on_device(self, s: torch.Tensor) -> np.ndarray:
        """The objective's output conversion of raw scores cast to float32
        (the JAX package's conversion input), run where ``s`` lies; the
        result comes to the host."""
        out = self.objective.convert_output(s.to(torch.float32))
        return out.cpu().numpy() if isinstance(out, torch.Tensor) \
            else np.asarray(out)

    def _host_tree(self, it: int, c: int):
        """The model tree (real thresholds, original features) of class
        ``c`` at iteration ``it``: an init model's own, or the booster's,
        converted once."""
        from ..io.model_text import ModelTree
        k = self.num_tree_per_iteration
        if it < self.loaded_iters:
            return self.loaded.trees[it * k + c]
        idx = (it - self.loaded_iters) * k + c
        mt = self._mt_cache.get(idx)
        if mt is None or mt[0] is not self.host_trees[idx]:
            mt = (self.host_trees[idx],
                  ModelTree.from_host(self.host_trees[idx],
                                      self.train_set.mappers))
            self._mt_cache[idx] = mt
        return mt[1]

    def predict_raw(self, X, num_iteration: Optional[int] = None,
                    start_iteration: int = 0,
                    pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0,
                    _postprocess=None) -> np.ndarray:
        """``_predict_raw_impl`` under the OOM ladder's predict rung: a
        device allocation failure halves the chunk (recorded in
        ``health_snapshot()``) and retries instead of failing the call."""
        while True:
            try:
                return self._predict_raw_impl(
                    X, num_iteration, start_iteration, pred_early_stop,
                    pred_early_stop_freq, pred_early_stop_margin,
                    _postprocess)
            except Exception as e:
                if not self._maybe_degrade_predict_oom(e):
                    raise

    def _predict_raw_impl(self, X, num_iteration: Optional[int] = None,
                          start_iteration: int = 0,
                          pred_early_stop: bool = False,
                          pred_early_stop_freq: int = 10,
                          pred_early_stop_margin: float = 10.0,
                          _postprocess=None) -> np.ndarray:
        """Raw scores for raw-feature rows (the analog of
        GBDT::PredictRaw, gbdt_prediction.cpp:13-53): binned with the train
        mappers on the device, then the engine over the own trees (one
        kernel launch a row chunk; the boost-from-average score lives in
        the first trees' leaves), accumulated in tree order; [N], or [N, K]
        with K classes. An init model's iterations come first, its trees
        walked over the raw rows on the host (their thresholds are real
        values), and the engine continues from that float64 sum.
        ``pred_early_stop``: rows whose margin exceeds the threshold at a
        check round (every ``pred_early_stop_freq`` iterations from
        ``start_iteration``) stop taking trees (reference:
        prediction_early_stop.cpp:25-75). A model trained on EFB bundles
        and a linear model predict from the raw features through their
        model trees on the host, in chunks of ``_RAW_CHUNK`` rows (new rows
        need not keep the bundles' exclusivity; linear leaves read raw
        features). An averaged model (RF) divides by the iterations used,
        and takes no early stop. ``fault_slow_predict_ms`` sleeps and
        ``fault_oom_at_predict`` raises here first (``utils/faults``). In
        serve mode a dense input over the whole ensemble goes through the
        engine's serve slots (``_predict_bins``)."""
        from ..utils import faults
        sf = faults.serve_faults(self.config)
        if sf is not None:
            # the serve-side fault points: a delay that forces deadlines
            # and shedding, and a simulated allocation failure the predict
            # rung (predict_raw's retry loop) must ride
            faults.maybe_slow_predict(sf)
            faults.maybe_oom_predict(sf)
        X = self._prep_predict_X(X)
        k = self.num_tree_per_iteration
        start, end = self._iter_range(num_iteration, start_iteration)
        es = pred_early_stop and not self.average_output
        if self.config.linear_tree or self.train_set.bundles is not None:
            out = self._predict_model_trees(X, start, end, es,
                                            pred_early_stop_freq,
                                            pred_early_stop_margin)
        else:
            out = self._predict_bins(X, start, end, es,
                                     pred_early_stop_freq,
                                     pred_early_stop_margin, _postprocess)
            if _postprocess is not None:
                return out
        if self.average_output:
            out /= max(end - start, 1)
        return out if k > 1 else out[:, 0]

    def _predict_bins(self, X, start: int, end: int, es: bool, freq: int,
                      margin: float, postprocess) -> np.ndarray:
        """[N, K] float64 raw scores of iterations [start, end) over the
        device bins of ``X``: the init model's prefix on the host, then the
        engine (``postprocess``: the converted [N] or [N, K] result)."""
        from ..basic import _is_scipy_sparse
        k = self.num_tree_per_iteration
        if self._serve_mode and not es and start == 0 \
                and self.loaded_iters == 0 and X.shape[0] > 0:
            rows = self.train_set.serve_rows(X)
            eng = self._predict_engine(end) if rows is not None else None
            # a sharded engine takes the ordinary path, as in the JAX
            # package
            if eng is not None and eng.serve_mode and not eng.sharded:
                res = eng.serve_predict(*rows, self.train_set.missing_bin,
                                        postprocess)
                return res if postprocess is not None \
                    else np.asarray(res, np.float64).reshape(-1, k)
        rows = self._predict_rows(X)
        n = X.shape[0]
        out = np.zeros((n, k), dtype=np.float64)
        mb = self.train_set.missing_bin
        active = np.ones(n, dtype=bool)
        lo = self.loaded_iters
        if start < min(end, lo) and _is_scipy_sparse(X):
            X = np.asarray(X.todense())
        it = start
        while it < min(end, lo):
            for c in range(k):
                _accumulate_active(out, c, self._host_tree(it, c).predict(X),
                                   active, es)
            it += 1
            if es and (it - start) % freq == 0:
                active &= ~_early_stop_mask(out, k, margin)
                if not active.any():
                    return out
        if it < end:
            own_end = end - lo
            eng = self._predict_engine(own_end)
            rng = ((it - lo) * k, own_end * k)
            base = out if out.any() else None   # an init model's prefix
            if not es:
                res = eng.predict(rows, mb, base=base, use_bias=False,
                                  tree_range=rng, postprocess=postprocess,
                                  n=n)
                return res if postprocess is not None \
                    else np.asarray(res, np.float64).reshape(n, k)
            out = self._predict_early_stop(eng, rows, n, mb, out, active,
                                           base, it, end, start, freq,
                                           margin)
        if postprocess is not None:
            return postprocess(torch.as_tensor(out if k > 1 else out[:, 0]))
        return out

    def _predict_rows(self, X):
        """The rows of ``X`` as the engine reads them: a shard's rows
        binned on the shard's own device (the feature count checked here,
        scipy-sparse rows sliced as CSR)."""
        from ..basic import _is_scipy_sparse
        ts = self.train_set
        X = ts._new_rows(X)
        if _is_scipy_sparse(X):
            X = X.tocsr()
        return lambda lo, hi, dev: ts.bin_new_data(X[lo:hi], device=dev)

    def _predict_early_stop(self, eng: PredictEngine, rows, n: int, mb, out,
                            active, base, it, end_iter, start_iteration,
                            freq, margin) -> np.ndarray:
        """Margin-based prediction early stop on the engine: the carry
        stays on the device across the check chunks (one launch each, or
        one a shard; the accumulation order is the host loop's), inactive
        rows keep their carry through a device mask (uploaded a shard at a
        time when sharded), and the host sees the [n, K] scores only at
        the check points. Row chunks beyond ``predict_chunk_rows`` run one
        after another (early stop is per row, so chunking is exact)."""
        k = self.num_tree_per_iteration
        chunk = eng._chunk_rows(n)
        if n > chunk:
            return np.concatenate([self._predict_early_stop(
                eng, slice_rows(rows, a0, min(n, a0 + chunk)),
                min(n, a0 + chunk) - a0, mb,
                out[a0:a0 + chunk], active[a0:a0 + chunk],
                None if base is None else base[a0:a0 + chunk], it, end_iter,
                start_iteration, freq, margin)
                for a0 in range(0, n, chunk)], axis=0)
        bins = eng.prepare_bins(rows, n)
        carry = eng.make_carry(base, n)
        lo = self.loaded_iters
        active_dev = eng.upload_rows(active)
        while it < end_iter:
            nxt = start_iteration + ((it - start_iteration) // freq
                                     + 1) * freq
            ce = min(end_iter, nxt)
            carry = eng.accumulate(bins, mb, carry, active_dev,
                                   tree_range=((it - lo) * k, (ce - lo) * k),
                                   use_bias=False)
            it = ce
            if (it - start_iteration) % freq == 0 and it < end_iter:
                out = eng.fetch(carry).reshape(n, k)
                active &= ~_early_stop_mask(out, k, margin)
                if not active.any():
                    return out
                active_dev = eng.upload_rows(active)
        return eng.fetch(carry).reshape(n, k)

    def _predict_model_trees(self, X, start: int, end: int, es: bool = False,
                             freq: int = 10, margin: float = 10.0
                             ) -> np.ndarray:
        """[N, K] float64 sums of the model trees (real thresholds,
        original features) of iterations [start, end) over raw rows, an
        init model's first, chunk by chunk (early stop is per row, so
        chunking is exact)."""
        from ..basic import _is_scipy_sparse
        k = self.num_tree_per_iteration
        if _is_scipy_sparse(X):
            X = X.tocsr()
        out = np.zeros((X.shape[0], k), np.float64)
        for r0 in range(0, X.shape[0], _RAW_CHUNK):
            xc = X[r0:r0 + _RAW_CHUNK]
            xc = (np.asarray(xc.toarray(), np.float64)
                  if _is_scipy_sparse(xc) else xc)
            oc = out[r0:r0 + xc.shape[0]]
            active = np.ones(xc.shape[0], dtype=bool)
            for it in range(start, end):
                for c in range(k):
                    _accumulate_active(oc, c, self._host_tree(it, c).predict(
                        xc), active, es)
                if es and (it - start + 1) % freq == 0:
                    active &= ~_early_stop_mask(oc, k, margin)
                    if not active.any():
                        break
        return out

    def _engine_predict_ok(self) -> bool:
        """Whether predict converts on the device before the one fetch: the
        whole ensemble through the engine, with no host prefix (RF's
        average divides on the host after the sum)."""
        return (not self.config.linear_tree
                and self.train_set.bundles is None
                and self.loaded_iters == 0
                and not self.average_output
                and len(self.trees) > 0)

    def score_dataset(self, ds: Dataset) -> np.ndarray:
        """Raw scores of a train-aligned Dataset from its bin matrix (the
        JAX package's ``score_dataset``, which ``Booster.eval`` uses): the
        init scores (or the set's ``init_score``) plus every tree through
        the engine, each tree's folded boost-from-average bias taken off
        its value first, over the full-width bins
        (``Dataset.traversal_binsT``: a sparse-stored set's stream columns
        rebuilt; a bundled set's bundle columns, which the trees' segments
        read). A linear model and an init model's trees read the set's raw
        features."""
        ds.construct()
        ts = self.train_set
        if ds is not ts and ds.reference is not ts \
                and ds.mappers is not ts.mappers:
            log.fatal("eval dataset was not binned against the training "
                      "set; construct it with reference=<train Dataset>")
        if self.loaded_iters > 0 or self.config.linear_tree:
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
        eng = self._predict_engine()
        if eng is not None:
            return eng.predict(tensor_rows(ds.traversal_binsT()),
                               ds.missing_bin, n=n,
                               base=base if k > 1 else base[:, 0])
        return base if k > 1 else base[:, 0]

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None,
                start_iteration: int = 0,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Raw scores (float64), or the objective's output of the raw
        scores cast to float32, as the JAX package converts; where the
        whole ensemble runs on the engine the conversion runs on the
        device before the one fetch."""
        if not (raw_score or self.objective is None) \
                and not pred_early_stop and self._engine_predict_ok():
            return self.predict_raw(X, num_iteration, start_iteration,
                                    _postprocess=self._convert_on_device)
        raw = self.predict_raw(X, num_iteration, start_iteration,
                               pred_early_stop=pred_early_stop,
                               pred_early_stop_freq=pred_early_stop_freq,
                               pred_early_stop_margin=pred_early_stop_margin)
        if raw_score or self.objective is None:
            return raw
        return self._convert_on_device(torch.as_tensor(raw))

    def predict_leaf(self, X, num_iteration: Optional[int] = None,
                     start_iteration: int = 0) -> np.ndarray:
        """Per-tree leaf indices [N, trees] (reference: the
        predict_leaf_index path): an init model's trees over the raw rows,
        then the engine's leaves over tree-range chunks that keep the
        [t, N] host buffer under ~256 MB; a bundled model walks its model
        trees over the raw rows."""
        from ..basic import _is_scipy_sparse
        X = self._prep_predict_X(X)
        bundled = self.train_set.bundles is not None
        rows = None if bundled else self._predict_rows(X)
        k = self.num_tree_per_iteration
        start, end = self._iter_range(num_iteration, start_iteration)
        if (bundled or start < min(end, self.loaded_iters)) \
                and _is_scipy_sparse(X):
            X = np.asarray(X.todense())
        cols = []
        it = start
        while it < min(end, self.loaded_iters) or (bundled and it < end):
            cols.extend(self._host_tree(it, c).leaf_index(X)
                        for c in range(k))
            it += 1
        if not bundled and it < end:
            own_end = end - self.loaded_iters
            eng = self._predict_engine(own_end)
            n = X.shape[0]
            mb = self.train_set.missing_bin
            bins = eng.prepare_bins(rows, n)
            for a, b in _chunked_tree_ranges(it - self.loaded_iters, own_end,
                                             k, n, itemsize=4):
                cols.extend(list(eng.leaves(bins, mb, tree_range=(a, b))))
        return (np.stack(cols, axis=1) if cols
                else np.zeros((X.shape[0], 0), np.int32))

    def predict_contrib(self, X, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> np.ndarray:
        """SHAP feature contributions [N, (F + 1) * K] (reference:
        GBDT::PredictContrib via Tree::PredictContrib, tree.h:139): the
        host's per-node decisions, then the batched TreeSHAP DP on the
        run's device in float64 (``io/shap.py``)."""
        from ..io.shap import predict_contrib_trees
        X = self._prep_predict_X(X)
        k = self.num_tree_per_iteration
        start, end = self._iter_range(num_iteration, start_iteration)
        # the model trees are kept (``_host_tree``), so the SHAP stacks
        # built on them are too
        trees = [self._host_tree(it, c) for it in range(start, end)
                 for c in range(k)]
        return predict_contrib_trees(trees, X,
                                     self.train_set.num_total_features, k,
                                     average=self.average_output,
                                     device=self.device)

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


def _chunk_iters_cap(n: int, k: int, itemsize: int) -> int:
    """Iterations a stacked-predict launch covers so that the [t, n, k]
    host buffer stays under ~256 MB."""
    return max(1, (256 << 20) // itemsize // max(n * k, 1))


def _chunked_tree_ranges(start_it: int, end_it: int, k: int, n: int,
                         itemsize: int):
    """(a, b) tree ranges covering iterations [start_it, end_it) in
    buffer-capped chunks."""
    cap = _chunk_iters_cap(n, k, itemsize)
    it = start_it
    while it < end_it:
        ce = min(end_it, it + cap)
        yield it * k, ce * k
        it = ce


def _accumulate_active(out: np.ndarray, c: int, delta: np.ndarray,
                       active: np.ndarray, early_stop: bool) -> None:
    """Add a tree's outputs to the active rows (a plain add when
    prediction early stop is off)."""
    if not early_stop or active.all():
        out[:, c] += delta
    else:
        out[active, c] += delta[active]


def _early_stop_mask(out: np.ndarray, k: int,
                     margin_threshold: float) -> np.ndarray:
    """Rows whose prediction margin already exceeds the early-stop
    threshold (reference: prediction_early_stop.cpp: binary margin
    2|pred| (:58-66), multiclass top1 - top2 (:29-49))."""
    if k == 1:
        margin = 2.0 * np.abs(out[:, 0])
    else:
        srt = np.sort(out, axis=1)
        margin = srt[:, -1] - srt[:, -2]
    return margin > margin_threshold


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
