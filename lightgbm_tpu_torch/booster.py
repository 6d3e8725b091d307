"""Booster: the user-facing handle of a trained or loaded model.

The port of lightgbm_tpu's ``booster.py``: training updates (with custom
gradients from ``fobj``), rollback and mid-run parameter changes,
evaluation (with ``feval``), prediction (raw and converted), model text and
its JSON dump, importances, tree inspection (``trees_to_dataframe``, leaf
outputs, score bounds, split-value histograms), ``shuffle_models``,
``free_dataset`` and ``refit``. A Booster is built from a training Dataset
(boosted by the booster ``boosting`` names), from a model file or string,
or from trees carried across as numpy arrays
(``convert.booster_from_numpy``). Predictions of a K-class model are
[N, K]: raw scores, or the softmax (``multiclass``) or per-class sigmoid
(``multiclassova``) of them. ``free_network`` leaves the process's gang
and ``set_network`` joins one (``distributed.init``), for the distributed
learners.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .basic import Dataset
from .config import Config
from .models.boosting import create_boosting
from .utils import log


class Booster:
    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set = train_set
        if model_file is not None or model_str is not None:
            from .io.model_text import load_model
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self._boosting = load_model(model_str, self.config)
        elif train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            from . import distributed
            distributed.maybe_init_from_config(self.config)
            merged = dict(train_set.params or {})
            merged.update(self.params)
            train_set.params = merged
            self._boosting = create_boosting(self.config, train_set)
            # the params' identity before any mid-training
            # reset_parameter: the checkpointing and the resuming run both
            # hash their construction-time config (checkpoint.py)
            from .checkpoint import params_hash
            self._initial_params_hash = params_hash(self.config)
        else:
            raise ValueError("need at least one of train_set, model_file or "
                             "model_str")

    @classmethod
    def _wrap(cls, params: Dict[str, Any], config: Config,
              boosting) -> "Booster":
        """A Booster over a boosting object built elsewhere (a refit's
        loaded model, trees carried across)."""
        booster = cls.__new__(cls)
        booster.params = dict(params)
        booster.config = config
        booster.best_iteration = -1
        booster.best_score = {}
        booster._train_set = None
        booster._boosting = boosting
        return booster

    # ------------------------------------------------------------ training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._boosting.add_valid(data, name)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True when it added no split. With
        ``fobj(score, train_set) -> (grad, hess)`` the gradients come from
        the caller (reference: basic.py Booster.update, c_api.cpp:1645
        LGBM_BoosterUpdateOneIterCustom): ``score`` is a float64 numpy copy
        of the train score ([N], or [N, K] row-major), and the returned
        arrays go to the run's device as float32, one copy each an
        iteration."""
        if train_set is not None and train_set is not self._train_set:
            log.fatal("Replacing the training set in update() is not "
                      "supported")
        if fobj is None:
            return self._boosting.train_one_iter()
        score = self._boosting.train_score.detach().cpu().numpy()
        grad, hess = fobj(score.astype(np.float64), self._train_set)
        return self._boosting.train_one_iter(grad, hess)

    def rollback_one_iter(self) -> "Booster":
        self._boosting.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self._boosting.current_iteration()

    def num_trees(self) -> int:
        return self._boosting.num_trees

    def num_model_per_iteration(self) -> int:
        return self._boosting.num_tree_per_iteration

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New parameters from the next iteration on (reference: basic.py
        Booster.reset_parameter): the learning rate, the split parameters,
        the sampling and the constraints (``GBDT.reset_config``)."""
        self.params.update(params)
        self.config = Config.from_params(self.params)
        self._boosting.reset_config(self.config)
        return self

    @property
    def rows_streamed_per_tree(self) -> float:
        """Rows the histogram passes read per tree (the compaction ladder's
        effect; the full pass reads N rows)."""
        return self._boosting.rows_streamed_per_tree

    @property
    def rows_real_per_tree(self) -> float:
        """Of those, the rows whose leaf the pass computed (the rest is the
        compaction rungs' padding)."""
        return self._boosting.rows_real_per_tree

    # ---------------------------------------------------------------- eval
    def eval_set(self, feval=None):
        return self._boosting.eval_set(feval)

    def eval(self, data: Dataset, name: str, feval=None):
        """The configured metrics (and ``feval``) on a Dataset binned
        against the training set (reference: basic.py Booster.eval); a
        list of (name, metric, value, bigger_is_better)."""
        b = self._boosting
        score = np.asarray(b.score_dataset(data), dtype=np.float64)
        return b.eval_metrics(score, data, name, feval)

    def eval_train(self, feval=None):
        old = self.config.is_provide_training_metric
        self.config.is_provide_training_metric = True
        try:
            return [r for r in self._boosting.eval_set(feval)
                    if r[0] == "training"]
        finally:
            self.config.is_provide_training_metric = old

    def eval_valid(self, feval=None):
        return [r for r in self._boosting.eval_set(feval)
                if r[0] != "training"]

    # ------------------------------------------------------------- predict
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                **kwargs) -> np.ndarray:
        """Predict on new data (reference: basic.py Booster.predict):
        converted or raw scores, per-tree leaf indices (``pred_leaf``;
        like the JAX package, from the first iteration), SHAP
        contributions (``pred_contrib``), with margin-based early stop.
        A trained model predicts through the device engine
        (``models/predict_engine.py``: one kernel launch a row chunk, the
        ``[N, K]`` result the only transfer), tuned by
        ``predict_chunk_rows`` and ``predict_accum``; a model loaded from
        text predicts on the host."""
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        if pred_leaf:
            return self._boosting.predict_leaf(data, num_iteration)
        if pred_contrib:
            return self._boosting.predict_contrib(data, num_iteration)
        return self._boosting.predict(
            data, raw_score=raw_score, num_iteration=num_iteration,
            start_iteration=start_iteration,
            pred_early_stop=pred_early_stop,
            pred_early_stop_freq=pred_early_stop_freq,
            pred_early_stop_margin=pred_early_stop_margin)

    # ------------------------------------------------------------ model IO
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from .io.model_text import dump_model_text
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        return dump_model_text(self._boosting, num_iteration, start_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        # atomic (tmp + fsync + rename): a crash mid-write leaves the
        # previous file, never a truncated model that parses shorter
        from .utils.atomic_write import atomic_write_text
        atomic_write_text(filename,
                          self.model_to_string(num_iteration, start_iteration))
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        from .io.model_text import dump_model_json
        return dump_model_json(self._boosting, num_iteration or -1,
                               start_iteration)

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model with one parsed from text
        (reference: basic.py Booster.model_from_string)."""
        from .io.model_text import load_model
        self._boosting = load_model(model_str, self.config)
        return self

    # ------------------------------------------------------ importance etc
    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Split counts or total gains by original feature (reference:
        gbdt.cpp FeatureImportance)."""
        imp = self._boosting.feature_importance(importance_type)
        return imp.astype(np.int32) if importance_type == "split" else imp

    def feature_name(self) -> List[str]:
        ts = getattr(self._boosting, "train_set", None)
        if ts is not None:
            return ts.get_feature_names()
        return list(self._boosting.feature_names)

    def num_feature(self) -> int:
        ts = getattr(self._boosting, "train_set", None)
        if ts is not None:
            return ts.num_total_features
        return self._boosting.max_feature_idx + 1

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """reference: Booster.get_leaf_output (Tree::LeafOutput)."""
        return float(self._boosting.host_trees[tree_id].leaf_value[leaf_id])

    def lower_bound(self) -> float:
        """The least raw score the trees can give: the sum of each tree's
        least leaf value (reference: tree.cpp:316 per-tree bounds)."""
        return float(sum(float(np.min(ht.leaf_value))
                         for ht in self._boosting.host_trees))

    def upper_bound(self) -> float:
        """The largest raw score the trees can give."""
        return float(sum(float(np.max(ht.leaf_value))
                         for ht in self._boosting.host_trees))

    def get_split_value_histogram(self, feature, bins=None):
        """Histogram of a feature's numerical split thresholds across the
        model (reference: Booster.get_split_value_histogram):
        (counts, bin_edges) as np.histogram gives them."""
        model = self.dump_model()
        feat_idx = (model["feature_names"].index(feature)
                    if isinstance(feature, str) else int(feature))
        values = []

        def walk(node):
            if "split_feature" in node:
                if node["split_feature"] == feat_idx \
                        and node["decision_type"] == "<=":
                    values.append(float(node["threshold"]))
                walk(node["left_child"])
                walk(node["right_child"])

        for ti in model["tree_info"]:
            walk(ti["tree_structure"])
        if not values:
            raise ValueError("feature was never used for splitting")
        return np.histogram(values, bins=bins or max(10, len(set(values))))

    def trees_to_dataframe(self):
        """Every node of every tree as one pandas DataFrame (reference:
        basic.py Booster.trees_to_dataframe, its column names). pandas is
        imported here only."""
        import pandas as pd
        model = self.dump_model()
        feature_names = model["feature_names"]
        rows = []

        def walk(tree_index, node, depth, parent):
            # a splitless tree's dump is a bare {"leaf_value": ...}
            node_idx = (f"{tree_index}-S{node['split_index']}"
                        if "split_index" in node
                        else f"{tree_index}-L{node.get('leaf_index', 0)}")
            row = {"tree_index": tree_index, "node_depth": depth,
                   "node_index": node_idx, "left_child": None,
                   "right_child": None, "parent_index": parent}
            if "split_feature" in node:
                row.update(
                    split_feature=feature_names[node["split_feature"]],
                    split_gain=node.get("split_gain"),
                    threshold=node.get("threshold"),
                    decision_type=node.get("decision_type"),
                    missing_direction="left" if node.get("default_left")
                    else "right",
                    missing_type=node.get("missing_type"),
                    value=node.get("internal_value"),
                    weight=node.get("internal_weight"),
                    count=node.get("internal_count"))
                rows.append(row)
                row["left_child"] = walk(tree_index, node["left_child"],
                                         depth + 1, node_idx)
                row["right_child"] = walk(tree_index, node["right_child"],
                                          depth + 1, node_idx)
            else:
                row.update(split_feature=None, split_gain=None,
                           threshold=None, decision_type=None,
                           missing_direction=None, missing_type=None,
                           value=node.get("leaf_value"),
                           weight=node.get("leaf_weight"),
                           count=node.get("leaf_count"))
                rows.append(row)
            return node_idx

        for ti in model["tree_info"]:
            walk(ti["tree_index"], ti["tree_structure"], 1, None)
        return pd.DataFrame(rows)

    # ----------------------------------------------- misc reference API
    def attr(self, key: str):
        """A runtime attribute (reference: basic.py Booster.attr/set_attr,
        a key/value store on the booster)."""
        return getattr(self, "_attr", {}).get(key)

    def set_attr(self, **kwargs) -> "Booster":
        store = self.__dict__.setdefault("_attr", {})
        for k, v in kwargs.items():
            if v is None:
                store.pop(k, None)
            else:
                store[k] = str(v)
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """reference: basic.py Booster.set_train_data_name."""
        self._train_data_name = name
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Permute the order of the iterations in [start, end) (reference:
        GBDT::ShuffleModels): the prediction sum does not depend on it,
        a refit or a truncated predict does. The generator is the
        reference's ``Random tmp_rand(17)`` (gbdt.h:95) kept on the
        booster, so a fresh booster draws the JAX package's first
        permutation and a second call draws the next one."""
        b = self._boosting
        if not hasattr(b, "_shuffle_rand"):
            b._shuffle_rand = random.Random(17)
        k = b.num_tree_per_iteration
        total = len(b.trees) // k
        end = total if end_iteration <= 0 else min(end_iteration, total)
        idx = list(range(start_iteration, end))
        perm = idx[:]
        b._shuffle_rand.shuffle(perm)
        # the trees, their host views and their biases hold the order; the
        # prediction caches check each position's tree object and rebuild
        for attr in ("trees", "host_trees", "tree_bias"):
            arr = getattr(b, attr)
            orig = list(arr)
            for src, dst in zip(idx, perm):
                for c in range(k):
                    arr[dst * k + c] = orig[src * k + c]
        return self

    def free_dataset(self) -> "Booster":
        """Release the training and validation data (reference:
        Booster.free_dataset): every device tensor of the sets (the bin
        matrix and its row-major copy, the sparse columns' four fields,
        the traversal matrix), the score caches, the bagging subset and
        mask and the raw rows. The bin mappers stay, so predict and model
        text keep working; further training does not."""
        b = self._boosting
        ts = getattr(b, "train_set", None)
        if ts is not None:
            ts.binsT = None
            ts._traversal_binsT = None
            # all four sparse fields go together: sp_cols alone would keep
            # has_sparse_cols true on a set whose streams are gone
            ts.sp_rows = ts.sp_bins = ts.sp_cols = ts.sp_default = None
            ts.label = ts.weight = ts.init_score = None
            ts.raw_data_np = None
            ts.data = None
        b.train_score = None
        b._bag_mask = b._bag_sub = None
        for vs in b.valid_sets:
            vs.binsT = None
            vs._traversal_binsT = None
            vs.raw_data_np = None
        b.valid_sets = []
        b.valid_names = []
        b._valid_scores = []
        b._valid_raw_cache = {}
        self._train_set = None
        return self

    def free_network(self) -> "Booster":
        """Leave the gang this process joined (``distributed.shutdown``);
        later trainings run alone (reference: basic.py free_network)."""
        from . import distributed
        distributed.shutdown()
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Join this process to the gang of ``machines`` (comma-separated
        host:port, or a list; the first entry hosts the gang's store) with
        ``num_machines`` ranks, this one found by local-IP match and
        ``local_listen_port``, ``listen_time_out`` minutes the collectives'
        timeout (reference: basic.py set_network -> LGBM_NetworkInit). A
        world of 1 trains alone. The device is the booster's
        ``device_type``'s."""
        from . import distributed
        if isinstance(machines, (list, tuple, set)):
            machines = ",".join(str(m) for m in machines)
        if int(num_machines) > 1:
            distributed.init(machines=machines,
                             num_machines=int(num_machines),
                             local_listen_port=int(local_listen_port),
                             time_out=float(listen_time_out),
                             params=self.config)
        return self

    # ---------------------------------------------------------------- refit
    def refit(self, data, label=None, weight=None, group=None,
              decay_rate: float = 0.9) -> "Booster":
        """A new Booster with this model's trees and leaf values refitted
        on new data (reference: GBDT::RefitTree gbdt.cpp:285-321 and
        SerialTreeLearner::FitByExistingTree; the JAX package's
        ``refit``): iteration by iteration, the objective's gradients
        (the port's own, float32 on the run's device) at the refitted
        model's scores so far, summed per leaf in float64 on the host,
        give each leaf its new output, blended with the old by
        ``decay_rate``; a linear leaf also re-solves its ridge system
        (``_refit_linear_leaves``). ``data`` may be a Dataset holding its
        raw rows."""
        from .io.model_text import load_model
        from .objectives import create_objective

        loaded = load_model(self.model_to_string(),
                            Config.from_params(self.params))
        if label is None and hasattr(data, "get_label"):
            label = data.get_label()
            weight = data.get_weight() if weight is None else weight
            group = data.get_group() if group is None else group
            data = data.data
        X = data
        label = np.asarray(label, dtype=np.float64).reshape(-1)
        leaf = loaded.predict_leaf(X)                 # [N, T]
        n = leaf.shape[0]
        cfg = loaded.config
        objective = create_objective(cfg)
        if objective is None:
            log.fatal("Cannot refit a model without a built-in objective")
        device = cfg.torch_device()
        objective.init(label, None if weight is None else
                       np.asarray(weight, np.float64).reshape(-1),
                       None if group is None else
                       np.asarray(group, np.int64).reshape(-1),
                       device=device)
        k = loaded.num_tree_per_iteration
        score = np.zeros((n, k) if k > 1 else (n,), np.float64)
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        mds = cfg.max_delta_step
        eps = 1e-15

        def leaf_output(sg, sh):
            out = -np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0) / (sh + l2)
            if mds > 0:
                out = np.clip(out, -mds, mds)
            return out

        Xmat = None
        if any(t.is_linear for t in loaded.trees):
            Xmat = loaded._check_features(X)
        for it in range(loaded.num_iteration):
            g, h = objective.get_grad_hess(torch.from_numpy(
                score.astype(np.float32)).to(device))
            g = g.cpu().numpy().astype(np.float64)
            h = h.cpu().numpy().astype(np.float64)
            for c in range(k):
                tree = loaded.trees[it * k + c]
                lp = leaf[:, it * k + c]
                gc = g[:, c] if k > 1 else g
                hc = h[:, c] if k > 1 else h
                nl = tree.num_leaves
                sum_g = np.bincount(lp, weights=gc, minlength=nl)[:nl]
                sum_h = np.bincount(lp, weights=hc, minlength=nl)[:nl] + eps
                new_out = leaf_output(sum_g, sum_h) * tree.shrinkage
                tree.leaf_value = (decay_rate * tree.leaf_value
                                   + (1.0 - decay_rate) * new_out)
                if tree.is_linear:
                    self._refit_linear_leaves(tree, lp, gc, hc, Xmat,
                                              cfg.linear_lambda, decay_rate,
                                              new_out)
                delta = (tree.predict(Xmat) if tree.is_linear
                         else tree.leaf_value[lp])
                if k > 1:
                    score[:, c] += delta
                else:
                    score += delta
        return Booster._wrap(self.params, loaded.config, loaded)

    @staticmethod
    def _refit_linear_leaves(tree, lp, g, h, Xmat, linear_lambda, decay_rate,
                             new_out) -> None:
        """Blend each linear leaf's const and coefficients with a fresh
        ridge fit on the refit rows (linear_tree_learner.cpp:320-380
        CalculateLinear with is_refit); a leaf with fewer usable rows than
        features + 1 takes the blended plain output and zero coefficients
        (:323-329)."""
        shrink = tree.shrinkage
        for li in range(tree.num_leaves):
            feats = (tree.leaf_features[li]
                     if li < len(tree.leaf_features) else [])
            old_coeffs = (tree.leaf_coeff[li]
                          if li < len(tree.leaf_coeff) else [])
            rows = lp == li
            Xl = (Xmat[rows][:, feats] if feats
                  else np.zeros((int(rows.sum()), 0)))
            ok = (~(np.isnan(Xl).any(axis=1) | np.isinf(Xl).any(axis=1))
                  if feats else np.ones(int(rows.sum()), bool))
            if ok.sum() < len(feats) + 1:
                tree.leaf_const[li] = (decay_rate * tree.leaf_const[li]
                                       + (1.0 - decay_rate) * new_out[li])
                tree.leaf_coeff[li] = [0.0] * len(feats)
                continue
            X1 = np.concatenate([Xl[ok], np.ones((int(ok.sum()), 1))], axis=1)
            hl = h[rows][ok]
            gl = g[rows][ok]
            A = X1.T @ (X1 * hl[:, None])
            A[np.arange(len(feats)), np.arange(len(feats))] += linear_lambda
            try:
                sol = -np.linalg.solve(A, X1.T @ gl)
            except np.linalg.LinAlgError:
                sol = -(np.linalg.pinv(A) @ (X1.T @ gl))
            tree.leaf_coeff[li] = [
                decay_rate * (old_coeffs[i] if i < len(old_coeffs) else 0.0)
                + (1.0 - decay_rate) * float(sol[i]) * shrink
                for i in range(len(feats))]
            tree.leaf_const[li] = (decay_rate * tree.leaf_const[li]
                                   + (1.0 - decay_rate) * float(sol[-1])
                                   * shrink)
