"""End to end: the PyTorch port's ``train`` + ``predict`` + ``model_to_string``
against ``lightgbm_tpu.train`` at the same parameters, on the CPU.

- L2 regression: model text bitwise equal after 10 rounds (every float of
  the path is the JAX package's operation in its order).
- Binary: the same split features, thresholds and tree shapes; leaf values
  within rtol 1e-5. Gradients differ from JAX's by an ulp through ``exp``
  (torch's and XLA's ``exp`` round differently), so the bits cannot match.
  For the same reason the missing-value direction may differ at a node that
  no row with a missing value reaches: there the forward and reverse scans
  split the rows identically, their gains tie in exact arithmetic, and the
  rounding decides; the test checks that every such node sees no missing
  value.
- Carrying across: the JAX package's trained trees, converted to numpy by
  the test, become a port Booster (``booster_from_numpy``) whose
  predictions agree within 1e-12 (float64 accumulation in tree order).
- The port's model text loads back into a port Booster that predicts the
  same and dumps the same text.
Objectives and metrics are checked against the JAX package on the same
scores as well.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu_torch import metrics as tmetrics
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.io.model_text import load_model

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

ROUNDS = 10


def _data(seed=0, n=2500, f=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[rng.rand(n) < 0.3, 2] = 0.0
    X[:, 3] = np.round(X[:, 3] * 3)
    y = (1.5 * X[:, 0] + np.nan_to_num(X[:, 1]) - X[:, 2] * X[:, 3]
         + 0.3 * rng.randn(n))
    return X, y


def _train_both(params, X, y, Xv=None, yv=None):
    params = dict(params, verbosity=-1, is_enable_sparse=False)
    jres, tres = {}, {}
    jtrain = lj.Dataset(X, label=y)
    ttrain = lt.Dataset(X, label=y)
    jv = [lj.Dataset(Xv, label=yv, reference=jtrain)] if Xv is not None \
        else None
    tv = [lt.Dataset(Xv, label=yv, reference=ttrain)] if Xv is not None \
        else None
    bj = lj.train(dict(params), jtrain, ROUNDS, valid_sets=jv,
                  valid_names=["v"] if jv else None, evals_result=jres)
    bt = lt.train(dict(params, device_type="cpu"), ttrain, ROUNDS,
                  valid_sets=tv, valid_names=["v"] if tv else None,
                  evals_result=tres)
    return bj, bt, jres, tres


L2_PARAMS = {
    "leaves31": {"objective": "regression", "num_leaves": 31, "max_bin": 63},
    "regularised": {"objective": "regression", "num_leaves": 15,
                    "max_bin": 31, "lambda_l2": 2.0, "min_data_in_leaf": 10,
                    "learning_rate": 0.3, "metric": ["l2", "rmse"]},
    "exact_depth": {"objective": "regression", "num_leaves": 12,
                    "max_bin": 63, "max_depth": 3,
                    "tree_growth_mode": "exact"},
}


@pytest.mark.parametrize("pname", sorted(L2_PARAMS))
def test_l2_model_text_bitwise(pname):
    X, y = _data()
    Xv, yv = _data(seed=1, n=500)
    bj, bt, jres, tres = _train_both(L2_PARAMS[pname], X, y, Xv, yv)
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.rows_streamed_per_tree == bj._boosting.rows_streamed_per_tree
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    # the JAX package converts in float32; the port keeps float64
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=2e-7)
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)


def _structure(text):
    """Per tree: leaves, split features, thresholds, missing types and
    child links (the default-left bit is checked separately)."""
    return [(t.num_leaves, t.split_feature.tolist(), t.threshold.tolist(),
             (t.decision_type >> 2).tolist(), t.left_child.tolist(),
             t.right_child.tolist()) for t in load_model(text).trees]


def _rows_reaching(tree, X, node):
    """Rows of X whose path passes through ``node``."""
    cur = np.zeros(len(X), np.int64)
    reached = np.zeros(len(X), bool)
    active = np.ones(len(X), bool)
    while active.any():
        reached |= active & (cur == node)
        idx = np.nonzero(active)[0]
        nd = cur[idx]
        left = tree._go_left(nd, X[idx, tree.split_feature[nd]])
        nxt = np.where(left, tree.left_child[nd], tree.right_child[nd])
        cur[idx] = nxt
        active[idx[nxt < 0]] = False
    return reached


@pytest.mark.parametrize("params", [
    {"num_leaves": 31, "max_bin": 63},
    {"num_leaves": 15, "max_bin": 63, "scale_pos_weight": 2.0,
     "metric": ["auc", "binary_logloss"]}], ids=["leaves31", "weighted_auc"])
def test_binary_same_structure_leaves_close(params):
    X, y = _data(seed=2)
    Xv, yv = _data(seed=3, n=500)
    bj, bt, jres, tres = _train_both(dict(params, objective="binary"),
                                     X, (y > 0).astype(np.float64),
                                     Xv, (yv > 0).astype(np.float64))
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert _structure(st) == _structure(sj)
    for a, b in zip(load_model(sj).trees, load_model(st).trees):
        # rtol 1e-5 of the tree's leaf scale: a leaf near zero sums
        # gradients that cancel, so its own relative error is larger
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-5 * np.abs(a.leaf_value).max())
        for node in np.nonzero(a.decision_type != b.decision_type)[0]:
            rows = _rows_reaching(a, X.astype(np.float64), node)
            assert not np.isnan(X[rows, a.split_feature[node]]).any()
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=1e-5)
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-5)


def _jax_trees_as_numpy(booster):
    """The JAX package's trained trees and mappers as plain numpy (what a
    caller hands the port)."""
    g = booster._boosting
    trees = []
    for ht in g.host_trees:
        trees.append({k: np.asarray(getattr(ht, k)) for k in (
            "split_feature", "threshold_bin", "threshold", "default_left",
            "left_child", "right_child", "split_gain", "internal_value",
            "internal_weight", "internal_count", "leaf_value",
            "leaf_weight", "leaf_count", "leaf_depth", "leaf_parent",
            "missing_type")})
        trees[-1]["num_leaves"] = ht.num_leaves
        trees[-1]["shrinkage"] = ht.shrinkage
    ds = g.train_set
    mappers = lt.mappers_from_numpy(
        [m.bin_upper_bound for m in ds.mappers],
        [m.missing_type for m in ds.mappers],
        [m.min_val for m in ds.mappers], [m.max_val for m in ds.mappers])
    return trees, mappers, np.asarray(ds.used_features)


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_carried_across_predictions(objective):
    X, y = _data(seed=4)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    bj = lj.train({"objective": objective, "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1}, lj.Dataset(X, label=y), ROUNDS)
    trees, mappers, used = _jax_trees_as_numpy(bj)
    bt = lt.booster_from_numpy(trees, {
        "mappers": mappers, "used_features": used, "objective": objective,
        "device_type": "cpu"})
    Xt, _ = _data(seed=5, n=700)
    np.testing.assert_allclose(bt.predict(Xt, raw_score=True),
                               bj.predict(Xt, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(bt.predict(Xt), bj.predict(Xt), rtol=1e-6)


def test_port_model_text_loads_back():
    X, y = _data(seed=6)
    bt = lt.train({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1, "device_type": "cpu"},
                  lt.Dataset(X, label=(y > 0).astype(np.float64)), ROUNDS)
    text = bt.model_to_string()
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    Xt, _ = _data(seed=7, n=600)
    np.testing.assert_allclose(loaded.predict(Xt, raw_score=True),
                               bt.predict(Xt, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(loaded.predict(Xt), bt.predict(Xt),
                               rtol=1e-12)
    assert loaded.model_to_string() == text
    assert loaded.num_trees() == ROUNDS


def test_eval_train_and_valid():
    X, y = _data(seed=8)
    tr = lt.Dataset(X, label=y, params={"device_type": "cpu"})
    va = lt.Dataset(X[:300], label=y[:300], reference=tr)
    bt = lt.Booster({"objective": "regression", "verbosity": -1,
                     "device_type": "cpu", "metric": "l2"}, tr)
    bt.add_valid(va, "v")
    for _ in range(3):
        bt.update()
    (name, metric, value, bigger), = bt.eval_valid()
    assert (name, metric, bigger) == ("v", "l2", False)
    pred = bt.predict(X[:300])
    np.testing.assert_allclose(value, np.mean((pred - y[:300]) ** 2),
                               rtol=1e-6)
    (tname, _, tval, _), = bt.eval_train()
    assert tname == "training" and tval < np.var(y)


def test_objective_gradients_match():
    rng = np.random.RandomState(9)
    score = rng.randn(5000).astype(np.float32) * 3
    label = rng.randn(5000)
    w = rng.rand(5000) + 0.5
    cfg_j = lj.Config.from_params({"objective": "regression"})
    cfg_t = lt.Config.from_params({"objective": "regression",
                                   "device_type": "cpu"})
    oj, ot = jobj.RegressionL2(cfg_j), tobj.RegressionL2(cfg_t)
    oj.init(label, w)
    ot.init(label, w)
    for a, b in zip(oj.get_grad_hess(jnp.asarray(score)),
                    ot.get_grad_hess(torch.from_numpy(score))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert ot.boost_from_score() == oj.boost_from_score()
    yb = (label > 0).astype(np.float64)
    oj = jobj.BinaryLogloss(lj.Config.from_params({"objective": "binary"}))
    ot = tobj.BinaryLogloss(lt.Config.from_params({"objective": "binary",
                                                   "device_type": "cpu"}))
    oj.init(yb, None)
    ot.init(yb, None)
    (jg, jh), (tg, th) = (oj.get_grad_hess(jnp.asarray(score)),
                          ot.get_grad_hess(torch.from_numpy(score)))
    ulps = np.abs(tg.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jg).view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    # h = |r| * (sigmoid - |r|) cancels where |r| nears sigmoid, which
    # magnifies the ulp of exp to a few parts in 1e6
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=5e-6)
    assert ot.boost_from_score() == oj.boost_from_score()


@pytest.mark.parametrize("name,objective,rtol", [
    ("l2", None, 1e-12), ("rmse", None, 1e-12), ("auc", None, 1e-12),
    ("binary_logloss", "binary", 1e-6)])
def test_metrics_match(name, objective, rtol):
    rng = np.random.RandomState(10)
    score = (rng.randn(3000) * 2).astype(np.float32).astype(np.float64)
    score[:50] = score[50:100]                       # tied scores
    label = (rng.rand(3000) < 0.4).astype(np.float64)
    w = rng.rand(3000) + 0.1
    jm = jmetrics.create_metric(name, lj.Config())
    tm = tmetrics.create_metric(name, lt.Config.from_params(
        {"device_type": "cpu"}))
    jo = to = None
    if objective:
        jo = jobj.BinaryLogloss(lj.Config.from_params({"objective": "binary"}))
        to = tobj.BinaryLogloss(lt.Config.from_params(
            {"objective": "binary", "device_type": "cpu"}))
    for weight in (None, w):
        jm.init(label, weight)
        tm.init(label, weight)
        np.testing.assert_allclose(tm.eval(score, to), jm.eval(score, jo),
                                   rtol=rtol)
