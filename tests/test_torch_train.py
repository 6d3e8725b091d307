"""End to end: the PyTorch port's ``train`` + ``predict`` + ``model_to_string``
against ``lightgbm_tpu.train`` at the same parameters, on the CPU.

- L2 regression and binary: model text bitwise equal after 10 rounds
  (every float of the path is the JAX package's operation in its order,
  XLA's float32 ``exp`` included), raw and converted predictions bitwise,
  with sparse device storage off and on (the default; a >= 90% zero column
  then lives as streams and the trees take the classic split path).
- Categorical features (one-hot and many-vs-many columns, NaN): the same,
  through the classic split path, on their own and beside concentrated
  columns.
- Carrying across: the JAX package's trained trees (categorical ones
  included), converted to numpy by the test, become a port Booster
  (``booster_from_numpy``) whose predictions agree within 1e-12 (float64
  accumulation in tree order).
- The port's model text (category bitsets included) loads back into a port
  Booster that predicts the same and dumps the same text.
- Quantized-gradient training (``quantized_grad``, or
  ``histogram_method=pallas_q8``): L2 and binary, on the fused path and on
  the classic one (categorical features beside concentrated columns); the
  model text bitwise equal after 10 rounds to the JAX package's, both in
  its XLA twin ``onehot_q8`` (its CPU default) and with its Pallas q8
  kernels run through the interpreter, which must agree with each other
  bit for bit (the int32 sums are exact).
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
    X[rng.rand(n) < 0.93, 4] = 0.0                 # concentrated
    y = (1.5 * X[:, 0] + np.nan_to_num(X[:, 1]) - X[:, 2] * X[:, 3]
         + 0.8 * X[:, 4] + 0.3 * rng.randn(n))
    return X, y


def _cat_data(seed=0, n=2500):
    """Column 2 one-hot categorical (5 codes), column 3 many-vs-many (30
    codes, skewed, NaN), column 5 concentrated (>= 90% zeros), column 6
    categorical and concentrated (91% one code: sparse streams)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 7).astype(np.float32)
    X[:, 2] = rng.randint(0, 5, n)
    X[:, 3] = rng.choice(30, n, p=rng.dirichlet(np.full(30, 0.8)))
    X[rng.rand(n) < 0.04, 3] = np.nan
    X[rng.rand(n) < 0.95, 5] = 0.0
    X[:, 6] = np.where(rng.rand(n) < 0.91, 3, rng.randint(0, 3, n))
    eff = np.random.RandomState(99).randn(31)
    y = (X[:, 0] + 0.7 * eff[X[:, 2].astype(int)]
         + eff[np.nan_to_num(X[:, 3], nan=30).astype(int)]
         + 0.5 * X[:, 5] + 4.0 * (X[:, 6] == 1) + 0.3 * rng.randn(n))
    return X, y


CAT = [2, 3, 6]


def _train_both(params, X, y, Xv=None, yv=None, is_enable_sparse=False,
                categorical=None):
    params = dict(params, verbosity=-1, is_enable_sparse=is_enable_sparse)
    kw = {} if categorical is None else {"categorical_feature": categorical}
    jres, tres = {}, {}
    jtrain = lj.Dataset(X, label=y, **kw)
    ttrain = lt.Dataset(X, label=y, **kw)
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


@pytest.mark.parametrize("is_enable_sparse", [False, True])
@pytest.mark.parametrize("pname", sorted(L2_PARAMS))
def test_l2_model_text_bitwise(pname, is_enable_sparse):
    X, y = _data()
    Xv, yv = _data(seed=1, n=500)
    bj, bt, jres, tres = _train_both(L2_PARAMS[pname], X, y, Xv, yv,
                                     is_enable_sparse)
    assert bt._boosting.train_set.has_sparse_cols == is_enable_sparse
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.rows_streamed_per_tree == bj._boosting.rows_streamed_per_tree
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    # both convert from float32 raw scores
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
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


@pytest.mark.parametrize("is_enable_sparse", [False, True])
@pytest.mark.parametrize("params", [
    {"num_leaves": 31, "max_bin": 63},
    {"num_leaves": 15, "max_bin": 63, "scale_pos_weight": 2.0,
     "metric": ["auc", "binary_logloss"]}], ids=["leaves31", "weighted_auc"])
def test_binary_same_structure_leaves_close(params, is_enable_sparse):
    """Binary is bitwise too now that ``exp`` is XLA's: the same model
    text, predictions and metrics."""
    X, y = _data(seed=2)
    Xv, yv = _data(seed=3, n=500)
    bj, bt, jres, tres = _train_both(dict(params, objective="binary"),
                                     X, (y > 0).astype(np.float64),
                                     Xv, (yv > 0).astype(np.float64),
                                     is_enable_sparse)
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert _structure(st) == _structure(sj)
    assert st == sj
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)


@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("params", [
    {"num_leaves": 31, "max_bin": 63},
    {"num_leaves": 20, "max_bin": 31, "max_cat_to_onehot": 8,
     "cat_smooth": 3.0, "cat_l2": 2.0, "min_data_per_group": 30,
     "max_cat_threshold": 6, "lambda_l2": 1.0},
    {"num_leaves": 31, "max_bin": 63, "split_fusion": "off",
     "is_enable_sparse": False}],
    ids=["defaults", "cat_params", "no_sparse"])
def test_categorical_model_text_bitwise(objective, params):
    X, y = _cat_data()
    Xv, yv = _cat_data(seed=1, n=600)
    if objective == "binary":
        y, yv = (y > 0).astype(np.float64), (yv > 0).astype(np.float64)
    bj, bt, jres, tres = _train_both(
        dict(params, objective=objective), X, y, Xv, yv,
        params.get("is_enable_sparse", True), CAT)
    ts = bt._boosting.train_set
    assert ts.has_categorical and not bt._boosting._split_fusion_on()
    st = bt.model_to_string()
    assert st == bj.model_to_string()
    assert sum(t.num_cat for t in load_model(st).trees) > 0
    assert bt.rows_streamed_per_tree == bj._boosting.rows_streamed_per_tree
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)
    # the model text predicts through category values, with no mappers
    loaded = lt.Booster(model_str=st, params={"device_type": "cpu"})
    np.testing.assert_allclose(loaded.predict(Xv, raw_score=True),
                               bt.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-12)
    assert loaded.model_to_string() == st


def test_split_fusion_on_raises_with_categorical():
    X, y = _cat_data(seed=2, n=800)
    with pytest.raises(ValueError, match="categorical features"):
        lt.train({"objective": "regression", "split_fusion": "on",
                  "verbosity": -1, "device_type": "cpu"},
                 lt.Dataset(X, label=y, categorical_feature=CAT), 1)


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
            "missing_type", "is_cat", "cat_bitset")})
        trees[-1]["num_leaves"] = ht.num_leaves
        trees[-1]["shrinkage"] = ht.shrinkage
    ds = g.train_set
    mappers = lt.mappers_from_numpy(
        [m.bin_upper_bound for m in ds.mappers],
        [m.missing_type for m in ds.mappers],
        [m.min_val for m in ds.mappers], [m.max_val for m in ds.mappers],
        [list(m.bin_2_categorical) if m.bin_type == 1 else None
         for m in ds.mappers])
    return trees, mappers, np.asarray(ds.used_features)


@pytest.mark.parametrize("objective,categorical", [
    ("regression", False), ("binary", False), ("regression", True),
    ("binary", True)])
def test_carried_across_predictions(objective, categorical):
    X, y = _cat_data(seed=4) if categorical else _data(seed=4)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    bj = lj.train({"objective": objective, "num_leaves": 15, "max_bin": 63,
                   "verbosity": -1},
                  lj.Dataset(X, label=y,
                             categorical_feature=CAT if categorical
                             else "auto"), ROUNDS)
    trees, mappers, used = _jax_trees_as_numpy(bj)
    bt = lt.booster_from_numpy(trees, {
        "mappers": mappers, "used_features": used, "objective": objective,
        "device_type": "cpu"})
    Xt, _ = (_cat_data if categorical else _data)(seed=5, n=700)
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
    # XLA's float32 exp, written out: bitwise
    np.testing.assert_array_equal(tg.numpy().view(np.int32),
                                  np.asarray(jg).view(np.int32))
    np.testing.assert_array_equal(th.numpy().view(np.int32),
                                  np.asarray(jh).view(np.int32))
    assert ot.boost_from_score() == oj.boost_from_score()


@pytest.mark.parametrize("name,objective,rtol", [
    ("l2", None, 1e-12), ("rmse", None, 1e-12), ("auc", None, 1e-12),
    ("binary_logloss", "binary", 1e-12)])
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


# ------------------------------------------------------- quantized gradients
def _jax_q8_text(params, X, y, kw, interpret, monkeypatch):
    """JAX model text of a q8 training; ``interpret`` runs its Pallas q8
    kernels through the Pallas interpreter (its pallas_q8 method off the
    TPU) without changing the parameters the model text echoes."""
    from lightgbm_tpu.models import gbdt as jgbdt
    with monkeypatch.context() as m:
        if interpret:
            m.setattr(jgbdt.GBDT, "_hist_interpret", lambda self: True)
        bj = lj.train(dict(params), lj.Dataset(X, label=y, **kw), ROUNDS)
        # pallas_q8 with the interpreter on: the grower runs the Pallas
        # kernels (ops/histogram.py epilogue_supported and histogram_tiles
        # take the kernel path only then)
        assert bj._boosting._hist_method() == (
            "pallas_q8" if interpret else "onehot_q8")
        assert bj._boosting._hist_interpret() == interpret
    return bj


@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("path", ["fused", "classic"])
def test_q8_model_text_bitwise(objective, path, monkeypatch):
    if path == "fused":
        X, y = _data(seed=11)
        Xv, _ = _data(seed=12, n=500)
        kw, sparse = {}, False
    else:
        X, y = _cat_data(seed=11)
        Xv, _ = _cat_data(seed=12, n=500)
        kw, sparse = {"categorical_feature": CAT}, True
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    params = {"objective": objective, "num_leaves": 31, "max_bin": 63,
              "quantized_grad": True, "verbosity": -1,
              "is_enable_sparse": sparse}
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, **kw), ROUNDS)
    gb = bt._boosting
    assert gb._hist_method == "plain_q8"
    assert gb._split_fusion_on() == (path == "fused")
    assert gb.train_set.has_sparse_cols == sparse
    text = bt.model_to_string()
    assert "[quantized_grad: True]" in text
    for interpret in (False, True):
        bj = _jax_q8_text(params, X, y, kw, interpret, monkeypatch)
        assert text == bj.model_to_string(), f"interpret={interpret}"
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-12)
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    assert loaded.model_to_string() == text
    np.testing.assert_allclose(loaded.predict(Xv, raw_score=True),
                               bt.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-12)


def test_pallas_q8_method_model_text_bitwise():
    """``histogram_method=pallas_q8`` alone selects the q8 mode too (the
    JAX package falls back to onehot_q8 off the TPU)."""
    X, y = _data(seed=13)
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 31,
              "histogram_method": "pallas_q8", "verbosity": -1,
              "is_enable_sparse": False}
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y),
                  ROUNDS)
    assert bt._boosting._hist_method == "plain_q8"
    bj = lj.train(dict(params), lj.Dataset(X, label=y), ROUNDS)
    assert bt.model_to_string() == bj.model_to_string()
    q = lt.train(dict(params, histogram_method="auto", quantized_grad=True,
                      device_type="cpu"), lt.Dataset(X, label=y), ROUNDS)
    assert _structure(q.model_to_string()) == _structure(
        bt.model_to_string())


def test_q8_with_unported_histogram_method_raises():
    X, y = _data(seed=14, n=300)
    for method in ("onehot_q8", "scatter"):
        with pytest.raises(NotImplementedError, match="one histogram path"):
            lt.train({"objective": "regression", "quantized_grad": True,
                      "histogram_method": method, "device_type": "cpu",
                      "verbosity": -1}, lt.Dataset(X, label=y), 1)
