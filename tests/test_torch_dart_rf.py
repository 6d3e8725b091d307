"""DART and RF boosting in the PyTorch port against ``lightgbm_tpu.train``
at the same parameters, on the CPU, and models carried across.

- DART at its defaults, in xgboost mode with uniform drops, ``max_drop``
  and ``skip_drop``, and multiclass (the drop set from
  ``np.random.RandomState(drop_seed)``, the dropped trees' outputs taken
  off and put back scaled): model text bitwise equal after 10 rounds, raw
  predictions bitwise, valid metrics within 1e-12.
- RF (no shrinkage, gradients from the constant init score, a bias on
  every tree, running-mean scores, ``average_output``) with bagging in the
  mask mode and ``feature_fraction``, and multiclass in the subset mode,
  in f32 and q8: the same bars.
- Carrying across: the JAX package's multiclass and RF models, converted
  to numpy by the test, become port Boosters (``booster_from_numpy``)
  whose raw predictions agree within 1e-12 (float64 accumulation in tree
  order) and whose converted predictions agree within 1e-6.
- An RF model's text (``average_output``) loads back into a port Booster
  that predicts the same and dumps the same text.
"""

import numpy as np
import pytest

import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from test_torch_train import _data, _jax_trees_as_numpy

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

ROUNDS = 10


def _labels(objective, y):
    if objective == "binary":
        return (y > 0).astype(np.float64)
    if objective == "multiclass":
        return np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(
            np.float64)
    return y


def _train_both(params, seed):
    X, y = _data(seed=seed)
    Xv, yv = _data(seed=seed + 1, n=400)
    obj = params["objective"]
    y, yv = _labels(obj, y), _labels(obj, yv)
    params = dict(params, verbosity=-1)
    jres, tres = {}, {}
    jtrain, ttrain = lj.Dataset(X, label=y), lt.Dataset(X, label=y)
    bj = lj.train(dict(params), jtrain, ROUNDS,
                  valid_sets=[lj.Dataset(Xv, label=yv, reference=jtrain)],
                  valid_names=["v"], evals_result=jres)
    bt = lt.train(dict(params, device_type="cpu"), ttrain, ROUNDS,
                  valid_sets=[lt.Dataset(Xv, label=yv, reference=ttrain)],
                  valid_names=["v"], evals_result=tres)
    assert bt.model_to_string() == bj.model_to_string()
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)
    return bj, bt


DART = {
    "defaults": {"objective": "regression"},
    "xgboost_uniform": {"objective": "binary", "drop_rate": 0.5,
                        "xgboost_dart_mode": True, "uniform_drop": True,
                        "max_drop": 3, "skip_drop": 0.2},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "drop_rate": 0.3, "num_leaves": 7},
}


@pytest.mark.parametrize("name", sorted(DART))
def test_dart_model_text_bitwise(name):
    params = dict({"num_leaves": 15, "max_bin": 63}, boosting="dart",
                  **DART[name])
    _, bt = _train_both(params, seed=60)
    gb = bt._boosting
    assert type(gb).__name__ == "DART"
    assert len(gb.tree_weight) == len(gb.drop_sets) == ROUNDS
    assert any(gb.drop_sets)
    # some iteration dropped trees: their shrinkage was scaled down
    assert min(ht.shrinkage for ht in gb.host_trees) < \
        max(ht.shrinkage for ht in gb.host_trees)


RF = {
    "mask": {"objective": "binary", "bagging_fraction": 0.632,
             "bagging_freq": 1, "feature_fraction": 0.8},
    "multiclass_subset": {"objective": "multiclass", "num_class": 3,
                          "bagging_fraction": 0.4, "bagging_freq": 1},
    "l1_mask": {"objective": "regression_l1", "bagging_fraction": 0.7,
                "bagging_freq": 2},
}


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("name", sorted(RF))
def test_rf_model_text_bitwise(name, q8):
    _, bt = _train_both(dict(RF[name], boosting="rf", num_leaves=15,
                             max_bin=63, quantized_grad=q8), seed=62)
    gb = bt._boosting
    assert type(gb).__name__ == "RF" and gb.average_output
    assert "average_output" in bt.model_to_string()
    assert all(ht.shrinkage == 1.0 for ht in gb.host_trees)


def test_rf_requires_bagging():
    with pytest.raises(Exception, match="RF mode requires bagging"):
        lt.train({"objective": "binary", "boosting": "rf",
                  "device_type": "cpu", "verbosity": -1},
                 lt.Dataset(_data(seed=64, n=300)[0],
                            label=np.zeros(300)), 1)


@pytest.mark.parametrize("params", [
    {"objective": "multiclass", "num_class": 3},
    {"objective": "multiclassova", "num_class": 3},
    {"objective": "binary", "boosting": "rf", "bagging_fraction": 0.6,
     "bagging_freq": 1},
    {"objective": "multiclass", "num_class": 3, "boosting": "rf",
     "bagging_fraction": 0.5, "bagging_freq": 1}],
    ids=["multiclass", "multiclassova", "rf", "rf_multiclass"])
def test_carried_across_predictions(params):
    X, y = _data(seed=66)
    y = _labels(params["objective"].replace("ova", ""), y)
    bj = lj.train(dict(params, num_leaves=15, max_bin=63, verbosity=-1),
                  lj.Dataset(X, label=y), ROUNDS)
    trees, mappers, used = _jax_trees_as_numpy(bj)
    meta = {"mappers": mappers, "used_features": used,
            "objective": params["objective"], "device_type": "cpu",
            "average_output": bj._boosting.average_output}
    if "num_class" in params:
        meta["num_class"] = params["num_class"]
    bt = lt.booster_from_numpy(trees, meta)
    Xt, _ = _data(seed=67, n=700)
    raw = bt.predict(Xt, raw_score=True)
    np.testing.assert_allclose(raw, bj.predict(Xt, raw_score=True), rtol=0,
                               atol=1e-12)
    assert raw.shape == ((700, 3) if "num_class" in params else (700,))
    np.testing.assert_allclose(bt.predict(Xt), bj.predict(Xt), rtol=0,
                               atol=1e-6)


def test_rf_model_text_loads_back():
    X, y = _data(seed=68)
    bt = lt.train({"objective": "binary", "boosting": "rf",
                   "bagging_fraction": 0.6, "bagging_freq": 1,
                   "num_leaves": 15, "max_bin": 63, "verbosity": -1,
                   "device_type": "cpu"},
                  lt.Dataset(X, label=_labels("binary", y)), ROUNDS)
    text = bt.model_to_string()
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    Xt, _ = _data(seed=69, n=600)
    np.testing.assert_allclose(loaded.predict(Xt, raw_score=True),
                               bt.predict(Xt, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(loaded.predict(Xt), bt.predict(Xt), rtol=0,
                               atol=1e-6)
    assert loaded.model_to_string() == text
