"""The port's TreeSHAP (``io/shap.py``) against the JAX package's, on the CPU.

Both packages train on the same numpy rows (made from a seed) with the same
parameters (model texts equal); on the same model trees the port's per-row
oracle is bitwise the JAX oracle, and its batched path (the host's
decisions, the extend/unwind DP in torch float64) is within rtol 1e-9 /
atol 1e-11 of the JAX fast path and of the oracle (the JAX package's own
bar, ``tests/test_shap_fast.py``), across deep trees with repeated
features, NaN routing, categorical splits, multiclass layouts and row
blocks; the float32 mode (``LIGHTGBM_TPU_SHAP_DTYPE=float32``) within
3e-5 / 3e-6. ``Booster.predict(pred_contrib=True)`` rows sum to the raw
scores within rtol 1e-6 / atol 1e-8, and a file-loaded model's
contributions equal the trained one's.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.io import shap as JS
from lightgbm_tpu_torch.io import shap as TS
from lightgbm_tpu_torch.io.model_text import ModelTree

torch.set_num_threads(1)

BAR = dict(rtol=1e-9, atol=1e-11)


def _pair(X, y, params, rounds, **ds_kw):
    bj = lj.train(dict(params), lj.Dataset(X, label=y, **ds_kw), rounds)
    pt = dict(params, device_type="cpu")
    bt = lt.train(pt, lt.Dataset(X, label=y, params=dict(pt), **ds_kw),
                  rounds)
    assert bt.model_to_string() == bj.model_to_string()
    return bj, bt


def _model_trees(booster):
    gb = booster._boosting
    return [ModelTree.from_host(ht, gb.train_set.mappers)
            for ht in gb.host_trees]


def _jax_trees(booster):
    from lightgbm_tpu.io.model_text import ModelTree as JModelTree
    gb = booster._boosting
    return [JModelTree.from_host(ht, gb.train_set.mappers)
            for ht in gb.host_trees]


def _case(name):
    if name == "numeric":
        rng = np.random.RandomState(0)
        X = rng.normal(size=(800, 6))
        y = X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=800)
        return X, y, {"num_leaves": 15, "min_data_in_leaf": 20}, 10, {}, 1
    if name == "deep_repeated":
        rng = np.random.RandomState(1)
        X = rng.normal(size=(2000, 3))
        y = np.sin(3 * X[:, 0]) + 0.5 * np.sign(X[:, 1]) * X[:, 2]
        return X, y, {"num_leaves": 63, "min_data_in_leaf": 5}, 5, {}, 1
    if name == "nan_categorical":
        rng = np.random.RandomState(2)
        X = rng.normal(size=(1500, 5))
        X[:, 3] = rng.randint(0, 8, size=1500)
        X[rng.rand(1500) < 0.2, 1] = np.nan
        y = (X[:, 0] + (X[:, 3] > 3)
             + np.where(np.isnan(X[:, 1]), 0.5, X[:, 1]))
        return (X, y, {"num_leaves": 15, "min_data_in_leaf": 20}, 8,
                {"categorical_feature": [3]}, 1)
    rng = np.random.RandomState(3)
    X = rng.normal(size=(900, 4))
    y = ((X[:, 0] + 0.5 * X[:, 1] > 0).astype(int) + (X[:, 2] > 1)
         ).astype(float)
    return (X, y, {"objective": "multiclass", "num_class": 3,
                   "num_leaves": 7, "min_data_in_leaf": 20}, 5, {}, 3)


@pytest.mark.parametrize("name", ["numeric", "deep_repeated",
                                  "nan_categorical", "multiclass"])
def test_shap_against_jax(name):
    X, y, extra, rounds, ds_kw, k = _case(name)
    params = dict({"objective": "regression", "verbosity": -1}, **extra)
    bj, bt = _pair(X, y, params, rounds, **ds_kw)
    f = X.shape[1]
    Xs = X[:200]
    trees = _model_trees(bt)
    jtrees = _jax_trees(bj)
    if name == "deep_repeated":
        assert any(len(feats) < sum(len(sp) for sp in splits)
                   for t in trees for feats, _, splits in TS._leaf_paths(t))
    ref_t = TS.predict_contrib_trees_reference(trees, Xs, f, k)
    ref_j = JS.predict_contrib_trees_reference(jtrees, Xs, f, k)
    np.testing.assert_array_equal(ref_t, ref_j)
    fast_t = TS.predict_contrib_trees_fast(trees, Xs, f, k)
    fast_j = JS.predict_contrib_trees_fast(jtrees, Xs, f, k)
    np.testing.assert_allclose(fast_t, fast_j, **BAR)
    np.testing.assert_allclose(fast_t, ref_t, **BAR)
    # through Booster.predict, and the sums-to-raw contract
    got = bt.predict(Xs, pred_contrib=True)
    np.testing.assert_allclose(got, bj.predict(Xs, pred_contrib=True),
                               **BAR)
    raw = bt.predict(Xs, raw_score=True)
    sums = got.reshape(len(Xs), k, f + 1).sum(axis=2)
    np.testing.assert_allclose(sums if k > 1 else sums[:, 0], raw,
                               rtol=1e-6, atol=1e-8)


def test_shap_f32_mode(monkeypatch):
    monkeypatch.setenv("LIGHTGBM_TPU_SHAP_DTYPE", "float32")
    rng = np.random.RandomState(5)
    X = rng.normal(size=(500, 4))
    y = X[:, 0] + 0.3 * X[:, 1]
    bj, bt = _pair(X, y, {"objective": "regression", "num_leaves": 15,
                          "min_data_in_leaf": 20, "verbosity": -1}, 8)
    trees = _model_trees(bt)
    ref = TS.predict_contrib_trees_reference(trees, X[:200], 4)
    fast = TS.predict_contrib_trees_fast(trees, X[:200], 4)
    np.testing.assert_allclose(fast, ref, rtol=3e-5, atol=3e-6)
    fast_j = JS.predict_contrib_trees_fast(_jax_trees(bj), X[:200], 4)
    np.testing.assert_allclose(fast, fast_j, rtol=3e-5, atol=3e-6)


def test_reference_switch_and_loaded_model(monkeypatch):
    """``LIGHTGBM_TPU_SHAP=reference`` takes the oracle, bitwise the JAX
    package's; a model loaded from text gives the trained model's
    contributions."""
    rng = np.random.RandomState(4)
    X = rng.normal(size=(600, 5))
    y = (X[:, 0] - X[:, 2] > 0).astype(float)
    bj, bt = _pair(X, y, {"objective": "binary", "num_leaves": 15,
                          "min_data_in_leaf": 20, "verbosity": -1}, 10)
    fast = bt.predict(X[:100], pred_contrib=True)
    loaded = lt.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(loaded.predict(X[:100], pred_contrib=True),
                               fast, **BAR)
    monkeypatch.setenv("LIGHTGBM_TPU_SHAP", "reference")
    np.testing.assert_array_equal(bt.predict(X[:100], pred_contrib=True),
                                  bj.predict(X[:100], pred_contrib=True))
    np.testing.assert_allclose(bt.predict(X[:100], pred_contrib=True), fast,
                               **BAR)


def test_bucket_ceiling_beyond_table():
    for d in (1, 2, 3, 33, 256, 257, 500):
        assert TS._bucket_ceiling(d) == JS._bucket_ceiling(d)
    assert TS._bucket_ceiling(257) == 320


def test_shap_outer_row_blocks(monkeypatch):
    """Row blocks of 100 give the unblocked contributions."""
    rng = np.random.RandomState(6)
    X = rng.normal(size=(350, 4))
    y = X[:, 0] - 0.4 * X[:, 2]
    bj, bt = _pair(X, y, {"objective": "regression", "num_leaves": 15,
                          "min_data_in_leaf": 20, "verbosity": -1}, 6)
    trees = _model_trees(bt)
    whole = TS.predict_contrib_trees_fast(trees, X, 4)
    monkeypatch.setattr(TS, "_dec_row_block", lambda total_nodes: 100)
    blocked = TS.predict_contrib_trees_fast(trees, X, 4)
    np.testing.assert_allclose(blocked, whole, **BAR)
    np.testing.assert_allclose(
        blocked, TS.predict_contrib_trees_reference(trees, X, 4), **BAR)
