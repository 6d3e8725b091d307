"""The PyTorch port's predictions against the JAX package's for every data
kind, on the CPU.

Sparse device columns (``score_dataset`` reads ``traversal_binsT``), wide
bins (int16), categorical bitsets, EFB bundles from scipy-sparse input and
linear trees (the last two through the model trees on raw rows): both
packages train on the same numpy rows with the same parameters (model
texts equal), and raw, converted, ``pred_leaf``, early-stopped and
windowed predictions, and ``score_dataset``, are bitwise the JAX
package's.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    X = rng.normal(size=(600, 8)).astype(np.float64)
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])) > 0) \
        .astype(np.float64)
    y3 = np.digitize(np.nan_to_num(X[:, 0]) + 0.3 * np.nan_to_num(X[:, 2]),
                     [-0.5, 0.5]).astype(np.float64)
    return X, y, y3


def _train_pair(X, y, extra, nround=6, **ds_kw):
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
         "verbosity": -1}
    p.update(extra)
    bj = lj.train(dict(p), lj.Dataset(X, label=y, params=dict(p), **ds_kw),
                  nround)
    pt = dict(p, device_type="cpu")
    bt = lt.train(pt, lt.Dataset(X, label=y, params=dict(pt), **ds_kw),
                  nround)
    assert bt.model_to_string() == bj.model_to_string()
    return bj, bt


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


_DATA_KINDS = ("sparse_columns", "wide_bins", "categorical", "efb",
               "linear_tree")


def _data_kind(kind, X, y):
    rng = np.random.RandomState(11)
    if kind == "sparse_columns":
        X = X.copy()
        X[:, 5] = np.where(rng.rand(len(X)) < 0.95, 0.0, rng.rand(len(X)))
        return X, y, {}
    if kind == "wide_bins":
        return X, y, {"max_bin": 1023, "min_data_in_bin": 1}
    if kind == "categorical":
        X = X.copy()
        X[:, 3] = rng.randint(0, 40, len(X))
        return X, y, {"min_data_per_group": 5, "cat_smooth": 1.0}
    if kind == "efb":
        import scipy.sparse as sp
        n = len(X)
        cols = np.zeros((n, 12))
        which = rng.randint(0, 12, n)
        cols[np.arange(n), which] = rng.rand(n) + 0.5
        Xs = np.hstack([np.nan_to_num(X[:, :2]), cols])
        ys = ((Xs[:, 0] + Xs[:, 2] + Xs[:, 5]) > 0.5).astype(np.float64)
        return sp.csr_matrix(Xs), ys, {}
    return np.nan_to_num(X), y, {"linear_tree": True, "linear_lambda": 0.1}


@pytest.mark.parametrize("kind", _DATA_KINDS)
def test_data_kinds(data, kind):
    """Sparse device columns (``traversal_binsT`` for score_dataset), wide
    bins (int16), categorical bitsets, EFB bundles and linear trees (the
    last two through the model trees on raw rows): bitwise the JAX
    package's."""
    X0, y0, _ = data
    X, y, extra = _data_kind(kind, X0, y0)
    bj, bt = _train_pair(X, y, extra, nround=5, **(
        {"categorical_feature": [3]} if kind == "categorical" else {}))
    if kind == "sparse_columns":
        assert bt._boosting.train_set.has_sparse_cols
    if kind == "wide_bins":
        assert bt._boosting.train_set.binsT.dtype == torch.int16
    for kw in ({"raw_score": True}, {}, {"pred_leaf": True},
               {"raw_score": True, "pred_early_stop": True,
                "pred_early_stop_freq": 2, "pred_early_stop_margin": 0.3},
               {"raw_score": True, "start_iteration": 1,
                "num_iteration": 3}):
        _same(bt.predict(X, **kw), bj.predict(X, **kw))
    if kind in ("sparse_columns", "wide_bins", "categorical"):
        _same(bt._boosting.score_dataset(bt._boosting.train_set),
              bj._boosting.score_dataset(bj._boosting.train_set))
