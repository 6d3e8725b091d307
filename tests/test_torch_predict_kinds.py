"""The PyTorch port's predictions against the JAX package's for every model
kind, on the CPU.

The same numpy rows (600 x 8 with 5% NaNs, made from a seed) train both
packages with the same parameters (model texts equal): gbdt, DART, RF,
GOSS, multiclass softmax and OVA, q8 binary and q8 multiclass. Raw,
converted, ``pred_leaf``, early-stopped and windowed predictions are
bitwise the JAX package's.
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


_KINDS = {
    "gbdt": ({}, "y"),
    "dart": ({"boosting": "dart", "drop_rate": 0.5}, "y"),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1},
           "y"),
    "goss": ({"boosting": "goss"}, "y"),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, "y3"),
    "multiclassova": ({"objective": "multiclassova", "num_class": 3}, "y3"),
    "q8": ({"quantized_grad": True}, "y"),
    "q8_multiclass": ({"quantized_grad": True, "objective": "multiclass",
                       "num_class": 3}, "y3"),
}


@pytest.mark.parametrize("kind", list(_KINDS))
def test_predict_bit_parity(data, kind):
    """Raw, converted, leaves, early stop and a window: bitwise the JAX
    package's for every model kind."""
    X, y, y3 = data
    extra, label = _KINDS[kind]
    bj, bt = _train_pair(X, y3 if label == "y3" else y, extra)
    for kw in ({"raw_score": True}, {},
               {"pred_leaf": True},
               {"raw_score": True, "pred_early_stop": True,
                "pred_early_stop_freq": 2, "pred_early_stop_margin": 0.4},
               {"pred_early_stop": True, "pred_early_stop_freq": 3,
                "pred_early_stop_margin": 1.0},
               {"raw_score": True, "start_iteration": 2,
                "num_iteration": 3},
               {"start_iteration": 1}):
        _same(bt.predict(X[:257], **kw), bj.predict(X[:257], **kw))
