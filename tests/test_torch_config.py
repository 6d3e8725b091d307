"""The PyTorch port's parameter table (lightgbm_tpu_torch/config.py) against the
JAX package's, and L2 training parity over sampled in-slice parameters.

The port carries the whole table over: the same fields in the same order
with the same defaults (``device_type`` aside: "cuda" in the port) and the
same alias table, so ``to_params`` echoes the same ``parameters:`` block
into model text. A sampled parameter set either configures both packages
identically or, when it leaves the ported slice, raises NotImplementedError
naming the parameter. L2 models trained from sampled in-slice sets are
bitwise equal to the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import PARAM_ALIASES as J_ALIASES
from lightgbm_tpu_torch.config import PARAM_ALIASES as T_ALIASES

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


def test_parameter_table_matches():
    j, t = _fields(lj.Config), _fields(lt.Config)
    assert [n for n, _ in j] == [n for n, _ in t]
    diff = [(a, b) for a, b in zip(j, t) if a != b]
    assert diff == [(("device_type", "tpu"), ("device_type", "cuda"))]
    assert J_ALIASES == T_ALIASES


def _sample_params(rng):
    """The sampler of tests/test_config_fuzz.py (its slow sweep), plus the
    port's device."""
    p = {"objective": "binary", "verbosity": -1,
         "num_leaves": int(rng.choice([4, 15, 31])),
         "min_data_in_leaf": int(rng.choice([1, 5, 40])),
         "learning_rate": float(rng.choice([0.05, 0.3])),
         "max_depth": int(rng.choice([-1, 3, 6])),
         "feature_fraction": float(rng.choice([1.0, 0.7])),
         "max_bin": int(rng.choice([15, 63, 255]))}
    if rng.rand() < 0.5:
        p.update(bagging_fraction=float(rng.choice([0.4, 0.8])),
                 bagging_freq=1)
    if rng.rand() < 0.3:
        p["extra_trees"] = True
    if rng.rand() < 0.3:
        p["min_gain_to_split"] = 0.1
    if rng.rand() < 0.3:
        p["lambda_l1"] = 0.5
    if rng.rand() < 0.3:
        p["lambda_l2"] = 5.0
    if rng.rand() < 0.25:
        p["monotone_constraints"] = [1, -1] + [0] * 6
    return p


OUTSIDE = ("feature_fraction", "bagging_fraction", "bagging_freq",
           "extra_trees", "monotone_constraints")


@pytest.mark.parametrize("seed", range(8))
def test_sampled_parameters_configure_alike_or_raise(seed):
    params = _sample_params(np.random.RandomState(1000 + seed))
    jc = lj.Config.from_params(dict(params))
    outside = [k for k in OUTSIDE
               if k in params and getattr(jc, k) != dict(_fields(lj.Config))[k]]
    if outside:
        with pytest.raises(NotImplementedError) as err:
            lt.Config.from_params(dict(params, device_type="cpu"))
        assert any(k in str(err.value) for k in outside)
        return
    tc = lt.Config.from_params(dict(params, device_type="cpu"))
    for name, _ in _fields(lj.Config):
        if name != "device_type":
            assert getattr(tc, name) == getattr(jc, name), name
    assert tc.to_params() == {k: v for k, v in jc.to_params().items()
                              if k != "device_type"}


@pytest.mark.parametrize("is_enable_sparse", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_sampled_l2_training_bitwise(seed, is_enable_sparse):
    """With sparse storage on (the default), column 7 (>= 90% zeros) lives
    as device streams and the trees take the classic split path."""
    rng = np.random.RandomState(2000 + seed)
    params = {k: v for k, v in _sample_params(rng).items()
              if k not in OUTSIDE}
    params.update(objective="regression", is_enable_sparse=is_enable_sparse,
                  eta=params.pop("learning_rate"))          # an alias too
    n = 1200
    X = rng.normal(size=(n, 8))
    if rng.rand() < 0.5:
        X[rng.uniform(size=X.shape) < 0.05] = np.nan
    X[rng.uniform(size=n) < 0.95, 7] = 0.0
    y = np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) ** 2 \
        + 0.1 * rng.normal(size=n)
    bj = lj.train(dict(params), lj.Dataset(X, label=y), 6)
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y), 6)
    assert bt.model_to_string() == bj.model_to_string(), params
