"""Binning of the PyTorch port (lightgbm_tpu_torch/binning.py, basic.py) against
the JAX package: bin mappers fitted on the same seeded row sample and the
quantized matrix must be bitwise equal, on data with NaN, zeros, constant
and few-valued columns, in float32 and float64.
"""

import numpy as np
import pytest

import torch

from lightgbm_tpu import binning as jbin
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import binning as tbin
from lightgbm_tpu_torch.basic import Dataset as TDataset
from lightgbm_tpu_torch.config import Config as TConfig

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

CONFIGS = {
    "defaults": {},
    "zero_as_missing": {"zero_as_missing": True},
    "no_missing": {"use_missing": False},
    "coarse": {"max_bin": 15, "min_data_in_bin": 1},
    "sampled": {"bin_construct_sample_cnt": 700, "data_random_seed": 3},
    "pre_filter": {"min_data_in_leaf": 1400},
}


def _matrix(seed=0, n=2500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n) < 0.2, 0] = np.nan          # NaN-bearing
    X[rng.rand(n) < 0.5, 1] = 0.0             # zero-heavy
    X[:, 2] = 1.5                             # constant
    X[:, 3] = np.round(X[:, 3])               # few distinct values
    X[:, 4] = np.where(rng.rand(n) < 0.3, np.nan, 0.0)   # NaN or zero
    X[:, 5] = np.abs(X[:, 5]) * 1e6           # wide range, all positive
    X[:, 6] = -np.abs(X[:, 6])                # all non-positive
    return X


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_mappers_bitwise(cname):
    X = _matrix()
    jm = jbin.find_bin_mappers(X, JConfig.from_params(dict(CONFIGS[cname])))
    tm = tbin.find_bin_mappers(
        X, TConfig.from_params(dict(CONFIGS[cname], device_type="cpu")))
    assert len(jm) == len(tm)
    for j, (a, b) in enumerate(zip(jm, tm)):
        for name in ("num_bin", "missing_type", "is_trivial", "default_bin",
                     "most_freq_bin", "sparse_rate", "min_val", "max_val"):
            assert getattr(a, name) == getattr(b, name), (j, name)
        np.testing.assert_array_equal(
            np.asarray(b.bin_upper_bound).view(np.uint64),
            np.asarray(a.bin_upper_bound).view(np.uint64), err_msg=str(j))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cname", ["defaults", "zero_as_missing", "coarse"])
def test_bin_matrix_bitwise(cname, dtype):
    X = _matrix(seed=1).astype(dtype)
    mappers = jbin.find_bin_mappers(X, JConfig.from_params(
        dict(CONFIGS[cname])))
    used = [m for m in mappers if not m.is_trivial]
    cols = [j for j, m in enumerate(mappers) if not m.is_trivial]
    ref = jbin.bin_data(X[:, cols].astype(np.float64), used)
    out = tbin.bin_data_device(np.ascontiguousarray(X[:, cols]), used,
                               torch.device("cpu"), block=997)
    assert out.dtype == torch.uint8 and out.shape == (len(cols), len(X))
    np.testing.assert_array_equal(out.numpy().T, ref)
    if dtype == np.float32:
        # and the JAX package's own device quantizer
        dev = np.asarray(jbin.bin_data_device(
            np.ascontiguousarray(X[:, cols]), used))
        np.testing.assert_array_equal(out.numpy().T, dev)


def test_device_tables_match():
    X = _matrix(seed=2)
    used = [m for m in jbin.find_bin_mappers(X, JConfig()) if not m.is_trivial]
    jb, jz, jn = jbin.device_bin_tables(used)
    tb, tz, tn = tbin.device_bin_tables(used, np.float32)
    np.testing.assert_array_equal(tb.view(np.uint32), jb.view(np.uint32))
    np.testing.assert_array_equal(tz, jz)
    np.testing.assert_array_equal(tn, jn)


def test_dataset_holds_both_layouts_and_valid_shares_mappers():
    X = _matrix(seed=3)
    ds = TDataset(X, label=np.zeros(len(X)),
                  params={"device_type": "cpu"}).construct()
    assert ds.binsT.is_contiguous() and ds.bins.shape == (len(X),
                                                          ds.binsT.shape[0])
    np.testing.assert_array_equal(ds.bins.numpy(), ds.binsT.numpy().T)
    assert 2 not in ds.used_features            # constant column dropped
    va = TDataset(X[:100], reference=ds).construct()
    assert va.mappers is ds.mappers
    np.testing.assert_array_equal(va.binsT.numpy(), ds.binsT.numpy()[:, :100])


# ------------------------------------------------------------ categorical
def _cat_matrix(seed=0, n=3000):
    """Categorical columns: skewed codes, NaN, negative values (read as
    NaN), rare categories under min_data_in_bin, a float-coded column
    whose values truncate onto the same ints, and more categories than
    max_bin; column 0 stays numerical."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[:, 1] = rng.choice(12, n, p=rng.dirichlet(np.full(12, 0.5)))
    X[rng.rand(n) < 0.07, 1] = np.nan
    X[:, 2] = rng.randint(-2, 8, n)                  # negatives -> NaN
    X[:, 3] = rng.choice(300, n, p=rng.dirichlet(np.full(300, 0.3)))
    X[:, 4] = rng.randint(0, 5, n) + rng.rand(n) * 0.9   # 1.3 -> 1
    X[:, 5] = np.where(rng.rand(n) < 0.995, 7, rng.randint(0, 50, n))
    return X


CAT_COLS = [1, 2, 3, 4, 5]


@pytest.mark.parametrize("cname", ["defaults", "coarse", "pre_filter",
                                   "no_missing"])
def test_categorical_mappers_bitwise(cname):
    X = _cat_matrix()
    jm = jbin.find_bin_mappers(X, JConfig.from_params(dict(CONFIGS[cname])),
                               CAT_COLS)
    tm = tbin.find_bin_mappers(
        X, TConfig.from_params(dict(CONFIGS[cname], device_type="cpu")),
        CAT_COLS)
    for j, (a, b) in enumerate(zip(jm, tm)):
        for name in ("num_bin", "missing_type", "bin_type", "is_trivial",
                     "default_bin", "most_freq_bin", "sparse_rate",
                     "bin_2_categorical", "categorical_2_bin"):
            assert getattr(a, name) == getattr(b, name), (j, name)
        vals = np.concatenate([X[:, j], [np.nan, -1.0, 0.0, 1e6, 3.7]])
        np.testing.assert_array_equal(b.values_to_bins(vals),
                                      a.values_to_bins(vals))
        if b.bin_type == tbin.BIN_TYPE_CATEGORICAL:
            assert b.bin_to_value(1) == a.bin_to_value(1)
    assert tm[3].num_bin > 100 and tm[1].missing_type == tbin.MISSING_NAN


def test_categorical_bin_matrix_bitwise():
    X = _cat_matrix(seed=1)
    cfg = {"max_bin": 63}
    jm = jbin.find_bin_mappers(X, JConfig.from_params(dict(cfg)), CAT_COLS)
    used = [m for m in jm if not m.is_trivial]
    cols = [j for j, m in enumerate(jm) if not m.is_trivial]
    ref = jbin.bin_data(X[:, cols], used)
    out = tbin.bin_data_device(np.ascontiguousarray(X[:, cols]), used,
                               torch.device("cpu"), block=1001)
    np.testing.assert_array_equal(out.numpy().T, ref)


@pytest.mark.parametrize("n,enable", [(3000, True), (3000, False),
                                      (400, True)])
def test_sparse_device_columns_match_jax(n, enable):
    """_maybe_extract_sparse: the same columns, streams (row order, padded
    with N), defaults and dense remainder as the JAX package's; off below
    512 rows, with is_enable_sparse=false, and for validation sets."""
    import lightgbm_tpu as lj
    rng = np.random.RandomState(4)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.95, 1] = 0.0
    X[rng.rand(n) < 0.91, 3] = 2.5                  # mode away from zero
    X[rng.rand(n) < 0.85, 4] = 0.0                  # below the 90% bar
    X[:, 5] = rng.randint(0, 3, n)
    X[rng.rand(n) < 0.97, 5] = 1                    # categorical, mode 1
    params = {"max_bin": 31, "is_enable_sparse": enable, "verbosity": -1}
    jds = lj.Dataset(X, params=dict(params), categorical_feature=[5]
                     ).construct()
    tds = TDataset(X, params=dict(params, device_type="cpu"),
                   categorical_feature=[5]).construct()
    assert tds.has_sparse_cols == jds.has_sparse_cols == (enable
                                                          and n >= 512)
    np.testing.assert_array_equal(tds.binsT.numpy(), np.asarray(jds.bins).T)
    if tds.has_sparse_cols:
        np.testing.assert_array_equal(tds.sp_cols, jds.sp_cols)
        assert tds.sp_cols.tolist() == [1, 3, 5]
        for name in ("sp_rows", "sp_bins", "sp_default"):
            np.testing.assert_array_equal(getattr(tds, name).numpy(),
                                          np.asarray(getattr(jds, name)))
    va = TDataset(X[:700], reference=tds).construct()
    assert not va.has_sparse_cols
    assert va.binsT.shape[0] == len(tds.used_features)
