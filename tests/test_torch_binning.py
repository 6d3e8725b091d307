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
