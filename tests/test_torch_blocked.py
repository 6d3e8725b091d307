"""The port's memory-bounded (feature-blocked) growth against the JAX
package's blocked mode, on the CPU.

``histogram_pool_size`` caps the resident ``[L, F, B, 3]`` histogram state;
above the cap the grower histograms and searches one column block at a
time and keeps only the per-leaf best splits.

- ``_feature_block``'s decision and width equal the JAX package's
  (``_feature_block("pallas")``, whose tile is the port's 42 slots) on the
  same inputs, and the refusal list (CEGB, forced splits, intermediate
  monotone constraints, the subset copy, f64, q8, sparse columns) warns
  and stays resident in both;
- model text bitwise the JAX package's blocked mode at a pool size that
  forces several blocks of a width that does not divide F: numerical
  data, mask bagging with basic monotone constraints, extra_trees,
  categorical features;
- grower level: blocked equals the resident grower with
  ``hist_subtraction=False`` bit for bit, on injected grad/hess, at widths
  16, 23 (not a divisor of F) and one block, in the plain sums and in the
  kernels' sums (``kernel_sums_on_cpu``, where the resident run also reads
  the compaction rungs); the column views persist across trees.
"""

import contextlib
import logging

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.grower import column_blocks, grow_tree
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops.split import FeatureMeta, SplitParams
from lightgbm_tpu_torch.utils import log as tlog

torch.set_num_threads(1)

N, F, L = 1000, 100, 31
POOL = 6.0      # MB: 18 columns a block at 31 leaves, 256 bins (6 blocks)


def _wide(n=N, f=F, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = X[:, 0] + 0.7 * X[:, 3] - 0.5 * X[:, 40] + 0.1 * rng.normal(size=n)
    return X, y


def _p(lib, params):
    p = dict(params)
    if lib is lt:
        p["device_type"] = "cpu"
    return p


def _train(lib, params, X, y, rounds=2, **ds_kw):
    p = _p(lib, params)
    ds = lib.Dataset(X, label=y, params=p, free_raw_data=False, **ds_kw)
    return lib.train(dict(p), ds, rounds)


BASE = {"objective": "regression", "num_leaves": L, "min_data_in_leaf": 20,
        "verbosity": -1}


@pytest.mark.parametrize("extra", [
    {},
    {"bagging_fraction": 0.8, "bagging_freq": 1,
     "monotone_constraints": [1] + [0] * (F - 1)},
    {"extra_trees": True},
], ids=["numerical", "bagging_monotone", "extra_trees"])
def test_blocked_text_is_the_jax_packages(extra):
    X, y = _wide()
    p = {**BASE, **extra, "histogram_pool_size": POOL}
    bt = _train(lt, p, X, y)
    bj = _train(lj, p, X, y)
    fb = bt._boosting._feature_block()
    assert fb == bj._boosting._feature_block("pallas") == 18
    assert F % fb and -(-F // fb) >= 2
    assert not bt._boosting._split_fusion_on(fb)
    assert bt.model_to_string() == bj.model_to_string()
    # every pass read all N rows once a block
    assert bt._boosting.rows_streamed_total % (N * -(-F // fb)) == 0


def test_blocked_categorical_text_is_the_jax_packages():
    X, y = _wide(f=44)
    rng = np.random.RandomState(4)
    X[:, 5] = rng.randint(0, 12, size=N)
    y = y + (X[:, 5] % 3)
    p = {**BASE, "histogram_pool_size": 1.0}
    bt = _train(lt, p, X, y, categorical_feature=[5])
    bj = _train(lj, p, X, y, categorical_feature=[5])
    assert bt._boosting._feature_block() == 16
    assert bt.model_to_string() == bj.model_to_string()


def _booster(lib, params, X, y, **ds_kw):
    p = _p(lib, params)
    return lib.Booster(params=p, train_set=lib.Dataset(X, label=y, params=p,
                                                       **ds_kw))


@pytest.mark.parametrize("params", [
    {},                                           # the 2 GiB auto cap
    {"histogram_pool_size": 1024.0},              # above the state
    {"histogram_pool_size": POOL},
    {"histogram_pool_size": 0.01},                # the 16-column floor
    {"histogram_pool_size": 3.0, "tile_leaves": 8},
    {"histogram_pool_size": 3.0, "num_leaves": 63},
], ids=["auto", "large", "pool", "floor", "tile8", "leaves63"])
def test_feature_block_decision_equals_the_jax_packages(params):
    X, y = _wide()
    p = {**BASE, **params}
    assert _booster(lt, p, X, y)._boosting._feature_block() \
        == _booster(lj, p, X, y)._boosting._feature_block("pallas")


def _forced(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text('{"feature": 0, "threshold": 0.0}')
    return str(path)


REFUSED = {
    "cegb": {"cegb_tradeoff": 0.5, "cegb_penalty_split": 0.1},
    "forced": "forced",
    "intermediate": {"monotone_constraints": [1] + [0] * (F - 1),
                     "monotone_constraints_method": "intermediate"},
    "subset": {"bagging_fraction": 0.4, "bagging_freq": 1},
    "f64": {"gpu_use_dp": True},
    "q8": {"quantized_grad": True},
    "sparse": "sparse",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_configurations_warn_and_stay_resident(case, tmp_path,
                                                        caplog):
    X, y = _wide(n=600)
    extra = REFUSED[case]
    if extra == "forced":
        extra = {"forcedsplits_filename": _forced(tmp_path)}
    elif extra == "sparse":
        X[np.random.RandomState(2).rand(600) < 0.92, 7] = 0.0
        extra = {}
    p = {**BASE, **extra, "histogram_pool_size": 0.5}
    logger = logging.getLogger("lgbm_torch_test_blocked")
    tlog.register_logger(logger)
    tlog.set_verbosity(0)
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            tb = _booster(lt, p, X, y)._boosting
            tlog.set_verbosity(0)
            assert tb._feature_block() == 0
        assert any("keeping the resident state" in r.message
                   for r in caplog.records)
    finally:
        tlog._logger = None
    if case == "sparse":
        assert tb.train_set.has_sparse_cols
    hm = "pallas_q8" if case == "q8" else "pallas"
    ctx = jax.enable_x64(True) if case == "f64" \
        else contextlib.nullcontext()
    with ctx:
        assert _booster(lj, p, X, y)._boosting._feature_block(hm) == 0


def _grower_inputs(n=3000, f=50, b=32, seed=7):
    rng = np.random.RandomState(seed)
    binsT = torch.from_numpy(rng.randint(0, b, size=(f, n)).astype(np.uint8))
    grad = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    hess = torch.from_numpy((rng.rand(n) + 0.5).astype(np.float32))
    meta = FeatureMeta(
        num_bins=torch.full((f,), b, dtype=torch.int32),
        missing_type=torch.zeros((f,), dtype=torch.int32),
        default_bin=torch.zeros((f,), dtype=torch.int32),
        is_categorical=torch.zeros((f,), dtype=torch.bool),
        monotone=torch.zeros((f,), dtype=torch.int8),
        penalty=torch.ones((f,), dtype=torch.float32))
    params = SplitParams.from_config(lt.Config.from_params(
        {"min_data_in_leaf": 5, "device_type": "cpu"}))
    mb = torch.full((f,), -1, dtype=torch.int32)
    return binsT, grad, hess, meta, params, mb


def _fields(tree):
    return [np.asarray(getattr(tree, k)).tobytes() for k in tree._fields]


@pytest.mark.parametrize("kernel_sums", [False, True],
                         ids=["plain_sums", "kernel_sums"])
def test_blocked_grower_bit_parity(kernel_sums):
    binsT, grad, hess, meta, params, mb = _grower_inputs()
    common = dict(max_leaves=31, num_bins=32, split_fusion=False)
    ctx = cuda_hist.kernel_sums_on_cpu() if kernel_sums \
        else contextlib.nullcontext()
    with ctx:
        res, res_leaf, res_rows = grow_tree(binsT, grad, hess, meta, params,
                                            mb, hist_subtraction=False,
                                            **common)
        # the card's resident run reads the compaction rungs: with the
        # kernels' fixed-point sums it still equals the blocked run
        ladder = ((192, 768, 1536) if kernel_sums else ())
        res_l, _, _ = grow_tree(binsT, grad, hess, meta, params, mb,
                                hist_subtraction=False,
                                compaction_ladder=ladder, **common)
        assert _fields(res_l) == _fields(res)
        for fb in (16, 23, 64):
            counters = {}
            blk, blk_leaf, rows = grow_tree(
                binsT, grad, hess, meta, params, mb, feature_block=fb,
                counters=counters, **common)
            assert int(blk.num_leaves) == 31
            assert _fields(blk) == _fields(res), fb
            assert torch.equal(blk_leaf, res_leaf)
            assert rows % (3000 * -(-50 // fb)) == 0


def test_column_views_persist_across_trees():
    binsT = _grower_inputs()[0]
    first = column_blocks(binsT, 23)
    assert [(s, e) for s, e, _ in first] == [(0, 23), (23, 46), (46, 50)]
    again = column_blocks(binsT, 23)
    assert all(a[2] is b[2] for a, b in zip(first, again))
    assert column_blocks(binsT, 16)[0][2] is not first[0][2]


def test_blocked_sentinel_flags_nan_stats():
    binsT, grad, hess, meta, params, mb = _grower_inputs(n=500)
    grad = grad.clone()
    grad[3] = float("nan")
    for fb in (0, 16):
        counters = {}
        grow_tree(binsT, grad, hess, meta, params, mb, max_leaves=15,
                  num_bins=32, split_fusion=False, feature_block=fb,
                  counters=counters, numerics_sentinels=True)
        assert counters["sentinel"] == 1, fb
    clean = {}
    grow_tree(binsT, _grower_inputs(n=500)[1], hess, meta, params, mb,
              max_leaves=15, num_bins=32, split_fusion=False,
              feature_block=16, counters=clean, numerics_sentinels=True)
    assert clean["sentinel"] == 0


def test_pool_size_is_accepted_and_routes_no_item():
    cfg = lt.Config.from_params({"histogram_pool_size": 64.0,
                                 "device_type": "cpu"})
    assert cfg.histogram_pool_size == 64.0


def test_greedy_bin_walk_equals_the_jax_packages():
    """The greedy bin search walks a bin at a time (a wide table's
    construct time); its bounds equal the JAX package's value-at-a-time
    walk on continuous, repeated, big-count and heavy-tailed counts."""
    from lightgbm_tpu.binning import greedy_find_bin as jg
    from lightgbm_tpu_torch.binning import greedy_find_bin as tg
    rng = np.random.RandomState(0)
    for trial in range(400):
        nd = rng.randint(2, 3000)
        dv = np.unique(np.round(rng.standard_normal(nd)
                                * rng.choice([1, 10, 1000]),
                                rng.randint(0, 6)))
        nd = len(dv)
        kind = trial % 4
        if kind == 0:
            cnt = np.ones(nd, np.int64)
        elif kind == 1:
            cnt = rng.randint(1, 5, nd).astype(np.int64)
        elif kind == 2:
            cnt = np.ones(nd, np.int64)
            cnt[rng.randint(0, nd, 5)] = rng.randint(50, 5000, 5)
        else:
            cnt = rng.geometric(0.01, nd).astype(np.int64)
        total = int(cnt.sum()) + rng.randint(0, 3)
        mb = int(rng.choice([2, 3, 15, 63, 255, 1023]))
        mdb = int(rng.choice([0, 1, 3, 20]))
        assert tg(dv, cnt, mb, total, mdb) == jg(dv, cnt, mb, total, mdb)
