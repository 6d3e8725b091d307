"""Row-sharded prediction (``predict_sharded``) of the PyTorch port.

The JAX engine shards its scan over the test process's 8 virtual devices
(``shard_map`` over ``jax.devices()``); the port's engine takes its device
list as a constructor argument (``GBDT.predict_devices``), so here it
shards over eight entries of the CPU. The sharded predict is bitwise the
port's unsharded predict and the JAX package's sharded one, raw and
converted, with K = 3, in row chunks, with early stopping and for
``pred_leaf``; through the public parameter on one device it runs one
shard and says so. Shards are contiguous and equal, every shard is one
launch on its own device's tables, and a serve-mode booster never
shards.
"""

import logging

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models import predict_engine as tpe
from lightgbm_tpu_torch.utils import log as tlog

torch.set_num_threads(1)

EIGHT = ["cpu"] * 8
BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1}


def _data(n=1203, f=6, seed=0, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    X[rng.rand(n) < 0.05, 3] = np.nan
    s = X[:, 0] + 0.5 * X[:, 1] - 0.3 * np.nan_to_num(X[:, 3])
    y = (np.digitize(s, [-0.5, 0.5]) if classes > 2
         else (s > 0)).astype(np.float64)
    return X, y


def _pair(extra=None, rounds=8, classes=2):
    """The same model in both packages (texts equal), the JAX one with
    ``predict_sharded`` on, the port's sharded over eight CPU entries."""
    X, y = _data(classes=classes)
    p = dict(BASE, objective="multiclass" if classes > 2 else "binary",
             **(extra or {}))
    if classes > 2:
        p["num_class"] = classes
    bj = lj.train(dict(p, predict_sharded=True),
                  lj.Dataset(X, label=y, params=dict(p)), rounds)
    tp = dict(p, device_type="cpu")
    bt = lt.train(dict(tp), lt.Dataset(X, label=y, params=dict(tp)), rounds)
    bs = lt.train(dict(tp, predict_sharded=True),
                  lt.Dataset(X, label=y, params=dict(tp)), rounds)
    bs._boosting.predict_devices = list(EIGHT)
    assert bj.model_to_string().split("parameters:")[0] == \
        bt.model_to_string().split("parameters:")[0] == \
        bs.model_to_string().split("parameters:")[0]
    return X, bj, bt, bs


@pytest.fixture(scope="module")
def binary():
    return _pair()


def test_sharded_matches_unsharded_and_jax(binary):
    X, bj, bt, bs = binary
    eng = bs._boosting._predict_engine()
    assert eng.sharded and len(eng.devices) == 8
    for kw in ({"raw_score": True}, {}):
        want = bt.predict(X, **kw)
        got = bs.predict(X, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, bj.predict(X, **kw))


def test_sharded_early_stopping_and_leaves(binary):
    X, bj, bt, bs = binary
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.0, raw_score=True)
    np.testing.assert_array_equal(bs.predict(X, **kw), bt.predict(X, **kw))
    np.testing.assert_array_equal(bs.predict(X, **kw), bj.predict(X, **kw))
    np.testing.assert_array_equal(bs.predict(X, pred_leaf=True),
                                  bt.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(bs.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))


def test_sharded_multiclass_converted():
    X, bj, bt, bs = _pair(classes=3, rounds=4)
    got = bs.predict(X)
    assert got.shape == (len(X), 3)
    np.testing.assert_array_equal(got, bt.predict(X))
    np.testing.assert_array_equal(got, bj.predict(X))


def test_chunked_and_sharded_launches(binary, monkeypatch):
    """Row chunks of ``predict_chunk_rows`` each split over the shards:
    one launch a (chunk, shard), each on its shard's rows only, and the
    result still bitwise the unsharded one."""
    X, _, bt, bs = binary
    g = bs._boosting
    g.config.predict_chunk_rows = 500
    g._engine_cache.clear()
    calls = []
    real = tpe.predict_ensemble

    def counted(tables, binsT, *a, **kw):
        calls.append(binsT.shape[1])
        return real(tables, binsT, *a, **kw)

    monkeypatch.setattr(tpe, "predict_ensemble", counted)
    try:
        got = bs.predict(X, raw_score=True)
    finally:
        g.config.predict_chunk_rows = 0
        g._engine_cache.clear()
        monkeypatch.undo()
    np.testing.assert_array_equal(got, bt.predict(X, raw_score=True))
    # chunks of 500, 500, 203 rows; 8 shards of 63 / 63 / 26 rows, each
    # chunk's last shorter (59, 59, 21)
    assert len(calls) == 8 + 8 + 8
    assert sum(calls) == len(X)
    assert calls[:8] == [63] * 7 + [59]


@pytest.mark.parametrize("n,d", [(1203, 8), (8, 8), (5, 8), (1, 3),
                                 (0, 2), (1000, 1)])
def test_shards_are_contiguous_and_equal(binary, n, d):
    eng = tpe.PredictEngine(binary[3]._boosting._stacked(8), 1, 8, 3,
                            sharded=True, devices=["cpu"] * d)
    sh = eng.shards(n)
    size = -(-n // d) if n else 0
    assert sh[0][1] == 0 and sh[-1][2] == n
    for (_, lo, hi), (_, lo2, _) in zip(sh, sh[1:]):
        assert hi == lo2 and hi - lo == size
    assert all(0 < hi - lo <= size for _, lo, hi in sh) or n == 0


def test_tables_replicated_once_a_device(binary):
    X, _, _, bs = binary
    eng = bs._boosting._predict_engine()
    bs.predict(X[:50])
    first = eng.tables_on("cpu")
    bs.predict(X[:50])
    assert eng.tables_on(torch.device("cpu")) is first
    assert first[0] is eng.tables


def test_public_parameter_one_device_logs_one_shard(caplog):
    """``predict_sharded`` through the parameters, on the one CPU device:
    one shard through the sharded path, said at info, bitwise the
    unsharded predict."""
    X, y = _data()
    p = dict(BASE, objective="binary", device_type="cpu")
    plain = lt.train(dict(p), lt.Dataset(X, label=y, params=dict(p)), 4)
    b = lt.train(dict(p, predict_sharded=True),
                 lt.Dataset(X, label=y, params=dict(p)), 4)
    logger = logging.getLogger("lgbm_torch_test_sharded")
    tlog.register_logger(logger)
    tlog.set_verbosity(1)
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            got = b.predict(X)
    finally:
        tlog._logger = None
        tlog.set_verbosity(-1)
    eng = b._boosting._predict_engine()
    assert eng.sharded and eng.devices == [torch.device("cpu")]
    assert any("one shard" in r.message for r in caplog.records)
    np.testing.assert_array_equal(got, plain.predict(X))


def test_serve_mode_and_score_dataset_with_sharding(binary):
    """A serve-mode booster takes the ordinary sharded path (no serve
    slot), and the training-time evaluation of a valid set through a
    sharded engine is the unsharded one."""
    X, _, bt, bs = binary
    g = bs._boosting
    g.enable_serve_mode(True)
    try:
        got = bs.predict(X[:100])
        assert not g._predict_engine()._serve_slots
    finally:
        g.enable_serve_mode(False)
    np.testing.assert_array_equal(got, bt.predict(X[:100]))
    ts = g.train_set
    np.testing.assert_array_equal(g.score_dataset(ts),
                                  bt._boosting.score_dataset(
                                      bt._boosting.train_set))


def test_predict_rung_on_a_sharded_engine(binary):
    """The OOM ladder's predict rung halves the chunk of a sharded engine
    and keeps the bits."""
    X, _, bt, bs = binary
    from lightgbm_tpu_torch import distributed
    from lightgbm_tpu_torch.utils import faults
    g = bs._boosting
    g.config.fault_oom_at_predict = 1
    g.config.predict_chunk_rows = 65536
    g._engine_cache.clear()
    distributed.reset_degradations()
    faults.reset_predict_oom()
    try:
        got = bs.predict(X, raw_score=True)
        eng = g._predict_engine()
        assert eng.sharded and eng.chunk_rows == 32768
    finally:
        g.config.fault_oom_at_predict = 0
        g.config.predict_chunk_rows = 0
        g._oom_predict_chunk = 0
        g._engine_cache.clear()
        faults.reset_predict_oom()
    np.testing.assert_array_equal(got, bt.predict(X, raw_score=True))
    assert [e["action"] for e in distributed.degradations()] == [
        "predict_chunk_rows -> 32768"]
