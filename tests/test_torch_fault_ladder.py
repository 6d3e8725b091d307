"""The port's numerics guard and OOM ladder against the JAX package, on
the CPU.

- ``check_numerics``: the gradient/hessian, leaf-output and sentinel
  messages equal the JAX package's word for word (``fault_nan_grad_at_iter``
  and ``fault_nan_hist_at_iter`` name iteration 2; a custom ``fobj`` that
  returns NaN); the grower's sentinel on its final state reaches the
  trainer's judge; a clean run's trees are bitwise the run without the
  flag.
- The OOM ladder (``fault_oom_at_iter`` / ``fault_oom_count``, and a
  ``torch.cuda.OutOfMemoryError``): the rungs in order -- the
  feature-blocked pass at the width of a quarter of the resident state's
  bytes, then at the 16-column floor, then the predict chunk -- each
  recorded in ``health_snapshot()``; a degraded run's trees are bitwise a
  fresh run at that rung's setting; a spent ladder, the gate off and a
  configuration that refuses the blocked pass re-raise; the classifier
  matches the allocation failures and nothing else; the degraded state
  rides a checkpoint; the predict rung (``fault_oom_at_predict``) halves
  the chunk, keeps the predictions bitwise and leaves the training rungs
  alone.
"""

import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import checkpoint as tckpt
from lightgbm_tpu_torch import distributed
from lightgbm_tpu_torch.models import gbdt as tgbdt
from lightgbm_tpu_torch.models.tree import empty_tree
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 5,
        "verbosity": -1}


def _data(n=400, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _p(lib, params):
    p = dict(BASE, **params)
    if lib is lt:
        p["device_type"] = "cpu"
    return p


def _fit(params, rounds=6, n=400, f=8, lib=lt, **kw):
    X, y = _data(n, f)
    p = _p(lib, params)
    return lib.train(dict(p), lib.Dataset(X, label=y, params=p), rounds,
                     **kw)


def _trees(text: str) -> str:
    """The trees of a model text (the parameters block echoes the fault
    and pool settings; the trees must not move)."""
    return text.split("\nparameters:")[0]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(os.environ):
        if name.startswith("LGBM_TPU_FAULT_"):
            monkeypatch.delenv(name)
    faults.reset_predict_oom()
    yield
    faults.reset_predict_oom()


# ------------------------------------------------------ check_numerics
@pytest.mark.parametrize("fault", ["fault_nan_grad_at_iter",
                                   "fault_nan_hist_at_iter"])
def test_check_numerics_message_is_the_jax_packages(fault):
    params = {"check_numerics": True, fault: 2}
    with pytest.raises(LightGBMError, match=r"iteration 2.*non-finite") \
            as et:
        _fit(params)
    # the JAX package's unfused spelling (its fused one reports the
    # in-program sentinel word instead)
    with pytest.raises(Exception) as ej:
        _fit({**params, "fused_iteration": False}, lib=lj)
    assert str(et.value) == str(ej.value)


def test_check_numerics_catches_custom_fobj_nans():
    X, y = _data()

    def bad_fobj(preds, ds):
        g = preds - np.asarray(ds.get_label())
        g[:3] = np.nan
        return g, np.ones_like(g)

    msgs = []
    for lib in (lt, lj):
        p = _p(lib, {"objective": "regression", "check_numerics": True})
        ds = lib.Dataset(X, label=y, params=p, free_raw_data=False)
        with pytest.raises(Exception, match="3 non-finite gradient") as e:
            lib.train(dict(p), ds, num_boost_round=3, fobj=bad_fobj)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_leaf_and_sentinel_messages_are_the_jax_packages():
    tb = _fit({}, rounds=1)._boosting
    jb = _fit({}, rounds=1, lib=lj)._boosting
    tree = empty_tree(4)
    tree.leaf_value[1] = float("nan")
    msgs = []
    for fn, arg in ((tb._check_numerics_leaves, tree),
                    (jb._check_numerics_leaves,
                     SimpleNamespace(leaf_value=tree.leaf_value.numpy()))):
        with pytest.raises(Exception, match="1 of 3 leaf outputs") as e:
            fn(arg, 3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for flags in (1 << 2, 0b10001):
        got = []
        for b in (tb, jb):
            with pytest.raises(Exception, match="in-program sentinels") as e:
                b._check_sentinel_flags(flags)
            got.append(str(e.value))
        assert got[0] == got[1]
    tb._check_sentinel_flags(0)


@pytest.mark.parametrize("pool", [None, 0.01], ids=["resident", "blocked"])
def test_grower_sentinel_reaches_the_judge(pool, monkeypatch):
    """With the gradient check out of the way, a NaN gradient reaches the
    histograms: the grower's sentinel on the final state flags bit 2."""
    monkeypatch.setattr(tgbdt.GBDT, "_check_numerics_grad",
                        lambda self, g, h: None)
    params = {"check_numerics": True, "fault_nan_hist_at_iter": 2}
    if pool:
        params["histogram_pool_size"] = pool
    with pytest.raises(LightGBMError) as e:
        _fit(params)
    msg = str(e.value)
    assert "iteration 2: in-program sentinels flagged non-finite values " \
           "in histogram sums" in msg
    assert "0b00100" in msg


def test_check_numerics_clean_run_unaffected():
    plain = _fit({}).model_to_string()
    checked = _fit({"check_numerics": True}).model_to_string()
    assert _trees(plain) == _trees(checked)
    assert _trees(checked) == _trees(_fit({"check_numerics": True},
                                          lib=lj).model_to_string())


# ------------------------------------------------------------ OOM ladder
F_WIDE = 80       # with 8-slot tiles rung 1's width (a quarter of the
WIDE = {"num_leaves": 31, "tile_leaves": 8}   # state) is 21, not 16
RUNG1 = 31 * F_WIDE * 3 // (8 * 44)


def test_oom_ladder_order_and_events():
    b = _fit({"fault_oom_at_iter": 1, "fault_oom_count": 3, **WIDE},
             rounds=3, f=F_WIDE)
    bb = b._boosting
    assert bb._oom_level == 3
    events = distributed.degradations()
    assert [e["level"] for e in events] == [1, 2, 3]
    assert [e["action"] for e in events] == [
        f"feature_block -> {RUNG1}", "feature_block -> 16 (floor)",
        "predict_chunk_rows -> 1048576"]
    assert all(e["iteration"] == 1 and e["kind"] == "oom" for e in events)
    assert bb._oom_block == 16 and bb._feature_block() == 16
    assert bb._oom_predict_chunk == 1 << 20
    health = distributed.health_snapshot()
    assert [e["action"] for e in health["degradations"]] \
        == [e["action"] for e in events]
    assert health["last_iteration"] == 2
    X, _ = _data(n=50, f=F_WIDE)
    assert b.predict(X).shape == (50,)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_degraded_run_is_a_fresh_run_at_its_rung(count):
    """Degraded from iteration 0, every tree grows at the rung's setting:
    the trees are bitwise a fresh run configured there
    (``histogram_pool_size`` giving the same width)."""
    assert RUNG1 == 21
    deg = _fit({**WIDE, "fault_oom_at_iter": 0, "fault_oom_count": count},
               rounds=3, f=F_WIDE)
    state_mb = deg._boosting._resident_hist_bytes() / 2 ** 20
    pool = state_mb / 4 if count == 1 else 0.01
    fresh = _fit({**WIDE, "histogram_pool_size": pool}, rounds=3,
                 f=F_WIDE)
    assert fresh._boosting._feature_block() \
        == deg._boosting._feature_block() == (RUNG1 if count == 1 else 16)
    assert _trees(deg.model_to_string()) == _trees(fresh.model_to_string())


def test_real_out_of_memory_takes_rung_1(monkeypatch):
    """A torch.cuda.OutOfMemoryError from the resident growth engages
    rung 1, and the run finishes as a fresh run at that width."""
    real = tgbdt.grow_tree
    raised = []

    def tight(*args, **kw):
        if kw.get("feature_block", 0) == 0:
            raised.append(1)
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 1.56 GiB")
        return real(*args, **kw)

    monkeypatch.setattr(tgbdt, "grow_tree", tight)
    deg = _fit(WIDE, rounds=3, f=F_WIDE)
    monkeypatch.setattr(tgbdt, "grow_tree", real)
    assert raised == [1] and deg._boosting._oom_level == 1
    assert deg._boosting._feature_block() == RUNG1
    fresh = _fit({**WIDE, "histogram_pool_size":
                  deg._boosting._resident_hist_bytes() / 2 ** 22},
                 rounds=3, f=F_WIDE)
    assert _trees(deg.model_to_string()) == _trees(fresh.model_to_string())


def test_oom_ladder_exhausted_reraises():
    with pytest.raises(faults.SimulatedResourceExhausted):
        _fit({"fault_oom_at_iter": 1, "fault_oom_count": 4}, rounds=3)


def test_oom_fallback_gate_off_reraises():
    with pytest.raises(faults.SimulatedResourceExhausted):
        _fit({"fault_oom_at_iter": 0, "hist_oom_fallback": False}, rounds=2)


def test_refused_configuration_reraises_with_the_reason(caplog):
    logger = logging.getLogger("lgbm_torch_test_ladder")
    tlog.register_logger(logger)
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            with pytest.raises(faults.SimulatedResourceExhausted):
                _fit({"fault_oom_at_iter": 1, "cegb_tradeoff": 0.5,
                      "cegb_penalty_split": 0.1, "verbosity": 0}, rounds=3)
        assert any("refuses (CEGB); re-raising" in r.message
                   for r in caplog.records)
    finally:
        tlog._logger = None


def test_oom_classifier_matches_allocation_failures_only():
    assert faults.is_resource_exhausted(
        torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert faults.is_resource_exhausted(
        faults.SimulatedResourceExhausted("x"))
    assert faults.is_resource_exhausted(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating"))
    assert not faults.is_resource_exhausted(ValueError("shape mismatch"))
    assert not faults.is_resource_exhausted(
        RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not faults.is_resource_exhausted(MemoryError())


def test_degraded_state_rides_a_checkpoint(tmp_path):
    """Checkpoints written after the rungs carry them; a run resumed from
    one (no fault armed) keeps the degraded width and ends with the
    degraded run's trees."""
    ckdir = str(tmp_path / "ck")
    params = {"fault_oom_at_iter": 1, "fault_oom_count": 2, **WIDE}
    full = _fit(params, rounds=3, f=F_WIDE)
    _fit(params, rounds=2, f=F_WIDE,
         callbacks=[lt.checkpoint_callback(ckdir, period=1)])
    ck = tckpt.CheckpointManager(ckdir).load_latest_valid()
    assert ck.state["boosting"]["oom_degrade"] == {
        "level": 2, "block": 16, "predict_chunk": 0}
    assert [e["level"] for e in ck.manifest["health"]["degradations"]] \
        == [1, 2]
    resumed = _fit(WIDE, rounds=3, f=F_WIDE, resume_from=ckdir)
    assert resumed._boosting._oom_level == 2
    assert _trees(resumed.model_to_string()) == _trees(full.model_to_string())
    assert _fit({}, rounds=1)._boosting.get_trainer_state()[
        "oom_degrade"] is None


def test_predict_rung_halves_the_chunk_and_keeps_the_bits():
    X, _ = _data(n=40000)
    clean = _fit({}, rounds=3)
    want = clean.predict(X)
    b = _fit({"fault_oom_at_predict": 2, "predict_chunk_rows": 65536},
             rounds=3)
    got = b.predict(X)
    np.testing.assert_array_equal(got, want)
    assert b._boosting._oom_predict_chunk == 16384
    events = distributed.degradations()
    assert [e["action"] for e in events] == [
        "predict_chunk_rows -> 32768", "predict_chunk_rows -> 16384"]
    assert all(e["kind"] == "oom_predict" for e in events)
    eng = b._boosting._predict_engine()
    assert eng.chunk_rows == 16384
    # the training rungs are untouched: the next training OOM takes rung 1
    bb = b._boosting
    assert bb._oom_level == 0
    exc = faults.SimulatedResourceExhausted("RESOURCE_EXHAUSTED: sim")
    assert bb._maybe_degrade_oom(exc, len(bb.trees))
    assert bb._oom_level == 1 and bb._oom_block > 0
    state = bb.get_trainer_state()["oom_degrade"]
    assert state["predict_chunk"] == 16384 and state["level"] == 1
    # the floor: no rung below 16k rows
    assert faults.next_predict_chunk(exc, 1 << 14) is None
    assert faults.next_predict_chunk(ValueError("x"), 1 << 20) is None
