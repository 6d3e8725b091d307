"""The port's checkpoints and resume against the JAX package, on the CPU.

- Kill-and-resume, in-process as the JAX package's
  ``test_kill_resume_bit_identical``: 5 rounds with a checkpoint every
  round, then ``resume_from`` to 10. gbdt with mask bagging (the resume
  lands mid-period), gbdt with the subset copy, DART, GOSS and q8: the
  resumed text is byte-equal to the port's uninterrupted text, and that
  text is bitwise the JAX package's. The eval history, early stopping and
  the callback states continue across a resume.
- The mechanics: a corrupt or truncated latest checkpoint falls back to
  the previous one; a truncated state or manifest; retention by validity;
  a params or dataset mismatch is refused with the JAX message; a writer
  killed inside the write leaves a stale ``.tmp`` the next write removes;
  the corruption injection point; the env overrides.
- Across the packages: ``dataset_fingerprint`` equals the JAX package's on
  the same data, and a port checkpoint's ``model.txt`` loads in the JAX
  package and predicts the same.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import checkpoint as jckpt
from lightgbm_tpu_torch import checkpoint as tckpt
from lightgbm_tpu_torch.utils import faults
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

N, F = 400, 10

MODE_PARAMS = {
    "gbdt": {"objective": "regression", "bagging_fraction": 0.6,
             "bagging_freq": 2, "feature_fraction": 0.8},
    # a fraction <= 0.5 takes the subset copy; the resume at 5 lands mid
    # period, so the subset drawn at 4 must be re-derived
    "gbdt_subset": {"objective": "regression", "bagging_fraction": 0.4,
                    "bagging_freq": 2, "feature_fraction": 0.8},
    "dart": {"objective": "regression", "boosting": "dart",
             "drop_rate": 0.5, "skip_drop": 0.3, "bagging_fraction": 0.6,
             "bagging_freq": 2, "feature_fraction": 0.8},
    # learning_rate 0.5 ends GOSS's warm-up after 2 iterations
    "goss": {"objective": "regression", "boosting": "goss",
             "top_rate": 0.3, "other_rate": 0.2, "learning_rate": 0.5,
             "feature_fraction": 0.8},
    "q8": {"objective": "regression", "quantized_grad": True,
           "bagging_fraction": 0.6, "bagging_freq": 2},
}
BASE = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}


def _data(seed=0, binary=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    if binary:
        y = (X[:, 0] + X[:, 1] > 0).astype(np.float64)
    else:
        y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.randn(N)
    return X, y


def _p(lib, params):
    p = dict(params)
    if lib is lt:
        p["device_type"] = "cpu"
    return p


def _train(params, X, y, rounds, lib=lt, **kw):
    p = _p(lib, params)
    ds = lib.Dataset(X, label=y, params=p, free_raw_data=False)
    return lib.train(dict(p), ds, num_boost_round=rounds, **kw)


@pytest.fixture(autouse=True)
def _no_fault_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("LGBM_TPU_FAULT_"):
            monkeypatch.delenv(name)


@pytest.mark.parametrize("mode", sorted(MODE_PARAMS))
def test_kill_resume_bit_identical(mode, tmp_path):
    X, y = _data()
    params = {**BASE, **MODE_PARAMS[mode]}
    full = _train(params, X, y, 10).model_to_string()
    assert full == _train(params, X, y, 10, lib=lj).model_to_string()
    ckdir = str(tmp_path / "ck")
    _train(params, X, y, 5,
           callbacks=[lt.checkpoint_callback(ckdir, period=1)])
    resumed = _train(params, X, y, 10, resume_from=ckdir,
                     callbacks=[lt.checkpoint_callback(ckdir, period=1)])
    assert resumed.model_to_string() == full
    assert resumed.current_iteration() == 10


def test_state_pickle_holds_no_torch_storage(tmp_path):
    """state.pkl is numpy arrays and plain Python: nothing that pins a
    device, so it loads where torch is absent."""
    X, y = _data()
    ckdir = str(tmp_path / "ck")
    _train({**BASE, **MODE_PARAMS["dart"]}, X, y, 2,
           callbacks=[lt.checkpoint_callback(ckdir, period=2)])
    with open(os.path.join(ckdir, "ckpt_00000002", "state.pkl"), "rb") as fh:
        state = pickle.load(fh)
    seen = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            seen.append(v)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif hasattr(v, "__dict__"):
            walk(vars(v))
    walk(state)
    assert not seen
    b = state["boosting"]
    assert isinstance(b["train_score"], np.ndarray)
    assert b["train_score"].dtype == np.float32
    assert b["measured_hm"] is None and b["coll_bytes"] is None
    assert "drop_rng_state" in b["dart"]


def test_resume_restores_eval_history_and_early_stopping(tmp_path):
    X, y = _data(binary=True)
    Xv, yv = _data(seed=5, binary=True)
    params = {**BASE, "objective": "binary", "metric": "binary_logloss"}

    def run(lib, rounds, resume_from=None, ckdir=None):
        p = _p(lib, params)
        ds = lib.Dataset(X, label=y, params=p, free_raw_data=False)
        vs = lib.Dataset(Xv, label=yv, params=p, reference=ds,
                         free_raw_data=False)
        hist = {}
        cbs = [lib.checkpoint_callback(ckdir, period=1)] if ckdir else []
        booster = lib.train(dict(p), ds, num_boost_round=rounds,
                            valid_sets=[vs], valid_names=["v"],
                            early_stopping_rounds=50, evals_result=hist,
                            verbose_eval=False, callbacks=cbs,
                            resume_from=resume_from)
        return booster, hist

    full, full_hist = run(lt, 8)
    jfull, jhist = run(lj, 8)
    ckdir = str(tmp_path / "ck")
    run(lt, 5, ckdir=ckdir)
    resumed, resumed_hist = run(lt, 8, resume_from=ckdir, ckdir=ckdir)
    assert resumed_hist == full_hist
    assert len(resumed_hist["v"]["binary_logloss"]) == 8
    np.testing.assert_allclose(full_hist["v"]["binary_logloss"],
                               jhist["v"]["binary_logloss"], rtol=1e-12)
    assert resumed.best_iteration == full.best_iteration \
        == jfull.best_iteration
    assert resumed.best_score == full.best_score
    assert resumed.model_to_string() == full.model_to_string() \
        == jfull.model_to_string()


def test_callback_states_ride_the_checkpoint(tmp_path):
    """The stateful callbacks' states (keyed by ``ckpt_key``) land in
    state.pkl and come back through ``set_state``."""
    X, y = _data(binary=True)
    Xv, yv = _data(seed=5, binary=True)
    params = _p(lt, {**BASE, "objective": "binary",
                     "metric": "binary_logloss"})
    ckdir = str(tmp_path / "ck")
    ds = lt.Dataset(X, label=y, params=params, free_raw_data=False)
    vs = lt.Dataset(Xv, label=yv, reference=ds, free_raw_data=False)
    es = lt.early_stopping(50, verbose=False)
    hist = {}
    # early stopping raises at the last round before the checkpoint
    # (order 40) runs, as in the JAX package: the newest checkpoint is 4
    lt.train(dict(params), ds, 5, valid_sets=[vs], valid_names=["v"],
             callbacks=[es, lt.record_evaluation(hist),
                        lt.checkpoint_callback(ckdir, period=2)])
    ck = tckpt.CheckpointManager(ckdir).load_latest_valid()
    assert ck.iteration == 4
    cbs = ck.state["callbacks"]
    assert cbs["record_evaluation"] == {"v": {"binary_logloss":
                                              hist["v"]["binary_logloss"][:4]}}
    saved = cbs["early_stopping"]
    assert len(saved["best_score_list"]) == 1 and saved["bigger"] == [False]
    fresh = lt.early_stopping(50, verbose=False)
    fresh.set_state(saved)
    assert fresh.get_state() == saved


def test_corrupt_latest_falls_back_to_previous_valid(tmp_path, caplog):
    X, y = _data()
    params = {**BASE, "objective": "regression", "bagging_fraction": 0.6,
              "bagging_freq": 2}
    full = _train(params, X, y, 10).model_to_string()
    ckdir = str(tmp_path / "ck")
    _train(params, X, y, 6,
           callbacks=[lt.checkpoint_callback(ckdir, period=3)])
    mgr = tckpt.CheckpointManager(ckdir)
    assert [it for it, _ in mgr.checkpoints()] == [3, 6]
    faults.corrupt_file(os.path.join(ckdir, "ckpt_00000006", "model.txt"))
    logger = logging.getLogger("lgbm_torch_test_ckpt")
    tlog.register_logger(logger)
    tlog.set_verbosity(0)
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            assert mgr.load_latest_valid().iteration == 3
        assert any("corrupt or truncated" in r.message
                   for r in caplog.records)
    finally:
        tlog._logger = None
    resumed = _train(params, X, y, 10, resume_from=ckdir,
                     callbacks=[lt.checkpoint_callback(ckdir, period=3)])
    assert resumed.model_to_string() == full


def test_truncated_state_and_manifest_fall_back(tmp_path):
    X, y = _data()
    params = {**BASE, "objective": "regression"}
    ckdir = str(tmp_path / "ck")
    _train(params, X, y, 6,
           callbacks=[lt.checkpoint_callback(ckdir, period=3)])
    faults.corrupt_file(os.path.join(ckdir, "ckpt_00000006", "state.pkl"),
                        truncate=True)
    assert tckpt.CheckpointManager(ckdir).load_latest_valid().iteration == 3
    faults.corrupt_file(os.path.join(ckdir, "ckpt_00000003",
                                     "MANIFEST.json"), truncate=True)
    assert tckpt.CheckpointManager(ckdir).load_latest_valid() is None
    # nothing valid: training starts from scratch (with a warning)
    full = _train(params, X, y, 4).model_to_string()
    assert _train(params, X, y, 4,
                  resume_from=ckdir).model_to_string() == full


def test_resume_rejects_params_and_dataset_mismatch(tmp_path):
    X, y = _data()
    params = {**BASE, "objective": "regression"}
    ckdir = str(tmp_path / "ck")
    _train(params, X, y, 4,
           callbacks=[lt.checkpoint_callback(ckdir, period=2)])
    with pytest.raises(LightGBMError,
                       match="different training parameters") as et:
        _train({**params, "num_leaves": 15}, X, y, 8, resume_from=ckdir)
    X2, y2 = _data(seed=7)
    with pytest.raises(LightGBMError, match="different training dataset"):
        _train(params, X2, y2, 8, resume_from=ckdir)
    # the JAX package's words around the hashes
    jdir = str(tmp_path / "jk")
    _train(params, X, y, 4, lib=lj,
           callbacks=[lj.checkpoint_callback(jdir, period=2)])
    with pytest.raises(Exception) as ej:
        _train({**params, "num_leaves": 15}, X, y, 8, lib=lj,
               resume_from=jdir)

    def words(m):
        return m.split("(params_hash")[0].split(": it was")[1] \
            + m.split(") — ")[1]
    assert words(str(et.value)) == words(str(ej.value))


def test_kill_inside_the_write_leaves_a_stale_tmp(tmp_path, monkeypatch):
    """The writer dies between the payload files and the manifest (the
    fault_kill_in_ckpt_write point, its hard exit replaced by an
    exception so the run stays in-process): only ``ckpt_4.tmp`` exists,
    the latest valid checkpoint is 3, resume is bit-identical and the next
    write removes the stale stage."""

    class Killed(BaseException):
        pass

    def die(context):
        raise Killed(context)

    monkeypatch.setattr(faults, "_hard_exit", die)
    X, y = _data()
    params = {**BASE, **MODE_PARAMS["gbdt"]}
    ckdir = str(tmp_path / "ck")
    with pytest.raises(Killed, match="inside checkpoint write"):
        _train({**params, "fault_kill_in_ckpt_write": 4}, X, y, 10,
               callbacks=[lt.checkpoint_callback(ckdir, period=1)])
    names = os.listdir(ckdir)
    assert "ckpt_00000004" not in names and "ckpt_00000004.tmp" in names
    assert sorted(os.listdir(os.path.join(ckdir, "ckpt_00000004.tmp"))) \
        == ["model.txt", "state.pkl"]
    assert tckpt.CheckpointManager(ckdir).load_latest_valid().iteration == 3
    full = _train(params, X, y, 10).model_to_string()
    resumed = _train(params, X, y, 10, resume_from=ckdir,
                     callbacks=[lt.checkpoint_callback(ckdir, period=1)])
    assert resumed.model_to_string() == full
    assert not [e for e in os.listdir(ckdir) if e.endswith(".tmp")]


def test_kill_at_iter_hook_fires_before_the_iteration(monkeypatch,
                                                      tmp_path):
    """fault_kill_at_iter exits at the start of iteration k: the
    checkpoints of iterations 1..k exist and k + 1 does not."""

    class Killed(BaseException):
        pass

    def die(context):
        raise Killed(context)

    monkeypatch.setattr(faults, "_hard_exit", die)
    X, y = _data()
    ckdir = str(tmp_path / "ck")
    with pytest.raises(Killed, match="at iteration 3"):
        _train({**BASE, "objective": "regression",
                "fault_kill_at_iter": 3}, X, y, 6,
               callbacks=[lt.checkpoint_callback(ckdir, period=1,
                                                 keep=10)])
    assert [it for it, _ in tckpt.CheckpointManager(ckdir).checkpoints()] \
        == [1, 2, 3]


def test_checkpoint_rotation_robustness(tmp_path):
    X, y = _data()
    params = {**BASE, "objective": "regression"}
    ckdir = str(tmp_path / "ck")
    _train(params, X, y, 3,
           callbacks=[lt.checkpoint_callback(ckdir, period=1, keep=10)])
    stale = os.path.join(ckdir, "ckpt_00000009.tmp")
    os.makedirs(stale)
    with open(os.path.join(stale, "model.txt"), "w") as fh:
        fh.write("half a model")
    mgr = tckpt.CheckpointManager(ckdir)
    assert [it for it, _ in mgr.checkpoints()] == [1, 2, 3]
    assert mgr.load_latest_valid().iteration == 3
    for it in (2, 3):
        faults.corrupt_file(
            os.path.join(ckdir, f"ckpt_{it:08d}", "state.pkl"),
            truncate=True)
    mgr = tckpt.CheckpointManager(ckdir, keep=2)
    mgr._prune()
    remaining = [it for it, _ in mgr.checkpoints()]
    assert remaining == [1]
    assert mgr.load_latest_valid().iteration == 1
    _train(params, X, y, 3, resume_from=ckdir,
           callbacks=[lt.checkpoint_callback(ckdir, period=1)])
    assert not [e for e in os.listdir(ckdir) if e.endswith(".tmp")]
    assert [it for it, _ in tckpt.CheckpointManager(ckdir).checkpoints()] \
        == [2, 3]


def test_corrupt_checkpoint_injection_point(tmp_path):
    X, y = _data()
    ckdir = str(tmp_path / "ck")
    _train({**BASE, "objective": "regression",
            "fault_corrupt_checkpoint": True}, X, y, 4,
           callbacks=[lt.checkpoint_callback(ckdir, period=2)])
    assert tckpt.CheckpointManager(ckdir).load_latest_valid() is None


def test_fault_env_overrides_in_both_directions(monkeypatch):
    cfg = lt.Config.from_params({"fault_corrupt_checkpoint": True,
                                 "fault_kill_at_iter": 3,
                                 "device_type": "cpu"})
    assert faults.plan_from(cfg).kill_at_iter == 3
    monkeypatch.setenv("LGBM_TPU_FAULT_CORRUPT_CHECKPOINT", "0")
    monkeypatch.setenv("LGBM_TPU_FAULT_KILL_AT_ITER", "-1")
    assert faults.plan_from(cfg) is None
    monkeypatch.setenv("LGBM_TPU_FAULT_OOM_AT_ITER", "2")
    assert faults.plan_from(None).oom_at_iter == 2


def test_params_hash_ignores_io_knobs_and_keeps_the_device():
    def cfg(**kw):
        return lt.Config.from_params({"num_leaves": 7, "device_type": "cpu",
                                      **kw})
    a = cfg(verbosity=-1)
    assert tckpt.params_hash(a) == tckpt.params_hash(
        cfg(verbosity=2, output_model="elsewhere.txt", snapshot_freq=3,
            check_numerics=True, fault_oom_at_iter=2))
    assert tckpt.params_hash(a) != tckpt.params_hash(cfg(num_leaves=9))
    assert tckpt.params_hash(a) != tckpt.params_hash(
        cfg(monotone_constraints=[1, -1, 0]))
    # a card checkpoint does not resume on the CPU (other sums)
    card = lt.Config(num_leaves=7)
    assert card.device_type == "cuda"
    assert tckpt.params_hash(card) != tckpt.params_hash(cfg())
    assert tckpt._NON_TRAINING_PARAMS == jckpt._NON_TRAINING_PARAMS


def test_dataset_fingerprint_equals_the_jax_packages():
    X, y = _data()
    w = np.random.RandomState(3).rand(N) + 0.5
    for kw in ({}, {"weight": w}):
        td = lt.Dataset(X, label=y, params={"device_type": "cpu"},
                        **kw).construct()
        jd = lj.Dataset(X, label=y, **kw).construct()
        assert tckpt.dataset_fingerprint(td) == jckpt.dataset_fingerprint(jd)
    other = lt.Dataset(X, label=y + 1.0,
                       params={"device_type": "cpu"}).construct()
    assert tckpt.dataset_fingerprint(other) != tckpt.dataset_fingerprint(
        lt.Dataset(X, label=y, params={"device_type": "cpu"}).construct())


def test_checkpoint_model_loads_in_the_jax_package(tmp_path):
    X, y = _data(binary=True)
    ckdir = str(tmp_path / "ck")
    b = _train({**BASE, "objective": "binary", "bagging_fraction": 0.7,
                "bagging_freq": 1}, X, y, 4,
               callbacks=[lt.checkpoint_callback(ckdir, period=4)])
    ck = tckpt.CheckpointManager(ckdir).load_latest_valid()
    assert ck.model_text == b.model_to_string()
    manifest = ck.manifest
    assert manifest["format"] == jckpt.MANIFEST_FORMAT == 1
    assert set(manifest) == {"format", "iteration", "params_hash",
                             "dataset_fingerprint", "files", "health"}
    assert manifest["health"]["last_iteration"] == 3
    jb = lj.Booster(model_file=os.path.join(ck.path, "model.txt"))
    np.testing.assert_array_equal(jb.predict(X), b.predict(X))
    # and the JAX package's own manager validates it
    assert jckpt.CheckpointManager(ckdir).validate(ck.path) == manifest


def test_save_model_is_atomic(tmp_path):
    X, y = _data()
    b = _train({**BASE, "objective": "regression"}, X, y, 2)
    path = str(tmp_path / "m.txt")
    with open(path, "w") as fh:
        fh.write("old")
    b.save_model(path)
    with open(path) as fh:
        assert fh.read() == b.model_to_string()
    assert os.listdir(tmp_path) == ["m.txt"]


def test_sharded_paths_raise_naming_item_15(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        tckpt.repartition_checkpoint(str(tmp_path), 2, str(tmp_path / "x"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        tckpt.load_shard(str(tmp_path), 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        lt.Config.from_params({"checkpoint_shards": False,
                               "device_type": "cpu"})
