"""Training control of the PyTorch port against the JAX package, on the CPU:
the callbacks (early stopping, ``learning_rates``, ``reset_parameter``,
``record_evaluation``) driven through ``train``.

On the same data and parameters (2,000 rows, 15 leaves, at most 8 rounds)
the port's model text is bitwise the JAX package's for early stopping
(with and without ``first_metric_only``), ``learning_rates`` as a list and
as a callable, and ``reset_parameter`` of the split parameters and the
bagging fraction mid-run on gbdt and on DART; ``best_iteration`` is equal,
and ``best_score`` and the ``evals_result`` values agree within the
tolerance ``tests/test_torch_train.py::test_metrics_match`` states for
those metrics (1e-12), with the same keys and lengths. The refusals and
warnings carry the JAX package's messages, the stateful callbacks keep the
checkpoint hooks, and the checkpoint callback writes the JAX package's
checkpoint layout, which a ``learning_rates`` run resumes from bitwise.
"""

import logging
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu_torch.utils import log as tlog

torch.set_num_threads(1)

N, NV, ROUNDS = 2000, 500, 8
RTOL = 1e-12            # test_metrics_match's bar for logloss, l2 and auc


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, 6).astype(np.float32)
    X[rng.rand(N + NV) < 0.05, 3] = np.nan
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.4 * rng.randn(N + NV) > 0)
    return X, y.astype(np.float64)


def _train(lib, params, rounds=ROUNDS, seed=0, **kw):
    """One training of ``lib`` with a valid set; (booster, evals_result)."""
    X, y = _data(seed)
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1},
             **params)
    if lib is lt:
        p["device_type"] = "cpu"
    ds = lib.Dataset(X[:N], label=y[:N])
    vs = lib.Dataset(X[N:], label=y[N:], reference=ds)
    evals = {}
    b = lib.train(p, ds, rounds, valid_sets=[vs], valid_names=["v"],
                  evals_result=evals, **kw)
    return b, evals


def _same_evals(et, ej):
    assert list(et) == list(ej)
    for name in ej:
        assert list(et[name]) == list(ej[name])
        for metric in ej[name]:
            assert len(et[name][metric]) == len(ej[name][metric])
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       rtol=RTOL)


def _same_run(params, **kw):
    bj, ej = _train(lj, params, **kw)
    bt, et = _train(lt, params, **kw)
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.best_iteration == bj.best_iteration
    assert list(bt.best_score) == list(bj.best_score)
    for name in bj.best_score:
        assert list(bt.best_score[name]) == list(bj.best_score[name])
        np.testing.assert_allclose(list(bt.best_score[name].values()),
                                   list(bj.best_score[name].values()),
                                   rtol=RTOL)
    _same_evals(et, ej)
    return bt, et


# the rate jumps after three rounds, so the valid loss turns and stops
RATES = [0.1] * 3 + [1.2] * (ROUNDS - 3)


@pytest.mark.parametrize("first_metric_only", [False, True])
def test_early_stopping_matches(first_metric_only):
    bt, et = _same_run({"metric": ["binary_logloss", "auc"],
                        "first_metric_only": first_metric_only},
                       early_stopping_rounds=1, learning_rates=RATES)
    assert 0 < bt.best_iteration < ROUNDS
    assert len(et["v"]["auc"]) < ROUNDS          # it stopped early


@pytest.mark.parametrize("kind", ["list", "callable"])
def test_learning_rates_match(kind):
    rates = ([0.05 * (i + 1) for i in range(ROUNDS)] if kind == "list"
             else (lambda i: 0.3 / (1 + i)))
    bt, _ = _same_run({"metric": "l2"}, learning_rates=rates)
    assert bt.num_trees() == ROUNDS


def _schedule(lib, name):
    """reset_parameter callbacks: lambda_l2 and min_data_in_leaf from the
    third round on; gbdt also the bagging fraction (mask mode, then the
    subset mode) from the fourth."""
    sched = {"lambda_l2": lambda i: 0.0 if i < 2 else 5.0,
             "min_data_in_leaf": lambda i: 20 if i < 2 else 60}
    if name == "gbdt":
        sched["bagging_fraction"] = lambda i: 0.8 if i < 3 else 0.4
    return [lib.reset_parameter(**sched)]


@pytest.mark.parametrize("name,params", [
    ("gbdt", {"bagging_fraction": 0.8, "bagging_freq": 1}),
    ("dart", {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}),
])
def test_reset_parameter_mid_run_matches(name, params):
    out = {}
    for lib in (lj, lt):
        out[lib] = _train(lib, dict(params, metric="binary_logloss"),
                          rounds=6, callbacks=_schedule(lib, name))
    assert out[lt][0].model_to_string() == out[lj][0].model_to_string()
    _same_evals(out[lt][1], out[lj][1])
    # the schedule reached the trees: a run without it differs
    plain = _train(lt, dict(params, metric="binary_logloss"), rounds=6)[0]
    assert plain.model_to_string() != out[lt][0].model_to_string()
    assert out[lt][0].params["lambda_l2"] == 5.0


def test_evals_result_of_a_non_empty_dict_matches():
    """A caller's dict that already holds results: the port records into
    it exactly as the JAX package does."""
    out = []
    for lib in (lj, lt):
        evals = {"v": {"binary_logloss": [9.0]}, "old": {"x": [1.0]}}
        X, y = _data(1)
        p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
        if lib is lt:
            p["device_type"] = "cpu"
        ds = lib.Dataset(X[:N], label=y[:N])
        vs = lib.Dataset(X[N:], label=y[N:], reference=ds)
        lib.train(p, ds, 3, valid_sets=[vs], valid_names=["v"],
                  evals_result=evals)
        out.append(evals)
    _same_evals(out[1], out[0])
    assert len(out[1]["v"]["binary_logloss"]) == 4


def test_record_evaluation_starts_an_empty_dict():
    _, evals = _train(lt, {"metric": "auc"}, rounds=3)
    assert list(evals) == ["v"] and len(evals["v"]["auc"]) == 3


def _warnings(lib, fn):
    """The warning lines ``fn`` logs through ``lib``'s logger."""
    logger = logging.getLogger(f"capture_{lib.__name__}")
    logger.setLevel(logging.DEBUG)
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno == logging.WARNING:
                seen.append(record.getMessage().split("] ", 2)[-1])
    handler = Keep()
    logger.addHandler(handler)
    mod = jlog if lib is lj else tlog
    old = mod._logger
    mod.register_logger(logger)
    try:
        fn()
    finally:
        mod._logger = old
        logger.removeHandler(handler)
    return seen


def test_dart_early_stopping_warns_as_the_jax_package():
    params = {"boosting": "dart", "metric": "auc", "verbosity": 1}
    got = {lib: _warnings(lib, lambda lib=lib: _train(
        lib, params, rounds=3, early_stopping_rounds=1)) for lib in (lj, lt)}
    assert "Early stopping is not available in dart mode" in got[lt]
    assert [w for w in got[lt] if "dart" in w] == \
        [w for w in got[lj] if "dart" in w]


@pytest.mark.parametrize("case", ["no_valid_set", "list_length"])
def test_refusals_carry_the_jax_message(case):
    msgs = []
    for lib in (lj, lt):
        X, y = _data(2)
        p = {"objective": "binary", "verbosity": -1}
        if lib is lt:
            p["device_type"] = "cpu"
        ds = lib.Dataset(X[:N], label=y[:N])
        with pytest.raises(ValueError) as err:
            if case == "no_valid_set":
                lib.train(p, ds, 3, early_stopping_rounds=2)
            else:
                lib.train(p, ds, 3, learning_rates=[0.1, 0.2])
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0]


def test_callbacks_keep_the_checkpoint_hooks():
    for name in ("record_evaluation", "early_stopping"):
        args = ({},) if name == "record_evaluation" else (2,)
        cj, ct = getattr(lj, name)(*args), getattr(lt, name)(*args)
        assert (ct.order, ct.ckpt_key) == (cj.order, cj.ckpt_key)
        assert ct.get_state() == cj.get_state()
        ct.set_state(ct.get_state())
    rj, rt = lj.reset_parameter(learning_rate=[0.1]), \
        lt.reset_parameter(learning_rate=[0.1])
    assert (rt.before_iteration, rt.order) == (rj.before_iteration, rj.order)
    assert lt.print_evaluation(5).order == lj.print_evaluation(5).order
    assert lt.log_evaluation is lt.print_evaluation


def test_early_stopping_state_round_trips():
    """The early-stopping state after a run restores into a fresh
    callback that then stops where the first would have."""
    cb = lt.early_stopping(2, verbose=False)
    X, y = _data(3)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "device_type": "cpu", "metric": "binary_logloss"}
    ds = lt.Dataset(X[:N], label=y[:N])
    vs = lt.Dataset(X[N:], label=y[N:], reference=ds)
    b = lt.train(p, ds, ROUNDS, valid_sets=[vs], callbacks=[cb],
                 learning_rates=RATES)
    state = cb.get_state()
    again = lt.early_stopping(2, verbose=False)
    again.set_state(state)
    assert again.get_state() == state
    assert state["best_iter"][0] + 1 == b.best_iteration


def test_checkpoint_callback_writes_resumable_checkpoints(tmp_path):
    """The checkpoint callback (order 40, ``ckpt_period``) writes the JAX
    package's layout every ``period`` rounds, and a run under a
    ``learning_rates`` schedule resumed from it ends with the JAX
    package's uninterrupted text and evaluations."""
    from lightgbm_tpu_torch import callback
    cb = callback.checkpoint(str(tmp_path / "x"), period=3)
    assert cb.order == 40 and cb.ckpt_period == 3
    assert lt.checkpoint_callback is callback.checkpoint
    rates = [0.1 + 0.02 * i for i in range(ROUNDS)]
    bj, ej = _train(lj, {}, learning_rates=rates)
    ckdir = str(tmp_path / "ck")
    _train(lt, {}, rounds=ROUNDS, learning_rates=rates,
           callbacks=[lt.checkpoint_callback(ckdir, period=2, keep=3)])
    assert sorted(os.listdir(ckdir)) == ["ckpt_00000004", "ckpt_00000006",
                                         "ckpt_00000008"]
    assert sorted(os.listdir(os.path.join(ckdir, "ckpt_00000008"))) == [
        "MANIFEST.json", "model.txt", "state.pkl"]
    # resume from round 6 (the newest two removed) to the end
    import shutil
    shutil.rmtree(os.path.join(ckdir, "ckpt_00000008"))
    bt, et = _train(lt, {}, learning_rates=rates, resume_from=ckdir)
    assert bt.model_to_string() == bj.model_to_string()
    # the evaluation history came back with the checkpoint
    _same_evals(et, ej)


def test_print_evaluation_logs_as_the_jax_package():
    got = {}
    for lib in (lj, lt):
        logger = logging.getLogger(f"eval_{lib.__name__}")
        logger.setLevel(logging.DEBUG)
        lines = []

        class Keep(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "]\t" in msg:
                    lines.append(msg.split("] ", 2)[-1])
        h = Keep()
        logger.addHandler(h)
        mod = jlog if lib is lj else tlog
        old = mod._logger
        mod.register_logger(logger)
        try:
            _train(lib, {"metric": "auc", "verbosity": 1}, rounds=4,
                   verbose_eval=2)
        finally:
            mod._logger = old
            logger.removeHandler(h)
        got[lib] = lines
    assert len(got[lt]) == 2
    assert got[lt] == got[lj]
