"""The PyTorch port's ``train`` and ``cv`` against the JAX package, on the
CPU: custom objectives and metrics, continued training and
cross-validation.

On the same data and parameters (at most 3,000 rows, 15 leaves, 6 rounds):

- ``fobj`` (numpy gradients of binary logloss, and of softmax over 3
  classes, which arrive row-major [N, K]) with ``feval``: model text
  bitwise the JAX package's, the evaluations within 1e-12;
- ``init_model`` from a Booster and from a model file: model text (its
  first tree blocks the init model's, byte for byte), predictions and the
  tree and iteration counts equal; the refusal of a Dataset whose raw
  data was freed carries the JAX message;
- ``cv``: the fold indices equal (stratified, shuffled, plain, and an
  sklearn ``GroupKFold`` over query groups), every fold's booster's model
  text bitwise, the mean/stdv curves within 1e-12 (early stopping,
  ``eval_train_metric``, ``fpreproc``, a custom objective, CSR input);
- ``train`` and ``cv`` take every keyword the JAX package's take, and
  ``resume_from`` resumes a checkpoint written by a ``fobj`` run to the
  JAX package's uninterrupted text.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import engine as jengine
from lightgbm_tpu_torch import engine as tengine

torch.set_num_threads(1)

N, NV = 2500, 500
RTOL = 1e-12        # test_metrics_match's bar for these metrics


def _data(seed=0, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, 6).astype(np.float32)
    X[rng.rand(N + NV) < 0.05, 2] = np.nan
    z = X[:, 0] + X[:, 1] * X[:, 3] + 0.4 * rng.randn(N + NV)
    y = (np.digitize(z, [-0.6, 0.6]) if classes == 3 else z > 0)
    return X, y.astype(np.float64)


def _params(lib, **extra):
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1},
             **extra)
    if lib is lt:
        p["device_type"] = "cpu"
    return p


def _sets(lib, X, y, free=True):
    ds = lib.Dataset(X[:N], label=y[:N], free_raw_data=free,
                     params={"device_type": "cpu"} if lib is lt else None)
    vs = lib.Dataset(X[N:], label=y[N:], reference=ds, free_raw_data=free)
    return ds, vs


def _same_evals(et, ej):
    assert list(et) == list(ej)
    for name in ej:
        assert list(et[name]) == list(ej[name])
        for metric in ej[name]:
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       rtol=RTOL)


# ---------------------------------------------------------- fobj / feval
def _fobj_binary(score, ds):
    p = 1.0 / (1.0 + np.exp(-score))
    return p - ds.get_label(), p * (1.0 - p)


def _fobj_softmax(score, ds):
    assert score.ndim == 2 and score.shape[1] == 3     # row-major [N, K]
    e = np.exp(score - score.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(3)[ds.get_label().astype(int)]
    return p - onehot, 2.0 * p * (1.0 - p)


def _feval_error(score, ds):
    y = ds.get_label()
    if score.ndim == 2:
        return [("merror", float(np.mean(score.argmax(1) != y)), False),
                ("top_score", float(score.max()), True)]
    return "err", float(np.mean((score > 0) != (y > 0))), False


@pytest.mark.parametrize("classes", [2, 3])
def test_fobj_with_feval_matches(classes):
    X, y = _data(1, classes)
    fobj = _fobj_softmax if classes == 3 else _fobj_binary
    out = []
    for lib in (lj, lt):
        p = _params(lib, metric="None")
        if classes == 3:
            p["num_class"] = 3
        ds, vs = _sets(lib, X, y)
        evals = {}
        b = lib.train(p, ds, 5, valid_sets=[vs], valid_names=["v"],
                      fobj=fobj, feval=_feval_error, evals_result=evals)
        out.append((b, evals))
    (bj, ej), (bt, et) = out
    assert bt.model_to_string() == bj.model_to_string()
    assert "objective=" not in bt.model_to_string().split("feature_names")[0]
    _same_evals(et, ej)
    assert len(next(iter(et["v"].values()))) == 5
    # no built-in objective: predict gives the raw scores
    np.testing.assert_array_equal(bt.predict(X[N:]), bj.predict(X[N:]))


# ----------------------------------------------------------- init_model
def _blocks(text):
    """The tree blocks of a model text, each from its Tree= line."""
    body = text.split("end of trees")[0]
    return ["Tree=" + b for b in body.split("Tree=")[1:]]


@pytest.mark.parametrize("source", ["booster", "file"])
def test_init_model_matches(source, tmp_path):
    X, y = _data(3)
    out = []
    for lib in (lj, lt):
        ds, _ = _sets(lib, X, y)
        first = lib.train(_params(lib), ds, 3)
        init = first
        if source == "file":
            init = str(tmp_path / f"init_{lib.__name__}.txt")
            first.save_model(init)
        ds, vs = _sets(lib, X, y)
        evals = {}
        b = lib.train(_params(lib, metric="auc"), ds, 2, valid_sets=[vs],
                      valid_names=["v"], init_model=init,
                      evals_result=evals)
        out.append((first, b, evals))
    (fj, bj, ej), (ft, bt, et) = out
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    # the continued model opens with the init model's trees, byte for byte
    assert _blocks(text)[:3] == _blocks(ft.model_to_string())
    assert (bt.num_trees(), bt.current_iteration()) == \
        (bj.num_trees(), bj.current_iteration()) == (5, 5)
    np.testing.assert_array_equal(bt.predict(X[N:]), bj.predict(X[N:]))
    np.testing.assert_array_equal(bt.predict(X[N:], num_iteration=2,
                                             start_iteration=2),
                                  bj.predict(X[N:], num_iteration=2,
                                             start_iteration=2))
    np.testing.assert_array_equal(bt.feature_importance("gain"),
                                  bj.feature_importance("gain"))
    _same_evals(et, ej)


def test_init_model_on_freed_raw_data_raises_the_jax_message():
    X, y = _data(4)
    msgs = []
    for lib in (lj, lt):
        ds, _ = _sets(lib, X, y)
        first = lib.train(_params(lib), ds, 2)
        ds, _ = _sets(lib, X, y)
        ds.construct()                  # free_raw_data drops the rows
        with pytest.raises(Exception) as err:
            lib.train(_params(lib), ds, 1, init_model=first)
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0] and "raw data was freed" in msgs[1]


# ------------------------------------------------------------------- cv
def test_cv_fold_indices_match():
    from sklearn.model_selection import GroupKFold
    X, y = _data(5)
    groups = np.full(N // 25, 25)
    for kw in (dict(stratified=True, shuffle=True, seed=3),
               dict(stratified=True, shuffle=False),
               dict(stratified=False, shuffle=True, seed=7),
               dict(stratified=False, shuffle=False)):
        got = []
        for lib in (lj, lt):
            ds = lib.Dataset(X[:N], label=y[:N], free_raw_data=False,
                             params=_params(lib))
            got.append(lib.engine._make_n_folds(
                ds, None, 4, _params(lib), kw.get("seed", 0),
                kw["stratified"], kw["shuffle"]))
        for (tj, sj), (tt, st) in zip(*got):
            np.testing.assert_array_equal(tt, tj)
            np.testing.assert_array_equal(st, sj)
    got = []
    for lib in (lj, lt):
        ds = lib.Dataset(X[:N], label=y[:N], group=groups,
                         free_raw_data=False, params=_params(lib))
        got.append(lib.engine._make_n_folds(ds, GroupKFold(3), 3,
                                            _params(lib), 0, False, False))
    assert len(got[1]) == 3
    for (tj, sj), (tt, st) in zip(*got):
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(st, sj)
        # whole queries on either side
        assert len(np.intersect1d(np.asarray(tt) // 25,
                                  np.asarray(st) // 25)) == 0


def _cv(lib, case):
    X, y = _data(6)
    p = _params(lib, metric=["binary_logloss", "auc"])
    kw = dict(nfold=3, return_cvbooster=True, seed=1)
    if case == "early_stopping":
        kw.update(early_stopping_rounds=1)
        p["learning_rate"] = 0.9
    elif case == "train_metric":
        p["is_provide_training_metric"] = True
        kw.update(eval_train_metric=True, stratified=False)
    elif case == "fpreproc":
        def fpreproc(tr, te, params):
            params["lambda_l2"] = 2.0
            return tr, te, params
        kw.update(fpreproc=fpreproc, shuffle=False)
    elif case == "fobj":
        kw.update(fobj=_fobj_binary, feval=_feval_error)
        p["metric"] = "None"
    data = X[:N]
    if case == "sparse":
        import scipy.sparse as sps
        data = np.nan_to_num(data)
        data[np.random.RandomState(1).rand(N) < 0.9, 4] = 0.0
        data = sps.csr_matrix(data)
    ds = lib.Dataset(data, label=y[:N], free_raw_data=False,
                     params={"device_type": "cpu"} if lib is lt else None)
    res = lib.cv(p, ds, 6, **kw)
    cvb = res.pop("cvbooster")
    return res, cvb


@pytest.mark.parametrize("case", ["early_stopping", "train_metric",
                                  "fpreproc", "fobj", "sparse"])
def test_cv_matches(case):
    (rj, cj), (rt, ct) = _cv(lj, case), _cv(lt, case)
    assert list(rt) == list(rj)
    for key in rj:
        assert len(rt[key]) == len(rj[key])
        np.testing.assert_allclose(rt[key], rj[key], rtol=RTOL, atol=1e-15)
    assert ct.best_iteration == cj.best_iteration
    assert len(ct.boosters) == 3
    for bt, bj in zip(ct.boosters, cj.boosters):
        assert bt.model_to_string() == bj.model_to_string()
    # a method called on the CVBooster runs on every fold
    assert ct.num_trees() == [b.num_trees() for b in ct.boosters]
    if case == "early_stopping":
        assert 0 < ct.best_iteration < 6
        assert all(len(v) == ct.best_iteration for v in rt.values())
    if case == "train_metric":
        assert "training auc-mean" in rt


def test_cv_needs_the_raw_data():
    X, y = _data(7)
    ds = lt.Dataset(X[:N], label=y[:N], params={"device_type": "cpu"})
    with pytest.raises(Exception, match="raw data was freed"):
        lt.cv(_params(lt), ds, 2, nfold=2)


# ------------------------------------------------------------ surface
@pytest.mark.parametrize("name", ["train", "cv"])
def test_entry_points_take_every_jax_keyword(name):
    jsig = inspect.signature(getattr(jengine, name)).parameters
    tsig = inspect.signature(getattr(tengine, name)).parameters
    assert list(tsig) == list(jsig)
    for key, par in jsig.items():
        assert tsig[key].default == par.default or key == "verbose_eval", key


def test_resume_from_continues_a_custom_objective_run(tmp_path):
    """``resume_from`` with ``fobj`` and ``feval``: a run checkpointed at
    round 3 and resumed to 6 ends with the JAX package's uninterrupted
    text."""
    X, y = _data(8)

    def fobj(score, ds):
        p = 1.0 / (1.0 + np.exp(-score))
        lab = np.asarray(ds.get_label())
        return p - lab, p * (1.0 - p)

    def run(lib, rounds, **kw):
        ds, vs = _sets(lib, X, y)
        return lib.train(_params(lib), ds, rounds, valid_sets=[vs],
                         fobj=fobj, **kw)

    full = run(lj, 6).model_to_string()
    ckdir = str(tmp_path / "ck")
    run(lt, 3, callbacks=[lt.checkpoint_callback(ckdir, period=3)])
    resumed = run(lt, 6, resume_from=ckdir)
    assert resumed.model_to_string() == full
    assert resumed.current_iteration() == 6


def test_exports_follow_the_jax_package():
    for name in ("cv", "CVBooster", "early_stopping", "print_evaluation",
                 "log_evaluation", "record_evaluation", "reset_parameter",
                 "EarlyStopException", "checkpoint_callback"):
        assert hasattr(lt, name) and hasattr(lj, name), name
    assert os.path.basename(lt.engine.__file__) == "engine.py"
