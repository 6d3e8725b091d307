"""The port's scikit-learn estimators and plotting helpers against the JAX
package's, on the CPU.

Each estimator is fitted by both packages on the same numpy rows (made
from a seed) with the same constructor arguments (``device_type="cpu"``
for the port): the boosters' model texts are bitwise equal, and so are
``predict``, ``predict_proba``, the string labels, ``evals_result_``,
the feature importances and ``score``; clones keep their parameters; the
scikit-learn stand-ins read the constructor's parameters as
``get_params`` does. The plotting helpers draw the same bars, lines and
tree graph from the port's Booster as from the JAX package's.
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lj  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402
from lightgbm_tpu_torch import sklearn as tsk  # noqa: E402

sklearn = pytest.importorskip("sklearn")
from sklearn.base import clone  # noqa: E402
from sklearn.datasets import make_classification, make_regression  # noqa: E402

torch.set_num_threads(1)


def _fit_pair(name, X, y, fit_kw=None, **ctor):
    ej = getattr(lj, name)(**ctor).fit(X, y, **(fit_kw or {}))
    et = getattr(lt, name)(device_type="cpu", **ctor).fit(
        X, y, **(fit_kw or {}))
    assert et.booster_.model_to_string() == ej.booster_.model_to_string()
    return ej, et


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_regressor_matches_train_and_jax():
    """LGBMRegressor's booster is bitwise ``train`` with the mapped
    parameters, and the JAX estimator's."""
    X, y = make_regression(n_samples=400, n_features=6, noise=2.0,
                           random_state=3)
    ej, et = _fit_pair("LGBMRegressor", X, y, n_estimators=12,
                       num_leaves=9, reg_lambda=0.5, min_child_samples=7)
    _same(et.predict(X), ej.predict(X))
    assert et.score(X, y) == ej.score(X, y)
    _same(et.feature_importances_, ej.feature_importances_)
    params = {"objective": "regression", "num_leaves": 9, "lambda_l2": 0.5,
              "min_data_in_leaf": 7, "verbosity": -1, "device_type": "cpu"}
    b = lt.train(params, lt.Dataset(X, label=y, params=dict(params)), 12)
    assert b.model_to_string() == et.booster_.model_to_string()
    _same(b.predict(X), et.predict(X))


def test_regressor_early_stopping_and_eval_set():
    X, y = make_regression(n_samples=500, n_features=8, noise=5.0,
                           random_state=1)
    fit_kw = {"eval_set": [(X[:200], y[:200])], "early_stopping_rounds": 3,
              "verbose": False}
    ej, et = _fit_pair("LGBMRegressor", X, y, fit_kw, n_estimators=30,
                       num_leaves=15, learning_rate=0.5)
    assert et.best_iteration_ == ej.best_iteration_
    assert et.evals_result_ == ej.evals_result_
    _same(et.predict(X), ej.predict(X))


@pytest.mark.parametrize("kind", ["binary", "strings", "multiclass",
                                  "balanced"])
def test_classifier(kind):
    if kind == "multiclass":
        X, y = make_classification(n_samples=600, n_features=8,
                                   n_informative=6, n_classes=3,
                                   random_state=2)
    else:
        X, y = make_classification(
            n_samples=400, n_features=6, random_state=1,
            weights=[0.85, 0.15] if kind == "balanced" else None)
    if kind == "strings":
        y = np.where(y > 0, "yes", "no")
    ctor = {"n_estimators": 8, "min_child_samples": 5}
    if kind == "balanced":
        ctor["class_weight"] = "balanced"
    ej, et = _fit_pair("LGBMClassifier", X, y, **ctor)
    assert list(et.classes_) == list(ej.classes_)
    assert et.n_classes_ == ej.n_classes_
    _same(et.predict(X), ej.predict(X))
    _same(et.predict_proba(X), ej.predict_proba(X))
    _same(et.predict(X, raw_score=True), ej.predict(X, raw_score=True))
    _same(et.predict(X, pred_leaf=True), ej.predict(X, pred_leaf=True))


def test_ranker():
    rng = np.random.RandomState(3)
    nq, qsize = 30, 10
    X = rng.normal(size=(nq * qsize, 5))
    rel = X[:, 0] + 0.5 * rng.normal(size=nq * qsize)
    y = np.clip((rel * 2).astype(int) - int(rel.min()), 0, 4).astype(float)
    group = np.full(nq, qsize)
    fit_kw = {"group": group, "eval_set": [(X, y)], "eval_group": [group]}
    ej, et = _fit_pair("LGBMRanker", X, y, fit_kw, n_estimators=6,
                       min_child_samples=3)
    _same(et.predict(X), ej.predict(X))
    assert et.evals_result_ == ej.evals_result_
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(n_estimators=2, device_type="cpu").fit(X, y)


def test_params_clone_and_not_fitted():
    est = lt.LGBMClassifier(n_estimators=12, num_leaves=9, cat_smooth=5.0,
                            device_type="cpu")
    cloned = clone(est)
    assert cloned.n_estimators == 12 and cloned.num_leaves == 9
    assert cloned.get_params()["cat_smooth"] == 5.0
    assert (est._booster_params()
            == lj.LGBMClassifier(n_estimators=12, num_leaves=9,
                                 cat_smooth=5.0,
                                 device_type="cpu")._booster_params())
    from sklearn.exceptions import NotFittedError
    with pytest.raises(NotFittedError):
        lt.LGBMRegressor().predict(np.zeros((2, 3)))


def test_stand_ins_without_sklearn(monkeypatch):
    """A copy of the module loaded with scikit-learn unimportable (as on a
    machine without it) takes the stand-ins; its regressor trains with
    the constructor's parameters: bitwise the sklearn-backed one."""
    import importlib.util
    import sys
    X, y = make_regression(n_samples=300, n_features=5, random_state=4)
    for name in [m for m in sys.modules
                 if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    spec = importlib.util.spec_from_file_location(
        "lightgbm_tpu_torch._sklearn_stand_in", tsk.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert not mod._SKLEARN
    ctor = dict(n_estimators=5, num_leaves=5, reg_alpha=0.5,
                min_child_samples=7, learning_rate=0.3, device_type="cpu")
    a = mod.LGBMRegressor(**ctor).fit(X, y)
    monkeypatch.undo()
    b = lt.LGBMRegressor(**ctor).fit(X, y)
    assert a.get_params() == b.get_params()
    assert a.booster_.model_to_string() == b.booster_.model_to_string()
    _same(a.predict(X), b.predict(X))


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.RandomState(0)
    X = rng.normal(size=(500, 5))
    y = X[:, 0] + 0.5 * X[:, 1]
    out = []
    for lib in (lj, lt):
        params = {"objective": "regression", "num_leaves": 7,
                  "verbosity": -1, "min_data_in_leaf": 5}
        if lib is lt:
            params["device_type"] = "cpu"
        ds = lib.Dataset(X, label=y, params=dict(params),
                         free_raw_data=False)
        vs = lib.Dataset(X, label=y, params=dict(params), reference=ds,
                         free_raw_data=False)
        evals = {}
        b = lib.train(params, ds, 10, valid_sets=[vs], evals_result=evals)
        out.append((b, evals))
    assert out[0][0].model_to_string() == out[1][0].model_to_string()
    return out


def _bars(ax):
    return [(p.get_width(), p.get_height()) for p in ax.patches]


def test_plot_importance(fitted):
    (bj, _), (bt, _) = fitted
    assert _bars(lt.plot_importance(bt)) == _bars(lj.plot_importance(bj))
    ax = lt.plot_importance(bt, importance_type="gain", max_num_features=2)
    assert len(ax.patches) <= 2
    assert [t.get_text() for t in ax.get_yticklabels()] == [
        t.get_text() for t in lj.plot_importance(
            bj, importance_type="gain",
            max_num_features=2).get_yticklabels()]


def test_plot_split_value_histogram(fitted):
    (bj, _), (bt, _) = fitted
    assert _bars(lt.plot_split_value_histogram(bt, 0)) == _bars(
        lj.plot_split_value_histogram(bj, 0))
    with pytest.raises(ValueError):
        lt.plot_split_value_histogram(bt, 4)


def test_plot_metric(fitted):
    (_, ej), (bt, et) = fitted
    ax = lt.plot_metric(et)
    ref = lj.plot_metric(ej)
    assert [list(line.get_ydata()) for line in ax.lines] == [
        list(line.get_ydata()) for line in ref.lines]
    with pytest.raises(TypeError):
        lt.plot_metric(bt)


def test_plot_tree_and_digraph(fitted):
    (bj, _), (bt, _) = fitted
    assert lt.plot_tree(bt) is not None
    try:
        graph = lt.create_tree_digraph(bt, show_info=["internal_count"])
    except ImportError:
        pytest.skip("graphviz unavailable")
    assert graph.source == lj.create_tree_digraph(
        bj, show_info=["internal_count"]).source
    with pytest.raises(IndexError):
        lt.create_tree_digraph(bt, tree_index=999)
