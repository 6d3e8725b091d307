"""Multiclass training and the objectives beyond L2 and binary: the PyTorch
port's ``train`` + ``predict`` + ``model_to_string`` against
``lightgbm_tpu.train`` at the same parameters, on the CPU.

- ``multiclass`` and ``multiclassova`` (3 classes, K trees an iteration,
  scores [N, K]) in f32 and q8, on the fused path and on the classic one (a
  >= 90%-zero column stored as sparse streams): model text bitwise equal
  after 10 rounds, raw predictions bitwise, converted (softmax / per-class
  sigmoid) predictions bitwise, and the valid metrics (multi_logloss,
  multi_error) within 1e-12.
- The regression objectives (parametrised: L1, quantile and MAPE with leaf
  renewal, huber, fair, poisson, gamma, tweedie) and xentropy / xentlambda
  (weighted, through XLA's float32 ``log1p``): model text bitwise.
  The JAX package's fused iteration contracts the gradient multiply-adds
  of tweedie, gamma and weighted xentlambda into fused multiply-adds (its
  fused and unfused texts differ there), so those three are held to its
  unfused iteration (``fused_iteration=False`` on both sides), whose
  operations the port runs; their raw predictions are also held to the
  JAX default (fused) iteration's within a stated relative tolerance.
- Gradients (softmax, one-vs-all, xentlambda) bitwise and every metric
  within 1e-12 of the JAX package's on the same scores.
- A multiclass model's text loads back into a port Booster that predicts
  the same [N, K] and dumps the same text.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu_torch import metrics as tmetrics
from lightgbm_tpu_torch import objectives as tobj
from test_torch_train import _data

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

ROUNDS = 10


def _classes(y, k=3):
    return np.digitize(y, np.quantile(y, np.arange(1, k) / k)).astype(
        np.float64)


def _train_both(params, X, y, Xv=None, yv=None, weight=None):
    params = dict(params, verbosity=-1)
    jres, tres = {}, {}
    jtrain = lj.Dataset(X, label=y, weight=weight)
    ttrain = lt.Dataset(X, label=y, weight=weight)
    jv = [lj.Dataset(Xv, label=yv, reference=jtrain)] if Xv is not None \
        else None
    tv = [lt.Dataset(Xv, label=yv, reference=ttrain)] if Xv is not None \
        else None
    bj = lj.train(dict(params), jtrain, ROUNDS, valid_sets=jv,
                  valid_names=["v"] if jv else None, evals_result=jres)
    bt = lt.train(dict(params, device_type="cpu"), ttrain, ROUNDS,
                  valid_sets=tv, valid_names=["v"] if tv else None,
                  evals_result=tres)
    return bj, bt, jres, tres


@pytest.mark.parametrize("path", ["fused", "classic"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_model_text_bitwise(objective, q8, path):
    X, y = _data(seed=20)
    Xv, yv = _data(seed=21, n=500)
    params = {"objective": objective, "num_class": 3, "num_leaves": 15,
              "max_bin": 63, "quantized_grad": q8,
              "is_enable_sparse": path == "classic",
              "metric": ["multi_logloss", "multi_error"]}
    bj, bt, jres, tres = _train_both(params, X, _classes(y), Xv,
                                     _classes(yv))
    gb = bt._boosting
    assert gb.num_tree_per_iteration == 3 and gb.num_trees == 3 * ROUNDS
    assert gb._split_fusion_on() == (path == "fused")
    assert gb._hist_method == ("plain_q8" if q8 else "plain")
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert "num_tree_per_iteration=3" in text
    raw = bt.predict(Xv, raw_score=True)
    assert raw.shape == (500, 3)
    np.testing.assert_array_equal(raw, bj.predict(Xv, raw_score=True))
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)


OBJECTIVES = {
    "regression_l1": {}, "quantile": {"alpha": 0.7}, "mape": {},
    "huber": {"alpha": 0.6}, "fair": {"fair_c": 0.5}, "poisson": {},
    "gamma": {"fused_iteration": False},
    "tweedie": {"tweedie_variance_power": 1.3, "fused_iteration": False},
    "regression_sqrt": {"objective": "regression", "reg_sqrt": True},
}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_regression_objectives_model_text_bitwise(name):
    X, y = _data(seed=22)
    Xv, yv = _data(seed=23, n=400)
    if name in ("poisson", "gamma", "tweedie"):
        y, yv = np.abs(y) + 0.1, np.abs(yv) + 0.1
    params = dict({"objective": name, "num_leaves": 15, "max_bin": 63},
                  **OBJECTIVES[name])
    bj, bt, jres, tres = _train_both(params, X, y, Xv, yv)
    assert bt.model_to_string() == bj.model_to_string()
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)


@pytest.mark.parametrize("objective,weighted", [
    ("cross_entropy", False), ("cross_entropy_lambda", False),
    ("cross_entropy_lambda", True)])
def test_xentropy_model_text_bitwise(objective, weighted):
    X, y = _data(seed=24)
    Xv, yv = _data(seed=25, n=400)
    # probabilities in [0, 1], the cross-entropy objectives' labels
    p, pv = 1 / (1 + np.exp(-y)), 1 / (1 + np.exp(-yv))
    w = np.random.RandomState(26).rand(len(y)) + 0.5 if weighted else None
    # weighted xentlambda: the unfused iteration (module docstring)
    bj, bt, jres, tres = _train_both(
        {"objective": objective, "num_leaves": 15, "max_bin": 63,
         "metric": ["cross_entropy", "kullback_leibler"],
         "fused_iteration": not weighted}, X, p, Xv, pv, w)
    assert bt.model_to_string() == bj.model_to_string()
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)


# The JAX package's default (fused) iteration contracts the gradient
# multiply-adds of these objectives into FMAs, so its leaves differ from the
# port's in the last bits from the first tree on; the gap compounds through
# the scores. Weighted xentlambda on this data diverges at its fifth
# iteration in both packages (raw scores near 300, predictions inf), so it
# is held over the four rounds before that.
FMA_GAP = {  # name: (params, rounds, tolerance relative to max |raw score|)
    "gamma": ({"objective": "gamma"}, ROUNDS, 2e-6),
    "tweedie": ({"objective": "tweedie", "tweedie_variance_power": 1.3},
                ROUNDS, 2e-6),
    "xentlambda_weighted": ({"objective": "cross_entropy_lambda"}, 4, 5e-5),
}


@pytest.mark.parametrize("name", sorted(FMA_GAP))
def test_fma_objectives_near_jax_fused_iteration(name):
    params, rounds, tol = FMA_GAP[name]
    params = dict(params, num_leaves=15, max_bin=63, verbosity=-1)
    if name == "xentlambda_weighted":
        X, y = _data(seed=24)
        Xv, _ = _data(seed=25, n=400)
        y = 1 / (1 + np.exp(-y))
        w = np.random.RandomState(26).rand(len(y)) + 0.5
    else:
        X, y = _data(seed=22)
        Xv, _ = _data(seed=23, n=400)
        y, w = np.abs(y) + 0.1, None
    bj = lj.train(dict(params), lj.Dataset(X, label=y, weight=w), rounds)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), rounds)
    raw, ref = bt.predict(Xv, raw_score=True), bj.predict(Xv, raw_score=True)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(
        raw, ref, rtol=0, atol=tol * np.abs(ref).max(),
        err_msg="beyond the JAX fused iteration's FMA-contracted gradients")


def _objective_pair(name, **params):
    cj = lj.Config.from_params(dict(params, objective=name))
    ct = lt.Config.from_params(dict(params, objective=name,
                                    device_type="cpu"))
    return jobj.create_objective(cj), tobj.create_objective(ct)


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("name,params,label", [
    ("multiclass", {"num_class": 4}, "classes"),
    ("multiclassova", {"num_class": 4, "sigmoid": 1.5}, "classes"),
    ("cross_entropy_lambda", {}, "prob"),
    ("tweedie", {"tweedie_variance_power": 1.6}, "positive"),
    ("huber", {"alpha": 0.3}, "real"),
    ("fair", {"fair_c": 2.0}, "real")])
@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_match(name, params, label, weighted):
    rng = np.random.RandomState(27)
    n, k = 4000, params.get("num_class", 1)
    score = (rng.randn(n, k) * 3).astype(np.float32)
    if k == 1:
        score = score[:, 0]
    y = {"classes": rng.randint(0, k, n).astype(np.float64),
         "prob": rng.rand(n), "positive": rng.exponential(2.0, n),
         "real": rng.randn(n) * 2}[label]
    w = rng.rand(n) + 0.5 if weighted else None
    oj, ot = _objective_pair(name, **params)
    oj.init(y, w)
    ot.init(y, w)
    for a, b in zip(oj.get_grad_hess(jnp.asarray(score)),
                    ot.get_grad_hess(torch.from_numpy(score))):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
    for c in range(k):
        assert ot.boost_from_score(c) == oj.boost_from_score(c)
    # conversions take float32 raw scores (an identity returns them)
    np.testing.assert_array_equal(
        _bits(np.asarray(ot.convert_output(score.astype(np.float64)),
                         np.float32)),
        _bits(oj.convert_output(jnp.asarray(score))))


@pytest.mark.parametrize("name,objective,params", [
    ("multi_logloss", "multiclass", {}),
    ("multi_error", "multiclass", {}),
    ("multi_error", "multiclass", {"multi_error_top_k": 2}),
    ("auc_mu", None, {}),
    ("auc_mu", None, {"auc_mu_weights": [0, 1, 2, 1, 0, 1, 3, 1, 0]}),
    ("l1", None, {}), ("quantile", None, {"alpha": 0.3}),
    ("huber", None, {}), ("fair", None, {}), ("mape", None, {}),
    ("poisson", "poisson", {}), ("gamma", "gamma", {}),
    ("gamma_deviance", "gamma", {}), ("tweedie", "tweedie", {}),
    ("binary_error", "binary", {}), ("average_precision", None, {}),
    ("cross_entropy", "cross_entropy", {}),
    ("cross_entropy_lambda", None, {}),
    ("kullback_leibler", "cross_entropy", {})])
def test_metrics_match(name, objective, params):
    rng = np.random.RandomState(28)
    n = 3000
    multi = name in ("multi_logloss", "multi_error", "auc_mu")
    if multi:
        score = (rng.randn(n, 3) * 2).astype(np.float32).astype(np.float64)
        label = rng.randint(0, 3, n).astype(np.float64)
    else:
        score = (rng.randn(n) * 2).astype(np.float32).astype(np.float64)
        score[:50] = score[50:100]                   # tied scores
        label = (rng.rand(n) < 0.4).astype(np.float64)
        if name in ("l1", "quantile", "huber", "fair", "mape"):
            label = rng.randn(n) * 2
        elif name in ("poisson", "gamma", "gamma_deviance", "tweedie"):
            label = rng.exponential(2.0, n) + 0.01
        elif name in ("cross_entropy", "cross_entropy_lambda",
                      "kullback_leibler"):
            label = rng.rand(n)
    cfg = dict(params, num_class=3) if multi else dict(params)
    jm = jmetrics.create_metric(name, lj.Config.from_params(dict(cfg)))
    tm = tmetrics.create_metric(name, lt.Config.from_params(
        dict(cfg, device_type="cpu")))
    jo = to = None
    if objective:
        jo, to = _objective_pair(objective,
                                 **({"num_class": 3} if multi else {}))
        jo.init(label, None)
        to.init(label, None)
    for weight in (None, rng.rand(n) + 0.1):
        jm.init(label, weight)
        tm.init(label, weight)
        np.testing.assert_allclose(tm.eval(score, to), jm.eval(score, jo),
                                   rtol=1e-12)


def test_multiclass_model_text_loads_back():
    X, y = _data(seed=29)
    bt = lt.train({"objective": "multiclass", "num_class": 3,
                   "num_leaves": 15, "max_bin": 63, "verbosity": -1,
                   "device_type": "cpu"}, lt.Dataset(X, label=_classes(y)),
                  ROUNDS)
    text = bt.model_to_string()
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    Xt, _ = _data(seed=30, n=600)
    np.testing.assert_allclose(loaded.predict(Xt, raw_score=True),
                               bt.predict(Xt, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(loaded.predict(Xt), bt.predict(Xt), rtol=0,
                               atol=1e-6)
    assert loaded.predict(Xt).shape == (600, 3)
    assert loaded.model_to_string() == text
    assert loaded.num_trees() == 3 * ROUNDS
    assert loaded.current_iteration() == ROUNDS
    # an iteration window cuts whole iterations of K trees
    two = bt.model_to_string(num_iteration=2)
    assert two.count("Tree=") == 6


def test_fair_model_text_loads_back_its_fair_c():
    # the dump writes fair's parameter as `fair c:0.5`
    X, y = _data(seed=31)
    bt = lt.train({"objective": "fair", "fair_c": 0.5, "num_leaves": 15,
                   "max_bin": 63, "verbosity": -1, "device_type": "cpu"},
                  lt.Dataset(X, label=y), 3)
    text = bt.model_to_string()
    assert "objective=fair c:0.5\n" in text
    loaded = lt.Booster(model_str=text, params={"device_type": "cpu"})
    assert loaded._boosting.config.fair_c == 0.5
    assert loaded.model_to_string() == text
