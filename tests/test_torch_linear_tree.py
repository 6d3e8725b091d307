"""Linear leaves (``linear_tree``, ``linear_lambda``) of the PyTorch port
against the JAX package.

On the same data and parameters the port's model text is bitwise the JAX
package's (regression with NaNs in the linear features, binary, bagging's
mask path, a valid set), and so is the valid-score cache: the JAX package
scores valid rows on the device with ``_linear_valid_delta``, whose row sum
XLA:CPU contracts into fused multiply-adds (``utils/ordered.py
linear_row_sum`` writes that order out; checked here at 1 to 29 and past
32 columns). Model text round-trips both ways: a JAX-written linear model
loads in the port and predicts what the JAX ``Booster.predict`` does, and
the port's loads in the JAX package. Each refusal of linear_tree raises
with the JAX package's message. A linear model's refit is the JAX
package's, bitwise.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.gbdt import _linear_valid_delta as j_delta
from lightgbm_tpu_torch.models.gbdt import _linear_valid_delta as t_delta

torch.set_num_threads(1)

N, NV = 3000, 500


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, 6).astype(np.float32)
    X[rng.rand(N + NV) < 0.05, 0] = np.nan
    X[rng.rand(N + NV) < 0.05, 2] = np.nan
    x0, x2 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 2])
    yr = (np.where(X[:, 1] > 0, 2 * x0, -x2) + 0.3 * rng.randn(N + NV))
    yb = (x0 + rng.randn(N + NV) > 0).astype(np.float64)
    return X, yr, yb


CASES = {
    "regression_nan": ({"objective": "regression"}, "r"),
    "binary": ({"objective": "binary"}, "b"),
    "bagging": ({"objective": "regression", "bagging_fraction": 0.5,
                 "bagging_freq": 1}, "r"),
}


def _pair(case, seed=0):
    extra, target = CASES[case]
    X, yr, yb = _data(seed)
    y = yr if target == "r" else yb
    params = dict({"num_leaves": 15, "linear_tree": True,
                   "linear_lambda": 0.01, "verbosity": -1}, **extra)
    dj = lj.Dataset(X[:N], label=y[:N], params=dict(params))
    vj = lj.Dataset(X[N:], label=y[N:], reference=dj)
    bj = lj.train(params, dj, 3, valid_sets=[vj], valid_names=["v"])
    pt = dict(params, device_type="cpu")
    dt = lt.Dataset(X[:N], label=y[:N], params=pt)
    vt = lt.Dataset(X[N:], label=y[N:], reference=dt)
    bt = lt.train(pt, dt, 3, valid_sets=[vt], valid_names=["v"])
    return bj, bt, X[N:]


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_model_text_and_valid_scores_match_jax(case):
    """Model text, the valid-score cache and predict bitwise the JAX
    package's, with fitted linear leaves in the text."""
    bj, bt, Xv = _pair(case)
    tj, tt = bj.model_to_string(), bt.model_to_string()
    assert tt == tj
    assert "is_linear=1" in tt and "leaf_coeff=" in tt
    assert any(c for ht in bt._boosting.host_trees[1:]
               for c in ht.leaf_coeff)
    np.testing.assert_array_equal(
        bt._boosting._valid_scores[0].numpy().view(np.uint32),
        np.asarray(bj._boosting._valid_scores[0]).view(np.uint32))
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    if case == "bagging":
        assert bt._boosting._bagging_mode() == "mask"


def test_jax_linear_text_loads_in_port_and_port_text_in_jax():
    """JAX -> port: the loaded model predicts the JAX Booster's values
    (NaN rows included); port -> JAX: the JAX package loads the port's
    text and predicts the port Booster's values."""
    bj, bt, Xv = _pair("regression_nan", seed=1)
    loaded = lt.Booster(model_str=bj.model_to_string())
    np.testing.assert_array_equal(loaded.predict(Xv), bj.predict(Xv))
    assert loaded.model_to_string() == bj.model_to_string()
    back = lj.Booster(model_str=bt.model_to_string())
    np.testing.assert_array_equal(back.predict(Xv), bt.predict(Xv))


@pytest.mark.parametrize("f", [1, 2, 6, 17, 28, 33, 47])
def test_linear_valid_delta_matches_jax(f):
    """The device valid scores of a linear tree on random tables and raw
    rows with NaN and inf: bitwise the JAX package's jitted function."""
    rng = np.random.RandomState(f)
    n, L = 4000, 15
    raw = (rng.randn(n, f) * 10 ** rng.uniform(-2, 2, (n, f))).astype(
        np.float32)
    raw[rng.rand(n, f) < 0.03] = np.nan
    raw[rng.rand(n, f) < 0.01] = np.inf
    W = (rng.randn(L, f) * 10 ** rng.uniform(-3, 1, (L, f))).astype(
        np.float32)
    W[rng.rand(L, f) < 0.5] = 0
    used = (W != 0).astype(np.float32)
    lv, lc = (rng.randn(L).astype(np.float32) for _ in range(2))
    leaf = rng.randint(0, L, n).astype(np.int32)
    ref = np.asarray(j_delta(*(jnp.asarray(a) for a in
                               (leaf, lv, lc, W, used, raw))))
    got = t_delta(torch.from_numpy(leaf).long(),
                  *(torch.from_numpy(a) for a in (lv, lc, W, used, raw)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))


@pytest.mark.parametrize("f", [30, 31, 32])
def test_linear_valid_delta_near_jax_at_30_to_32_columns(f):
    """At 30-32 raw features XLA:CPU's vectorised row sum adds in an order
    the port does not write out (ROADMAP.md Queue 3): the valid scores
    come within any summation order's float32 error of the JAX package's,
    f * 2^-23 of |const| + sum |coeff x| (the finite rows; rows with a
    non-finite linear feature take the leaf value on both sides)."""
    rng = np.random.RandomState(f)
    n, L = 4000, 15
    raw = (rng.randn(n, f) * 10 ** rng.uniform(-2, 2, (n, f))).astype(
        np.float32)
    raw[rng.rand(n, f) < 0.03] = np.nan
    W = (rng.randn(L, f) * 10 ** rng.uniform(-3, 1, (L, f))).astype(
        np.float32)
    used = (W != 0).astype(np.float32)
    lv, lc = (rng.randn(L).astype(np.float32) for _ in range(2))
    leaf = rng.randint(0, L, n).astype(np.int32)
    ref = np.asarray(j_delta(*(jnp.asarray(a) for a in
                               (leaf, lv, lc, W, used, raw))))
    got = t_delta(torch.from_numpy(leaf).long(),
                  *(torch.from_numpy(a) for a in (lv, lc, W, used,
                                                  raw))).numpy()
    mag = np.abs(lc[leaf]).astype(np.float64) + np.abs(
        W[leaf].astype(np.float64) * np.nan_to_num(raw)).sum(1)
    assert np.all(np.abs(got.astype(np.float64) - ref) <= f * 2.0 ** -23
                  * mag)


def _refusal(lib, params, data=None):
    X, yr, _ = _data(2)
    p = dict({"objective": "regression", "linear_tree": True,
              "verbosity": -1}, **params)
    kw = {"params": dict(p)}
    if lib is lt:
        p["device_type"] = kw["params"]["device_type"] = "cpu"
    if data == "no_raw":
        kw["params"].pop("linear_tree")
    ds = lib.Dataset(X[:N] if data != "sparse" else _sparse(X[:N]),
                     label=yr[:N], **kw)
    with pytest.raises(Exception) as err:
        lib.train(p, ds.construct(), 1)
    return str(err.value)


def _sparse(X):
    import scipy.sparse as sps
    return sps.csr_matrix(np.nan_to_num(X))


@pytest.mark.parametrize("params,data", [
    ({"boosting": "dart"}, None),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1}, None),
    ({"objective": "regression_l1"}, None),
    ({}, "no_raw"),
    ({}, "sparse"),
], ids=["dart", "rf", "renewal_objective", "no_raw_data", "sparse_input"])
def test_refusals_carry_the_jax_message(params, data):
    """linear_tree with DART, RF, a leaf-renewal objective, a Dataset that
    kept no raw features, or scipy-sparse input: the port raises with the
    JAX package's message."""
    assert _refusal(lt, params, data) == _refusal(lj, params, data)


def test_refit_of_a_linear_model_raises_naming_item_12a():
    """Linear-leaf refit, once refused naming Queue 1 item 12a, is ported
    with that item: the refitted model (leaf values, consts and
    coefficients blended with a fresh ridge fit on the new rows) is the
    JAX package's, model text and predictions bitwise."""
    X, yr, _ = _data(3)
    p = {"objective": "regression", "linear_tree": True, "verbosity": -1}
    out = []
    for lib in (lj, lt):
        pl = dict(p, device_type="cpu") if lib is lt else dict(p)
        b = lib.train(pl, lib.Dataset(X[:N], label=yr[:N], params=pl), 2)
        r = b.refit(X[N:], yr[N:], decay_rate=0.7)
        out.append((r.model_to_string(), r.predict(X[N:])))
    assert "is_linear=1" in out[1][0]
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])
