"""scipy-sparse input, Exclusive Feature Bundling and pandas categoricals in
the PyTorch port, against the JAX package on the CPU. Bitwise:

- the port's own ``fast_feature_bundling`` gives the JAX package's bundles
  on random sparse inputs (conflicts, the 256-bin cap, both greedy
  orders);
- CSR, CSC and COO input construct the same bins, bundles and segment
  tables as the JAX package, without densifying;
- model text, evaluation results and predictions of a bundled run and of
  an unbundled one (``enable_bundle=False``), f32 and q8, with a
  validation set on the bundled reference (sparse and dense rows);
- ``score_dataset`` on a sparse-stored training set and on a bundled
  validation set, against the JAX package's;
- the exact-tie case: a bundle's tie goes to the lower original feature,
  as the unbundled run's does;
- a DataFrame with ``category`` columns: the same model text (its
  ``pandas_categorical:`` line included), the line read back, and the
  same predictions from the trained and the reloaded model.
"""

import numpy as np
import pytest

import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.bundling import fast_feature_bundling as j_bundling
from lightgbm_tpu_torch.bundling import fast_feature_bundling as t_bundling
from lightgbm_tpu_torch.io.model_text import load_model

sp = pytest.importorskip("scipy.sparse")

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(4))
def test_bundling_matches_jax(seed):
    rng = np.random.RandomState(seed)
    total = 3000
    f = 60
    rows, nbins, ok = [], [], np.ones(f, bool)
    for i in range(f):
        cnt = rng.randint(1, 120)
        start = rng.randint(0, total - cnt)
        # overlapping row ranges make conflicts; some features ineligible
        rows.append(np.arange(start, start + cnt) if rng.rand() < 0.5
                    else np.sort(rng.choice(total, cnt, replace=False)))
        nbins.append(int(rng.choice([3, 16, 64, 200])))
        ok[i] = rng.rand() > 0.15
    rows = [r if o else None for r, o in zip(rows, ok)]
    jb = j_bundling(rows, nbins, ok, total)
    tb = t_bundling(rows, nbins, ok, total)
    assert [tuple(b) for b in tb] == [tuple(b) for b in jb]
    assert len(tb) < f


def _onehotish(seed, n=2000, f=40, dense=3):
    rng = np.random.RandomState(seed)
    X = sp.random(n, f, density=0.04, random_state=rng, format="csr",
                  data_rvs=lambda k: rng.uniform(0.5, 2.0, k)).toarray()
    X = np.hstack([X, rng.randn(n, dense)])
    y = (X[:, :f].sum(1) + 0.3 * X[:, f] + 0.3 * rng.randn(n) > 0.4)
    return X, y.astype(np.float64)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sparse_construct_matches_jax(fmt):
    X, y = _onehotish(0)
    Xs = getattr(sp, f"{fmt}_matrix")(X)
    jd = lj.Dataset(Xs, label=y, params={"verbosity": -1}).construct()
    td = lt.Dataset(Xs, label=y, params={"verbosity": -1,
                                         "device_type": "cpu"}).construct()
    assert td.bundles is not None and len(td.bundles) < len(td.used_features)
    assert [tuple(b) for b in td.bundles] == [tuple(b) for b in jd.bundles]
    np.testing.assert_array_equal(td.used_features, jd.used_features)
    assert td.has_sparse_cols == jd.has_sparse_cols
    np.testing.assert_array_equal(td.binsT.numpy().T, np.asarray(jd.bins))
    for name, arr in zip(jd._bundle_meta._fields, jd._bundle_meta):
        np.testing.assert_array_equal(
            getattr(td.bundle_meta, name).numpy(), np.asarray(arr), name)
    for name in ("_owner_orig", "_thr_fwd", "_thr_rev"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))


RUNS = {
    "bundled": {},
    "bundled_q8": {"quantized_grad": True},
    "unbundled": {"enable_bundle": False},
}


def _train_pair(params, X, y, Xv, yv, rounds=4):
    jt, tt = lj.Dataset(X, label=y), lt.Dataset(X, label=y)
    jv = lj.Dataset(Xv, label=yv, reference=jt)
    tv = lt.Dataset(Xv, label=yv, reference=tt)
    jres, tres = {}, {}
    bj = lj.train(dict(params), jt, rounds, valid_sets=[jv],
                  valid_names=["v"], evals_result=jres)
    bt = lt.train(dict(params, device_type="cpu"), tt, rounds,
                  valid_sets=[tv], valid_names=["v"], evals_result=tres)
    return bj, bt, jres, tres, (jt, jv), (tt, tv)


@pytest.mark.parametrize("valid", ["sparse", "dense"])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_sparse_model_text_bitwise(name, valid):
    X, y = _onehotish(1)
    Xv, yv = _onehotish(2, n=600)
    Xs = sp.csr_matrix(X)
    Xvs = sp.csr_matrix(Xv) if valid == "sparse" else Xv
    params = dict({"objective": "binary", "num_leaves": 15,
                   "min_data_in_leaf": 5, "verbosity": -1,
                   "metric": ["binary_logloss", "auc"]}, **RUNS[name])
    bj, bt, jres, tres, jds, tds = _train_pair(params, Xs, y, Xvs, yv)
    gb = bt._boosting
    assert not gb._split_fusion_on()
    assert not bj._boosting._split_fusion_on(bj._boosting._hist_method())
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert tres == jres
    np.testing.assert_array_equal(bt.predict(Xvs, raw_score=True),
                                  bj.predict(Xvs, raw_score=True))
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    # score_dataset: the sparse-stored train set and the valid set
    for jd, td in zip(jds, tds):
        np.testing.assert_array_equal(gb.score_dataset(td),
                                      bj._boosting.score_dataset(jd))
    assert tds[0].has_sparse_cols
    # the model text is bundle-free: it reloads and predicts the same
    back = lt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_allclose(back.predict(Xv, raw_score=True),
                               bt.predict(Xv, raw_score=True), rtol=1e-12)


def test_score_dataset_reads_the_stream_columns():
    """A sparse-stored set's trees traverse its stream columns rebuilt:
    the scores are the training scores (the JAX package's fix of the
    logloss read off the dense columns alone)."""
    X, y = _onehotish(3)
    Xs = sp.csr_matrix(X)
    ts = lt.Dataset(Xs, label=y, free_raw_data=False)
    bt = lt.train({"objective": "binary", "num_leaves": 15,
                   "verbosity": -1, "device_type": "cpu"}, ts, 5)
    gb = bt._boosting
    assert ts.has_sparse_cols
    np.testing.assert_allclose(gb.score_dataset(ts),
                               gb.train_score.numpy().astype(np.float64),
                               rtol=1e-6)
    np.testing.assert_allclose(gb.score_dataset(ts),
                               bt.predict(Xs, raw_score=True), rtol=1e-6)


def test_bundle_tie_breaks_to_lowest_feature():
    n = 400
    X = np.zeros((n, 3))
    X[:100, 0] = 1.0
    X[100:200, 1] = 1.0
    y = np.zeros(n)
    y[:200] = 1.0
    params = {"objective": "regression", "num_leaves": 4,
              "min_data_in_leaf": 5, "verbosity": -1,
              "boost_from_average": False}
    texts = []
    for enable in (True, False):
        p = dict(params, enable_bundle=enable)
        bt = lt.train(dict(p, device_type="cpu"),
                      lt.Dataset(sp.csr_matrix(X), label=y), 1)
        bj = lj.train(dict(p), lj.Dataset(sp.csr_matrix(X), label=y), 1)
        assert bt.model_to_string() == bj.model_to_string()
        texts.append(bt.model_to_string())
    feats = [[ln for ln in t.split("Tree=")[1].splitlines()
              if ln.startswith("split_feature=")][0] for t in texts]
    assert feats[0] == feats[1] and feats[0].split("=")[1].split()[0] == "0"


def _frame(seed=0, n=2500):
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(seed)
    df = pd.DataFrame({
        "a": rng.randn(n),
        "b": pd.Categorical(rng.choice(["x", "y", "z", "w"], n)),
        "c": rng.randn(n),
        "d": pd.Categorical(rng.choice(list("pqrstu"), n))})
    y = (df["a"].values + 1.0 * (df["b"] == "x").values
         + 0.5 * df["d"].isin(["p", "q"]).values + 0.1 * rng.randn(n))
    return df, y


def test_pandas_categoricals_bitwise():
    df, y = _frame()
    dv, yv = _frame(seed=1, n=500)
    # a category the training set never saw reads NaN
    dv["b"] = dv["b"].cat.add_categories(["v"])
    dv.loc[dv.index[:20], "b"] = "v"
    params = {"objective": "regression", "num_leaves": 15,
              "min_data_in_leaf": 5, "verbosity": -1}
    bj, bt, jres, tres, _, tds = _train_pair(params, df, y, dv, yv)
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert tres == jres
    assert tds[0].has_categorical and not bt._boosting._split_fusion_on()
    assert text.rstrip("\n").splitlines()[-1].startswith(
        'pandas_categorical:{"1": ["w", "x", "y", "z"], "3": ["p"')
    np.testing.assert_array_equal(bt.predict(dv), bj.predict(dv))
    back = load_model(text)
    assert back.meta["pandas_categorical"] == {
        1: ["w", "x", "y", "z"], 3: list("pqrstu")}
    np.testing.assert_array_equal(back.predict(dv), bt.predict(dv))
    again = lt.Booster(model_str=text, params={"device_type": "cpu"})
    assert again.model_to_string() == text
