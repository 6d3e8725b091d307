"""Tree growth of the PyTorch port (lightgbm_tpu_torch/models/grower.py) against
the JAX package's ``grow_tree``.

One tree from injected (full-mantissa) gradients and hessians, on the same
binned data, through the same split path on both sides: the fused path
(``split_fusion`` on, histogram subtraction, the compaction ladder whose
rung passes take the gather form), and the classic path (plane-only tile
passes, subtraction on the resident planes, ``find_best_splits``) on
categorical features, on concentrated columns kept as sparse device
streams, and with ``split_fusion`` off on plain numerical data. The JAX
side runs its CPU histogram method (one flat scatter-add, which the port's
plain ``index_add_`` matches bit for bit), so the tree arrays (categorical
bitsets included), the per-row leaf ids and the rows the histogram passes
read must all be equal. The port keeps its per-leaf state in numpy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.grower import grow_tree as j_grow
from lightgbm_tpu.ops.split import SplitParams as JSplitParams
from lightgbm_tpu_torch.models import grower as tgrower
from lightgbm_tpu_torch.ops.split import SplitParams as TSplitParams

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

N = 3000


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, 6).astype(np.float32)
    X[rng.rand(N) < 0.15, 1] = np.nan              # NaN bin
    X[rng.rand(N) < 0.4, 2] = 0.0                  # zero-heavy
    X[:, 3] = np.round(X[:, 3] * 2)                # few distinct values
    g = (rng.randn(N) + X[:, 0]).astype(np.float32)
    h = (rng.rand(N) + 0.5).astype(np.float32)
    return X, g, h


def _ladder(fracs=(0.5, 0.125)):
    return tuple(sorted({-(-int(round(N * f)) // 64) * 64 for f in fracs}))


CASES = {
    "ladder": dict(max_leaves=31, params={}, ladder=_ladder()),
    "exact": dict(max_leaves=15, params={"min_data_in_leaf": 5},
                  ladder=_ladder(), exact=True),
    "no_subtraction": dict(max_leaves=20, params={"lambda_l2": 1.0},
                           ladder=_ladder(), subtraction=False, max_depth=4,
                           rungs=None),
    "full_passes": dict(max_leaves=31, params={"min_data_in_leaf": 50,
                                               "lambda_l1": 0.2,
                                               "zero_as_missing": True},
                        ladder=()),
}


@pytest.mark.parametrize("is_enable_sparse", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_tree_matches_jax(case, is_enable_sparse, monkeypatch):
    """The fused path; this data has no concentrated column, so sparse
    storage (on by default) leaves every column dense."""
    c = CASES[case]
    X, g, h = _data()
    params = dict(c["params"], max_bin=63, is_enable_sparse=is_enable_sparse,
                  verbosity=-1)
    jds = lj.Dataset(X, params=dict(params)).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu")).construct()
    assert not tds.has_sparse_cols and not jds.has_sparse_cols
    # same mappers -> same bins and feature metadata
    np.testing.assert_array_equal(tds.binsT.numpy(),
                                  np.asarray(jds.bins).T)
    np.testing.assert_array_equal(tds.missing_bin.numpy(),
                                  np.asarray(jds.missing_bin))
    L = c["max_leaves"]
    kw = dict(max_leaves=L, num_bins=jds.max_num_bins,
              max_depth=c.get("max_depth", -1), exact=c.get("exact", False),
              hist_subtraction=c.get("subtraction", True),
              compaction_ladder=c["ladder"])
    jtree, jleaf, jaux = j_grow(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.ones(N, jnp.float32),
        jds.feature_meta,
        JSplitParams.from_config(lj.Config.from_params(dict(params))),
        jnp.ones(jds.bins.shape[1], jnp.float32), jds.missing_bin,
        hist_method="scatter", split_fusion=True, binsT=jds.bins_T, **kw)
    jtree = jax.device_get(jtree)

    forms = []
    real = tgrower.histogram_tiles_with_candidates

    def spy(*a, **k):
        forms.append(a[-1] is not None)
        return real(*a, **k)

    monkeypatch.setattr(tgrower, "histogram_tiles_with_candidates", spy)
    ttree, tleaf, streamed = tgrower.grow_tree(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta,
        TSplitParams.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))),
        tds.missing_bin, **kw)
    assert int(ttree.num_leaves) > L // 2
    for name in ttree._fields:
        a = np.asarray(getattr(jtree, name))
        b = getattr(ttree, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    assert streamed == float(jaux.rows_streamed)
    rungs = c.get("rungs", bool(c["ladder"]))
    if rungs:
        assert any(forms) and not all(forms)   # full AND gather passes
    elif rungs is not None:
        assert not any(forms)


def _classic_data(kind, seed=1):
    """(X, categorical columns) for one classic-path case."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, 6).astype(np.float32)
    X[rng.rand(N) < 0.1, 1] = np.nan
    cats = []
    if kind == "categorical":
        X[:, 2] = rng.randint(0, 6, N)                  # one-hot mode
        X[:, 4] = rng.choice(40, N, p=rng.dirichlet(np.full(40, 0.6)))
        X[rng.rand(N) < 0.03, 4] = np.nan
        cats = [2, 4]
    elif kind == "sparse":
        X[rng.rand(N) < 0.95, 3] = 0.0                  # >= 90% one bin
        X[rng.rand(N) < 0.92, 5] = 0.0
    return X, cats


CLASSIC = {
    "categorical": dict(max_leaves=31, params={"min_data_per_group": 20,
                                               "cat_smooth": 5.0}),
    "sparse": dict(max_leaves=31, params={}),
    "fusion_off": dict(max_leaves=31, params={"lambda_l2": 0.5},
                       exact=False),
    "categorical_exact_depth": dict(max_leaves=20, params={}, exact=True,
                                    max_depth=5, kind="categorical"),
}


@pytest.mark.parametrize("case", sorted(CLASSIC))
def test_classic_grow_tree_matches_jax(case, monkeypatch):
    c = CLASSIC[case]
    kind = c.get("kind", case)
    X, cats = _classic_data(kind)
    g = (np.random.RandomState(2).randn(N) + np.nan_to_num(X[:, 0])
         + (np.nan_to_num(X[:, 4]) % 3 if kind == "categorical"
            else 0)).astype(np.float32)
    h = (np.random.RandomState(3).rand(N) + 0.5).astype(np.float32)
    params = dict(c["params"], max_bin=63, verbosity=-1)
    jds = lj.Dataset(X, params=dict(params), categorical_feature=cats
                     ).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu"),
                     categorical_feature=cats).construct()
    assert tds.has_categorical == bool(cats) == jds.has_categorical
    np.testing.assert_array_equal(tds.binsT.numpy(), np.asarray(jds.bins).T)
    has_sp = kind == "sparse"
    assert tds.has_sparse_cols == has_sp == jds.has_sparse_cols
    sp_kw, sp = {}, None
    if has_sp:
        np.testing.assert_array_equal(tds.sp_cols, jds.sp_cols)
        sp_kw = dict(sp_cols=tuple(int(v) for v in jds.sp_cols),
                     sp_rows=jds.sp_rows, sp_bins=jds.sp_bins,
                     sp_default=jds.sp_default)
        sp = (tds.sp_cols, tds.sp_rows, tds.sp_bins, tds.sp_default)
    L = c["max_leaves"]
    ladder = _ladder()
    kw = dict(max_leaves=L, num_bins=jds.max_num_bins,
              max_depth=c.get("max_depth", -1), exact=c.get("exact", False),
              compaction_ladder=ladder)
    f = len(jds.used_features)
    jtree, jleaf, jaux = j_grow(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.ones(N, jnp.float32),
        jds.feature_meta,
        JSplitParams.from_config(lj.Config.from_params(dict(params))),
        jnp.ones(f, jnp.float32), jds.missing_bin, hist_method="scatter",
        split_fusion=False, with_categorical=bool(cats), binsT=jds.bins_T,
        **sp_kw, **kw)
    jtree = jax.device_get(jtree)

    forms = []
    real = tgrower.histogram_tiles

    def spy(*a, **k):
        forms.append(a[6] is not None)
        return real(*a, **k)

    monkeypatch.setattr(tgrower, "histogram_tiles", spy)
    ttree, tleaf, streamed = tgrower.grow_tree(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta,
        TSplitParams.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))),
        tds.missing_bin, split_fusion=False, with_categorical=bool(cats),
        sp=sp, **kw)
    assert int(ttree.num_leaves) > L // 2
    if cats:
        assert ttree.node_cat.any()
    for name in ttree._fields:
        a = np.asarray(getattr(jtree, name))
        b = getattr(ttree, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    assert streamed == float(jaux.rows_streamed)
    assert any(forms) and not all(forms)       # full AND rung passes
