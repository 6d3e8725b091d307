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


# ------------------------------------------------------------------ q8 mode
def _tree_equal(jtree, ttree):
    for name in ttree._fields:
        a = np.asarray(getattr(jtree, name))
        b = getattr(ttree, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_q8_quantization_matches_jax_at_300k_rows():
    """The quantized-gradient mode's int8 stats, scales and root sums at
    300,000 rows, where the hessian channel's int8 sum (~2.0e7) passes
    2^24 and a float32 sum's order decides its bits (XLA's tree order
    matches; the exact sum cast once does not): the scales and the
    int8 stats against the JAX grower's own arithmetic compiled by XLA
    (which turns ``/ 127.0`` into a multiply by its reciprocal), the root
    sums and output against a 2-leaf JAX ``grow_tree``'s root node."""
    from lightgbm_tpu_torch.utils import random as trandom
    n = 300_000
    rng = np.random.RandomState(21)
    X = rng.randn(n, 2).astype(np.float32)
    g = (rng.randn(n) * 0.7 + 0.01).astype(np.float32)
    h = (rng.rand(n) * 0.9 + 0.05).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(6), 2)
    tkey = trandom.fold_in(trandom.prng_key(6), 2)

    @jax.jit
    def jquant(g, h, key):
        stats = jnp.stack([g, h, jnp.ones_like(g)], axis=1)
        sg = jnp.maximum(jnp.max(jnp.abs(stats[:, 0])), 1e-12)
        sh = jnp.maximum(jnp.max(jnp.abs(stats[:, 1])), 1e-12)
        q_scale = jnp.stack([sg / 127.0, sh / 127.0,
                             jnp.float32(1.0)]).astype(jnp.float32)
        u = jax.random.uniform(jax.random.fold_in(key, 0x5138), stats.shape)
        q = jnp.clip(jnp.floor(stats / q_scale[None, :] + u), -127,
                     127).astype(jnp.int8)
        return q, q_scale

    jq, jscale = jax.device_get(jquant(jnp.asarray(g), jnp.asarray(h), jkey))
    params = {"max_bin": 15, "verbosity": -1, "min_data_in_leaf": 20}
    tds = lt.Dataset(X, params=dict(params, device_type="cpu")).construct()
    gr = tgrower.Grower(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta, TSplitParams.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))), tds.missing_bin,
        max_leaves=2, num_bins=tds.max_num_bins, hist_method="plain_q8",
        rng_key=tkey)
    np.testing.assert_array_equal(gr.stats.numpy(), jq)
    np.testing.assert_array_equal(gr.q_scale.numpy().view(np.uint32),
                                  jscale.view(np.uint32))
    assert (jq[:, 2] == 1).all()
    assert int(jq[:, 1].astype(np.int64).sum()) > 2 ** 24

    jds = lj.Dataset(X, params=dict(params)).construct()
    jtree, _, _ = j_grow(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.ones(n, jnp.float32),
        jds.feature_meta,
        JSplitParams.from_config(lj.Config.from_params(dict(params))),
        jnp.ones(jds.bins.shape[1], jnp.float32), jds.missing_bin,
        max_leaves=2, num_bins=jds.max_num_bins, hist_method="onehot_q8",
        rng_key=jkey)
    jtree = jax.device_get(jtree)
    ttree, _, _ = tgrower.grow_tree(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta, TSplitParams.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))), tds.missing_bin,
        max_leaves=2, num_bins=tds.max_num_bins, hist_method="plain_q8",
        rng_key=tkey)
    assert int(jtree.num_leaves) == 2
    for name in ("node_value", "node_weight", "node_count"):
        a = np.asarray(getattr(jtree, name))[0]
        b = getattr(ttree, name).numpy()[0]
        assert np.float32(b).view(np.uint32) == np.float32(a).view(
            np.uint32), name
    np.testing.assert_array_equal(
        gr.root.numpy()[1:].view(np.uint32),
        np.array([jtree.node_weight[0], jtree.node_count[0]],
                 np.float32).view(np.uint32))
    # the order matters here: the exact int64 sum, cast to float32 once,
    # is not the JAX package's root hessian on this data
    exact = np.float32(jq[:, 1].astype(np.int64).sum()) * jscale[1]
    assert np.float32(exact) != np.float32(jtree.node_weight[0])
    _tree_equal(jtree, ttree)


Q8_CASES = {
    "fused": dict(kind=None, split_fusion=True, max_leaves=31,
                  params={}),
    "fused_exact": dict(kind=None, split_fusion=True, max_leaves=15,
                        params={"lambda_l2": 1.0}, exact=True),
    "classic_categorical": dict(kind="categorical", split_fusion=False,
                                max_leaves=31,
                                params={"min_data_per_group": 20}),
    "classic_sparse": dict(kind="sparse", split_fusion=False, max_leaves=31,
                           params={}),
}


@pytest.mark.parametrize("case", sorted(Q8_CASES))
def test_q8_grow_tree_matches_jax(case):
    """One q8 tree (int8 gradients from the tree's key, exact int32 sums)
    against the JAX grow_tree in its onehot_q8 mode, on the fused path and
    on the classic path (categorical features; concentrated columns as
    sparse streams); and the same tree with the compaction ladder off,
    which the exact sums make bitwise equal."""
    from lightgbm_tpu_torch.utils import random as trandom
    c = Q8_CASES[case]
    if c["kind"] is None:
        X, g, h = _data(seed=4)
        cats = []
    else:
        X, cats = _classic_data(c["kind"], seed=5)
        g = (np.random.RandomState(6).randn(N) + np.nan_to_num(X[:, 0])
             ).astype(np.float32)
        h = (np.random.RandomState(7).rand(N) + 0.5).astype(np.float32)
    params = dict(c["params"], max_bin=63, verbosity=-1)
    jds = lj.Dataset(X, params=dict(params), categorical_feature=cats
                     ).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu"),
                     categorical_feature=cats).construct()
    sp_kw, sp = {}, None
    if tds.has_sparse_cols:
        sp_kw = dict(sp_cols=tuple(int(v) for v in jds.sp_cols),
                     sp_rows=jds.sp_rows, sp_bins=jds.sp_bins,
                     sp_default=jds.sp_default)
        sp = (tds.sp_cols, tds.sp_rows, tds.sp_bins, tds.sp_default)
    assert tds.has_sparse_cols == (c["kind"] == "sparse")
    kw = dict(max_leaves=c["max_leaves"], num_bins=jds.max_num_bins,
              exact=c.get("exact", False), split_fusion=c["split_fusion"],
              with_categorical=bool(cats))
    jkey = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    tkey = trandom.fold_in(trandom.prng_key(9), 3)
    f = len(jds.used_features)
    jtree, jleaf, _ = j_grow(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.ones(N, jnp.float32),
        jds.feature_meta,
        JSplitParams.from_config(lj.Config.from_params(dict(params))),
        jnp.ones(f, jnp.float32), jds.missing_bin, hist_method="onehot_q8",
        binsT=jds.bins_T, rng_key=jkey, compaction_ladder=_ladder(),
        **sp_kw, **kw)
    jtree = jax.device_get(jtree)
    tparams = TSplitParams.from_config(lt.Config.from_params(
        dict(params, device_type="cpu")))
    trees = {}
    for ladder in (_ladder(), ()):
        trees[ladder] = tgrower.grow_tree(
            tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
            tds.feature_meta, tparams, tds.missing_bin, sp=sp,
            hist_method="plain_q8", rng_key=tkey, compaction_ladder=ladder,
            **kw)
    ttree, tleaf, streamed = trees[_ladder()]
    assert int(ttree.num_leaves) > c["max_leaves"] // 2
    if cats:
        assert ttree.node_cat.any()
    _tree_equal(jtree, ttree)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    # ladder on = off, and the ladder really took rung passes
    off_tree, off_leaf, off_streamed = trees[()]
    _tree_equal(ttree, off_tree)
    np.testing.assert_array_equal(tleaf.numpy(), off_leaf.numpy())
    assert streamed < off_streamed
