"""The f64 precision mode of the PyTorch port (``gpu_use_dp``) against the
JAX package run with x64 on.

The port's ``gpu_use_dp`` is always the JAX package's float64 mode, so
every JAX side here runs inside ``jax.enable_x64(True)`` (a scope: the rest
of the worker stays float32). On the same binned data and injected
gradients the two must agree bit for bit:

- the float64 planes: the port's CPU plain version (a float64 ``index_add_``
  in row order) against the JAX package's ``histogram_tiles`` with its CPU
  method (``scatter``) at float64, and the kernel's own arithmetic
  (``hist_tile_exact`` at float64) rounded to float32 against its f32 mode;
- the split search on float64 planes (numerical and categorical): every
  ``SplitInfo`` field, the gains cast to float32 as the JAX package casts
  them;
- one tree on the classic path (numerical, categorical, sparse device
  columns, bagging's mask and by-node draws): the tree arrays and leaf ids;
- trainings: model text bitwise, dense binary and regression, categorical,
  sparse columns, bagging (mask and subset), 63 leaves, 3 rounds.

The float64 ``uniform`` draws of x64 are checked against ``jax.random``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.grower import grow_tree as j_grow
from lightgbm_tpu.ops.histogram import histogram_tiles
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.models import grower as tgrower
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.utils.random import fold_in, prng_key, uniform

torch.set_num_threads(1)

N = 3000


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[:, 3] = rng.randint(0, 12, n)
    g = (rng.randn(n) + X[:, 0]).astype(np.float32)
    h = (rng.rand(n) + 0.5).astype(np.float32)
    return X, g, h


@pytest.mark.parametrize("n_slots", [1, 5])
def test_f64_planes_match_jax_f64_scatter(n_slots):
    """Injected full-mantissa stats: the float64 plain planes are the JAX
    package's float64 scatter bit for bit; the kernel's own arithmetic at
    float64, rounded to float32, is its f32 mode bit for bit."""
    rng = np.random.RandomState(n_slots)
    f, b, leaves = 5, 63, 9
    binsT = rng.randint(0, b, (f, N)).astype(np.uint8)
    leaf = rng.randint(0, leaves, N).astype(np.int32)
    stats = np.stack([rng.randn(N), rng.rand(N), np.ones(N)],
                     1).astype(np.float32)
    sel = np.arange(n_slots, dtype=np.int32) * 2
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(sel))
    args = (torch.from_numpy(binsT), torch.from_numpy(leaf),
            torch.from_numpy(stats), chan, n_slots, b, leaves)
    tile = cuda_hist.hist_tile_plain(*args, dtype=torch.float64)
    with jax.enable_x64(True):
        ref = np.asarray(histogram_tiles(
            jnp.asarray(binsT.T), jnp.asarray(stats.astype(np.float64)),
            jnp.asarray(leaf), jnp.asarray(sel), b, method="scatter",
            dtype=jnp.float64))
    assert tile.dtype == torch.float64 and ref.dtype == np.float64
    np.testing.assert_array_equal(tile.numpy().view(np.uint64),
                                  ref.view(np.uint64))
    exact = cuda_hist.hist_tile_exact(*args, dtype=torch.float64)
    exact32 = cuda_hist.hist_tile_exact(*args)
    assert torch.equal(exact.to(torch.float32).view(torch.int32),
                       exact32.view(torch.int32))
    assert float((exact - tile).abs().max()) <= 1e-12 * float(
        tile.abs().max())


def test_f64_request_of_a_fused_form_raises():
    """The fused path's forms have no f64 mode: the wrapper refuses one."""
    binsT = torch.zeros((2, 10), dtype=torch.uint8)
    leaf = torch.zeros(10, dtype=torch.int32)
    chan = cuda_hist.chan_leaf_table(torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="f64 mode"):
        cuda_hist.hist_tile(binsT, leaf, torch.ones((10, 3)), chan, 1, 4, 2,
                            dtype=torch.float64)
    with pytest.raises(ValueError, match="f64 mode"):
        cuda_hist.hist_tile(binsT, leaf, torch.ones((10, 3), dtype=torch.int8),
                            chan, 1, 4, 2, plane=True, dtype=torch.float64)


@pytest.mark.parametrize("with_categorical", [False, True])
def test_find_best_splits_on_f64_planes_matches_jax(with_categorical):
    """The classic search on float64 planes and sums: every SplitInfo field
    bitwise the JAX package's under x64 (sums and outputs float64, gains
    float32)."""
    X, _, _ = _data(3)
    params = {"max_bin": 31, "verbosity": -1, "lambda_l2": 0.5,
              "path_smooth": 1.0, "min_data_in_leaf": 5}
    kw = {"categorical_feature": [3]} if with_categorical else {}
    jds = lj.Dataset(X, params=dict(params), **kw).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu"),
                     **kw).construct()
    rng = np.random.RandomState(5)
    L, F, B = 7, jds.bins.shape[1], jds.max_num_bins
    hist = np.zeros((L, F, B, 3))
    hist[..., 0] = rng.randn(L, F, B) * 3
    hist[..., 1] = rng.rand(L, F, B) * 2 + 0.1
    hist[..., 2] = rng.randint(1, 40, (L, F, B))
    nb = np.asarray(jds.feature_meta.num_bins)
    hist[:, np.arange(B)[None, :] >= nb[:, None]] = 0.0
    sums = hist[:, 0].sum(1)
    out = np.zeros(L)
    depth = np.zeros(L, np.int32)
    fmask = np.ones(F, bool)
    with jax.enable_x64(True):
        jp = jsplit.SplitParams.from_config(lj.Config.from_params(params))
        ji = jsplit.find_best_splits(
            jnp.asarray(hist), *(jnp.asarray(sums[:, s]) for s in range(3)),
            jnp.asarray(out), jnp.asarray(depth), jds.feature_meta, jp,
            jnp.asarray(fmask), with_categorical=with_categorical,
            cat_words=tsplit.cat_words_for(B))
        ji = jax.device_get(ji)
    tp = tsplit.SplitParams.from_config(lt.Config.from_params(
        dict(params, device_type="cpu")))
    ti = tsplit.find_best_splits(
        torch.from_numpy(hist), *(torch.from_numpy(sums[:, s])
                                  for s in range(3)),
        torch.from_numpy(out), torch.from_numpy(depth), tds.feature_meta, tp,
        torch.from_numpy(fmask), with_categorical=with_categorical,
        cat_words=tsplit.cat_words_for(B))
    assert bool(np.isfinite(np.asarray(ji.gain)).any())
    for name in ti._fields:
        a, b = np.asarray(getattr(ji, name)), getattr(ti, name).numpy()
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b.view(f"u{b.itemsize}"),
                                          a.view(f"u{a.itemsize}"),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)


GROW_CASES = {
    "numerical": dict(params={}, kw={}, mask=False),
    "categorical": dict(params={}, kw={"categorical_feature": [3]},
                        mask=False),
    "sparse": dict(params={}, kw={}, mask=False, sparse=True),
    "bagging_mask": dict(params={"min_data_in_leaf": 5}, kw={}, mask=True),
}


@pytest.mark.parametrize("case", sorted(GROW_CASES))
def test_grow_tree_dp_matches_jax(case):
    """One tree on the classic path with float64 histograms from injected
    gradients: the tree arrays (float32, as the JAX package keeps them)
    and the leaf ids bitwise the JAX ``grow_tree(hist_dp=True)``'s."""
    c = GROW_CASES[case]
    X, g, h = _data(7)
    if c.get("sparse"):
        X[np.random.RandomState(8).rand(N) < 0.93, 4] = 0.0
    params = dict(c["params"], max_bin=63, verbosity=-1)
    jds = lj.Dataset(X, params=dict(params), **c["kw"]).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu"),
                     **c["kw"]).construct()
    assert tds.has_sparse_cols == bool(c.get("sparse"))
    mask = ((np.random.RandomState(9).rand(N) < 0.7).astype(np.float32)
            if c["mask"] else np.ones(N, np.float32))
    L = 31
    kw = dict(max_leaves=L, num_bins=jds.max_num_bins,
              with_categorical=tds.has_categorical)
    jkw = dict(kw)
    if jds.has_sparse_cols:
        jkw.update(sp_cols=tuple(int(v) for v in jds.sp_cols),
                   sp_rows=jds.sp_rows,
                   sp_bins=jds.sp_bins, sp_default=jds.sp_default)
    with jax.enable_x64(True):
        jtree, jleaf, _ = j_grow(
            jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.asarray(mask),
            jds.feature_meta,
            jsplit.SplitParams.from_config(lj.Config.from_params(params)),
            jnp.ones(len(jds.used_features), jnp.float32), jds.missing_bin,
            hist_method="scatter", split_fusion=False, hist_dp=True,
            binsT=jds.bins_T, **jkw)
        jtree, jleaf = jax.device_get((jtree, jleaf))
    sp = ((tds.sp_cols, tds.sp_rows, tds.sp_bins, tds.sp_default)
          if tds.has_sparse_cols else None)
    ttree, tleaf, _ = tgrower.grow_tree(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta,
        tsplit.SplitParams.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))),
        tds.missing_bin, split_fusion=False, sp=sp, hist_dp=True,
        sample_mask=torch.from_numpy(mask) if c["mask"] else None, **kw)
    assert int(ttree.num_leaves) > L // 2
    for name in ttree._fields:
        a, b = np.asarray(getattr(jtree, name)), getattr(ttree, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))


def _jax_text(params, X, y, rounds, **kw):
    with jax.enable_x64(True):
        return lj.train(params, lj.Dataset(X, label=y, params=dict(params),
                                           **kw), rounds).model_to_string()


def _port_text(params, X, y, rounds, **kw):
    p = dict(params, device_type="cpu")
    return lt.train(p, lt.Dataset(X, label=y, params=p, **kw),
                    rounds).model_to_string()


TRAIN_CASES = {
    "binary": ({}, {}, False),
    "regression": ({"objective": "regression"}, {}, False),
    "categorical": ({}, {"categorical_feature": [3]}, False),
    "sparse": ({}, {}, True),
    "bagging_mask": ({"bagging_fraction": 0.7, "bagging_freq": 1}, {},
                     False),
    "bagging_subset": ({"bagging_fraction": 0.5, "bagging_freq": 1}, {},
                       False),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_dp_model_text_matches_jax_x64(case):
    """gpu_use_dp end to end, 63 leaves, 3 rounds: model text bitwise the
    JAX package's under x64 (which, with x64 off, would warn and train in
    float32; the port has no such fallback)."""
    extra, kw, sparse = TRAIN_CASES[case]
    X, _, _ = _data(11)
    rng = np.random.RandomState(12)
    if sparse:
        X[rng.rand(N) < 0.93, 4] = 0.0
    y = (np.nan_to_num(X[:, 0]) + (X[:, 3] % 3 == 0) + rng.randn(N)
         > 0.5).astype(np.float32)
    if extra.get("objective") == "regression":
        y = (2 * X[:, 0] + rng.randn(N)).astype(np.float32)
    params = dict({"objective": "binary", "num_leaves": 63,
                   "gpu_use_dp": True, "verbosity": -1}, **extra)
    tt = _port_text(params, X, y, 3, **kw)
    assert tt == _jax_text(params, X, y, 3, **kw)
    assert "[gpu_use_dp: True]" in tt


def test_dp_forces_the_classic_path():
    """The "f64 histograms" fusion reason, as the JAX package gives it."""
    X, _, _ = _data(13, 400)
    y = (X[:, 0] > 0).astype(float)
    p = {"objective": "binary", "gpu_use_dp": True, "verbosity": -1,
         "device_type": "cpu"}
    b = lt.Booster(p, lt.Dataset(X, label=y, params=p))
    assert not b._boosting._split_fusion_on()
    with pytest.raises(ValueError, match="f64 histograms"):
        lt.Booster(dict(p, split_fusion="on"),
                   lt.Dataset(X, label=y, params=p))._boosting \
            ._split_fusion_on()
    with pytest.raises(ValueError, match="exclusive"):
        lt.Booster(dict(p, quantized_grad=True),
                   lt.Dataset(X, label=y, params=p))


@pytest.mark.parametrize("shape", [(1000,), (31, 6), (5, 7, 3)])
def test_uniform_float64_matches_jax_x64(shape):
    """x64's float64 draws (bagging's mask, by-node sampling,
    extra_trees): 64 random bits, the first word high."""
    with jax.enable_x64(True):
        key = jax.random.fold_in(jax.random.PRNGKey(sum(shape)), 3)
        ref = np.asarray(jax.random.uniform(key, shape))
    got = uniform(fold_in(prng_key(sum(shape)), 3), shape,
                  dtype=torch.float64).numpy()
    assert ref.dtype == got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))
