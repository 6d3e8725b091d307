"""Split epilogue of the PyTorch port (lightgbm_tpu_torch/ops/split.py,
ops/histogram.py ``derive_and_scan``, ops/cuda_hist.py ``split_epilogue_plain``)
against the JAX package.

On identical planes the candidate tables and ``SplitInfo`` must be bitwise
equal to the JAX package's: the port repeats its float32 arithmetic in its
order (the bin-axis cumulative sum in XLA's block order, XLA's ``sign``).
The JAX side runs its XLA twin ``derive_and_scan`` on the same float planes,
and the fused Pallas kernel ``histogram_tiles_pallas_epilogue`` through the
Pallas interpreter on integer-valued stats (whose planes are exact in any
order). Cases cover derived sibling slots, missing types none/zero/nan,
within- and cross-feature ties and the regularisation parameters. The CUDA
``split_epilogue`` is held to ``split_epilogue_plain`` on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops import pallas_hist as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops import histogram as thist
from lightgbm_tpu_torch.ops import split as tsplit

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

B = 16
# per feature: num_bins, missing_type (0 none, 1 zero, 2 nan), default_bin
FEATS = [(16, 0, 0), (10, 2, 0), (12, 1, 4), (16, 2, 3), (2, 0, 0),
         (16, 0, 0)]
SEL = np.array([3, 7, 0, 1, 5, -1], np.int32)
DERIVE = np.array([False, True, False, True, False, False])

PARAM_SETS = {
    "defaults": {},
    "regularised": {"lambda_l1": 0.5, "lambda_l2": 2.0, "max_delta_step": 0.7,
                    "min_gain_to_split": 0.01},
    "smoothed": {"path_smooth": 3.0, "min_data_in_leaf": 5,
                 "min_sum_hessian_in_leaf": 2.5},
}


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.uint32),
                                  np.asarray(b, np.float32).view(np.uint32))


def _fmeta():
    nb = np.array([f[0] for f in FEATS], np.int32)
    mt = np.array([f[1] for f in FEATS], np.int32)
    db = np.array([f[2] for f in FEATS], np.int32)
    return nb, mt, db


def _inputs(seed, n=3000, representable=False):
    """Bins (each feature inside its own bin count, a few bins only, so
    thresholds tie), stats, leaf ids; feature 5 duplicates feature 0 so the
    cross-feature argmax sees exact ties."""
    rng = np.random.RandomState(seed)
    nb, _, _ = _fmeta()
    f = len(FEATS)
    binsT = np.zeros((f, n), np.uint8)
    for j in range(f):
        support = rng.choice(nb[j], size=min(nb[j], 5), replace=False)
        binsT[j] = rng.choice(support, size=n)
    binsT[5] = binsT[0]
    if representable:
        g = rng.randint(-1023, 1024, n) / 1024.0
        h = rng.randint(1, 1024, n) / 1024.0
    else:
        g = rng.randn(n)
        h = rng.rand(n) + 0.1
    stats = np.stack([g, h, np.ones(n)], 1).astype(np.float32)
    leaf = rng.randint(0, 8, n).astype(np.int32)
    return binsT, stats, leaf


def _leaf_aux(planes):
    """Leaf aggregates = the plane sums of feature 0 (every row lands in
    exactly one of its bins); output 0.3 * sum_g as a stand-in."""
    s = planes[:, 0].sum(axis=1)
    return [s[:, 0], s[:, 1], s[:, 2], (0.3 * s[:, 0]).astype(np.float32)]


def _pvec(params):
    c = TConfig.from_params(dict(params, device_type="cpu"))
    return np.array([c.lambda_l1, c.lambda_l2, c.max_delta_step,
                     c.path_smooth, c.min_data_in_leaf,
                     c.min_sum_hessian_in_leaf, c.min_gain_to_split],
                    np.float32)


def _planes(binsT, stats, leaf):
    """[P, F, B, 3] computed planes of SEL (derived slots zero) and the
    parents of the derived slots (computed + derived children)."""
    full = np.asarray(jhist.histogram_scatter(
        jnp.asarray(binsT.T), jnp.asarray(stats), jnp.asarray(leaf), 8, B))
    p = len(SEL)
    tile = np.zeros((p, binsT.shape[0], B, 3), np.float32)
    parent = np.zeros_like(tile)
    for i, l in enumerate(SEL):
        if l < 0:
            continue
        if DERIVE[i]:
            parent[i] = full[SEL[i - 1]] + full[l]
        else:
            tile[i] = full[l]
    return tile, parent


@pytest.mark.parametrize("pname", sorted(PARAM_SETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_derive_and_scan_matches_jax(pname, seed):
    tile, parent = _planes(*_inputs(seed))
    # leaf aux of the FULL planes (derived slots included)
    full_ref = np.where(DERIVE[:, None, None, None],
                        parent - np.concatenate([tile[:1] * 0, tile[:-1]]),
                        tile)
    la = np.stack(_leaf_aux(full_ref) + [np.zeros(len(SEL), np.float32)] * 4,
                  1).astype(np.float32)
    la[:, 4], la[:, 5] = -np.finfo(np.float32).max, np.finfo(np.float32).max
    nb, mt, db = _fmeta()
    fm = np.stack([nb, mt, db, np.zeros_like(nb)] + [np.zeros_like(nb)] * 4,
                  1).astype(np.float32)
    pv = _pvec(PARAM_SETS[pname])
    jfull, jcand = jhist.derive_and_scan(
        jnp.asarray(tile), jnp.asarray(DERIVE), jnp.asarray(parent),
        jnp.asarray(la), jnp.asarray(fm), jnp.asarray(pv))
    tfull, tcand = thist.derive_and_scan(
        torch.from_numpy(tile), torch.from_numpy(DERIVE),
        torch.from_numpy(parent), torch.from_numpy(la), torch.from_numpy(fm),
        torch.from_numpy(np.append(pv, np.float32(0))))
    _bits_equal(tfull.numpy(), jfull)
    _bits_equal(tcand.numpy(), jcand)
    assert np.isfinite(np.asarray(jcand)[..., 0]).any()   # real splits found
    # the epilogue's plain version reads the derived slots off the lane table
    der = cuda_hist._epilogue_lanes(torch.from_numpy(SEL),
                                    torch.from_numpy(DERIVE))
    pfull, pcand = cuda_hist.split_epilogue_plain(
        torch.from_numpy(tile), torch.from_numpy(parent), der,
        torch.from_numpy(la), torch.from_numpy(fm),
        torch.from_numpy(np.append(pv, np.float32(0))))
    _bits_equal(pcand.numpy(), jcand)
    _bits_equal(pfull.numpy(), jfull)

    # cross-feature argmax -> SplitInfo
    jp = jsplit.SplitParams.from_config(
        JConfig.from_params(dict(PARAM_SETS[pname])))
    tp = tsplit.SplitParams.from_config(
        TConfig.from_params(dict(PARAM_SETS[pname], device_type="cpu")))
    f = len(FEATS)
    jmeta = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb), missing_type=jnp.asarray(mt),
        default_bin=jnp.asarray(db), is_categorical=jnp.zeros(f, bool),
        monotone=jnp.zeros(f, jnp.int8), penalty=jnp.ones(f, jnp.float32))
    tmeta = tsplit.FeatureMeta(
        num_bins=torch.from_numpy(nb), missing_type=torch.from_numpy(mt),
        default_bin=torch.from_numpy(db),
        is_categorical=torch.zeros(f, dtype=torch.bool),
        monotone=torch.zeros(f, dtype=torch.int8),
        penalty=torch.ones(f, dtype=torch.float32))
    depth = np.array([0, 1, 2, 3, 2, 1], np.int32)
    fmask = np.ones((len(SEL), f), bool)
    fmask[2, 1] = False
    cols = [la[:, 0], la[:, 1], la[:, 2], la[:, 3], depth]
    jinfo = jsplit.candidates_to_splitinfo(
        jcand, *map(jnp.asarray, cols), jmeta, jp, jnp.asarray(fmask), 3)
    tinfo = tsplit.candidates_to_splitinfo(
        tcand, *map(torch.from_numpy, cols), tmeta, tp,
        torch.from_numpy(fmask), 3)
    for name in tsplit.SplitInfo._fields:
        a, b = np.asarray(getattr(jinfo, name)), getattr(tinfo, name).numpy()
        if a.dtype == np.float32:
            _bits_equal(b, a)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_cross_feature_tie_takes_lowest_index():
    tile, parent = _planes(*_inputs(2))
    la = np.stack(_leaf_aux(tile) + [np.zeros(len(SEL), np.float32)] * 4, 1)
    nb, mt, db = _fmeta()
    cand = tsplit.numerical_candidates(
        torch.from_numpy(tile), *(torch.from_numpy(la[:, i]) for i in range(4)),
        torch.from_numpy(nb), torch.from_numpy(mt), torch.from_numpy(db),
        tsplit.SplitParams.from_config(TConfig.from_params(
            {"device_type": "cpu"})))
    # feature 5 duplicates feature 0: identical candidates
    _bits_equal(cand[:, 5].numpy(), cand[:, 0].numpy())


@pytest.mark.parametrize("gather", [False, True])
def test_fused_kernel_epilogue_matches_port(gather):
    """The whole fused pass: JAX's Pallas epilogue kernel (interpreted) vs
    the port's hist_tile + split_epilogue plain versions."""
    binsT, stats, leaf = _inputs(3, n=1500, representable=True)
    tile, parent = _planes(binsT, stats, leaf)
    del tile
    n = binsT.shape[1]
    idx = None
    if gather:
        keep = np.isin(leaf, SEL[SEL >= 0])
        idx = np.asarray(jhist.compact_indices(jnp.asarray(keep),
                                               int(keep.sum()) + 5))
    full = np.asarray(jhist.histogram_scatter(
        jnp.asarray(binsT.T), jnp.asarray(stats), jnp.asarray(leaf), 8, B))
    selc = np.maximum(SEL, 0)
    la = np.stack(_leaf_aux(full[selc]), 1).astype(np.float32)
    nb, mt, db = _fmeta()
    fm = np.asarray(jph.pack_feature_meta(*map(jnp.asarray, (
        nb, mt, db, np.zeros_like(nb)))))
    pv = _pvec({"lambda_l2": 1.0})
    jla = jph.pack_leaf_aux(*map(jnp.asarray, [la[:, i] for i in range(4)]))
    jt, jc = jph.histogram_tiles_pallas_epilogue(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(SEL), jnp.asarray(DERIVE), jnp.asarray(parent), jla,
        jnp.asarray(fm), jnp.asarray(pv), B, block=512, mode="highest",
        idx=None if idx is None else jnp.asarray(idx), interpret=True)
    tla = cuda_hist.pack_leaf_aux(*(torch.from_numpy(la[:, i])
                                    for i in range(4)))
    tt, tc = thist.histogram_tiles_with_candidates(
        torch.from_numpy(binsT), torch.from_numpy(stats),
        torch.from_numpy(leaf), torch.from_numpy(SEL),
        torch.from_numpy(DERIVE), torch.from_numpy(parent), tla,
        torch.from_numpy(fm), torch.from_numpy(np.append(pv, 0).astype(
            np.float32)), B, 8,
        None if idx is None else torch.from_numpy(idx))
    assert n == binsT.shape[1]
    _bits_equal(tt.numpy(), jt)
    _bits_equal(tc.numpy(), jc)


def test_split_epilogue_wrapper_on_cpu_counts_no_launch():
    tile, parent = _planes(*_inputs(4))
    la = cuda_hist.pack_leaf_aux(*(torch.from_numpy(v) for v in
                                   _leaf_aux(tile)))
    nb, mt, db = _fmeta()
    fm = cuda_hist.pack_feature_meta(*(torch.from_numpy(v) for v in
                                       (nb, mt, db, np.zeros_like(nb))))
    der = cuda_hist._epilogue_lanes(torch.from_numpy(SEL),
                                    torch.from_numpy(DERIVE))
    pv = torch.from_numpy(np.append(_pvec({}), 0).astype(np.float32))
    cuda_hist.reset_launch_counts()
    args = (torch.from_numpy(tile), torch.from_numpy(parent), der, la, fm,
            pv)
    full, cand = cuda_hist.split_epilogue(*args)
    pfull, pcand = cuda_hist.split_epilogue_plain(*args)
    _bits_equal(cand.numpy(), pcand.numpy())
    _bits_equal(full.numpy(), pfull.numpy())
    assert cuda_hist.split_epilogue.launches == 0


# ---------------------------------------------------------------- classic
# the classic search over resident [L, F, B, 3] planes, numerical and
# categorical: per feature (num_bins, missing_type, default_bin, categorical)
CB = 20
CFEATS = [(20, 0, 0, False), (4, 2, 0, True), (20, 2, 0, True),
          (12, 0, 0, True), (14, 2, 0, False), (9, 0, 0, True)]
CAT_PARAMS = {
    "defaults": {},
    "small_groups": {"min_data_per_group": 5, "cat_smooth": 1.0,
                     "max_cat_threshold": 3, "min_data_in_leaf": 3},
    "all_onehot": {"max_cat_to_onehot": 32, "cat_l2": 1.0},
    "smoothed": {"path_smooth": 2.0, "lambda_l1": 0.5, "cat_smooth": 3.0,
                 "min_data_per_group": 20, "lambda_l2": 1.0},
}


def _classic_inputs(seed, n=6000, leaves=6):
    """Planes of ``leaves`` leaves over CFEATS: skewed categories (rare
    bins fall under cat_smooth), feature 3's bins 1..6 given identical
    sums (ties in g / (h + cat_smooth)), feature 5 a copy of feature 3
    (cross-feature ties)."""
    rng = np.random.RandomState(seed)
    f = len(CFEATS)
    binsT = np.zeros((f, n), np.uint8)
    for j, (nb, _, _, _) in enumerate(CFEATS):
        p = rng.dirichlet(np.full(nb, 0.7))
        binsT[j] = rng.choice(nb, size=n, p=p)
    g = rng.randn(n) + 0.8 * np.sin(binsT[2])
    h = rng.rand(n) + 0.1
    stats = np.stack([g, h, np.ones(n)], 1).astype(np.float32)
    leaf = rng.randint(0, leaves, n).astype(np.int32)
    planes = np.array(jhist.histogram_scatter(
        jnp.asarray(binsT.T), jnp.asarray(stats), jnp.asarray(leaf), leaves,
        CB))
    planes[:, 3, 1:7] = planes[:, 3, 1:2]
    planes[:, 5] = planes[:, 3]
    s = planes[:, 0].sum(axis=1)
    aux = [s[:, 0], s[:, 1], s[:, 2], (-0.2 * s[:, 0] / (s[:, 1] + 1)
                                       ).astype(np.float32)]
    return planes, aux


def _metas():
    nb = np.array([c[0] for c in CFEATS], np.int32)
    mt = np.array([c[1] for c in CFEATS], np.int32)
    db = np.array([c[2] for c in CFEATS], np.int32)
    cat = np.array([c[3] for c in CFEATS])
    f = len(CFEATS)
    jmeta = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb), missing_type=jnp.asarray(mt),
        default_bin=jnp.asarray(db), is_categorical=jnp.asarray(cat),
        monotone=jnp.zeros(f, jnp.int8), penalty=jnp.ones(f, jnp.float32))
    tmeta = tsplit.FeatureMeta(
        num_bins=torch.from_numpy(nb), missing_type=torch.from_numpy(mt),
        default_bin=torch.from_numpy(db), is_categorical=torch.from_numpy(cat),
        monotone=torch.zeros(f, dtype=torch.int8),
        penalty=torch.ones(f, dtype=torch.float32))
    return jmeta, tmeta


def _params(pname):
    jp = jsplit.SplitParams.from_config(
        JConfig.from_params(dict(CAT_PARAMS[pname])))
    tp = tsplit.SplitParams.from_config(
        TConfig.from_params(dict(CAT_PARAMS[pname], device_type="cpu")))
    return jp, tp


def _same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        _bits_equal(b, a)
    else:
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("pname", sorted(CAT_PARAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_find_best_cat_splits_matches_jax(pname, seed):
    planes, aux = _classic_inputs(seed)
    jmeta, tmeta = _metas()
    jp, tp = _params(pname)
    depth = np.array([0, 1, 2, 3, 2, 1], np.int32)
    fmask = np.ones((6, len(CFEATS)), bool)
    fmask[4, 2] = False
    cw = tsplit.cat_words_for(CB)
    jout = jsplit.find_best_cat_splits(
        jnp.asarray(planes), *map(jnp.asarray, aux), jnp.asarray(depth),
        jmeta, jp, jnp.asarray(fmask), 3, cw)
    tout = tsplit.find_best_cat_splits(
        torch.from_numpy(planes), *map(torch.from_numpy, aux),
        torch.from_numpy(depth), tmeta, tp, torch.from_numpy(fmask), 3, cw)
    for name, a, b in zip(("gain", "feature", "left_g", "left_h", "left_c",
                           "bitset", "l2"), jout, tout):
        _same(a, b.numpy(), name)
    assert np.isfinite(np.asarray(jout[0])).any()


@pytest.mark.parametrize("pname", sorted(CAT_PARAMS))
@pytest.mark.parametrize("with_categorical", [False, True])
def test_find_best_splits_matches_jax(pname, with_categorical):
    planes, aux = _classic_inputs(7)
    jmeta, tmeta = _metas()
    jp, tp = _params(pname)
    depth = np.array([0, 1, 2, 3, 2, 1], np.int32)
    cw = tsplit.cat_words_for(CB)
    jinfo = jsplit.find_best_splits(
        jnp.asarray(planes), *map(jnp.asarray, aux), jnp.asarray(depth),
        jmeta, jp, jnp.ones(len(CFEATS), jnp.float32), 3,
        with_categorical=with_categorical, cat_words=cw)
    tinfo = tsplit.find_best_splits(
        torch.from_numpy(planes), *map(torch.from_numpy, aux),
        torch.from_numpy(depth), tmeta, tp,
        torch.ones(len(CFEATS), dtype=torch.bool), 3,
        with_categorical=with_categorical, cat_words=cw)
    for name in tsplit.SplitInfo._fields:
        _same(getattr(jinfo, name), getattr(tinfo, name).numpy(), name)
    if with_categorical:
        assert np.asarray(jinfo.is_cat).any()


def test_sorted_categories_tie_in_bin_order():
    """Bins whose g / (h + cat_smooth) ties keep bin order (a stable sort,
    as jnp.argsort's): the chosen bitset is the lowest bins of the tie."""
    planes, aux = _classic_inputs(3)
    planes[:, 3, 1:7] = np.array([-50.0, 40.0, 60.0], np.float32)
    jmeta, tmeta = _metas()
    jp, tp = _params("defaults")
    cw = tsplit.cat_words_for(CB)
    only3 = np.zeros((6, len(CFEATS)), bool)
    only3[:, 3] = True
    args = (*map(np.asarray, aux), np.zeros(6, np.int32))
    jout = jsplit.find_best_cat_splits(
        jnp.asarray(planes), *map(jnp.asarray, args), jmeta, jp,
        jnp.asarray(only3), -1, cw)
    tout = tsplit.find_best_cat_splits(
        torch.from_numpy(planes), *map(torch.from_numpy, args), tmeta, tp,
        torch.from_numpy(only3), -1, cw)
    _same(jout[5], tout[5].numpy(), "bitset")
    words = tout[5].numpy()
    chosen = [b for b in range(CB) if (words[0, b >> 5] >> (b & 31)) & 1]
    assert chosen and chosen == sorted(chosen)
