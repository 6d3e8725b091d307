"""The PyTorch port's prediction against the JAX package's, on the CPU.

The same numpy rows (600 x 8 with 5% NaNs, made from a seed) train both
packages with the same parameters (model texts equal), then the port's
predictions are held to the JAX package's bit for bit: raw, converted and
early-stopped scores in the three ``predict_accum`` modes,
``start_iteration`` / ``num_iteration`` windows, chunked rows,
``score_dataset`` with the per-tree biases, and an init model's prefix
(the model kinds and data kinds are in ``test_torch_predict_kinds.py``
and ``test_torch_predict_data.py``). The depth-bounded
traversal gives the leaves of the level-by-level loop, the kernel's plain
version is ``_accum_core``'s arithmetic on the JAX engine's own stacked
trees, and the input checks raise the JAX package's messages
(``predict_disable_shape_check`` turns them off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import predict_engine as jpe
from lightgbm_tpu_torch.models.predict_engine import host_tree_depth
from lightgbm_tpu_torch.models.tree import (empty_tree, predict_leaf_bins,
                                            predict_leaf_bins_depth,
                                            stack_trees)
from lightgbm_tpu_torch.ops import predict as tp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    X = rng.normal(size=(600, 8)).astype(np.float64)
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])) > 0) \
        .astype(np.float64)
    y3 = np.digitize(np.nan_to_num(X[:, 0]) + 0.3 * np.nan_to_num(X[:, 2]),
                     [-0.5, 0.5]).astype(np.float64)
    return X, y, y3


def _train_pair(X, y, extra, nround=6, **ds_kw):
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
         "verbosity": -1}
    p.update(extra)
    bj = lj.train(dict(p), lj.Dataset(X, label=y, params=dict(p), **ds_kw),
                  nround)
    pt = dict(p, device_type="cpu")
    bt = lt.train(pt, lt.Dataset(X, label=y, params=dict(pt), **ds_kw),
                  nround)
    assert bt.model_to_string() == bj.model_to_string()
    return bj, bt


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pairs(data):
    """A binary and a 3-class pair of boosters, 10 rounds each."""
    X, y, y3 = data
    return (_train_pair(X, y, {}, nround=10),
            _train_pair(X, y3, {"objective": "multiclass", "num_class": 3},
                        nround=10))


def _set_accum(bj, bt, mode):
    for b in (bj, bt):
        b._boosting.config.predict_accum = mode
    bj._boosting._engine_cache.clear()


@pytest.mark.parametrize("mode", ["auto", "float64", "compensated",
                                  "float32"])
def test_accum_modes(data, pairs, mode):
    """Each accumulation mode is bitwise the JAX engine's: raw, converted
    and early-stopped predictions, binary and 3-class."""
    X = data[0]
    for bj, bt in pairs:
        _set_accum(bj, bt, mode)
        try:
            for kw in ({"raw_score": True}, {},
                       {"raw_score": True, "pred_early_stop": True,
                        "pred_early_stop_freq": 4,
                        "pred_early_stop_margin": 0.8}):
                _same(bt.predict(X, **kw), bj.predict(X, **kw))
        finally:
            _set_accum(bj, bt, "auto")


def test_windows_and_chunked_rows(data):
    """num_iteration counts from start_iteration; chunked rows give the
    unchunked bits; both equal the JAX package's."""
    X, y, _ = data
    bj, bt = _train_pair(X, y, {"predict_chunk_rows": 77}, nround=8)
    for s, n in ((0, 3), (3, None), (2, 4), (7, 5), (9, 2), (0, -1)):
        _same(bt.predict(X[:400], raw_score=True, start_iteration=s,
                         num_iteration=n),
              bj.predict(X[:400], raw_score=True, start_iteration=s,
                         num_iteration=n))
    got = bt.predict(X[:400], raw_score=True)
    g = bt._boosting
    g.config.predict_chunk_rows = 0
    _same(bt.predict(X[:400], raw_score=True), got)
    _same(bt.predict(X[:400], pred_leaf=True, num_iteration=5),
          bj.predict(X[:400], pred_leaf=True, num_iteration=5))


def test_score_dataset_with_biases(data):
    """score_dataset (Booster.eval's path) takes each tree's folded bias
    off before the add: bitwise the JAX package's on a valid set, in
    each accumulation mode."""
    X, y, _ = data
    sets = []
    for lib in (lj, lt):
        p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
             "metric": "binary_logloss"}
        if lib is lt:
            p["device_type"] = "cpu"
        dtr = lib.Dataset(X[:500], label=y[:500], params=dict(p))
        b = lib.train(p, dtr, 5)
        sets.append((b, lib.Dataset(X[500:], label=y[500:], reference=dtr)))
    (bj, vj), (bt, vt) = sets
    assert np.any(np.asarray(bt._boosting.tree_bias) != 0)
    for mode in ("float64", "compensated", "float32"):
        _set_accum(bj, bt, mode)
        _same(bt._boosting.score_dataset(vt), bj._boosting.score_dataset(vj))
        assert bt.eval(vt, "extra") == bj.eval(vj, "extra")
    _set_accum(bj, bt, "auto")


def test_init_model_prefix(data):
    """An init model's iterations come first on the host, then the
    engine from that float64 sum: raw, converted, leaves, early stop and
    windows across the boundary equal the JAX package's."""
    X, y, _ = data
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    bj0 = lj.train(dict(p), lj.Dataset(X, label=y, params=dict(p)), 3)
    text = bj0.model_to_string()
    bj = lj.train(dict(p), lj.Dataset(X, label=y, params=dict(p)), 3,
                  init_model=lj.Booster(model_str=text))
    pt = dict(p, device_type="cpu")
    bt = lt.train(pt, lt.Dataset(X, label=y, params=dict(pt)), 3,
                  init_model=lt.Booster(model_str=text))
    assert bt.model_to_string() == bj.model_to_string()
    for kw in ({"raw_score": True}, {}, {"pred_leaf": True},
               {"raw_score": True, "pred_early_stop": True,
                "pred_early_stop_freq": 2, "pred_early_stop_margin": 0.5},
               {"raw_score": True, "start_iteration": 2, "num_iteration": 3},
               {"raw_score": True, "start_iteration": 4}):
        _same(bt.predict(X, **kw), bj.predict(X, **kw))


def _random_deep_tree(rng, n_leaves, n_feats, n_bins, cap=None):
    """A random, deliberately unbalanced tree (the JAX test's builder) of
    leaf capacity ``cap``, as the port's TreeArrays and as the JAX
    package's."""
    from lightgbm_tpu.models.tree import empty_tree as jempty
    leaves = [(~0, 0)]
    feat = np.zeros(n_leaves - 1, np.int32)
    thr = np.zeros(n_leaves - 1, np.int32)
    left = np.full(n_leaves - 1, -1, np.int32)
    right = np.full(n_leaves - 1, -1, np.int32)
    parent_link = {}
    for node in range(n_leaves - 1):
        enc, depth = leaves.pop(rng.randint(len(leaves)))
        leaf_idx = ~enc
        if leaf_idx in parent_link:
            arr, pos = parent_link.pop(leaf_idx)
            arr[pos] = node
        feat[node] = rng.randint(n_feats)
        thr[node] = rng.randint(n_bins - 1)
        new_leaf = node + 1
        left[node] = ~leaf_idx
        right[node] = ~new_leaf
        parent_link[leaf_idx] = (left, node)
        parent_link[new_leaf] = (right, node)
        leaves.append((~leaf_idx, depth + 1))
        leaves.append((~new_leaf, depth + 1))
    cap = cap or n_leaves
    pad = cap - n_leaves
    feat, thr = np.pad(feat, (0, pad)), np.pad(thr, (0, pad))
    left = np.pad(left, (0, pad), constant_values=-1)
    right = np.pad(right, (0, pad), constant_values=-1)
    lv = np.pad(rng.randn(n_leaves).astype(np.float32), (0, pad))
    tt = empty_tree(cap)._replace(
        node_feature=torch.as_tensor(feat), node_threshold_bin=torch.as_tensor(
            thr), node_left=torch.as_tensor(left),
        node_right=torch.as_tensor(right), leaf_value=torch.as_tensor(lv),
        num_leaves=torch.tensor(n_leaves, dtype=torch.int32))
    tj = jax.device_get(jempty(cap))._replace(
        node_feature=feat, node_threshold_bin=thr, node_left=left,
        node_right=right, leaf_value=lv, num_leaves=np.int32(n_leaves))
    return tt, jax.tree.map(jnp.asarray, tj), left, right


def test_depth_bounded_traversal_matches_while_loop():
    """The depth-bounded traversal gives the leaves of the level-by-level
    loop on a random deep tree, at the exact bound and above, and the
    JAX package's while-loop leaves."""
    rng = np.random.RandomState(3)
    n_leaves, n_feats, n_bins = 31, 6, 16
    tree, jtree, left, right = _random_deep_tree(rng, n_leaves, n_feats,
                                                 n_bins)
    bins = rng.randint(0, n_bins, size=(512, n_feats)).astype(np.uint8)
    binsT = torch.as_tensor(np.ascontiguousarray(bins.T))
    mb = torch.full((n_feats,), -1, dtype=torch.int32)
    ref = predict_leaf_bins(tree, binsT, mb).numpy()
    from lightgbm_tpu.models.tree import predict_leaf_bins as jleaf
    _same(ref, np.asarray(jleaf(jtree, jnp.asarray(bins),
                                jnp.full((n_feats,), -1, jnp.int32))))
    depth = host_tree_depth(left, right, n_leaves)
    assert depth > 3
    for d in (depth, depth + 1, n_leaves - 1):
        _same(predict_leaf_bins_depth(tree, binsT, mb, d).numpy(), ref)


def test_plain_kernel_version_is_accum_core():
    """``predict_ensemble_plain`` on the port's stacked trees is bitwise
    the JAX engine's ``_accum_core`` / ``_leaves_core`` on the same trees
    and bins, in every mode, with biases and an active mask, K = 1 and
    K = 3, from a nonzero carry."""
    rng = np.random.RandomState(5)
    n_feats, n_bins, n = 6, 16, 300
    pairs = [_random_deep_tree(rng, 15 + 2 * i, n_feats, n_bins, cap=25)[:2]
             for i in range(6)]
    from lightgbm_tpu.models.tree import stack_trees as jstack
    trees_t = [p[0] for p in pairs]
    trees_j = [p[1] for p in pairs]
    bins = rng.randint(0, n_bins, size=(n, n_feats)).astype(np.uint8)
    binsT = torch.as_tensor(np.ascontiguousarray(bins.T))
    mb = np.full((n_feats,), -1, np.int32)
    mb[2] = 0
    depth = 24
    st = stack_trees(trees_t)
    tables = tp.pack_ensemble(st, depth, "cpu")
    sj = jstack(trees_j)
    bias = rng.randn(len(trees_t)) * 0.1
    active = rng.rand(n) < 0.5
    with jax.enable_x64(True):
        for k in (1, 3):
            t_used = 6 if k == 3 else 5
            class_of = jnp.asarray(np.arange(t_used, dtype=np.int32) % k)
            sjt = jax.tree.map(lambda x: x[:t_used], sj)
            for accum in ("float64", "compensated", "float32"):
                for use_bias in (False, True):
                    for use_act in (False, True):
                        base = rng.randn(n, k)
                        dt = np.float64 if accum == "float64" else np.float32
                        if accum == "compensated":
                            s = jnp.asarray(base.astype(np.float32))
                            carry_j = (s, jnp.zeros_like(s))
                            carry_t = (torch.as_tensor(
                                base.astype(np.float32)),
                                torch.zeros((n, k), dtype=torch.float32))
                        else:
                            carry_j = jnp.asarray(base.astype(dt))
                            carry_t = torch.as_tensor(base.astype(dt))
                        if k == 1:
                            carry_j = jax.tree.map(lambda x: x[:, 0],
                                                   carry_j)
                        got = tp.predict_ensemble(
                            tables, binsT, torch.as_tensor(mb), (0, t_used),
                            k, bias=(torch.as_tensor(bias)
                                     if use_bias else None),
                            active=(torch.as_tensor(active)
                                    if use_act else None),
                            carry=carry_t, accum=accum)
                        ref = jpe._accum_core(
                            sjt, class_of,
                            jnp.asarray(bias[:t_used]) if use_bias else None,
                            jnp.asarray(bins), jnp.asarray(mb), carry_j,
                            jnp.asarray(active) if use_act else None,
                            depth=depth, k=k, use_bias=use_bias,
                            use_active=use_act, accum=accum,
                            init_zero=False)
                        g = got[0] if accum == "compensated" else got
                        r = ref[0] if accum == "compensated" else ref
                        r = np.asarray(r).reshape(n, k)
                        _same(g.numpy(), r)
    leaves = tp.predict_ensemble(tables, binsT, torch.as_tensor(mb), (1, 5),
                                 leaves=True)
    ref = jpe._leaves_core(jax.tree.map(lambda x: x[1:5], sj),
                           jnp.asarray(bins), jnp.asarray(mb), depth=depth)
    _same(leaves.numpy(), np.asarray(ref))
    assert tp.node_visits(tables, leaves, (1, 5)) == int(sum(
        st.leaf_depth[t][leaves[t - 1].long()].sum() for t in range(1, 5)))


_BAD = {
    "width": (lambda X: X[:, :7], "predict input has 7 feature columns but "
              "the model was trained with 8"),
    "non_numeric": (lambda X: np.where(np.arange(8) == 4, "a",
                                       X.astype(str)).astype(object),
                    "non-numeric data in feature column 4"),
    "nan_without_missing": (lambda X: _poke(X, 5, 6, np.nan),
                            "has NaN at row 5, feature column 6"),
    "pos_inf": (lambda X: _poke(X, 7, 3, np.inf),
                "has +inf at row 7, feature column 3"),
    "neg_inf": (lambda X: _poke(X, 2, 1, -np.inf),
                "has -inf at row 2, feature column 1"),
}


def _poke(X, r, c, v):
    X = X.copy()
    X[r, c] = v
    return X


@pytest.fixture(scope="module")
def checked():
    """A pair trained on rows whose column 2 has NaNs and the others
    none."""
    rng = np.random.RandomState(1)
    X = rng.randn(400, 8)
    X[:, 2] = np.where(rng.rand(400) < 0.1, np.nan, X[:, 2])
    y = (X[:, 0] > 0).astype(np.float64)
    return X, _train_pair(X, y, {}, nround=3)


@pytest.mark.parametrize("case", list(_BAD))
def test_input_validation(checked, case):
    """The input checks raise the JAX package's message naming the row
    and the column; predict_disable_shape_check bins the same input as
    the JAX package does."""
    X, (bj, bt) = checked
    make, msg = _BAD[case]
    bad = make(X[:20])
    errs = []
    for b in (bj, bt):
        with pytest.raises(ValueError) as ei:
            b.predict(bad)
        errs.append(str(ei.value).split(": could not convert")[0])
    assert msg in errs[1]
    assert errs[0] == errs[1]
    if case in ("nan_without_missing", "pos_inf", "neg_inf"):
        try:
            for b in (bj, bt):
                b._boosting.config.predict_disable_shape_check = True
            _same(bt.predict(bad, raw_score=True),
                  bj.predict(bad, raw_score=True))
        finally:
            for b in (bj, bt):
                b._boosting.config.predict_disable_shape_check = False


def test_caches_follow_the_trees(data):
    """Rollback, more training and shuffle_models change the trees; the
    stacked trees, engines and model-tree caches follow them (predict
    equals the JAX package's after each)."""
    X, y, _ = data
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    out = []
    for lib in (lj, lt):
        pp = dict(p, device_type="cpu") if lib is lt else dict(p)
        b = lib.Booster(params=pp, train_set=lib.Dataset(X, label=y,
                                                         params=dict(pp)))
        res = []
        for _ in range(4):
            b.update()
        res.append(b.predict(X, raw_score=True))
        res.append(b.predict(X, pred_contrib=True))
        b.rollback_one_iter()
        res.append(b.predict(X, raw_score=True))
        b.update()
        res.append(b.predict(X, raw_score=True))
        b.shuffle_models()
        res.append(b.predict(X, raw_score=True, num_iteration=2))
        res.append(b.predict(X, pred_contrib=True))
        out.append(res)
    for a, b in zip(out[0], out[1]):
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)
    for i in (0, 2, 3, 4):
        _same(out[1][i], out[0][i])


@pytest.mark.parametrize("label", ["y", "y3"])
def test_booster_to_numpy_twin(data, label):
    """A booster's trees carried to a new booster (``booster_to_numpy`` ->
    ``booster_from_numpy``) predict bitwise the same in every mode."""
    X, y, y3 = data
    extra = ({"objective": "multiclass", "num_class": 3} if label == "y3"
             else {})
    p = dict({"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "device_type": "cpu"}, **extra)
    b = lt.train(p, lt.Dataset(X, label=y3 if label == "y3" else y,
                               params=dict(p)), 5)
    twin = lt.booster_from_numpy(*lt.booster_to_numpy(b))
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True},
               {"pred_early_stop": True, "pred_early_stop_freq": 2,
                "pred_early_stop_margin": 0.5},
               {"pred_contrib": True}):
        _same(twin.predict(X, **kw), b.predict(X, **kw))


def test_stacked_leaves_and_values(pairs, data):
    """``predict_leaves_stacked`` / ``predict_values_stacked`` over the
    stacked trees equal the JAX package's ([T, N] leaves and float32
    values), binary and 3-class."""
    from lightgbm_tpu.models.tree import predict_leaves_stacked as jleaves
    from lightgbm_tpu.models.tree import predict_values_stacked as jvalues
    from lightgbm_tpu_torch.models.tree import (predict_leaves_stacked,
                                                predict_values_stacked)
    X = data[0][:200]
    for bj, bt in pairs:
        gj, gt = bj._boosting, bt._boosting
        bins = jnp.asarray(gj.train_set.bin_new_data(X))
        st = stack_trees(gt.trees)
        binsT = gt.train_set.bin_new_data(X)
        mb = gt.train_set.missing_bin
        depth = gt._ensemble_depth(len(gt.trees))
        _same(predict_leaves_stacked(st, binsT, mb, depth).numpy(),
              np.asarray(jleaves(gj._stacked(), bins,
                                 gj.train_set.missing_bin)))
        _same(predict_values_stacked(st, binsT, mb, depth).numpy(),
              np.asarray(jvalues(gj._stacked(), bins,
                                 gj.train_set.missing_bin)))


# ------------------------------------------- the kernel's launch geometry
# launch_geometry's rule on the shapes it must place (pure Python): the
# arguments (rows, columns, bytes a bin, records a tree, leaves,
# categorical, segment nodes) and the geometry it gives: mode, threads a
# block, rows a tile, the bins' row stride, trees a chunk, a tree's stage
# bytes, shared bytes a block, blocks
GEOMETRY_CASES = {
    # Higgs: 28 uint8 columns, 100 trees of 255 leaves, 2M rows
    "higgs_u8_255": ((2_000_000, 28, 1, 254, 255, False, False),
                     ("tiled", 256, 1024, 28, 6, 3072, 28672 + 36864, 1954)),
    # max_bin 1,023: int16 bins (56 bytes a row, 15 words), 200k rows
    "max_bin_1023_int16": ((200_000, 28, 2, 254, 255, False, False),
                           ("tiled", 128, 512, 60, 6, 3072, 30720 + 36864,
                            391)),
    # Epsilon: 2,000 uint8 columns, a tile's bins past the block's memory
    "epsilon_2000": ((400_000, 2000, 1, 254, 255, False, False),
                     ("global", 256, 256, 0, 0, 3072, 0, 1563)),
    # a categorical node: the global mode
    "categorical": ((2_000_000, 28, 1, 254, 255, True, False),
                    ("global", 256, 256, 0, 0, 3072, 0, 7813)),
    "leaves_1023": ((2_000_000, 28, 1, 1022, 1023, False, False),
                    ("tiled", 256, 1024, 28, 1, 12288, 28672 + 24576, 1954)),
    # 2,047 leaves: 24 KB a tree, past the 16 KB stage
    "leaves_2047": ((2_000_000, 28, 1, 2046, 2047, False, False),
                    ("global", 256, 256, 0, 0, 24576, 0, 7813)),
    "leaves_4095": ((2_000_000, 28, 1, 4094, 4095, False, False),
                    ("global", 256, 256, 0, 0, 49152, 0, 7813)),
    # EFB segments: the global mode
    "leaves_4095_segments": ((2_000_000, 28, 1, 4094, 4095, False, True),
                             ("global", 256, 256, 0, 0, 49152, 0, 7813)),
    # small calls: blocks of 64 threads
    "rows_20k": ((20_000, 28, 1, 254, 255, False, False),
                 ("tiled", 64, 256, 28, 6, 3072, 7168 + 36864, 79)),
    # past an 8-byte record: the first design, a thread a row
    "leaves_40001": ((100_000, 28, 1, 40_000, 40_001, False, False),
                     ("global", 256, 256, 0, 0, 320_016 + 160_016, 0, 391)),
    "columns_4097": ((5_000, 4097, 1, 254, 255, False, False),
                     ("global", 256, 256, 0, 0, 3072, 0, 20)),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_predict_launch_geometry(case):
    """Rows a tile, shared bytes and the mode ``launch_geometry`` gives each
    shape, the layout's offsets, and the block's shared memory within the
    card's 227 KB."""
    args, want = GEOMETRY_CASES[case]
    g = tp.launch_geometry(*args)
    got = (g.mode, g.threads, g.rows, g.stride, g.chunk_trees, g.stage.bytes,
           g.smem, g.blocks)
    assert got == want
    n, f, bin_bytes = args[:3]
    assert g.smem <= 232_448 and g.stage.bytes % 16 == 0
    assert g.blocks * g.rows >= n > (g.blocks - 1) * g.rows
    assert (g.mode == "tiled") == (tp.stageable(*args[3:])
                                   and g.smem > 0)
    if g.mode == "tiled":
        assert g.rows == 4 * g.threads
        # bins at 0, an odd number of words a row, then the two buffers
        assert g.stride >= f * bin_bytes and (g.stride // 4) % 2 == 1
        assert g.off_trees == -(-g.rows * g.stride // 16) * 16
        assert g.smem == g.off_trees + 2 * g.chunk_trees * g.stage.bytes
        assert g.stage.bytes <= 16 * 1024
    else:
        assert g.smem == g.off_trees == g.chunk_trees == 0


def test_launch_geometry_follows_the_card():
    """Fewer streaming multiprocessors, larger blocks: the tiles fill two
    blocks an SM where the rows allow."""
    shape = (28, 1, 254, 255, False)
    assert tp.launch_geometry(2_000_000, *shape, sms=132).threads == 256
    assert tp.launch_geometry(200_000, *shape, sms=132).threads == 128
    assert tp.launch_geometry(100_000, *shape, sms=132).threads == 64
    assert tp.launch_geometry(200_000, *shape, sms=16).threads == 256
    assert tp.launch_geometry(0, *shape).blocks == 1


def _stage_trees(rng, n_feats, n_bins):
    """Random deep trees with default directions, a tree of one leaf, and
    leaf capacities that differ."""
    trees = []
    for n_leaves in (9, 1, 23, 17, 2):
        if n_leaves == 1:
            trees.append(empty_tree(12)._replace(leaf_value=torch.as_tensor(
                rng.randn(12).astype(np.float32))))
            continue
        t = _random_deep_tree(rng, n_leaves, n_feats, n_bins)[0]
        trees.append(t._replace(node_default_left=torch.as_tensor(
            rng.rand(n_leaves - 1) < 0.5)))
    return trees


def _walk_stages(stage, lay, node_cap, binsT, mb):
    """The tile kernel's traversal transcribed in numpy over the staged
    bytes (a landed chunk's records get their exception bins from ``mb``
    first): leaves [T, N] and the staged leaf values (with the stage's
    padding)."""
    t_count = stage.shape[0]
    raw = stage.numpy()
    rec = raw[:, :(node_cap + 1) * 8].copy().view(np.uint32).reshape(
        t_count, node_cap + 1, 2).astype(np.int64)
    x, y = rec[..., 0], rec[..., 1]
    feat, thr, dl = x & 0xFFF, (x >> 12) & 0xFFF, x >> 24
    m = mb[feat]
    e = np.where((m >= 0) & ((m <= thr) != (dl != 0)), m, 8191)
    lc, rc = (y >> 5) & 0x1FFF, (y >> 18) & 0x1FFF
    assert not (y >> 31).any()
    lv = raw[:, lay.off_leaf:].copy().view(np.float32)
    bins = binsT.numpy().astype(np.int64)
    n = bins.shape[1]
    rows = np.arange(n)
    out = np.zeros((t_count, n), np.int32)
    for t in range(t_count):
        cur = np.zeros(n, np.int64)
        leaf = np.full(n, -1, np.int64)
        while (leaf < 0).any():
            go = leaf < 0
            bv = bins[feat[t, cur], rows]
            left = (bv <= thr[t, cur]) != (bv == e[t, cur])
            code = np.where(left, lc[t, cur], rc[t, cur])
            done = go & (code >= 4096)
            leaf[done] = code[done] - 4096
            cur = np.where(go & (code < 4096), code, cur)
        out[t] = leaf
    return out, lv


@pytest.mark.parametrize("seed", [12, 14])
def test_staged_trees_walk_as_the_plain_version(seed):
    """The trees as ``stage_ensemble`` packs them for the tiled mode
    (8-byte records numbered breadth first, then the leaf values), walked
    as the kernel walks them, reach the plain version's leaves, and the
    staged leaf values are the trees' -- nodes with a missing bin on
    either side of the threshold and either default direction, a tree of
    one leaf, capacities that differ."""
    rng = np.random.RandomState(seed)
    n_feats, n_bins, n = 5, 32, 400
    trees = _stage_trees(rng, n_feats, n_bins)
    st = stack_trees(trees)
    tables = tp.pack_ensemble(st, 22, "cpu")
    assert tables.stage is None and not tables.has_cat
    stage = tp.stage_ensemble(tables.stacked, tables.nodes, tables.depth)
    node_cap, leaf_cap = tables.nodes.shape[1], st.leaf_value.shape[1]
    lay = tp.stage_layout(node_cap, leaf_cap)
    assert tuple(stage.shape) == (len(trees), lay.bytes)
    assert stage.dtype == torch.uint8
    bins = rng.randint(0, n_bins, size=(n_feats, n)).astype(np.uint8)
    binsT = torch.as_tensor(bins)
    for mb in (np.array([-1, 3, 0, -1, n_bins - 1], np.int64),
               np.array([n_bins - 1, 0, 7, 1, -1], np.int64)):
        got, lv = _walk_stages(stage, lay, node_cap, binsT, mb)
        ref = tp.predict_ensemble_plain(
            tables, binsT, torch.as_tensor(mb, dtype=torch.int32),
            (0, len(trees)), leaves=True)
        _same(got, ref.numpy())
    assert (got[1] == 0).all()
    _same(lv[:, :leaf_cap], st.leaf_value.numpy())
    assert tp.stageable(node_cap, leaf_cap, False, False)
    assert not tp.stageable(node_cap, leaf_cap, True, False)
    assert not tp.stageable(node_cap, leaf_cap, False, True)


def test_staged_records_are_breadth_first():
    """A tree's records in breadth-first order: the root first, each
    depth's nodes together, children after their parents."""
    rng = np.random.RandomState(2)
    tree = _random_deep_tree(rng, 40, 4, 16)[0]
    st = stack_trees([tree])
    tables = tp.pack_ensemble(st, 39, "cpu")
    stage = tp.stage_ensemble(tables.stacked, tables.nodes,
                              tables.depth).numpy()
    rec = stage[0, :40 * 8].copy().view(np.uint32).reshape(40, 2)
    # the sentinel after the nodes: both children itself
    assert rec[39, 0] == 0 and rec[39, 1] == (39 << 5 | 39 << 18)
    depth = np.zeros(39, np.int64)
    for node in range(39):
        for code in ((rec[node, 1] >> 5) & 0x1FFF,
                     (rec[node, 1] >> 18) & 0x1FFF):
            if code < 4096:
                assert code > node
                depth[code] = depth[node] + 1
    assert (np.diff(depth) >= 0).all()
    # several trees at once: each tree's records are its own queue order
    trees = _stage_trees(rng, 5, 32)
    st = stack_trees(trees)
    tables = tp.pack_ensemble(st, 22, "cpu")
    stage = tp.stage_ensemble(tables.stacked, tables.nodes,
                              tables.depth).numpy()
    cap = tables.nodes.shape[1]
    for t, tree in enumerate(trees):
        left, right = tree.node_left.tolist(), tree.node_right.tolist()
        queue = [0] if int(tree.num_leaves) > 1 else []
        for node in queue:
            queue += [c for c in (left[node], right[node]) if c >= 0]
        rec = stage[t, :cap * 8].copy().view(np.uint32).reshape(cap, 2)
        want = np.array([tree.node_feature[i] for i in queue], np.uint32)
        assert (rec[:len(queue), 0] & 0xFFF == want).all()
