"""The distributed learners of the PyTorch port at grower level
(``lightgbm_tpu_torch/parallel/learners.py`` over ``models/grower.py``'s
collective hooks) against the JAX package's ``ParallelGrower`` on a mesh
of W virtual CPU devices.

One tree from injected gradients and hessians on the same binned data,
601 rows and 7 features (neither divisible by W, so both paddings run),
for each learner -- data (planes reduce-scattered to the feature owners,
the owners' search, the best-split sync), feature (each rank's slice) and
voting (the local vote and the elected columns' sums) -- at W = 2 and 8,
in f32 (with and without a bagging mask) and q8: the tree arrays and the
leaf ids of every row are bitwise the JAX learner's, on every rank. The
ranks run as threads over ``ProcessGroupGloo`` (``network.thread_gang``).
``grow_tree_dp`` is the data learner; inside ``kernel_sums_on_cpu()`` the
data learner's passes take the integer-planes mode and split as the float
run does on this data.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops.split import SplitParams as JSplitParams
from lightgbm_tpu.parallel.data_parallel import make_mesh
from lightgbm_tpu.parallel.learners import ParallelGrower as JParallelGrower
from lightgbm_tpu_torch import network
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops.split import SplitParams as TSplitParams
from lightgbm_tpu_torch.parallel.data_parallel import grow_tree_dp
from lightgbm_tpu_torch.parallel.learners import ParallelGrower
from lightgbm_tpu_torch.utils.random import prng_key

torch.set_num_threads(1)

N, L = 601, 8
PARAMS = {"max_bin": 31, "verbosity": -1, "min_data_in_leaf": 5,
          "lambda_l2": 0.5}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(N, 7).astype(np.float32)
    X[rng.rand(N) < 0.1, 1] = np.nan
    X[:, 3] = np.round(X[:, 3] * 2)
    g = (rng.randn(N) + X[:, 0] - 0.5 * X[:, 2]).astype(np.float32)
    h = (rng.rand(N) + 0.5).astype(np.float32)
    mask = (rng.rand(N) < 0.7).astype(np.float32)
    jds = lj.Dataset(X, params=dict(PARAMS)).construct()
    tds = lt.Dataset(X, params=dict(PARAMS, device_type="cpu")).construct()
    np.testing.assert_array_equal(tds.binsT.numpy(), np.asarray(jds.bins).T)
    return jds, tds, g, h, mask


_JAX_GROWERS = {}


def _jax_tree(data, mode, w, q8, masked):
    jds, _, g, h, mask = data
    pg = _JAX_GROWERS.get((mode, w))
    if pg is None:
        pg = _JAX_GROWERS[(mode, w)] = JParallelGrower(
            mode, mesh=make_mesh(w, axis="shard"), axis="shard")
    m = mask if masked else np.ones(N, np.float32)
    tree, leaf, _ = pg(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
        jds.feature_meta,
        JSplitParams.from_config(lj.Config.from_params(dict(PARAMS))),
        jnp.ones(jds.bins.shape[1], jnp.float32), jds.missing_bin,
        max_leaves=L, num_bins=jds.max_num_bins,
        hist_method="onehot_q8" if q8 else "scatter",
        rng_key=jax.random.PRNGKey(3))
    return jax.device_get(tree), np.asarray(leaf)


def _port_trees(data, mode, w, q8, masked, kernel_sums=False):
    _, tds, g, h, mask = data
    params = TSplitParams.from_config(lt.Config.from_params(
        dict(PARAMS, device_type="cpu")))

    def body(net):
        def grow():
            return ParallelGrower(mode, net)(
                tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
                torch.from_numpy(mask) if masked else None,
                tds.feature_meta, params, None, tds.missing_bin,
                max_leaves=L, num_bins=tds.max_num_bins,
                hist_method="plain_q8" if q8 else "", rng_key=prng_key(3))
        if kernel_sums:
            with cuda_hist.kernel_sums_on_cpu():
                return grow()
        return grow()

    return network.thread_gang(w, body)


def _assert_trees_equal(jtree, ttree):
    for name in ttree._fields:
        a = np.asarray(getattr(jtree, name))
        b = getattr(ttree, name).numpy()
        if a.dtype == np.float32:
            np.testing.assert_array_equal(b.view(np.uint32),
                                          a.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(b.astype(np.int64),
                                          a.astype(np.int64), err_msg=name)


# every learner at W = 2 (f32, f32 with a bagging mask: one JAX compile)
# and W = 8 (f32, q8); the data learner at W = 2 in q8 with the mask too
CASES = [(m, w, q8, masked) for m in ("data", "feature", "voting")
         for w, q8, masked in ((2, False, False), (2, False, True),
                               (8, False, False), (8, True, False))]
CASES.append(("data", 2, True, True))


@pytest.mark.parametrize("mode,w,q8,masked", CASES,
                         ids=[f"{m}-w{w}-{'q8' if q else 'f32'}"
                              f"{'-bagging' if b else ''}"
                              for m, w, q, b in CASES])
def test_learner_matches_jax(data, mode, w, q8, masked):
    jtree, jleaf = _jax_tree(data, mode, w, q8, masked)
    outs = _port_trees(data, mode, w, q8, masked)
    ttree, tleaf, streamed = outs[0]
    assert int(ttree.num_leaves) == L
    _assert_trees_equal(jtree, ttree)
    np.testing.assert_array_equal(tleaf.numpy(), jleaf)
    for other, oleaf, ostreamed in outs[1:]:
        _assert_trees_equal(jtree, other)
        np.testing.assert_array_equal(oleaf.numpy(), jleaf)
        assert ostreamed == streamed


def test_grow_tree_dp_is_the_data_learner(data):
    _, tds, g, h, _ = data
    params = TSplitParams.from_config(lt.Config.from_params(
        dict(PARAMS, device_type="cpu")))
    jtree, jleaf = _jax_tree(data, "data", 2, False, False)

    def body(net):
        return grow_tree_dp(net, tds.binsT, torch.from_numpy(g),
                            torch.from_numpy(h), None, tds.feature_meta,
                            params, None, tds.missing_bin, max_leaves=L,
                            num_bins=tds.max_num_bins)

    for tree, leaf, _ in network.thread_gang(2, body):
        _assert_trees_equal(jtree, tree)
        np.testing.assert_array_equal(leaf.numpy(), jleaf)


def test_integer_planes_data_learner_splits_as_the_float_run(data):
    """Inside ``kernel_sums_on_cpu()`` the data learner reduce-scatters the
    passes' int64 planes (the card's arithmetic on the CPU): the same
    splits and counts as the float run here, every rank the same tree."""
    flt = _port_trees(data, "data", 2, False, False)[0][0]
    outs = _port_trees(data, "data", 2, False, False, kernel_sums=True)
    for tree, _, _ in outs:
        for name in ("node_feature", "node_threshold_bin", "leaf_count",
                     "node_left", "node_right"):
            np.testing.assert_array_equal(getattr(tree, name).numpy(),
                                          getattr(flt, name).numpy(), name)
    for name in outs[0][0]._fields:
        np.testing.assert_array_equal(getattr(outs[1][0], name).numpy(),
                                      getattr(outs[0][0], name).numpy())
