"""Row and column sampling: bagging (mask, subset, pos/neg), by-tree
``feature_fraction`` and GOSS in the PyTorch port against
``lightgbm_tpu.train`` at the same parameters, on the CPU.

- ``bits`` (the subset's and GOSS's draws) bitwise ``jax.random.bits``,
  at odd sizes too; ``stable_argsort`` / ``stable_ranks`` are
  ``jnp.argsort``'s stable sort and its inverse; GOSS's per-row weights
  bitwise the JAX package's ``goss_weights`` on scores with ties.
- Bagging in the mask mode (fraction 0.8), the subset mode (fraction 0.5:
  the in-bag rows alone are histogrammed, the compaction ladder's rungs
  are fractions of them) and with pos/neg fractions, with sparse device
  storage off and on (sparse columns keep the mask mode), in f32 and q8;
  ``feature_fraction``; GOSS (learning rate 0.5, so it samples from the
  third iteration on) in f32 and q8, binary and multiclass: model text
  bitwise equal after 10 rounds, rows streamed per tree equal, valid
  metrics within 1e-12.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import goss as jgoss
from lightgbm_tpu_torch.models import goss as tgoss
from lightgbm_tpu_torch.utils import random as tr
from test_torch_train import _data

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

ROUNDS = 10


@pytest.mark.parametrize("n", [1, 7, 1000, 4097, 300_001])
def test_bits_bitwise(n):
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    tk = tr.fold_in(tr.prng_key(3), 5)
    a = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64)
    b = tr.bits(tk, (n,)).numpy()
    np.testing.assert_array_equal(b, a)


def test_stable_sort_and_ranks():
    rng = np.random.RandomState(4)
    x = rng.randint(0, 50, 2000).astype(np.uint32)      # many ties
    x[::7] = 0xFFFFFFFF
    order = np.asarray(jnp.argsort(jnp.asarray(x)))
    ranks = np.asarray(jnp.argsort(jnp.argsort(jnp.asarray(x))))
    t = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(tr.stable_argsort(t).numpy(), order)
    np.testing.assert_array_equal(tr.stable_ranks(t).numpy(), ranks)


@pytest.mark.parametrize("top_k,other_k", [(500, 250), (1, 1),
                                           (1999, 5000)])
def test_goss_weights_bitwise(top_k, other_k):
    rng = np.random.RandomState(5)
    score = np.abs(rng.randn(2000)).astype(np.float32)
    score[:400] = np.float32(0.5)               # a tie at the threshold
    key_j = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    key_t = tr.fold_in(tr.prng_key(3), 7)
    a = np.asarray(jgoss.goss_weights(jnp.asarray(score), key_j, top_k,
                                      other_k))
    b = tgoss.goss_weights(torch.from_numpy(score), key_t, top_k,
                           other_k).numpy()
    np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))
    assert (b == 1.0).sum() == top_k
    assert (b > 1.0).sum() == min(other_k, 2000 - top_k) or \
        (2000 - top_k) / other_k <= 1.0


def _train_both(params, X, y, Xv, yv):
    params = dict(params, verbosity=-1)
    jres, tres = {}, {}
    jtrain, ttrain = lj.Dataset(X, label=y), lt.Dataset(X, label=y)
    bj = lj.train(dict(params), jtrain, ROUNDS,
                  valid_sets=[lj.Dataset(Xv, label=yv, reference=jtrain)],
                  valid_names=["v"], evals_result=jres)
    bt = lt.train(dict(params, device_type="cpu"), ttrain, ROUNDS,
                  valid_sets=[lt.Dataset(Xv, label=yv, reference=ttrain)],
                  valid_names=["v"], evals_result=tres)
    assert bt.model_to_string() == bj.model_to_string()
    assert bt.rows_streamed_per_tree == bj._boosting.rows_streamed_per_tree
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    for metric, vals in jres["v"].items():
        np.testing.assert_allclose(tres["v"][metric], vals, rtol=1e-12)
    return bj, bt


BAGGING = {
    "mask": {"bagging_fraction": 0.8, "bagging_freq": 1},
    "subset": {"bagging_fraction": 0.5, "bagging_freq": 2},
    "posneg": {"pos_bagging_fraction": 0.7, "neg_bagging_fraction": 0.4,
               "bagging_freq": 1},
}


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("mode", sorted(BAGGING))
def test_bagging_model_text_bitwise(mode, sparse, q8):
    X, y = _data(seed=40)
    Xv, yv = _data(seed=41, n=400)
    params = dict({"objective": "binary", "num_leaves": 15, "max_bin": 63,
                   "is_enable_sparse": sparse, "quantized_grad": q8,
                   "metric": ["auc", "binary_logloss"]}, **BAGGING[mode])
    _, bt = _train_both(params, X, (y > 0).astype(np.float64), Xv,
                        (yv > 0).astype(np.float64))
    gb = bt._boosting
    want = "subset" if mode == "subset" and not sparse else "mask"
    assert gb._bagging_mode() == want
    if want == "subset":
        # the rungs are fractions of the subset's rows
        assert gb._subset_rows() == 1250
        assert gb._compaction_ladder() == (192, 640)


@pytest.mark.parametrize("fraction", [0.5, 0.8])
def test_feature_fraction_model_text_bitwise(fraction):
    X, y = _data(seed=42)
    Xv, yv = _data(seed=43, n=400)
    _, bt = _train_both({"objective": "regression", "num_leaves": 15,
                         "max_bin": 63, "feature_fraction": fraction,
                         "is_enable_sparse": fraction < 0.6}, X, y, Xv, yv)
    used = {f for ht in bt._boosting.host_trees for f in ht.split_feature}
    assert len(used) > 1


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_goss_model_text_bitwise(objective, q8):
    X, y = _data(seed=44)
    Xv, yv = _data(seed=45, n=400)
    if objective == "binary":
        y, yv = (y > 0).astype(np.float64), (yv > 0).astype(np.float64)
        extra = {}
    else:
        edges = np.quantile(y, [1 / 3, 2 / 3])
        y, yv = (np.digitize(y, edges).astype(np.float64),
                 np.digitize(yv, edges).astype(np.float64))
        extra = {"num_class": 3}
    params = dict({"objective": objective, "boosting": "goss",
                   "learning_rate": 0.5, "top_rate": 0.2,
                   "other_rate": 0.1, "num_leaves": 15, "max_bin": 63,
                   "quantized_grad": q8}, **extra)
    _, bt = _train_both(params, X, y, Xv, yv)
    gb = bt._boosting
    assert type(gb).__name__ == "GOSS"
    # sampling starts at iteration int(1 / 0.5) = 2
    g, h = gb._gradients()
    w = gb._sample_weights(g, h)
    assert w is not None and int((w > 0).sum()) == 500 + 250


def test_goss_and_bagging_exclusive():
    with pytest.raises(Exception, match="bagging in GOSS"):
        lt.train({"objective": "binary", "boosting": "goss",
                  "bagging_fraction": 0.5, "bagging_freq": 1,
                  "device_type": "cpu", "verbosity": -1},
                 lt.Dataset(*_data(seed=46, n=300)[:1],
                            label=np.zeros(300)), 1)
