"""The PyTorch port's Booster surface against the JAX package's, on the CPU.

On the same data and parameters (2,000 rows, 15 leaves, at most 4 rounds):
train -> ``rollback_one_iter`` -> train (binary and 3-class) gives the JAX
package's model text bitwise, and the same tree count and valid
evaluations; ``refit`` of a plain model, ``shuffle_models`` twice in a row
and GOSS with custom gradients too. ``dump_model()`` (JSON),
``trees_to_dataframe()``, ``get_split_value_histogram``,
``lower_bound``/``upper_bound``/``get_leaf_output`` and ``eval(data, name,
feval)`` give equal structures; the refusals (rollback with sparse device
columns) carry the JAX messages. The port's Booster has every public
method of the JAX package's; ``free_network``/``set_network`` on a world
of one leave the process training alone; ``free_dataset`` drops every device tensor of the sets
and leaves prediction working.
"""

import inspect

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

torch.set_num_threads(1)

N, NV = 2000, 400


def _data(seed=0, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(N + NV, 6).astype(np.float32)
    X[:, 4] = rng.randint(0, 4, N + NV)
    z = X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * X[:, 4] + 0.3 * rng.randn(N + NV)
    y = np.digitize(z, [-0.5, 0.7]) if classes == 3 else z > 0
    return X, y.astype(np.float64)


def _params(lib, **extra):
    p = dict({"objective": "binary", "num_leaves": 15, "verbosity": -1},
             **extra)
    if lib is lt:
        p["device_type"] = "cpu"
    return p


def _trained(lib, rounds=4, seed=0, classes=2, **extra):
    X, y = _data(seed, classes)
    if classes == 3:
        extra = dict({"objective": "multiclass", "num_class": 3}, **extra)
    p = _params(lib, **extra)
    ds = lib.Dataset(X[:N], label=y[:N], params=dict(p))
    vs = lib.Dataset(X[N:], label=y[N:], reference=ds)
    b = lib.train(p, ds, rounds, valid_sets=[vs], valid_names=["v"])
    return b, X, y, vs


def test_booster_has_every_jax_method():
    public = {n for n, _ in inspect.getmembers(lj.Booster)
              if not n.startswith("_")}
    missing = sorted(n for n in public if not hasattr(lt.Booster, n))
    assert missing == []


@pytest.mark.parametrize("classes", [2, 3])
def test_rollback_then_train_matches(classes):
    out = []
    for lib in (lj, lt):
        b, X, y, vs = _trained(lib, rounds=3, classes=classes)
        b.rollback_one_iter()
        counts = (b.num_trees(), b.current_iteration())
        rolled = b.eval_valid()
        b.update()
        out.append((b.model_to_string(), counts, rolled, b.eval_valid()))
    (tj, cj, rj, ej), (tt, ct, rt, et) = out
    assert tt == tj
    assert ct == cj == (2 * (3 if classes == 3 else 1), 2)
    for a, b in ((rt, rj), (et, ej)):
        assert [r[:2] for r in a] == [r[:2] for r in b]
        np.testing.assert_allclose([r[2] for r in a], [r[2] for r in b],
                                   rtol=1e-12)


def test_rollback_scores_equal_a_shorter_run():
    """Rolled back to two iterations, the valid scores are a two-round
    run's within float32 rounding (the tree outputs come off one by one)."""
    b, X, y, vs = _trained(lt, rounds=3)
    b.rollback_one_iter()
    short, *_ = _trained(lt, rounds=2)
    np.testing.assert_allclose(b._boosting._valid_scores[0].numpy(),
                               short._boosting._valid_scores[0].numpy(),
                               rtol=0, atol=1e-6)
    assert b.model_to_string() == short.model_to_string()


def test_rollback_with_sparse_columns_raises_the_jax_message():
    msgs = []
    for lib in (lj, lt):
        X, y = _data(1)
        X[np.random.RandomState(2).rand(len(X)) < 0.95, 3] = 0.0
        p = _params(lib)
        b = lib.train(p, lib.Dataset(X[:N], label=y[:N], params=dict(p)), 2)
        with pytest.raises(Exception) as err:
            b.rollback_one_iter()
        msgs.append(str(err.value))
    assert msgs[1] == msgs[0] and "sparse" in msgs[1]


def test_refit_matches():
    out = []
    for lib in (lj, lt):
        b, X, y, vs = _trained(lib, rounds=4, objective="regression",
                               lambda_l1=0.5, max_delta_step=0.8)
        yr = X[:, 0] * 2.0 - X[:, 1]
        r = b.refit(X[N:], yr[N:], decay_rate=0.6)
        out.append((r.model_to_string(), r.predict(X[:200]),
                    r.num_trees()))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert out[1][2] == out[0][2] == 4


def test_refit_from_a_dataset_matches():
    out = []
    for lib in (lj, lt):
        b, X, y, vs = _trained(lib, rounds=3, classes=3)
        ds = lib.Dataset(X[N:], label=y[N:], free_raw_data=False,
                         params=_params(lib))
        out.append(b.refit(ds).model_to_string())
    assert out[1] == out[0]


def test_shuffle_models_twice_matches():
    out = []
    for lib in (lj, lt):
        b, X, y, vs = _trained(lib, rounds=4, classes=3)
        b.shuffle_models()
        first = b.model_to_string()
        b.shuffle_models(1, 4)
        out.append((first, b.model_to_string(), b.predict(X[N:])))
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1] != out[1][0]
    np.testing.assert_array_equal(out[1][2], out[0][2])


def test_goss_with_custom_gradients_matches():
    def fobj(score, ds):
        p = 1.0 / (1.0 + np.exp(-score))
        return p - ds.get_label(), p * (1.0 - p)
    texts = []
    for lib in (lj, lt):
        X, y = _data(3)
        p = _params(lib, boosting="goss", learning_rate=0.5)
        ds = lib.Dataset(X[:N], label=y[:N], params=dict(p))
        texts.append(lib.train(p, ds, 4, fobj=fobj).model_to_string())
    assert texts[1] == texts[0]


def test_dump_model_and_inspection_match():
    (bj, X, y, _), (bt, *_rest) = _trained(lj), _trained(lt)
    assert bt.dump_model() == bj.dump_model()
    assert bt.dump_model(num_iteration=2, start_iteration=1) == \
        bj.dump_model(num_iteration=2, start_iteration=1)
    fj, ft = bj.trees_to_dataframe(), bt.trees_to_dataframe()
    assert list(ft.columns) == list(fj.columns)
    assert ft.astype(str).equals(fj.astype(str))
    for feature in (0, "Column_1"):
        cj, ej = bj.get_split_value_histogram(feature)
        ct, et = bt.get_split_value_histogram(feature)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(et, ej)
    assert bt.lower_bound() == bj.lower_bound()
    assert bt.upper_bound() == bj.upper_bound()
    for tree, leaf in ((0, 0), (2, 5), (3, 1)):
        assert bt.get_leaf_output(tree, leaf) == bj.get_leaf_output(tree,
                                                                     leaf)
    assert bt.feature_name() == bj.feature_name()
    assert bt.num_feature() == bj.num_feature() == 6
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration() == 1


def test_eval_of_a_dataset_matches():
    def feval(score, ds):
        return "mean_score", float(np.mean(score)), True
    out = []
    for lib in (lj, lt):
        b, X, y, vs = _trained(lib, metric=["auc", "binary_logloss"])
        other = lib.Dataset(X[:300], label=y[:300],
                            reference=b._train_set)
        out.append((b.eval(other, "other", feval),
                    b.eval_train(feval), b.eval_valid(feval)))
    for a, b in zip(out[1], out[0]):
        assert [r[:2] + r[3:] for r in a] == [r[:2] + r[3:] for r in b]
        np.testing.assert_allclose([r[2] for r in a], [r[2] for r in b],
                                   rtol=1e-12)


def test_model_from_string_and_attributes():
    bt, X, *_ = _trained(lt, rounds=2)
    text = bt.model_to_string()
    other, *_ = _trained(lt, rounds=1, seed=5)
    other.model_from_string(text)
    assert other.model_to_string() == text
    np.testing.assert_array_equal(other.predict(X[:50]), bt.predict(X[:50]))
    bt.set_attr(stage="a", n=3)
    assert (bt.attr("stage"), bt.attr("n"), bt.attr("none")) == \
        ("a", "3", None)
    bt.set_attr(stage=None)
    assert bt.attr("stage") is None
    assert bt.set_train_data_name("train") is bt


def test_free_dataset_drops_the_device_tensors():
    b, X, y, vs = _trained(lt, rounds=2)
    ts = b._train_set
    before = b.predict(X[N:])
    b.free_dataset()
    assert ts.binsT is None and ts.sp_rows is None and ts.sp_cols is None
    assert ts.label is None and vs.binsT is None
    assert b._boosting.train_score is None
    assert b._boosting._valid_scores == []
    np.testing.assert_array_equal(b.predict(X[N:]), before)
    assert b.model_to_string().count("Tree=") == 2


@pytest.mark.parametrize("name", ["free_network", "set_network"])
def test_network_on_a_world_of_one(name):
    """``set_network`` with one machine and ``free_network`` leave the
    process alone (no gang), return the booster, and it trains on as
    before (a world of 2 is driven in test_torch_network.py's gang)."""
    from lightgbm_tpu_torch import distributed, network
    b, *_ = _trained(lt, rounds=1)
    text = b.model_to_string()
    args = (["127.0.0.1:12400"],) if name == "set_network" else ()
    assert getattr(b, name)(*args) is b
    assert not distributed.is_initialized()
    assert network.current().world == 1
    b.update()
    assert b.model_to_string() != text and b.current_iteration() == 2
