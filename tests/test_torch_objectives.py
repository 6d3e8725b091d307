"""The PyTorch port's float32 ``exp`` and output conversion against the JAX
package on the CPU.

- ``objectives.exp_f32`` writes XLA:CPU's float32 ``exp`` out in PyTorch
  operations. It matched ``jnp.exp`` on every finite float32 in
  [-88.7, 88.7] (2,237,844,686 values, none differing); a seeded sample of
  10^6 values over that range, the extremes, the specials and the flush to
  zero below FLT_MIN is pinned here bitwise.
- Binary gradients and hessians, built on it, are bitwise the JAX
  package's (``BinaryLogloss.get_grad_hess``, eager and as its fused step
  compiles it), with weights and a sigmoid other than 1 too; results below
  FLT_MIN flush to zero as XLA:CPU flushes them.
- Converted predictions: the JAX package casts the raw float64 scores to
  float32 before ``convert_output``; the port does the same and returns
  float32, bitwise equal for both objectives.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu_torch import objectives as tobj

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _exp_inputs():
    rng = np.random.RandomState(20261017)
    x = rng.uniform(-88.7, 88.7, 1_000_000).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-30, -1e-30, 88.7, -88.7, 88.37626,
                      88.72283, 88.72284, -87.33654, -87.33655, -87.3366,
                      -103.9, -104.0, 100.0, np.inf, -np.inf, np.nan,
                      np.finfo(np.float32).max, -np.finfo(np.float32).max],
                     np.float32)
    return np.concatenate([x, edges])


def test_exp_f32_bitwise_on_a_seeded_sample():
    x = _exp_inputs()
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = tobj.exp_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("params", [
    {}, {"sigmoid": 1.7, "scale_pos_weight": 2.5},
    {"is_unbalance": True}], ids=["default", "sigmoid_weighted", "unbalanced"])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_gradients_bitwise(params, weighted):
    rng = np.random.RandomState(3)
    n = 200_000
    score = (rng.randn(n) * 4).astype(np.float32)
    score[:7] = [0.0, -0.0, 30.0, -30.0, 88.0, -88.0, 1e-8]
    label = (rng.rand(n) < 0.35).astype(np.float64)
    w = rng.rand(n) + 0.25 if weighted else None
    oj = jobj.BinaryLogloss(lj.Config.from_params(
        dict(params, objective="binary")))
    ot = tobj.BinaryLogloss(lt.Config.from_params(
        dict(params, objective="binary", device_type="cpu")))
    oj.init(label, w)
    ot.init(label, w)

    def step(consts, s):
        # the JAX package's fused step passes the label arrays as operands
        with oj.bound(consts):
            return oj.get_grad_hess(s)

    tg, th = ot.get_grad_hess(torch.from_numpy(score))
    for jg, jh in (oj.get_grad_hess(jnp.asarray(score)),
                   jax.jit(step)(oj.device_consts(), jnp.asarray(score))):
        np.testing.assert_array_equal(_bits(tg.numpy()), _bits(jg))
        np.testing.assert_array_equal(_bits(th.numpy()), _bits(jh))


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_converted_predictions_like_jax(objective):
    """Repair of the float64 conversion: raw scores go to float32 first."""
    rng = np.random.RandomState(5)
    X = rng.randn(2000, 4).astype(np.float32)
    y = X[:, 0] - 0.5 * X[:, 1] + 0.2 * rng.randn(2000)
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63,
              "verbosity": -1}
    bj = lj.train(dict(params), lj.Dataset(X, label=y), 5)
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y), 5)
    Xt = rng.randn(700, 4).astype(np.float32)
    np.testing.assert_array_equal(bt.predict(Xt, raw_score=True),
                                  bj.predict(Xt, raw_score=True))
    pj, pt = bj.predict(Xt), bt.predict(Xt)
    assert pt.dtype == pj.dtype == np.float32
    np.testing.assert_array_equal(_bits(pt), _bits(pj))
    # a model loaded from text converts the same way
    loaded = lt.Booster(model_str=bt.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_array_equal(_bits(loaded.predict(Xt)), _bits(pj))
