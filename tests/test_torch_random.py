"""The JAX package's random numbers in plain torch
(lightgbm_tpu_torch/utils/random.py) against ``jax.random`` itself, bit for
bit: ``PRNGKey``, ``fold_in`` (the quantized-gradient mode's 0x5138 and the
per-tree ``iter * k + c``) and ``uniform`` at the shapes the grower draws
(``[N, 3]``) and others. A wrong counter layout still gives uniforms that
look fine, so only a bitwise comparison catches it.
"""

import numpy as np
import pytest

import jax
import torch

from lightgbm_tpu_torch.utils import random as tr

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)


def _key_np(key):
    return np.asarray(jax.random.key_data(key)
                      if jax.dtypes.issubdtype(key.dtype,
                                               jax.dtypes.prng_key)
                      else key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 6, 42, 2 ** 31 - 1, -1, -5,
                                  2 ** 32 + 3])
def test_prng_key(seed):
    np.testing.assert_array_equal(tr.prng_key(seed).numpy(),
                                  _key_np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 7, 0x5138, 2 ** 31 + 5,
                                  2 ** 32 - 1])
@pytest.mark.parametrize("seed", [6, 12])
def test_fold_in(seed, data):
    np.testing.assert_array_equal(
        tr.fold_in(tr.prng_key(seed), data).numpy(),
        _key_np(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_fold_in_chain_of_the_grower():
    """The key of tree ``iter * k + c`` (models/gbdt.py) and its 0x5138
    rounding draw (models/grower.py), for the first iterations."""
    jk, tk = jax.random.PRNGKey(6), tr.prng_key(6)
    for it in range(5):
        a = jax.random.fold_in(jax.random.fold_in(jk, it), 0x5138)
        b = tr.fold_in(tr.fold_in(tk, it), 0x5138)
        np.testing.assert_array_equal(b.numpy(), _key_np(a))


@pytest.mark.parametrize("shape", [(7,), (1000, 3), (4097, 3), (5, 4, 3),
                                   (1,), (0, 3)])
def test_uniform_bitwise(shape):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(6), 3),
                            0x5138)
    tk = tr.fold_in(tr.fold_in(tr.prng_key(6), 3), 0x5138)
    a = np.asarray(jax.random.uniform(jk, shape))
    b = tr.uniform(tk, shape).numpy()
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))
    assert b.size == 0 or (b.min() >= 0.0 and b.max() < 1.0)


def test_uniform_large_draw():
    """The grower's [N, 3] draw at 300,000 rows (counters past 2^20)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(11), 0x5138)
    tk = tr.fold_in(tr.prng_key(11), 0x5138)
    a = np.asarray(jax.random.uniform(jk, (300_000, 3)))
    b = tr.uniform(tk, (300_000, 3)).numpy()
    np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) test vector of the Random123 suite:
    key (0x13198a2e, 0x03707344), counter (0x243f6a88, 0x85a308d3) ->
    (0xc4923a9c, 0x483df7a0)."""
    y1, y2 = tr.threefry2x32(0x13198a2e, 0x03707344,
                             torch.tensor([0x243f6a88]),
                             torch.tensor([0x85a308d3]))
    assert (int(y1), int(y2)) == (0xc4923a9c, 0x483df7a0)
