"""Bins past 4,096 a feature in the PyTorch port against the JAX package on
the CPU.

The port stores up to 32,768 bins a column as int16 and more (up to
65,536: ``max_bin`` 65,535 and a NaN bin) as int32; the JAX package stores
every wide bin as int32. Its kernels split a feature's bins across blocks
past one block's shared memory and its wide epilogue scans in four levels
past 4,096 bins (held to their plain versions on the card:
tests/test_torch_cuda.py, ``chip_smoke.py --only widebins``). Here,
bitwise:

- the plain histogram forms (``hist_tile_plain``, ``hist_tile_exact``, the
  integer planes of ``raw`` through ``hist_convert_plain``,
  ``full_accumulate_plain``) at B = 4,097 against the interpreted Pallas
  kernels, and at B = 40,000 against the JAX scatter histogram, f32 and
  q8, full and gather, on representable sums;
- ``split_epilogue_plain`` at B = 6,000 and 40,000, unconstrained and
  monotone, f32 and q8, against the JAX ``_epilogue_compute`` on the
  kernel's lane layout;
- end to end at ``max_bin`` 6,000 and 40,000 (bins past 32,767): the bin
  matrix, the ``model_to_string()`` text and ``predict`` equal to
  ``lightgbm_tpu``'s;
- ``max_bin`` 65,535 with NaNs (65,535 bins) and the cap, 65,536 bins (a
  per-feature max_bin of 65,536 with NaNs): equal to the JAX bins.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import pallas_hist as jph
from lightgbm_tpu.ops.histogram import compact_indices as j_compact
from lightgbm_tpu.ops.histogram import histogram_tiles as j_tiles
from lightgbm_tpu_torch.ops import cuda_hist

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

SEL = np.array([0, 2, 5, 7, 9, 11, -1, -1], np.int32)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


def _mk(n, f, b, q8, seed):
    """Bins over the whole range (half of them uniform, half skewed low),
    in the dataset's dtype for ``b``; stats that are multiples of 2^-10
    (f32: exact sums in any order) or int8."""
    rng = np.random.RandomState(seed)
    u = rng.rand(f, n)
    u[:, 1::2] **= 3
    dt = np.int16 if b <= 32768 else np.int32
    binsT = np.minimum((u * b).astype(np.int64), b - 1).astype(dt)
    if q8:
        stats = rng.randint(-127, 128, size=(n, 3)).astype(np.int8)
        stats[:, 2] = 1
    else:
        stats = (rng.randint(-1023, 1024, size=(n, 3)) / 1024.0
                 ).astype(np.float32)
        stats[:, 2] = 1.0
    leaf = rng.randint(0, 12, n).astype(np.int32)
    return binsT, stats, leaf


def _jax_planes(binsT, stats, leaf, sel, b, idx, q8):
    """The JAX reference planes: the interpreted Pallas kernels up to
    4,097 bins, the scatter histogram (float32, exact here) past them."""
    jb = jnp.asarray(binsT.astype(np.int32))
    ji = None if idx is None else jnp.asarray(idx)
    if b <= 4097:
        return np.asarray(jph.histogram_tiles_pallas_mode(
            jb, jnp.asarray(stats), jnp.asarray(leaf), jnp.asarray(sel), b,
            block=512, mode="q8" if q8 else "highest", idx=ji,
            interpret=True))
    out = np.asarray(j_tiles(
        jb.T, jnp.asarray(stats.astype(np.float32)), jnp.asarray(leaf),
        jnp.asarray(sel), b, method="scatter", gather_idx=ji))
    return out.astype(np.int32) if q8 else out


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("gather", [False, True], ids=["full", "gather"])
@pytest.mark.parametrize("b", [4097, 40000])
def test_plain_forms_match_jax(b, gather, q8):
    n, f = 1200, 3
    binsT, stats, leaf = _mk(n, f, b, q8, seed=b + gather)
    idx = None
    if gather:
        keep = np.random.RandomState(4).rand(n) < 0.3
        idx = np.asarray(j_compact(jnp.asarray(keep), int(keep.sum()) + 9))
    ref = _jax_planes(binsT, stats, leaf, SEL, b, idx, q8)
    tb, ts, tl = map(torch.from_numpy, (binsT, stats, leaf))
    ti = None if idx is None else torch.from_numpy(idx.copy())
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(SEL))
    out = cuda_hist.hist_tile_plain(tb, tl, ts, chan, 8, b, 12, ti)
    _bits(out.numpy(), ref, "hist_tile_plain")
    if q8:
        assert out.dtype == torch.int32
        return
    m = n if ti is None else ti.shape[0]
    _bits(cuda_hist.hist_tile_exact(tb, tl, ts, chan, 8, b, 12, ti).numpy(),
          ref, "hist_tile_exact")
    # the integer-planes mode: int64 sums at a gang's exponent, converted
    amax = torch.from_numpy(np.abs(stats).max(0))
    raw = cuda_hist.hist_tile_exact(tb, tl, ts, chan, 8, b, 12, ti, amax,
                                    rows=3 * m, raw=True)
    assert raw.dtype == torch.int64
    _bits(cuda_hist.hist_convert_plain(raw, amax, 3 * m).numpy(), ref,
          "raw + hist_convert_plain")
    if not gather:
        one = np.array([5, -1, -1, -1, -1, -1, -1, -1], np.int32)
        ref1 = _jax_planes(binsT, stats, leaf, one, b, None, False)
        chan1 = cuda_hist.chan_leaf_table(torch.from_numpy(one))
        _bits(cuda_hist.full_accumulate_plain(tb, tl, ts, chan1, 8, b,
                                              12).numpy(), ref1,
              "full_accumulate_plain")


def _lanes(x, p, f, b):
    """[P, F, B, 3] -> the kernel's [F * B, 128] lane layout."""
    out = np.zeros((f * b, 128), np.float32)
    out[:, :p * 3] = np.asarray(x, np.float32).transpose(1, 2, 0, 3).reshape(
        f * b, p * 3)
    return out


@pytest.mark.parametrize("mono", [False, True], ids=["free", "monotone"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("b", [6000, 40000])
def test_split_epilogue_plain_matches_jax(b, q8, mono):
    """``split_epilogue_plain`` past 4,096 bins (XLA's cumulative sum in
    four levels) bitwise the JAX ``_epilogue_compute`` on the same planes:
    the full planes and the candidate table."""
    p, f = 4, 3
    rng = np.random.RandomState(b + 2 * q8 + mono)
    derive = np.array([False, True, False, True])
    cnt = rng.randint(0, 6, (p, f, b)) * (rng.rand(p, f, b) < 0.3)
    plane = np.stack([rng.randint(-4, 5, (p, f, b)) * cnt,
                      rng.randint(1, 4, (p, f, b)) * cnt, cnt], -1)
    tile = np.where(derive[:, None, None, None], 0, plane)
    sib = np.concatenate([np.zeros_like(tile[:1]), tile[:-1]])
    q_scale = np.array([0.0173, 0.00291, 1.0], np.float32)
    scale = q_scale if q8 else np.ones(3, np.float32)
    parent = np.where(derive[:, None, None, None],
                      (plane + sib).astype(np.float32) * scale, 0
                      ).astype(np.float32)
    tile_t = (torch.from_numpy(tile.astype(np.int32)) if q8
              else torch.from_numpy(tile.astype(np.float32)))
    tot = (plane.astype(np.float32) * scale)[:, 0].sum(1)
    la = cuda_hist.pack_leaf_aux(
        *(torch.from_numpy(tot[:, i].copy()) for i in range(3)),
        torch.from_numpy((-0.1 * tot[:, 0] / (tot[:, 1] + 1)).astype(
            np.float32)),
        *((torch.full((p,), -0.05), torch.full((p,), 0.05)) if mono
          else (None, None)))
    fm = cuda_hist.pack_feature_meta(
        torch.tensor([b, b - 300, b - 23], dtype=torch.int32),
        torch.tensor([0, 2, 1], dtype=torch.int32),
        torch.tensor([0, 0, b // 3], dtype=torch.int32),
        torch.tensor([1, -1, 0] if mono else [0, 0, 0], dtype=torch.int32))
    pv = torch.tensor([0.0, 1.0, 0.0, 0.0, 2.0, 1e-3, 0.0, 0.0])
    der = cuda_hist._epilogue_lanes(torch.arange(p, dtype=torch.int32),
                                    torch.from_numpy(derive))
    qs = torch.from_numpy(q_scale) if q8 else None
    full, cand = cuda_hist.split_epilogue_plain(
        tile_t, torch.from_numpy(parent), der, la, fm, pv, qs,
        with_monotone=mono)
    qlane = np.ones((1, 128), np.float32)
    qlane[0, :p * 3] = np.tile(q_scale, p)
    jfull, jcand = jph._epilogue_compute(
        jnp.asarray(_lanes(tile, p, f, b) if not q8 else
                    _lanes(tile, p, f, b).astype(np.int32)),
        jnp.asarray(_lanes(parent, p, f, b)), jnp.asarray(der.numpy()),
        jnp.asarray(qlane), jnp.asarray(la.numpy()), jnp.asarray(fm.numpy()),
        jnp.asarray(pv.numpy()[:7]), f=f, b=b, p=p, s=3,
        mode="q8" if q8 else "highest", with_monotone=mono)
    _bits(_lanes(full.numpy(), p, f, b)[:, :p * 3],
          np.asarray(jfull)[:, :p * 3], "planes")
    _bits(cand.numpy(), jcand, "candidates")
    assert np.isfinite(cand.numpy()[..., 0]).any()


def _data(n=50_000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 3)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) * 0.5 + rng.randn(n) * 0.3
         > 0).astype(float)
    return X, y


@pytest.mark.parametrize("max_bin", [6000, 40000])
def test_training_bitwise_past_4096_bins(max_bin):
    """``train({"objective": "binary"})`` at max_bin 6,000 (int16 bins) and
    40,000 (int32: bins past 32,767): the bins widened to int32, the model
    text and predict equal to the JAX package's."""
    X, y = _data()
    p = {"objective": "binary", "num_leaves": 15, "max_bin": max_bin,
         "min_data_in_bin": 1, "verbosity": -1}
    dj = lj.Dataset(X, label=y)
    bj = lj.train(dict(p), dj, 3)
    dt = lt.Dataset(X, label=y, params=dict(p, device_type="cpu"))
    bt = lt.train(dict(p, device_type="cpu"), dt, 3)
    ts = bt._boosting.train_set
    assert ts.binsT.dtype == (torch.int16 if max_bin <= 32768
                              else torch.int32)
    assert int(ts.binsT.max()) > (4096 if max_bin < 32768 else 32767)
    np.testing.assert_array_equal(
        ts.binsT.to(torch.int32).numpy().T,
        np.asarray(dj.bins).astype(np.int32))
    assert bt.model_to_string() == bj.model_to_string()
    np.testing.assert_array_equal(bt.predict(X), bj.predict(X))


@pytest.mark.parametrize("params,bins", [
    ({"max_bin": 65535}, 65535),
    ({"max_bin_by_feature": [65536]}, 65536)], ids=["max_bin", "cap"])
def test_the_bin_types_edge_constructs(params, bins):
    """The edge of the bin types: max_bin 65,535 with NaNs (65,534 value
    bins and a NaN bin, as the reference counts them) and the cap itself,
    65,536 bins (a per-feature max_bin of 65,536 with NaNs), construct
    int32 bins equal to the JAX package's."""
    n = 70_000
    X = np.random.RandomState(1).permutation(n).astype(np.float64)
    X[::97] = np.nan
    X = X.reshape(-1, 1)
    y = np.sin(np.nan_to_num(X[:, 0]) / 100.0)
    p = dict(params, min_data_in_bin=1, verbosity=-1,
             bin_construct_sample_cnt=n)
    dt = lt.Dataset(X, label=y, params=dict(p, device_type="cpu"))
    dt.construct()
    assert dt.max_num_bins == bins and dt.binsT.dtype == torch.int32
    assert int(dt.binsT.max()) == bins - 1
    dj = lj.Dataset(X, label=y, params=dict(p))
    dj.construct()
    np.testing.assert_array_equal(
        dt.binsT.to(torch.int32).numpy().T,
        np.asarray(dj.bins).astype(np.int32))
