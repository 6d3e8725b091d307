"""The thread-block cluster forms past one block's plane, on the CPU.

Past what one block's shared memory holds (about 8,400 bins a feature in
f32), ``hist_tile`` holds a feature's [B, 3] plane in the pooled shared
memory of a cluster of CTAs, CTA k owning a contiguous bin range. The
kernels run only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py --only redesign``); here,
bitwise:

- the cluster decomposition's plain version (``cluster_accumulate_plain``:
  the rows shared among a cluster's CTAs, each bin added at its owner's
  range, the flush) against ``hist_tile_exact`` and the JAX package's
  scatter histogram, at B = 8,191, 16,383 and 65,535, the full and the
  gather form, f32, q8 and the integer planes;
- the shape functions: the CTAs a cluster and the bins a CTA
  (``bin_ranges``), the cluster rows that fill whole waves
  (``cluster_rows``), a card that cannot place the cluster refused by
  name (``cluster_wave``);
- ``traffic_model``'s count of the cluster form (rows read once a
  feature, not once a bin range).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops.histogram import compact_indices as j_compact
from lightgbm_tpu.ops.histogram import histogram_tiles as j_tiles
from lightgbm_tpu_torch.ops import cuda_hist

torch.set_num_threads(1)

SEL = np.array([0, 2, 5, 7, 9, 11, -1, -1], np.int32)
ROOT = np.array([5, -1, -1, -1, -1, -1, -1, -1], np.int32)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


def _mk(n, f, b, q8, seed):
    """Bins over the whole range (half uniform, half skewed low) in the
    dataset's dtype for ``b``; stats that are multiples of 2^-10 (f32:
    exact sums in any order) or int8."""
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


@pytest.mark.parametrize("mode", ["f32", "q8", "raw"])
@pytest.mark.parametrize("gather", [False, True], ids=["full", "gather"])
@pytest.mark.parametrize("b", [8191, 16383, 65535])
def test_cluster_plain_matches_exact_and_jax(b, gather, mode):
    """Three cluster row ranges of CTAs of 512 threads (so the readers
    and the owners differ), the root pass (one computed slot) or a rung
    of six: bitwise ``hist_tile_exact`` and the JAX scatter histogram;
    the integer planes (at a gang's exponent) bitwise the exact int64
    sums and, converted, the JAX planes."""
    n, f = 1500, 3
    q8 = mode == "q8"
    binsT, stats, leaf = _mk(n, f, b, q8, seed=b + gather)
    sel = SEL if gather else ROOT
    idx = None
    if gather:
        keep = np.random.RandomState(4).rand(n) < 0.4
        idx = np.asarray(j_compact(jnp.asarray(keep), int(keep.sum()) + 9))
    ref = np.asarray(j_tiles(
        jnp.asarray(binsT.astype(np.int32)).T,
        jnp.asarray(stats.astype(np.float32)), jnp.asarray(leaf),
        jnp.asarray(sel), b, method="scatter",
        gather_idx=None if idx is None else jnp.asarray(idx)))
    tb, ts, tl = map(torch.from_numpy, (binsT, stats, leaf))
    ti = None if idx is None else torch.from_numpy(idx.copy())
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(sel))
    kw = dict(ygrid=3, threads=512)
    if q8:
        out = cuda_hist.cluster_accumulate_plain(tb, tl, ts, chan, 8, b, 12,
                                                 ti, **kw)
        assert out.dtype == torch.int32
        _bits(out.numpy(), ref.astype(np.int32), "q8")
        return
    if mode == "f32":
        out = cuda_hist.cluster_accumulate_plain(tb, tl, ts, chan, 8, b, 12,
                                                 ti, **kw)
        _bits(out.numpy(), ref, "cluster vs JAX")
        _bits(out.numpy(), cuda_hist.hist_tile_exact(
            tb, tl, ts, chan, 8, b, 12, ti).numpy(), "cluster vs exact")
        return
    m = n if ti is None else ti.shape[0]
    amax = torch.from_numpy(np.abs(stats).max(0))
    raw = cuda_hist.cluster_accumulate_plain(tb, tl, ts, chan, 8, b, 12, ti,
                                             amax, rows=3 * m, raw=True, **kw)
    assert raw.dtype == torch.int64
    assert torch.equal(raw, cuda_hist.hist_tile_exact(
        tb, tl, ts, chan, 8, b, 12, ti, amax, rows=3 * m, raw=True))
    _bits(cuda_hist.hist_convert_plain(raw, amax, 3 * m).numpy(), ref,
          "raw + convert vs JAX")


def test_the_cpu_kernel_sums_take_the_cluster_decomposition(monkeypatch):
    """Inside ``kernel_sums_on_cpu`` a full pass past one block's plane
    sums through the cluster form's plain version."""
    seen = []
    keep = cuda_hist.cluster_accumulate_plain
    monkeypatch.setattr(cuda_hist, "cluster_accumulate_plain",
                        lambda *a, **k: seen.append(1) or keep(*a, **k))
    binsT, stats, leaf = _mk(700, 2, 16383, False, 3)
    tb, ts, tl = map(torch.from_numpy, (binsT, stats, leaf))
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(ROOT))
    with cuda_hist.kernel_sums_on_cpu():
        out = cuda_hist.hist_tile(tb, tl, ts, chan, 8, 16383, 12)
    assert seen == [1]
    _bits(out.numpy(), cuda_hist.hist_tile_exact(tb, tl, ts, chan, 8, 16383,
                                                 12).numpy())


@pytest.mark.parametrize("b,q8,full,shape", [
    (8191, False, True, (8191, 1)), (16383, False, True, (8192, 2)),
    (16384, False, True, (8192, 2)), (65535, True, True, (16384, 4)),
    (65536, False, True, (8192, 8)), (65535, False, False, (9363, 7)),
    (16383, True, False, (16383, 1))])
def test_cluster_shape(b, q8, full, shape):
    """The CTAs of the cluster that holds a feature's plane and the bins
    each owns: as few as hold it, at most MAX_CLUSTER, the last one
    holding at least one bin."""
    span, cluster = cuda_hist.bin_ranges(b, q8, full)
    assert (span, cluster) == shape
    assert 1 <= cluster <= cuda_hist.MAX_CLUSTER
    assert span * cluster >= b > span * (cluster - 1)
    f = 5
    assert cuda_hist.launch_shape(f, b, q8, full,
                                  cuda_hist.DEFAULT_GEOMETRY) == (
        (1 if cluster > 1 else cuda_hist._group(f, b, q8, full, 1024)),
        span, cluster)


@pytest.mark.parametrize("f,wave,rows", [(28, 66, 2), (28, 16, 1),
                                         (28, 33, 1), (4, 66, 33),
                                         (28, 132, 9), (1, 8, 8)])
def test_cluster_rows_fill_whole_waves(f, wave, rows):
    """The row ranges a feature's clusters take: the grid of f x rows
    clusters uses the largest share of its waves' slots, the fewest
    ranges on a tie, within two waves."""
    assert cuda_hist.cluster_rows(f, wave) == rows
    share = lambda y: f * y / (-(-f * y // wave) * wave)
    most = max(1, -(-2 * wave // f))
    assert share(rows) == max(share(y) for y in range(1, most + 1))
    with pytest.raises(ValueError):
        cuda_hist.cluster_rows(f, 0)


def test_a_card_that_cannot_place_the_cluster_is_refused(monkeypatch):
    """Zero active clusters: the wrapper raises and names the shape; no
    other form stands in."""
    class Lib:
        def hist_cluster_occupancy(self, full, q8, bin_bytes, cluster, span,
                                   threads, out):
            out._obj.value = 0
            return 0
    monkeypatch.setattr(cuda_hist, "_waves", {})
    with pytest.raises(RuntimeError, match="cluster of 8 CTAs of 1024 "
                                           "threads and 8192 bins"):
        cuda_hist.cluster_wave(Lib(), True, False, 4, 8, 8192, 1024)


def test_traffic_model_counts_the_cluster_form():
    """At 65,535 bins in f32 (8 CTAs a cluster in the full form, 7 in the
    gather form) each row's leaf and stats are read once a feature and
    every row's bins once; the payload once a feature."""
    n, f, b, p, m, t = 2_000_000, 28, 65535, 42, 1_000_000, 900_000
    tm = cuda_hist.traffic_model(n, f, b, p, gathered_rows=m, tile_rows=t,
                                 bin_bytes=4)
    sums, planes = f * b * 3 * 8, p * f * b * 3 * 4
    assert (tm["cluster"], tm["gather_cluster"]) == (8, 7)
    assert tm["full_kernels"] == f * n * 16 + n * f * 4 + 2 * sums + planes
    active = sums * (p // 2)
    assert tm["gather_kernels"] == (8 * m + 8 * m + t * 12 + t * 32
                                    + f * t * 32 + t * f * 4 + 2 * active
                                    + planes)
    # q8 at 16,383 bins: one block's plane, the rows read once a group
    q = cuda_hist.traffic_model(n, f, 16383, p, mode="q8", bin_bytes=2)
    assert q["cluster"] == 1
    assert q["full_kernels"] == (-(-f // cuda_hist._group(
        f, 16383, True, True, 1024)) * n * 7 + n * f * 2
        + 2 * f * 16383 * 3 * 4 + p * f * 16383 * 3 * 4)
