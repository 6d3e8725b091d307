"""Histogram tile pass of the PyTorch port (lightgbm_tpu_torch/ops/cuda_hist.py
and ops/histogram.py) against the JAX package.

The port's ``hist_tile_plain`` (the plain version of the Hopper ``hist_tile``
kernel, and the CPU path of the ``hist_tile`` wrapper) is held to:

- the JAX Pallas kernel ``histogram_tiles_pallas_mode(mode="highest")`` run
  through the Pallas interpreter, full-row and gather forms: bitwise on
  integer-valued stats, whose sums are exact in any order (the JAX package's
  parity contract);
- the JAX ``histogram_scatter`` on full-mantissa float stats: bitwise (one
  flat scatter-add in row order on both sides);

plus the argument-layout tables the kernels take, which must equal the JAX
package's one to one. In the quantized-gradient (q8) mode the int32 planes
of int8 stats are held bitwise to the interpreted Pallas kernel in
``mode="q8"`` and to its XLA twin ``onehot_q8``, the dequantizing
``derive_and_scan`` and the whole fused q8 pass to the JAX package's, and
the classic tile pass's int32 ``combine_sparse`` to the JAX grower's. The
kernel itself needs the card: it is held to its plain version by
tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lightgbm_tpu.ops import pallas_hist as jph
from lightgbm_tpu.ops.histogram import compact_indices as j_compact
from lightgbm_tpu.ops.histogram import histogram_scatter
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops.histogram import (compact_indices,
                                              histogram_tiles, resolve_method)
from torch_epilogue_cases import (EDGE_BINS, EDGE_CASES, PV_DEFAULT,
                                  epilogue_case)

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

SEL = np.array([0, 2, 5, 7, 9, 11, -1, -1], np.int32)


def _mk(n, f, b, n_leaves=12, seed=0, representable=True):
    rng = np.random.RandomState(seed)
    binsT = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    if representable:
        stats = (rng.randint(-1023, 1024, size=(n, 3)) / 1024.0
                 ).astype(np.float32)
    else:
        stats = rng.randn(n, 3).astype(np.float32)
    stats[:, 2] = 1.0
    leaf = rng.randint(0, n_leaves, n).astype(np.int32)
    return binsT, stats, leaf


def _port_tile(binsT, stats, leaf, sel, b, n_leaves, idx=None):
    return histogram_tiles(
        torch.from_numpy(binsT), torch.from_numpy(stats),
        torch.from_numpy(leaf), torch.from_numpy(sel), b, n_leaves,
        None if idx is None else torch.from_numpy(idx)).numpy()


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("n,f,b", [(1000, 3, 63), (1537, 4, 16),
                                   (700, 2, 255)])
def test_full_form_matches_pallas_highest(n, f, b):
    binsT, stats, leaf = _mk(n, f, b)
    ref = jph.histogram_tiles_pallas_mode(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(SEL), b, block=512, mode="highest", interpret=True)
    _bits_equal(_port_tile(binsT, stats, leaf, SEL, b, 12), ref)


@pytest.mark.parametrize("keep_frac,size_pad", [(0.5, 0), (0.125, 37)])
def test_gather_form_matches_pallas_highest(keep_frac, size_pad):
    n, f, b = 1300, 3, 63
    binsT, stats, leaf = _mk(n, f, b, seed=1)
    rng = np.random.RandomState(2)
    keep = rng.rand(n) < keep_frac
    size = int(keep.sum()) + size_pad       # padded with N
    idx = np.asarray(j_compact(jnp.asarray(keep), size))
    ref = jph.histogram_tiles_pallas_mode(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(SEL), b, block=256, mode="highest",
        idx=jnp.asarray(idx), interpret=True)
    _bits_equal(_port_tile(binsT, stats, leaf, SEL, b, 12, idx), ref)


@pytest.mark.parametrize("n_leaves", [4, 31])
def test_plain_matches_histogram_scatter_on_float_stats(n_leaves):
    n, f, b = 4000, 5, 63
    binsT, stats, leaf = _mk(n, f, b, n_leaves=n_leaves, seed=3,
                             representable=False)
    ref = histogram_scatter(jnp.asarray(binsT.T), jnp.asarray(stats),
                            jnp.asarray(leaf), n_leaves, b)
    sel = np.arange(n_leaves, dtype=np.int32)
    _bits_equal(_port_tile(binsT, stats, leaf, sel, b, n_leaves), ref)


def test_compact_indices_match():
    keep = np.random.RandomState(4).rand(999) < 0.3
    size = int(keep.sum()) + 11
    np.testing.assert_array_equal(
        compact_indices(torch.from_numpy(keep), size).numpy(),
        np.asarray(j_compact(jnp.asarray(keep), size)))


@pytest.mark.parametrize("derive", [[0, 1, 0, 1, 0, 0, 0, 0],
                                    [0, 0, 0, 0, 0, 0, 0, 0]])
def test_lane_tables_match(derive):
    derive = np.asarray(derive, bool)
    sel = torch.from_numpy(SEL)
    np.testing.assert_array_equal(
        cuda_hist.chan_leaf_table(sel).numpy(),
        np.asarray(jph.chan_leaf_table(jnp.asarray(SEL), 3)))
    dl, _ = jph._epilogue_lanes(jnp.asarray(SEL), jnp.asarray(derive), 3)
    np.testing.assert_array_equal(
        cuda_hist._epilogue_lanes(sel, torch.from_numpy(derive)).numpy(),
        np.asarray(dl))


def test_pack_tables_match():
    rng = np.random.RandomState(5)
    cols = [rng.randn(6).astype(np.float32) for _ in range(4)]
    _bits_equal(cuda_hist.pack_leaf_aux(*map(torch.from_numpy, cols)),
                jph.pack_leaf_aux(*map(jnp.asarray, cols)))
    meta = [np.array([63, 2, 17], np.int32), np.array([0, 2, 1], np.int32),
            np.array([3, 0, 5], np.int32), np.zeros(3, np.int32)]
    _bits_equal(cuda_hist.pack_feature_meta(*map(torch.from_numpy, meta)),
                jph.pack_feature_meta(*map(jnp.asarray, meta)))
    assert cuda_hist.structural_tile_leaves() == jph.structural_tile_leaves()


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    binsT, stats, leaf = _mk(500, 2, 15, seed=6)
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(SEL))
    cuda_hist.reset_launch_counts()
    args = (torch.from_numpy(binsT), torch.from_numpy(leaf),
            torch.from_numpy(stats), chan, len(SEL), 15, 12)
    out = cuda_hist.hist_tile(*args)
    _bits_equal(out.numpy(), cuda_hist.hist_tile_plain(*args).numpy())
    assert cuda_hist.hist_tile.launches == 0


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    meta = torch.empty((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_hist.hist_tile(meta, torch.empty(8, dtype=torch.int32),
                            torch.empty(8, 3), torch.empty(1, 128,
                                                           dtype=torch.int32),
                            1, 4, 2)


@pytest.mark.parametrize("method,device,want", [
    ("auto", "cpu", "plain"), ("pallas", "cpu", "plain"),
    ("pallas_hilo", "cuda", "cuda"), ("auto", "cuda", "cuda")])
def test_resolve_method(method, device, want):
    assert resolve_method(method, torch.device(device)) == want


@pytest.mark.parametrize("method,device,quantized,want", [
    ("auto", "cpu", True, "plain_q8"), ("pallas", "cuda", True, "cuda_q8"),
    ("pallas_hilo", "cpu", True, "plain_q8"),
    ("pallas_q8", "cpu", False, "plain_q8"),
    ("pallas_q8", "cuda", False, "cuda_q8"),
    ("pallas_q8", "cuda", True, "cuda_q8")])
def test_resolve_method_q8(method, device, quantized, want):
    assert resolve_method(method, torch.device(device), quantized) == want


@pytest.mark.parametrize("method", ["scatter", "onehot", "onehot_q8"])
def test_resolve_method_rejects_unported(method):
    with pytest.raises(NotImplementedError, match=method):
        resolve_method(method, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=method):
        resolve_method(method, torch.device("cpu"), True)


# -------------------------------------------------- the kernel's arithmetic
@pytest.mark.parametrize("gather", [False, True])
def test_exact_form_matches_pallas_on_integer_stats(gather):
    """hist_tile_exact (the kernel's fixed-point sums in plain PyTorch) is
    exact on representable stats: bitwise the interpreted Pallas kernel."""
    n, f, b = 1400, 3, 31
    binsT, stats, leaf = _mk(n, f, b, seed=8)
    idx = None
    if gather:
        keep = np.random.RandomState(9).rand(n) < 0.4
        idx = np.asarray(j_compact(jnp.asarray(keep), int(keep.sum()) + 9))
    ref = jph.histogram_tiles_pallas_mode(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(SEL), b, block=256, mode="highest",
        idx=None if idx is None else jnp.asarray(idx), interpret=True)
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(SEL))
    out = cuda_hist.hist_tile_exact(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats), chan, len(SEL), b, 12,
        None if idx is None else torch.from_numpy(idx))
    _bits_equal(out.numpy(), ref)


def test_exact_form_on_float_stats_and_the_cpu_switch():
    """On float stats the fixed-point sums sit within a few float32 ulps of
    the float32 row-order sums; kernel_sums_on_cpu makes the CPU path use
    them (a CPU run with a card run's bits); a non-finite stat makes its
    channel NaN."""
    n, f, b = 3000, 4, 16
    binsT, stats, leaf = _mk(n, f, b, seed=10, representable=False)
    args = (torch.from_numpy(binsT), torch.from_numpy(leaf),
            torch.from_numpy(stats),
            cuda_hist.chan_leaf_table(torch.from_numpy(SEL)), len(SEL), b, 12)
    plain = cuda_hist.hist_tile_plain(*args)
    exact = cuda_hist.hist_tile_exact(*args)
    mag = cuda_hist.hist_tile_plain(*args[:2], args[2].abs(), *args[3:])
    assert bool(((plain - exact).abs() <= 1e-6 * mag + 1e-30).all())
    assert not torch.equal(plain, exact)
    with cuda_hist.kernel_sums_on_cpu():
        _bits_equal(cuda_hist.hist_tile(*args).numpy(), exact.numpy())
    _bits_equal(cuda_hist.hist_tile(*args).numpy(), plain.numpy())
    bad = args[2].clone()
    bad[7, 1] = float("inf")
    out = cuda_hist.hist_tile_exact(*args[:2], bad, *args[3:])
    assert torch.isnan(out[..., 1]).all() and torch.isfinite(out[..., 0]).all()


# ------------------------------------------- the classic tile pass, sparse
def test_classic_tile_pass_with_sparse_columns_matches_jax():
    """One plane-only tile pass over 5 pending leaves on data whose
    concentrated columns live as (row, bin) streams: the dense columns'
    planes from the histogram pass, the sparse columns' from
    combine_sparse (scatter of the stream entries + the default bin rebuilt
    from per-slot totals), bitwise the JAX package's on float stats."""
    import lightgbm_tpu as lj
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu.models.grower import _grower_fns
    from lightgbm_tpu.ops.split import SplitParams as JSP
    from lightgbm_tpu_torch.models import grower as tgrower
    from lightgbm_tpu_torch.ops.split import SplitParams as TSP
    n = 2500
    rng = np.random.RandomState(11)
    X = rng.randn(n, 5).astype(np.float32)
    X[rng.rand(n) < 0.94, 1] = 0.0
    X[rng.rand(n) < 0.92, 3] = -1.0
    params = {"max_bin": 31, "verbosity": -1}
    jds = lj.Dataset(X, params=dict(params)).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu")).construct()
    assert tds.sp_cols.tolist() == [1, 3] == list(jds.sp_cols)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) + 0.3).astype(np.float32)
    leaf = rng.randint(0, 5, n).astype(np.int32)
    f = len(jds.used_features)
    jp = JSP.from_config(lj.Config.from_params(dict(params)))
    fns = _grower_fns(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.ones(n, jnp.float32),
        jds.feature_meta, jp, jnp.ones(f, jnp.float32), jds.missing_bin,
        max_leaves=8, num_bins=jds.max_num_bins, hist_method="scatter",
        binsT=jds.bins_T, sp_cols=tuple(int(c) for c in jds.sp_cols),
        sp_rows=jds.sp_rows, sp_bins=jds.sp_bins, sp_default=jds.sp_default)
    st = fns["init_state"]()._replace(leaf_id=jnp.asarray(leaf),
                                      num_leaves=jnp.int32(5))
    jhist_ = np.asarray(fns["hist_phase"](st).hist)
    gr = tgrower.Grower(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta, TSP.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))), tds.missing_bin,
        max_leaves=8, num_bins=tds.max_num_bins, split_fusion=False,
        sp=(tds.sp_cols, tds.sp_rows, tds.sp_bins, tds.sp_default))
    pst = gr.init_state()
    pst.leaf_id = torch.from_numpy(leaf)
    pst.num_leaves = 5
    gr.tile_pass(pst)
    _bits_equal(pst.hist.numpy(), jhist_)
    assert pst.hist_valid[:5].all() and not pst.hist_valid[5:].any()


# ------------------------------------------------------------------ q8 mode
def _mk_q8(n, f, b, n_leaves=12, seed=0):
    rng = np.random.RandomState(seed)
    binsT = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    stats = rng.randint(-127, 128, size=(n, 3)).astype(np.int8)
    stats[:, 2] = 1
    leaf = rng.randint(0, n_leaves, n).astype(np.int32)
    return binsT, stats, leaf


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("n,f,b", [(1500, 3, 63), (900, 4, 16)])
def test_q8_tiles_match_pallas_q8_and_onehot_q8(n, f, b, gather):
    """int8 stats -> exact int32 planes: bitwise the interpreted Pallas
    kernel in q8 mode and the XLA twin onehot_q8, full-row and gather."""
    from lightgbm_tpu.ops.histogram import histogram_tiles as j_tiles
    binsT, stats, leaf = _mk_q8(n, f, b, seed=n)
    idx = None
    if gather:
        keep = np.random.RandomState(3).rand(n) < 0.4
        idx = np.asarray(j_compact(jnp.asarray(keep), int(keep.sum()) + 13))
    jidx = None if idx is None else jnp.asarray(idx)
    ref = np.asarray(jph.histogram_tiles_pallas_mode(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(SEL), b, block=256, mode="q8", idx=jidx,
        interpret=True))
    twin = np.asarray(j_tiles(
        jnp.asarray(np.ascontiguousarray(binsT.T)), jnp.asarray(stats),
        jnp.asarray(leaf), jnp.asarray(SEL), b, method="onehot_q8",
        binsT=jnp.asarray(binsT), gather_idx=jidx))
    out = _port_tile(binsT, stats, leaf, SEL, b, 12, idx)
    assert out.dtype == np.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, twin)
    # the kernel-sums switch changes nothing in q8: the sums are exact
    with cuda_hist.kernel_sums_on_cpu():
        np.testing.assert_array_equal(
            _port_tile(binsT, stats, leaf, SEL, b, 12, idx), out)


def test_q8_row_limit():
    """int32 holds 127 * rows up to (2^31 - 1) // 127 rows, the JAX
    package's own limit; hist_tile refuses more."""
    assert cuda_hist.Q8_MAX_ROWS == (2 ** 31 - 1) // 127
    n = cuda_hist.Q8_MAX_ROWS + 1
    binsT = torch.zeros((1, 1), dtype=torch.uint8).expand(1, n)
    with pytest.raises(ValueError, match="overflow int32"):
        cuda_hist.hist_tile(binsT,
                            torch.zeros(1, dtype=torch.int32).expand(n),
                            torch.zeros((1, 3), dtype=torch.int8).expand(n,
                                                                         3),
                            cuda_hist.chan_leaf_table(torch.from_numpy(SEL)),
                            len(SEL), 4, 12)


def _q8_epilogue_inputs(seed):
    """int32 tiles of SEL's computed slots (derived slots zero), float
    parents for the derived ones, their leaf aggregates, and the tables."""
    from lightgbm_tpu.ops.histogram import histogram_tiles as j_tiles
    rng = np.random.RandomState(seed)
    n, f, b = 2000, 4, 16
    binsT, stats, leaf = _mk_q8(n, f, b, n_leaves=12, seed=seed)
    derive = np.array([0, 1, 0, 1, 0, 0, 0, 0], bool)
    q_scale = np.array([0.0137, 0.00291, 1.0], np.float32)
    sel_c = np.where(derive, -1, SEL).astype(np.int32)
    tile = np.asarray(j_tiles(
        jnp.asarray(np.ascontiguousarray(binsT.T)), jnp.asarray(stats),
        jnp.asarray(leaf), jnp.asarray(sel_c), b, method="onehot_q8"))
    full_sib = np.asarray(j_tiles(
        jnp.asarray(np.ascontiguousarray(binsT.T)), jnp.asarray(stats),
        jnp.asarray(leaf), jnp.asarray(SEL), b, method="onehot_q8"))
    parent = np.zeros(tile.shape, np.float32)
    for i in np.nonzero(derive)[0]:
        parent[i] = ((full_sib[i] + full_sib[i - 1]).astype(np.float32)
                     * q_scale)
    sums = (full_sib[:, 0].sum(1).astype(np.float32) * q_scale)
    out = sums[:, 0] * np.float32(-0.1) / (sums[:, 1] + 1)
    la = np.asarray(jph.pack_leaf_aux(*map(jnp.asarray, (
        sums[:, 0], sums[:, 1], sums[:, 2], out.astype(np.float32)))))
    meta = [np.array([16, 10, 12, 2], np.int32),
            np.array([0, 2, 1, 0], np.int32),
            np.array([0, 0, 4, 0], np.int32), np.zeros(4, np.int32)]
    fm = np.asarray(jph.pack_feature_meta(*map(jnp.asarray, meta)))
    pv = np.array([0.0, 1.0, 0.0, 0.0, 5.0, 1e-3, 0.0, 0.0], np.float32)
    del rng
    return (binsT, stats, leaf, derive, q_scale, tile, parent, la, fm, pv,
            b)


@pytest.mark.parametrize("seed", [0, 1])
def test_q8_derive_and_scan_matches_jax(seed):
    """Dequantize (each int32 cell times its stat's scale, one rounding),
    derive, scan: bitwise the JAX package's derive_and_scan(q8=True), and
    the epilogue's plain version with q_scale."""
    from lightgbm_tpu.ops.histogram import derive_and_scan as j_das
    from lightgbm_tpu_torch.ops.histogram import derive_and_scan as t_das
    (_, _, _, derive, q_scale, tile, parent, la, fm, pv,
     _) = _q8_epilogue_inputs(seed)
    jfull, jcand = j_das(jnp.asarray(tile), jnp.asarray(derive),
                         jnp.asarray(parent), jnp.asarray(la),
                         jnp.asarray(fm), jnp.asarray(pv[:7]), q8=True,
                         q_scale=jnp.asarray(q_scale))
    tfull, tcand = t_das(torch.from_numpy(tile), torch.from_numpy(derive),
                         torch.from_numpy(parent), torch.from_numpy(la),
                         torch.from_numpy(fm), torch.from_numpy(pv), q8=True,
                         q_scale=torch.from_numpy(q_scale))
    _bits_equal(tfull.numpy(), jfull)
    _bits_equal(tcand.numpy(), jcand)
    assert np.isfinite(np.asarray(jcand)[..., 0]).any()
    der = cuda_hist._epilogue_lanes(torch.from_numpy(SEL),
                                    torch.from_numpy(derive))
    cuda_hist.reset_launch_counts()
    pfull, pcand = cuda_hist.split_epilogue(
        torch.from_numpy(tile), torch.from_numpy(parent), der,
        torch.from_numpy(la), torch.from_numpy(fm), torch.from_numpy(pv),
        torch.from_numpy(q_scale))
    _bits_equal(pfull.numpy(), jfull)
    _bits_equal(pcand.numpy(), jcand)
    assert cuda_hist.split_epilogue.launches_q8 == 0


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("b", EDGE_BINS)
@pytest.mark.parametrize("case", EDGE_CASES)
def test_epilogue_edge_cases_match_jax(case, b, q8):
    """The split epilogue's plain version (the wrapper on CPU tensors) on
    planes built to break a parallel scan or argmax (exact gain ties within
    and across the two scans, all keys -inf, NaN cells, derived slot 0,
    nb < B with NaN and Zero missing types; B at the edges of 8 bins a lane
    and 16-bin scan blocks): bitwise the JAX package's derive_and_scan, in
    f32 and in q8."""
    from lightgbm_tpu.ops.histogram import derive_and_scan as j_das
    tile, parent, der, la, fm, q_scale, derive = epilogue_case(case, b, q8)
    pv = torch.tensor(PV_DEFAULT, dtype=torch.float32)
    jfull, jcand = j_das(
        jnp.asarray(tile.numpy()), jnp.asarray(derive.numpy()),
        jnp.asarray(parent.numpy()), jnp.asarray(la.numpy()),
        jnp.asarray(fm.numpy()), jnp.asarray(pv.numpy()[:7]), q8=q8,
        q_scale=None if q_scale is None else jnp.asarray(q_scale.numpy()))
    cuda_hist.reset_launch_counts()
    pfull, pcand = cuda_hist.split_epilogue(tile, parent, der, la, fm, pv,
                                            q_scale)
    assert sum(cuda_hist.launch_counts().values()) == 0
    _bits_equal(pfull.numpy(), jfull)
    _bits_equal(pcand.numpy(), jcand)
    if case == "all_inf":
        # the empty feature: every key -inf, the reverse threshold B-1 wins
        c = pcand.numpy()[:, 0]
        assert np.all(c[:, 0] == -np.inf) and np.all(c[:, 1] == b - 1)
        assert np.all(c[:, 2] == 1.0)


@pytest.mark.parametrize("gather", [False, True])
def test_q8_fused_pass_matches_pallas_q8_epilogue(gather):
    """The whole fused q8 pass: JAX's Pallas epilogue kernel in q8 mode
    (interpreted) vs the port's hist_tile + split_epilogue plain versions
    on int8 stats."""
    (binsT, stats, leaf, derive, q_scale, _, parent, la, fm, pv,
     b) = _q8_epilogue_inputs(2)
    idx = None
    if gather:
        keep = np.isin(leaf, SEL[(SEL >= 0) & ~derive])
        idx = np.asarray(j_compact(jnp.asarray(keep), int(keep.sum()) + 5))
    jt, jc = jph.histogram_tiles_pallas_epilogue(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(SEL), jnp.asarray(derive), jnp.asarray(parent),
        jnp.asarray(la), jnp.asarray(fm), jnp.asarray(pv[:7]), b,
        block=512, mode="q8", idx=None if idx is None else jnp.asarray(idx),
        interpret=True, q_scale=jnp.asarray(q_scale))
    from lightgbm_tpu_torch.ops.histogram import \
        histogram_tiles_with_candidates
    tt, tc = histogram_tiles_with_candidates(
        torch.from_numpy(binsT), torch.from_numpy(stats),
        torch.from_numpy(leaf), torch.from_numpy(SEL),
        torch.from_numpy(derive), torch.from_numpy(parent),
        torch.from_numpy(la), torch.from_numpy(fm), torch.from_numpy(pv),
        b, 12, None if idx is None else torch.from_numpy(idx),
        torch.from_numpy(q_scale))
    _bits_equal(tt.numpy(), jt)
    _bits_equal(tc.numpy(), jc)


@pytest.mark.parametrize("all_sparse", [False, True])
def test_q8_classic_tile_pass_with_sparse_columns_matches_jax(all_sparse):
    """The classic tile pass in q8: dense planes in int32, the sparse
    columns' planes by combine_sparse in int32 (stream scatter + the
    default bin rebuilt from per-slot totals, taken from a dense plane or,
    with no dense column, from the stats by slot), one dequantization of
    the whole tile: bitwise the JAX grower's onehot_q8 pass, int8 stats
    and scales included."""
    import lightgbm_tpu as lj
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu.models.grower import _grower_fns
    from lightgbm_tpu.ops.split import SplitParams as JSP
    from lightgbm_tpu_torch.models import grower as tgrower
    from lightgbm_tpu_torch.ops.split import SplitParams as TSP
    from lightgbm_tpu_torch.utils import random as trandom
    import jax
    n = 2500
    rng = np.random.RandomState(12)
    X = rng.randn(n, 5).astype(np.float32)
    X[rng.rand(n) < 0.94, 1] = 0.0
    X[rng.rand(n) < 0.92, 3] = -1.0
    if all_sparse:
        X = X[:, [1, 3]]
    params = {"max_bin": 31, "verbosity": -1}
    jds = lj.Dataset(X, params=dict(params)).construct()
    tds = lt.Dataset(X, params=dict(params, device_type="cpu")).construct()
    want = [0, 1] if all_sparse else [1, 3]
    assert tds.sp_cols.tolist() == want == list(jds.sp_cols)
    assert tds.binsT.shape[0] == (0 if all_sparse else 3)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) + 0.3).astype(np.float32)
    leaf = rng.randint(0, 5, n).astype(np.int32)
    f = len(jds.used_features)
    jkey = jax.random.fold_in(jax.random.PRNGKey(6), 4)
    fns = _grower_fns(
        jds.bins, jnp.asarray(g), jnp.asarray(h), jnp.ones(n, jnp.float32),
        jds.feature_meta, JSP.from_config(lj.Config.from_params(
            dict(params))), jnp.ones(f, jnp.float32), jds.missing_bin,
        max_leaves=8, num_bins=jds.max_num_bins, hist_method="onehot_q8",
        binsT=jds.bins_T, sp_cols=tuple(int(c) for c in jds.sp_cols),
        sp_rows=jds.sp_rows, sp_bins=jds.sp_bins, sp_default=jds.sp_default,
        rng_key=jkey)
    st = fns["init_state"]()._replace(leaf_id=jnp.asarray(leaf),
                                      num_leaves=jnp.int32(5))
    jhist_ = np.asarray(fns["hist_phase"](st).hist)
    gr = tgrower.Grower(
        tds.binsT, torch.from_numpy(g), torch.from_numpy(h),
        tds.feature_meta, TSP.from_config(lt.Config.from_params(
            dict(params, device_type="cpu"))), tds.missing_bin,
        max_leaves=8, num_bins=tds.max_num_bins, split_fusion=False,
        sp=(tds.sp_cols, tds.sp_rows, tds.sp_bins, tds.sp_default),
        hist_method="plain_q8",
        rng_key=trandom.fold_in(trandom.prng_key(6), 4))
    assert gr.stats.dtype == torch.int8
    pst = gr.init_state()
    pst.leaf_id = torch.from_numpy(leaf)
    pst.num_leaves = 5
    gr.tile_pass(pst)
    _bits_equal(pst.hist.numpy(), jhist_)
    assert np.abs(jhist_).max() > 0


# ------------------------------------------- the gather form's two passes
GATHER_CASES = ["empty_slot", "hot_slot", "sparse_rung", "slots42", "f1_b2"]


def _gather_case(case, seed=20):
    """Inputs of one gather edge case: (binsT, leaf, sel, derive, n_leaves,
    b, idx). The rung holds the rows of the tile's leaves in row order,
    a tenth of the other rows (dropped by the pass) and padding (N).
    ``empty_slot``: a computed leaf with no rows; ``hot_slot``: 90% of the
    rows in one slot; ``sparse_rung``: 1% of the rung is real rows;
    ``slots42``: 42 slots (all computed on the plane path, 21 computed and
    21 derived on the fused one); ``f1_b2``: one feature of two bins."""
    rng = np.random.RandomState(seed)
    n, f, b, n_leaves = 1200, 3, 16, 12
    sel = SEL.copy()
    derive = np.array([0, 1, 0, 1, 0, 0, 0, 0], bool)
    if case == "f1_b2":
        f, b = 1, 2
    if case == "slots42":
        n_leaves = 48
        sel = np.arange(42, dtype=np.int32)
        derive = np.arange(42) % 2 == 1
    binsT = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    leaf = rng.randint(0, n_leaves, n).astype(np.int32)
    if case == "empty_slot":
        leaf[leaf == sel[2]] = 4                    # leaf 4 is in no slot
    if case == "hot_slot":
        leaf = np.where(rng.rand(n) < 0.9, sel[0], leaf).astype(np.int32)
    keep = np.isin(leaf, sel[sel >= 0]) | (rng.rand(n) < 0.1)
    if case == "sparse_rung":
        keep &= rng.rand(n) < 0.02
    size = 100 * int(keep.sum()) if case == "sparse_rung" \
        else int(keep.sum()) + 37
    idx = compact_indices(torch.from_numpy(keep), size).numpy()
    return binsT, leaf, sel, derive, n_leaves, b, idx


def _gather_plain(binsT, leaf, stats, sel, n_leaves, b, idx, amax=None):
    """The gather form's plain pipeline: partition, then accumulate."""
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(sel))
    offsets, rows = cuda_hist.gather_partition_plain(
        torch.from_numpy(leaf), chan, len(sel), n_leaves,
        torch.from_numpy(idx))
    return cuda_hist.gather_accumulate_plain(
        torch.from_numpy(binsT), torch.from_numpy(stats), offsets, rows,
        chan, len(sel), b, n_leaves, len(idx), amax)


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_partition_matches_definition(case):
    """Each computed slot's run holds the rung's rows whose leaf is that
    slot's, in rung order; padding and other leaves are dropped."""
    binsT, leaf, sel, _, n_leaves, _, idx = _gather_case(case)
    n = leaf.shape[0]
    offsets, rows = cuda_hist.gather_partition_plain(
        torch.from_numpy(leaf), cuda_hist.chan_leaf_table(
            torch.from_numpy(sel)), len(sel), n_leaves,
        torch.from_numpy(idx))
    real = idx[idx < n]
    want = [real[leaf[real] == lf] for lf in sel if 0 <= lf < n_leaves]
    assert offsets.tolist() == np.cumsum([0] + [len(w) for w in want]
                                         ).tolist()
    np.testing.assert_array_equal(rows.numpy(), np.concatenate(want))
    if case == "empty_slot":
        assert int(offsets[3] - offsets[2]) == 0
    if case == "hot_slot":
        assert int(offsets[1]) >= 0.85 * len(rows)
    if case == "sparse_rung":
        assert len(rows) <= 0.01 * len(idx)


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_accumulate_matches_exact_and_pallas_gather_kernel(case):
    """Partition + accumulation (plain): bitwise hist_tile_exact on float
    stats (with and without a given amax), the interpreted Pallas
    _gather_kernel in mode "highest" on integer-valued stats and in mode
    "q8" on int8 stats."""
    binsT, leaf, sel, _, n_leaves, b, idx = _gather_case(case)
    n = leaf.shape[0]
    rng = np.random.RandomState(21)
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(sel))
    floats = rng.randn(n, 3).astype(np.float32)
    exact = cuda_hist.hist_tile_exact(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(floats), chan, len(sel), b, n_leaves,
        torch.from_numpy(idx))
    _bits_equal(_gather_plain(binsT, leaf, floats, sel, n_leaves, b,
                              idx).numpy(), exact.numpy())
    amax = torch.from_numpy(np.abs(floats).max(0))
    _bits_equal(_gather_plain(binsT, leaf, floats, sel, n_leaves, b, idx,
                              amax).numpy(), exact.numpy())
    for mode, stats in (
            ("highest", (rng.randint(-1023, 1024, (n, 3)) / 1024.0
                         ).astype(np.float32)),
            ("q8", rng.randint(-127, 128, (n, 3)).astype(np.int8))):
        ref = jph.histogram_tiles_pallas_mode(
            jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
            jnp.asarray(sel), b, block=256, mode=mode, idx=jnp.asarray(idx),
            interpret=True)
        out = _gather_plain(binsT, leaf, stats, sel, n_leaves, b, idx)
        assert out.dtype == (torch.int32 if mode == "q8" else torch.float32)
        _bits_equal(out.numpy(), ref)


@pytest.mark.parametrize("mode", ["highest", "q8"])
@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather_accumulate_matches_pallas_gather_epi_kernel(case, mode):
    """The fused gather pass: the interpreted Pallas _gather_epi_kernel
    against partition + accumulation (plain) of the computed slots
    followed by split_epilogue_plain, tile and candidates bitwise, on
    integer-valued f32 stats and on int8 stats (q8, dequantized by
    q_scale in the epilogue)."""
    binsT, leaf, sel, derive, n_leaves, b, idx = _gather_case(case)
    n, f = leaf.shape[0], binsT.shape[0]
    p = len(sel)
    rng = np.random.RandomState(22)
    q8 = mode == "q8"
    if q8:
        stats = rng.randint(-127, 128, (n, 3)).astype(np.int8)
        q_scale = np.array([0.0137, 0.00291, 1.0], np.float32)
    else:
        stats = (rng.randint(-1023, 1024, (n, 3)) / 1024.0).astype(np.float32)
        q_scale = None
    stats[:, 2] = 1
    # every slot's full plane (exact: integer sums), the derived slots'
    # parents and the leaf aggregates
    full = cuda_hist.hist_tile_plain(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats), cuda_hist.chan_leaf_table(
            torch.from_numpy(sel)), p, b, n_leaves).numpy()
    full = full.astype(np.float32) * (1.0 if q_scale is None else q_scale)
    parent = np.zeros_like(full)
    for i in np.nonzero(derive)[0]:
        parent[i] = full[i] + full[i - 1]
    sums = full[:, 0].sum(1)
    out = sums[:, 0] * np.float32(-0.1) / (sums[:, 1] + 1)
    la = cuda_hist.pack_leaf_aux(*(torch.from_numpy(np.ascontiguousarray(c))
                                   for c in (sums[:, 0], sums[:, 1],
                                             sums[:, 2], out)))
    nb = np.full(f, b, np.int32)
    fm = cuda_hist.pack_feature_meta(*(torch.from_numpy(c) for c in (
        nb, np.zeros(f, np.int32), np.zeros(f, np.int32),
        np.zeros(f, np.int32))))
    pv = np.array([0.0, 1.0, 0.0, 0.0, 2.0, 1e-3, 0.0, 0.0], np.float32)
    jt, jc = jph.histogram_tiles_pallas_epilogue(
        jnp.asarray(binsT), jnp.asarray(stats), jnp.asarray(leaf),
        jnp.asarray(sel), jnp.asarray(derive), jnp.asarray(parent),
        jnp.asarray(la.numpy()), jnp.asarray(fm.numpy()),
        jnp.asarray(pv[:7]), b, block=256, mode=mode, idx=jnp.asarray(idx),
        interpret=True,
        q_scale=None if q_scale is None else jnp.asarray(q_scale))
    sel_compute = np.where(derive, -1, sel).astype(np.int32)
    tile = _gather_plain(binsT, leaf, stats, sel_compute, n_leaves, b, idx)
    tt, tc = cuda_hist.split_epilogue_plain(
        tile, torch.from_numpy(parent), cuda_hist._epilogue_lanes(
            torch.from_numpy(sel), torch.from_numpy(derive)), la, fm,
        torch.from_numpy(pv),
        None if q_scale is None else torch.from_numpy(q_scale))
    _bits_equal(tt.numpy(), jt)
    _bits_equal(tc.numpy(), jc)
    assert np.isfinite(np.asarray(jc)[..., 0]).any() or case == "f1_b2"


def test_gather_layout_and_row_major_bins():
    """The gather form's launch shape and its row-major bin copy: rows
    padded to a power of two up to 32 bytes, then to multiples of 32; all
    28 Higgs features in one f32 block; the copy zero-padded, built once
    per bin matrix and again after an in-place write."""
    assert [cuda_hist.gather_layout(f, 255, False)[1]
            for f in (1, 4, 5, 8, 17, 28, 33, 65)] == [4, 4, 8, 8, 32, 32,
                                                       64, 96]
    assert cuda_hist.gather_layout(28, 255, False)[0] == 28
    assert cuda_hist.gather_layout(28, 255, True)[0] == 28
    assert cuda_hist.gather_layout(80, 255, False)[0] == 27  # 3 groups
    binsT = torch.from_numpy(np.random.RandomState(13).randint(
        0, 7, (5, 40)).astype(np.uint8))
    rows = cuda_hist.bins_by_row(binsT, 8)
    assert rows.shape == (40, 8) and torch.equal(rows[:, :5], binsT.T)
    assert not rows[:, 5:].any()
    assert cuda_hist.bins_by_row(binsT, 8) is rows
    binsT[2, 3] = 6
    again = cuda_hist.bins_by_row(binsT, 8)
    assert again is not rows and int(again[3, 2]) == 6
