"""Wide bins (more than 256 bins a feature) in the PyTorch port against the
JAX package on the CPU.

The port stores such bins as int16 (the JAX package as int32); its kernels'
wide mode is held to its plain versions on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``). Here, bitwise:

- the plain histogram forms (``hist_tile_plain``, ``hist_tile_exact``,
  ``gather_accumulate_plain``, ``full_accumulate_plain``) on 16-bit bins
  against the JAX Pallas kernels run through the interpreter at B = 511
  and 1,023, full-row and gather, f32 and q8; at B <= 256 the same bits
  from uint8 and int16 bins;
- the whole fused pass (``hist_tile`` + ``split_epilogue`` plain versions)
  against the interpreted Pallas epilogue kernel at B = 1,023, f32 and q8,
  unconstrained and monotone;
- ``split_epilogue_plain`` on the edge-case planes against the JAX
  ``derive_and_scan`` past 256 bins (its scan runs XLA's three levels);
- end to end at ``max_bin`` 511: the model text of
  ``lightgbm_tpu_torch.train`` equal to ``lightgbm_tpu.train``'s on the
  fused path (f32, and q8 against the interpreted Pallas q8 kernels), the
  classic path, and a categorical feature of 400 categories (a bitset of
  13 words a node), with the same ``split_fusion`` resolution;
- a device column above the bin types' cap (65,536 bins) raises
  NotImplementedError.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import pallas_hist as jph
from lightgbm_tpu.ops.histogram import compact_indices as j_compact
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops.histogram import (histogram_tiles,
                                              histogram_tiles_with_candidates)
from torch_epilogue_cases import EDGE_CASES, PV_DEFAULT, epilogue_case

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

SEL = np.array([0, 2, 5, 7, 9, 11, -1, -1], np.int32)
DERIVE = np.array([0, 1, 0, 1, 0, 0, 0, 0], bool)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


def _mk(n, f, b, q8, seed=0, n_leaves=12):
    """Bins skewed toward the low bins (many empty high bins), integer-
    valued f32 stats (exact sums in any order) or int8 stats."""
    rng = np.random.RandomState(seed)
    binsT = np.minimum((rng.exponential(b / 4, size=(f, n))).astype(
        np.int64), b - 1).astype(np.int16)
    if q8:
        stats = rng.randint(-127, 128, size=(n, 3)).astype(np.int8)
        stats[:, 2] = 1
    else:
        stats = (rng.randint(-1023, 1024, size=(n, 3)) / 1024.0
                 ).astype(np.float32)
        stats[:, 2] = 1.0
    leaf = rng.randint(0, n_leaves, n).astype(np.int32)
    return binsT, stats, leaf


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("gather", [False, True], ids=["full", "gather"])
@pytest.mark.parametrize("b", [511, 1023])
def test_plain_forms_match_interpreted_pallas(b, gather, q8):
    n, f = 1200, 3
    binsT, stats, leaf = _mk(n, f, b, q8, seed=b + gather)
    idx = None
    if gather:
        keep = np.random.RandomState(4).rand(n) < 0.3
        idx = np.asarray(j_compact(jnp.asarray(keep), int(keep.sum()) + 9))
    ref = np.asarray(jph.histogram_tiles_pallas_mode(
        jnp.asarray(binsT.astype(np.int32)), jnp.asarray(stats),
        jnp.asarray(leaf), jnp.asarray(SEL), b, block=512,
        mode="q8" if q8 else "highest",
        idx=None if idx is None else jnp.asarray(idx), interpret=True))
    tb, ts, tl = map(torch.from_numpy, (binsT, stats, leaf))
    ti = None if idx is None else torch.from_numpy(idx)
    chan = cuda_hist.chan_leaf_table(torch.from_numpy(SEL))
    out = histogram_tiles(tb, ts, tl, torch.from_numpy(SEL), b, 12, ti)
    _bits(out.numpy(), ref, "hist_tile_plain")
    if q8:
        assert out.dtype == torch.int32
        return
    # the kernel's own fixed-point arithmetic, in every plain form
    _bits(cuda_hist.hist_tile_exact(tb, tl, ts, chan, 8, b, 12, ti).numpy(),
          ref, "hist_tile_exact")
    with cuda_hist.kernel_sums_on_cpu():
        _bits(histogram_tiles(tb, ts, tl, torch.from_numpy(SEL), b, 12,
                              ti).numpy(), ref, "kernel sums")
    if gather:
        offsets, rows = cuda_hist.gather_partition_plain(tl, chan, 8, 12, ti)
        _bits(cuda_hist.gather_accumulate_plain(
            tb, ts, offsets, rows, chan, 8, b, 12, ti.shape[0]).numpy(), ref,
            "gather_accumulate_plain")
    else:
        one = np.array([5, -1, -1, -1, -1, -1, -1, -1], np.int32)
        ref1 = np.asarray(jph.histogram_tiles_pallas_mode(
            jnp.asarray(binsT.astype(np.int32)), jnp.asarray(stats),
            jnp.asarray(leaf), jnp.asarray(one), b, block=512,
            mode="highest", interpret=True))
        chan1 = cuda_hist.chan_leaf_table(torch.from_numpy(one))
        _bits(cuda_hist.full_accumulate_plain(tb, tl, ts, chan1, 8, b,
                                              12).numpy(), ref1,
              "full_accumulate_plain")


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_int16_bins_give_the_uint8_bits(q8):
    """At B <= 256 the 16-bit bins give the uint8 planes bit for bit, in
    every plain form."""
    n, f, b = 900, 4, 200
    binsT, stats, leaf = _mk(n, f, b, q8, seed=7)
    sel = torch.from_numpy(SEL)
    chan = cuda_hist.chan_leaf_table(sel)
    t8 = torch.from_numpy(binsT.astype(np.uint8))
    t16 = torch.from_numpy(binsT)
    ts, tl = torch.from_numpy(stats), torch.from_numpy(leaf)
    idx = torch.arange(0, n, 3, dtype=torch.int32)
    for gi in (None, idx):
        _bits(histogram_tiles(t16, ts, tl, sel, b, 12, gi).numpy(),
              histogram_tiles(t8, ts, tl, sel, b, 12, gi).numpy())
    if not q8:
        _bits(cuda_hist.hist_tile_exact(t16, tl, ts, chan, 8, b, 12).numpy(),
              cuda_hist.hist_tile_exact(t8, tl, ts, chan, 8, b, 12).numpy())
        _bits(cuda_hist.full_accumulate_plain(t16, tl, ts, chan, 8, b,
                                              12).numpy(),
              cuda_hist.full_accumulate_plain(t8, tl, ts, chan, 8, b,
                                              12).numpy())


def _fused_inputs(b, q8, mono, seed=0):
    """A fused tile pass at B = b: the bins, stats and leaves, the derived
    slots' parent planes (their sibling pair's planes, summed), the slots'
    aggregates and bounds, the feature table and the scan parameters."""
    n, f = 1500, 3
    binsT, stats, leaf = _mk(n, f, b, q8, seed=seed)
    sel = torch.from_numpy(SEL)
    full = cuda_hist.hist_tile_plain(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats), cuda_hist.chan_leaf_table(sel), 8, b, 12)
    q_scale = np.array([0.0137, 0.00291, 1.0], np.float32)
    scale = torch.from_numpy(q_scale) if q8 else torch.ones(3)
    fullf = full.to(torch.float32) * scale
    parent = torch.zeros_like(fullf)
    for i in np.nonzero(DERIVE)[0]:
        parent[i] = (full[i] + full[i - 1]).to(torch.float32) * scale
    sums = fullf[:, 0].sum(1)
    out = sums[:, 0] * -0.1 / (sums[:, 1] + 1)
    bounds = ((torch.full((8,), -0.04), torch.full((8,), 0.04)) if mono
              else (None, None))
    la = cuda_hist.pack_leaf_aux(sums[:, 0], sums[:, 1], sums[:, 2], out,
                                 *bounds)
    fm = cuda_hist.pack_feature_meta(
        torch.tensor([b, b - 300, b - 23], dtype=torch.int32),
        torch.tensor([0, 2, 1], dtype=torch.int32),
        torch.tensor([0, 0, b // 3], dtype=torch.int32),
        torch.tensor([1, -1, 0] if mono else [0, 0, 0], dtype=torch.int32))
    pv = torch.tensor([0.0, 1.0, 0.0, 0.0, 5.0, 1e-3, 0.0, 0.0])
    return (binsT, stats, leaf, parent, la, fm, pv,
            torch.from_numpy(q_scale) if q8 else None)


@pytest.mark.parametrize("mono", [False, True], ids=["free", "monotone"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_fused_pass_matches_interpreted_pallas_epilogue(q8, mono):
    b = 1023
    binsT, stats, leaf, parent, la, fm, pv, qs = _fused_inputs(b, q8, mono)
    jt, jc = jph.histogram_tiles_pallas_epilogue(
        jnp.asarray(binsT.astype(np.int32)), jnp.asarray(stats),
        jnp.asarray(leaf), jnp.asarray(SEL), jnp.asarray(DERIVE),
        jnp.asarray(parent.numpy()), jnp.asarray(la.numpy()),
        jnp.asarray(fm.numpy()), jnp.asarray(pv.numpy()[:7]), b,
        block=512, mode="q8" if q8 else "highest", interpret=True,
        with_monotone=mono,
        q_scale=None if qs is None else jnp.asarray(qs.numpy()))
    cuda_hist.reset_launch_counts()
    tt, tc = histogram_tiles_with_candidates(
        torch.from_numpy(binsT), torch.from_numpy(stats),
        torch.from_numpy(leaf), torch.from_numpy(SEL),
        torch.from_numpy(DERIVE), parent, la, fm, pv, b, 12, q_scale=qs,
        with_monotone=mono)
    assert not any(cuda_hist.launch_counts().values())
    _bits(tt.numpy(), jt, "planes")
    _bits(tc.numpy(), jc, "candidates")
    assert np.isfinite(tc.numpy()[..., 0]).any()


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("b", [257, 272, 512, 513, 1023, 2048, 4095, 4096])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_epilogue_edge_cases_match_jax_past_256_bins(case, b, q8):
    """The plain epilogue past 16 scan blocks (XLA's three-level cumulative
    sum) on the edge-case planes, at B on the wide kernel's chunk and
    block edges (17 blocks; bin B-1 first or last in a 256-bin chunk):
    bitwise the JAX derive_and_scan."""
    from lightgbm_tpu.ops.histogram import derive_and_scan as j_das
    tile, parent, der, la, fm, q_scale, derive = epilogue_case(
        case, b, q8)
    pv = torch.tensor(PV_DEFAULT, dtype=torch.float32)
    jfull, jcand = j_das(
        jnp.asarray(tile.numpy()), jnp.asarray(derive.numpy()),
        jnp.asarray(parent.numpy()), jnp.asarray(la.numpy()),
        jnp.asarray(fm.numpy()), jnp.asarray(pv.numpy()[:7]), q8=q8,
        q_scale=None if q_scale is None else jnp.asarray(q_scale.numpy()))
    pfull, pcand = cuda_hist.split_epilogue(tile, parent, der, la, fm, pv,
                                            q_scale)
    _bits(pfull.numpy(), jfull, "planes")
    _bits(pcand.numpy(), jcand, "candidates")


def _data(seed=0, n=2000):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, size=(n, 5)).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 4] = 0.0
    y = (2 * X[:, 0] - 1.5 * X[:, 1] + np.sin(3 * np.nan_to_num(X[:, 2]))
         + X[:, 3] * np.abs(X[:, 4]) + 0.3 * rng.normal(size=n))
    return X, y


def _cat400(seed=3, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    X[:, 1] = rng.randint(0, 400, n)
    eff = np.random.RandomState(9).randn(400)
    y = X[:, 0] + eff[X[:, 1].astype(int)] + 0.2 * rng.randn(n)
    return X, y


RUNS = {
    "fused": ({}, True),
    "fused_q8": ({"quantized_grad": True}, True),
    "classic": ({"split_fusion": "off"}, False),
    "classic_q8": ({"split_fusion": "off", "quantized_grad": True}, False),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_model_text_bitwise_at_max_bin_511(name, monkeypatch):
    """The JAX q8 runs use its Pallas q8 kernels through the interpreter
    (its CPU default is the XLA twin onehot_q8; both are exact)."""
    from lightgbm_tpu.models import gbdt as jgbdt
    extra, fused = RUNS[name]
    X, y = _data()
    params = dict({"objective": "regression", "num_leaves": 7,
                   "max_bin": 511, "min_data_in_leaf": 5,
                   "verbosity": -1}, **extra)
    if extra.get("quantized_grad"):
        monkeypatch.setattr(jgbdt.GBDT, "_hist_interpret", lambda self: True)
    bj = lj.train(dict(params), lj.Dataset(X, label=y), 2)
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y), 2)
    ts = bt._boosting.train_set
    assert ts.binsT.dtype == torch.int16 and ts.max_num_bins == 511
    assert bt._boosting._split_fusion_on() == fused
    assert bj._boosting._split_fusion_on(bj._boosting._hist_method()) == fused
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    back = lt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X), bt.predict(X))


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_400_category_feature_bitwise(q8):
    X, y = _cat400()
    params = {"objective": "regression", "num_leaves": 15, "max_bin": 511,
              "min_data_in_leaf": 3, "min_data_per_group": 3,
              "cat_smooth": 1.0, "max_cat_threshold": 300,
              "quantized_grad": q8, "verbosity": -1}
    bj = lj.train(dict(params), lj.Dataset(X, label=y,
                                           categorical_feature=[1]), 3)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, categorical_feature=[1]), 3)
    gb = bt._boosting
    assert gb.train_set.max_num_bins > 256 and not gb._split_fusion_on()
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    # a node's bitset runs past the 8 words of 256 bins
    widths = [len(ln.split("=")[1].split()) for ln in text.splitlines()
              if ln.startswith("cat_threshold=")]
    assert widths and max(widths) > 8
    back = lt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(back.predict(X), bt.predict(X))


def test_bins_above_the_cap_raise():
    """Past the bin types' cap of 65,536 bins a column (max_bin 65,535
    and a NaN bin) construction raises; up to it every layout holds a
    feature, splitting its bins across blocks where one block's shared
    memory does not."""
    n = 90000
    X = np.arange(n, dtype=np.float64).reshape(-1, 1)
    y = np.sin(X[:, 0] / 100.0)
    ds = lt.Dataset(X, label=y, params={"max_bin_by_feature": [70000],
                                        "min_data_in_bin": 1,
                                        "device_type": "cpu",
                                        "verbosity": -1})
    with pytest.raises(NotImplementedError, match="cap of 65536"):
        ds.construct()
    with pytest.raises(NotImplementedError, match="cap of 65536"):
        cuda_hist.full_layout(28, cuda_hist.MAX_BINS_DEVICE + 1, False)
    # the old cap fits both forms' shared memory (2 features a block)
    assert cuda_hist.full_layout(28, cuda_hist.MAX_BINS_WIDE, False)[0] == 2
    assert cuda_hist.gather_layout(28, 1023, False)[0] == 7
    assert cuda_hist.full_layout(28, 1023, False)[0] == 7
    # past one block's plane: one feature a block, its bins in ranges
    assert cuda_hist.full_layout(28, cuda_hist.MAX_BINS_DEVICE, False)[0] == 1
    assert cuda_hist.bin_ranges(cuda_hist.MAX_BINS_DEVICE, False, True) == (
        8192, 8)
