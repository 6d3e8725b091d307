"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (the kernels have no CPU form): each
carries the ``cuda`` marker and skips when ``torch.cuda.is_available()`` is
false. The file imports neither JAX nor the JAX package, so it runs on a GPU
host without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bars: ``hist_tile`` bitwise equal to ``hist_tile_plain`` on integer-valued
stats (sums exact in any order), within 1e-5 of the summed magnitudes on
float stats, and two launches bitwise equal on float stats (its 64-bit
fixed-point sums are deterministic); ``split_epilogue`` bitwise equal to
``split_epilogue_plain`` on identical planes (built with ``--fmad=false``)
and to a second launch, in f32 and q8, also on the edge cases of
``tests/torch_epilogue_cases.py`` (exact gain ties within and across the
two scans, all keys -inf, NaN cells, derived slot 0, nb < B with NaN and
Zero missing types, B in {1, 8, 16, 17, 255, 256});
training on the card gives the same model text twice, and the CPU plain
path's structure, on the fused and on the classic path. The q8 mode
(quantized gradients): ``hist_tile`` on int8 stats and the dequantizing
``split_epilogue`` bitwise equal to their plain versions (exact int32
sums), and a q8 training's model text on the card bitwise the CPU's.
The gather form's edge cases (an empty computed slot, one slot with 90%
of the rows, a rung of 1% real rows, 42 computed slots, one feature of
two bins): bitwise the plain versions in both modes, with or without the
caller's amax, and two launches equal. The same for the full form of a
one-slot tile (the root pass) at the Higgs and Expo widths, on skewed
bins (80% in one bin, Zipf columns), at 40 features (two feature groups)
and with most rows outside the slot.
The experiment script's ``hist_onehot`` (bf16 tensor cores) within 1e-5
of each cell's summed magnitudes of its plain version, and two launches
bitwise equal. The boosting modes (multiclass, bagging's subset and mask,
feature_fraction, GOSS, DART, RF, a weighted objective): a card training's
model text twice the same and equal to the CPU's with the kernel's sums
(f32) or the plain path (q8). Learning to rank: the pairwise lambda
kernel (``lambdarank_grads``) bitwise its plain version in the kernel's
order on the card and on the CPU at edge layouts (1-document queries, a
query longer than a block's threads, MS LTR's longest, all-tied scores,
labels all 0, truncation levels 3 and above n), two launches equal; a
lambdarank, q8 lambdarank and rank_xendcg training gives the same text
twice and the CPU's in the kernels' orders. The split constraints:
``split_epilogue``'s monotone mode bitwise its plain version and a second
launch at F = 28 and F = 136, f32 and q8, with open, tight and equal
bounds and a feature whose every candidate breaks its direction
(``tests/torch_monotone_cases.py``); basic, intermediate and advanced
monotone, interaction constraints, feature_contri, extra_trees and
by-node trainings give the same text twice and the CPU's with the
kernel's sums. Wide bins: ``hist_tile``'s wide mode (int16 bins) at
B = 511, 1,023 and 4,095, the root pass, 42 slots and the gather form,
bitwise ``hist_tile_exact`` (f32) or the exact plain sums (q8), two
launches equal and counted apart from the uint8 mode; the epilogue's wide
mode at B = 257 to 4,096, f32 and q8, unconstrained and monotone, on
random planes and the edge cases, bitwise its plain version and a second
launch. Past one block's plane (B = 8,191 to 65,535, int16 and int32
bins): ``hist_tile``'s cluster form (on skewed bins too) and another
rows-and-threads geometry in the three forms, f32 and q8, bitwise
``hist_tile_exact`` or the exact sums and two launches equal, the
integer-planes mode too; the wider epilogue (B = 4,097 to 65,536) in its
four modes bitwise its plain version; a max_bin 40,000 training's text
twice the same and the CPU's with the kernel's sums; ``predict_ensemble``
folding bins past its records' thresholds (tiled) and taking the global
geometry for thresholds past 4,095, bitwise. The data layer (wide bins fused, q8 and classic, a 400-category
feature, CSR with and without EFB, forced bins, max_bin_by_feature, forced
splits, CEGB split, coupled and lazy): a card training's text twice the
same and equal to the CPU's. The precision modes: ``hist_tile``'s f64 mode
(gpu_use_dp) at B = 255 and 1,023, the root pass, 42 slots and the gather
form, bitwise ``hist_tile_exact`` at float64 and a second launch, rounded
to float32 bitwise the f32 mode, within 1e-11 of a float64 sum's summed
magnitudes; gpu_use_dp (numerical, categorical, sparse columns, bagging)
and linear_tree (regression with NaNs, binary) trainings give the same
text twice and the CPU's with the kernel's sums. Training control (early
stopping with a rate schedule, fobj with feval, init_model, rollback,
reset_parameter mid-run, a cv fold's booster): the same text twice and the
CPU's with the kernel's sums, through the fused path's kernels; and
free_dataset gives back at least the bin matrix's device bytes.
Prediction: the ensemble traversal kernel (``predict_ensemble``) bitwise
its plain version and a second launch in every accumulation mode, with
biases and an active mask, in leaves mode, on uint8 and int16 bins,
categorical bitsets and 3 classes, and at serve sizes (1 and 8,192 rows);
a card booster's predictions bitwise those of its trees carried to a CPU
booster, its SHAP values within 1e-9 / 1e-11. Serve mode: after each
bucket's first flush a flush allocates no device memory, keeps its slot's
buffers, launches the kernel once and answers bitwise the ordinary
path. Fault tolerance: the feature-blocked pass
(``histogram_pool_size``) gives the resident run's trees (no
subtraction) and the CPU's with the kernel's sums, kernel 3 once a block a
pass; a run resumed from a checkpoint gives the uninterrupted text; a real
``torch.cuda.OutOfMemoryError`` is what the OOM ladder matches; the
predict rung's chunks keep the predictions bitwise, one launch a chunk.
"""

import contextlib

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import cuda_hist
from torch_epilogue_cases import (EDGE_BINS, EDGE_CASES, PV_DEFAULT,
                                  PV_REGULARISED, epilogue_case)
from torch_monotone_cases import KINDS, epilogue_args, monotone_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _hist_inputs(n, f, b, leaves, seed, integer):
    g = torch.Generator().manual_seed(seed)
    binsT = torch.randint(0, b, (f, n), generator=g, dtype=torch.int32)
    leaf = torch.randint(0, leaves, (n,), generator=g, dtype=torch.int32)
    if integer:
        stats = torch.stack([torch.randint(-3, 4, (n,), generator=g),
                             torch.randint(0, 4, (n,), generator=g),
                             torch.ones(n)], 1).float()
    else:
        stats = torch.stack([torch.randn(n, generator=g),
                             torch.rand(n, generator=g), torch.ones(n)], 1)
    return binsT.to(torch.uint8), leaf, stats.contiguous()


@pytest.mark.parametrize("n,f,b,p,gather", [
    (100_003, 28, 255, 42, False), (100_003, 28, 255, 42, True),
    (5_000, 3, 16, 7, True), (777, 1, 2, 1, False)])
@pytest.mark.parametrize("integer", [True, False])
def test_hist_tile_matches_plain(dev, n, f, b, p, gather, integer):
    """Full form: 42 or 7 computed slots run the gather form over all N
    rows, one slot (p=1 has none, whose launch writes zeros) the one-slot
    kernel."""
    leaves = p + 5
    binsT, leaf, stats = _hist_inputs(n, f, b, leaves, n + f, integer)
    sel = torch.arange(p, dtype=torch.int32)
    sel[p // 2] = -1                              # an inactive slot
    chan = cuda_hist.chan_leaf_table(sel)
    idx = None
    if gather:
        keep = torch.nonzero(leaf < p // 2 + 2).reshape(-1)
        idx = torch.cat([keep, torch.full((13,), n)]).to(torch.int32)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    gidx = None if idx is None else idx.to(dev)
    before = cuda_hist.hist_tile.launches
    before_plane = cuda_hist.hist_tile.launches_plane
    k = cuda_hist.hist_tile(*args, p, b, leaves, gidx)
    assert cuda_hist.hist_tile.launches == before + 1
    ref = cuda_hist.hist_tile_plain(*args, p, b, leaves, gidx)
    torch.cuda.synchronize()
    if integer:
        assert torch.equal(k.view(torch.int32), ref.view(torch.int32))
    else:
        mag = cuda_hist.hist_tile_plain(args[0], args[1], args[2].abs(),
                                        args[3], p, b, leaves, gidx)
        assert bool(((k - ref).abs() <= 1e-5 * mag + 1e-30).all())
    # deterministic: a second (plane-only) launch gives the same bits, and
    # so does the kernel's own arithmetic in plain torch
    again = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True)
    assert cuda_hist.hist_tile.launches_plane == before_plane + 1
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    exact = cuda_hist.hist_tile_exact(*args, p, b, leaves, gidx)
    assert torch.equal(k.view(torch.int32), exact.view(torch.int32))
    # and the plain version on the card equals it on the CPU (integer sums)
    if integer:
        cpu = cuda_hist.hist_tile_plain(binsT, leaf, stats, chan, p, b,
                                        leaves, idx)
        assert torch.equal(ref.cpu(), cpu)


def _epilogue_inputs(p, f, b, seed):
    g = torch.Generator().manual_seed(seed)
    derive = torch.zeros(p, dtype=torch.bool)
    derive[1::2] = True
    tile = torch.zeros((p, f, b, 3))
    parent = torch.zeros_like(tile)
    for s in range(p):
        cnt = torch.randint(0, 30, (f, b), generator=g).float()
        plane = torch.stack([torch.randn((f, b), generator=g) * cnt.sqrt(),
                             torch.rand((f, b), generator=g) * cnt, cnt], -1)
        if derive[s]:
            parent[s] = plane + tile[s - 1]
        else:
            tile[s] = plane
    full = torch.where(derive[:, None, None, None],
                       parent - torch.cat([tile[:1] * 0, tile[:-1]]), tile)
    tot = full[:, 0].sum(1)
    la = cuda_hist.pack_leaf_aux(tot[:, 0], tot[:, 1], tot[:, 2],
                                 -0.1 * tot[:, 0] / (tot[:, 1] + 1))
    nb = torch.full((f,), b, dtype=torch.int32)
    mt = torch.zeros(f, dtype=torch.int32)
    db = torch.zeros(f, dtype=torch.int32)
    if f >= 4:
        nb[1], mt[2], mt[3], db[3] = max(2, b // 2), 2, 1, min(3, b - 1)
    fm = cuda_hist.pack_feature_meta(nb, mt, db, torch.zeros_like(nb))
    der = cuda_hist._epilogue_lanes(torch.arange(p, dtype=torch.int32),
                                    derive)
    return tile, parent, der, la, fm


# the epilogue's edge cases (tests/torch_epilogue_cases.py): exact ties
# within and across the scans, all keys -inf, NaN cells, derived slot 0,
# nb < B with NaN / Zero missing types, at B on the edges of the kernel's
# 8 bins a lane and 16-bin scan blocks
EPI_EDGES = [(6, 6, b, case) for case in EDGE_CASES for b in EDGE_BINS]


def _cpu_bits(t, case):
    """The float32 bits of ``t``; in the ``nan`` case with every NaN one
    NaN: the CPU and the card make NaNs of other signs and payloads from
    NaN cells. Every other case compares raw bits."""
    if case == "nan":
        t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.view(torch.int32)


def _epilogue_case(p, f, b, case, q8):
    if case is None:
        return _epilogue_inputs(p, f, b, p * f + b + (1 if q8 else 0))
    return epilogue_case(case, b, q8, p, f)[:5]


@pytest.mark.parametrize("p,f,b,case", [(42, 28, 255, None),
                                        (6, 5, 16, None), (3, 2, 256, None),
                                        (1, 1, 3, None)] + EPI_EDGES)
@pytest.mark.parametrize("pv", [PV_DEFAULT[:7], PV_REGULARISED[:7]],
                         ids=["default", "regularised"])
def test_split_epilogue_matches_plain(dev, p, f, b, case, pv):
    tile, parent, der, la, fm = _epilogue_case(p, f, b, case, False)
    pvec = torch.tensor(pv + [0.0], dtype=torch.float32)
    args = [t.to(dev) for t in (tile, parent, der, la, fm, pvec)]
    before = cuda_hist.split_epilogue.launches
    kf, kc = cuda_hist.split_epilogue(*args)
    assert cuda_hist.split_epilogue.launches == before + 1
    kf2, kc2 = cuda_hist.split_epilogue(*args)
    pf, pc = cuda_hist.split_epilogue_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), pf.view(torch.int32))
    assert torch.equal(kc.view(torch.int32), kc2.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), kf2.view(torch.int32))
    # the plain version on the card equals it on the CPU
    cf, cc = cuda_hist.split_epilogue_plain(tile, parent, der, la, fm, pvec)
    assert torch.equal(_cpu_bits(pc.cpu(), case), _cpu_bits(cc, case))


def test_wrapper_raises_instead_of_falling_back(dev):
    binsT, leaf, stats = _hist_inputs(100, 2, 8, 4, 0, True)
    chan = cuda_hist.chan_leaf_table(torch.arange(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="leaf_ids"):   # one tensor left
        cuda_hist.hist_tile(binsT.to(dev), leaf, stats.to(dev),
                            chan.to(dev), 2, 8, 4)      # on the CPU
    with pytest.raises(ValueError, match="num_bins"):
        cuda_hist.hist_tile(binsT.to(dev), leaf.to(dev), stats.to(dev),
                            chan.to(dev), 2, 300, 4)
    # no form keeps a per-leaf table in shared memory any more, so a tile
    # over 60,000 leaves runs; one wider than the 128-lane tables raises
    args = (binsT.to(dev), leaf.to(dev), stats.to(dev), chan.to(dev))
    wide = cuda_hist.hist_tile(*args, 2, 8, 60_000)
    assert torch.equal(wide, cuda_hist.hist_tile_plain(*args, 2, 8, 60_000))
    with pytest.raises(ValueError, match="slots exceed"):
        cuda_hist.hist_tile(*args, 43, 8, 4)


@pytest.mark.parametrize("path", ["fused", "categorical", "sparse"])
def test_training_on_card_matches_cpu_structure(dev, path):
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.model_text import load_model
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 10).astype(np.float32)
    kw = {}
    if path == "categorical":
        X[:, 3] = rng.randint(0, 30, 20_000)
        kw = {"categorical_feature": [3]}
    elif path == "sparse":
        X[rng.rand(20_000) < 0.95, 4] = 0.0
    y = (X[:, 0] + X[:, 1] * X[:, 2] + np.sin(X[:, 3])
         + 0.5 * rng.randn(20_000) > 0)
    texts = {}
    for d in ("cuda", "cuda_again", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
             "device_type": d.split("_")[0]}
        texts[d] = lgb.train(p, lgb.Dataset(X, label=y.astype(float),
                                            params=p, **kw),
                             3).model_to_string()
    assert texts["cuda"] == texts["cuda_again"]
    # the kernel's sums are closer to exact than the CPU's float32 sums; a
    # leaf's sums are differences of cumulative sums whose rounding scales
    # with the parent's gradient mass, so leaves agree to an absolute 1e-4
    # (chip_smoke.py's parity bar), not to a relative one
    for a, b in zip(load_model(texts["cuda"]).trees,
                    load_model(texts["cpu"]).trees):
        assert a.split_feature.tolist() == b.split_feature.tolist()
        assert a.threshold.tolist() == b.threshold.tolist()
        assert a.cat_threshold.tolist() == b.cat_threshold.tolist()
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("n,f,b,p,gather", [
    (100_003, 28, 255, 42, False), (100_003, 8, 255, 42, True),
    (5_000, 3, 16, 7, True), (777, 1, 2, 1, False)])
def test_hist_tile_q8_matches_plain(dev, n, f, b, p, gather):
    """int8 stats -> int32 planes, exact: bitwise the plain version (on
    the card and on the CPU) and a second launch; counted as q8 launches
    only."""
    leaves = p + 5
    binsT, leaf, _ = _hist_inputs(n, f, b, leaves, n + f + 1, True)
    g = torch.Generator().manual_seed(n)
    stats = torch.randint(-127, 128, (n, 3), generator=g).to(torch.int8)
    stats[:, 2] = 1
    sel = torch.arange(p, dtype=torch.int32)
    sel[p // 2] = -1
    chan = cuda_hist.chan_leaf_table(sel)
    idx = None
    if gather:
        keep = torch.nonzero(leaf < p // 2 + 2).reshape(-1)
        idx = torch.cat([keep, torch.full((13,), n)]).to(torch.int32)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    gidx = None if idx is None else idx.to(dev)
    cuda_hist.reset_launch_counts()
    k = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True)
    again = cuda_hist.hist_tile(*args, p, b, leaves, gidx)
    ref = cuda_hist.hist_tile_plain(*args, p, b, leaves, gidx)
    torch.cuda.synchronize()
    assert k.dtype == torch.int32
    assert torch.equal(k, ref) and torch.equal(k, again)
    assert torch.equal(k.cpu(), cuda_hist.hist_tile_plain(
        binsT, leaf, stats, chan, p, b, leaves, idx))
    h = cuda_hist.hist_tile
    assert (h.launches_q8, h.launches_plane_q8) == (2, 1)
    assert h.gather_launches_q8 == (2 if gather else 0)
    assert (h.launches, h.gather_launches, h.launches_plane) == (0, 0, 0)


@pytest.mark.parametrize("p,f,b,case", [(42, 28, 255, None),
                                        (6, 5, 16, None), (1, 1, 3, None)]
                         + EPI_EDGES)
def test_split_epilogue_q8_matches_plain(dev, p, f, b, case):
    if case is None:
        tile, parent, der, la, fm = _epilogue_case(p, f, b, None, True)
        qtile = torch.round(tile * 37).to(torch.int32)
        q_scale = torch.tensor([0.0173, 0.00291, 1.0])
    else:
        qtile, parent, der, la, fm, q_scale, _ = epilogue_case(case, b, True,
                                                               p, f)
    pvec = torch.tensor(PV_DEFAULT, dtype=torch.float32)
    args = [t.to(dev) for t in (qtile, parent, der, la, fm, pvec)]
    cuda_hist.reset_launch_counts()
    kf, kc = cuda_hist.split_epilogue(*args, q_scale.to(dev))
    kf2, kc2 = cuda_hist.split_epilogue(*args, q_scale.to(dev))
    pf, pc = cuda_hist.split_epilogue_plain(*args, q_scale.to(dev))
    torch.cuda.synchronize()
    assert cuda_hist.split_epilogue.launches_q8 == 2
    assert cuda_hist.split_epilogue.launches == 0
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), pf.view(torch.int32))
    assert torch.equal(kc.view(torch.int32), kc2.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), kf2.view(torch.int32))
    cf, cc = cuda_hist.split_epilogue_plain(qtile, parent, der, la, fm, pvec,
                                            q_scale)
    assert torch.equal(_cpu_bits(pc.cpu(), case), _cpu_bits(cc, case))


@pytest.mark.parametrize("n,f,b,fg,blk", [
    (65_536, 28, 255, 2, 2048), (65_536, 28, 255, 7, 1024),
    (4_096, 5, 31, 4, 1024), (1_024, 1, 2, 3, 64),
    # edges: a last stage of 16 rows (TMA fills the rest with zeros), B=1,
    # B=256, two feature groups, a bins box of 256 features (its cap)
    (1_040, 3, 31, 2, 16), (4_096, 3, 1, 1, 1024),
    (8_192, 40, 256, 28, 1024), (8_192, 40, 255, 7, 1024),
    (4_096, 300, 1, 256, 1024)])
def test_hist_onehot_matches_plain(dev, n, f, b, fg, blk):
    g = torch.Generator().manual_seed(n + f)
    binsT = torch.randint(0, b, (f, n), generator=g).to(torch.uint8).to(dev)
    rhs = torch.randn((n, 256), generator=g).to(torch.bfloat16).to(dev)
    cuda_hist.reset_launch_counts()
    k = cuda_hist.hist_onehot(binsT, rhs, b, fg, blk)
    again = cuda_hist.hist_onehot(binsT, rhs, b, fg, blk)
    ref = cuda_hist.hist_onehot_plain(binsT, rhs, b)
    mag = cuda_hist.hist_onehot_plain(binsT, rhs.abs(), b)
    torch.cuda.synchronize()
    assert cuda_hist.hist_onehot.launches == 2
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    assert bool(((k - ref).abs() <= 1e-5 * mag).all())


@pytest.mark.parametrize("path", ["fused", "categorical", "sparse"])
def test_q8_training_on_card_equals_cpu(dev, path):
    """q8: the int8 quantization is the same torch arithmetic on both
    devices and the int32 sums are exact, so the card's model text is the
    CPU's, bit for bit."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(1)
    X = rng.randn(20_000, 10).astype(np.float32)
    kw = {}
    if path == "categorical":
        X[:, 3] = rng.randint(0, 30, 20_000)
        kw = {"categorical_feature": [3]}
    elif path == "sparse":
        X[rng.rand(20_000) < 0.95, 4] = 0.0
    y = (X[:, 0] + X[:, 1] * X[:, 2] + np.sin(X[:, 3])
         + 0.5 * rng.randn(20_000) > 0)
    texts = {}
    for d in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
             "quantized_grad": True, "device_type": d}
        texts[d] = lgb.train(p, lgb.Dataset(X, label=y.astype(float),
                                            params=p, **kw),
                             3).model_to_string()
    assert texts["cuda"] == texts["cpu"]


GATHER_CASES = ["empty_slot", "hot_slot", "sparse_rung", "slots42", "f1_b2",
                "f40"]


def _gather_case(case, seed):
    """A gather edge case at card scale: (binsT, leaf, sel, n_leaves, b,
    idx) on the CPU. The rung holds the tile's rows in row order, a tenth
    of the other rows and padding (N). ``empty_slot``: a computed leaf
    with no rows; ``hot_slot``: 90% of the rows in one slot;
    ``sparse_rung``: 1% of the rung is real rows; ``slots42``: 42 computed
    slots (the plane path); ``f1_b2``: one feature of two bins; ``f40``:
    40 features, wider than a 32-byte bin row."""
    g = torch.Generator().manual_seed(seed)
    n, f, b, n_leaves = 60_000, 28, 255, 255
    sel = torch.full((42,), -1, dtype=torch.int32)
    sel[0::2] = torch.arange(21, dtype=torch.int32) * 12
    if case == "f1_b2":
        f, b = 1, 2
    if case == "f40":
        f = 40
    if case == "slots42":
        f = 8
        sel = torch.arange(42, dtype=torch.int32) * 6
    binsT = torch.randint(0, b, (f, n), generator=g).to(torch.uint8)
    leaf = torch.randint(0, n_leaves, (n,), generator=g, dtype=torch.int32)
    if case == "empty_slot":
        leaf[leaf == sel[2]] = 1                    # leaf 1 is in no slot
    if case == "hot_slot":
        leaf = torch.where(torch.rand(n, generator=g) < 0.9, sel[0], leaf)
    keep = torch.isin(leaf, sel[sel >= 0]) | (torch.rand(n, generator=g)
                                               < 0.1)
    if case == "sparse_rung":
        keep &= torch.rand(n, generator=g) < 0.02
    size = 100 * int(keep.sum()) if case == "sparse_rung" \
        else int(keep.sum()) + 37
    rows = torch.nonzero(keep).reshape(-1).to(torch.int32)
    idx = torch.cat([rows, torch.full((size - rows.shape[0],), n,
                                      dtype=torch.int32)])
    return binsT, leaf.contiguous(), sel, n_leaves, b, idx


@pytest.mark.parametrize("case", GATHER_CASES)
def test_hist_tile_gather_cases_match_plain(dev, case):
    """The gather form on its edge cases: bitwise the plain version on
    integer-valued stats, hist_tile_exact and the partition + accumulation
    plain versions on float stats (with the grower's amax or without),
    exact int32 sums in q8; two launches equal in each mode."""
    binsT, leaf, sel, n_leaves, b, idx = _gather_case(case, 7)
    n = leaf.shape[0]
    p = sel.shape[0]
    chan = cuda_hist.chan_leaf_table(sel)
    g = torch.Generator().manual_seed(8)
    ints = torch.stack([torch.randint(-3, 4, (n,), generator=g),
                        torch.randint(0, 4, (n,), generator=g),
                        torch.ones(n)], 1).float()
    floats = torch.stack([torch.randn(n, generator=g),
                          torch.rand(n, generator=g), torch.ones(n)], 1)
    q8 = torch.randint(-127, 128, (n, 3), generator=g).to(torch.int8)
    q8[:, 2] = 1
    bd, ld, cd, id_ = (t.to(dev) for t in (binsT, leaf, chan, idx))
    cuda_hist.reset_launch_counts()
    for stats in (ints, floats, q8):
        sd = stats.contiguous().to(dev)
        k = cuda_hist.hist_tile(bd, ld, sd, cd, p, b, n_leaves, id_)
        again = cuda_hist.hist_tile(bd, ld, sd, cd, p, b, n_leaves, id_,
                                    plane=True)
        if stats is ints:
            ref = cuda_hist.hist_tile_plain(bd, ld, sd, cd, p, b, n_leaves,
                                            id_)
        elif stats is floats:
            amax = sd.abs().amax(0)
            ref = cuda_hist.hist_tile_exact(bd, ld, sd, cd, p, b, n_leaves,
                                            id_)
            given = cuda_hist.hist_tile(bd, ld, sd, cd, p, b, n_leaves, id_,
                                        amax=amax)
            off, rows = cuda_hist.gather_partition_plain(ld, cd, p, n_leaves,
                                                         id_)
            two = cuda_hist.gather_accumulate_plain(
                bd, sd, off, rows, cd, p, b, n_leaves, idx.shape[0])
            torch.cuda.synchronize()
            assert torch.equal(given.view(torch.int32), k.view(torch.int32))
            assert torch.equal(two.view(torch.int32), ref.view(torch.int32))
        else:
            ref = cuda_hist.hist_tile_plain(bd, ld, sd, cd, p, b, n_leaves,
                                            id_)
        torch.cuda.synchronize()
        assert k.dtype == ref.dtype
        assert torch.equal(k.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(k.view(torch.int32), again.view(torch.int32))
    h = cuda_hist.hist_tile
    assert (h.gather_launches, h.gather_launches_q8) == (5, 2)
    assert (h.launches_plane, h.launches_plane_q8) == (2, 1)


FULL_CASES = ["root28", "root8", "skew80", "zipf", "f40", "one_slot"]


def _full_case(case, seed):
    """A full-form pass at card scale: (binsT, leaf, sel, n_leaves) on the
    CPU, 255 bins. ``root28`` / ``root8``: the root pass (one computed slot,
    every row in it) at the Higgs and the Expo width; ``skew80``: the root
    at F=28 with 80% of all bins 0; ``zipf``: the root at F=8 with two
    Zipf-skewed columns (the Expo airports, p ~ (rank + 8)^-2) and a
    seven-bin one; ``f40``: the root at 40 features (two feature groups in
    f32); ``one_slot``: one computed slot whose leaf holds a tenth of the
    rows, the others dropped."""
    g = torch.Generator().manual_seed(seed)
    n, b, n_leaves = 300_007, 255, 255
    f = {"root8": 8, "zipf": 8, "f40": 40}.get(case, 28)
    binsT = torch.randint(0, b, (f, n), generator=g).to(torch.uint8)
    if case == "skew80":
        binsT[torch.rand((f, n), generator=g) < 0.8] = 0
    if case == "zipf":
        p = 1.0 / (torch.arange(1, b + 1, dtype=torch.float64) + 8.0) ** 2
        for c in (5, 6):
            binsT[c] = torch.multinomial(p, n, replacement=True,
                                         generator=g).to(torch.uint8)
        binsT[2] = torch.randint(0, 7, (n,), generator=g).to(torch.uint8)
    sel = torch.full((42,), -1, dtype=torch.int32)
    sel[0] = 0
    leaf = torch.zeros((n,), dtype=torch.int32)
    if case == "one_slot":
        sel[0] = 7
        leaf = torch.randint(0, 10, (n,), generator=g, dtype=torch.int32)
    return binsT, leaf, sel, n_leaves


@pytest.mark.parametrize("case", FULL_CASES)
def test_hist_tile_full_cases_match_plain(dev, case):
    """The full form of a one-slot tile (full_accumulate): bitwise the
    plain version on integer-valued stats, hist_tile_exact and
    full_accumulate_plain on float stats (with the grower's amax or
    without), exact int32 sums in q8; two launches equal in each mode;
    counted as full launches, no gather launch."""
    binsT, leaf, sel, n_leaves = _full_case(case, 11)
    n, b, p = leaf.shape[0], 255, sel.shape[0]
    chan = cuda_hist.chan_leaf_table(sel)
    g = torch.Generator().manual_seed(12)
    ints = torch.stack([torch.randint(-3, 4, (n,), generator=g),
                        torch.randint(0, 4, (n,), generator=g),
                        torch.ones(n)], 1).float()
    floats = torch.stack([torch.randn(n, generator=g),
                          torch.rand(n, generator=g), torch.ones(n)], 1)
    q8 = torch.randint(-127, 128, (n, 3), generator=g).to(torch.int8)
    q8[:, 2] = 1
    bd, ld, cd = (t.to(dev) for t in (binsT, leaf, chan))
    cuda_hist.reset_launch_counts()
    for stats in (ints, floats, q8):
        sd = stats.contiguous().to(dev)
        k = cuda_hist.hist_tile(bd, ld, sd, cd, p, b, n_leaves)
        again = cuda_hist.hist_tile(bd, ld, sd, cd, p, b, n_leaves,
                                    plane=True)
        if stats is floats:
            ref = cuda_hist.hist_tile_exact(bd, ld, sd, cd, p, b, n_leaves)
            given = cuda_hist.hist_tile(bd, ld, sd, cd, p, b, n_leaves,
                                        amax=sd.abs().amax(0))
            plain = cuda_hist.full_accumulate_plain(bd, ld, sd, cd, p, b,
                                                    n_leaves, blocks=5)
            torch.cuda.synchronize()
            assert torch.equal(given.view(torch.int32), k.view(torch.int32))
            assert torch.equal(plain.view(torch.int32),
                               ref.view(torch.int32))
        else:
            ref = cuda_hist.hist_tile_plain(bd, ld, sd, cd, p, b, n_leaves)
        torch.cuda.synchronize()
        assert k.dtype == ref.dtype
        assert torch.equal(k.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(k.view(torch.int32), again.view(torch.int32))
        assert bool(k[0].ne(0).any()) and not bool(k[1:].ne(0).any())
    h = cuda_hist.hist_tile
    assert (h.launches, h.launches_q8) == (5, 2)
    assert (h.gather_launches, h.gather_launches_q8) == (0, 0)
    assert (h.launches_plane, h.launches_plane_q8) == (2, 1)


# the boosting modes of the slice on the card: name -> (parameters, a
# >= 90%-zero column, i.e. the classic path)
BOOSTING_MODES = {
    "multiclass": ({"objective": "multiclass", "num_class": 3}, False),
    "multiclass_q8_classic": ({"objective": "multiclassova", "num_class": 3,
                               "quantized_grad": True}, True),
    "bagging_subset": ({"bagging_fraction": 0.5, "bagging_freq": 1}, False),
    "bagging_posneg_classic": ({"pos_bagging_fraction": 0.7,
                                "neg_bagging_fraction": 0.4,
                                "bagging_freq": 1}, True),
    "feature_fraction": ({"feature_fraction": 0.6}, False),
    "goss": ({"boosting": "goss", "learning_rate": 0.5}, False),
    "goss_q8": ({"boosting": "goss", "learning_rate": 0.5,
                 "quantized_grad": True}, False),
    "dart": ({"boosting": "dart"}, False),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
            "feature_fraction": 0.8}, False),
    "xentlambda_weighted": ({"objective": "cross_entropy_lambda"}, False),
}


@pytest.mark.parametrize("name", sorted(BOOSTING_MODES))
def test_boosting_modes_on_card_equal_cpu(dev, name):
    """Multiclass, bagging (subset and mask), feature_fraction, GOSS, DART,
    RF and a weighted objective: two card trainings give the same model
    text, and the CPU gives it too -- with the kernel's fixed-point sums
    (``kernel_sums_on_cpu``) in f32, on its plain path in q8. Every other
    operation (the threefry draws, the stable sorts, softmax, XLA's exp
    and log1p written out) is the same IEEE arithmetic on both devices."""
    import contextlib

    import lightgbm_tpu_torch as lgb
    extra, classic = BOOSTING_MODES[name]
    rng = np.random.RandomState(2)
    n = 20_000
    X = rng.randn(n, 10).astype(np.float32)
    if classic:
        X[rng.rand(n) < 0.95, 4] = 0.0
    z = X[:, 0] + X[:, 1] * X[:, 2] + np.sin(X[:, 3]) + 0.5 * rng.randn(n)
    obj = extra.get("objective", "binary")
    if obj.startswith("multiclass"):
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
    elif obj == "cross_entropy_lambda":
        y = 1 / (1 + np.exp(-z))
    else:
        y = (z > 0).astype(float)
    w = rng.rand(n) + 0.5 if obj == "cross_entropy_lambda" else None
    q8 = extra.get("quantized_grad", False)
    texts = {}
    for d in ("cuda", "cuda_again", "cpu"):
        p = dict({"objective": "binary", "num_leaves": 31, "verbosity": -1,
                  "device_type": d.split("_")[0]}, **extra)
        with (cuda_hist.kernel_sums_on_cpu() if d == "cpu" and not q8
              else contextlib.nullcontext()):
            b = lgb.train(p, lgb.Dataset(X, label=y, weight=w, params=p), 4)
            texts[d] = b.model_to_string()
        if d == "cuda":
            assert b._boosting._split_fusion_on() == (not classic)
    assert texts["cuda"] == texts["cuda_again"]
    assert texts["cuda"] == texts["cpu"]


# lambdarank_grads layouts: query sizes (a 1-document query, a query longer
# than a block's 128 threads, MS LTR's longest), what the labels and scores
# hold, and the parameters
RANK_LAYOUTS = {
    "mixed": ([1, 7, 12, 1, 5, 9, 3, 20, 300, 1251], "random", {}),
    "trunc3": ([1, 7, 12, 1, 5, 9, 3, 20, 300], "random",
               {"lambdarank_truncation_level": 3}),
    "trunc_above_n": ([4, 30, 129, 2], "random",
                      {"lambdarank_truncation_level": 5000}),
    "all_tied": ([1, 7, 12, 200], "tied", {}),
    "labels_all_0": ([3, 7, 40], "zero_labels", {}),
    "no_norm_sigmoid2": ([5, 64, 130], "random",
                         {"lambdarank_norm": False, "sigmoid": 2.0}),
    # past the kernel's partner tile of 256 documents
    "longer_than_tile": ([2100, 1, 7, 40], "random", {}),
}


@pytest.mark.parametrize("name", sorted(RANK_LAYOUTS))
def test_lambdarank_grads_matches_exact(dev, name):
    """The pairwise lambda kernel bitwise equal to its plain version in the
    kernel's order (``lambdarank_grads_exact``) on the card and on the CPU
    (``kernel_sums_on_cpu``), two launches bitwise equal, one counted
    launch a call."""
    from lightgbm_tpu_torch import ranking
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import rank
    groups, kind, extra = RANK_LAYOUTS[name]
    rng = np.random.RandomState(4)
    n = int(np.sum(groups))
    label = rng.randint(0, 5, size=n).astype(np.float64)
    score = rng.normal(size=n).astype(np.float32)
    if kind == "tied":
        score[:] = 0.25
    if kind == "zero_labels":
        label[:] = 0.0
    out = {}
    for d in ("cuda", "cpu"):
        cfg = Config.from_params(dict({"objective": "lambdarank",
                                       "device_type": d}, **extra))
        obj = ranking.create_ranking_objective(cfg)
        obj.init(label, None, groups, device=d)
        s = torch.from_numpy(score).to(d)
        if d == "cpu":
            with cuda_hist.kernel_sums_on_cpu():
                out[d] = obj.get_grad_hess(s)
            continue
        rank.lambdarank_grads.launches = 0
        g1, h1 = obj.get_grad_hess(s)
        g2, h2 = obj.get_grad_hess(s)
        torch.cuda.synchronize()
        assert rank.lambdarank_grads.launches == 2
        assert torch.equal(g1.view(torch.int32), g2.view(torch.int32))
        assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))
        ge, he = rank.lambdarank_grads_exact(
            s, obj.label, obj.gain, obj.inv_max_dcg, obj.layout, obj.sigmoid,
            obj.truncation_level, obj.norm)
        assert torch.equal(g1.view(torch.int32), ge.view(torch.int32))
        assert torch.equal(h1.view(torch.int32), he.view(torch.int32))
        out[d] = (g1.cpu(), h1.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if kind == "zero_labels":
        assert not bool(out["cuda"][0].ne(0).any())


@pytest.mark.parametrize("params", [
    {"objective": "lambdarank"},
    {"objective": "lambdarank", "quantized_grad": True},
    {"objective": "rank_xendcg", "seed": 3}], ids=["lambdarank",
                                                  "lambdarank_q8",
                                                  "rank_xendcg"])
def test_ranking_training_on_card_equals_cpu(dev, params):
    """Learning to rank on the card: two trainings give the same model
    text, and the CPU with the kernels' orders (``kernel_sums_on_cpu``:
    hist_tile's fixed-point sums, lambdarank_grads' partner order) gives
    it too; lambdarank launches its kernel once an iteration."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import rank
    rng = np.random.RandomState(3)
    groups = rng.randint(1, 150, size=200)
    n = int(groups.sum())
    X = rng.randn(n, 12).astype(np.float32)
    y = np.clip(np.floor(X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) + 1.5), 0, 4)
    texts = {}
    for d in ("cuda", "cuda_again", "cpu"):
        p = dict({"num_leaves": 31, "verbosity": -1,
                  "device_type": d.split("_")[0]}, **params)
        rank.lambdarank_grads.launches = 0
        with cuda_hist.kernel_sums_on_cpu():
            b = lgb.train(p, lgb.Dataset(X, label=y, group=groups, params=p),
                          4)
        texts[d] = b.model_to_string()
        if d == "cuda":
            assert rank.lambdarank_grads.launches == (
                4 if params["objective"] == "lambdarank" else 0)
    assert texts["cuda"] == texts["cuda_again"]
    assert texts["cuda"] == texts["cpu"]


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f", [28, 136])
def test_split_epilogue_monotone_matches_plain(dev, f, kind, q8):
    """The monotone mode at the main path's P = 42, B = 255: bitwise its
    plain version (planes and table) and a second launch, counted as
    ``launches_mono`` (``launches_mono_q8``) and nowhere else."""
    case = monotone_case(kind, q8, p=42, f=f, b=255, n=40_000)
    args = epilogue_args(case, dev)
    name = "launches_mono_q8" if q8 else "launches_mono"
    before = cuda_hist.launch_counts()
    kf, kc = cuda_hist.split_epilogue(*args, with_monotone=True)
    after = cuda_hist.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {f"split_epilogue.{name}": 1}
    kf2, kc2 = cuda_hist.split_epilogue(*args, with_monotone=True)
    pf, pc = cuda_hist.split_epilogue_plain(*args, with_monotone=True)
    torch.cuda.synchronize()
    for a, b in ((kc, pc), (kf, pf), (kc, kc2), (kf, kf2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the plain version on the card equals it on the CPU
    _, cc = cuda_hist.split_epilogue_plain(*epilogue_args(case),
                                           with_monotone=True)
    assert torch.equal(pc.cpu().view(torch.int32), cc.view(torch.int32))
    if kind == "violate":
        assert not torch.isfinite(kc[:, 0, 0]).any()


CONSTRAINED = {
    "basic": {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0, -1, 0]},
    "basic_q8": {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0, -1, 0],
                 "quantized_grad": True},
    "intermediate": {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0, -1,
                                              0],
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0, -1, 0],
                 "monotone_constraints_method": "advanced"},
    "interactions": {"interaction_constraints": [[0, 1, 2], [3, 4, 5],
                                                 [6, 7, 8, 9]]},
    "contri_zero": {"feature_contri": [1, 0, 1, 1, 0.5, 1, 2, 1, 1, 1]},
    "extra_trees": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.5},
}


@pytest.mark.parametrize("name", sorted(CONSTRAINED))
def test_constrained_training_on_card_equals_cpu(dev, name):
    """A constrained training on the card gives the same model text twice
    and the CPU's with the kernel's sums (f32) or on its plain path (q8);
    basic monotone runs the epilogue's monotone mode."""
    import contextlib

    import lightgbm_tpu_torch as lgb
    extra = CONSTRAINED[name]
    rng = np.random.RandomState(5)
    n = 20_000
    X = rng.randn(n, 10).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + np.sin(X[:, 4])
         - 0.5 * X[:, 8] + 0.5 * rng.randn(n) > 0).astype(float)
    q8 = extra.get("quantized_grad", False)
    texts = {}
    for d in ("cuda", "cuda_again", "cpu"):
        p = dict({"objective": "binary", "num_leaves": 31, "verbosity": -1,
                  "device_type": d.split("_")[0]}, **extra)
        cuda_hist.reset_launch_counts()
        with (cuda_hist.kernel_sums_on_cpu() if d == "cpu" and not q8
              else contextlib.nullcontext()):
            texts[d] = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                                 4).model_to_string()
        if d == "cuda" and name.startswith("basic"):
            counts = cuda_hist.launch_counts()
            sfx = "_q8" if q8 else ""
            assert counts["split_epilogue.launches_mono" + sfx] > 0
            assert counts["split_epilogue.launches" + sfx] == 0
    assert texts["cuda"] == texts["cuda_again"]
    assert texts["cuda"] == texts["cpu"]


# ------------------------------------------------------------ wide bins
def _wide_inputs(n, f, b, leaves, seed, q8):
    """int16 bins skewed toward the low bins (the high bins of a wide
    feature are sparse), integer-valued f32 or int8 stats."""
    g = torch.Generator().manual_seed(seed)
    binsT = torch.minimum(
        (torch.rand((f, n), generator=g) ** 3 * b).to(torch.int64),
        torch.tensor(b - 1)).to(torch.int16)
    leaf = torch.randint(0, leaves, (n,), generator=g, dtype=torch.int32)
    if q8:
        stats = torch.randint(-127, 128, (n, 3), generator=g).to(torch.int8)
        stats[:, 2] = 1
    else:
        stats = torch.stack([torch.randn(n, generator=g),
                             torch.rand(n, generator=g), torch.ones(n)], 1)
    return binsT, leaf, stats.contiguous()


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("form", ["root", "slots", "gather"])
@pytest.mark.parametrize("b", [511, 1023, 4095])
def test_hist_tile_wide_matches_plain(dev, b, form, q8):
    """The wide mode (int16 bins): bitwise the kernel's own arithmetic in
    plain torch (f32; float stats) or the exact plain sums (q8), two
    launches equal, counted as wide launches and not as uint8 ones."""
    n, f = 200_003, 28
    p = 1 if form == "root" else 42
    leaves = p + 5
    binsT, leaf, stats = _wide_inputs(n, f, b, leaves, b + n, q8)
    sel = torch.arange(p, dtype=torch.int32)
    chan = cuda_hist.chan_leaf_table(sel)
    idx = None
    if form == "gather":
        keep = torch.nonzero(leaf < 9).reshape(-1)
        idx = torch.cat([keep, torch.full((13,), n)]).to(torch.int32)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    gidx = None if idx is None else idx.to(dev)
    cuda_hist.reset_launch_counts()
    k = cuda_hist.hist_tile(*args, p, b, leaves, gidx)
    again = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True)
    counts = cuda_hist.launch_counts()
    sfx = "_wide" + ("_q8" if q8 else "")
    assert counts["hist_tile.launches" + sfx] == 2
    assert counts["hist_tile.launches_plane" + sfx] == 1
    assert counts["hist_tile.gather_launches" + sfx] == (
        2 if form == "gather" else 0)
    assert sum(v for c, v in counts.items()
               if c.startswith("hist_tile.") and "_wide" not in c) == 0
    ref = (cuda_hist.hist_tile_plain(*args, p, b, leaves, gidx) if q8
           else cuda_hist.hist_tile_exact(*args, p, b, leaves, gidx))
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))


# the wide epilogue's geometry (a CTA of ceil(B / 256) warps a (slot,
# feature)): B on the edges of its chunks, 16-bin blocks and 256-bin
# super-blocks (bin B-1 first or last in a lane, a block or a chunk; 17
# blocks), a plane of one (slot, feature), a few, and more CTAs than one
# wave (F = 136)
WIDE_BINS = (257, 272, 511, 512, 513, 768, 1023, 2048, 2049, 4095, 4096)
WIDE_EPI = ([(42, 28, b, None) for b in WIDE_BINS]
            + [(1, 1, 257, None), (1, 1, 4096, None), (3, 5, 513, None),
               (3, 5, 2049, None), (42, 136, 1023, None),
               (42, 136, 4095, None)]
            + [(6, 6, b, c) for c in EDGE_CASES
               for b in (272, 513, 1023, 2049, 4095)])


@pytest.mark.parametrize("mono", [False, True], ids=["free", "monotone"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("p,f,b,case", WIDE_EPI)
def test_split_epilogue_wide_matches_plain(dev, p, f, b, case, q8, mono):
    """The epilogue's wide mode (B > 256, XLA's three-level scan): bitwise
    its plain version and a second launch, in each of its four modes,
    each counted apart."""
    _epilogue_wide_case(dev, p, f, b, case, q8, mono, "launches_wide")


def _epilogue_wide_case(dev, p, f, b, case, q8, mono, counter):
    """One wide or wider epilogue case: random planes (``case`` None) or
    an edge case, bitwise the plain version and a second launch, the two
    launches counted under ``counter`` (+ ``_mono``, ``_q8``) alone."""
    if case is None:
        tile, parent, der, la, fm = _epilogue_inputs(p, f, b, b)
        qs = None
        if q8:
            qs = torch.tensor([0.0137, 0.00291, 1.0])
            tile = (tile * 64).round().to(torch.int32)
    else:
        tile, parent, der, la, fm, qs, _ = epilogue_case(case, b, q8, p, f)
    if mono:
        p = tile.shape[0]
        la = la.clone()
        la[:, 4], la[:, 5] = -0.05, 0.05
        fm = fm.clone()
        fm[:, 3] = torch.tensor([1.0, -1.0, 0.0] * (fm.shape[0] // 3 + 1)
                                )[:fm.shape[0]]
    pvec = torch.tensor(PV_DEFAULT, dtype=torch.float32)
    args = [t.to(dev) for t in (tile, parent, der, la, fm, pvec)]
    q = None if qs is None else qs.to(dev)
    cuda_hist.reset_launch_counts()
    kf, kc = cuda_hist.split_epilogue(*args, q, with_monotone=mono)
    kf2, kc2 = cuda_hist.split_epilogue(*args, q, with_monotone=mono)
    name = ("split_epilogue." + counter + ("_mono" if mono else "")
            + ("_q8" if q8 else ""))
    counts = cuda_hist.launch_counts()
    assert counts[name] == 2 and sum(
        v for c, v in counts.items() if c.startswith("split_epilogue")) == 2
    pf, pc = cuda_hist.split_epilogue_plain(*args, q, with_monotone=mono)
    torch.cuda.synchronize()
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), pf.view(torch.int32))
    assert torch.equal(kc.view(torch.int32), kc2.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), kf2.view(torch.int32))


# -------------------------------------------- bins past one block's plane
def _wider_inputs(n, f, b, leaves, seed, q8):
    """Bins of the dtype the dataset gives ``b`` (int16 up to 32,768,
    int32 above), half uniform and half skewed toward the low bins, so
    every bin range of a split feature gets rows; float or int8 stats."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((f, n), generator=g)
    u = torch.where(torch.arange(n)[None, :] % 2 == 0, u, u ** 3)
    binsT = torch.minimum((u * b).to(torch.int64), torch.tensor(b - 1)).to(
        torch.int16 if b <= 32768 else torch.int32)
    leaf = torch.randint(0, leaves, (n,), generator=g, dtype=torch.int32)
    if q8:
        stats = torch.randint(-127, 128, (n, 3), generator=g).to(torch.int8)
        stats[:, 2] = 1
    else:
        stats = torch.stack([torch.randn(n, generator=g),
                             torch.rand(n, generator=g), torch.ones(n)], 1)
    return binsT, leaf, stats.contiguous()


WIDER_GEOMETRIES = {"default": None,
                    "rows4096_t512": cuda_hist.HistGeometry(4096, 512)}


@pytest.mark.parametrize("geo", sorted(WIDER_GEOMETRIES))
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("form", ["root", "slots", "gather"])
@pytest.mark.parametrize("b", [8191, 16383, 40000, 65535])
def test_hist_tile_wider_matches_plain(dev, b, form, q8, geo):
    """Bins past what one block's shared memory holds (a cluster of CTAs
    holding a feature's plane), int16 and int32 bins:
    bitwise ``hist_tile_exact`` (f32) or the exact plain sums (q8), two
    launches equal, counted as ``_wider`` where a feature's bins span
    blocks."""
    n, f = 60_001, 5
    p = 1 if form == "root" else 42
    leaves = p + 5
    binsT, leaf, stats = _wider_inputs(n, f, b, leaves, b + n, q8)
    sel = torch.arange(p, dtype=torch.int32)
    chan = cuda_hist.chan_leaf_table(sel)
    idx = None
    if form == "gather":
        keep = torch.nonzero(leaf < 9).reshape(-1)
        idx = torch.cat([keep, torch.full((13,), n)]).to(torch.int32)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    gidx = None if idx is None else idx.to(dev)
    g = WIDER_GEOMETRIES[geo]
    cuda_hist.reset_launch_counts()
    k = cuda_hist.hist_tile(*args, p, b, leaves, gidx, geometry=g)
    again = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True,
                                geometry=g)
    counts = cuda_hist.launch_counts()
    full = form == "root"
    split = cuda_hist.bin_ranges(b, q8, full)[1] > 1
    sfx = ("_wider" if split else "_wide") + ("_q8" if q8 else "")
    assert counts["hist_tile.launches" + sfx] == 2
    ref = (cuda_hist.hist_tile_plain(*args, p, b, leaves, gidx) if q8
           else cuda_hist.hist_tile_exact(*args, p, b, leaves, gidx))
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("form", ["root", "slots", "gather"])
@pytest.mark.parametrize("b", [16383, 65535])
def test_hist_tile_cluster_skewed_bins_match_exact(dev, b, form, q8):
    """Skewed bins (80% of the rows in bin 0): the lanes of a warp that
    add to one cell of the cluster merge first; the planes bitwise
    ``hist_tile_exact`` (f32) or the exact sums (q8), two launches
    equal."""
    n, f = 60_001, 5
    p = 1 if form == "root" else 42
    binsT, leaf, stats = _wider_inputs(n, f, b, p + 5, b + 7, q8)
    binsT[:, torch.arange(n) % 5 != 0] = 0
    chan = cuda_hist.chan_leaf_table(torch.arange(p, dtype=torch.int32))
    idx = None
    if form == "gather":
        idx = torch.nonzero(leaf < 9).reshape(-1).to(torch.int32).to(dev)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    ref = (cuda_hist.hist_tile_plain(*args, p, b, p + 5, idx) if q8
           else cuda_hist.hist_tile_exact(*args, p, b, p + 5, idx))
    k = cuda_hist.hist_tile(*args, p, b, p + 5, idx)
    again = cuda_hist.hist_tile(*args, p, b, p + 5, idx)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(k.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("form", ["root", "gather"])
def test_hist_tile_wider_integer_planes_match_exact(dev, form):
    """The integer-planes mode (``raw``) of a split feature at B = 16,383:
    the int64 sums bitwise ``hist_tile_exact(raw=True)`` in both forms."""
    n, f, b = 60_001, 5, 16383
    p = 1 if form == "root" else 42
    binsT, leaf, stats = _wider_inputs(n, f, b, p + 5, 77, False)
    chan = cuda_hist.chan_leaf_table(torch.arange(p, dtype=torch.int32))
    idx = None
    if form == "gather":
        idx = torch.nonzero(leaf < 9).reshape(-1).to(torch.int32).to(dev)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    amax = stats.abs().amax(0).to(dev)
    for g in WIDER_GEOMETRIES.values():
        k = cuda_hist.hist_tile(*args, p, b, p + 5, idx, plane=True,
                                amax=amax, rows=2 * n, raw=True, geometry=g)
        ref = cuda_hist.hist_tile_exact(*args, p, b, p + 5, idx, amax,
                                        rows=2 * n, raw=True)
        torch.cuda.synchronize()
        assert torch.equal(k, ref)


# the wider epilogue (B > 4,096: a cluster of CTAs, a warp a chunk, XLA's
# scan a fourth level): B on the edges of 16 chunks and of 256-chunk
# groups, one plane, a few, the main path's tile, and the edge cases
WIDER_BINS = (4097, 4352, 8191, 8192, 8193, 16383, 40000, 65535, 65536)
WIDER_EPI = ([(6, 6, b, None) for b in WIDER_BINS]
             + [(42, 28, 8191, None), (42, 28, 16383, None),
                (1, 1, 4097, None), (1, 1, 65536, None)]
             + [(6, 6, b, c) for c in EDGE_CASES
                for b in (4097, 8193, 65535)])


@pytest.mark.parametrize("mono", [False, True], ids=["free", "monotone"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("p,f,b,case", WIDER_EPI)
def test_split_epilogue_wider_matches_plain(dev, p, f, b, case, q8, mono):
    """The epilogue past 4,096 bins, in each of its four modes: bitwise
    its plain version and a second launch, counted as ``_wider``."""
    _epilogue_wide_case(dev, p, f, b, case, q8, mono, "launches_wider")


def test_wider_training_on_card_equals_cpu(dev):
    """max_bin 40,000 (int32 bins, bins past 32,767): a card training's
    text twice the same and equal to the CPU's with the kernel's sums;
    its predictions bitwise those of its trees carried to the CPU."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(5)
    n = 50_000
    X = rng.randn(n, 3)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) * 0.5 + rng.randn(n) * 0.3
         > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 63, "max_bin": 40000,
         "min_data_in_bin": 1, "verbosity": -1}
    texts = []
    for _ in range(2):
        b = lgb.train(dict(p, device_type="cuda"),
                      lgb.Dataset(X, label=y, params=dict(p)), 3)
        texts.append(b.model_to_string())
    assert b._boosting.train_set.binsT.dtype == torch.int32
    with cuda_hist.kernel_sums_on_cpu():
        cpu = lgb.train(dict(p, device_type="cpu"),
                        lgb.Dataset(X, label=y, params=dict(
                            p, device_type="cpu")), 3)
    assert texts[0] == texts[1] == cpu.model_to_string()
    carried = lgb.booster_from_numpy(*lgb.booster_to_numpy(b, "cpu"))
    np.testing.assert_array_equal(b.predict(X), carried.predict(X))


@pytest.mark.parametrize("dtype,b", [(torch.int16, 16383),
                                     (torch.int32, 40000)])
def test_predict_ensemble_folds_wide_bins(dev, dtype, b):
    """Trees whose thresholds lie below 4,096 over wide bins take the tiled
    mode, which folds every bin from 4,096 up (the missing bin apart):
    bitwise its plain version; trees with a threshold past it take the
    global mode, bitwise too."""
    from lightgbm_tpu_torch.ops import predict as P
    f, n = 6, 40_000
    rng = np.random.RandomState(9)
    binsT = torch.as_tensor(rng.randint(0, b, (f, n)), dtype=dtype)
    mb = torch.tensor([b - 1, 5000, 3, -1, b - 1, 4096], dtype=torch.int32)
    for j in range(f):
        if mb[j] >= 0:
            binsT[j, rng.rand(n) < 0.1] = int(mb[j])
    binsT, mb = binsT.to(dev), mb.to(dev)
    for thr_b, mode in ((4000, "tiled"), (b, "global")):
        st = _deep_trees(4, 255, f, thr_b, 11, segments=False)
        tb = P.pack_ensemble(st, int(st.node_left.shape[1]), dev)
        cuda_hist.reset_launch_counts()
        out = P.predict_ensemble(tb, binsT, mb, (0, 4), 1)
        ref = P.predict_ensemble_plain(tb, binsT, mb, (0, 4), 1, None, None,
                                       P.new_carry(n, 1, "float64", dev))
        assert torch.equal(out, ref), mode
        assert getattr(P.predict_ensemble_geometry, "launches_" + mode) == 1


def _data_layer_run(name, tmp):
    """(params, X, y, Dataset keyword arguments) of a data-layer training:
    wide bins fused, q8 and classic, a 400-category feature, CSR with and
    without bundles, forced bins, max_bin_by_feature, forced splits and
    the three CEGB modes."""
    import json

    import scipy.sparse as sps
    rng = np.random.RandomState(6)
    n = 20_000
    X = rng.randn(n, 10).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + np.sin(X[:, 4])
         + 0.5 * rng.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    kw = {}
    if name.startswith("wide"):
        p["max_bin"] = 1023
        p.update({"wide_q8": {"quantized_grad": True},
                  "wide_classic": {"split_fusion": "off"}}.get(name, {}))
    elif name == "cat400":
        X[:, 5] = rng.randint(0, 400, n)
        y = (y + (X[:, 5] % 7 == 0) > 0.5).astype(float)
        p.update(max_bin=511, cat_smooth=1.0, min_data_per_group=5)
        kw = {"categorical_feature": [5]}
    elif name.startswith("csr"):
        Xs = sps.random(n, 300, density=0.02, random_state=rng,
                        format="csr", data_rvs=lambda k: rng.uniform(
                            0.5, 2.0, k))
        X = sps.hstack([Xs, sps.csr_matrix(X[:, :3])]).tocsr()
        y = (np.asarray(Xs[:, :50].sum(1)).ravel() + X[:, 300].toarray()
             .ravel() > 0.6).astype(float)
        if name == "csr_unbundled":
            p["enable_bundle"] = False
    elif name == "forced_bins":
        path = tmp / "bins.json"
        path.write_text(json.dumps([{"feature": 0, "bin_upper_bound":
                                     [-1.0, 0.0, 0.5, 1.5]}]))
        p["forcedbins_filename"] = str(path)
    elif name == "max_bin_by_feature":
        p["max_bin_by_feature"] = [15, 511, 31, 7, 63, 255, 1023, 2, 100, 9]
    elif name == "forced_splits":
        path = tmp / "forced.json"
        path.write_text(json.dumps({
            "feature": 0, "threshold": 0.0,
            "left": {"feature": 1, "threshold": 0.5},
            "right": {"feature": 2, "threshold": -0.5}}))
        p["forcedsplits_filename"] = str(path)
    elif name == "cegb_split":
        p["cegb_penalty_split"] = 0.1
    elif name == "cegb_coupled":
        p["cegb_penalty_feature_coupled"] = [1.0] * 10
    elif name == "cegb_lazy":
        p["cegb_penalty_feature_lazy"] = [0.01] * 10
    return p, X, y, kw


DATA_LAYER = ("wide", "wide_q8", "wide_classic", "cat400", "csr",
              "csr_unbundled", "forced_bins", "max_bin_by_feature",
              "forced_splits", "cegb_split", "cegb_coupled", "cegb_lazy")


@pytest.mark.parametrize("name", DATA_LAYER)
def test_data_layer_training_on_card_equals_cpu(dev, name, tmp_path):
    """A data-layer training on the card gives the same model text twice
    and the CPU's with the kernel's sums (f32) or on its plain path (q8);
    the wide runs launch only the wide modes."""
    import contextlib

    import lightgbm_tpu_torch as lgb
    params, X, y, kw = _data_layer_run(name, tmp_path)
    q8 = params.get("quantized_grad", False)
    texts = {}
    for d in ("cuda", "cuda_again", "cpu"):
        p = dict(params, device_type=d.split("_")[0])
        cuda_hist.reset_launch_counts()
        with (cuda_hist.kernel_sums_on_cpu() if d == "cpu" and not q8
              else contextlib.nullcontext()):
            texts[d] = lgb.train(p, lgb.Dataset(X, label=y, params=p, **kw),
                                 4).model_to_string()
        if d == "cuda" and name.startswith("wide"):
            counts = cuda_hist.launch_counts()
            assert sum(v for c, v in counts.items() if "_wide" in c) > 0
            assert sum(v for c, v in counts.items()
                       if c.startswith(("hist_tile.", "split_epilogue."))
                       and "_wide" not in c) == 0
    assert texts["cuda"] == texts["cuda_again"]
    assert texts["cuda"] == texts["cpu"]


# ------------------------------------------------------ precision modes
@pytest.mark.parametrize("b", [255, 1023])
@pytest.mark.parametrize("form", ["root", "slots", "gather"])
def test_hist_tile_dp_matches_exact(dev, form, b):
    """The f64 mode of the plane-only forms (gpu_use_dp): bitwise
    ``hist_tile_exact`` at float64 and a second launch, its planes rounded
    to float32 bitwise the f32 mode's on the same inputs, within 1e-11 of
    the summed magnitudes of a float64 sum, and counted as f64 launches."""
    n, f = 200_003, 28
    p = 1 if form == "root" else 42
    leaves = p + 5
    binsT, leaf, stats = (_hist_inputs(n, f, b, leaves, n + b, False)
                          if b <= 256 else
                          _wide_inputs(n, f, b, leaves, n + b, False))
    sel = torch.arange(p, dtype=torch.int32)
    chan = cuda_hist.chan_leaf_table(sel)
    idx = None
    if form == "gather":
        keep = torch.nonzero(leaf < 9).reshape(-1)
        idx = torch.cat([keep, torch.full((13,), n)]).to(torch.int32)
    args = [t.to(dev) for t in (binsT, leaf, stats, chan)]
    gidx = None if idx is None else idx.to(dev)
    f64 = torch.float64
    cuda_hist.reset_launch_counts()
    k = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True, dtype=f64)
    again = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True,
                                dtype=f64)
    k32 = cuda_hist.hist_tile(*args, p, b, leaves, gidx, plane=True)
    counts = cuda_hist.launch_counts()
    w = "_wide" if b > 256 else ""
    assert counts[f"hist_tile.launches_plane{w}_dp"] == 2
    assert counts[f"hist_tile.gather_launches{w}_dp"] == (
        2 if form == "gather" else 0)
    assert counts[f"hist_tile.launches_plane{w}"] == 1
    exact = cuda_hist.hist_tile_exact(*args, p, b, leaves, gidx, dtype=f64)
    plain = cuda_hist.hist_tile_plain(*args, p, b, leaves, gidx, dtype=f64)
    mag = cuda_hist.hist_tile_plain(args[0], args[1], args[2].abs(), args[3],
                                    p, b, leaves, gidx, dtype=f64)
    torch.cuda.synchronize()
    assert k.dtype == f64
    assert torch.equal(k.view(torch.int64), exact.view(torch.int64))
    assert torch.equal(k.view(torch.int64), again.view(torch.int64))
    assert torch.equal(k.to(torch.float32).view(torch.int32),
                       k32.view(torch.int32))
    assert bool(((k - plain).abs() <= 1e-11 * mag + 1e-300).all())


PRECISION = {
    "dp_numerical": ({"gpu_use_dp": True}, False),
    "dp_categorical": ({"gpu_use_dp": True}, "cat"),
    "dp_sparse": ({"gpu_use_dp": True}, "sparse"),
    "dp_bagging": ({"gpu_use_dp": True, "bagging_fraction": 0.7,
                    "bagging_freq": 1}, False),
    "linear_regression": ({"linear_tree": True, "linear_lambda": 0.01,
                           "objective": "regression"}, "nan"),
    "linear_binary": ({"linear_tree": True}, False),
}


@pytest.mark.parametrize("name", sorted(PRECISION))
def test_precision_training_on_card_equals_cpu(dev, name):
    """A gpu_use_dp or linear_tree training on the card gives the same
    model text twice and the CPU's with the kernel's sums; gpu_use_dp
    launches the f64 plane-only forms alone, linear_tree the fused path's
    f32 kernels."""
    import lightgbm_tpu_torch as lgb
    extra, data = PRECISION[name]
    rng = np.random.RandomState(11)
    n = 20_000
    X = rng.randn(n, 10).astype(np.float32)
    kw = {}
    if data == "cat":
        X[:, 5] = rng.randint(0, 30, n)
        kw = {"categorical_feature": [5]}
    elif data == "sparse":
        X[rng.rand(n) < 0.93, 4] = 0.0
    y = (X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + (X[:, 5] > 1)
         + 0.5 * rng.randn(n) > 0).astype(float)
    if data == "nan":
        y = np.where(X[:, 1] > 0, 2 * X[:, 0], -X[:, 2]) + 0.3 * rng.randn(n)
        X[rng.rand(n) < 0.05, 0] = np.nan
    params = dict({"objective": "binary", "num_leaves": 31,
                   "verbosity": -1}, **extra)
    texts = {}
    for d in ("cuda", "cuda_again", "cpu"):
        p = dict(params, device_type=d.split("_")[0])
        cuda_hist.reset_launch_counts()
        with (cuda_hist.kernel_sums_on_cpu() if d == "cpu"
              else contextlib.nullcontext()):
            texts[d] = lgb.train(p, lgb.Dataset(X, label=y, params=p, **kw),
                                 3).model_to_string()
        if d == "cuda":
            got = {c: v for c, v in cuda_hist.launch_counts().items() if v}
            if name.startswith("dp"):
                assert got.get("hist_tile.launches_plane_dp", 0) > 0
                assert all(c.endswith("_dp") for c in got
                           if c.startswith(("hist_tile.",
                                            "split_epilogue.")))
            else:
                assert got.get("hist_tile.launches", 0) > 0
                assert got.get("split_epilogue.launches", 0) > 0
    assert texts["cuda"] == texts["cuda_again"]
    assert texts["cuda"] == texts["cpu"]
    if name.startswith("linear"):
        assert "is_linear=1" in texts["cuda"]


def _control_text(name, device):
    """One training-control run (early stopping with a rate schedule, fobj
    with feval, init_model, rollback, reset_parameter, a cv fold) on
    ``device``: its model text."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(13)
    n = 20_000
    X = rng.randn(n, 10).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3] + rng.randn(n) > 0
         ).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "metric": "binary_logloss", "device_type": device}
    cut = 16_000

    def sets():
        ds = lgb.Dataset(X[:cut], label=y[:cut], params=dict(p),
                         free_raw_data=False)
        vs = lgb.Dataset(X[cut:], label=y[cut:], reference=ds,
                         free_raw_data=False)
        return ds, vs

    ds, vs = sets()
    if name == "early_stopping":
        b = lgb.train(p, ds, 8, valid_sets=[vs], early_stopping_rounds=1,
                      learning_rates=[0.1] * 3 + [1.2] * 5)
    elif name == "fobj":
        def fobj(score, d):
            pr = 1.0 / (1.0 + np.exp(-score))
            return pr - d.get_label(), pr * (1.0 - pr)
        b = lgb.train(dict(p, metric="None"), ds, 3, valid_sets=[vs],
                      fobj=fobj, feval=lambda s, d: ("mean", s.mean(), True))
    elif name == "init_model":
        first = lgb.train(p, ds, 2)
        ds, vs = sets()
        b = lgb.train(p, ds, 2, valid_sets=[vs], init_model=first)
    elif name == "rollback":
        b = lgb.train(p, ds, 3, valid_sets=[vs])
        b.rollback_one_iter()
        b.update()
    elif name == "reset_parameter":
        b = lgb.train(dict(p, bagging_fraction=0.8, bagging_freq=1), ds, 3,
                      valid_sets=[vs], callbacks=[lgb.reset_parameter(
                          lambda_l2=lambda i: 0.0 if i < 1 else 4.0,
                          bagging_fraction=lambda i: 0.8 if i < 2 else 0.4)])
    else:
        res = lgb.cv(p, ds, 3, nfold=3, return_cvbooster=True)
        b = res["cvbooster"].boosters[0]
    return b.model_to_string()


@pytest.mark.parametrize("name", ["early_stopping", "fobj", "init_model",
                                  "rollback", "reset_parameter", "cv"])
def test_training_control_on_card_equals_cpu(dev, name):
    """Each training-control run gives the same model text twice on the
    card and the CPU's with the kernel's sums, and launches the fused
    path's kernels."""
    cuda_hist.reset_launch_counts()
    card = _control_text(name, "cuda")
    got = cuda_hist.launch_counts()
    assert got["hist_tile.launches"] - got["hist_tile.launches_plane"] > 0
    assert got["split_epilogue.launches"] > 0
    assert _control_text(name, "cuda") == card
    with cuda_hist.kernel_sums_on_cpu():
        assert _control_text(name, "cpu") == card


def test_free_dataset_releases_device_memory(dev):
    """free_dataset gives back at least the bin matrix's bytes of device
    memory, and the booster still predicts the same."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(14)
    X = rng.randn(200_000, 28).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    p = {"objective": "binary", "verbosity": -1, "device_type": "cuda"}
    ds = lgb.Dataset(X, label=y, params=p)
    b = lgb.train(p, ds, 2)
    bins_bytes = ds.binsT.numel() * ds.binsT.element_size()
    pred = b.predict(X[:1000])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    b.free_dataset()
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() >= bins_bytes
    np.testing.assert_array_equal(b.predict(X[:1000]), pred)


def _predict_model(kind, device):
    """A small model trained on ``device``: uint8 bins (``u8``), int16
    bins (``wide``, max_bin 1,023), a 300-category feature (``cat``), 3
    classes (``multi``) or a >= 90%-zero column stored sparse
    (``sparse``)."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.RandomState(21)
    n = 20_000
    X = rng.randn(n, 10)
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + X[:, 1] * np.nan_to_num(X[:, 2]) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "device_type": device}
    kw = {}
    if kind == "wide":
        p["max_bin"] = 1023
    if kind == "cat":
        X[:, 5] = rng.randint(0, 300, n)
        kw["categorical_feature"] = [5]
    if kind == "multi":
        p.update(objective="multiclass", num_class=3)
        y = np.digitize(X[:, 0] + 0.5 * X[:, 3], [-0.5, 0.5]).astype(float)
    if kind == "sparse":
        X[:, 7] = np.where(rng.rand(n) < 0.95, 0.0, rng.rand(n))
    b = lgb.train(p, lgb.Dataset(X, label=y, params=dict(p), **kw), 6)
    return b, X


@pytest.mark.parametrize("kind", ["u8", "wide", "cat", "multi"])
def test_predict_ensemble_matches_plain(dev, kind):
    """The ensemble traversal kernel is bitwise its plain version (run on
    the card's tensors) and a second launch, in every accumulation mode,
    with and without biases and an active mask, and in leaves mode."""
    from lightgbm_tpu_torch.ops import predict as P
    b, X = _predict_model(kind, "cuda")
    g = b._boosting
    eng = g._predict_engine()
    tb, k, t = eng.tables, eng.k, eng.T
    binsT = g.train_set.bin_new_data(X[:5000])
    assert binsT.dtype == (torch.int16 if kind in ("wide", "cat")
                           else torch.uint8)
    mb = g.train_set.missing_bin.to(dev)
    n = binsT.shape[1]
    bias = torch.as_tensor(np.random.RandomState(3).randn(t) * 0.01,
                           dtype=torch.float64, device=dev)
    act = torch.as_tensor(np.random.RandomState(4).rand(n) < 0.5,
                          device=dev)
    for accum in ("float64", "compensated", "float32"):
        for kw in ({}, {"bias": bias}, {"active": act},
                   {"bias": bias, "active": act}):
            outs = [P.predict_ensemble(tb, binsT, mb, (1, t), k,
                                       accum=accum, **kw) for _ in range(2)]
            ref = P.predict_ensemble_plain(
                tb, binsT, mb, (1, t), k, kw.get("bias"), kw.get("active"),
                P.new_carry(n, k, accum, dev), accum)
            for o in outs:
                for a, r in zip(*(x if accum == "compensated" else (x,)
                                  for x in (o, ref))):
                    assert torch.equal(a, r), (accum, list(kw))
    lv = [P.predict_ensemble(tb, binsT, mb, (0, t), k, leaves=True)
          for _ in range(2)]
    ref = P.predict_ensemble_plain(tb, binsT, mb, (0, t), k, leaves=True)
    assert torch.equal(lv[0], ref) and torch.equal(lv[1], ref)


def _deep_trees(count, leaves, f, b, seed, segments=True):
    """Random unbalanced trees of ``leaves`` leaves (a leaf drawn at random
    splits next; with ``segments`` a third of the nodes on EFB bundle
    segments), stacked."""
    from lightgbm_tpu_torch.models.tree import empty_tree, stack_trees
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(count):
        li = leaves - 1
        left, right = np.zeros(li, np.int32), np.zeros(li, np.int32)
        open_leaves, link = [0], {}
        for node in range(li):
            leaf = open_leaves.pop(rng.randint(len(open_leaves)))
            if leaf in link:
                arr, pos = link.pop(leaf)
                arr[pos] = node
            left[node], right[node] = ~leaf, ~(node + 1)
            link[leaf], link[node + 1] = (left, node), (right, node)
            open_leaves += [leaf, node + 1]
        trees.append(empty_tree(leaves)._replace(
            num_leaves=torch.tensor(leaves, dtype=torch.int32),
            node_feature=torch.as_tensor(rng.randint(0, f, li),
                                         dtype=torch.int32),
            node_threshold_bin=torch.as_tensor(rng.randint(0, b - 1, li),
                                               dtype=torch.int32),
            node_default_left=torch.as_tensor(rng.rand(li) < 0.5),
            node_left=torch.as_tensor(left), node_right=torch.as_tensor(right),
            leaf_value=torch.as_tensor(rng.randn(leaves).astype(np.float32)),
            node_seg_lo=torch.as_tensor(
                np.where((rng.rand(li) < 1 / 3) & segments, 2, -1),
                dtype=torch.int32)))
        trees[-1] = trees[-1]._replace(node_seg_hi=torch.where(
            trees[-1].node_seg_lo >= 0, trees[-1].node_seg_lo + b // 3,
            trees[-1].node_seg_lo))
    return stack_trees(trees)


@pytest.mark.parametrize("case,mode", [
    ("model", "tiled"), ("leaves_1023", "tiled"),
    ("columns_2000", "global"), ("segments_4095", "global")])
def test_predict_ensemble_geometries_match_plain(dev, case, mode):
    """Each of the kernel's geometries, chosen by ``launch_geometry`` from
    the shape (a model's 10 columns; 1,023-leaf trees; the columns inside
    2,000 handed over as a column slice; 4,095-leaf trees on EFB
    segments), bitwise its plain version in the float64 mode with biases
    and in leaves mode, a second launch equal, every launch counted in
    that geometry."""
    from lightgbm_tpu_torch.ops import predict as P
    b, X = _predict_model("u8", "cuda")
    g = b._boosting
    tb = g._predict_engine().tables
    binsT = g.train_set.bin_new_data(X[:4000])
    mb = g.train_set.missing_bin.to(dev).to(torch.int32)
    if case in ("leaves_1023", "segments_4095"):
        leaves = 1023 if case == "leaves_1023" else 4095
        st = _deep_trees(3, leaves, binsT.shape[0], 32, 5,
                         segments=case == "segments_4095")
        tb = P.pack_ensemble(st, int(st.node_left.shape[1]), dev)
    if case == "columns_2000":
        cols = 2000
        big = torch.zeros((cols, binsT.shape[1] + 9), dtype=binsT.dtype,
                          device=dev)
        big[:binsT.shape[0], 3:-6] = binsT
        binsT = big[:, 3:-6]
        mb = torch.cat([mb, torch.full((cols - mb.shape[0],), -1,
                                       dtype=torch.int32, device=dev)])
    n, t = binsT.shape[1], int(tb.nodes.shape[0])
    geo = P.launch_geometry(n, binsT.shape[0], binsT.element_size(),
                            int(tb.nodes.shape[1]),
                            int(tb.stacked.leaf_value.shape[1]), tb.has_cat,
                            tb.has_seg)
    assert geo.mode == mode
    bias = torch.as_tensor(np.random.RandomState(3).randn(t) * 0.01,
                           dtype=torch.float64, device=dev)
    cuda_hist.reset_launch_counts()
    outs = [P.predict_ensemble(tb, binsT, mb, (0, t), 1, bias=bias)
            for _ in range(2)]
    ref = P.predict_ensemble_plain(tb, binsT, mb, (0, t), 1, bias, None,
                                   P.new_carry(n, 1, "float64", dev))
    assert torch.equal(outs[0], ref) and torch.equal(outs[1], ref)
    lv = [P.predict_ensemble(tb, binsT, mb, (0, t), leaves=True)
          for _ in range(2)]
    ref = P.predict_ensemble_plain(tb, binsT, mb, (0, t), leaves=True)
    assert torch.equal(lv[0], ref) and torch.equal(lv[1], ref)
    assert getattr(P.predict_ensemble_geometry, "launches_" + mode) == 4
    assert sum(getattr(P.predict_ensemble_geometry, c) for c in
               cuda_hist._COUNTERS["predict_ensemble_geometry"]) == 4


@pytest.mark.parametrize("kind", ["u8", "multi", "sparse"])
def test_predict_on_card_equals_cpu(dev, kind):
    """A card booster's predictions (raw, converted, leaves, early stop,
    a window) are bitwise those of its trees carried to a CPU booster,
    its contributions within 1e-9 / 1e-11, and every predict launches the
    kernel."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import predict as P
    b, X = _predict_model(kind, "cuda")
    twin = lgb.booster_from_numpy(*lgb.booster_to_numpy(b, "cpu"))
    Xs = X[:3000]
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True},
               {"raw_score": True, "pred_early_stop": True,
                "pred_early_stop_freq": 2, "pred_early_stop_margin": 1.0},
               {"start_iteration": 1, "num_iteration": 3}):
        cuda_hist.reset_launch_counts()
        got = b.predict(Xs, **kw)
        launched = sum(getattr(P.predict_ensemble, c) for c in
                       cuda_hist._COUNTERS["predict_ensemble"])
        assert launched >= 1, kw
        np.testing.assert_array_equal(got, twin.predict(Xs, **kw))
    np.testing.assert_allclose(b.predict(Xs[:500], pred_contrib=True),
                               twin.predict(Xs[:500], pred_contrib=True),
                               rtol=1e-9, atol=1e-11)


# ------------------------------------------------------------ fault tolerance
def _fault_data(n=20_000, f=120, seed=31):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 3] - 0.5 * X[:, 40] + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


def _fault_text(device, extra, rounds=3, **kw):
    import lightgbm_tpu_torch as lgb
    X, y = _fault_data()
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "device_type": device, **extra}
    b = lgb.train(p, lgb.Dataset(X, label=y, params=dict(p)), rounds, **kw)
    return b, b.model_to_string()


def test_blocked_pass_on_card_equals_resident_and_cpu(dev):
    """histogram_pool_size 7 MB: 21 columns a block (6 blocks); the trees
    equal the resident run's with hist_subtraction=False and the CPU's in
    the kernels' orders, and kernel 3 launches once a block a pass."""
    cuda_hist.reset_launch_counts()
    b, blocked = _fault_text("cuda", {"histogram_pool_size": 7.0})
    got = cuda_hist.launch_counts()
    assert b._boosting._feature_block() == 21
    assert got["split_epilogue.launches"] == 0
    assert got["hist_tile.launches_plane"] > 0
    assert got["hist_tile.launches_plane"] % 6 == 0
    assert got["hist_tile.gather_launches"] == 0
    _, resident = _fault_text("cuda", {"hist_subtraction": False})
    trees = lambda t: t.split("\nparameters:")[0]
    assert trees(blocked) == trees(resident)
    assert _fault_text("cuda", {"histogram_pool_size": 7.0})[1] == blocked
    with cuda_hist.kernel_sums_on_cpu():
        assert _fault_text("cpu", {"histogram_pool_size": 7.0})[1] == blocked


def test_resume_on_card_is_bitwise(dev, tmp_path):
    import lightgbm_tpu_torch as lgb
    extra = {"bagging_fraction": 0.7, "bagging_freq": 2,
             "feature_fraction": 0.8}
    _, full = _fault_text("cuda", extra, rounds=6)
    ck = str(tmp_path / "ck")
    _fault_text("cuda", extra, rounds=3,
                callbacks=[lgb.checkpoint_callback(ck, period=1)])
    _, resumed = _fault_text("cuda", extra, rounds=6, resume_from=ck)
    assert resumed == full


def test_real_out_of_memory_is_resource_exhausted(dev):
    from lightgbm_tpu_torch.utils import faults
    total = torch.cuda.get_device_properties(dev).total_memory
    with pytest.raises(torch.cuda.OutOfMemoryError) as e:
        torch.empty((2 * total,), dtype=torch.uint8, device=dev)
    assert faults.is_resource_exhausted(e.value)


def test_predict_rung_on_card_keeps_the_bits(dev, monkeypatch):
    from lightgbm_tpu_torch.utils import faults
    b, _ = _fault_text("cuda", {})
    X, _ = _fault_data(n=100_000, seed=5)
    want = b.predict(X)
    b.reset_parameter({"predict_chunk_rows": 65_536})
    faults.reset_predict_oom()
    monkeypatch.setenv("LGBM_TPU_FAULT_OOM_AT_PREDICT", "2")
    cuda_hist.reset_launch_counts()
    got = b.predict(X)
    faults.reset_predict_oom()
    assert b._boosting._oom_predict_chunk == 16_384
    np.testing.assert_array_equal(got, want)
    c = cuda_hist.launch_counts()
    assert sum(v for k, v in c.items()
               if k.startswith("predict_ensemble.")) == -(-100_000 // 16_384)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("rows", [1, 8192])
def test_predict_ensemble_serve_sizes_match_plain(dev, rows):
    """The kernel at a serve flush's row counts (1 and 8,192 rows), in
    every accumulation mode: bitwise its plain version on the card's
    tensors and a second launch."""
    from lightgbm_tpu_torch.ops import predict as P
    b, X = _predict_model("u8", "cuda")
    g = b._boosting
    eng = g._predict_engine()
    binsT = g.train_set.bin_new_data(X[:rows])
    mb = g.train_set.missing_bin.to(dev)
    for accum in ("float64", "compensated", "float32"):
        one = P.predict_ensemble(eng.tables, binsT, mb, (0, eng.T), eng.k,
                                 accum=accum)
        two = P.predict_ensemble(eng.tables, binsT, mb, (0, eng.T), eng.k,
                                 accum=accum)
        ref = P.predict_ensemble_plain(
            eng.tables, binsT, mb, (0, eng.T), eng.k,
            carry=P.new_carry(rows, eng.k, accum, dev), accum=accum)
        flat = [torch.cat(c, 1) if isinstance(c, tuple) else c
                for c in (one, two, ref)]
        assert torch.equal(flat[0], flat[2]) and torch.equal(flat[0],
                                                             flat[1])


@pytest.mark.parametrize("kind", ["u8", "cat", "multi"])
def test_serve_mode_steady_state_allocates_nothing(dev, kind):
    """Serve mode: after each bucket's first flush, flushes of 1 to 8,192
    rows make no device allocation (the caching allocator's request
    count stays), keep every slot buffer's address, launch the kernel once
    each, and answer bitwise the ordinary path."""
    b, X = _predict_model(kind, "cuda")
    g = b._boosting
    sizes = [1, 700, 1024, 1500, 5000, 8192, 3, 2048, 4096, 64]
    want = {n: b.predict(X[:n], raw_score=True) for n in set(sizes)}
    g.enable_serve_mode(True)
    try:
        for n in sizes:
            b.predict(X[:n], raw_score=True)
        eng = g._predict_engine()
        assert sorted(eng._serve_slots) == [1024, 2048, 4096, 8192]
        ptrs = {bk: {k: t.data_ptr() for k, t in sl.tensors().items()}
                for bk, sl in eng._serve_slots.items()}
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        cuda_hist.reset_launch_counts()
        got = {n: b.predict(X[:n], raw_score=True) for n in sizes}
        torch.cuda.synchronize()
        after = torch.cuda.memory_stats()["allocation.all.allocated"]
        c = cuda_hist.launch_counts()
        assert after == before
        assert sum(v for k, v in c.items()
                   if k.startswith("predict_ensemble.")) == len(sizes)
        assert {bk: {k: t.data_ptr() for k, t in sl.tensors().items()}
                for bk, sl in eng._serve_slots.items()} == ptrs
    finally:
        g.enable_serve_mode(False)
    for n in sizes:
        np.testing.assert_array_equal(got[n], want[n])


# ------------------------------------------------- distributed learners
@pytest.mark.parametrize("form", ["root", "slots", "gather"])
@pytest.mark.parametrize("dp", [False, True])
def test_hist_tile_integer_planes_match_exact(dev, form, dp):
    """The integer-planes mode (``raw=True``, the exponent from the gang's
    ``amax`` and ``rows``): int64 planes bitwise ``hist_tile_exact``'s
    integers and a second launch; two row halves' planes add to one
    pass's; ``hist_convert`` of them bitwise its plain version and the
    one-pass planes of ``hist_tile_exact`` (f32 and f64); counted apart."""
    n, f, b = 200_003, 28, 255
    p = 1 if form == "root" else 42
    leaves = p + 5
    binsT, leaf, stats = _hist_inputs(n, f, b, leaves, n + p, False)
    sel = torch.arange(p, dtype=torch.int32)
    chan = cuda_hist.chan_leaf_table(sel)
    idx = None
    if form == "gather":
        keep = torch.nonzero(leaf < 9).reshape(-1)
        idx = torch.cat([keep, torch.full((13,), n)]).to(torch.int32)
    binsT, leaf, stats, chan = (t.to(dev) for t in (binsT, leaf, stats,
                                                    chan))
    gidx = None if idx is None else idx.to(dev)
    amax = cuda_hist._absmax(stats)
    rows = 2 * n                          # a gang of two such ranks
    dtype = torch.float64 if dp else torch.float32
    cuda_hist.reset_launch_counts()
    k = cuda_hist.hist_tile(binsT, leaf, stats, chan, p, b, leaves, gidx,
                            plane=True, amax=amax, rows=rows, raw=True)
    again = cuda_hist.hist_tile(binsT, leaf, stats, chan, p, b, leaves,
                                gidx, plane=True, amax=amax, rows=rows,
                                raw=True)
    exact = cuda_hist.hist_tile_exact(binsT, leaf, stats, chan, p, b, leaves,
                                      gidx, amax, rows=rows, raw=True)
    assert k.dtype == torch.int64
    assert torch.equal(k, exact) and torch.equal(k, again)
    if form != "gather":
        h = n // 2
        lo = cuda_hist.hist_tile(binsT[:, :h].contiguous(), leaf[:h],
                                 stats[:h], chan, p, b, leaves, plane=True,
                                 amax=amax, rows=rows, raw=True)
        hi = cuda_hist.hist_tile(binsT[:, h:].contiguous(), leaf[h:],
                                 stats[h:].contiguous(), chan, p, b, leaves,
                                 plane=True, amax=amax, rows=rows, raw=True)
        assert torch.equal(lo + hi, k)
    conv = cuda_hist.hist_convert(k, amax, rows, dtype)
    plain = cuda_hist.hist_convert_plain(k, amax, rows, dtype)
    one = cuda_hist.hist_tile_exact(binsT, leaf, stats, chan, p, b, leaves,
                                    gidx, amax, dtype, rows=rows)
    counts = cuda_hist.launch_counts()
    assert counts["hist_tile.launches_plane_raw"] == (2 if form == "gather"
                                                      else 4)
    assert counts["hist_convert.launches" + ("_dp" if dp else "")] == 1
    assert torch.equal(conv, plain) and torch.equal(conv, one)


@pytest.mark.parametrize("learner", ["data", "feature", "voting"])
def test_distributed_learner_on_card_equals_cpu(dev, learner):
    """Two thread-ranks sharing the card (gloo through host memory): the
    model text twice the same, and the CPU gang's inside
    ``kernel_sums_on_cpu()`` (the data learner through the integer planes
    on both)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import network
    rng = np.random.RandomState(3)
    X = rng.randn(20_000, 10)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "tree_learner": learner, "top_k": 4}

    def run(device):
        def body(net):
            p = dict(params, device_type=device)
            with (cuda_hist.kernel_sums_on_cpu() if device == "cpu"
                  else contextlib.nullcontext()):
                ds = lgb.Dataset(X, label=y.astype(float), params=p)
                return lgb.train(p, ds, 3).model_to_string()
        return network.thread_gang(2, body, device=device)

    card, card2, cpu = run("cuda"), run("cuda"), run("cpu")
    assert card[0] == card[1] == card2[0] == cpu[0]


# ------------------------------------------ streaming construct, sharding
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streaming_bins_on_card_match_host(dev, dtype):
    """The streaming construct's bin pass on the card (the pinned staging
    buffer, one write in flight), float32 and float64 chunks, a NaN column
    and a categorical one (the host lookup): ``binsT`` bitwise
    ``binning.bin_data`` on the host and the monolithic construct's, the
    peak host bytes within a chunk plus the staged copy."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import binning
    rng = np.random.RandomState(8)
    n, f, c = 30_000, 9, 7_000
    X = rng.randn(n, f).astype(dtype)
    X[rng.rand(n) < 0.05, 2] = np.nan
    X[:, 4] = rng.randint(0, 40, n)
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] > 0).astype(float)
    p = {"verbosity": -1, "device_type": "cuda", "sketch_max_size": 0}
    ds = lgb.Dataset.from_chunks(
        [(X[s:s + c], y[s:s + c]) for s in range(0, n, c)],
        categorical_feature=[4], params=dict(p)).construct()
    mono = lgb.Dataset(X, label=y, categorical_feature=[4],
                       params=dict(p)).construct()
    assert ds.binsT.device.type == "cuda"
    host = binning.bin_data(X[:, ds.used_features],
                            [ds.mappers[j] for j in ds.used_features])
    assert np.array_equal(ds.binsT.cpu().numpy(), host.T)
    assert torch.equal(ds.binsT, mono.binsT)
    assert 0 < ds.construct_stats["peak_host_bytes"] <= 2 * c * f * X.itemsize


def test_sharded_predict_on_card_is_bitwise(dev):
    """``predict_sharded`` over the device list [cuda, cuda] in chunks of
    7,000 rows: converted, raw, early-stopped and leaf outputs bitwise the
    unsharded ones, one launch a (chunk, shard)."""
    b, X = _predict_model("u8", "cuda")
    g = b._boosting
    es = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.0)
    want = (b.predict(X), b.predict(X, raw_score=True), b.predict(X, **es),
            b.predict(X, pred_leaf=True))
    g.config.predict_sharded = True
    g.config.predict_chunk_rows = 7_000
    g.predict_devices = [dev, dev]
    g._engine_cache.clear()
    try:
        cuda_hist.reset_launch_counts()
        got = b.predict(X)
        c = cuda_hist.launch_counts()
        rest = (b.predict(X, raw_score=True), b.predict(X, **es),
                b.predict(X, pred_leaf=True))
    finally:
        g.config.predict_sharded = False
        g.config.predict_chunk_rows = 0
        g.predict_devices = None
        g._engine_cache.clear()
    assert sum(v for k, v in c.items()
               if k.startswith("predict_ensemble.")) == 3 * 2
    for a, w in zip((got,) + rest, want):
        np.testing.assert_array_equal(a, w)
