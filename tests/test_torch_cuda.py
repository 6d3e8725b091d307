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
``split_epilogue_plain`` on identical planes (built with ``--fmad=false``);
training on the card gives the same model text twice, and the CPU plain
path's structure, on the fused and on the classic path. The q8 mode
(quantized gradients): ``hist_tile`` on int8 stats and the dequantizing
``split_epilogue`` bitwise equal to their plain versions (exact int32
sums), and a q8 training's model text on the card bitwise the CPU's.
The experiment script's ``hist_onehot`` (bf16 tensor cores) within 1e-5
of each cell's summed magnitudes of its plain version.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import cuda_hist

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
    """42 computed slots at 255 bins take two slot parts; fewer, one."""
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


@pytest.mark.parametrize("p,f,b", [(42, 28, 255), (6, 5, 16), (3, 2, 256),
                                   (1, 1, 3)])
@pytest.mark.parametrize("pv", [[0, 1, 0, 0, 20, 1e-3, 0],
                                [0.5, 2, 0.7, 3, 5, 1, 0.01]],
                         ids=["default", "regularised"])
def test_split_epilogue_matches_plain(dev, p, f, b, pv):
    tile, parent, der, la, fm = _epilogue_inputs(p, f, b, p * f + b)
    pvec = torch.tensor(pv + [0.0], dtype=torch.float32)
    args = [t.to(dev) for t in (tile, parent, der, la, fm, pvec)]
    before = cuda_hist.split_epilogue.launches
    kf, kc = cuda_hist.split_epilogue(*args)
    assert cuda_hist.split_epilogue.launches == before + 1
    pf, pc = cuda_hist.split_epilogue_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), pf.view(torch.int32))
    # the plain version on the card equals it on the CPU
    cf, cc = cuda_hist.split_epilogue_plain(tile, parent, der, la, fm, pvec)
    assert torch.equal(pc.cpu().view(torch.int32), cc.view(torch.int32))


def test_wrapper_raises_instead_of_falling_back(dev):
    binsT, leaf, stats = _hist_inputs(100, 2, 8, 4, 0, True)
    chan = cuda_hist.chan_leaf_table(torch.arange(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="leaf_ids"):   # one tensor left
        cuda_hist.hist_tile(binsT.to(dev), leaf, stats.to(dev),
                            chan.to(dev), 2, 8, 4)      # on the CPU
    with pytest.raises(ValueError, match="num_bins"):
        cuda_hist.hist_tile(binsT.to(dev), leaf.to(dev), stats.to(dev),
                            chan.to(dev), 2, 300, 4)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_hist.hist_tile(binsT.to(dev), leaf.to(dev), stats.to(dev),
                            chan.to(dev), 2, 8, 60_000)


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
    only. 42 computed slots at 255 bins fit one slot part."""
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


@pytest.mark.parametrize("p,f,b", [(42, 28, 255), (6, 5, 16), (1, 1, 3)])
def test_split_epilogue_q8_matches_plain(dev, p, f, b):
    tile, parent, der, la, fm = _epilogue_inputs(p, f, b, p * f + b + 1)
    qtile = torch.round(tile * 37).to(torch.int32)
    q_scale = torch.tensor([0.0173, 0.00291, 1.0])
    pvec = torch.tensor([0, 1, 0, 0, 20, 1e-3, 0, 0], dtype=torch.float32)
    args = [t.to(dev) for t in (qtile, parent, der, la, fm, pvec)]
    cuda_hist.reset_launch_counts()
    kf, kc = cuda_hist.split_epilogue(*args, q_scale.to(dev))
    pf, pc = cuda_hist.split_epilogue_plain(*args, q_scale.to(dev))
    torch.cuda.synchronize()
    assert cuda_hist.split_epilogue.launches_q8 == 1
    assert cuda_hist.split_epilogue.launches == 0
    assert torch.equal(kc.view(torch.int32), pc.view(torch.int32))
    assert torch.equal(kf.view(torch.int32), pf.view(torch.int32))
    cf, cc = cuda_hist.split_epilogue_plain(qtile, parent, der, la, fm, pvec,
                                            q_scale)
    assert torch.equal(pc.cpu().view(torch.int32), cc.view(torch.int32))


@pytest.mark.parametrize("n,f,b,fg,blk", [
    (65_536, 28, 255, 2, 2048), (65_536, 28, 255, 7, 1024),
    (4_096, 5, 31, 4, 1024), (1_024, 1, 2, 3, 64)])
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
