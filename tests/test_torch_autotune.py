"""``hist_tile``'s launch geometry: the sweep (``autotune_hist``), the
parameters that steer it (``hist_block``, ``hist_autotune``) and the
traffic model (``traffic_model``), on the CPU.

The sweep times candidates only on the card (``chip_smoke.py --only
widebins`` prints each candidate's time and holds their planes bitwise
equal); here its contracts: off the card it returns the defaults without
timing; an explicit ``hist_block`` wins without a sweep; ``hist_autotune``
False is accepted and trains the same text (the JAX package's too); a
tuning dict ridden in from a checkpoint whose ``epilogue`` key is not the
pass's form is measured again; every geometry gives the same planes. The
traffic model gives the bytes counted by hand at small shapes and the
kernel table's bounds (PERF.md) at the main path's.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import cuda_hist

torch.set_num_threads(1)


def _data(n=3000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


P = {"objective": "binary", "num_leaves": 7, "verbosity": -1}


def test_autotune_off_the_card_returns_the_defaults_untimed(monkeypatch):
    called = []
    monkeypatch.setattr(cuda_hist, "hist_tile",
                        lambda *a, **k: called.append(1))
    binsT = torch.zeros((3, 100), dtype=torch.uint8)
    out = cuda_hist.autotune_hist(binsT, 255, epilogue=True)
    assert out == {"block": 0, "threads": 0, "tile_leaves": 0,
                   "epilogue": True, "times_ms": {}}
    assert not called and cuda_hist.tuned_geometry(out) is None


def test_autotune_measured_on_the_host_keeps_a_candidate():
    """``force_measure`` times the candidates on the host (the card's path
    without events): the winner is one of them, cached per shape bucket."""
    rng = np.random.RandomState(2)
    binsT = torch.as_tensor(rng.randint(0, 300, (3, 700)), dtype=torch.int16)
    cuda_hist._tuned.clear()
    out = cuda_hist.autotune_hist(binsT, 300, q8=True, force_measure=True)
    cands = cuda_hist.hist_candidates(3, 300, True)
    assert cuda_hist.tuned_geometry(out) in cands
    assert len(out["times_ms"]) == len(cands)
    assert out["tile_leaves"] == cuda_hist.structural_tile_leaves()
    assert cuda_hist.autotune_hist(binsT, 300, q8=True,
                                   force_measure=True) is out
    cuda_hist._tuned.clear()


@pytest.mark.parametrize("b", [255, 16383, 65535])
def test_every_candidate_gives_the_same_planes(b):
    """The sweep's passes under each candidate geometry: the same bits (on
    the CPU through the plain versions; on the card chip_smoke.py holds the
    kernels to the same)."""
    rng = np.random.RandomState(b)
    dt = torch.uint8 if b <= 256 else torch.int16 if b <= 32768 \
        else torch.int32
    binsT = torch.as_tensor(rng.randint(0, b, (3, 900)), dtype=dt)
    run = cuda_hist.autotune_pass(binsT, b, False, 600)
    cands = cuda_hist.hist_candidates(3, b, False)
    assert cands[0] == cuda_hist.DEFAULT_GEOMETRY
    assert len(set(cands)) == len(cands)
    ref = run(cands[0])
    for g in cands[1:]:
        for a, r in zip(run(g), ref):
            assert torch.equal(a, r)


@pytest.mark.parametrize("b,q8,cluster", [
    (255, False, 1), (16383, False, 2), (40000, False, 5),
    (58000, False, 7), (65535, False, 8), (65535, True, 4)])
def test_the_default_form_follows_the_split_ranges(b, q8, cluster):
    """Every pass takes the one form there is, shared-memory planes: one
    block's plane where a feature's fits, past it a cluster of as many
    CTAs as the bin ranges that fit a block (at most MAX_CLUSTER; the
    card measured it ahead of the global form, which went: PERF.md);
    a geometry ridden in with the old form keeps its rows and threads."""
    f = 28
    shape = cuda_hist.launch_shape(f, b, q8, True, cuda_hist.DEFAULT_GEOMETRY)
    assert shape[1:] == cuda_hist.bin_ranges(b, q8, True)
    assert shape[2] == cluster <= cuda_hist.MAX_CLUSTER
    assert (cluster > 1) == (b * 3 * (4 if q8 else 8) > 202_752)
    assert cuda_hist.tuned_geometry({"block": 8192, "threads": 512,
                                     "form": "global"}) == \
        cuda_hist.HistGeometry(8192, 512)


def _timed_sweep(monkeypatch, costs):
    """autotune_hist measured on the host with a clock that advances by
    ``costs[(block_rows, threads)][pass]`` ms a pass (the root pass, the
    gather pass at the 0.5 and at the 0.125 rung of the sample)."""
    import types
    clock = [0.0]
    k = 8000

    def fake(binsT, leaf, stats, chan, p, b, l, idx=None, geometry=None,
             **kw):
        kind = ("root" if idx is None else
                "rung_0.5" if idx.shape[0] == k // 2 else "rung_0.125")
        clock[0] += costs[(geometry.block_rows, geometry.threads)][kind] / 1e3
        return torch.zeros(1)
    monkeypatch.setattr(cuda_hist, "hist_tile", fake)
    monkeypatch.setattr(cuda_hist, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    cuda_hist._tuned.clear()
    binsT = torch.zeros((3, k), dtype=torch.uint8)
    try:
        return cuda_hist.autotune_hist(binsT, 255, sample_rows=k,
                                       force_measure=True)
    finally:
        cuda_hist._tuned.clear()


def test_the_sweep_weights_the_passes_as_a_tree_launches_them(monkeypatch):
    """A candidate's time is its root pass plus its gather passes at the
    ladder's rungs, each weighted by the passes of it a tree launches
    (TREE_PASSES: 1, 7.5, 7.5). A fast root does not buy a slower 0.5
    rung, a pass a tree launches 7.5 times; a candidate with a pass more
    than SWEEP_SLACK over the default's is not kept even when its
    weighted time wins."""
    flat = {"root": 1.0, "rung_0.5": 1.0, "rung_0.125": 1.0}
    costs = {(blk, th): dict(flat) for blk in cuda_hist.BLOCK_CANDIDATES
             for th in cuda_hist.THREAD_CANDIDATES}
    # the old weighting (one root, one gather pass) would keep 32768/1024
    costs[(32768, 1024)] = {"root": 0.1, "rung_0.5": 1.2, "rung_0.125": 1.0}
    costs[(8192, 1024)] = {"root": 0.5, "rung_0.5": 1.02,
                           "rung_0.125": 1.02}
    out = _timed_sweep(monkeypatch, costs)
    w = {name: wt for name, _, wt in cuda_hist.TREE_PASSES}
    assert w == {"root": 1.0, "rung_0.5": 7.5, "rung_0.125": 7.5}
    for geo, ms in out["times_ms"].items():
        blk, th = geo.split("/")
        want = sum(w[n] * c for n, c in costs[(int(blk), int(th))].items())
        assert abs(ms - want) < 1e-6, geo
        assert out["pass_ms"][geo].keys() == w.keys()
    assert (out["block"], out["threads"]) == (8192, 1024)
    # a win on the weighted time with one pass 6% over the default's
    costs[(8192, 1024)] = {"root": 0.2, "rung_0.5": 1.06,
                           "rung_0.125": 0.9}
    out = _timed_sweep(monkeypatch, costs)
    assert out["times_ms"]["8192/1024"] < out["times_ms"]["0/1024"]
    assert (out["block"], out["threads"]) == (0, 1024)


def test_tree_passes_are_what_train_launches(monkeypatch):
    """TREE_PASSES is the count of passes a tree launches at each rung in
    chip_smoke.py's train configuration (255 leaves, max_bin 255, its
    Higgs-shaped rows) cut to 65,536 rows: one root pass (the full form)
    and the gather passes at the ladder's 0.5 and 0.125 rungs, counted
    over two trees."""
    import chip_smoke
    n, rounds = 65536, 2
    X, y = chip_smoke.higgs_like(n, 0)
    rungs = {-(-int(round(n * share)) // 64) * 64: name
             for name, share, _ in cuda_hist.TREE_PASSES if share}
    seen = {name: 0 for name, _, _ in cuda_hist.TREE_PASSES}
    real = cuda_hist.hist_tile

    def counted(binsT, leaf_ids, stats, chan, num_slots, num_bins,
                num_leaves, idx=None, *a, **k):
        seen["root" if idx is None else rungs[idx.shape[0]]] += 1
        return real(binsT, leaf_ids, stats, chan, num_slots, num_bins,
                    num_leaves, idx, *a, **k)
    monkeypatch.setattr(cuda_hist, "hist_tile", counted)
    params = dict(chip_smoke.PARAMS, device_type="cpu")
    b = lt.train(params, lt.Dataset(X, label=y, params=params), rounds)
    assert [t.num_leaves for t in b._boosting.host_trees] == [255] * rounds
    assert {name: c / rounds for name, c in seen.items()} == \
        {name: w for name, _, w in cuda_hist.TREE_PASSES}


def test_the_sweep_launches_the_full_pass_grid(monkeypatch):
    """On a sample of k of N rows the sweep's rows a block are the
    candidate's x k / N (at least 32): the full pass's count of blocks,
    each flushing its planes; one wave (0) stays one wave."""
    seen = []
    monkeypatch.setattr(cuda_hist, "hist_tile",
                        lambda *a, geometry=None, **k: seen.append(geometry))
    binsT = torch.zeros((3, 80_000), dtype=torch.uint8)
    run = cuda_hist.autotune_pass(binsT, 255, False, 10_000)
    for geo, rows in ((cuda_hist.HistGeometry(32768, 512), 4096),
                      (cuda_hist.HistGeometry(128), 32),
                      (cuda_hist.HistGeometry(0, 512), 0)):
        seen.clear()
        run(geo)
        assert seen == [geo._replace(block_rows=rows)] * len(
            cuda_hist.TREE_PASSES)


def test_hist_block_wins_over_the_sweep(monkeypatch):
    X, y = _data()
    ref = lt.train(dict(P, device_type="cpu"),
                   lt.Dataset(X, label=y, params={"device_type": "cpu"}), 2)

    def no_sweep(*a, **k):
        raise AssertionError("an explicit hist_block must not sweep")
    monkeypatch.setattr(cuda_hist, "autotune_hist", no_sweep)
    b = lt.train(dict(P, hist_block=4096, device_type="cpu"),
                 lt.Dataset(X, label=y, params={"device_type": "cpu"}), 2)
    tile, geo = b._boosting._hist_tuning(True)
    assert geo == cuda_hist.HistGeometry(4096) and tile == 0
    assert b.model_to_string().split("\nparameters:")[0] == \
        ref.model_to_string().split("\nparameters:")[0]


def test_the_feature_blocked_pass_keeps_the_defaults(monkeypatch):
    """The memory-bounded pass never sweeps: the sweep's sample would copy
    every column, the memory the blocked pass exists to save, at a width
    its passes never launch."""
    rng = np.random.RandomState(5)
    X = rng.normal(size=(1000, 100)).astype(np.float32)
    y = X[:, 0] + 0.5 * X[:, 40] + 0.1 * rng.normal(size=1000)
    p = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
         "histogram_pool_size": 6.0, "device_type": "cpu"}

    def no_sweep(*a, **k):
        raise AssertionError("the feature-blocked pass must not sweep")
    monkeypatch.setattr(cuda_hist, "autotune_hist", no_sweep)
    b = lt.train(dict(p), lt.Dataset(X, label=y, params=p), 2)
    g = b._boosting
    fb = g._feature_block()
    assert fb == 18
    assert g._hist_tuning(False, fb) == (0, None) and g._hist_tuned is None


def test_hist_autotune_false_trains_the_same_text():
    X, y = _data()
    texts = [lt.train(dict(P, hist_autotune=flag, device_type="cpu"),
                      lt.Dataset(X, label=y, params={"device_type": "cpu"}),
                      3).model_to_string() for flag in (True, False)]
    jtext = lj.train(dict(P, hist_autotune=False),
                     lj.Dataset(X, label=y), 3).model_to_string()
    assert texts[1] == jtext
    assert texts[0].split("\nparameters:")[0] == \
        texts[1].split("\nparameters:")[0]


def test_a_ridden_dict_of_the_other_form_is_measured_again(monkeypatch):
    X, y = _data()
    b = lt.train(dict(P, device_type="cpu"),
                 lt.Dataset(X, label=y, params={"device_type": "cpu"}), 1)
    g = b._boosting
    state = g.get_trainer_state()
    assert state["hist_tuned"]["epilogue"] is True   # the fused path's
    calls = []

    def sweep(binsT, num_bins, q8=False, epilogue=False, **kw):
        calls.append(epilogue)
        return {"block": 8192, "threads": 512,
                "tile_leaves": 42, "epilogue": epilogue, "times_ms": {}}
    monkeypatch.setattr(cuda_hist, "autotune_hist", sweep)
    ridden = dict(state["hist_tuned"], epilogue=False, block=4096,
                  threads=1024, form="smem")
    g.set_trainer_state(dict(state, hist_tuned=ridden))
    assert g._hist_tuning(False)[1] == cuda_hist.HistGeometry(4096, 1024)
    assert calls == []                       # the same form rides as is
    assert g._hist_tuning(True)[1] == cuda_hist.HistGeometry(8192, 512)
    assert calls == [True] and g._hist_tuned["epilogue"] is True


def test_traffic_model_counts_by_hand():
    n, f, b, p = 1000, 3, 10, 4
    t = cuda_hist.traffic_model(n, f, b, p, gathered_rows=400, tile_rows=300)
    planes = p * f * b * 3 * 4
    assert t["full"] == 4 * n + 300 * (f * 1 + 12) + planes
    assert t["gather"] == 4 * 400 + 4 * 300 + 300 * (f + 12) + planes
    assert t["epilogue"] == (2 + 2 + 4) * f * b * 12 + p * f * 48 + p * 32 \
        + f * 32 + 32
    q = cuda_hist.traffic_model(n, f, b, p, mode="q8", bin_bytes=2)
    assert q["full"] == 4 * n + n * (2 * f + 3) + planes
    assert q["epilogue"] == t["epilogue"] + 12
    wide = cuda_hist.traffic_model(n, f, 65535, p, bin_bytes=4)
    # the cluster form reads each row's leaf and stats once a feature and
    # every row's bins once
    assert wide["cluster"] == 8
    assert wide["full_kernels"] == (f * n * 16 + n * f * 4
                                    + 2 * f * 65535 * 3 * 8
                                    + p * f * 65535 * 3 * 4)
    assert cuda_hist.traffic_model(n, f, 255, p)["cluster"] == 1
    assert cuda_hist.traffic_model(n, f, b, p, mode="f64")["full"] == \
        4 * n + n * (f + 12) + planes * 2


def test_traffic_model_gives_the_kernel_tables_bounds():
    """The bounds of PERF.md's kernel table at N = 2,000,000, F = 28,
    B = 255, 42 slots (the rung's tile rows are the phase's draw)."""
    def ms(nbytes):                   # at the H100's 3.35 TB/s
        return nbytes / 3.35e12 * 1e3
    tm = cuda_hist.traffic_model
    assert round(ms(tm(2_000_000, 28, 255, 42)["full"]), 6) == 0.027343
    assert round(ms(tm(2_000_000, 28, 255, 42, mode="q8")["full"]),
                 6) == 0.02197
    assert round(ms(tm(2_000_000, 28, 255, 42)["epilogue"]), 7) == 0.0021659
    g = ms(tm(2_000_000, 28, 255, 42, gathered_rows=1_000_000,
              tile_rows=899_800)["gather"])
    assert abs(g - 0.014087) < 2e-6
