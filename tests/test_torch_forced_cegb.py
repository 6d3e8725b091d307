"""Forced bins, ``max_bin_by_feature``, forced splits and CEGB
(cost-effective gradient boosting) in the PyTorch port, against the JAX
package on the CPU: the model text of ``lightgbm_tpu_torch.train`` bitwise
``lightgbm_tpu.train``'s on the same seeded data and the same JSON files
(written to ``tmp_path``), f32 and q8, forced splits under intermediate
monotone constraints included; each run's ``split_fusion`` resolution
equal to the JAX package's over the matrix of the settings; the forced
splits at the top of every tree; the forced bounds in the mappers; and
the JAX package's size check of the CEGB penalty lists.
"""

import itertools
import json

import numpy as np
import pytest

import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

FORCED = {"feature": 0, "threshold": 0.1,
          "left": {"feature": 1, "threshold": -0.5},
          "right": {"feature": 3, "threshold": 0.3,
                    "left": {"feature": 4, "threshold": 0.0}}}
FORCED_BINS = [{"feature": 0, "bin_upper_bound": [-1.0, 0.0, 0.5, 1.5]},
               {"feature": 3, "bin_upper_bound": [0.2, 0.4, 0.4]}]


def _data(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 5] = 0.0
    y = (X[:, 0] + 0.3 * X[:, 1] ** 2 - 0.5 * X[:, 3]
         + 0.2 * np.nan_to_num(X[:, 2]) + 0.1 * rng.randn(n))
    return X, y


@pytest.fixture
def files(tmp_path):
    fs, fb = tmp_path / "forced.json", tmp_path / "bins.json"
    fs.write_text(json.dumps(FORCED))
    fb.write_text(json.dumps(FORCED_BINS))
    return {"forcedsplits_filename": str(fs),
            "forcedbins_filename": str(fb)}


RUNS = {
    "cegb_split": {"cegb_penalty_split": 0.5},
    "cegb_coupled": {"cegb_penalty_feature_coupled": [5, 1, 0, 2, 3, 0.5],
                     "cegb_tradeoff": 0.5},
    "cegb_lazy": {"cegb_penalty_feature_lazy": [0.01, 0.02, 0, 0.01, 0.05,
                                                0.0]},
    "cegb_lazy_q8": {"cegb_penalty_feature_lazy": [0.01, 0.02, 0, 0.01,
                                                   0.05, 0.0],
                     "cegb_tradeoff": 0.7, "quantized_grad": True},
    "forced": {"forcedsplits_filename": None},
    "forced_q8": {"forcedsplits_filename": None, "quantized_grad": True},
    "forced_intermediate": {"forcedsplits_filename": None,
                            "monotone_constraints": [1, 0, 0, -1, 0, 0],
                            "monotone_constraints_method": "intermediate"},
    "forced_bins": {"forcedbins_filename": None},
    "max_bin_by_feature": {"max_bin_by_feature": [15, 511, 31, 7, 63, 255]},
}
CLASSIC = {n for n in RUNS if n.startswith(("cegb", "forced_"))
           and n != "forced_bins"} | {"forced"}


def _params(name, files):
    p = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 5, "verbosity": -1}
    for k, v in RUNS[name].items():
        p[k] = files[k] if v is None else v
    return p


@pytest.mark.parametrize("name", sorted(RUNS))
def test_model_text_bitwise(name, files):
    X, y = _data()
    params = _params(name, files)
    bj = lj.train(dict(params), lj.Dataset(X, label=y), 3)
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, label=y), 3)
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert bt._boosting._split_fusion_on() == (name not in CLASSIC)
    if name.startswith("forced") and name != "forced_bins":
        # every tree starts with the forced features, in preorder
        for block in text.split("Tree=")[1:]:
            line = [ln for ln in block.splitlines()
                    if ln.startswith("split_feature=")][0]
            assert line.split("=")[1].split()[:3] == ["0", "1", "3"]


def test_forced_bins_and_max_bin_by_feature_in_the_mappers(files):
    X, y = _data()
    ds = lt.Dataset(X, label=y, params=dict(
        device_type="cpu", verbosity=-1,
        forcedbins_filename=files["forcedbins_filename"],
        max_bin_by_feature=[15, 511, 31, 7, 63, 255])).construct()
    ub0 = list(ds.mappers[0].bin_upper_bound)
    for b in (-1.0, 0.5, 1.5):
        assert b in ub0
    assert 0.2 in list(ds.mappers[3].bin_upper_bound)
    assert [m.num_bin <= c for m, c in
            zip(ds.mappers, [15, 511, 31, 7, 63, 255])] == [True] * 6
    assert ds.mappers[1].num_bin > 256 and ds.binsT.dtype == torch.int16


def test_cegb_uses_fewer_features(files):
    X, y = _data(seed=1)
    base = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
            "device_type": "cpu"}
    free = lt.train(base, lt.Dataset(X, label=y), 5)
    pen = lt.train(dict(base, cegb_penalty_feature_coupled=[0, 0, 0, 1e4,
                                                            0, 0]),
                   lt.Dataset(X, label=y), 5)
    used = [set(np.nonzero(b.feature_importance())[0]) for b in (free, pen)]
    assert 3 in used[0] and 3 not in used[1]
    state = pen._boosting._cegb.state
    assert state["used_split"].sum() == len(used[1])


def test_cegb_penalty_size_is_checked():
    X, y = _data(n=500)
    for mod, dev in ((lj, {}), (lt, {"device_type": "cpu"})):
        with pytest.raises(Exception, match="same size as feature"):
            mod.train(dict({"objective": "regression", "verbosity": -1,
                            "cegb_penalty_feature_lazy": [1.0, 2.0]}, **dev),
                      mod.Dataset(X, label=y), 1)


def _resolution(mod, params, ds, device=None):
    p = dict(params, verbosity=-1)
    if device:
        p["device_type"] = device
    try:
        gb = mod.Booster(params=p, train_set=ds)._boosting
        if mod is lj:
            return gb._split_fusion_on(gb._hist_method())
        return gb._split_fusion_on()
    except ValueError as e:
        return str(e)


def test_split_fusion_resolution_matches_jax(files):
    X, y = _data(n=600)
    jds = lj.Dataset(X, label=y, params={"verbosity": -1}).construct()
    tds = lt.Dataset(X, label=y, params={"verbosity": -1,
                                         "device_type": "cpu"}).construct()
    extra = [{}, {"forcedsplits_filename": files["forcedsplits_filename"]},
             {"cegb_penalty_split": 0.1},
             {"cegb_penalty_feature_lazy": [1.0] * 6},
             {"extra_trees": True}]
    seen = set()
    for a, b, mode in itertools.product(extra, extra[:3],
                                        ("auto", "on", "off")):
        params = dict(a, **b, split_fusion=mode)
        want = _resolution(lj, params, jds)
        assert _resolution(lt, params, tds, "cpu") == want, params
        seen.add(want if isinstance(want, bool) else "raises")
    assert seen == {True, False, "raises"}


def test_cegb_lazy_term_rounds_as_xla():
    """XLA:CPU contracts the lazy term's ``delta + tradeoff * penalty *
    count`` into one fused multiply-add (the JAX grower's cegb_adjust);
    the port's ``fma_f32`` rounds once the same way, where two roundings
    differ in hundreds of cells."""
    import jax
    import jax.numpy as jnp
    from lightgbm_tpu_torch.models.grower import fma_f32
    rng = np.random.RandomState(1)
    d = (rng.rand(64, 28) * 100).astype(np.float32)
    pen = (rng.rand(28) * 0.1).astype(np.float32)
    cnt = rng.randint(0, 50000, (64, 28)).astype(np.float32)
    t = np.float32(0.7)
    xla = np.asarray(jax.jit(lambda d, t, p, c: d + (t * p[None, :] * c))(
        jnp.asarray(d), t, jnp.asarray(pen), jnp.asarray(cnt)))
    tl = torch.from_numpy(t * pen)
    port = fma_f32(tl[None, :], torch.from_numpy(cnt), torch.from_numpy(d))
    np.testing.assert_array_equal(port.numpy(), xla)
    twice = d + (t * pen)[None, :] * cnt
    assert (twice != xla).sum() > 0
