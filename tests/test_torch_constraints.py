"""The split constraints and the randomised search of the PyTorch port --
monotone constraints (basic, intermediate, advanced, with the depth
penalty), interaction constraints, feature_contri, extra_trees and
feature_fraction_bynode -- against the JAX package on the CPU, on the same
seeded numpy inputs. Every bar is bitwise:

- the split epilogue's monotone mode: ``split_epilogue_plain(...,
  with_monotone=True)`` against the JAX package's Pallas epilogue run
  through the interpreter (``histogram_tiles_pallas_epilogue(...,
  with_monotone=True)``), f32 and q8, open, tight and equal bounds,
  derived slots, the three missing types, and a feature whose every
  candidate breaks its direction (``tests/torch_monotone_cases.py``);
- ``find_best_splits`` with ``leaf_min``/``leaf_max``, ``adv_bounds``,
  ``rand_bin``, feature_contri and the monotone penalty, on the same
  planes as the JAX ``find_best_splits`` (jitted, as the grower runs it);
- ``advanced_child_bounds`` against the JAX function, and
  ``intermediate_bounds`` against the JAX grower's split search, on random
  boxes and outputs (leaves with no constraining partner included);
- the by-node mask, the interaction mask and extra_trees' random
  thresholds against the JAX draws for the same key and growth round;
- end to end at 3,000 rows: the model text of ``lightgbm_tpu_torch.train``
  equal to ``lightgbm_tpu.train``'s in every mode, fused and classic, f32
  and q8, a multiclass run included; the ``split_fusion`` resolution equal
  to the JAX package's over the matrix of the settings; a monotone model
  with no violation on a sweep, its ``monotone_constraints=`` line, and
  the same predictions after loading its text back.
"""

import functools
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import grower as jgrower
from lightgbm_tpu.ops import pallas_hist as jph
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.io.model_text import load_model
from lightgbm_tpu_torch.models import grower as tgrower
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.utils import random as tr
from torch_monotone_cases import KINDS, epilogue_args, monotone_case

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

F32_MAX = float(np.finfo(np.float32).max)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64),
                                      b.astype(np.int64), err_msg=what)


# ------------------------------------------------ the epilogue's monotone mode
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("kind", KINDS)
def test_monotone_epilogue_matches_interpreted_pallas(kind, q8):
    """The plain monotone epilogue is bitwise the interpreted Pallas
    epilogue with ``with_monotone=True`` (full planes and candidate
    table); the bounds change winners (tight, equal) and a violating
    feature has no candidate (violate)."""
    c = monotone_case(kind, q8)
    b = c["tile"].shape[2]
    jt, jc = jph.histogram_tiles_pallas_epilogue(
        jnp.asarray(c["binsT"]), jnp.asarray(c["stats"]),
        jnp.asarray(c["leaf"]), jnp.asarray(c["sel"]),
        jnp.asarray(c["derive"]), jnp.asarray(c["parent"].numpy()),
        jnp.asarray(c["la"].numpy()), jnp.asarray(c["fm"].numpy()),
        jnp.asarray(c["pv"].numpy()[:7]), b, block=256,
        mode="q8" if q8 else "highest", interpret=True, with_monotone=True,
        q_scale=None if not q8 else jnp.asarray(c["q_scale"].numpy()))
    args = epilogue_args(c)
    tt, tc = cuda_hist.split_epilogue_plain(*args, with_monotone=True)
    _bits(tt.numpy(), jt, "planes")
    _bits(tc.numpy(), jc, "candidates")
    _, free = cuda_hist.split_epilogue_plain(*args)
    changed = (free[..., 1:3] != tc[..., 1:3]).any(-1)
    if kind in ("tight", "equal"):
        assert bool(changed.any())
    if kind == "violate":
        assert torch.isfinite(free[:, 0, 0]).all()
        assert not torch.isfinite(tc[:, 0, 0]).any()
    # the wrapper on a CPU tensor is the plain version and counts nothing
    cuda_hist.reset_launch_counts()
    wt, wc = cuda_hist.split_epilogue(*args, with_monotone=True)
    assert torch.equal(wc, tc) and torch.equal(wt, tt)
    assert not any(cuda_hist.launch_counts().values())


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_monotone_derive_and_scan_matches_jax(q8):
    """The plain epilogue at plane level against the JAX package's XLA
    twin ``derive_and_scan(with_monotone=True)``, on the tight case."""
    from lightgbm_tpu.ops.histogram import derive_and_scan as j_das
    c = monotone_case("equal", q8, seed=5)
    tile, parent, _, la, fm, pv, qs = epilogue_args(c)
    jfull, jcand = jax.jit(functools.partial(
        j_das, q8=q8, with_monotone=True))(
        jnp.asarray(tile.numpy()), jnp.asarray(c["derive"]),
        jnp.asarray(parent.numpy()), jnp.asarray(la.numpy()),
        jnp.asarray(fm.numpy()), jnp.asarray(pv.numpy()),
        q_scale=None if qs is None else jnp.asarray(qs.numpy()))
    tfull, tcand = cuda_hist.split_epilogue_plain(
        *epilogue_args(c), with_monotone=True)
    _bits(tfull.numpy(), jfull, "planes")
    _bits(tcand.numpy(), jcand, "candidates")


def test_ieee_max_min_and_clip_match_jnp():
    """``clip`` is ``jnp.clip``'s arithmetic (maximum then minimum, NaN
    propagated, +0 over -0 in max and -0 over +0 in min), where
    ``torch.clamp`` and ``torch.maximum`` keep their first argument of two
    equal zeros."""
    vals = np.array([np.nan, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf,
                     F32_MAX, -F32_MAX, 3.5], np.float32)
    a, b, c = (x.ravel() for x in np.meshgrid(vals, vals, vals,
                                              indexing="ij"))
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    # NaN payloads aside (XLA's canonical NaN), every bit
    for got, want in ((tsplit.ieee_max(ta, tb), jnp.maximum(a, b)),
                      (tsplit.ieee_min(ta, tb), jnp.minimum(a, b)),
                      (tsplit.clip(ta, tb, tc), jax.jit(jnp.clip)(a, b, c))):
        got, want = got.numpy(), np.asarray(want)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        _bits(got[ok], want[ok])
    np.testing.assert_array_equal(
        np.signbit(tsplit.ieee_max(torch.tensor([0.0]),
                                   torch.tensor([-0.0])).numpy()), [False])


# ------------------------------------------------------- the classic search
L, F, B = 8, 6, 31


def _planes(seed=0):
    rng = np.random.RandomState(seed)
    n = 4000
    binsT = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    binsT[3] = np.minimum(binsT[3], 5)                # a categorical column
    stats = (rng.randint(-1023, 1024, size=(n, 3)) / 1024.0
             ).astype(np.float32)
    stats[:, 1] = rng.randint(1, 1024, n) / 1024.0
    stats[:, 2] = 1.0
    # the categorical column carries most of the gradient
    stats[binsT[3] == 2, 0] = 1023 / 1024.0
    stats[binsT[3] == 4, 0] = -1023 / 1024.0
    leaf = rng.randint(0, L, n).astype(np.int32)
    sel = np.arange(L, dtype=np.int32)
    hist = cuda_hist.hist_tile_plain(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats),
        cuda_hist.chan_leaf_table(torch.from_numpy(sel)), L, B, L).numpy()
    sums = hist[:, 0].sum(1)
    out = (-sums[:, 0] / (sums[:, 1] + 1.0)).astype(np.float32)
    depth = rng.randint(0, 6, L).astype(np.int32)
    return hist, sums, out, depth, rng


def _metas(monotone, penalty, categorical=False):
    nb = np.full(F, B, np.int32)
    nb[3] = 6
    mt = np.array([0, 1, 2, 0, 2, 1], np.int32)
    db = np.array([0, 4, 0, 0, 0, 9], np.int32)
    cat = np.zeros(F, bool)
    if categorical:
        cat[3], mt[3] = True, 0
    mono = np.asarray(monotone, np.int8)
    pen = np.asarray(penalty, np.float32)
    jm = jsplit.FeatureMeta(*(jnp.asarray(x)
                              for x in (nb, mt, db, cat, mono, pen)))
    tm = tsplit.FeatureMeta(*(torch.from_numpy(x)
                              for x in (nb, mt, db, cat, mono, pen)))
    return jm, tm


def _params(**kw):
    base = dict({"min_data_in_leaf": 5, "lambda_l2": 1.0, "verbosity": -1},
                **kw)
    return (jsplit.SplitParams.from_config(lj.Config.from_params(dict(base))),
            tsplit.SplitParams.from_config(lt.Config.from_params(
                dict(base, device_type="cpu"))))


def _boxes(rng, l, f, nb):
    a = rng.randint(0, nb, (l, f))
    b = rng.randint(0, nb, (l, f))
    return np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)


MONO = [1, -1, 0, 0, 1, -1]


def _search_case(case, rng, out):
    """(monotone, penalty, categorical, params, keyword arguments)."""
    lmin = (out - 0.02).astype(np.float32)
    lmax = (out + 0.02).astype(np.float32)
    lmin[2] = lmax[2] = out[2]
    if case == "bounds":
        return MONO, np.ones(F), False, {}, dict(leaf_min=lmin,
                                                 leaf_max=lmax)
    if case == "bounds_cat":
        return MONO, np.ones(F), True, {"min_data_per_group": 10,
                                        "cat_smooth": 1.0}, dict(
            leaf_min=lmin, leaf_max=lmax)
    if case == "adv":
        lo, hi = _boxes(rng, L, F, B)
        act = np.ones(L, bool)
        act[5] = False
        adv = jgrower.advanced_child_bounds(
            jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(out),
            jnp.asarray(act), jnp.asarray(np.asarray(MONO, np.int8)), B,
            (0, 1, 4, 5))
        return MONO, np.ones(F), False, {}, dict(
            leaf_min=lmin, leaf_max=lmax,
            adv_bounds=tuple(np.array(a) for a in adv))
    if case == "rand_bin":
        nbm = np.maximum(np.array([B, B, B, 6, B, B]) - 2, 1)
        rb = (rng.rand(L, F) * nbm).astype(np.int32)
        return [0] * F, np.ones(F), False, {}, dict(rand_bin=rb)
    if case == "contri_penalty":
        return MONO, [1.0, 0.5, 0.0, 1.0, -1.0, 2.0], False, \
            {"monotone_penalty": 2.0}, dict(leaf_min=lmin, leaf_max=lmax)
    assert case == "penalty_small"
    return MONO, [1.0, 1.5, 1.0, 1.0, 0.7, 1.0], False, \
        {"monotone_penalty": 0.5}, {}


@pytest.mark.parametrize("case", ["bounds", "bounds_cat", "adv", "rand_bin",
                                  "contri_penalty", "penalty_small"])
def test_find_best_splits_constraints_match_jax(case):
    hist, sums, out, depth, rng = _planes(seed=3)
    mono, pen, cat, pkw, kw = _search_case(case, rng, out)
    jm, tm = _metas(mono, pen, cat)
    jp, tp = _params(**pkw)
    fmask = np.ones((L, F), bool)
    fmask[1, 4] = False
    jkw = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
               else jnp.asarray(v)) for k, v in kw.items()}
    tkw = {k: (tuple(torch.from_numpy(a) for a in v) if isinstance(v, tuple)
               else torch.from_numpy(v)) for k, v in kw.items()}
    jfn = jax.jit(lambda *a, **k: jsplit.find_best_splits(
        *a, max_depth=-1, with_categorical=cat, cat_words=1, **k))
    ref = jfn(jnp.asarray(hist), *(jnp.asarray(sums[:, i]) for i in range(3)),
              jnp.asarray(out), jnp.asarray(depth), jm, jp,
              jnp.asarray(fmask), **jkw)
    got = tsplit.find_best_splits(
        torch.from_numpy(hist), *(torch.from_numpy(
            np.ascontiguousarray(sums[:, i])) for i in range(3)),
        torch.from_numpy(out), torch.from_numpy(depth), tm, tp,
        torch.from_numpy(fmask), with_categorical=cat, cat_words=1, **tkw)
    for name in tsplit.SplitInfo._fields:
        _bits(getattr(got, name).numpy(), getattr(ref, name), name)
    assert np.isfinite(np.asarray(ref.gain)).any()
    if cat:
        assert np.asarray(ref.is_cat).any()


def test_monotone_split_penalty_matches_jax():
    depth = np.arange(0, 40, dtype=np.int32)
    for pen in (0.0, 0.5, 1.0, 2.0, 2.5, 10.0, 39.0):
        jp, tp = _params(monotone_penalty=pen)
        ref = jax.jit(jsplit.monotone_split_penalty)(jnp.asarray(depth), jp)
        _bits(tsplit.monotone_split_penalty(torch.from_numpy(depth),
                                            tp).numpy(), ref, str(pen))


# ------------------------------------------------- the monotone leaf bounds
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_advanced_child_bounds_match_jax(seed):
    rng = np.random.RandomState(seed)
    nl, f, b = 14, 5, 12
    lo, hi = _boxes(rng, nl, f, b)
    out = rng.randint(-3, 4, nl).astype(np.float32) * np.float32(0.25)
    out[out == 0] = np.float32(-0.0)
    out[1] = np.float32(0.0)                 # +0 beside the -0s
    act = rng.rand(nl) < 0.85
    mono = np.array([1, -1, 0, 1, 0], np.int8)
    feats = (0, 1, 3)
    ref = jgrower.advanced_child_bounds(
        *(jnp.asarray(x) for x in (lo, hi, out, act, mono)), b, feats)
    got = tgrower.advanced_child_bounds(
        *(torch.from_numpy(x) for x in (lo, hi, out, act, mono)), b, feats)
    for name, g, r in zip(("lmin", "lmax", "rmin", "rmax"), got, ref):
        _bits(g.numpy(), r, name)
    assert (np.asarray(ref[0]) > -F32_MAX).any()
    assert (np.asarray(ref[3]) < F32_MAX).any()


def _jax_intermediate(lo, hi, out, num_leaves, mono, feats, b):
    """The JAX grower's intermediate_bounds, through its split search
    (which recomputes the bounds first) on a state holding these boxes."""
    f = lo.shape[1]
    n = 64
    meta = jsplit.FeatureMeta(
        jnp.full((f,), b, jnp.int32), jnp.zeros((f,), jnp.int32),
        jnp.zeros((f,), jnp.int32), jnp.zeros((f,), bool),
        jnp.asarray(mono), jnp.ones((f,), jnp.float32))
    fns = jgrower._grower_fns(
        jnp.zeros((n, f), jnp.uint8), jnp.zeros((n,)), jnp.ones((n,)),
        jnp.ones((n,)), meta, _params()[0], jnp.ones((f,)),
        jnp.full((f,), -1, jnp.int32), max_leaves=lo.shape[0], num_bins=b,
        hist_method="scatter", with_monotone=True, mono_mode="intermediate",
        mono_features=feats)
    st = fns["init_state"]()._replace(
        leaf_lo=jnp.asarray(lo), leaf_hi=jnp.asarray(hi),
        leaf_output=jnp.asarray(out), num_leaves=jnp.int32(num_leaves))
    st = fns["split_search"](st)
    return np.asarray(st.leaf_min), np.asarray(st.leaf_max)


@pytest.mark.parametrize("seed", [0, 1])
def test_intermediate_bounds_match_jax(seed):
    rng = np.random.RandomState(seed + 10)
    nl, f, b, k = 16, 5, 10, 13
    lo, hi = _boxes(rng, nl, f, b)
    out = rng.randn(nl).astype(np.float32)
    out[3] = np.float32(-0.0)
    mono = np.array([1, 0, -1, 0, 1], np.int8)
    feats = (0, 2, 4)
    jlb, jub = _jax_intermediate(lo, hi, out, k, mono, feats, b)
    act = np.arange(nl) < k
    lb, ub = tgrower.intermediate_bounds(
        *(torch.from_numpy(x) for x in (lo, hi, out, act, mono)), feats)
    _bits(lb.numpy(), jlb, "lb")
    _bits(ub.numpy(), jub, "ub")
    # some leaf bounded, and some with no constraining partner
    assert (jlb > -F32_MAX).any() or (jub < F32_MAX).any()
    assert ((jlb == -F32_MAX) & (jub == F32_MAX)).any()


# ------------------------------------------------ masks and random thresholds
def _grower(params, n=500, f=7, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    ds = lt.Dataset(X, params=dict(params, device_type="cpu",
                                   verbosity=-1)).construct()
    cfg = lt.Config.from_params(dict(params, device_type="cpu"))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    return ds, tgrower.Grower(
        ds.binsT, g, torch.ones_like(g), ds.feature_meta,
        tsplit.SplitParams.from_config(cfg), ds.missing_bin, max_leaves=12,
        num_bins=ds.max_num_bins, split_fusion=False,
        rng_key=tr.fold_in(tr.prng_key(6), 3),
        interaction_groups=np.array([[1, 1, 0, 0, 1, 0, 0],
                                     [0, 1, 1, 1, 0, 0, 0],
                                     [0, 0, 0, 0, 0, 1, 1]], bool),
        extra_trees=True, bynode_fraction=0.45)


@pytest.mark.parametrize("rounds", [0, 5, 17])
def test_leaf_masks_and_rand_bins_match_jax_draws(rounds):
    """The by-node mask (the ceil(frac * F) lowest stable ranks of
    ``uniform(fold_in(fold_in(key, rounds), 1), (L, F))``), the
    interaction mask (JAX: two float32 matmuls over the groups) and
    extra_trees' thresholds (``uniform(..., 2) * max(num_bins - 2, 1)``
    truncated), each for the same key and growth round as the JAX
    package's draws."""
    ds, g = _grower({"max_bin": 15})
    st = g.init_state()
    st.rounds = rounds
    rng = np.random.RandomState(rounds)
    st.used_path = rng.rand(g.L, g.f) < 0.2
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(6), 3),
                             rounds)
    # the JAX grower's leaf_feature_mask
    grp = jnp.asarray(g.igroups, jnp.float32)
    viol = jnp.asarray(st.used_path, jnp.float32) @ (1.0 - grp).T
    allowed = ((viol < 0.5).astype(jnp.float32) @ grp) > 0.5
    u = jax.random.uniform(jax.random.fold_in(key, 1), (g.L, g.f))
    k = jnp.maximum(jnp.ceil(jnp.float32(0.45) * g.f).astype(jnp.int32), 1)
    rank = jnp.argsort(jnp.argsort(u, axis=1), axis=1)
    want = np.asarray(allowed & (rank < k))
    np.testing.assert_array_equal(g.leaf_feature_mask(st), want)
    assert int(k) == g.bynode_k == 4
    nbm = jnp.maximum(jnp.asarray(ds.feature_meta.num_bins.numpy()) - 2, 1)
    ur = jax.random.uniform(jax.random.fold_in(key, 2), (g.L, g.f))
    _bits(g.rand_bins(st).numpy(), (ur * nbm[None, :]).astype(jnp.int32))


# ------------------------------------------------------------- end to end
ROUNDS = 8
MC = [1, -1, 0, -1, 1, 0]


def _data(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, size=(n, 6)).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.3, 5] = 0.0
    y = (2 * X[:, 0] - 1.5 * X[:, 1] + 0.5 * np.sin(3 * np.nan_to_num(
        X[:, 2])) - X[:, 3] * np.abs(X[:, 4]) + 0.7 * X[:, 4]
        + 0.3 * rng.normal(size=n))
    return X, y


RUNS = {
    "basic": {"monotone_constraints": MC},
    "basic_classic": {"monotone_constraints": MC, "split_fusion": "off"},
    "basic_q8": {"monotone_constraints": MC, "quantized_grad": True},
    "basic_q8_classic": {"monotone_constraints": MC, "quantized_grad": True,
                         "split_fusion": "off"},
    "intermediate": {"monotone_constraints": MC,
                     "monotone_constraints_method": "intermediate"},
    "advanced": {"monotone_constraints": MC,
                 "monotone_constraints_method": "advanced"},
    "advanced_q8": {"monotone_constraints": MC,
                    "monotone_constraints_method": "advanced",
                    "quantized_grad": True},
    "penalty": {"monotone_constraints": MC, "monotone_penalty": 2.0},
    # an unknown method warns and falls back to basic (fused)
    "unknown_method": {"monotone_constraints": MC,
                       "monotone_constraints_method": "sideways"},
    "interactions": {"interaction_constraints": [[0, 1], [2, 3, 0], [4, 5]]},
    "contri": {"feature_contri": [1.0, 0.6, 1.5, 1.0, 0.8, 1.2]},
    "contri_zero": {"feature_contri": [1.0, 0.0, 1.5, 1.0, 0.8, 1.2]},
    "extra_trees": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.5},
}
# the split path each run must take (the JAX package's resolution)
CLASSIC = {"basic_classic", "basic_q8_classic", "intermediate", "advanced",
           "advanced_q8", "contri_zero", "extra_trees", "bynode"}


def _both(params, X, y, rounds=ROUNDS):
    p = dict({"objective": "regression", "num_leaves": 31, "max_bin": 63,
              "min_data_in_leaf": 5, "verbosity": -1}, **params)
    bj = lj.train(dict(p), lj.Dataset(X, label=y), rounds)
    bt = lt.train(dict(p, device_type="cpu"), lt.Dataset(X, label=y), rounds)
    return bj, bt


@pytest.mark.parametrize("name", sorted(RUNS))
def test_model_text_bitwise(name):
    X, y = _data()
    bj, bt = _both(RUNS[name], X, y)
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert bt._boosting._split_fusion_on() == (name not in CLASSIC)
    assert ("monotone_constraints=1 -1 0 -1 1 0" in text) == (
        "monotone_constraints" in RUNS[name])


def test_basic_monotone_fused_equals_classic():
    """Basic monotone constraints: the fused path's epilogue and the
    classic search grow the same trees (f32 and q8), in both packages."""
    X, y = _data(seed=4)
    for q8 in (False, True):
        texts = []
        for fusion in ("auto", "off"):
            params = {"monotone_constraints": MC, "quantized_grad": q8,
                      "split_fusion": fusion}
            bj, bt = _both(params, X, y, rounds=5)
            texts.append((bj.model_to_string(), bt.model_to_string()))
        strip = [tuple(t.split("\nparameters:")[0] for t in pair)
                 for pair in texts]
        assert strip[0][0] == strip[0][1] == strip[1][0] == strip[1][1]


def test_multiclass_monotone_bitwise():
    X, y = _data(seed=2)
    cls = np.digitize(y, np.quantile(y, [0.33, 0.66])).astype(float)
    bj, bt = _both({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 15, "monotone_constraints": MC,
                    "monotone_constraints_method": "intermediate"},
                   X, cls, rounds=4)
    assert bt.model_to_string() == bj.model_to_string()


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


def test_split_fusion_resolution_matches_jax():
    X, y = _data(n=600)
    jds = lj.Dataset(X, label=y, params={"verbosity": -1}).construct()
    tds = lt.Dataset(X, label=y, params={"verbosity": -1,
                                         "device_type": "cpu"}).construct()
    monos = [{}, {"monotone_constraints": MC},
             {"monotone_constraints": MC,
              "monotone_constraints_method": "intermediate"},
             {"monotone_constraints": MC,
              "monotone_constraints_method": "advanced"}]
    others = [{}, {"interaction_constraints": [[0, 1], [2, 3, 4, 5]]},
              {"feature_contri": [1.0, 0.5, 1.0, 1.0, 1.0, 2.0]},
              {"feature_contri": [1.0, 0.0, 1.0, 1.0, 1.0, 2.0]},
              {"extra_trees": True}, {"feature_fraction_bynode": 0.5}]
    seen = set()
    for mono, other, mode in itertools.product(monos, others,
                                               ("auto", "on", "off")):
        params = dict(mono, **other, split_fusion=mode)
        want = _resolution(lj, params, jds)
        assert _resolution(lt, params, tds, "cpu") == want, params
        seen.add(want if isinstance(want, bool) else "raises")
    assert seen == {True, False, "raises"}


def test_monotone_sweep_text_and_reload():
    """A basic monotone model is monotone along each constrained feature
    (1,000 rows x 60 points a feature, as the JAX package's own test
    sweeps), writes the monotone_constraints line, and predicts the same
    after loading its text back."""
    X, y = _data(seed=7)
    _, bt = _both({"monotone_constraints": MC, "num_leaves": 63}, X, y,
                  rounds=10)
    rng = np.random.RandomState(8)
    base = X[rng.choice(len(X), 1000, replace=False)]
    grid = np.linspace(-2, 2, 60, dtype=np.float32)
    for j, d in enumerate(MC):
        if d == 0:
            continue
        Xs = np.repeat(base, len(grid), axis=0)
        Xs[:, j] = np.tile(grid, len(base))
        pred = bt.predict(Xs).reshape(len(base), len(grid))
        steps = np.diff(pred, axis=1) * d
        assert (steps >= 0).all(), (j, steps.min())
    text = bt.model_to_string()
    assert "\nmonotone_constraints=1 -1 0 -1 1 0\n" in text
    back = load_model(text)
    assert back.meta["monotone_constraints"] == MC
    np.testing.assert_array_equal(back.predict(X), bt.predict(X))
    again = lt.Booster(model_str=text, params={"device_type": "cpu"})
    assert again.model_to_string() == text
