"""Learning to rank: the PyTorch port's query groups, lambdarank, rank_xendcg,
NDCG and MAP against the JAX package on the same seeded numpy inputs, on the
CPU.

- The padding plan: ``group_boundaries`` and ``_PaddedQueries``'
  ``doc_index``, ``mask`` and M (rounded up to a multiple of 8) equal.
- lambdarank's gradients and hessians (``LambdarankNDCG.get_grad_hess``, on
  the CPU ``ops/rank.lambdarank_grads_plain``) bitwise the JAX package's:
  query sizes 1 to 40 with a one-document query, a query whose labels are
  all equal and one whose labels are all 0; tied scores; truncation levels
  5 and 30; ``lambdarank_norm`` on and off; ``sigmoid`` 2; a custom
  ``label_gain``; document weights; and the layouts whose longest query
  puts M in each of XLA:CPU's summation regimes (M = 8, 16 to 32 where the
  sums are vectorised, 40 and more where they run in windows of 32).
- ``lambdarank_grads_exact`` (the CUDA kernel's order, which the card holds
  the kernel to bitwise) within 1e-5 of the largest magnitude of the
  query's JAX-order values: the two add the same float32 terms in other
  orders.
- rank_xendcg bitwise, over three iterations of the same numpy draws.
- NDCG and MAP bitwise (the same float64 numpy operations): ``eval_at``
  lists, weighted queries, queries without positives.
- End to end at ~3,000 documents in 100 queries: lambdarank and
  rank_xendcg model text bitwise the JAX package's in f32 and in q8, with
  weights, ``init_score`` on train and valid and a custom ``label_gain``,
  and the valid set's ``ndcg@k`` / ``map@k`` in ``evals_result`` equal.
- The Dataset's ``group`` / ``init_score`` fields (constructor,
  ``set_group``, ``set_field``, ``create_valid``), and a saved ranking
  model loading back with the same objective and predictions.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import ranking as jrank
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import ranking as trank
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.ops import cuda_hist
from lightgbm_tpu_torch.ops import rank as trank_ops

# one intra-op thread: the suite runs in worker processes that share the cores
torch.set_num_threads(1)

ROUNDS = 5


def _queries(seed, n_queries, longest, labels=5):
    """Query sizes 1..longest (the first query exactly ``longest``), labels
    in [0, labels) and normal scores, from ``seed``."""
    rng = np.random.RandomState(seed)
    groups = rng.randint(1, longest + 1, size=n_queries)
    groups[0] = longest
    n = int(groups.sum())
    label = rng.randint(0, labels, size=n).astype(np.float64)
    score = rng.normal(size=n).astype(np.float32)
    return groups, label, score


def _edge_queries(seed):
    """Sizes 1..40 with a one-document query, a query whose labels are all
    equal, a query whose labels are all 0 and tied scores in another."""
    rng = np.random.RandomState(seed)
    groups = np.concatenate([[40, 1, 9, 12, 7], rng.randint(1, 41, size=25)])
    b = np.concatenate([[0], np.cumsum(groups)])
    n = int(b[-1])
    label = rng.randint(0, 5, size=n).astype(np.float64)
    score = rng.normal(size=n).astype(np.float32)
    label[b[2]:b[3]] = 3.0                        # all labels equal
    label[b[3]:b[4]] = 0.0                        # all labels 0
    score[b[4]:b[5]] = np.round(score[b[4]:b[5]])  # ties
    return groups, label, score


def _objectives(params, label, weight, groups):
    jo = jrank.create_ranking_objective(JConfig.from_params(dict(params)))
    jo.init(label, weight, groups)
    to = trank.create_ranking_objective(
        TConfig.from_params(dict(params, device_type="cpu")))
    to.init(label, weight, groups)
    return jo, to


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_padding_plan_matches_jax():
    for groups in ([3, 1, 7], [8], [1] * 5, [40, 1, 33, 2], [9, 100, 1]):
        g = np.asarray(groups)
        np.testing.assert_array_equal(trank.group_boundaries(g),
                                      jrank.group_boundaries(g))
        jp, tp = jrank._PaddedQueries(g), trank._PaddedQueries(g)
        assert tp.m == jp.m and tp.m % 8 == 0
        np.testing.assert_array_equal(tp.doc_index, jp.doc_index)
        np.testing.assert_array_equal(tp.mask, jp.mask)
        x = np.random.RandomState(0).normal(size=int(g.sum()))
        np.testing.assert_array_equal(tp.gather(x, -1.0), jp.gather(x, -1.0))


LAMBDARANK_CASES = {
    "default": {},
    "trunc5": {"lambdarank_truncation_level": 5},
    "no_norm": {"lambdarank_norm": False},
    "sigmoid2": {"sigmoid": 2.0},
    "label_gain": {"label_gain": [0, 1, 2, 5, 11]},
    "weights": {},
    "trunc5_no_norm_sigmoid2": {"lambdarank_truncation_level": 5,
                                "lambdarank_norm": False, "sigmoid": 2.0},
}


@pytest.mark.parametrize("case", sorted(LAMBDARANK_CASES))
def test_lambdarank_gradients_bitwise(case):
    """Bitwise (tolerance 0) on the edge-case layout, at the default score
    and at all-equal scores (the first iteration's)."""
    groups, label, score = _edge_queries(3)
    weight = (np.random.RandomState(4).uniform(0.5, 2.0, size=len(label))
              if case == "weights" else None)
    params = dict({"objective": "lambdarank"}, **LAMBDARANK_CASES[case])
    jo, to = _objectives(params, label, weight, groups)
    for s in (score, np.zeros_like(score)):
        jg, jh = jo.get_grad_hess(jnp.asarray(s))
        tg, th = to.get_grad_hess(torch.from_numpy(s))
        np.testing.assert_array_equal(_bits(tg), _bits(jg))
        np.testing.assert_array_equal(_bits(th), _bits(jh))


@pytest.mark.parametrize("longest", [6, 13, 20, 30, 45, 130])
@pytest.mark.parametrize("norm", [True, False])
def test_lambdarank_gradients_bitwise_in_every_sum_regime(longest, norm):
    """M = 8, 16, 24, 32 (XLA's vectorised sums), 48 and 136 (its windows
    of 32); bitwise (tolerance 0), also at all-equal scores, where the
    M = 32 loop is unswitched."""
    groups, label, score = _queries(longest, 24, longest)
    jo, to = _objectives({"objective": "lambdarank", "lambdarank_norm": norm},
                         label, None, groups)
    assert to.padding.m == -(-longest // 8) * 8
    for s in (score, np.zeros_like(score)):
        jg, jh = jo.get_grad_hess(jnp.asarray(s))
        tg, th = to.get_grad_hess(torch.from_numpy(s))
        np.testing.assert_array_equal(_bits(tg), _bits(jg))
        np.testing.assert_array_equal(_bits(th), _bits(jh))


@pytest.mark.parametrize("params", [
    {"objective": "lambdarank"},
    {"objective": "lambdarank", "lambdarank_truncation_level": 3},
    {"objective": "lambdarank", "lambdarank_truncation_level": 1000},
    {"objective": "lambdarank", "lambdarank_norm": False, "sigmoid": 2.0}],
    ids=["default", "trunc3", "trunc_above_n", "no_norm_sigmoid2"])
def test_exact_order_near_plain(params):
    """The kernel's order (``kernel_sums_on_cpu``) against the JAX order:
    within 1e-5 of the largest magnitude of the JAX-order values (float32
    sums of the same terms in other orders; a query's largest lambda is
    the scale of its rounding), and the wrapper never counts a launch on
    the CPU."""
    groups, label, score = _edge_queries(5)
    _, to = _objectives(params, label, None, groups)
    s = torch.from_numpy(score)
    trank_ops.lambdarank_grads.launches = 0
    pg, ph = to.get_grad_hess(s)
    with cuda_hist.kernel_sums_on_cpu():
        eg, eh = to.get_grad_hess(s)
    assert trank_ops.lambdarank_grads.launches == 0
    for e, p in ((eg, pg), (eh, ph)):
        e, p = e.numpy(), p.numpy()
        assert np.abs(e - p).max() <= 1e-5 * np.abs(p).max()
        assert np.array_equal(e == 0, p == 0)


def test_rank_xendcg_gradients_bitwise():
    """Three iterations: each draws gamma [Q, M] from
    ``RandomState(seed)``, the same numbers on both sides; bitwise
    (tolerance 0), the contracted multiply-add included."""
    groups, label, score = _edge_queries(6)
    jo, to = _objectives({"objective": "rank_xendcg", "seed": 11}, label,
                         None, groups)
    for it in range(3):
        s = score * (it + 1)
        jg, jh = jo.get_grad_hess(jnp.asarray(s))
        tg, th = to.get_grad_hess(torch.from_numpy(s))
        np.testing.assert_array_equal(_bits(tg), _bits(jg))
        np.testing.assert_array_equal(_bits(th), _bits(jh))


@pytest.mark.parametrize("name", ["ndcg", "map"])
@pytest.mark.parametrize("eval_at", [[1, 2, 3, 4, 5], [1, 3, 10], [50]])
@pytest.mark.parametrize("weighted", [False, True])
def test_ranking_metrics_bitwise(name, eval_at, weighted):
    """The same float64 numpy operations on both sides: equal (tolerance
    0); the layout has queries without positives and all-zero labels."""
    groups, label, score = _edge_queries(7)
    label[label == 1] = 0.0
    weight = (np.random.RandomState(8).uniform(0.5, 2.0, size=len(label))
              if weighted else None)
    params = {"metric": name, "eval_at": eval_at}
    jm = jrank.create_ranking_metric(name, JConfig.from_params(params))
    tm = trank.create_ranking_metric(
        name, TConfig.from_params(dict(params, device_type="cpu")))
    jm.init(label, weight, groups)
    tm.init(label, weight, groups)
    assert tm.name == jm.name == [f"{name}@{k}" for k in eval_at]
    for s in (score, np.zeros_like(score)):
        assert tm.eval(s.astype(np.float64)) == jm.eval(s.astype(np.float64))


def _rank_data(seed, n_queries=100, longest=60, f=8):
    rng = np.random.RandomState(seed)
    groups = rng.randint(1, longest + 1, size=n_queries)
    n = int(groups.sum())
    X = rng.normal(size=(n, f))
    X[rng.uniform(size=n) < 0.2, 2] = 0.0
    rel = X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 3] ** 2 + 0.5 * rng.normal(
        size=n)
    y = np.clip(np.floor(rel + 1.5), 0, 4)
    return X, y, groups


def _train_both(params, weight=False, init_score=False, longest=60):
    X, y, g = _rank_data(20, longest=longest)
    Xv, yv, gv = _rank_data(21, n_queries=30, longest=longest)
    rng = np.random.RandomState(22)
    kw = {"weight": rng.uniform(0.5, 2.0, size=len(y)) if weight else None,
          "init_score": rng.normal(size=len(y)) * 0.1 if init_score
          else None}
    vkw = {"init_score": rng.normal(size=len(yv)) * 0.1 if init_score
           else None}
    params = dict(params, num_leaves=15, max_bin=63, verbosity=-1,
                  metric=["ndcg", "map"], eval_at=[1, 3, 5])
    jres, tres = {}, {}
    jt = lj.Dataset(X, label=y, group=g, **kw)
    bj = lj.train(dict(params), jt, ROUNDS,
                  valid_sets=[lj.Dataset(Xv, label=yv, group=gv,
                                         reference=jt, **vkw)],
                  valid_names=["v"], evals_result=jres)
    tt = lt.Dataset(X, label=y, group=g, **kw)
    bt = lt.train(dict(params, device_type="cpu"), tt, ROUNDS,
                  valid_sets=[tt.create_valid(Xv, label=yv, group=gv,
                                              **vkw)],
                  valid_names=["v"], evals_result=tres)
    return bj, bt, jres, tres, Xv


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_model_text_bitwise(objective, q8):
    bj, bt, jres, tres, Xv = _train_both(
        {"objective": objective, "quantized_grad": q8, "seed": 5})
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert f"objective={objective}" in text
    np.testing.assert_array_equal(bt.predict(Xv), bj.predict(Xv))
    assert sorted(tres["v"]) == sorted(jres["v"]) == sorted(
        [f"ndcg@{k}" for k in (1, 3, 5)] + [f"map@{k}" for k in (1, 3, 5)])
    assert tres == jres


@pytest.mark.parametrize("longest", [20, 30])
def test_lambdarank_model_text_bitwise_in_vectorised_regime(longest):
    """Longest query 20 (M = 24) and 30 (M = 32): XLA's vectorised sums,
    the M = 32 loop unswitched on the first iteration's tied scores."""
    bj, bt, jres, tres, _ = _train_both({"objective": "lambdarank"},
                                        longest=longest)
    assert bt.model_to_string() == bj.model_to_string()
    assert tres == jres


def test_weights_init_score_and_label_gain_model_text_bitwise():
    bj, bt, jres, tres, Xv = _train_both(
        {"objective": "lambdarank", "label_gain": [0, 1, 2, 4, 9],
         "lambdarank_truncation_level": 10}, weight=True, init_score=True)
    text = bt.model_to_string()
    assert text == bj.model_to_string()
    assert "[lambdarank_truncation_level: 10]" in text
    np.testing.assert_array_equal(bt._boosting.objective.gains,
                                  [0, 1, 2, 4, 9])
    np.testing.assert_array_equal(bt.predict(Xv, raw_score=True),
                                  bj.predict(Xv, raw_score=True))
    assert tres == jres


def test_dataset_group_and_init_score_fields():
    X, y, g = _rank_data(30, n_queries=20)
    a = lt.Dataset(X, label=y, group=g)
    b = lt.Dataset(X, label=y).set_group(list(g))
    c = lt.Dataset(X, label=y).set_field("group", g.astype(np.int32))
    for ds in (a, b, c):
        assert ds.get_group().dtype == np.int64
        np.testing.assert_array_equal(ds.get_group(), g)
        np.testing.assert_array_equal(ds.get_field("group"), g)
    init = np.linspace(-1, 1, len(y))
    d = lt.Dataset(X, label=y, group=g).set_init_score(init)
    np.testing.assert_array_equal(d.get_init_score(), init)
    assert d.set_field("init_score", None).get_init_score() is None
    v = a.create_valid(X[:50], label=y[:50], group=[20, 30],
                       init_score=init[:50])
    assert v.reference is a
    np.testing.assert_array_equal(v.get_group(), [20, 30])
    with pytest.raises(Exception, match="Unknown field"):
        a.set_field("position", g)
    params = {"objective": "lambdarank", "verbosity": -1, "device_type": "cpu",
              "num_leaves": 7}
    with pytest.raises(Exception, match="query information"):
        lt.train(params, lt.Dataset(X, label=y), 1)
    # a valid set's init score starts its scores: ndcg@1 of the init score
    ev = {}
    bt = lt.train(dict(params, eval_at=[1]), a, 1, valid_sets=[v],
                  valid_names=["v"], evals_result=ev)
    gb = bt._boosting
    np.testing.assert_array_equal(
        gb._valid_scores[0].numpy().astype(np.float64),
        init[:50].astype(np.float32) + bt.predict(X[:50], raw_score=True)
        .astype(np.float32))
    assert list(ev["v"]) == ["ndcg@1"]


def test_saved_ranking_model_loads_back(tmp_path):
    X, y, g = _rank_data(31, n_queries=40)
    params = {"objective": "rank_xendcg", "verbosity": -1, "seed": 3,
              "device_type": "cpu", "num_leaves": 7}
    bt = lt.train(params, lt.Dataset(X, label=y, group=g), 3)
    path = tmp_path / "rank.txt"
    bt.save_model(str(path))
    loaded = lt.Booster(model_file=str(path),
                        params={"device_type": "cpu"})
    assert loaded._boosting.config.objective == "rank_xendcg"
    assert loaded.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(loaded.predict(X), bt.predict(X))
    # the identity conversion of the raw scores cast to float32, as the JAX
    # package converts them
    np.testing.assert_array_equal(
        bt.predict(X), bt.predict(X, raw_score=True).astype(np.float32))


def test_ranking_parameters_parse_as_jax():
    for params in ({"objective": "xendcg", "ndcg_eval_at": "1,3,5",
                    "label_gain": "0,1,3,7"},
                   {"objective": "lambdarank", "eval_at": [2, 4],
                    "lambdarank_truncation_level": "12",
                    "lambdarank_norm": "false", "metric": "map"},
                   {"objective": "rank_xendcg", "map_eval_at": "10",
                    "metric": "ndcg,map"}):
        jc = JConfig.from_params(dict(params))
        tc = TConfig.from_params(dict(params, device_type="cpu"))
        for name in ("objective", "eval_at", "label_gain", "metric",
                     "lambdarank_truncation_level", "lambdarank_norm"):
            assert getattr(tc, name) == getattr(jc, name), name
    from lightgbm_tpu_torch.metrics import default_metric_for_objective
    assert default_metric_for_objective("lambdarank") == ["ndcg"]
    assert default_metric_for_objective("rank_xendcg") == ["ndcg"]


# ------------------------------------ the kernel's order, transcribed
_FLT_MIN = np.float32(1.17549435082228750797e-38)


def _ftz32(x):
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < _FLT_MIN, x * np.float32(0.0),
                    x).astype(np.float32)


def _kernel_order_numpy(to, score):
    """``lambdarank_grads``' sums as the card's kernel adds them, written
    out in numpy query by query: a top document's (rank < trunc) higher
    and lower sums in 32 lanes (lane l over partners l, l + 32, ... of the
    query in ascending index, each from +0), combined by the butterfly
    v + v[l ^ m] for m = 16, 8, 4, 2, 1; any other document's over the top
    list in ascending index; the query's higher lambdas by 128 strided
    partial sums and a halving tree. The pair terms are the port's
    (``_pair_terms``), the normalisation its ``_normalise``."""
    lay = to.layout
    s = torch.from_numpy(score)
    rank, _, disc, same = trank_ops._preamble(s, lay)
    rank, disc = rank.numpy(), disc.numpy()
    lab, gain = to.label.numpy(), to.gain.numpy()
    trunc = to.truncation_level
    lam = np.zeros(lay.num_data, np.float32)
    hess = np.zeros_like(lam)
    sum_high = np.zeros(lay.num_queries, np.float32)
    lanes = np.arange(32)
    for q in range(lay.num_queries):
        b0, b1 = lay.bounds_np[q], lay.bounds_np[q + 1]
        n = b1 - b0
        sl = slice(b0, b1)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
        ok = ((lab[sl][:, None] > lab[sl][None, :])
              & (np.minimum(rank[sl][:, None], rank[sl][None, :]) < trunc))
        pl, ph = trank_ops._pair_terms(
            t(score[sl][:, None]), t(score[sl][None, :]),
            t(lab[sl][:, None]), t(lab[sl][None, :]),
            t(gain[sl][:, None]), t(gain[sl][None, :]),
            t(disc[sl][:, None]), t(disc[sl][None, :]), t(ok),
            to.inv_max_dcg[q], same[q], to.sigmoid, to.norm)
        pl, ph = pl.numpy(), ph.numpy()
        # [d, k]: d higher, k lower; and the transposes: k higher, d lower
        terms = ((ok, pl), (ok, ph), (ok.T, pl.T), (ok.T, ph.T))
        top = rank[sl] < trunc
        sums = []
        for o, x in terms:
            steps = -(-n // 32)
            acc = np.zeros((n, 32), np.float32)
            for st in range(steps):
                k = st * 32 + lanes
                inside = k < n
                kk = np.minimum(k, n - 1)
                add = o[:, kk] & inside[None, :]
                acc = np.where(add, _ftz32(acc + x[:, kk]), acc)
            for m in (16, 8, 4, 2, 1):
                acc = _ftz32(acc + acc[:, lanes ^ m])
            top_sum = acc[:, 0]
            seq = np.zeros(n, np.float32)
            for k in range(n):
                seq = np.where(o[:, k], _ftz32(seq + x[:, k]), seq)
            sums.append(np.where(top, top_sum, seq))
        hl, hh, ll, lh = sums
        lam[sl] = _ftz32(hl - ll)
        hess[sl] = _ftz32(hh + lh)
        part = np.zeros(128, np.float32)
        for k in range(n):
            part[k % 128] = _ftz32(part[k % 128] + hl[k])
        width = 64
        while width:
            part[:width] = _ftz32(part[:width] + part[width:2 * width])
            width //= 2
        sum_high[q] = part[0]
    g, h = trank_ops._normalise(torch.from_numpy(lam), torch.from_numpy(hess),
                                torch.from_numpy(sum_high), lay.qid,
                                to.norm)
    return g.numpy(), h.numpy()


def _order_layout(seed):
    """A query longer than the kernel's partner tile (256) and than 32 x
    trunc, a one-document query, tied scores, labels all 0, and short
    ones."""
    rng = np.random.RandomState(seed)
    groups = np.array([2100, 1, 40, 7, 33, 12, 64, 1, 130])
    b = np.concatenate([[0], np.cumsum(groups)])
    n = int(b[-1])
    label = rng.randint(0, 5, size=n).astype(np.float64)
    score = rng.normal(size=n).astype(np.float32)
    score[b[2]:b[3]] = 0.25                       # all tied
    label[b[3]:b[4]] = 0.0                        # labels all 0
    score[b[6]:b[7]] = np.round(score[b[6]:b[7]])  # ties among others
    return groups, label, score


@pytest.mark.parametrize("params", [
    {},
    {"lambdarank_truncation_level": 3},
    {"lambdarank_truncation_level": 5000},
    {"lambdarank_norm": False, "sigmoid": 2.0}],
    ids=["default", "trunc3", "trunc_above_n", "no_norm_sigmoid2"])
def test_exact_is_the_kernel_order(params):
    """``lambdarank_grads_exact`` is bitwise the kernel's sum order written
    out in numpy: lane-strided sums and the butterfly for the top
    documents, ascending sums for the rest, the block's strided sums and
    halving tree for the query's lambda sum."""
    groups, label, score = _order_layout(9)
    _, to = _objectives(dict({"objective": "lambdarank"}, **params), label,
                        None, groups)
    s = torch.from_numpy(score)
    eg, eh = trank_ops.lambdarank_grads_exact(
        s, to.label, to.gain, to.inv_max_dcg, to.layout, to.sigmoid,
        to.truncation_level, to.norm)
    ng, nh = _kernel_order_numpy(to, score)
    np.testing.assert_array_equal(_bits(eg), _bits(ng))
    np.testing.assert_array_equal(_bits(eh), _bits(nh))
    # the layout's block order: longest first, ties by index
    np.testing.assert_array_equal(to.layout.by_length.numpy(),
                                  np.argsort(-groups, kind="stable"))
