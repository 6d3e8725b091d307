"""The streaming construct of the PyTorch port against the JAX package.

The port's ``binning.FeatureSketch`` folds, merges and compacts as the
JAX package's (values, counts and compactions equal after the same
folds); ``fit_mappers_from_sketches`` fits the same mappers;
``Dataset.from_chunks`` and ``construct_streaming`` on array input give
mappers bitwise the JAX package's ``from_chunks`` and a ``binsT`` equal to
the JAX ``bins`` transposed, for float32 and float64 chunks; a streamed
model's text is the port's monolithic text (itself pinned to the JAX
package's by the training tests). The rest of the JAX package's streaming
tests: the valid-set alignment, the memory bound by a weakref census and
the gauges, the scopes, the rejections and the ``free_dataset`` audit.
``distributed.load_partitioned_chunks``: a gang of one against the
monolithic ``load_partitioned``, a gang of two thread-ranks (the same
mappers on both ranks and at world size 1), and a gang of eight against the
JAX package's single-process chunked run, whose data learner spans the
test process's 8 virtual devices. Everything on the CPU, at 2,000 x 5.
"""

import json
import weakref

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import binning as jb
from lightgbm_tpu import distributed as jd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import binning as tb
from lightgbm_tpu_torch import distributed as td
from lightgbm_tpu_torch import network, telemetry
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils import profiling

torch.set_num_threads(1)

P = {"verbosity": -1}
TP = {"verbosity": -1, "device_type": "cpu"}
TRAIN = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
         "verbosity": -1, "device_type": "cpu"}


def _data(rng, n=2000, f=5, dtype=np.float32):
    X = rng.normal(size=(n, f)).astype(dtype)
    X[:, f - 2] *= (rng.rand(n) < 0.3)          # zero-heavy column
    X[rng.rand(n) < 0.05, f - 1] = np.nan       # NaN column
    y = (np.nan_to_num(X[:, 0] + 0.5 * X[:, 1] - X[:, f - 2]) > 0) \
        .astype(np.float64)
    return X, y


def _chunks(X, y=None, rows=700):
    return [X[s:s + rows] if y is None else (X[s:s + rows], y[s:s + rows])
            for s in range(0, len(X), rows)]


def _mapper_fields(m):
    return (m.num_bin, m.missing_type, m.bin_type, m.is_trivial,
            m.sparse_rate, np.asarray(m.bin_upper_bound,
                                      np.float64).tobytes(),
            list(m.bin_2_categorical), dict(m.categorical_2_bin),
            m.default_bin, m.most_freq_bin, m.min_val, m.max_val)


def _same_mappers(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        assert _mapper_fields(ma) == _mapper_fields(mb)


def _same_sketch(a, b):
    assert a.values.tobytes() == b.values.tobytes()
    assert a.counts.tobytes() == b.counts.tobytes()
    assert (a.na_cnt, a.total_cnt, a.compactions, a.max_size) == \
        (b.na_cnt, b.total_cnt, b.compactions, b.max_size)


def _folded(mod, col, max_size, step):
    sk = mod.FeatureSketch(max_size=max_size)
    for s in range(0, len(col), step):
        sk.fold(col[s:s + step])
    return sk


# ------------------------------------------------------------- sketches
def test_sketch_compaction_rank_error_budget():
    """A compacted sketch's values, counts and compactions are the JAX
    package's; its ranks lie within ~2 * compactions / max_size of exact
    and the fitted mapper (the JAX one) keeps a healthy bin count."""
    col = np.random.RandomState(5).normal(size=20000)
    sk = _folded(tb, col, 256, 2500)
    _same_sketch(sk, _folded(jb, col, 256, 2500))
    assert sk.compactions > 0 and len(sk.values) <= 256
    sv = np.sort(col)
    sketch_rank = np.cumsum(sk.counts) / sk.total_cnt
    true_rank = np.searchsorted(sv, sk.values, side="right") / len(col)
    err = float(np.max(np.abs(sketch_rank - true_rank)))
    assert err <= 2.0 * sk.compactions / sk.max_size, err
    m = tb.fit_mappers_from_sketches([sk], len(col),
                                     TConfig.from_params(dict(TP)))[0]
    mj = jb.fit_mappers_from_sketches([_folded(jb, col, 256, 2500)],
                                      len(col), JConfig.from_params(P))[0]
    _same_mappers([m], [mj])
    assert m.num_bin > 200


def test_sketch_zero_slot_survives_compaction():
    rng = np.random.RandomState(2)
    col = np.where(rng.rand(10000) < 0.4, 0.0, rng.normal(size=10000))
    sk = _folded(tb, col, 64, 1000)
    _same_sketch(sk, _folded(jb, col, 64, 1000))
    zi = np.searchsorted(sk.values, 0.0)
    assert zi < len(sk.values) and sk.values[zi] == 0.0


def test_sketch_json_roundtrip_and_merge():
    """to_dict / from_dict round-trips float64 bit for bit (the gang's
    payload, the JAX package's JSON text), and two merged half-sketches
    are the whole one."""
    rng = np.random.RandomState(3)
    col = rng.normal(size=2000)
    col[::97] = np.nan
    whole = tb.FeatureSketch()
    whole.fold(col)
    a, b = tb.FeatureSketch(), tb.FeatureSketch()
    a.fold(col[:1100])
    b.fold(col[1100:])
    a.merge(tb.FeatureSketch.from_dict(json.loads(json.dumps(b.to_dict()))))
    _same_sketch(a, whole)
    assert a.exact
    rt = tb.FeatureSketch.from_dict(json.loads(json.dumps(whole.to_dict())))
    _same_sketch(rt, whole)
    jw = jb.FeatureSketch()
    jw.fold(col)
    assert json.dumps(whole.to_dict()) == json.dumps(jw.to_dict())


def test_merge_feature_sketches_single_process():
    sk = tb.FeatureSketch()
    sk.fold(np.arange(10.0))
    merged = td.merge_feature_sketches([sk])
    assert merged[0] is sk


def test_mappers_from_sketches_match_jax():
    """Numerical, zero-heavy, NaN and categorical columns, exact sketches
    over two chunks: the port's mappers are the JAX package's field for
    field, and they are the sampled ``find_bin_mappers``' (every row the
    sample); a compacted categorical feature fails as in the JAX
    package."""
    rng = np.random.RandomState(11)
    X, _ = _data(rng, n=1500, f=6, dtype=np.float64)
    X[:, 1] = rng.randint(0, 9, 1500)
    cfg_t, cfg_j = TConfig.from_params(dict(TP)), JConfig.from_params(P)
    sks_t = tb.sketch_chunks(lambda: iter(_chunks(X, rows=600)))[0]
    sks_j = jb.sketch_chunks(lambda: iter(_chunks(X, rows=600)))[0]
    for a, b in zip(sks_t, sks_j):
        _same_sketch(a, b)
    mt = tb.fit_mappers_from_sketches(sks_t, len(X), cfg_t, [1])
    _same_mappers(mt, jb.fit_mappers_from_sketches(sks_j, len(X), cfg_j,
                                                   [1]))
    _same_mappers(mt, tb.find_bin_mappers(X, cfg_t, [1]))
    small = tb.FeatureSketch(max_size=4)
    small.fold(np.arange(20.0))
    with pytest.raises(tlog.LightGBMError, match="sketch_max_size"):
        tb.fit_mappers_from_sketches([small], 20, cfg_t, [0])


def test_find_bin_from_distinct_matches_jax():
    """``find_bin`` fits through ``find_bin_from_distinct`` in both
    packages: the same summary gives the same mapper, numerical (with an
    implied zero count) and categorical."""
    rng = np.random.RandomState(4)
    vals = np.unique(np.round(rng.normal(size=300), 2))
    counts = rng.randint(1, 5, len(vals)).astype(np.int64)
    total = int(counts.sum()) + 40 + 3
    for kw in ({}, {"bin_type": 1}, {"zero_as_missing": True},
               {"max_bin": 16, "min_data_in_bin": 5}):
        cv = np.abs(np.round(vals * 10)) if kw.get("bin_type") else vals
        cv, inv = np.unique(cv, return_inverse=True)
        cc = np.zeros(len(cv), np.int64)
        np.add.at(cc, inv, counts)
        args = dict({"max_bin": 255}, **kw)
        mt, mj = tb.BinMapper(), jb.BinMapper()
        mt.find_bin_from_distinct(cv, cc, 3, total, **args)
        mj.find_bin_from_distinct(cv, cc, 3, total, **args)
        _same_mappers([mt], [mj])


# ----------------------------------------------------- streaming construct
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_from_chunks_matches_jax(rng, dtype):
    """``from_chunks`` with labelled chunks: mappers bitwise the JAX
    package's ``from_chunks``, ``binsT`` its ``bins`` transposed and the
    port's own monolithic construct's (float64 chunks quantize on the
    device in float64, where the JAX package bins them on the host)."""
    X, y = _data(rng, dtype=dtype)
    ds_t = lt.Dataset.from_chunks(_chunks(X, y), params=dict(TP))
    ds_t.construct()
    ds_j = lj.Dataset.from_chunks(_chunks(X, y), params=dict(P))
    ds_j.construct()
    _same_mappers(ds_t.mappers, ds_j.mappers)
    assert np.array_equal(ds_t.binsT.numpy(), np.asarray(ds_j.bins).T)
    assert np.array_equal(ds_t.get_label(), y)
    ds_m = lt.Dataset(X.copy(), label=y, params=dict(TP)).construct()
    _same_mappers(ds_t.mappers, ds_m.mappers)
    assert torch.equal(ds_t.binsT, ds_m.binsT)
    host = tb.bin_data(X[:, ds_t.used_features],
                       [ds_t.mappers[j] for j in ds_t.used_features])
    assert np.array_equal(ds_t.binsT.numpy(), host.T)


def test_construct_streaming_array_input_matches_jax(rng):
    """``construct_streaming`` with ``construct_chunk_rows`` slices array
    input into chunks: the JAX package's mappers and bins."""
    X, y = _data(rng)
    extra = {"construct_streaming": True, "construct_chunk_rows": 700}
    ds_t = lt.Dataset(X, label=y, params=dict(TP, **extra)).construct()
    ds_j = lj.Dataset(X, label=y, params=dict(P, **extra))
    ds_j.construct()
    _same_mappers(ds_t.mappers, ds_j.mappers)
    assert np.array_equal(ds_t.binsT.numpy(), np.asarray(ds_j.bins).T)
    assert ds_t.construct_stats["rows"] == len(X)
    assert ds_t.data is None and ds_t._chunk_source is None


def test_chunked_vs_monolithic_model_text_identical(rng):
    """Both streaming front ends train, at 4 rounds, to the port's
    monolithic model text, and the chunked dataset passes the
    free_dataset / construct re-entry audit."""
    X, y = _data(rng)
    b_m = lt.train(dict(TRAIN), lt.Dataset(X.copy(), label=y,
                                           params=dict(TP)), 4)
    ds_c = lt.Dataset.from_chunks(_chunks(X, y), params=dict(TP))
    b_c = lt.train(dict(TRAIN), ds_c, 4)
    assert b_m.model_to_string() == b_c.model_to_string()
    ds_s = lt.Dataset(X.copy(), label=y,
                      params=dict(TP, construct_streaming=True,
                                  construct_chunk_rows=700))
    b_s = lt.train(dict(TRAIN), ds_s, 4)
    assert b_m.model_to_string() == b_s.model_to_string()
    assert ds_c.data is None and ds_c._chunk_source is None
    assert ds_c.raw_data_np is None
    assert ds_c.construct() is ds_c
    want = b_c.predict(X[:32])
    b_c.free_dataset()
    assert ds_c.bins is None and ds_c._chunk_source is None
    assert ds_c.label is None
    np.testing.assert_array_equal(b_c.predict(X[:32]), want)


def test_valid_set_aligns_to_streaming_reference(rng):
    """A monolithic valid set of a streamed train set takes its mappers
    and evaluates every round; a streamed valid set with ``reference=``
    makes the light pass and bins as the monolithic one."""
    X, y = _data(rng)
    ds = lt.Dataset.from_chunks(_chunks(X, y), params=dict(TP))
    Xv, yv = _data(np.random.RandomState(9), n=700)
    ev = {}
    lt.train(dict(TRAIN), ds, 3, valid_sets=[ds.create_valid(Xv, label=yv)],
             valid_names=["v"], evals_result=ev)
    assert "v" in ev and len(next(iter(ev["v"].values()))) == 3
    vs = lt.Dataset.from_chunks(_chunks(Xv, yv, rows=300), reference=ds,
                                params=dict(TP)).construct()
    vm = lt.Dataset(Xv, label=yv, reference=ds, params=dict(TP)).construct()
    assert vs.mappers is ds.mappers
    assert torch.equal(vs.binsT, vm.binsT)
    np.testing.assert_array_equal(vs.get_label(), yv)


def test_streaming_memory_bounded_and_gauges(rng):
    """At most 2 raw chunks alive at any moment (weakref census over a
    generator source), the gauges record the peak within a chunk plus the
    staged copy, the snapshot reads them, and a later monolithic construct
    changes neither the dataset's ``construct_stats`` nor the snapshot."""
    X, y = _data(rng)
    chunk = 700
    live, peak_live = set(), [0]

    def factory():
        def gen():
            for s in range(0, len(X), chunk):
                c = np.array(X[s:s + chunk])
                live.add(id(c))
                weakref.finalize(c, live.discard, id(c))
                peak_live[0] = max(peak_live[0], len(live))
                yield c, np.array(y[s:s + chunk])
        return gen()

    ds = lt.Dataset.from_chunks(factory, params=dict(TP))
    ds.construct()
    assert peak_live[0] <= 2, f"{peak_live[0]} chunks alive"
    g = profiling.gauges()
    assert 0 < g["construct_peak_bytes"] <= 2 * chunk * X.shape[1] * 4
    assert g["construct_rows"] == len(X)
    for k in ("construct_sketch_s", "construct_bin_s",
              "construct_h2d_overlap_s"):
        assert k in g
    snap = telemetry.construct_snapshot()
    assert snap["rows"] == len(X) and "rows_per_sec" in snap
    assert {"sketch_pass", "bin_pass", "h2d_overlap"} <= set(snap)
    stats = ds.construct_stats
    assert stats["rows"] == len(X) and stats["peak_host_bytes"] > 0
    lt.Dataset(X[:300].copy(), label=y[:300], params=dict(TP)).construct()
    assert ds.construct_stats == stats
    assert telemetry.construct_snapshot() == snap


def test_streaming_scopes_and_recorder_header(rng, tmp_path):
    """Under profiling the construct runs its ``sketch_pass``,
    ``bin_pass`` and ``h2d_overlap`` scopes inside ``construct``; the
    flight recorder's header carries the dataset's ``construct_stats``."""
    X, y = _data(rng)
    was = profiling.enabled()
    profiling.reset()
    profiling.enable(True)
    try:
        ds = lt.Dataset(X, label=y, params=dict(
            TP, construct_streaming=True, construct_chunk_rows=700))
        lt.train(dict(TRAIN, telemetry_dir=str(tmp_path)), ds, 2)
        sc = profiling.scopes()
    finally:
        profiling.enable(was)
        profiling.reset()
    assert {"construct", "sketch_pass", "bin_pass", "h2d_overlap"} <= set(sc)
    recs, errors = telemetry.validate_flight_jsonl(
        str(tmp_path / "flight_rank0.jsonl"))
    assert errors == [] and recs[0]["type"] == "run"
    assert recs[0]["context"]["construct"] == ds.construct_stats


REJECTIONS = {
    "linear_tree": "linear_tree",
    "one_shot_iterator": "re-iterable",
    "labels_twice": "one or the other",
    "scipy_sparse": "dense arrays or chunk sources",
    "bundled_reference": "EFB-bundled",
    "dtype_changed": "dtype changed mid-stream",
    "rows_changed": "rows on the bin pass",
    "width_changed": "feature count changed",
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_streaming_rejections(rng, case):
    """Each refusal of the JAX package's streaming construct, with its
    message."""
    import scipy.sparse as sp
    X, y = _data(rng, n=400)
    if case == "linear_tree":
        ds = lt.Dataset(X, label=y, params=dict(
            TP, linear_tree=True, construct_streaming=True))
    elif case == "one_shot_iterator":
        ds = lt.Dataset.from_chunks(iter([X]), params=dict(TP))
    elif case == "labels_twice":
        ds = lt.Dataset.from_chunks([(X, y)], label=y, params=dict(TP))
    elif case == "scipy_sparse":
        ds = lt.Dataset(sp.csr_matrix(X), label=y,
                        params=dict(TP, construct_streaming=True))
    elif case == "bundled_reference":
        Xs = sp.random(400, 12, density=0.05, random_state=1, format="csr")
        ref = lt.Dataset(Xs, label=y, params=dict(TP)).construct()
        assert ref.bundles is not None
        ds = lt.Dataset.from_chunks([Xs.toarray()], reference=ref,
                                    params=dict(TP))
    elif case == "dtype_changed":
        ds = lt.Dataset.from_chunks([X[:200], X[200:].astype(np.float64)],
                                    label=y, params=dict(TP))
    elif case == "rows_changed":
        calls = [0]

        def source():
            calls[0] += 1
            return iter([X] if calls[0] == 1 else [X[:300]])

        ds = lt.Dataset.from_chunks(source, label=y, params=dict(TP))
    else:
        ds = lt.Dataset.from_chunks([X[:200], X[200:, :4]], label=y,
                                    params=dict(TP))
    with pytest.raises(tlog.LightGBMError, match=REJECTIONS[case]):
        ds.construct()


# ------------------------------------------------ load_partitioned_chunks
TR = {"objective": "binary", "num_leaves": 8, "tree_learner": "data",
      "min_data_in_leaf": 5, "boost_from_average": False, "verbosity": -1}
LP = {"min_data_in_leaf": 5, "verbosity": -1, "enable_bundle": False}


def _gang_data():
    rng = np.random.RandomState(13)
    n, f = 400, 6
    X = rng.normal(size=(n, f))
    X[:, 4] *= (rng.rand(n) < 0.3)
    y = (X[:, 0] + 0.5 * X[:, 1] - X[:, 4] > 0).astype(np.float64)
    return X, y


def _gang_rank(net, rounds=3):
    """One rank of a pre-partitioned gang: its contiguous rows as two
    chunks through ``load_partitioned_chunks``, and as one matrix
    through ``load_partitioned``; mappers, the gang's rows binned by the
    agreed mappers, and both model texts."""
    X, y = _gang_data()
    c = len(X) // net.world
    Xl, yl = X[net.rank * c:(net.rank + 1) * c], y[net.rank * c:
                                                  (net.rank + 1) * c]
    h = c // 2
    p = dict(LP, device_type="cpu")
    ds = td.load_partitioned_chunks([(Xl[:h], yl[:h]), (Xl[h:], yl[h:])],
                                    params=dict(p))
    out = {"mappers": [_mapper_fields(m) for m in ds.mappers],
           "bins": ds.bin_new_data(X).numpy().tobytes(),
           "fields": (ds.is_pre_partitioned, ds.num_data, ds.num_local_data,
                      ds.partition_counts, ds.local_row_start),
           "stats": ds.construct_stats,
           "chunked": lt.train(dict(TR, device_type="cpu"), ds,
                               rounds).model_to_string()}
    dm = td.load_partitioned(Xl, label=yl, params=dict(p))
    out["mono_fields"] = (dm.is_pre_partitioned, dm.num_data,
                          dm.num_local_data, dm.partition_counts,
                          dm.local_row_start)
    out["mono"] = lt.train(dict(TR, device_type="cpu"), dm,
                           rounds).model_to_string()
    return out


def test_load_partitioned_chunks_single_process_parity():
    """A gang of one: the chunked loader sets the pre-partitioned fields
    as ``load_partitioned`` does and trains to its text."""
    out = network.thread_gang(1, _gang_rank)[0]
    assert out["fields"] == out["mono_fields"] == (True, 400, 400, [400], 0)
    assert out["chunked"] == out["mono"]
    assert out["stats"]["rows"] == 400


def test_two_rank_sketch_merge():
    """Two thread-ranks, each folding its half as two chunks: the merged
    sketches fit the same mappers on both ranks and at world size 1 (the
    gang's rows binned the same everywhere), each rank's fields are its
    slice's, and the data learner's text is the monolithic gang's."""
    two = network.thread_gang(2, _gang_rank)
    one = network.thread_gang(1, lambda net: _gang_rank(net, rounds=0))[0]
    assert two[0]["mappers"] == two[1]["mappers"] == one["mappers"]
    assert two[0]["bins"] == two[1]["bins"] == one["bins"]
    for r in (0, 1):
        assert two[r]["fields"] == two[r]["mono_fields"] == (
            True, 400, 200, [200, 200], 200 * r)
        assert two[r]["chunked"] == two[r]["mono"]
    assert two[0]["chunked"] == two[1]["chunked"]


def test_eight_rank_chunked_matches_jax_single_process():
    """The JAX package's single-process chunked run shards its data
    learner over the test process's 8 virtual devices; the port's gang of
    8 thread-ranks, each folding its eighth as two chunks, trains to its
    model text byte for byte."""
    X, y = _gang_data()
    h = len(X) // 2
    ds = jd.load_partitioned_chunks([(X[:h], y[:h]), (X[h:], y[h:])],
                                    params=dict(LP))
    want = lj.train(dict(TR), ds, 3).model_to_string()
    got = network.thread_gang(8, _gang_rank)
    assert got[0]["chunked"] == want
    assert got[0]["mappers"] == [_mapper_fields(m) for m in ds.mappers]


def test_merge_width_mismatch_fails_before_the_exchange():
    """Ranks whose sources disagree on the feature count fail at once on
    every rank (no rank hangs in the batched exchange)."""
    def body(net):
        sks = [tb.FeatureSketch() for _ in range(5 + net.rank)]
        with pytest.raises(tlog.LightGBMError, match="disagree on feature"):
            td.merge_feature_sketches(sks)
        return True

    assert network.thread_gang(2, body, timeout=30) == [True, True]


def test_sketch_payloads_stay_out_of_the_store(monkeypatch):
    """A gang's merge puts only the feature counts into the store (a few
    bytes a rank, under keys that are never deleted); the sketches
    themselves go through the gang's collective, and both ranks fit the
    same mappers."""
    stored, gathered = [], []
    real_x, real_g = network.Network.exchange_host, \
        network.Network.allgather_object

    def exchange_host(self, tag, payload, timeout=None):
        stored.append((tag, len(payload)))
        return real_x(self, tag, payload, timeout)

    def allgather_object(self, obj):
        gathered.append(len(obj))
        return real_g(self, obj)

    monkeypatch.setattr(network.Network, "exchange_host", exchange_host)
    monkeypatch.setattr(network.Network, "allgather_object",
                        allgather_object)
    X, y = _gang_data()

    def body(net):
        c = len(X) // net.world
        Xl, yl = X[net.rank * c:(net.rank + 1) * c], \
            y[net.rank * c:(net.rank + 1) * c]
        ds = td.load_partitioned_chunks(
            [(Xl[:c // 2], yl[:c // 2]), (Xl[c // 2:], yl[c // 2:])],
            params=dict(LP, device_type="cpu"))
        return [_mapper_fields(m) for m in ds.mappers]

    got = network.thread_gang(2, body)
    assert got[0] == got[1]
    sketch = [n for tag, n in stored if tag.startswith("sketch_")]
    assert len(sketch) == 2 and max(sketch) <= 8
    assert len(gathered) == 2 and min(gathered) > 1000
