"""The port's serving front end (``lightgbm_tpu_torch/serving.py``) and
the predict engine's serve mode against the JAX package's, on the CPU.

The same small model (2,000 rows, 10 features, 15 leaves, 10 rounds,
trained by both packages to the same text) stands behind the JAX
``ServeFrontend`` and the port's:

- single and coalesced requests are bitwise each other, the port
  booster's own predict and the JAX frontend's answers, raw and
  converted; a small request after a large one reads no stale rows;
- serve mode: one slot a power-of-two bucket, its buffers kept from
  flush to flush (the same ``data_ptr``), outputs bitwise the ordinary
  path; ``close`` and a swap release the slots;
- deadlines name ``dispatch`` or ``queue-wait`` (the slow-predict fault),
  admission control sheds with a retriable error recorded as one episode,
  a lone oversized request still runs, a crash in dispatch reaches the
  callers and the dispatcher lives on;
- hot swap: the new version bitwise a cold model and the JAX frontend
  after the same swap; every rejection leaves the old version serving;
  a request admitted before a swap answers with the old bits;
- a serve-time allocation failure rides the predict-chunk rung, for a
  trained and a file-loaded model;
- the error messages and ``stats()`` keys are the JAX package's; the
  policy comes from the ``serve_*`` parameters; two models serve side by
  side.
"""

import os
import re
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import serving as jserving
from lightgbm_tpu_torch import distributed as tdist
from lightgbm_tpu_torch import serving as tserving
from lightgbm_tpu_torch.utils import faults as tfaults
from lightgbm_tpu_torch.utils import profiling as tprof
from lightgbm_tpu_torch.serving import (ServeFrontend, ServeOverloadError,
                                        ServeSwapError, ServeTimeoutError)

torch.set_num_threads(1)

SLOW_ENV = "LGBM_TPU_FAULT_SLOW_PREDICT_MS"
OOM_ENV = "LGBM_TPU_FAULT_OOM_AT_PREDICT"
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1, "seed": 1}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(os.environ):
        if name.startswith("LGBM_TPU_FAULT_"):
            monkeypatch.delenv(name)
    tfaults.reset_predict_oom()
    yield
    tfaults.reset_predict_oom()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(11)
    X = rng.normal(size=(2000, 10))
    y = (X[:, 0] + 0.4 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _train(X, y, lib=lt, nround=10, **extra):
    p = dict(BASE, **extra)
    if lib is lt:
        p["device_type"] = "cpu"
    return lib.train(p, lib.Dataset(X, label=y, params=dict(p)), nround)


@pytest.fixture(scope="module")
def model(data):
    return _train(*data)


@pytest.fixture(scope="module")
def jax_model(data):
    return _train(*data, lib=lj)


@pytest.fixture()
def frontend(model):
    fe = ServeFrontend(model, flush_ms=5.0)
    yield fe
    fe.close()


def _trees(text):
    return text.split("\nparameters:")[0]


# ------------------------------------------------------- batching parity
def test_models_are_the_same_text(model, jax_model):
    assert _trees(model.model_to_string()) == \
        _trees(jax_model.model_to_string())


@pytest.mark.parametrize("raw", [False, True], ids=["converted", "raw"])
def test_single_request_bit_identical(frontend, model, jax_model, data,
                                      raw):
    X, _ = data
    jfe = jserving.ServeFrontend(jax_model, flush_ms=5.0)
    try:
        want = jfe.predict(X[:37], raw_score=raw)
    finally:
        jfe.close()
    got = frontend.predict(X[:37], raw_score=raw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, model.predict(X[:37], raw_score=raw))


def _concurrent(fe, X, sizes):
    offs = np.cumsum([0] + sizes)
    res, errs = {}, {}

    def go(i):
        try:
            res[i] = fe.predict(X[offs[i]:offs[i + 1]])
        except BaseException as e:       # noqa: BLE001 -- reported
            errs[i] = e

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(sizes))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    return [res[i] for i in range(len(sizes))], offs


def test_coalesced_bit_identical(model, jax_model, data):
    """Five concurrent requests coalesce into fewer flushes, each answer
    bitwise the unbatched predict and the JAX frontend's answer to the
    same requests."""
    X, _ = data
    sizes = [1, 3, 17, 40, 8]
    answers = {}
    for lib, fe in ((lt, ServeFrontend(model, flush_ms=30.0)),
                    (lj, jserving.ServeFrontend(jax_model, flush_ms=30.0))):
        try:
            fe.predict(X[:1])
            before = fe.stats()["batches"]
            answers[lib], offs = _concurrent(fe, X, sizes)
            assert fe.stats()["batches"] - before < len(sizes)
        finally:
            fe.close()
    for i in range(len(sizes)):
        direct = model.predict(X[offs[i]:offs[i + 1]])
        assert np.array_equal(answers[lt][i], direct), f"request {i}"
        assert np.array_equal(answers[lt][i], answers[lj][i])


def test_padding_never_leaks_across_batch_sizes(frontend, model, data):
    X, _ = data
    big = frontend.predict(X[:1500])
    one = frontend.predict(X[1700:1701])
    assert np.array_equal(big, model.predict(X[:1500]))
    assert np.array_equal(one, model.predict(X[1700:1701]))


def test_serve_slots_reused(model, data):
    """One slot a bucket, its buffers the same from flush to flush, the
    answers bitwise the ordinary path (serve mode off)."""
    X, _ = data
    fe = ServeFrontend(model, flush_ms=5.0)
    try:
        eng = model._boosting._predict_engine()
        outs, ptrs = {}, None
        for n in (50, 7, 300, 1024):
            outs[n] = fe.predict(X[:n], raw_score=True)
            assert eng.serve_mode and list(eng._serve_slots) == [1024]
            slot = eng._serve_slots[1024]
            now = {k: t.data_ptr() for k, t in slot.tensors().items()}
            assert ptrs is None or now == ptrs
            ptrs = now
            assert slot.bins.binsT.shape[1] == eng.bucket_rows(n) == 1024
        outs[1025] = fe.predict(X[:1025], raw_score=True)
        assert sorted(eng._serve_slots) == [1024, 2048]
        assert eng.bucket_rows(1) == 1024 and eng.bucket_rows(4097) == 8192
    finally:
        fe.close()
    assert not model._boosting._serve_mode
    for n, out in outs.items():
        assert np.array_equal(out, model.predict(X[:n], raw_score=True))


@pytest.mark.parametrize("case", ["categorical", "multiclass",
                                  "compensated", "float32", "float32_rows",
                                  "missing"])
def test_serve_mode_bitwise_the_ordinary_path(data, case):
    """Serve mode against the ordinary path over the shapes its slots
    take: a categorical column (the host lookup into the pinned rows), K =
    3 carries, the two f32 accumulation modes, float32 rows (float32
    bounds), NaN and zero-as-missing values."""
    X, y = data
    X = X.copy()
    params, label = {}, y
    if case == "categorical":
        X[:, 2] = np.floor(np.abs(X[:, 2]) * 3)
        params = {"categorical_feature": [2]}
    elif case == "multiclass":
        label = (X[:, 0] > 0).astype(float) + (X[:, 1] > 0)
        params = {"objective": "multiclass", "num_class": 3}
    elif case in ("compensated", "float32"):
        params = {"predict_accum": case}
    elif case == "missing":
        X[::7, 3] = np.nan
        X[::5, 4] = 0.0
        params = {"zero_as_missing": True}
    b = _train(X, label, nround=4, **params)
    rows = X[:300].astype(np.float32) if case == "float32_rows" else X[:300]
    if case == "missing":
        rows = rows.copy()
        rows[::3, 4] = np.nan
    g = b._boosting
    want = [b.predict(rows[:n], raw_score=raw) for n in (1, 300)
            for raw in (False, True)]
    g.enable_serve_mode(True)
    try:
        got = [b.predict(rows[:n], raw_score=raw) for n in (1, 300)
               for raw in (False, True)]
        slot = g._predict_engine()._serve_slots[1024]
        assert slot.bins.dtype == rows.dtype
    finally:
        g.enable_serve_mode(False)
    for w, o in zip(want, got):
        assert w.dtype == o.dtype and np.array_equal(w, o)


# ---------------------------------------------------------- deadlines
def test_deadline_dispatch_phase(frontend, data, monkeypatch):
    X, _ = data
    frontend.predict(X[:10])
    monkeypatch.setenv(SLOW_ENV, "400")
    with pytest.raises(ServeTimeoutError) as ei:
        frontend.predict(X[:10], deadline_ms=100.0)
    assert ei.value.phase == "dispatch"
    assert "dispatch" in str(ei.value)
    assert tprof.gauges().get("serve_timeout_count", 0) >= 1


def test_deadline_queue_wait_phase(frontend, data, monkeypatch):
    X, _ = data
    frontend.predict(X[:10])
    monkeypatch.setenv(SLOW_ENV, "500")
    t = threading.Thread(target=lambda: frontend.predict(X[:10]))
    t.start()
    time.sleep(0.15)
    with pytest.raises(ServeTimeoutError) as ei:
        frontend.predict(X[10:20], deadline_ms=80.0)
    t.join(timeout=30)
    assert ei.value.phase == "queue-wait"
    assert "queue-wait" in str(ei.value)


@pytest.mark.parametrize("phase", ["queue-wait", "dispatch"])
def test_error_messages_match_jax(phase):
    kw = dict(phase=phase, model="m", version=3, rows=7, deadline_ms=50.0,
              waited_ms=61.25, queued_rows=5, inflight_rows=9)
    assert str(ServeTimeoutError(**kw)) == \
        str(jserving.ServeTimeoutError(**kw))
    kw = dict(model="m", rows=7, queued_rows=40, inflight_rows=9, limit=50)
    assert str(ServeOverloadError(**kw)) == \
        str(jserving.ServeOverloadError(**kw))
    assert ServeOverloadError.retriable is True
    assert tserving.__all__ == jserving.__all__


# ------------------------------------------------------------- shedding
def test_queue_overflow_sheds_retriable(model, data, monkeypatch):
    X, _ = data
    fe = ServeFrontend(model, flush_ms=2.0, max_queue_rows=50)
    try:
        fe.predict(X[:10])
        monkeypatch.setenv(SLOW_ENV, "400")
        shed_before = tdist.degradations()
        t1 = threading.Thread(target=lambda: fe.predict(X[:30]))
        t1.start()
        time.sleep(0.15)
        t2 = threading.Thread(target=lambda: fe.predict(X[30:45]))
        t2.start()
        time.sleep(0.05)
        with pytest.raises(ServeOverloadError) as ei:
            fe.predict(X[45:60])
        t1.join(timeout=30)
        t2.join(timeout=30)
    finally:
        monkeypatch.delenv(SLOW_ENV)
        fe.close()
    assert ei.value.retriable is True and ei.value.limit == 50
    assert fe.stats()["shed"] >= 1
    assert tprof.gauges().get("serve_shed_count", 0) >= 1
    sheds = [d for d in tdist.degradations()
             if d["kind"] == "serve_shed" and d not in shed_before]
    assert sheds and sheds[-1]["limit"] == 50
    assert "serve_shed_count" in tdist.health_snapshot().get("serve", {})


def test_shed_episode_count_reaches_degradation_log(model):
    fe = ServeFrontend(model, flush_ms=2.0, max_queue_rows=50)
    try:
        with fe._lock:
            for _ in range(3):
                fe._record_shed("default", 10, 50)
        ev = [d for d in tdist.degradations()
              if d["kind"] == "serve_shed"][-1]
        assert ev["count"] == 3 and fe.stats()["shed"] == 3
    finally:
        fe.close()


def test_dispatcher_survives_dispatch_crash(model, data):
    X, _ = data
    fe = ServeFrontend(model, flush_ms=2.0)
    try:
        fe.predict(X[:5])
        orig = fe._dispatch

        def boom(batch):
            raise MemoryError("simulated coalesce allocation failure")
        fe._dispatch = boom
        with pytest.raises(MemoryError):
            fe.predict(X[:5])
        fe._dispatch = orig
        assert fe._thread.is_alive()
        assert np.array_equal(fe.predict(X[:5]), model.predict(X[:5]))
    finally:
        fe.close()


def test_oversized_lone_request_admitted(model, data):
    X, _ = data
    fe = ServeFrontend(model, flush_ms=2.0, max_queue_rows=30)
    try:
        assert np.array_equal(fe.predict(X[:80]), model.predict(X[:80]))
        assert fe.stats()["shed"] == 0
    finally:
        fe.close()


# ------------------------------------------------------------- hot swap
def test_swap_success_bit_identical_to_cold_engine(model, data):
    """After a swap the answers are a cold clone's and the JAX frontend's
    after the same swap; the swapped-out booster leaves serve mode."""
    X, y = data
    fe = ServeFrontend(model, flush_ms=2.0)
    jfe = jserving.ServeFrontend(_train(X, y, lib=lj), flush_ms=2.0)
    try:
        fe.predict(X[:20])
        new = _train(X, y, learning_rate=0.2)
        cold = _train(X, y, learning_rate=0.2)
        assert fe.swap("default", new) == 2 and fe.version() == 2
        jfe.swap("default", _train(X, y, lib=lj, learning_rate=0.2))
        out = fe.predict(X[:50])
        assert np.array_equal(out, cold.predict(X[:50]))
        assert np.array_equal(out, jfe.predict(X[:50]))
        assert not np.array_equal(out, model.predict(X[:50]))
        assert not model._boosting._serve_mode
        assert new._boosting._serve_mode
    finally:
        fe.close()
        jfe.close()
        model._boosting.enable_serve_mode(False)


def test_swap_validation_failure_keeps_old_serving(model, data, tmp_path):
    """A corrupt file, the wrong feature count, the wrong class arity and
    a non-finite probe output are each refused with the JAX package's
    reasons; the old version keeps serving, bit for bit."""
    X, y = data
    narrow = _train(X[:, :4], y, nround=3)
    multi = lt.train(
        {"objective": "multiclass", "num_class": 3, "num_leaves": 5,
         "verbosity": -1, "device_type": "cpu"},
        lt.Dataset(X, label=(X[:, 0] > 0).astype(float) + (X[:, 1] > 0),
                   params={"device_type": "cpu"}), 3)
    # every leaf of the first tree: any probe row reaches one
    poisoned = re.sub(r"leaf_value=[^\n]*",
                      lambda m: "leaf_value=" + " ".join(
                          ["inf"] * len(m.group(0).split())),
                      model.model_to_string(), count=1)
    fe = ServeFrontend(model, flush_ms=2.0)
    try:
        baseline = fe.predict(X[:40])
        deg_before = len(tdist.degradations())
        bad = tmp_path / "corrupt.txt"
        bad.write_text("tree\nversion=v3\nTree=0\ngarbage")
        with pytest.raises(ServeSwapError):
            fe.swap("default", str(bad))
        with pytest.raises(ServeSwapError, match="failed to predict"):
            fe.swap("default", narrow)
        with pytest.raises(ServeSwapError, match="arity"):
            fe.swap("default", multi)
        with pytest.raises(ServeSwapError, match="non-finite"):
            fe.swap("default", lt.Booster(model_str=poisoned))
        assert fe.version() == 1
        assert np.array_equal(fe.predict(X[:40]), baseline)
        rejects = [d for d in tdist.degradations()[deg_before:]
                   if d["kind"] == "serve_swap_rejected"]
        assert len(rejects) == 4
    finally:
        fe.close()


def test_inflight_requests_complete_on_admitted_version(model, data,
                                                        monkeypatch):
    X, y = data
    fe = ServeFrontend(model, flush_ms=2.0)
    try:
        fe.predict(X[:12])
        new = _train(X, y, learning_rate=0.2)
        new.predict(X[:12])
        monkeypatch.setenv(SLOW_ENV, "400")
        res = {}
        t = threading.Thread(
            target=lambda: res.update(r1=fe.predict(X[:12])))
        t.start()
        time.sleep(0.15)
        monkeypatch.delenv(SLOW_ENV)
        fe.swap("default", new)
        t.join(timeout=30)
        model._boosting.enable_serve_mode(False)
        assert np.array_equal(res["r1"], model.predict(X[:12]))
        assert np.array_equal(fe.predict(X[:12]), new.predict(X[:12]))
    finally:
        fe.close()


def test_swap_same_shape_builds_its_own_slots(data):
    """Two versions of one ensemble shape: after the swap the new
    version's engine serves through slots of its own, and the old
    booster's slots are released."""
    X, y = data
    a = _train(X, y, seed=21, max_depth=2)
    b = _train(X, y, seed=22, max_depth=2)
    fe = ServeFrontend(a, flush_ms=2.0)
    try:
        fe.predict(X[:33])
        ea = a._boosting._predict_engine()
        assert list(ea._serve_slots) == [1024]
        fe.swap("default", b)
        out = fe.predict(X[:33])
        eb = b._boosting._predict_engine()
        assert list(eb._serve_slots) == [1024] and not ea._serve_slots
        b._boosting.enable_serve_mode(False)
        assert np.array_equal(out, b.predict(X[:33]))
    finally:
        fe.close()


# ------------------------------------------------- engine thread safety
def test_concurrent_first_call_builds_once(data):
    """Four threads first-touch one booster in serve mode together: one
    engine, one slot, the same answers."""
    X, y = data
    booster = _train(X, y, seed=31, num_leaves=6, nround=7)
    booster._boosting.enable_serve_mode(True)
    barrier = threading.Barrier(4)
    errs, outs = [], [None] * 4

    def go(i):
        try:
            barrier.wait(timeout=10)
            outs[i] = booster.predict(X[:61], raw_score=True)
        except BaseException as e:       # noqa: BLE001 -- reported
            errs.append(e)

    ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errs, errs
    g = booster._boosting
    assert len(g._engine_cache) == 1
    assert list(g._predict_engine()._serve_slots) == [1024]
    for o in outs[1:]:
        assert np.array_equal(outs[0], o)


# --------------------------------------------------------- serve-time OOM
def test_serve_oom_rides_predict_chunk_ladder(data, monkeypatch):
    X, y = data
    booster = _train(X, y, seed=41)
    fe = ServeFrontend(booster, flush_ms=2.0)
    try:
        fe.predict(X[:25])
        deg_before = len(tdist.degradations())
        monkeypatch.setenv(OOM_ENV, "1")
        out = fe.predict(X[:25])
        monkeypatch.delenv(OOM_ENV)
        booster._boosting.enable_serve_mode(False)
        assert np.array_equal(out, booster.predict(X[:25]))
        ooms = [d for d in tdist.degradations()[deg_before:]
                if d["kind"] == "oom_predict"]
        assert len(ooms) == 1
        g = booster._boosting
        assert g._oom_level == 0 and g._oom_predict_chunk > 0
    finally:
        fe.close()


def test_file_loaded_model_oom_rides_ladder(model, data, tmp_path,
                                            monkeypatch):
    X, _ = data
    path = tmp_path / "m.txt"
    model.save_model(str(path))
    fe = ServeFrontend(model, flush_ms=2.0)
    try:
        fe.swap("default", str(path))
        loaded = lt.Booster(model_file=str(path))
        fe.predict(X[:25])
        deg_before = len(tdist.degradations())
        monkeypatch.setenv(OOM_ENV, "1")
        out = fe.predict(X[:25])
        monkeypatch.delenv(OOM_ENV)
        assert np.array_equal(out, loaded.predict(X[:25]))
        ooms = [d for d in tdist.degradations()[deg_before:]
                if d["kind"] == "oom_predict"]
        assert len(ooms) == 1
    finally:
        fe.close()


# ------------------------------------------------------------ lifecycle
def test_health_gauges_and_stats(frontend, jax_model, data):
    X, _ = data
    for n in (5, 30):
        frontend.predict(X[:n])
    serve = tdist.health_snapshot().get("serve", {})
    for k in ("serve_requests", "serve_batches", "serve_p50_ms",
              "serve_p99_ms", "serve_queue_rows", "serve_inflight_rows"):
        assert k in serve, k
    st = frontend.stats()
    assert st["requests"] >= 2 and st["p50_ms"] > 0
    assert st["queued_rows"] == 0 and st["inflight_rows"] == 0
    jfe = jserving.ServeFrontend(jax_model, flush_ms=5.0)
    try:
        jfe.predict(X[:5])
        assert set(st) == set(jfe.stats())
    finally:
        jfe.close()


def test_close_releases_serve_resources(model, data):
    X, _ = data
    fe = ServeFrontend(model, flush_ms=2.0)
    fe.predict(X[:40])
    eng = model._boosting._predict_engine()
    assert eng.serve_mode and eng._serve_slots
    fe.close()
    assert not eng.serve_mode and not eng._serve_slots
    assert np.array_equal(model.predict(X[:40]), model.predict(X[:40]))


def test_unknown_model_and_closed_frontend(model, jax_model, data):
    X, _ = data
    msgs = []
    for fe in (ServeFrontend(model, flush_ms=2.0),
               jserving.ServeFrontend(jax_model, flush_ms=2.0)):
        got = []
        with pytest.raises(KeyError, match="unknown model") as e1:
            fe.predict(X[:3], model="nope")
        with pytest.raises(KeyError, match="unknown model") as e2:
            fe.swap("nope", model)
        fe.close()
        with pytest.raises(RuntimeError, match="closed") as e3:
            fe.predict(X[:3])
        got = [str(e.value) for e in (e1, e2, e3)]
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_config_params_steer_policy(data):
    X, y = data
    b = _train(X, y, nround=2, serve_flush_ms=7.0, serve_max_batch_rows=123,
               serve_max_queue_rows=456, serve_deadline_ms=0.0)
    fe = ServeFrontend(b)
    try:
        assert fe.flush_s == pytest.approx(0.007)
        assert fe.max_batch_rows == 123 and fe.max_queue_rows == 456
        assert fe.default_deadline_ms == 0.0
        assert not fe.metrics_enabled and fe.metrics_host == "127.0.0.1"
    finally:
        fe.close()


def test_two_models_served_independently(model, data):
    X, y = data
    other = _train(X, y, seed=77, nround=3)
    fe = ServeFrontend(model, flush_ms=2.0)
    try:
        fe.register("other", other)
        assert np.array_equal(fe.predict(X[:20], model="other"),
                              other.predict(X[:20]))
        assert np.array_equal(fe.predict(X[:20]), model.predict(X[:20]))
        assert fe.stats()["models"] == {"default": 1, "other": 1}
    finally:
        fe.close()
