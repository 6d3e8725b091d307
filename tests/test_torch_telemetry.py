"""The port's telemetry (``lightgbm_tpu_torch/telemetry.py``,
``utils/profiling.py``) against the JAX package's, on the CPU.

- The snapshot: the JAX package's schema version and key sets (the
  dispatch and memory planes' keys too); ``prometheus_text`` of the same
  gauges, scopes, counters and dispatch counts is the JAX package's line
  for line; ``gang_snapshot`` in a gang of one and over a thread gang of
  2.
- The flight recorder: it rides training (a bounded ring, the context
  header, the train-end flush, the path in ``health_snapshot()``), is off
  by parameter, leaves no file without a directory; the NaN and OOM
  error flushes; the cumulative and periodic flush rules; schema
  validation both ways (each package's ``validate_flight_jsonl`` accepts
  the other's JSONL from the same training, and both reject a bad one).
- Memory: null device fields on the CPU, host RSS real, in every record,
  the gauges and the exposition; off by parameter; a failing allocator
  query gives nulls; the per-phase watermarks under profiling; the OOM
  rungs' memory evidence.
- The overhead contract: recorder-on training is bitwise recorder-off
  training, with equal dispatch-hook counts.
- ``trace_window`` writes a Chrome trace that names the grower's scopes;
  a bad directory is an error recorded, never raised.
- The profiling tables are thread-safe; ``reset`` leaves the dispatch
  counters; the serve metrics endpoint.
"""

import itertools
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import distributed as jdist
from lightgbm_tpu import telemetry as jtele
from lightgbm_tpu.utils import profiling as jprof
from lightgbm_tpu_torch import distributed as tdist
from lightgbm_tpu_torch import network
from lightgbm_tpu_torch import telemetry as ttele
from lightgbm_tpu_torch.utils import faults as tfaults
from lightgbm_tpu_torch.utils import profiling as tprof
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 20}
TELE = [ttele, jtele]
IDS = ["torch", "jax"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(os.environ):
        if name.startswith("LGBM_TPU_FAULT_"):
            monkeypatch.delenv(name)
    yield
    tprof.enable(False)


def _data(n=3000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _train(params=None, rounds=6, lib=lt):
    X, y = _data()
    p = dict(BASE, **(params or {}))
    if lib is lt:
        p["device_type"] = "cpu"
    return lib.train(p, lib.Dataset(X, label=y, params=dict(p)), rounds)


# ------------------------------------------------------------- snapshot
def test_snapshot_schema_matches_jax():
    ours, ref = ttele.snapshot(), jtele.snapshot()
    assert ttele.SCHEMA_VERSION == jtele.SCHEMA_VERSION == ours["schema"]
    assert set(ours) == set(ref)
    assert set(ours["dispatch"]) == set(ref["dispatch"]) == {
        "dispatches", "device_gets", "d2h_bytes", "h2d_bytes"}
    assert set(ours["memory"]) == set(ref["memory"])
    assert {"restart_count", "last_iteration", "in_step_iteration"} \
        <= set(ours["health"]) & set(ref["health"])
    assert ttele.FLIGHT_RECORD_FIELDS == jtele.FLIGHT_RECORD_FIELDS
    assert ttele.construct_snapshot() == {}


def test_prometheus_text_matches_jax_line_for_line():
    """The same gauges (a counter past 1e6 at full precision), scopes,
    counters and dispatch counts in both packages' tables render to the
    same text."""
    for prof in (tprof, jprof):
        prof.reset()
        prof.reset_dispatch()
        prof.set_gauge("serve_p99_ms", 12.5)
        prof.set_gauge("serve_p50_ms", 3.25)
        prof.set_gauge("serve_requests", 1234567.0)
        with prof._lock:
            prof._acc["hist_pass"] += 1.25
            prof._cnt["hist_pass"] += 4
            prof._counters["hist_rows_streamed"] += 5072.0
            prof._counter_cnt["hist_rows_streamed"] += 1
    try:
        ref = jtele.snapshot()
        ours = ttele.snapshot()
        ours["health"] = ref["health"]
        text, want = ttele.prometheus_text(ours), jtele.prometheus_text(ref)
    finally:
        tprof.reset()
        jprof.reset()
    assert text.splitlines() == want.splitlines()
    assert "lightgbm_tpu_serve_p99_ms 12.5" in text
    assert "lightgbm_tpu_serve_requests 1234567" in text
    assert 'lightgbm_tpu_scope_calls_total{scope="hist_pass"} 4' in text
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name, _, value = line.rpartition(" ")
        assert name.startswith("lightgbm_tpu_"), line
        float(value)


def test_gang_snapshot_single_process_and_thread_gang():
    out = ttele.gang_snapshot("test_single")
    assert len(out) == 1 and out[0]["schema"] == ttele.SCHEMA_VERSION

    def rank_fn(net):
        return [s["schema"] for s in ttele.gang_snapshot("tele_gang")]

    assert network.thread_gang(2, rank_fn) == [[ttele.SCHEMA_VERSION] * 2] * 2


# ------------------------------------------------------- flight recorder
def test_recorder_rides_training_and_flushes(tmp_path):
    d = str(tmp_path / "tele")
    _train({"telemetry_dir": d, "telemetry_ring_size": 4}, rounds=7)
    rec = ttele.recorder()
    records = rec.records()
    assert len(records) == 4 and records[-1]["iteration"] == 6
    assert all(r["completed"] for r in records)
    assert rec.has_context
    path = os.path.join(d, "flight_rank0.jsonl")
    recs, errors = ttele.validate_flight_jsonl(path)
    assert errors == []
    assert recs[0]["type"] == "run" and recs[0]["context"]["backend"] == "cpu"
    assert recs[-1]["type"] == "flush" and recs[-1]["reason"] == "train-end"
    assert tdist.health_snapshot().get("flight_recorder") == path


def test_recorder_disabled_by_param(tmp_path):
    _train({"telemetry_flight_recorder": False,
            "telemetry_dir": str(tmp_path)}, rounds=3)
    assert ttele.recorder() is None
    assert not os.path.exists(str(tmp_path / "flight_rank0.jsonl"))


def test_recorder_no_flush_without_dir():
    _train(rounds=3)
    rec = ttele.recorder()
    assert rec is not None and len(rec.records()) == 3
    assert rec.path() is None


def test_jsonl_validates_across_packages(tmp_path):
    """The same training in both packages: each JSONL is accepted by both
    validators, with the same record types in the same order."""
    types = {}
    for lib, tele in ((lt, ttele), (lj, jtele)):
        d = str(tmp_path / tele.__name__)
        _train({"telemetry_dir": d}, rounds=4, lib=lib)
        path = os.path.join(d, "flight_rank0.jsonl")
        for validator in TELE:
            recs, errors = validator.validate_flight_jsonl(path)
            assert errors == [], (tele.__name__, validator.__name__)
        types[lib] = [r["type"] for r in recs]
        assert [r["iteration"] for r in recs if r["type"] == "iter"] == \
            [0, 1, 2, 3]
    assert types[lt] == types[lj]


def test_nan_grad_error_flush_names_iteration():
    """check_numerics fails at iteration 2: the train-error flush lands
    (a temp dir, none configured) and names it."""
    with pytest.raises(LightGBMError, match="iteration 2"):
        _train({"check_numerics": True, "fault_nan_grad_at_iter": 2})
    path = ttele.recorder().path()
    assert path is not None and os.path.exists(path)
    recs, errors = ttele.validate_flight_jsonl(path)
    assert errors == []
    reasons = [r["reason"] for r in recs if r["type"] == "flush"]
    assert any("train-error" in r and "iteration 2" in r for r in reasons)


@pytest.mark.parametrize("tele", TELE, ids=IDS)
def test_sentinel_verdict_backfills_record(tele):
    rec = tele.FlightRecorder(capacity=8)
    rec.record(iteration=0, sentinel="pending")
    rec.record(iteration=1, iters=2, sentinel="pending")
    rec.note_sentinel(2, 0b100)
    rec.note_sentinel(0, 0)
    assert [r["sentinel"] for r in rec.records()] == ["ok", "flags=0b00100"]


def test_check_numerics_records_sentinel_ok():
    _train({"check_numerics": True}, rounds=3)
    assert all(r["sentinel"] == "ok" for r in ttele.recorder().records())


@pytest.mark.parametrize("tele", TELE, ids=IDS)
def test_flush_is_idempotent_and_cumulative(tmp_path, tele):
    rec = tele.FlightRecorder(capacity=8, directory=str(tmp_path), rank=0)
    rec.record(iteration=0, wall_s=0.1)
    p1 = rec.flush("first-event")
    rec.record(iteration=1, wall_s=0.1)
    p2 = rec.flush("second-event")
    assert p1 == p2
    recs, errors = tele.validate_flight_jsonl(p2)
    assert errors == []
    assert [r["reason"] for r in recs if r["type"] == "flush"] == \
        ["first-event", "second-event"]
    p3 = rec.flush("periodic", retain_event=False)
    recs, _ = tele.validate_flight_jsonl(p3)
    assert [r["reason"] for r in recs if r["type"] == "flush"] == \
        ["first-event", "second-event", "periodic"]
    p4 = rec.flush("third-event")
    recs, _ = tele.validate_flight_jsonl(p4)
    assert [r["reason"] for r in recs if r["type"] == "flush"] == \
        ["first-event", "second-event", "third-event"]


@pytest.mark.parametrize("tele", TELE, ids=IDS)
def test_periodic_flush_cadence(tmp_path, tele):
    rec = tele.FlightRecorder(capacity=8, directory=str(tmp_path), rank=0,
                              flush_period=4)
    rec.record(iteration=0, wall_s=0.0)
    assert not os.path.exists(rec.path())
    for i in range(1, 4):
        rec.record(iteration=i, wall_s=0.0)
    assert not os.path.exists(rec.path())
    rec.record(iteration=4, wall_s=0.0)
    recs, errors = tele.validate_flight_jsonl(rec.path())
    assert errors == []
    assert [r["reason"] for r in recs if r["type"] == "flush"] == \
        ["periodic"]


@pytest.mark.parametrize("tele", TELE, ids=IDS)
def test_validate_rejects_bad_jsonl(tmp_path, tele):
    p = str(tmp_path / "bad.jsonl")
    with open(p, "w") as fh:
        fh.write('{"type": "iter", "iteration": 0}\nnot json\n')
    recs, errors = tele.validate_flight_jsonl(p)
    assert any("unparseable" in e for e in errors)
    assert any("run" in e for e in errors)
    assert errors == (jtele.validate_flight_jsonl(p)[1])


# ------------------------------------------------------ memory telemetry
def test_snapshot_has_memory_plane():
    mem = ttele.snapshot()["memory"]
    assert mem["hbm_bytes_in_use"] is None and mem["hbm_peak_bytes"] is None
    assert isinstance(mem["host_rss_bytes"], int)
    assert mem["host_rss_peak_bytes"] >= mem["host_rss_bytes"] > 0


def test_recorder_records_memory_fields(tmp_path):
    _train({"telemetry_dir": str(tmp_path / "t")}, rounds=3)
    for r in ttele.recorder().records():
        assert r["mem"]["hbm_bytes_in_use"] is None
        assert r["mem"]["hbm_peak_bytes"] is None
        assert r["mem"]["host_rss_bytes"] > 0
    health = tdist.health_snapshot()
    assert health["memory"]["host_rss_peak_bytes"] \
        >= health["memory"]["host_rss_bytes"] > 0
    text = ttele.prometheus_text()
    assert "lightgbm_tpu_host_rss_bytes" in text
    assert "lightgbm_tpu_hbm_bytes_in_use" not in text


def test_memory_off_by_param(tmp_path):
    _train({"telemetry_memory": False, "telemetry_dir": str(tmp_path)},
           rounds=3)
    assert all("mem" not in r for r in ttele.recorder().records())


def test_memory_stats_failure_forces_none_path(monkeypatch, tmp_path):
    """An allocator query that raises gives null device fields, and a
    recorder-on training run goes through."""
    def boom(*a, **k):
        raise RuntimeError("memory_stats unavailable")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    sample = tprof.sample_memory()
    assert sample["hbm_bytes_in_use"] is None
    assert sample["host_rss_bytes"] > 0
    monkeypatch.undo()
    _train({"telemetry_dir": str(tmp_path)}, rounds=2)


@pytest.mark.parametrize("prof", [tprof, jprof], ids=IDS)
def test_phase_hbm_watermarks_under_timetag(monkeypatch, prof):
    """The per-scope peak of the samples at scope exits (a stub allocator
    giving 100, 400, 200) is kept, shows in the snapshot, and goes with
    ``reset``."""
    seq = itertools.chain([100, 400], itertools.repeat(200))
    monkeypatch.setattr(prof, "device_memory", lambda: {
        "bytes_in_use": 50, "peak_bytes_in_use": next(seq)})
    prof.reset()
    prof.enable(True)
    try:
        for _ in range(3):
            with prof.timer("pm_test_phase"):
                pass
        assert prof.memory_watermarks()["pm_test_phase"] == 400
        tele = ttele if prof is tprof else jtele
        assert tele.snapshot()["memory"]["phase_hbm_peak"][
            "pm_test_phase"] == 400
    finally:
        prof.enable(False)
        prof.reset()
    assert prof.memory_watermarks() == {}


def test_degradation_event_enrichment():
    with pytest.raises(tfaults.SimulatedResourceExhausted):
        _train({"fault_oom_at_iter": 1, "fault_oom_count": 4}, rounds=4)
    degr = [d for d in tdist.degradations() if d["kind"] == "oom"]
    assert [d["level"] for d in degr] == [1, 2, 3]
    for d in degr:
        assert d["iteration"] == 1 and d["t"] > 0 and d["t_mono"] > 0
        assert d["memory"]["host_rss_bytes"] > 0
        assert d["memory"]["hbm_bytes_in_use"] is None
        assert d["predicted_hist_bytes"] > 0
    assert degr[0]["t_mono"] <= degr[1]["t_mono"] <= degr[2]["t_mono"]


# -------------------------------------------------- overhead contract
def test_recorder_adds_zero_dispatches():
    """Recorder on and off: the same trees bit for bit, and the dispatch
    hook counts the same operations and copies over 4 iterations."""
    X, y = _data(n=4000)
    counts, texts = {}, {}
    for on in (False, True):
        p = dict(BASE, device_type="cpu", telemetry_flight_recorder=on)
        booster = lt.Booster(params=p, train_set=lt.Dataset(
            X, label=y, params=dict(p)))
        booster.update()
        assert tprof.install_dispatch_hook()
        try:
            with tprof.dispatch_scope() as d:
                for _ in range(4):
                    booster.update()
        finally:
            tprof.uninstall_dispatch_hook()
        counts[on] = dict(d)
        texts[on] = booster.model_to_string().split("\nparameters:")[0]
    assert counts[True] == counts[False]
    assert counts[True]["dispatches"] > 0
    assert texts[True] == texts[False]


def test_dispatch_hook_counts_copies():
    """A host-to-device copy and a fetch as the hook counts them (on the
    CPU both ends are the host: no transfer), and the kernel wrappers'
    launch reports."""
    tprof.reset_dispatch()
    assert tprof.install_dispatch_hook()
    try:
        x = torch.arange(8, dtype=torch.float32)
        y = (x * 2).sum()
        float(y)
        tprof.note_launch()
    finally:
        tprof.uninstall_dispatch_hook()
    st = tprof.dispatch_stats()
    assert st["dispatches"] >= 4
    assert st["device_gets"] == st["d2h_bytes"] == st["h2d_bytes"] == 0
    before = tprof.dispatch_stats()
    torch.ones(3).sum()
    tprof.note_launch()
    assert tprof.dispatch_stats() == before      # not installed: no count


# ------------------------------------------------------- trace capture
def test_trace_window_names_the_scopes(tmp_path):
    d = str(tmp_path / "trace")
    booster = _train(rounds=2)
    with ttele.trace_window(d, iters=2) as tw:
        booster.update()
        booster.update()
    assert tw.ok, tw.error
    assert tw.to_json()["iters"] == 2
    assert ttele.trace_files(d) == [tw.path]
    with open(tw.path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    for scope in ("gradients", "grow_tree", "hist_pass", "apply_split",
                  "score_update"):
        assert scope in names, scope


@pytest.mark.parametrize("tele", TELE, ids=IDS)
def test_trace_window_tolerates_bad_dir(tele):
    with tele.trace_window("/proc/definitely/not/writable") as tw:
        pass
    assert not tw.ok and tw.error


def test_profiling_scopes_ride_training(tmp_path):
    """With profiling on, training fills the JAX package's scope names
    (the unfused iteration's, the grower's phases, the construct) and its
    work counter, the flight records carry the phase deltas and the
    cumulative counters, and ``table`` prints them."""
    tprof.reset()
    tprof.enable(True)
    try:
        X, y = _data()
        p = dict(BASE, device_type="cpu", telemetry_dir=str(tmp_path))
        lt.train(p, lt.Dataset(X, label=y, params=dict(p)), 3)
        names = set(tprof.scopes())
        counters = tprof.counters()
        table = tprof.table()
    finally:
        tprof.enable(False)
        tprof.reset()
    assert {"construct", "gradients", "grow_tree", "hist_pass",
            "apply_split", "finalize_tree", "score_update"} <= names
    assert counters["hist_rows_streamed"] > 0
    assert counters["hist_coll_bytes"] == 0            # a gang of one
    assert "grow_tree" in table and "hist_rows_streamed" in table
    for rec in ttele.recorder().records():
        assert rec["phases"]["grow_tree"] > 0
        assert rec["rows_streamed"] > 0 and rec["coll_bytes"] == 0


# -------------------------------------------------- profiling satellites
@pytest.mark.parametrize("prof", [tprof, jprof], ids=IDS)
def test_profiling_counters_thread_safe(prof):
    prof.reset()
    prof.enable(True)
    try:
        def work():
            for _ in range(400):
                prof.counter("ts_test", 1.0)
                prof.inc_gauge("ts_gauge", 1.0)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert prof.counters()["ts_test"] == 8 * 400
        assert prof.gauges()["ts_gauge"] == 8 * 400
    finally:
        prof.enable(False)
        prof.reset()


def test_reset_leaves_dispatch_counters_and_table():
    tprof.reset_dispatch()
    tprof.install_dispatch_hook()
    try:
        torch.ones(2).sum()
    finally:
        tprof.uninstall_dispatch_hook()
    before = tprof.dispatch_stats()
    assert before["dispatches"] > 0
    tprof.reset()
    assert tprof.dispatch_stats() == before
    tprof.reset_dispatch()
    assert all(v == 0 for v in tprof.dispatch_stats().values())
    assert tprof.table() == "(no timer scopes recorded)"


def test_serve_metrics_endpoint():
    booster = _train(rounds=3)
    fe = lt.ServeFrontend(booster, metrics=True, metrics_port=0)
    try:
        addr = fe.metrics_addr
        assert addr is not None
        fe.predict(_data(n=8)[0])
        body = urllib.request.urlopen(f"http://{addr}/metrics",
                                      timeout=10).read().decode()
        assert "lightgbm_tpu_serve_p50_ms" in body
        assert "lightgbm_tpu_serve_requests 1" in body
        p99 = ttele._metric_value(fe.stats()["p99_ms"])
        assert f"lightgbm_tpu_serve_p99_ms {p99}" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{addr}/nope", timeout=10)
        assert "lightgbm_tpu_serve_requests" in fe.metrics_text()
    finally:
        fe.close()
    assert fe.metrics_addr is None
