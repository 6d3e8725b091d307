"""The port's gang post-mortem (``lightgbm_tpu_torch/postmortem.py``)
against the JAX package's, on the CPU.

Each fault class of ``tests/test_postmortem.py`` (kill, hang, divergence,
NaN, OOM exhaustion) leaves its artifacts in a directory: the port's
training writes them (its flight recorder, its watchdog, the same
diagnosis shapes), and the JAX package's writes the in-process ones too.
On every such directory both analyzers run and must agree: the verdict,
the rank, the iteration, and ``render()`` with the paths masked. The
analyzer's unit cases (empty directory, timeline order, monotonic
stamps, incarnation-suffixed rings, the report round trip) run on both
packages as parametrised cases. One supervised gang of 2 processes
(``run_supervised``, rank 1 killed at iteration 2, no restart budget)
raises ``GangFailedError`` carrying the report the supervisor wrote,
classified ``kill`` on rank 1 at iteration 2 by both analyzers, and its
flight recorders are on disk.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
import torch_supervised_cases as sc
from lightgbm_tpu import distributed as jdist
from lightgbm_tpu import postmortem as jpm
from lightgbm_tpu import telemetry as jtele
from lightgbm_tpu.utils import faults as jfaults
from lightgbm_tpu.utils.log import LightGBMError as JLightGBMError
from lightgbm_tpu_torch import distributed as tdist
from lightgbm_tpu_torch import postmortem as tpm
from lightgbm_tpu_torch import supervisor
from lightgbm_tpu_torch import telemetry as ttele
from lightgbm_tpu_torch.utils import faults as tfaults
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 20}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(os.environ):
        if name.startswith("LGBM_TPU_FAULT_"):
            monkeypatch.delenv(name)
    yield


def _data(n=2000, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _train(lib, params=None, rounds=6):
    X, y = _data()
    p = dict(BASE, **(params or {}))
    if lib is lt:
        p["device_type"] = "cpu"
    return lib.train(p, lib.Dataset(X, label=y, params=dict(p)), rounds)


def _masked(text: str, *dirs) -> str:
    for d in dirs:
        text = text.replace(str(d), "<dir>")
    return re.sub(r"/tmp/[^\s'\")]+", "<tmp>", text)


def _agree(d, failures=None, checkpoint_dir=None):
    """Both analyzers on one artifact directory: the same verdict, rank,
    iteration, evidence and rendering (paths masked). Returns the
    port's."""
    ours = tpm.analyze(d, checkpoint_dir=checkpoint_dir, failures=failures)
    ref = jpm.analyze(d, checkpoint_dir=checkpoint_dir, failures=failures)
    assert (ours.verdict, ours.rank, ours.iteration) == \
        (ref.verdict, ref.rank, ref.iteration)
    assert ours.evidence == ref.evidence
    assert ours.memory == ref.memory
    assert _masked(ours.render(), d) == _masked(ref.render(), d)
    return ours


# ---------------------------------------------- fault-class verdicts
def test_classify_kill_rank(tmp_path):
    """A rank hard-killed at iteration 3 (``fault_kill_rank_at_iter``,
    os._exit(137) in a child process) flushes its ring first; the JSONL
    validates under both packages' schema, and both analyzers classify
    ``kill`` on rank 0 at iteration 3, with the host memory trend."""
    d = str(tmp_path / "tele")
    code = (
        "import numpy as np, torch, lightgbm_tpu_torch as lgb\n"
        "torch.set_num_threads(1)\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.normal(size=(2000, 8)).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(np.float32)\n"
        "p = {'objective': 'binary', 'num_leaves': 15, 'verbosity': -1,\n"
        "     'device_type': 'cpu', 'telemetry_dir': %r,\n"
        "     'fault_kill_rank_at_iter': '0:3'}\n"
        "lgb.train(p, lgb.Dataset(X, label=y, params=dict(p)), 10)\n" % d)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 137, r.stderr[-2000:]
    path = os.path.join(d, "flight_rank0.jsonl")
    for tele in (ttele, jtele):
        recs, errors = tele.validate_flight_jsonl(path)
        assert errors == []
    assert "at iteration 3" in recs[-1]["reason"]
    failures = [{"incarnation": 0, "failed_ranks": [0],
                 "exit_codes": {0: 137}, "reason": "rank 0 exit 137",
                 "watchdog": []}]
    pm = _agree(d, failures=failures)
    assert (pm.verdict, pm.rank, pm.iteration) == ("kill", 0, 3)
    assert any("fault-kill" in e for e in pm.evidence)
    assert pm.memory and "rss" in pm.memory


def test_classify_hang_rank(tmp_path, monkeypatch):
    """The rank-targeted hang stalls the loop; the watchdog fires, flushes
    the ring into its diagnosis and raises; both analyzers say ``hang``
    on rank 0."""
    d = str(tmp_path / "diag")
    monkeypatch.setenv(tdist._DIAG_DIR_ENV, d)
    with pytest.raises(tdist.DistributedTimeoutError):
        _train(lt, {"collective_deadline": 2.0,
                    "fault_hang_rank_at_iter": "0:2"})
    with open(os.path.join(d, "watchdog_rank0.json")) as fh:
        diag = json.load(fh)
    assert diag["t"] > 0 and diag["t_mono"] > 0
    assert diag["kind"] == "watchdog"
    assert diag["flight_recorder"] == os.path.join(d, "flight_rank0.jsonl")
    pm = _agree(d)
    assert (pm.verdict, pm.rank) == ("hang", 0)
    assert any("watchdog" in e for e in pm.evidence)


def test_classify_flip_score_divergence(tmp_path):
    """The harness's one-bit score flip drives the port's fingerprint
    vote (rank 1 of 3 corrupt); the verdict written in
    ``check_model_integrity``'s diagnosis shape is ``divergence`` on rank
    1 at iteration 2 for both analyzers."""
    booster = _train(lt, rounds=3)
    boosting = booster._boosting
    fp_good = tdist.model_fingerprint(boosting)
    plan = tfaults.FaultPlan(flip_score_rank=(0, 2))
    boosting.train_score = tfaults.maybe_flip_score(plan, 2,
                                                    boosting.train_score)
    fp_bad = tdist.model_fingerprint(boosting)
    assert fp_bad["score"] != fp_good["score"]
    entries = [dict(fp_good, rank=0), dict(fp_bad, rank=1),
               dict(fp_good, rank=2)]
    corrupt, indeterminate = tdist.divergence_verdict(entries)
    assert (corrupt, indeterminate) == ([1], False)
    d = str(tmp_path / "diag")
    os.makedirs(d)
    table = {str(e["rank"]): {"trees": e["trees"][:16],
                              "score": e["score"][:16]} for e in entries}
    with open(os.path.join(d, "divergence_rank1.json"), "w") as fh:
        json.dump({"rank": 1, "iteration": 2, "corrupt_ranks": corrupt,
                   "fingerprints": table, "kind": "divergence",
                   "t": time.time(), "t_mono": time.monotonic()}, fh)
    pm = _agree(d)
    assert (pm.verdict, pm.rank, pm.iteration) == ("divergence", 1, 2)
    assert any("corrupt_ranks=[1]" in e for e in pm.evidence)


@pytest.mark.parametrize("lib", [lt, lj], ids=["torch", "jax"])
def test_classify_nan_hist(tmp_path, lib):
    """check_numerics with the NaN injection at iteration 2: the
    train-error flush names it, and both analyzers say ``nan`` on rank 0
    at iteration 2, on the port's artifacts and on the JAX package's."""
    err = LightGBMError if lib is lt else JLightGBMError
    with pytest.raises(err, match="iteration 2"):
        _train(lib, {"check_numerics": True, "fault_nan_hist_at_iter": 2,
                     "telemetry_dir": str(tmp_path / "tele")})
    pm = _agree(str(tmp_path / "tele"))
    assert (pm.verdict, pm.rank, pm.iteration) == ("nan", 0, 2)
    assert any("sentinel" in e or "non-finite" in e for e in pm.evidence)


@pytest.mark.parametrize("lib", [lt, lj], ids=["torch", "jax"])
def test_classify_oom_exhaustion(tmp_path, lib):
    """Spending the OOM ladder at iteration 2 flushes ``oom-exhausted``
    with the rungs [1, 2, 3] in its health, each with the memory sample
    and the predicted bytes; both analyzers say ``oom`` on rank 0 at
    iteration 2 with the rung evidence and a memory trend."""
    d = str(tmp_path / "tele")
    exc = tfaults.SimulatedResourceExhausted if lib is lt \
        else jfaults.SimulatedResourceExhausted
    with pytest.raises(exc):
        _train(lib, {"telemetry_dir": d, "fault_oom_at_iter": 2,
                     "fault_oom_count": 4})
    tele = ttele if lib is lt else jtele
    recs, errors = tele.validate_flight_jsonl(tele.recorder().path())
    assert errors == []
    flush = next(r for r in recs if r["type"] == "flush"
                 and r["reason"].startswith("oom-exhausted"))
    degr = flush["health"].get("degradations") or []
    assert [x["level"] for x in degr if x["kind"] == "oom"] == [1, 2, 3]
    for x in degr:
        assert "host_rss_bytes" in x["memory"]
        assert x["memory"]["hbm_bytes_in_use"] is None      # the CPU
        assert x["predicted_hist_bytes"] > 0
        assert x["t_mono"] > 0
    pm = _agree(d)
    assert (pm.verdict, pm.rank, pm.iteration) == ("oom", 0, 2)
    assert any("predicted" in e for e in pm.evidence)
    assert any("rung" in e for e in pm.evidence)
    assert pm.memory and pm.memory["rss"]["samples"] >= 1


def test_gang_kill_postmortem(tmp_path):
    """A supervised gang of 2 (``run_supervised`` over the CPU) whose rank
    1 is killed at iteration 2, with no restart budget: GangFailedError
    carries the report the supervisor wrote beside the ranks' flight
    recorders, ``kill`` on rank 1 at iteration 2, and the JAX analyzer
    reads the same directory to the same verdict."""
    ck = str(tmp_path / "ck")
    os.environ["LGBM_TPU_FAULT_KILL_RANK_AT_ITER"] = "1:2"
    try:
        with pytest.raises(supervisor.GangFailedError) as ei:
            supervisor.run_supervised(
                sc.gang_train, nproc=2, args=(ck,), device_type="cpu",
                checkpoint_dir=ck, max_restarts=0, timeout=120)
    finally:
        os.environ.pop("LGBM_TPU_FAULT_KILL_RANK_AT_ITER", None)
    err = ei.value
    assert err.postmortem and os.path.exists(err.postmortem)
    assert "Post-mortem report" in str(err)
    with open(err.postmortem) as fh:
        report = json.load(fh)
    assert (report["verdict"], report["rank"], report["iteration"]) == \
        ("kill", 1, 2)
    diag = os.path.dirname(err.postmortem)
    assert os.path.exists(os.path.join(diag, "flight_rank1.jsonl"))
    for path in err.failures[0].flight_recorders:
        assert os.path.exists(path)
    pm = _agree(diag, failures=err.failures, checkpoint_dir=ck)
    assert (pm.verdict, pm.rank, pm.iteration) == ("kill", 1, 2)


# ------------------------------------------------- analyzer unit tests
PM = [tpm, jpm]
PM_IDS = ["torch", "jax"]


@pytest.mark.parametrize("pm_mod", PM, ids=PM_IDS)
def test_analyze_empty_dir_is_unknown(tmp_path, pm_mod):
    pm = pm_mod.analyze(str(tmp_path))
    assert pm.verdict == "unknown" and pm.rank is None
    assert pm.render()
    assert tpm.VERDICTS == jpm.VERDICTS


@pytest.mark.parametrize("tele,dist", [(ttele, tdist), (jtele, jdist)],
                         ids=PM_IDS)
def test_timeline_orders_degradations_against_watchdog(tmp_path, tele,
                                                       dist):
    """A rung recorded before a watchdog fire sorts before it on the
    timeline (wall and monotonic stamps on both); each package's
    artifacts read the same under both analyzers."""
    d = str(tmp_path)
    rec = tele.FlightRecorder(capacity=8, directory=d, rank=0)
    dist.reset_degradations()
    e1 = dist.record_degradation({"kind": "oom", "level": 1,
                                  "action": "feature_block -> 256"})
    assert e1["t"] > 0 and e1["t_mono"] > 0 and "iteration" in e1
    rec.record(iteration=0, wall_s=0.1)
    rec.flush("test-event")
    time.sleep(0.01)
    with open(os.path.join(d, "watchdog_rank0.json"), "w") as fh:
        json.dump({"rank": 0, "iteration": 1, "phase": "step:1",
                   "elapsed": 9.9, "deadline": 5.0, "suspects": [0],
                   "kind": "watchdog", "t": time.time(),
                   "t_mono": time.monotonic()}, fh)
    dist.reset_degradations()
    pm = _agree(d)
    kinds = [e["kind"] for e in pm.timeline if e["t"] is not None]
    assert kinds.index("degradation") < kinds.index("watchdog")


@pytest.mark.parametrize("dist", [tdist, jdist], ids=PM_IDS)
def test_monotonic_orders_degradations(dist):
    dist.reset_degradations()
    a = dist.record_degradation({"kind": "oom", "level": 1, "action": "a"})
    b = dist.record_degradation({"kind": "oom", "level": 2, "action": "b"})
    assert b["t_mono"] > a["t_mono"]
    assert b["seq"] == a["seq"] + 1
    dist.reset_degradations()


@pytest.mark.parametrize("tele", [ttele, jtele], ids=PM_IDS)
def test_incarnation_suffixed_flights_both_gathered(tmp_path, tele):
    """A relaunch's ``flight_rank0.r1.jsonl`` beside the dead
    incarnation's ring: both analyzers read both, newest last."""
    d = str(tmp_path)
    for inc in (0, 1):
        rec = tele.FlightRecorder(capacity=4, directory=d, rank=0,
                                  incarnation=inc)
        rec.record(iteration=inc * 10, wall_s=0.1)
        rec.flush("train-end")
    for pm_mod in PM:
        flights = pm_mod.gather_flights([d])
        assert [(f.rank, f.incarnation) for f in flights] == \
            [(0, 0), (0, 1)]


@pytest.mark.parametrize("pm_mod", PM, ids=PM_IDS)
def test_write_report_roundtrip(tmp_path, pm_mod):
    pm = pm_mod.analyze(str(tmp_path))
    path = pm_mod.write_report(pm, str(tmp_path / "out"))
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["verdict"] == "unknown"
    assert sorted(doc) == sorted(jpm.analyze(str(tmp_path)).to_json())
    assert os.path.exists(os.path.join(str(tmp_path / "out"),
                                       pm_mod.REPORT_TEXT))


def test_cli_expect_and_json(tmp_path):
    """``python -m lightgbm_tpu_torch.scripts.postmortem``: the report on
    stdout, the JSON beside it, ``--expect`` gating the exit code, 2 for
    a directory with no artifacts."""
    d = str(tmp_path / "diag")
    os.makedirs(d)
    with open(os.path.join(d, "divergence_rank1.json"), "w") as fh:
        json.dump({"rank": 1, "iteration": 2, "corrupt_ranks": [1],
                   "kind": "divergence", "t": time.time(),
                   "t_mono": time.monotonic()}, fh)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(tmp_path / "pm.json")
    base = [sys.executable, "-m", "lightgbm_tpu_torch.scripts.postmortem"]
    r = subprocess.run(base + [d, "--json", out, "--expect", "divergence"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "VERDICT: DIVERGENCE  (rank 1, iteration 2)" in r.stdout
    with open(out) as fh:
        assert json.load(fh)["verdict"] == "divergence"
    r = subprocess.run(base + [d, "--expect", "kill"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    r = subprocess.run(base + [str(tmp_path / "none")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2
