"""The port's cross-rank integrity vote against the JAX package, on the CPU.

- ``divergence_verdict`` equals the JAX function on the world-3 score and
  tree minorities, the world-2 split (indeterminate), disjoint row ranges
  (no score vote; a tree mismatch still votes) and a clean gang;
  ``RankDivergenceError``'s message is the JAX package's.
- ``model_fingerprint`` of a CPU run equals the JAX package's on the same
  data and params (the same bytes and dtypes: int32 split features, int64
  threshold bins, float64 leaf values, the float32 score cache), and moves
  with the score's bits and with the trees.
- The score-flip fault moves one bit and undoes itself applied twice.
- ``notify_step_retry`` re-arms the step clock; the checkpoint callback
  votes before it saves unless the engine voted at that iteration.
- A gang of 3 thread-ranks on replicated rows with rank 1's score flipped
  after iteration 2: unsupervised, every rank raises naming rank 1.
- One supervised gang of 3 processes (replicated rows,
  ``integrity_check_period=1``, the flip "1:2"): rank 1 exits with the
  divergence code and its diagnosis, the supervisor charges it (no shrink
  within the budget), the honest majority's checkpoint restores the gang,
  and the text is the uninterrupted run's, the JAX data learner's on a
  3-device mesh.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import distributed as jd
from lightgbm_tpu_torch import distributed as td
from lightgbm_tpu_torch import network, supervisor
from lightgbm_tpu_torch.callback import CallbackEnv
from lightgbm_tpu_torch.utils import faults

sys.path.insert(0, os.path.dirname(__file__))
import torch_jax_mesh  # noqa: E402
import torch_supervised_cases as sc  # noqa: E402

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 8, "min_data_in_leaf": 5,
        "verbosity": -1}


def _data(n=400, f=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _fit(lib, params, rounds=6, n=400):
    X, y = _data(n)
    p = dict(BASE, **params)
    if lib is lt:
        p["device_type"] = "cpu"
    return lib.train(dict(p), lib.Dataset(X, label=y, params=dict(p)),
                     rounds)


# ================================================== the vote, unit layer
def _entry(rank, trees="T", score="S", row_start=0, row_count=100):
    return {"rank": rank, "trees": trees, "score": score,
            "row_start": row_start, "row_count": row_count}


VERDICT_CASES = {
    "world3_score_minority": [_entry(0), _entry(1, score="S'"), _entry(2)],
    "world3_tree_minority": [_entry(0, trees="T'"), _entry(1), _entry(2)],
    "world2_indeterminate": [_entry(0), _entry(1, score="S'")],
    "disjoint_rows": [_entry(0, score="A", row_start=0, row_count=50),
                      _entry(1, score="B", row_start=50, row_count=50),
                      _entry(2, score="C", row_start=100, row_count=50)],
    "disjoint_rows_tree_mismatch": [
        _entry(0, score="A", row_start=0, row_count=50),
        _entry(1, trees="T'", score="B", row_start=50, row_count=50),
        _entry(2, score="C", row_start=100, row_count=50)],
    "clean": [_entry(r) for r in range(4)],
    "two_groups_of_two": [_entry(0, row_start=0, row_count=10),
                          _entry(1, row_start=0, row_count=10),
                          _entry(2, score="X", row_start=10, row_count=10),
                          _entry(3, score="Y", row_start=10, row_count=10)],
}
VERDICTS = {"world3_score_minority": ([1], False),
            "world3_tree_minority": ([0], False),
            "world2_indeterminate": ([0, 1], True),
            "disjoint_rows": ([], False),
            "disjoint_rows_tree_mismatch": ([1], False),
            "clean": ([], False),
            "two_groups_of_two": ([2, 3], True)}


@pytest.mark.parametrize("name", sorted(VERDICT_CASES))
def test_divergence_verdict_matches_jax(name):
    entries = VERDICT_CASES[name]
    got = td.divergence_verdict(entries)
    assert got == jd.divergence_verdict(entries)
    assert got == VERDICTS[name]


@pytest.mark.parametrize("indeterminate", [False, True])
def test_divergence_error_message_matches_jax(indeterminate):
    args = (4, [1], {"0": {"trees": "a", "score": "b"}})
    t = td.RankDivergenceError(*args, indeterminate=indeterminate)
    j = jd.RankDivergenceError(*args, indeterminate=indeterminate)
    assert str(t) == str(j)
    assert (t.iteration, t.corrupt_ranks, t.indeterminate) == \
        (j.iteration, j.corrupt_ranks, j.indeterminate)


# ===================================================== the fingerprint
@pytest.mark.parametrize("params", [{}, {"objective": "regression"},
                                    {"bagging_fraction": 0.7,
                                     "bagging_freq": 1}],
                         ids=["binary", "regression", "bagging"])
def test_model_fingerprint_matches_jax(params):
    """The same run in both packages (texts equal) fingerprints to the
    same hashes: the trees' bytes and the score cache's float32 bits."""
    bt, bj = _fit(lt, params), _fit(lj, params)
    assert bt.model_to_string() == bj.model_to_string()
    ft = td.model_fingerprint(bt._boosting)
    fj = jd.model_fingerprint(bj._boosting)
    assert ft == fj
    assert ft["row_count"] == 400 and ft["row_start"] == 0


def test_model_fingerprint_moves_with_state():
    b = _fit(lt, {}, rounds=2, n=200)
    fp1 = td.model_fingerprint(b._boosting)
    arr = b._boosting.train_score.numpy().copy()
    arr.reshape(-1).view(np.uint32)[0] ^= 1
    b._boosting.train_score = torch.from_numpy(arr)
    fp2 = td.model_fingerprint(b._boosting)
    assert fp1["score"] != fp2["score"] and fp1["trees"] == fp2["trees"]
    b2 = _fit(lt, {}, rounds=3, n=200)
    assert td.model_fingerprint(b2._boosting)["trees"] != fp1["trees"]


def test_flip_score_fault_is_one_bit_involution():
    plan = faults.FaultPlan(flip_score_rank=(0, 3))
    s = torch.arange(8, dtype=torch.float32)
    assert faults.maybe_flip_score(plan, 2, s) is None      # wrong iteration
    assert faults.maybe_flip_score(faults.FaultPlan(flip_score_rank=(1, 3)),
                                   3, s) is None            # wrong rank
    f1 = faults.maybe_flip_score(plan, 3, s)
    bits = f1.numpy().view(np.uint32) ^ s.numpy().view(np.uint32)
    assert np.count_nonzero(bits) == 1 and bits.sum() == 1
    assert f1.device == s.device and f1.dtype == torch.float32
    f2 = faults.maybe_flip_score(plan, 3, f1)
    assert torch.equal(f2, s)


def test_fault_plan_parses_rank_iteration_as_jax(monkeypatch):
    """The rank-targeted faults read "r:k" from the parameters, the
    environment overriding them; a malformed value disarms."""
    from lightgbm_tpu.utils import faults as jfaults
    cfg_t = lt.Config.from_params({"fault_flip_score_rank": "2:5",
                                   "fault_kill_rank_at_iter": "1:3",
                                   "fault_corrupt_shard": 1,
                                   "device_type": "cpu"})
    cfg_j = lj.Config.from_params({"fault_flip_score_rank": "2:5",
                                   "fault_kill_rank_at_iter": "1:3",
                                   "fault_corrupt_shard": 1})
    monkeypatch.setenv("LGBM_TPU_FAULT_HANG_RANK_AT_ITER", "0:4")
    monkeypatch.setenv("LGBM_TPU_FAULT_KILL_IN_SHARD_WRITE", "bad")
    pt, pj = faults.plan_from(cfg_t), jfaults.plan_from(cfg_j)
    for field in ("flip_score_rank", "kill_rank_at_iter",
                  "hang_rank_at_iter", "kill_in_shard_write",
                  "corrupt_shard", "hang_at_iter"):
        assert getattr(pt, field) == getattr(pj, field), field
    assert pt.flip_score_rank == (2, 5) and pt.hang_rank_at_iter == (0, 4)
    assert pt.kill_in_shard_write is None


# ====================================================== the engine hooks
def test_step_retry_rearms_watchdog_clock():
    prog = td._progress
    prog.reset()
    td.notify_step_begin(5)
    time.sleep(0.05)
    td.notify_step_retry(5)
    snap = prog.snapshot()
    assert snap["phase"].startswith("step-retry:5")
    assert snap["phase_elapsed"] < 0.05
    assert snap["steps_done"] == 0 and snap["step"] == 5
    td.notify_step_end(5)
    snap = prog.snapshot()
    assert snap["phase"] is None and snap["steps_done"] == 1
    prog.reset()


def test_checkpoint_callback_votes_before_save(tmp_path, monkeypatch):
    X, y = _data(n=200)
    p = dict(BASE, integrity_check_period=3, device_type="cpu")
    b = lt.train(dict(p), lt.Dataset(X, label=y, params=dict(p)), 2)
    calls = []
    monkeypatch.setattr(td, "check_model_integrity",
                        lambda boosting, it, **kw: calls.append(it))
    cb = lt.checkpoint_callback(str(tmp_path / "ck"), period=1)
    env = CallbackEnv(model=b, params=dict(p), iteration=1,
                      begin_iteration=0, end_iteration=2,
                      evaluation_result_list=[])
    cb(env)
    assert calls == [1]
    b._boosting._integrity_checked_iter = 1
    cb(env)
    assert calls == [1]


FLIP_PARAMS = dict(sc.PARAMS, integrity_check_period=1)
FLIP_ROUNDS = 4


def test_unsupervised_gang_raises_everywhere(monkeypatch):
    """Three thread-ranks on replicated rows, rank 1's score flipped after
    iteration 2: every rank raises RankDivergenceError naming rank 1 at
    iteration 2, by a strict majority (no supervisor: no exit)."""
    monkeypatch.setenv("LGBM_TPU_FAULT_FLIP_SCORE_RANK", "1:2")
    X, y = sc.data()
    p = dict(FLIP_PARAMS, device_type="cpu", collective_deadline=0.0)

    def body(net):
        try:
            lt.train(dict(p), lt.Dataset(X, label=y, params=dict(p)),
                     FLIP_ROUNDS)
            return ("no-error", None)
        except td.RankDivergenceError as e:
            return ("diverged", (e.iteration, e.corrupt_ranks,
                                 e.indeterminate))

    assert network.thread_gang(3, body) == [("diverged", (2, [1], False))] * 3


# ============================================== the supervised gang demo
@pytest.fixture(scope="module")
def flipped_gang(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("integrity") / "ck")
    os.environ["LGBM_TPU_FAULT_FLIP_SCORE_RANK"] = "1:2"
    try:
        report = supervisor.run_supervised(
            sc.gang_train, nproc=3,
            args=(ck, {"integrity_check_period": 1}, FLIP_ROUNDS, False),
            device_type="cpu", checkpoint_dir=ck, max_restarts=2,
            timeout=180)
    finally:
        os.environ.pop("LGBM_TPU_FAULT_FLIP_SCORE_RANK", None)
    X, y = sc.data()
    return {"report": report, "ck": ck,
            "jax": torch_jax_mesh.jax_on_mesh(3, FLIP_PARAMS, X, y,
                                              FLIP_ROUNDS)}


def test_supervised_corrupt_rank_restart_bit_identical(flipped_gang):
    report = flipped_gang["report"]
    assert report.restarts == 1 and report.world_size == 3
    fl = report.failures[0]
    assert fl.exit_codes.get(1) == td.DIVERGENCE_EXIT_CODE
    assert "diverged" in fl.reason
    divs = [d for d in fl.watchdog if d.get("kind") == "divergence"]
    assert divs and divs[0]["corrupt_ranks"] == [1] and divs[0]["rank"] == 1
    assert divs[0]["iteration"] == 2
    assert report.shrinks == []                 # budget 1: restart
    # the relaunch resumed from the newest valid checkpoint: 2, or 3 when
    # the honest majority's rank 0 (replicated rows: it writes alone)
    # checkpointed its own state after iteration 2 before the teardown
    # reached it; the flipped bit is in neither
    ev = [e for e in sc.events(flipped_gang["ck"]) if e["incarnation"] == 1]
    first = min(e["iteration"] for e in ev)
    assert first in (2, 3)
    assert sorted(e["iteration"] for e in ev) == \
        sorted(list(range(first, FLIP_ROUNDS)) * 3)
    assert report.result == flipped_gang["jax"]
