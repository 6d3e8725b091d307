"""The port's gang supervisor, heartbeats and collective watchdog against
the JAX package, on the CPU.

- The pure parts on the same inputs as the JAX package's:
  ``format_timeout_message`` word for word, the heartbeat's suspects
  (dead, missing and lagging ranks; no ghost after a shrink; unknown in
  the relaunch window), the restart count a health snapshot reads from
  the environment, ``DistributedTimeoutError``'s fields.
- The watchdog alone, in this process: the first step's exemption, a
  hang (``fault_hang_at_iter``) ended within the deadline by a
  ``DistributedTimeoutError`` naming the rank and the last completed
  iteration (the JAX package's message), and a clean run it leaves
  untouched (same trees; the manifest's health carries the deadline).
- One supervised gang of 2 processes on the CPU (``run_supervised``,
  ranks pre-partitioned, sharded checkpoints every iteration;
  ``torch_supervised_cases``) through three faults:

  * rank 1 killed at iteration 2: one relaunch, and the text is the
    uninterrupted gang's; the report's post-mortem says ``kill``, rank 1,
    iteration 2;
  * rank 1 hung at iteration 1: rank 0's main thread sits inside a gloo
    collective while its watchdog thread fires within the deadline plus
    2 s, naming rank 1 and iteration 0; the relaunch gives the same text,
    and the post-mortem says ``hang`` on rank 1;
  * rank 1 killed at iteration 2 with ``rank_restart_budget=0``: rank 1
    is lost for good, the gang shrinks to 1 and resumes from the sharded
    checkpoint the gang of 2 wrote.

  The uninterrupted gang's text is ``lightgbm_tpu.train``'s data learner
  on a 2-device mesh; the shrunk gang's is the JAX package's run of 2
  iterations on a 2-device mesh resumed from its checkpoint on a 1-device
  mesh. Each JAX run gets its mesh by ``make_mesh`` patched in the test.
"""

import json
import os
import sys
import time

import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu import distributed as jd
from lightgbm_tpu_torch import checkpoint as tckpt
from lightgbm_tpu_torch import distributed as td
from lightgbm_tpu_torch import network, supervisor
from lightgbm_tpu_torch.utils import profiling
from lightgbm_tpu_torch.utils.log import LightGBMError

sys.path.insert(0, os.path.dirname(__file__))
import torch_jax_mesh  # noqa: E402
import torch_supervised_cases as sc  # noqa: E402

torch.set_num_threads(1)


def jax_on_mesh(world, rounds, callbacks=None, resume_from=None):
    """The JAX data learner's text of the gang's data and params on a
    ``world``-device mesh."""
    X, y = sc.data()
    return torch_jax_mesh.jax_on_mesh(world, sc.PARAMS, X, y, rounds,
                                      callbacks, resume_from)


# ==================================================== the pure functions
@pytest.mark.parametrize("args", [
    (0, 1, [1], "step:2", 12.0),
    (3, 17, [1, 2], "barrier:lgbm_tpu_checkpoint_4", 0.4),
    (1, -1, [], None, 5.0),
    (2, 4, None, "exchange:ckpt_shard_3", None),
    (0, 7, [0], "between-steps (host-side)", 10.0),
])
def test_format_timeout_message_matches_jax(args):
    assert td.format_timeout_message(*args) == \
        jd.format_timeout_message(*args)


def test_timeout_error_carries_diagnosis():
    kw = dict(rank=3, iteration=17, suspects=[1, 2], phase="step:18")
    e, j = td.DistributedTimeoutError(**kw), jd.DistributedTimeoutError(**kw)
    assert (e.rank, e.iteration, e.suspects, e.phase) == \
        (j.rank, j.iteration, j.suspects, j.phase)
    assert str(e) == str(j)
    assert "rank 3" in str(e) and "iteration 17" in str(e)


def _suspects(mod, rank, nproc, table_age, my_step, my_iter):
    """``HeartbeatMonitor.suspects`` of package ``mod`` over a fabricated
    table: rank -> (iter, step, seconds since its report); the calling
    rank's own progress is begun as ``step:<my_step>``."""
    hb = mod.HeartbeatMonitor(rank, nproc, "127.0.0.1:1", interval=0.5)
    now = time.monotonic()
    prog = mod._progress
    prog.reset()
    prog.begin(f"step:{my_step}", my_step)
    try:
        if rank == 0:
            hb._server_table = {r: {"iter": i, "step": s, "recv": now - a}
                                for r, (i, s, a) in table_age.items()}
        else:
            hb._table = {r: {"iter": i, "step": s, "age": a}
                         for r, (i, s, a) in table_age.items()}
        return hb.suspects(my_step=my_step, my_iter=my_iter)
    finally:
        prog.end(my_step)
        prog.reset()


@pytest.mark.parametrize("rank,nproc,table,my_step,my_iter", [
    # current, dead (stale), lagging (hung): [2, 3]
    (0, 4, {0: (4, 5, 0.0), 1: (4, 5, 0.0), 2: (4, 5, 60.0),
            3: (2, -1, 0.0)}, 5, 4),
    # a rank that never reported is missing
    (0, 5, {0: (4, 5, 0.0), 1: (4, 5, 0.0), 2: (4, 5, 60.0),
            3: (2, -1, 0.0)}, 5, 4),
    # after a 3 -> 2 shrink, a current table implicates nobody
    (0, 2, {0: (3, 4, 0.0), 1: (3, 4, 0.0)}, 4, 3),
    # a non-zero rank in the relaunch window: an empty table is unknown
    (1, 2, {}, 0, -1),
    # a non-zero rank reading the table rank 0 sent back
    (1, 3, {0: (6, 7, 0.1), 1: (6, 7, 0.1), 2: (5, -1, 0.2)}, 7, 6),
])
def test_heartbeat_suspects_match_jax(rank, nproc, table, my_step,
                                      my_iter):
    got = _suspects(td, rank, nproc, table, my_step, my_iter)
    assert got == _suspects(jd, rank, nproc, table, my_step, my_iter)


@pytest.mark.parametrize("value", ["3", "0", ""])
def test_health_snapshot_restart_count_env_matches_jax(monkeypatch, value):
    monkeypatch.setenv("LGBM_TPU_RESTART_COUNT", value)
    assert td.health_snapshot()["restart_count"] == \
        jd.health_snapshot()["restart_count"]


def test_heartbeat_roundtrip_localhost():
    """A rank-0 server and a rank-1 client exchange progress over the TCP
    side channel; both ends hold the 2-rank table."""
    port = td.free_port()
    hb0 = td.HeartbeatMonitor(0, 2, f"127.0.0.1:{port}", interval=0.2)
    hb1 = td.HeartbeatMonitor(1, 2, f"127.0.0.1:{port}", interval=0.2)
    td._progress.reset()
    try:
        hb0.start()
        hb1.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            if set(hb1.table()) == {0, 1} and set(hb0.table()) == {0, 1}:
                break
            time.sleep(0.1)
        assert set(hb0.table()) == {0, 1}
        assert set(hb1.table()) == {0, 1}
        assert profiling.gauges()["last_iter_rank1"] == -1.0
    finally:
        hb0.stop()
        hb1.stop()


# ====================================================== the watchdog alone
def test_watchdog_exempts_first_step(monkeypatch):
    """A first step longer than the deadline does not fire (the step
    phases are judged after one completed step of this process); once a
    step completed, a stalled one does."""
    fired = []
    prog = td._progress
    wd = td.CollectiveWatchdog(0.2, rank=0, supervised=False)
    monkeypatch.setattr(wd, "_fire", lambda snap: fired.append(snap))
    prog.reset()
    prog.begin("step:0", 0)
    try:
        wd.start()
        time.sleep(1.0)
        assert fired == []
    finally:
        wd.stop()
        prog.end(0)
    prog.begin("step:1", 1)
    try:
        wd2 = td.CollectiveWatchdog(0.2, rank=0, supervised=False)
        monkeypatch.setattr(wd2, "_fire", lambda snap: fired.append(snap))
        wd2.start()
        time.sleep(1.0)
        assert fired and fired[0]["phase"] == "step:1"
    finally:
        wd2.stop()
        prog.end(1)
        prog.reset()


def test_collective_phases_are_on_the_progress_stack():
    """Barriers and exchanges register on the progress stack, so the
    watchdog times them (the checkpoint barrier is where a dead rank's
    survivors wait)."""
    prog = td._progress
    prog.reset()
    with td.watchdog_phase("barrier:test"):
        snap = prog.snapshot()
        assert snap["phase"] == "barrier:test"
        assert snap["phase_elapsed"] >= 0.0
        with td.watchdog_phase("exchange:inner"):
            assert prog.snapshot()["phase"] == "exchange:inner"
        assert prog.snapshot()["phase"] == "barrier:test"
    assert prog.snapshot()["phase"] is None


def _single(params, rounds=6):
    X, y = sc.data()
    p = dict({"objective": "regression", "num_leaves": 7,
              "verbosity": -1, "device_type": "cpu"}, **params)
    return lt.train(dict(p), lt.Dataset(X, label=y, params=dict(p)), rounds)


def test_watchdog_hang_names_rank_and_iteration():
    """A hang at iteration 2 (a host-side stall of this process) is ended
    within the deadline by a DistributedTimeoutError naming rank 0 and the
    last completed iteration, 1: the JAX package's message."""
    t0 = time.time()
    with pytest.raises(td.DistributedTimeoutError) as ei:
        _single({"collective_deadline": 2.0, "fault_hang_at_iter": 2})
    elapsed = time.time() - t0
    e = ei.value
    assert (e.rank, e.iteration) == (0, 1)
    assert e.phase == "between-steps (host-side)"
    assert str(e) == jd.format_timeout_message(0, 1, None, e.phase, 2.0)
    assert elapsed < 2.0 + 10.0, elapsed


def test_watchdog_clean_run_unaffected(tmp_path):
    """An armed watchdog and heartbeat leave the trees as they are, and
    the checkpoint manifest's health records the deadline and restart
    count 0."""
    X, y = sc.data()
    base = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
            "device_type": "cpu"}
    plain = lt.train(dict(base), lt.Dataset(X, label=y, params=dict(base)),
                     4).model_to_string()
    armed = dict(base, collective_deadline=120.0, heartbeat_interval=0.3)
    ckdir = str(tmp_path / "ck")
    watched = lt.train(dict(armed), lt.Dataset(X, label=y,
                                               params=dict(armed)), 4,
                       callbacks=[lt.checkpoint_callback(ckdir, period=2)]
                       ).model_to_string()
    assert plain.split("\nparameters:")[0] == \
        watched.split("\nparameters:")[0]
    health = tckpt.CheckpointManager(ckdir).load_latest_valid() \
        .manifest["health"]
    assert health["restart_count"] == 0
    assert health["last_iteration"] >= 0
    assert health["collective_deadline"] == 120.0
    assert td._active_health is None          # stopped with the run


def test_deadline_must_stay_below_the_group_timeout(monkeypatch):
    """A collective_deadline the gang's time_out would beat is refused:
    torch's own timeout must not fire first. Off the main thread (a
    thread-rank) the handle is inert."""
    monkeypatch.setitem(td._gang, "timeout_s", 60.0)
    cfg = lt.Config.from_params({"collective_deadline": 20.0,
                                 "device_type": "cpu"})
    with network.bind(network.Network(None, 0, 2)):
        with pytest.raises(LightGBMError, match="time_out above"):
            td.start_health(lt.Config.from_params(
                {"collective_deadline": 45.0, "device_type": "cpu"}))
        h = td.start_health(cfg)
        assert h.watchdog is not None and h.watchdog.deadline == 20.0
        h.stop()
    assert td._active_health is None
    handles = network.thread_gang(2, lambda net: td.start_health(cfg))
    assert all(h.watchdog is None and h.heartbeat is None for h in handles)


def test_run_supervised_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supervisor.run_supervised(sc.gang_train, nproc=2,
                                  args=(str(tmp_path / "ck"),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supervisor.train_supervised({"objective": "binary"}, *sc.data(),
                                    num_boost_round=2, nproc=2,
                                    checkpoint_dir=str(tmp_path / "ck2"))


# ================================================ the supervised gang
def _supervised(tmp, name, env, **kw):
    ckdir = os.path.join(tmp, name)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return ckdir, supervisor.run_supervised(
            sc.gang_train, nproc=2, args=(ckdir,), device_type="cpu",
            checkpoint_dir=ckdir, max_restarts=2, timeout=120, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The three faulted gangs and the two JAX texts they are held to."""
    tmp = str(tmp_path_factory.mktemp("supervised"))
    out = {}
    out["kill"] = _supervised(tmp, "kill",
                              {"LGBM_TPU_FAULT_KILL_RANK_AT_ITER": "1:2"})
    out["hang"] = _supervised(tmp, "hang",
                              {"LGBM_TPU_FAULT_HANG_RANK_AT_ITER": "1:1"})
    out["shrink"] = _supervised(tmp, "shrink",
                                {"LGBM_TPU_FAULT_KILL_RANK_AT_ITER": "1:2"},
                                rank_restart_budget=0)
    out["gauges"] = profiling.gauges()
    out["jax_w2"] = jax_on_mesh(2, sc.ROUNDS)
    jck = os.path.join(tmp, "jax_ck")
    jax_on_mesh(2, 2, callbacks=[lj.checkpoint_callback(jck, period=1)])
    out["jax_shrunk"] = jax_on_mesh(1, sc.ROUNDS, resume_from=jck)
    return out


def test_uninterrupted_gang_text_is_the_jax_data_learner(gang, tmp_path):
    """The gang's uninterrupted text (a thread gang of 2, in process) is
    the JAX data learner's on 2 devices; the faulted gangs are held to
    it."""
    texts = network.thread_gang(
        2, lambda net: sc.gang_train(net.rank, str(tmp_path / "ck")))
    assert texts[0] == texts[1] == gang["jax_w2"]


def test_kill_restart_bitwise(gang):
    ckdir, rep = gang["kill"]
    assert rep.restarts == 1 and rep.world_size == 2
    fl = rep.failures[0]
    assert fl.exit_codes.get(1) == 137
    assert fl.failed_ranks == [0, 1] or fl.failed_ranks == [1]
    assert rep.shrinks == []
    # the relaunched gang's report carries the post-mortem of the kill:
    # rank 1 at iteration 2, from its flushed ring and exit code
    with open(rep.postmortem) as fh:
        pm = json.load(fh)
    assert (pm["verdict"], pm["rank"], pm["iteration"]) == ("kill", 1, 2)
    assert all(os.path.exists(p) for p in fl.flight_recorders)
    assert rep.result == gang["jax_w2"]
    ev = sc.events(ckdir)
    # the relaunch resumed at iteration 2 (checkpoint 2) on both ranks
    assert sorted(e["iteration"] for e in ev if e["incarnation"] == 1) \
        == [2, 2, 3, 3]
    assert not [e for e in os.listdir(ckdir) if e.endswith(".tmp")]


def test_hang_watchdog_fires_over_gloo_within_deadline(gang):
    """Rank 1 hangs at the start of iteration 1; rank 0's main thread
    waits inside the step's first gloo collective, and its watchdog
    thread fires within the deadline plus 2 s with a diagnosis naming
    rank 1 and iteration 0; the gang relaunches to the same text."""
    ckdir, rep = gang["hang"]
    deadline = sc.PARAMS["collective_deadline"]
    assert rep.restarts == 1
    fl = rep.failures[0]
    assert fl.watchdog_fired
    assert fl.exit_codes.get(0) == td.WATCHDOG_EXIT_CODE
    d = next(d for d in fl.watchdog if d["rank"] == 0)
    assert d["suspects"] == [1]
    assert d["iteration"] == 0 and d["phase"] == "step:1"
    assert d["deadline"] == deadline
    assert deadline <= d["elapsed"] <= deadline + 2.0
    hang_began = max(e["t"] for e in sc.events(ckdir)
                     if e["incarnation"] == 0 and e["rank"] == 1)
    assert d["t"] - hang_began <= deadline + 2.0
    assert "rank(s) 1" in td.format_timeout_message(
        d["rank"], d["iteration"], d["suspects"], d["phase"], deadline)
    assert rep.shrinks == []
    assert rep.result == gang["jax_w2"]
    with open(rep.postmortem) as fh:
        pm = json.load(fh)
    assert (pm["verdict"], pm["rank"]) == ("hang", 1)
    assert fl.flight_recorders


def test_shrink_2_to_1_resumes_from_the_gang_of_2(gang):
    """rank_restart_budget 0: the killed rank is lost for good, the gang
    relaunches with one rank, which reassembles all rows from the two
    shards the gang of 2 wrote and finishes with the JAX package's text
    for the same 2 + 2 iterations (2 devices, then 1)."""
    ckdir, rep = gang["shrink"]
    assert rep.restarts == 1 and rep.world_size == 1
    sh = rep.shrinks[0]
    assert (sh.from_nproc, sh.to_nproc, sh.lost_ranks) == (2, 1, [1])
    assert "budget 0" in sh.reason
    ev = [e for e in sc.events(ckdir) if e["incarnation"] == 1]
    assert [(e["world"], e["iteration"]) for e in ev] == [(1, 2), (1, 3)]
    assert rep.result == gang["jax_shrunk"]
    assert rep.result != gang["jax_w2"]
    assert gang["gauges"]["supervisor_world_size"] == 1.0
    assert gang["gauges"]["supervisor_shrinks"] == 1.0
