"""Gang supervisor: launch a multi-process training gang, watch it, and
relaunch it from the newest valid checkpoint when a rank dies, hangs,
fails to start or holds corrupted state.

The port of lightgbm_tpu's ``supervisor.py``, the restart half of the
supervision layer (the detection half, heartbeats and the collective
watchdog, lives in ``distributed.py``). Kill a rank at iteration k: the
supervisor tears the survivors down, relaunches the gang, the gang
resumes from the newest valid checkpoint, and the final model text is
the uninterrupted run's byte for byte.

``fn`` is a picklable ``fn(rank, *args)`` as in ``distributed.spawn``;
it trains with a checkpoint callback and ``resume_from`` on the same
directory, so a relaunched incarnation continues instead of starting
over. A gang over replicated data (every rank all rows) checkpoints from
rank 0; a pre-partitioned gang (``distributed.load_partitioned``, each
rank its own rows) writes sharded checkpoints, which re-partition on
load, so it also resumes after a shrink::

    def work(rank, ckdir):
        net = lgb.network.current()        # after the gang's init
        lo, hi = rows_of(net.rank, net.world)
        ds = lgb.distributed.load_partitioned(X[lo:hi], label=y[lo:hi],
                                              params=params)
        booster = lgb.train(params, ds, rounds,
                            callbacks=[lgb.checkpoint_callback(ckdir)],
                            resume_from=ckdir)
        return booster.model_to_string()

    report = lgb.supervisor.run_supervised(work, nproc=2, args=(ckdir,),
                                           checkpoint_dir=ckdir)
    report.result      # rank 0's return value
    report.restarts    # how many gang relaunches it took

Children run with ``LGBM_TPU_SUPERVISED=1``: a rank whose watchdog fires
exits with ``WATCHDOG_EXIT_CODE`` after writing a JSON diagnosis the
supervisor folds into its report (a rank stuck inside a native collective
cannot be unstuck from Python); a rank the integrity vote names as holding
diverged state exits with ``DIVERGENCE_EXIT_CODE`` and is charged its
restart budget, as a killed rank is. One-shot ``LGBM_TPU_FAULT_*``
injections are stripped from relaunched incarnations, and
``LGBM_TPU_RESTART_COUNT`` tells the children which incarnation they are.

Elastic gangs: a rank whose spawn fails (exit ``SPAWN_FAIL_EXIT_CODE``),
or that keeps failing past ``rank_restart_budget`` at one world size, is
lost for good: the next incarnation runs one rank smaller (down to
``min_world_size``), its ranks renumbered ``0..n-2`` (so ``fn`` takes its
rows from the gang's rank and world after the init), and the report
records a ``GangShrink``.

Each incarnation gets a fresh store port (the dead incarnation's store
died with its rank 0) and a fresh heartbeat port; the children are
started by the ``spawn`` context only (a child that uses CUDA must never
be forked, and the supervising process may hold a CUDA context itself).
Teardown terminates every live rank at once, waits at most 10 s, then
kills: a rank inside a CUDA call may ignore SIGTERM.

Every failure leaves a post-mortem: the ranks' flight recorders flush
into the diagnosis directory (a killed rank before its exit, a watchdog
or a divergence verdict into its diagnosis, ``telemetry.py``), and when
any incarnation failed the supervisor runs ``postmortem.analyze`` over
the directory, the failure history and the checkpoint manifests, writes
``postmortem.json`` / ``postmortem.txt`` beside them, and carries the
report's path in ``SupervisorReport.postmortem`` (or
``GangFailedError.postmortem``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from . import distributed
from .utils import log, profiling

# environment variables whose faults are one-shot: armed for the first
# incarnation only
_FAULT_ENV_PREFIX = "LGBM_TPU_FAULT_"


@dataclass
class GangFailure:
    """One failed incarnation: which rank(s) went down, how, and what the
    watchdog or integrity diagnoses said. ``started_at`` / ``detected_at``
    are wall times (``time.time()``) of the incarnation's launch and of
    the supervisor's detection; ``teardown_seconds`` the teardown's."""
    incarnation: int
    failed_ranks: List[int]
    exit_codes: dict
    reason: str
    watchdog: List[dict] = field(default_factory=list)
    world_size: int = 0               # nproc of this incarnation
    started_at: float = 0.0
    detected_at: float = 0.0
    teardown_seconds: float = 0.0

    @property
    def watchdog_fired(self) -> bool:
        return bool(self.watchdog) or any(
            c == distributed.WATCHDOG_EXIT_CODE
            for c in self.exit_codes.values())

    @property
    def spawn_failed_ranks(self) -> List[int]:
        """Ranks whose process never came up (exit SPAWN_FAIL_EXIT_CODE):
        lost for good, without burning the per-rank budget."""
        return sorted(r for r, c in self.exit_codes.items()
                      if c == distributed.SPAWN_FAIL_EXIT_CODE)

    @property
    def flight_recorders(self) -> List[str]:
        """The per-rank flight-recorder files the diagnoses reference
        (the watchdog and the divergence verdict flush before writing
        theirs; a killed rank's JSONL is found as flight_rank*.jsonl in
        the diagnosis directory)."""
        return sorted({d["flight_recorder"] for d in self.watchdog
                       if d.get("flight_recorder")})


@dataclass
class GangShrink:
    """One shrink: the supervisor gave up rank(s) for good and relaunched
    the gang smaller (the survivors renumber to 0..to_nproc-1; a sharded
    checkpoint re-partitions on load)."""
    incarnation: int                  # the incarnation that failed
    from_nproc: int
    to_nproc: int
    lost_ranks: List[int]             # ranks (old numbering) given up
    reason: str


@dataclass
class SupervisorReport:
    """The outcome of a supervised gang run. ``incarnation_starts`` holds
    each incarnation's launch wall time."""
    result: Any
    restarts: int
    failures: List[GangFailure]
    wall_time: float
    world_size: int = 0               # nproc the gang finished at
    shrinks: List[GangShrink] = field(default_factory=list)
    # the post-mortem report's path (postmortem.py) when any incarnation
    # failed; None on a clean first-try run
    postmortem: Optional[str] = None
    incarnation_starts: List[float] = field(default_factory=list)


class GangFailedError(RuntimeError):
    """The gang kept failing past ``max_restarts``; carries the failure
    history and the post-mortem report's path."""

    def __init__(self, msg: str, failures: List[GangFailure],
                 postmortem: Optional[str] = None):
        super().__init__(msg)
        self.failures = failures
        self.postmortem = postmortem


def _run_postmortem(diag_dir: str, failures: List[GangFailure],
                    checkpoint_dir: Optional[str]) -> Optional[str]:
    """Analyze the failed gang's breadcrumbs (the flight JSONLs in the
    diagnosis directory, the diagnoses the failure history consumed, the
    checkpoint manifests) and write the report beside them. Best effort,
    as in the JAX package: an analyzer failure must not replace the real
    failure path, so it warns and returns None."""
    from . import postmortem
    try:
        pm = postmortem.analyze(diag_dir, checkpoint_dir=checkpoint_dir,
                                failures=failures)
        path = postmortem.write_report(pm, diag_dir)
    except Exception as e:           # noqa: BLE001 -- see docstring
        log.warning(f"supervisor: post-mortem analysis failed: {e}")
        return None
    log.warning(f"supervisor: post-mortem verdict {pm.verdict.upper()}"
                + (f" (rank {pm.rank})" if pm.rank is not None else "")
                + f" -- report at {path}")
    return path


def _read_diags(diag_dir: str) -> List[dict]:
    """The watchdog (``watchdog_rank*.json``) and integrity
    (``divergence_rank*.json``) diagnoses the failed ranks wrote, each
    consumed (deleted) as it is read: one diagnosis a failure. A file a
    dying rank left unreadable is reported as such."""
    out = []
    for name in sorted(os.listdir(diag_dir)):
        if not name.startswith(("watchdog_rank", "divergence_rank")):
            continue
        path = os.path.join(diag_dir, name)
        try:
            with open(path) as fh:
                out.append(json.load(fh))
        except ValueError as e:
            out.append({"file": name, "unreadable": str(e)})
        os.unlink(path)
    return out


def _died(dead_codes: dict) -> str:
    """The failure line of ranks that exited nonzero (and of those that
    raised beside them)."""
    kinds = ", ".join(
        f"rank {r} exit {c}"
        + (" (watchdog)" if c == distributed.WATCHDOG_EXIT_CODE else
           (" (spawn failed)" if c == distributed.SPAWN_FAIL_EXIT_CODE else
            (" (diverged)" if c == distributed.DIVERGENCE_EXIT_CODE
             else "")))
        for r, c in sorted(dead_codes.items()) if c is not None)
    raised = sorted(r for r, c in dead_codes.items() if c is None)
    return (f"gang member(s) died: {kinds}"
            + (f"; rank(s) {raised} raised after it (a dead peer's echo)"
               if raised else ""))


def _settle(gang, results: dict, dead_codes: dict,
            grace: float = 2.0) -> dict:
    """A rank that raised is often collateral: gloo reports a dead peer
    to the survivors at once ("Connection reset by peer"), and their
    report can reach the queue before the dead rank's exit code is read.
    Wait up to ``grace`` seconds for another rank to die with a nonzero
    code, and add those codes: the shrink rules then charge the dead rank
    and shield the ones that raised beside it."""
    end = time.monotonic() + grace
    out = dict(dead_codes)
    while True:
        for r, p in enumerate(gang.procs):
            if r not in results and r not in out and not p.is_alive() \
                    and p.exitcode not in (0, None):
                out[r] = p.exitcode
        if any(c is not None for c in out.values()) \
                or time.monotonic() > end:
            return out
        time.sleep(0.05)


class _Incarnation:
    """One launched gang: its processes, its result queue and the
    environment it was started with."""

    def __init__(self, fn, nproc, args, per_rank_args, device_type,
                 incarnation, heartbeat_port, diag_dir):
        import multiprocessing as mp
        self.nproc = nproc
        port = distributed.free_port()
        machines = ",".join(f"127.0.0.1:{port}" for _ in range(nproc))
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        # the children inherit os.environ at start(): install the
        # supervision environment, strip one-shot faults on relaunches,
        # then restore
        override = {
            distributed._SUPERVISED_ENV: "1",
            distributed._HEARTBEAT_ADDR_ENV: f"127.0.0.1:{heartbeat_port}",
            distributed._DIAG_DIR_ENV: diag_dir,
            distributed._RESTART_COUNT_ENV: str(incarnation),
        }
        removed = {}
        if incarnation > 0:
            for k in list(os.environ):
                if k.startswith(_FAULT_ENV_PREFIX):
                    removed[k] = os.environ.pop(k)
        saved = {k: os.environ.get(k) for k in override}
        os.environ.update(override)
        self.started_at = time.time()
        try:
            self.procs = [ctx.Process(
                target=distributed._spawn_child,
                args=(self.q, fn, r, nproc, machines, device_type,
                      tuple(args) if per_rank_args is None
                      else (per_rank_args[r],) + tuple(args)))
                for r in range(nproc)]
            for p in self.procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            os.environ.update(removed)

    def teardown(self) -> float:
        """Terminate every live rank at once, wait at most 10 s, then kill
        what is left (SIGTERM ignored inside native code). Returns the
        seconds it took."""
        t0 = time.monotonic()
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + 10
        for p in self.procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.q.close()
        self.q.cancel_join_thread()
        return time.monotonic() - t0


def run_supervised(fn: Callable, nproc: int = 2, args: tuple = (),
                   per_rank_args: Optional[list] = None,
                   device_type: str = "cuda",
                   checkpoint_dir: Optional[str] = None,
                   max_restarts: int = 2,
                   timeout: Optional[float] = 600.0,
                   diag_dir: Optional[str] = None,
                   rank_restart_budget: int = 1,
                   min_world_size: int = 1) -> SupervisorReport:
    """Run ``fn(rank, *args)`` as a supervised, elastic ``nproc``-process
    gang on ``device_type`` ("cuda": the ranks take cards by their local
    rank modulo the card count, several ranks sharing a card through
    gloo; "cpu").

    Like ``distributed.spawn`` but fault-tolerant: when a rank exits
    nonzero (killed, crashed, watchdog or integrity exit) the survivors
    are torn down and the whole gang relaunches (its ranks share every
    collective, so part of a gang cannot go on), up to ``max_restarts``
    times. ``fn`` resumes from ``checkpoint_dir`` (``train(resume_from=
    ...)``); the supervisor gives relaunches, fault disarming, the
    heartbeat side channel and the failures' diagnoses.

    The gang shrinks instead of giving up when a rank is lost for good:
    its spawn failed, or it has failed more than ``rank_restart_budget``
    times at the current world size. The next incarnation has one process
    fewer and resumes from the newest valid checkpoint. Shrinks take from
    the same ``max_restarts`` budget, are recorded in
    ``SupervisorReport.shrinks`` and the ``supervisor_world_size`` gauge,
    need ``per_rank_args is None`` and stop at ``min_world_size``.

    Args:
      fn, nproc, args, per_rank_args, device_type: as in
        ``distributed.spawn``.
      checkpoint_dir: where the resumable state lives (named in errors).
      max_restarts: the gang's relaunch budget (per run, not per rank).
      timeout: an incarnation's deadline; a gang that neither finishes
        nor fails within it counts as failed.
      diag_dir: where the ranks' diagnoses land (default
        ``supervisor_diag`` inside checkpoint_dir, or a temporary dir).
      rank_restart_budget: failures of one rank tolerated at one world
        size before it is lost for good.
      min_world_size: the smallest gang it may shrink to.

    Returns a SupervisorReport with rank 0's result and the restart
    history; raises GangFailedError past the budget, and RuntimeError at
    once when ``device_type`` is "cuda" and no CUDA device is there.
    """
    import queue as _queue
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be cuda or cpu, got "
                         f"{device_type!r}")
    if device_type == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_supervised(device_type='cuda') but no CUDA device is "
                "available (pass device_type='cpu' to run the gang on the "
                "CPU)")
    if per_rank_args is not None and len(per_rank_args) != nproc:
        raise ValueError(f"per_rank_args has {len(per_rank_args)} entries "
                         f"for {nproc} ranks")
    if diag_dir is None:
        if checkpoint_dir:
            diag_dir = os.path.join(checkpoint_dir, "supervisor_diag")
        else:
            import tempfile
            diag_dir = tempfile.mkdtemp(prefix="lgbm_supervisor_diag_")
    os.makedirs(diag_dir, exist_ok=True)
    failures: List[GangFailure] = []
    shrinks: List[GangShrink] = []
    starts: List[float] = []
    world = int(nproc)
    rank_failures: dict = {}          # rank -> failures at this world size
    t0 = time.monotonic()
    profiling.set_gauge("supervisor_world_size", world)
    for incarnation in range(max_restarts + 1):
        hb_port = distributed.free_port()
        gang = _Incarnation(fn, world, args, per_rank_args, device_type,
                            incarnation, hb_port, diag_dir)
        starts.append(gang.started_at)
        profiling.set_gauge("supervisor_incarnation", incarnation)
        results = {}
        failure = None
        dead_codes = {}
        detected_at = 0.0
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(results) < world and failure is None:
                try:
                    rank, ok, payload = gang.q.get(timeout=0.5)
                    if not ok:
                        failure = (f"rank {rank} raised:\n"
                                   f"{str(payload)[-2000:]}")
                        dead_codes = {rank: None}
                        break
                    results[rank] = payload
                    continue
                except _queue.Empty:
                    pass
                # exit codes read at detection: after the teardown the
                # terminated survivors would read as dead too
                dead_codes = {r: p.exitcode for r, p in enumerate(gang.procs)
                              if r not in results and not p.is_alive()
                              and p.exitcode not in (0, None)}
                if dead_codes:
                    failure = _died(dead_codes)
                    break
                if deadline is not None and time.monotonic() > deadline:
                    missing = [r for r in range(world) if r not in results]
                    failure = (f"incarnation timed out after {timeout}s "
                               f"waiting for ranks {missing}")
                    break
            if failure is not None and None in dead_codes.values():
                dead_codes = _settle(gang, results, dead_codes)
                if any(c is not None for c in dead_codes.values()):
                    failure = _died(dead_codes)
        finally:
            detected_at = time.time()
            teardown_s = gang.teardown()
        if failure is None:
            profiling.set_gauge("supervisor_restarts", incarnation)
            return SupervisorReport(result=results.get(0),
                                    restarts=incarnation,
                                    failures=failures,
                                    wall_time=time.monotonic() - t0,
                                    world_size=world, shrinks=shrinks,
                                    postmortem=(_run_postmortem(
                                        diag_dir, failures, checkpoint_dir)
                                        if failures else None),
                                    incarnation_starts=starts)
        diags = _read_diags(diag_dir)
        rec = GangFailure(
            incarnation=incarnation,
            failed_ranks=sorted(dead_codes) or
            [r for r in range(world) if r not in results],
            exit_codes=dead_codes, reason=failure, watchdog=diags,
            world_size=world, started_at=gang.started_at,
            detected_at=detected_at, teardown_seconds=teardown_s)
        failures.append(rec)
        sus = {s for d in diags for s in (d.get("suspects") or [])}
        # ---- lost for good -> shrink. A divergence exit is hard evidence
        # against the exiting rank (it held minority state by the gang's
        # own vote): like a kill it charges that rank's budget and shields
        # the collateral exits beside it
        hard = {r for r, c in rec.exit_codes.items()
                if c in (137, distributed.SPAWN_FAIL_EXIT_CODE,
                         distributed.DIVERGENCE_EXIT_CODE)}
        for r in rec.failed_ranks:
            if r not in rec.exit_codes:
                # an incarnation timeout: a rank merely missing from the
                # results is no evidence against it
                continue
            if rec.exit_codes.get(r) is None \
                    and any(c is not None for c in rec.exit_codes.values()):
                # a rank that raised beside one that exited: the raise is
                # the dead peer's echo (gloo resets its connections)
                continue
            if rec.exit_codes.get(r) == distributed.WATCHDOG_EXIT_CODE:
                # the symptom of a stalled gang (this rank declared a peer
                # dead or hung), not evidence against this rank
                continue
            if hard and r not in hard:
                # beside a hard death, other nonzero exits are collateral
                continue
            rank_failures[r] = rank_failures.get(r, 0) + 1
        lost = sorted(set(rec.spawn_failed_ranks)
                      | {r for r in rec.failed_ranks
                         if rank_failures.get(r, 0)
                         > max(0, int(rank_restart_budget))})
        shrink = None
        if lost and per_rank_args is None \
                and world - len(lost) >= max(1, int(min_world_size)):
            why = ", ".join(
                f"rank {r} " + ("spawn failed"
                                if r in rec.spawn_failed_ranks else
                                f"failed {rank_failures[r]}x (budget "
                                f"{rank_restart_budget})")
                for r in lost)
            shrink = GangShrink(incarnation=incarnation, from_nproc=world,
                                to_nproc=world - len(lost),
                                lost_ranks=lost, reason=why)
            shrinks.append(shrink)
            world -= len(lost)
            rank_failures = {}        # the new gang's numbering
            profiling.set_gauge("supervisor_world_size", world)
            profiling.set_gauge("supervisor_shrinks", len(shrinks))
        log.warning(
            f"supervisor: incarnation {incarnation} failed ({failure})"
            + (f"; watchdog suspects rank(s) "
               f"{sorted(sus)} at iteration "
               f"{max((d.get('iteration', -1) for d in diags), default=-1)}"
               if diags else "")
            + (f"; rank(s) {shrink.lost_ranks} permanently lost "
               f"({shrink.reason}) — SHRINKING gang "
               f"{shrink.from_nproc} -> {shrink.to_nproc}" if shrink else "")
            + (f"; relaunching from {checkpoint_dir}"
               if incarnation < max_restarts and checkpoint_dir else
               ("; relaunching" if incarnation < max_restarts else "")))
    profiling.set_gauge("supervisor_restarts", max_restarts + 1)
    last = failures[-1]
    wd = next((d for d in last.watchdog if d.get("kind") == "watchdog"),
              None)
    pm_path = _run_postmortem(diag_dir, failures, checkpoint_dir)
    raise GangFailedError(
        f"gang failed {len(failures)} time(s), exceeding max_restarts="
        f"{max_restarts}. Last failure: {last.reason}"
        + (f" (watchdog diagnosis: "
           f"{distributed.format_timeout_message(wd.get('rank'), wd.get('iteration'), wd.get('suspects'), wd.get('phase'), wd.get('deadline'))})"
           if wd else "")
        + (f". Post-mortem report: {pm_path}" if pm_path else "")
        + (f". Resumable checkpoints: {checkpoint_dir}"
           if checkpoint_dir else ""),
        failures, postmortem=pm_path)


def train_supervised(params: dict, data, label=None,
                     num_boost_round: int = 100, nproc: int = 2,
                     checkpoint_dir: str = "", checkpoint_period: int = 1,
                     device_type: Optional[str] = None,
                     timeout: Optional[float] = 900.0,
                     **train_kwargs):
    """Fault-tolerant distributed training: an ``nproc``-process gang over
    replicated data (every rank holds all rows and takes its share through
    the data, voting or feature learner), checkpointing every
    ``checkpoint_period`` iterations and resuming bit-identically across
    relaunches. ``device_type`` defaults to the params' (else "cuda");
    ``max_restarts``, ``rank_restart_budget`` and ``min_world_size`` come
    from the params. Returns (Booster, SupervisorReport)."""
    if not checkpoint_dir:
        raise ValueError("train_supervised needs a checkpoint_dir")
    params = dict(params or {})
    params.setdefault("tree_learner", "data")
    device_type = device_type or str(params.get("device_type", "cuda"))
    params["device_type"] = device_type
    report = run_supervised(
        _supervised_train_fn, nproc=nproc,
        args=(data, label, params, num_boost_round, checkpoint_dir,
              checkpoint_period, dict(train_kwargs)),
        device_type=device_type, checkpoint_dir=checkpoint_dir,
        max_restarts=int(params.get("max_restarts", 2)), timeout=timeout,
        rank_restart_budget=int(params.get("rank_restart_budget", 1)),
        min_world_size=int(params.get("min_world_size", 1)))
    from .booster import Booster
    return Booster(params=params, model_str=report.result), report


def _supervised_train_fn(rank, data, label, params, num_boost_round,
                         checkpoint_dir, checkpoint_period, train_kwargs):
    """One rank of ``train_supervised`` (module level, so the spawn
    context can pickle it): the full replicated Dataset and a
    checkpointed, resumable train."""
    from . import callback as callback_mod
    from .basic import Dataset
    from .engine import train as _train
    ds = Dataset(data, label=label, params=dict(params),
                 free_raw_data=False)
    cbs = list(train_kwargs.pop("callbacks", []) or [])
    cbs.append(callback_mod.checkpoint(checkpoint_dir,
                                       period=checkpoint_period))
    booster = _train(params, ds, num_boost_round, callbacks=cbs,
                     resume_from=checkpoint_dir, **train_kwargs)
    return booster.model_to_string()
