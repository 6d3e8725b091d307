"""Fault-injection harness for resilience testing.

The port of lightgbm_tpu's ``utils/faults.py``: deterministic, opt-in
failure points threaded through the training loop and the predict path,
so the fault-tolerance tests and ``chip_smoke.py``'s faults group drive
the checkpoint/resume, numerics and OOM-ladder machinery against real
failure shapes -- a hard kill mid-run, a writer killed mid-checkpoint, a
checkpoint corrupted on disk, NaN gradients, an allocation failure.

Faults are driven by params (``fault_kill_at_iter`` etc. on Config) or by
environment variables of the JAX package's names, which override the
params, so a test can arm a fault in a child process without touching its
config:

  LGBM_TPU_FAULT_KILL_AT_ITER=k       hard-exit (os._exit(137), no cleanup,
                                      like SIGKILL) at the start of 0-based
                                      boosting iteration k
  LGBM_TPU_FAULT_HANG_AT_ITER=k       hang (an interruptible sleep loop,
                                      forever) at the start of iteration k
  LGBM_TPU_FAULT_KILL_RANK_AT_ITER=r:k   kill only rank r of the gang at
                                      iteration k
  LGBM_TPU_FAULT_HANG_RANK_AT_ITER=r:k   hang only rank r at iteration k
  LGBM_TPU_FAULT_KILL_IN_CKPT_WRITE=k hard-exit in the middle of the
                                      checkpoint write for iteration k
                                      (payload files written, manifest not)
  LGBM_TPU_FAULT_KILL_IN_SHARD_WRITE=r:k  hard-exit rank r between writing
                                      its score-cache shard and the shards'
                                      metadata exchange of the sharded
                                      checkpoint for iteration k (the
                                      stale ckpt_N.tmp must stay harmless)
  LGBM_TPU_FAULT_CORRUPT_SHARD=r      flip bytes in rank r's shard file of
                                      every sharded checkpoint right after
                                      it is published (the manifest stays,
                                      so only the checksums catch it)
  LGBM_TPU_FAULT_SPAWN_FAIL_RANK=r    make spawned child rank r exit with
                                      SPAWN_FAIL_EXIT_CODE (96) before the
                                      gang's init, the "machine cannot
                                      start" shape the supervisor answers
                                      with a shrink (environment only: it
                                      fires before a config exists)
  LGBM_TPU_FAULT_FLIP_SCORE_RANK=r:k  flip one bit of rank r's train-score
                                      cache right after iteration k, the
                                      silent corruption the integrity vote
                                      (distributed.check_model_integrity)
                                      must catch
  LGBM_TPU_FAULT_NAN_GRAD_AT_ITER=k   overwrite the first
                                      LGBM_TPU_FAULT_NAN_GRAD_COUNT (default
                                      8) gradient values with NaN at
                                      iteration k
  LGBM_TPU_FAULT_NAN_HIST_AT_ITER=k   poison one gradient value with NaN at
                                      iteration k (the unfused spelling of
                                      the JAX package's in-program
                                      injection: the port has no fused
                                      one-program iteration)
  LGBM_TPU_FAULT_CORRUPT_CHECKPOINT=1 flip bytes in every checkpoint's
                                      model text right after it is written
  LGBM_TPU_FAULT_OOM_AT_ITER=k        raise a simulated out-of-memory error
                                      from the boosting step at iteration
                                      k, LGBM_TPU_FAULT_OOM_COUNT times in a
                                      row (default 1): one OOM-ladder rung
                                      a raise (models/gbdt.py
                                      _maybe_degrade_oom)
  LGBM_TPU_FAULT_OOM_AT_PREDICT=c     raise a simulated out-of-memory error
                                      from the next ``c`` predict calls of
                                      the process (the fired count persists
                                      across the fresh plans each predict
                                      call builds, so the retry loop ends):
                                      the predict-chunk rung
                                      (_maybe_degrade_predict_oom)
  LGBM_TPU_FAULT_SLOW_PREDICT_MS=ms   sleep ``ms`` milliseconds inside every
                                      predict call (the slow-dispatch shape
                                      the serving layer's per-request
                                      deadlines and admission control must
                                      answer; twin: fault_slow_predict_ms)

The rank-targeted forms read the rank of the calling thread's or
process's gang (``network.current()``), so the plan can be built before
the gang is joined. The gang supervisor strips every
``LGBM_TPU_FAULT_*`` variable from the incarnations it relaunches. With no
fault armed the plan is ``None`` and every hook is one attribute check.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional, Tuple

_KILL_EXIT_CODE = 137   # 128 + SIGKILL: what a preemption/oom kill reports


@dataclass
class FaultPlan:
    kill_at_iter: int = -1
    hang_at_iter: int = -1
    kill_rank_at_iter: Optional[Tuple[int, int]] = None   # (rank, iter)
    hang_rank_at_iter: Optional[Tuple[int, int]] = None   # (rank, iter)
    kill_in_ckpt_write: int = -1
    kill_in_shard_write: Optional[Tuple[int, int]] = None  # (rank, iter)
    corrupt_shard: int = -1                               # rank
    nan_grad_at_iter: int = -1
    nan_grad_count: int = 8
    corrupt_checkpoint: bool = False
    flip_score_rank: Optional[Tuple[int, int]] = None     # (rank, iter)
    nan_hist_at_iter: int = -1
    oom_at_iter: int = -1
    oom_count: int = 1            # consecutive simulated OOM raises left
                                  # (mutated by maybe_oom as they fire)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name, "")
    try:
        return int(v) if v != "" else default
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    try:
        return float(v) if v != "" else default
    except ValueError:
        return default


def _env_rank_iter(name: str,
                   default: str = "") -> Optional[Tuple[int, int]]:
    """An "r:k" rank-targeted fault from the environment (else the
    parameter's string); None when unset or malformed (a malformed value
    must not kill rank 0)."""
    v = os.environ.get(name, "") or str(default or "")
    if not v:
        return None
    try:
        r, _, k = v.partition(":")
        return (int(r), int(k))
    except ValueError:
        sys.stderr.write(f"[faults] ignoring malformed {name}={v!r} "
                         f"(want rank:iter)\n")
        return None


def plan_from(config=None) -> Optional[FaultPlan]:
    """The active fault plan from config fields overridden by the
    LGBM_TPU_FAULT_* environment; None when nothing is armed."""
    get = (lambda k, d: getattr(config, k, d)) if config is not None \
        else (lambda k, d: d)
    plan = FaultPlan(
        kill_at_iter=_env_int("LGBM_TPU_FAULT_KILL_AT_ITER",
                              int(get("fault_kill_at_iter", -1))),
        hang_at_iter=_env_int("LGBM_TPU_FAULT_HANG_AT_ITER",
                              int(get("fault_hang_at_iter", -1))),
        kill_rank_at_iter=_env_rank_iter(
            "LGBM_TPU_FAULT_KILL_RANK_AT_ITER",
            get("fault_kill_rank_at_iter", "")),
        hang_rank_at_iter=_env_rank_iter(
            "LGBM_TPU_FAULT_HANG_RANK_AT_ITER",
            get("fault_hang_rank_at_iter", "")),
        kill_in_ckpt_write=_env_int("LGBM_TPU_FAULT_KILL_IN_CKPT_WRITE",
                                    int(get("fault_kill_in_ckpt_write", -1))),
        kill_in_shard_write=_env_rank_iter(
            "LGBM_TPU_FAULT_KILL_IN_SHARD_WRITE",
            get("fault_kill_in_shard_write", "")),
        corrupt_shard=_env_int("LGBM_TPU_FAULT_CORRUPT_SHARD",
                               int(get("fault_corrupt_shard", -1))),
        nan_grad_at_iter=_env_int("LGBM_TPU_FAULT_NAN_GRAD_AT_ITER",
                                  int(get("fault_nan_grad_at_iter", -1))),
        nan_grad_count=_env_int("LGBM_TPU_FAULT_NAN_GRAD_COUNT", 8),
        flip_score_rank=_env_rank_iter(
            "LGBM_TPU_FAULT_FLIP_SCORE_RANK",
            get("fault_flip_score_rank", "")),
        nan_hist_at_iter=_env_int("LGBM_TPU_FAULT_NAN_HIST_AT_ITER",
                                  int(get("fault_nan_hist_at_iter", -1))),
        oom_at_iter=_env_int("LGBM_TPU_FAULT_OOM_AT_ITER",
                             int(get("fault_oom_at_iter", -1))),
        oom_count=_env_int("LGBM_TPU_FAULT_OOM_COUNT",
                           int(get("fault_oom_count", 1))),
        corrupt_checkpoint=(
            # env, when set, overrides the param in both directions: "1"
            # arms, anything else disarms
            os.environ["LGBM_TPU_FAULT_CORRUPT_CHECKPOINT"] == "1"
            if "LGBM_TPU_FAULT_CORRUPT_CHECKPOINT" in os.environ
            else bool(get("fault_corrupt_checkpoint", False))),
    )
    if (plan.kill_at_iter < 0 and plan.hang_at_iter < 0
            and plan.kill_rank_at_iter is None
            and plan.hang_rank_at_iter is None
            and plan.kill_in_ckpt_write < 0
            and plan.kill_in_shard_write is None
            and plan.corrupt_shard < 0
            and plan.nan_grad_at_iter < 0 and plan.nan_hist_at_iter < 0
            and plan.flip_score_rank is None
            and plan.oom_at_iter < 0 and not plan.corrupt_checkpoint):
        return None
    return plan


def _process_rank() -> int:
    from .. import network
    return network.current().rank


def _hard_exit(context: str) -> None:
    """``os._exit`` skips atexit and finally, so nothing gets the chance
    to finish a write (the SIGKILL shape a preempted worker sees).

    One exception, as in the JAX package: the flight recorder flushes
    first. The harness kill is the testable stand-in for preemption, and
    a killed gang is meant to leave its post-mortem ring; the flush is one
    atomic file write, so it finishes no in-flight checkpoint."""
    from .. import telemetry
    telemetry.flush_recorder(f"fault-kill {context}")
    sys.stderr.write(f"[faults] killing process {context}\n")
    sys.stderr.flush()
    os._exit(_KILL_EXIT_CODE)


def maybe_kill(plan: Optional[FaultPlan], iteration: int) -> None:
    """Hard-exit at the armed iteration (optionally rank-targeted)."""
    if plan is None:
        return
    if plan.kill_at_iter == iteration:
        _hard_exit(f"at iteration {iteration}")
    if plan.kill_rank_at_iter is not None \
            and plan.kill_rank_at_iter[1] == iteration \
            and plan.kill_rank_at_iter[0] == _process_rank():
        _hard_exit(f"(rank {plan.kill_rank_at_iter[0]}) at iteration "
                   f"{iteration}")


def maybe_hang(plan: Optional[FaultPlan], iteration: int) -> None:
    """Hang forever at the armed iteration (optionally rank-targeted) in
    an interruptible short-sleep loop: it re-enters Python bytecode every
    tick, so the watchdog's asynchronous DistributedTimeoutError lands and
    a supervisor's SIGTERM still ends the process."""
    if plan is None:
        return
    hang = plan.hang_at_iter == iteration
    if not hang and plan.hang_rank_at_iter is not None \
            and plan.hang_rank_at_iter[1] == iteration:
        hang = plan.hang_rank_at_iter[0] == _process_rank()
    if not hang:
        return
    sys.stderr.write(f"[faults] hanging rank {_process_rank()} at "
                     f"iteration {iteration}\n")
    sys.stderr.flush()
    while True:
        time.sleep(0.05)


def maybe_kill_in_ckpt_write(plan: Optional[FaultPlan],
                             iteration: int) -> None:
    """Kill the checkpoint writer between the payload writes and the
    manifest write: the mid-write crash the manifest-last protocol and the
    ``.tmp`` staging directory must make harmless."""
    if plan is not None and plan.kill_in_ckpt_write == iteration:
        _hard_exit(f"inside checkpoint write for iteration {iteration}")


def maybe_nan_grad(plan: Optional[FaultPlan], iteration: int, g, h):
    """Overwrite the first ``nan_grad_count`` gradient entries (row-major)
    with NaN at the armed iteration; returns (g, h), ``g`` a new tensor
    when it fires."""
    if plan is None or plan.nan_grad_at_iter != iteration:
        return g, h
    n = min(plan.nan_grad_count, g.shape[0])
    g = g.clone()
    g.view(-1)[:n] = float("nan")
    return g, h


def maybe_nan_hist(plan: Optional[FaultPlan], iteration: int, g, h):
    """Poison one gradient value with NaN at the armed iteration (the
    host-path twin of the JAX package's in-program injection)."""
    if plan is None or plan.nan_hist_at_iter != iteration:
        return g, h
    g = g.clone()
    g.view(-1)[0] = float("nan")
    return g, h


def corrupt_file(path: str, offset: Optional[int] = None,
                 nbytes: int = 16, truncate: bool = False) -> None:
    """Damage a file in place: XOR-flip ``nbytes`` at ``offset`` (the
    middle of the file by default), or truncate it there."""
    size = os.path.getsize(path)
    if offset is None:
        offset = size // 2
    offset = max(0, min(offset, max(size - 1, 0)))
    if truncate:
        with open(path, "r+b") as fh:
            fh.truncate(offset)
        return
    with open(path, "r+b") as fh:
        fh.seek(offset)
        chunk = fh.read(nbytes)
        fh.seek(offset)
        fh.write(bytes(b ^ 0xA5 for b in chunk))


def maybe_corrupt_checkpoint(plan: Optional[FaultPlan], path: str) -> None:
    """Corruption injection point the checkpoint writer calls after a
    successful save (damages the payload and leaves the manifest intact,
    so only checksum validation can catch it)."""
    if plan is not None and plan.corrupt_checkpoint:
        corrupt_file(path)


def maybe_kill_in_shard_write(plan: Optional[FaultPlan],
                              iteration: int) -> None:
    """Kill rank r between writing its score-cache shard into the staging
    directory and the shards' metadata exchange: one participant of the
    sharded write dies mid-protocol, the manifest never lands, and the
    stale ``ckpt_N.tmp`` must be ignored by readers and removed by the
    next write."""
    if plan is None or plan.kill_in_shard_write is None:
        return
    if plan.kill_in_shard_write[1] == iteration \
            and plan.kill_in_shard_write[0] == _process_rank():
        _hard_exit(f"(rank {plan.kill_in_shard_write[0]}) inside sharded "
                   f"checkpoint write for iteration {iteration}")


def maybe_corrupt_shard(plan: Optional[FaultPlan], path: str,
                        rank: int) -> None:
    """Corrupt one rank's published shard file (the manifest stays): only
    the shard's sha256 in MANIFEST.json can catch it, and the checkpoint
    must then count as invalid."""
    if plan is not None and plan.corrupt_shard == rank:
        corrupt_file(path)


def maybe_flip_score(plan: Optional[FaultPlan], iteration: int, score):
    """Flip one bit (the lowest mantissa bit of element 0) of the armed
    rank's train-score cache after iteration ``iteration`` completes: the
    silent single-bit corruption the integrity vote must pin on exactly
    this rank. Returns the corrupted score tensor (on the score's device),
    or None when the fault is not armed for this rank and iteration.
    Applied twice it restores the original bits."""
    if plan is None or plan.flip_score_rank is None:
        return None
    if plan.flip_score_rank[1] != iteration \
            or plan.flip_score_rank[0] != _process_rank():
        return None
    import numpy as np
    import torch
    arr = score.detach().cpu().numpy().astype(np.float32, copy=True)
    flat = arr.reshape(-1).view(np.uint32)
    flat[0] ^= np.uint32(1)
    sys.stderr.write(f"[faults] flipping one score-cache bit on rank "
                     f"{_process_rank()} after iteration {iteration}\n")
    sys.stderr.flush()
    return torch.from_numpy(arr).to(score.device)


def maybe_fail_spawn(rank: int) -> None:
    """The spawn-failure injection point, at the very top of a spawned
    child (before the gang's init, so it reads the environment only):
    exits with SPAWN_FAIL_EXIT_CODE, and the supervisor classifies the
    rank permanently lost and shrinks the gang."""
    v = os.environ.get("LGBM_TPU_FAULT_SPAWN_FAIL_RANK", "")
    if not v:
        return
    try:
        target = int(v)
    except ValueError:
        sys.stderr.write(f"[faults] ignoring malformed "
                         f"LGBM_TPU_FAULT_SPAWN_FAIL_RANK={v!r}\n")
        return
    if target == rank:
        from ..distributed import SPAWN_FAIL_EXIT_CODE
        sys.stderr.write(f"[faults] failing spawn of rank {rank}\n")
        sys.stderr.flush()
        os._exit(SPAWN_FAIL_EXIT_CODE)


class SimulatedResourceExhausted(RuntimeError):
    """Stands in for a device allocation failure, so the OOM ladder can be
    driven on any host. The message carries the token
    ``is_resource_exhausted`` matches on."""


def maybe_oom(plan: Optional[FaultPlan], iteration: int) -> None:
    """Raise a simulated allocation failure from the boosting step at the
    armed iteration, ``oom_count`` times in a row (the plan's counter
    falls by one a raise): each raise takes the ladder one rung down
    before the step is retried."""
    if plan is None or plan.oom_at_iter != iteration or plan.oom_count <= 0:
        return
    plan.oom_count -= 1
    raise SimulatedResourceExhausted(
        f"RESOURCE_EXHAUSTED: simulated histogram allocation failure at "
        f"iteration {iteration} ({plan.oom_count} more armed)")


def is_resource_exhausted(exc: BaseException) -> bool:
    """Whether an exception is an out-of-device-memory failure: a
    ``torch.cuda.OutOfMemoryError`` (matched by type), an error carrying
    an allocator's phrasing, or the harness's simulated stand-in. The
    classifier the OOM ladder gates on: it matches nothing else."""
    if isinstance(exc, SimulatedResourceExhausted):
        return True
    import torch
    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return ("RESOURCE_EXHAUSTED" in text
            or "Out of memory" in text
            or "Resource exhausted" in text)


# ------------------------------------------------------------ predict faults
@dataclass
class ServeFaults:
    slow_predict_ms: float = 0.0   # sleep inside every predict call
    oom_predicts: int = 0          # simulated OOMs to raise, process-wide


# predict-OOM raises fired so far in this process: the budget lives here
# (module state), not on the plan, because a fresh plan is built per
# predict call and a per-plan counter would re-arm on every retry
_predict_oom_fired = 0
_predict_oom_lock = threading.Lock()


def serve_faults(config=None) -> Optional[ServeFaults]:
    """The active predict-side fault plan; None when nothing is armed."""
    get = (lambda k, d: getattr(config, k, d)) if config is not None \
        else (lambda k, d: d)
    slow = _env_float("LGBM_TPU_FAULT_SLOW_PREDICT_MS",
                      float(get("fault_slow_predict_ms", 0.0)))
    ooms = _env_int("LGBM_TPU_FAULT_OOM_AT_PREDICT",
                    int(get("fault_oom_at_predict", 0)))
    if slow <= 0 and ooms <= 0:
        return None
    return ServeFaults(slow_predict_ms=slow, oom_predicts=ooms)


def maybe_slow_predict(sf: Optional[ServeFaults]) -> None:
    """Delay inside the predict call: forces requests past their
    deadlines and backs the serve queue up into admission control."""
    if sf is not None and sf.slow_predict_ms > 0:
        time.sleep(sf.slow_predict_ms / 1e3)


def maybe_oom_predict(sf: Optional[ServeFaults]) -> None:
    """Raise a simulated allocation failure from the predict call while
    the armed budget has raises left: each raise drives the predict-chunk
    rung once before the call is retried."""
    global _predict_oom_fired
    if sf is None or sf.oom_predicts <= 0:
        return
    with _predict_oom_lock:
        if _predict_oom_fired >= sf.oom_predicts:
            return
        _predict_oom_fired += 1
        left = sf.oom_predicts - _predict_oom_fired
    raise SimulatedResourceExhausted(
        f"RESOURCE_EXHAUSTED: simulated predict allocation failure "
        f"({left} more armed)")


def reset_predict_oom() -> None:
    """Re-arm the predict-OOM budget (tests call this between cases)."""
    global _predict_oom_fired
    _predict_oom_fired = 0


def next_predict_chunk(exc: BaseException, cur: int,
                       hist_oom_fallback: bool = True) -> Optional[int]:
    """The predict rung's arithmetic: the halved chunk to retry with, or
    None when the rung must not fire (gate off, not an allocation failure,
    or the 16k-row floor reached; the caller then re-raises)."""
    if not hist_oom_fallback or not is_resource_exhausted(exc):
        return None
    cur = cur or (1 << 22)
    if cur <= (1 << 14):
        return None
    return max(1 << 14, cur // 2)
