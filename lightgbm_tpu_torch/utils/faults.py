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
  LGBM_TPU_FAULT_KILL_IN_CKPT_WRITE=k hard-exit in the middle of the
                                      checkpoint write for iteration k
                                      (payload files written, manifest not)
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

The multi-process faults (rank-targeted kills and hangs, the sharded
checkpoint's, the score-bit flip) and the hang a watchdog answers come
with ROADMAP Queue 1 item 15, the slow-predict fault with item 16: their
parameters raise naming the item (``config.py``). With no fault armed the
plan is ``None`` and every hook is one attribute check.
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass
from typing import Optional

_KILL_EXIT_CODE = 137   # 128 + SIGKILL: what a preemption/oom kill reports


@dataclass
class FaultPlan:
    kill_at_iter: int = -1
    kill_in_ckpt_write: int = -1
    nan_grad_at_iter: int = -1
    nan_grad_count: int = 8
    corrupt_checkpoint: bool = False
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


def plan_from(config=None) -> Optional[FaultPlan]:
    """The active fault plan from config fields overridden by the
    LGBM_TPU_FAULT_* environment; None when nothing is armed."""
    get = (lambda k, d: getattr(config, k, d)) if config is not None \
        else (lambda k, d: d)
    plan = FaultPlan(
        kill_at_iter=_env_int("LGBM_TPU_FAULT_KILL_AT_ITER",
                              int(get("fault_kill_at_iter", -1))),
        kill_in_ckpt_write=_env_int("LGBM_TPU_FAULT_KILL_IN_CKPT_WRITE",
                                    int(get("fault_kill_in_ckpt_write", -1))),
        nan_grad_at_iter=_env_int("LGBM_TPU_FAULT_NAN_GRAD_AT_ITER",
                                  int(get("fault_nan_grad_at_iter", -1))),
        nan_grad_count=_env_int("LGBM_TPU_FAULT_NAN_GRAD_COUNT", 8),
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
    if (plan.kill_at_iter < 0 and plan.kill_in_ckpt_write < 0
            and plan.nan_grad_at_iter < 0 and plan.nan_hist_at_iter < 0
            and plan.oom_at_iter < 0 and not plan.corrupt_checkpoint):
        return None
    return plan


def _hard_exit(context: str) -> None:
    """``os._exit`` skips atexit and finally, so nothing gets the chance
    to finish a write (the SIGKILL shape a preempted worker sees)."""
    sys.stderr.write(f"[faults] killing process {context}\n")
    sys.stderr.flush()
    os._exit(_KILL_EXIT_CODE)


def maybe_kill(plan: Optional[FaultPlan], iteration: int) -> None:
    """Hard-exit at the armed iteration."""
    if plan is not None and plan.kill_at_iter == iteration:
        _hard_exit(f"at iteration {iteration}")


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
    ooms = _env_int("LGBM_TPU_FAULT_OOM_AT_PREDICT",
                    int(get("fault_oom_at_predict", 0)))
    return ServeFaults(oom_predicts=ooms) if ooms > 0 else None


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
