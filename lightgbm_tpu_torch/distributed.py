"""Process-level supervision state, single-process part.

The part of lightgbm_tpu's ``distributed.py`` a one-process run needs:
``barrier`` (the checkpoint writer's synchronization point, a no-op in
one process), the training loop's progress (``notify_step_begin`` /
``notify_step_end``), the OOM ladder's degradation log
(``record_degradation`` / ``degradations`` / ``reset_degradations``) and
``health_snapshot``, the supervision record every checkpoint manifest
carries: the restart count, the last completed iteration and the
degradation events. Process groups, heartbeats, the collective watchdog,
the gang supervisor and the cross-rank integrity vote come with ROADMAP
Queue 1 item 15.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

# the supervisor's restart counter, read from the environment as the JAX
# package reads it (a relaunched process inherits it)
_RESTART_COUNT_ENV = "LGBM_TPU_RESTART_COUNT"

_lock = threading.Lock()
_progress = {"iter": -1, "step": -1}
# degradation events this process recorded (models/gbdt.py
# _maybe_degrade_oom and _maybe_degrade_predict_oom), surfaced through
# health_snapshot() and so through every later checkpoint manifest
_degradations: List[dict] = []


def barrier(name: str = "barrier", timeout: Optional[float] = None) -> None:
    """Cross-process synchronization point; a no-op in one process (the
    port's runs are single-process until Queue 1 item 15)."""
    return None


def notify_step_begin(iteration: int) -> None:
    """The training loop entered boosting iteration ``iteration``."""
    with _lock:
        _progress["step"] = int(iteration)


def notify_step_end(last_completed: int) -> None:
    """The step finished; ``last_completed`` is the last iteration that
    completed (the step's own on success, the one before on a failure)."""
    with _lock:
        _progress["iter"] = int(last_completed)
        _progress["step"] = -1


def record_degradation(event: dict) -> dict:
    """Record one degradation event (kind, iteration, level, action,
    error); each stored event gains a wall and a monotonic timestamp and,
    without one, the active iteration. Returns the stored dict."""
    event = dict(event)
    with _lock:
        event["seq"] = len(_degradations)
        event.setdefault("t", time.time())
        event["t_mono"] = time.monotonic()
        event.setdefault("iteration", int(_progress["iter"]))
        _degradations.append(event)
    return event


def degradations() -> List[dict]:
    """The degradation events recorded since the last reset."""
    with _lock:
        return list(_degradations)


def reset_degradations() -> None:
    """Clear the log: a fresh training run starts with no events, so its
    health snapshots and manifests do not inherit an earlier booster's."""
    with _lock:
        _degradations.clear()


def health_snapshot() -> dict:
    """The restart count (from the supervisor's environment), this
    process's progress and every degradation event, for checkpoint
    manifests."""
    with _lock:
        out = {
            "restart_count": int(os.environ.get(_RESTART_COUNT_ENV, "0")
                                 or 0),
            "last_iteration": _progress["iter"],
            "in_step_iteration": _progress["step"],
        }
        if _degradations:
            out["degradations"] = list(_degradations)
    return out
