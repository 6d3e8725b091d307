"""Health gauges: last-value-wins instruments of the supervision layer.

The port of the gauge table of lightgbm_tpu's ``utils/profiling.py``: the
supervisor records ``supervisor_world_size``, ``supervisor_incarnation``,
``supervisor_restarts`` and ``supervisor_shrinks``, the heartbeat server
``heartbeat_age_rank<r>`` and ``last_iter_rank<r>``, the integrity vote
``integrity_checks_run``, ``integrity_last_iteration`` and
``integrity_check_ms`` (its host milliseconds), and the OOM ladder
``oom_degradations``. Unlike timers these are always on (a restart count
that records only when profiling is enabled would be useless after a
failure) and cost one dict store. The rest of the JAX module (timer
scopes, work counters, the dispatch hooks) comes with ROADMAP.md Queue 1
item 16.
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.RLock()
_gauges: Dict[str, float] = {}


def set_gauge(name: str, value: float) -> None:
    """Record the current value of a named health gauge."""
    with _lock:
        _gauges[name] = float(value)


def inc_gauge(name: str, delta: float = 1.0) -> float:
    """Increment a counting gauge and return its new value."""
    with _lock:
        v = _gauges.get(name, 0.0) + float(delta)
        _gauges[name] = v
        return v


def gauges() -> Dict[str, float]:
    """Current gauge values (supervisor restarts, heartbeat ages, ...)."""
    with _lock:
        return dict(_gauges)
