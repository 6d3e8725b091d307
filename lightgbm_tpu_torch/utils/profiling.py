"""Training-phase profiling: named timer scopes, work counters, health
gauges, memory samples and the dispatch counters.

The port of lightgbm_tpu's ``utils/profiling.py`` (the analog of the
reference's ``Common::Timer`` / ``FunctionTimer`` scopes and the
``global_timer`` table printed under ``USE_TIMETAG``,
include/LightGBM/utils/common.h:953-1037). Each scope also opens a
``torch.profiler.record_function`` of its name, so the phases land
labelled in a trace captured with ``telemetry.trace_window``.

Enabled by the ``LIGHTGBM_TPU_TIMETAG`` environment variable or
``profiling.enable()``. When enabled, a scope's exit synchronises the
scope's device (CUDA launches return before the work is done, so a host
clock without the synchronise measures the enqueue): like USE_TIMETAG,
profiling adds overhead.

The gauges are last-value-wins instruments that are always on: the
supervisor's ``supervisor_world_size`` / ``_incarnation`` / ``_restarts``
/ ``_shrinks``, the heartbeat's ``heartbeat_age_rank<r>`` and
``last_iter_rank<r>``, the integrity vote's ``integrity_checks_run`` /
``_last_iteration`` / ``_check_ms``, the OOM ladder's
``oom_degradations``, the serving layer's ``serve_*`` and the flight
recorder's memory samples. A restart count that recorded only when
profiling is enabled would be useless after a failure.

The dispatch counters (``install_dispatch_hook``): the JAX package counts
compiled-program executions and explicit transfers by hooking jax's
internals; here a ``TorchDispatchMode`` counts every PyTorch operation
dispatched in the installing thread (``dispatches``), the host<->device
copies among them (``device_gets`` / ``d2h_bytes``, ``h2d_bytes``), and
the hand-written kernels' launches (their wrappers go through ctypes,
not PyTorch's dispatcher, so ``ops/cuda_hist._count`` reports each one
here). Installed only on request, by measurement code and tests: every
operation then pays a Python round trip.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

_enabled = os.environ.get("LIGHTGBM_TPU_TIMETAG", "") not in ("", "0")
# a trace_window is capturing: scopes open their record_function even
# with profiling off, so the trace names the phases
_tracing = 0
# one lock over every aggregate table below: the serve dispatcher, the
# watchdog thread and the flight recorder read and update them beside
# the training thread, and a racing ``_acc[k] += v`` can lose an update.
# Reentrant: table()/scopes() may be called from a flush that holds it
_lock = threading.RLock()
_acc: Dict[str, float] = defaultdict(float)
_cnt: Dict[str, int] = defaultdict(int)
# named value counters (work counts rather than wall time), e.g. the rows
# a histogram pass streamed
_counters: Dict[str, float] = defaultdict(float)
_counter_cnt: Dict[str, int] = defaultdict(int)
_gauges: Dict[str, float] = {}
# per-scope device-memory high-water marks, sampled at scope exits
_mem_marks: Dict[str, int] = {}


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear the timer scopes, work counters, gauges and memory marks.

    It leaves the dispatch counters alone: they are monotonic by contract
    (readers scope a measurement by diffing two ``dispatch_stats()``
    snapshots, and a reset between them would corrupt the delta); tests
    that need a clean origin call ``reset_dispatch``."""
    with _lock:
        _acc.clear()
        _cnt.clear()
        _counters.clear()
        _counter_cnt.clear()
        _gauges.clear()
        _mem_marks.clear()


def counter(name: str, value: float) -> None:
    """Accumulate a named work counter (e.g. ``hist_rows_streamed``); a
    no-op when profiling is disabled (callers pass a value the host
    already holds, never one fetched for the purpose)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] += float(value)
        _counter_cnt[name] += 1


def counters() -> Dict[str, float]:
    """Accumulated named counters (empty when profiling is disabled)."""
    with _lock:
        return dict(_counters)


def scopes() -> Dict[str, Dict[str, float]]:
    """Accumulated timer scopes as data: ``{name: {"total_s", "calls",
    "mean_ms"}}``, what ``table()`` prints (the flight recorder's
    per-iteration phase deltas read it)."""
    with _lock:
        return {name: {"total_s": _acc[name], "calls": _cnt[name],
                       "mean_ms": 1e3 * _acc[name] / max(_cnt[name], 1)}
                for name in _acc}


# ------------------------------------------------------------- gauges
def set_gauge(name: str, value: float) -> None:
    """Record the current value of a named health gauge."""
    with _lock:
        _gauges[name] = float(value)


def inc_gauge(name: str, delta: float = 1.0) -> float:
    """Increment a counting gauge (serve shed/timeout counts) and return
    its new value, under the module lock so racing increments keep every
    count."""
    with _lock:
        v = _gauges.get(name, 0.0) + float(delta)
        _gauges[name] = v
        return v


def gauges() -> Dict[str, float]:
    """Current gauge values (supervisor restarts, heartbeat ages, ...)."""
    with _lock:
        return dict(_gauges)


def drop_gauges(prefix: str) -> None:
    """Remove every gauge whose name starts with ``prefix``: a family
    scoped to one event (the ``construct_*`` gauges of one dataset
    construction) is dropped when the next event starts, so no reader
    attributes the last event's values to the current one."""
    with _lock:
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]


# --------------------------------------------------------------- memory
# The device allocator's view (torch.cuda.memory_stats, a local query
# with no launch and no synchronise) and this process's resident set
# (/proc/self/status). Every reader gives None where its source is
# missing: a process that never touched CUDA, a container without /proc.

def device_memory() -> Optional[Dict[str, int]]:
    """One sample of the current CUDA device's allocator:
    ``{"bytes_in_use", "peak_bytes_in_use"}``. None when this process has
    no CUDA context (the CPU runs, as the JAX CPU backend gives None) or
    the query fails: a measurement never fails the run it measures (the
    JAX package's contract; a caller that needs the numbers asserts
    them)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    try:
        stats = torch.cuda.memory_stats()
    except RuntimeError:
        return None
    if not stats:
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0))}


def _proc_status_kb(field: str) -> Optional[int]:
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return None


def host_rss_bytes() -> Optional[int]:
    """This process's current resident set size (bytes), or None where
    /proc is unavailable."""
    kb = _proc_status_kb("VmRSS")
    return kb * 1024 if kb is not None else None


def host_rss_peak_bytes() -> Optional[int]:
    """This process's peak resident set size (VmHWM, bytes)."""
    kb = _proc_status_kb("VmHWM")
    return kb * 1024 if kb is not None else None


def sample_memory() -> Dict[str, Optional[int]]:
    """The memory sample the flight recorder takes an iteration and the
    OOM ladder attaches to every degradation event: device memory in use
    and its peak (``hbm_*``, the JAX package's names) and host RSS, each
    null when its source is unavailable."""
    dev = device_memory()
    return {
        "hbm_bytes_in_use": dev.get("bytes_in_use") if dev else None,
        "hbm_peak_bytes": dev.get("peak_bytes_in_use") if dev else None,
        "host_rss_bytes": host_rss_bytes(),
    }


def _mark_scope_memory(name: str) -> None:
    """Record a scope's device-memory high-water mark, sampled at its exit
    (after the synchronise, so the allocator reflects the phase)."""
    dev = device_memory()
    if not dev:
        return
    cur = dev["peak_bytes_in_use"]
    with _lock:
        if cur > _mem_marks.get(name, -1):
            _mem_marks[name] = cur


def memory_watermarks() -> Dict[str, int]:
    """Per-phase device-memory high-water marks (scope name -> peak bytes
    seen at its exits), kept only while profiling is enabled; cleared by
    ``reset``."""
    with _lock:
        return dict(_mem_marks)


def _sync(value) -> None:
    """Synchronise the device of ``value`` (a tensor, a torch.device, or
    None: the current CUDA device when this process has a CUDA context),
    so a measured scope covers the device work launched inside it."""
    import torch
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
        return
    if isinstance(value, torch.device):
        if value.type == "cuda":
            torch.cuda.synchronize(value)
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def timer(name: str, sync=None) -> Iterator[None]:
    """Named scope. When profiling is enabled its exit synchronises
    ``sync``'s device (or the current CUDA device) and adds the host wall
    time to the table; while profiling or a trace window is on it also
    opens ``torch.profiler.record_function(name)``."""
    if not (_enabled or _tracing):
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        if not _enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            with _lock:
                _acc[name] += time.perf_counter() - t0
                _cnt[name] += 1
            _mark_scope_memory(name)


class timer_sync:
    """Like ``timer`` but the value to synchronise on is produced inside
    the scope: ``with timer_sync("x") as t: ...; t.sync(tensor)``."""

    def __init__(self, name: str):
        self.name = name
        self._value = None

    def sync(self, value) -> None:
        self._value = value

    def __enter__(self):
        self._cm = timer(self.name, None)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        # the synchronise happens before the inner timer closes, so the
        # recorded time covers the device work
        if _enabled:
            _sync(self._value)
        return self._cm.__exit__(*exc)


# ------------------------------------------------- dispatch / transfers
_disp: Dict[str, int] = {"dispatches": 0, "device_gets": 0,
                         "d2h_bytes": 0, "h2d_bytes": 0}
_hook = None            # the live counting mode (None: not installed)


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _count_op(func, args, kwargs, out) -> None:
    """Count one dispatched operation and, for a copy across the host
    boundary, its direction and bytes."""
    import torch
    aten = torch.ops.aten
    src = dst = None
    if func is aten._to_copy.default:
        src, dst = args[0], out
    elif func is aten.copy_.default:
        dst, src = args[0], args[1]
    elif func is aten._local_scalar_dense.default:
        src = args[0]
    with _lock:
        _disp["dispatches"] += 1
        if not isinstance(src, torch.Tensor):
            return
        if func is aten._local_scalar_dense.default:
            if src.device.type != "cpu":
                _disp["device_gets"] += 1
                _disp["d2h_bytes"] += int(src.element_size())
            return
        if not isinstance(dst, torch.Tensor):
            return
        if src.device.type != "cpu" and dst.device.type == "cpu":
            _disp["device_gets"] += 1
            _disp["d2h_bytes"] += _nbytes(src)
        elif src.device.type == "cpu" and dst.device.type != "cpu":
            _disp["h2d_bytes"] += _nbytes(src)


def _counting_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            _count_op(func, args, kwargs, out)
            return out

    return _Counting()


def install_dispatch_hook() -> bool:
    """Start counting the operations dispatched in the calling thread
    (idempotent); returns whether the counters are live.
    ``uninstall_dispatch_hook`` stops it (from the same thread)."""
    global _hook
    if _hook is None:
        mode = _counting_mode()
        mode.__enter__()
        _hook = mode
    return True


def uninstall_dispatch_hook() -> None:
    """Stop counting; the counter values stay."""
    global _hook
    if _hook is not None:
        mode, _hook = _hook, None
        mode.__exit__(None, None, None)


def note_launch() -> None:
    """A hand-written kernel launched (called by its wrapper's launch
    count): one dispatch while the hook is live."""
    if _hook is not None:
        with _lock:
            _disp["dispatches"] += 1


def dispatch_stats() -> Dict[str, int]:
    """Current cumulative counter values (all zero until
    ``install_dispatch_hook``). Monotonic by contract: diff two snapshots
    to scope a measurement."""
    with _lock:
        return dict(_disp)


def reset_dispatch() -> None:
    """Zero the dispatch counters. For tests only: measurement code scopes
    with ``dispatch_stats()`` deltas, and zeroing while another reader
    holds a snapshot corrupts that reader's delta."""
    with _lock:
        for k in _disp:
            _disp[k] = 0


def dispatch_delta(before: Dict[str, int],
                   after: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Counter deltas since a ``dispatch_stats()`` snapshot."""
    if after is None:
        after = dispatch_stats()
    return {k: after[k] - before.get(k, 0) for k in after}


@contextmanager
def dispatch_scope() -> Iterator[Dict[str, int]]:
    """``with dispatch_scope() as d: ...``: after the block ``d`` holds
    the counter deltas of the work inside it (all zero unless the hook is
    live)."""
    before = dispatch_stats()
    d: Dict[str, int] = {}
    try:
        yield d
    finally:
        d.update(dispatch_delta(before))


def table() -> str:
    """The per-scope wall-time table (reference: the USE_TIMETAG summary,
    common.h:970-990), followed by the named work counters."""
    with _lock:
        return _table_locked()


def _table_locked() -> str:
    if not _acc and not _counters:
        return "(no timer scopes recorded)"
    lines = []
    if _acc:
        width = max(len(k) for k in _acc)
        lines.append(f"{'scope'.ljust(width)}  {'calls':>7}  "
                     f"{'total s':>10}  {'mean ms':>10}")
        for name in sorted(_acc, key=lambda k: -_acc[k]):
            n = _cnt[name]
            lines.append(f"{name.ljust(width)}  {n:>7}  "
                         f"{_acc[name]:>10.3f}  "
                         f"{1e3 * _acc[name] / max(n, 1):>10.2f}")
    if _counters:
        width = max(len(k) for k in _counters)
        lines.append(f"{'counter'.ljust(width)}  {'calls':>7}  "
                     f"{'total':>14}  {'mean':>14}")
        for name in sorted(_counters, key=lambda k: -_counters[k]):
            n = _counter_cnt[name]
            lines.append(f"{name.ljust(width)}  {n:>7}  "
                         f"{_counters[name]:>14.0f}  "
                         f"{_counters[name] / max(n, 1):>14.1f}")
    return "\n".join(lines)


def print_table() -> None:
    from . import log
    for line in table().splitlines():
        log.info(line)
