"""Telemetry: the flight recorder, trace capture and exposition.

The port of lightgbm_tpu's ``telemetry.py``, the one subsystem every
layer reports into:

- :func:`snapshot`: one versioned document over the timer scopes, work
  counters, health gauges, dispatch counters, memory and
  ``distributed.health_snapshot()`` (which carries the degradation log,
  the serve gauges and the flight recorder's path). The
  ``ServeFrontend`` metrics endpoint renders it (:func:`prometheus_text`)
  and rank 0 gathers every rank's (:func:`gang_snapshot` over
  ``distributed.exchange_host``).

- :class:`FlightRecorder`: a bounded ring of per-iteration records (phase
  wall-time deltas, dispatch deltas, the numerics verdict, the OOM rung,
  heartbeat ages, memory) that flushes to JSONL atomically on a watchdog
  firing, a divergence verdict, the OOM ladder's exhaustion, a training
  error or a fault-harness kill, so a dead gang leaves a self-describing
  post-mortem (``postmortem.py`` reads it). The recorder reads only values
  the host already holds: recording adds no synchronise and no launch.

- :func:`trace_window`: a ``torch.profiler`` capture around N boosting
  iterations, written as a Chrome trace; the ``record_function`` scopes
  ``profiling.timer`` opens name the phases in it.

Crash durability as in the JAX package: the injected kill faults
(``utils/faults._hard_exit``) flush the ring before ``os._exit``; a real
SIGKILL cannot flush, so runs with a telemetry directory (``telemetry_dir``,
the supervisor's diagnosis directory, or ``checkpoint_path``) also flush
every ``telemetry_flush_period`` iterations. The watchdog's and the
integrity vote's diagnoses embed the flushed path (``"flight_recorder"``),
and so does ``health_snapshot()``, and with it every checkpoint
manifest's health section.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from .utils import log

# Version of both the snapshot schema and the flight-recorder JSONL
# schema (the JAX package's; consumers match on it).
SCHEMA_VERSION = 1

# record types a flight-recorder JSONL may contain, with their required
# fields (validate_flight_jsonl enforces them)
FLIGHT_RECORD_FIELDS: Dict[str, tuple] = {
    # one per flushed file, always the first line
    "run": ("schema", "rank", "pid", "context"),
    # one per boosting update()
    "iter": ("t", "iteration", "iters", "completed", "wall_s", "phases",
             "dispatch", "sentinel", "oom_level"),
    # one per flush event, appended in order (each later flush rewrites
    # the file with the ring and every retained flush event so far)
    "flush": ("t", "reason", "health"),
}


def _utcnow() -> float:
    return time.time()


# ============================================================ snapshot

def snapshot() -> Dict[str, Any]:
    """The telemetry snapshot: ``scopes``/``counters`` (empty unless
    profiling is enabled), ``gauges``, ``dispatch`` (zero until
    ``profiling.install_dispatch_hook``), ``memory``
    (:func:`memory_snapshot`) and ``health``
    (``distributed.health_snapshot()``). Reads host state only, so serving
    threads and the metrics endpoint may call it."""
    from . import distributed
    from .utils import profiling
    return {
        "schema": SCHEMA_VERSION,
        "time": _utcnow(),
        "scopes": profiling.scopes(),
        "counters": profiling.counters(),
        "gauges": profiling.gauges(),
        "dispatch": profiling.dispatch_stats(),
        "memory": memory_snapshot(),
        "health": distributed.health_snapshot(),
    }


def memory_snapshot() -> Dict[str, Any]:
    """The memory plane: ``profiling.sample_memory()``'s fields (device
    memory in use and its peak from ``torch.cuda``, host RSS; null where a
    source is missing), the host RSS peak, and under profiling the
    per-phase device-memory watermarks (``phase_hbm_peak``)."""
    from .utils import profiling
    out: Dict[str, Any] = dict(profiling.sample_memory())
    out["host_rss_peak_bytes"] = profiling.host_rss_peak_bytes()
    marks = profiling.memory_watermarks()
    if marks:
        out["phase_hbm_peak"] = marks
    return out


def construct_snapshot() -> Dict[str, Any]:
    """The construct phase's telemetry from the ``construct_*`` gauges a
    streaming construct records (``Dataset._construct_streaming`` and
    ``distributed.load_partitioned_chunks``); an empty dict when no such
    construct ran in this process."""
    from .utils import profiling
    g = profiling.gauges()
    out: Dict[str, Any] = {}
    for gauge, key in (("construct_sketch_s", "sketch_pass"),
                       ("construct_bin_s", "bin_pass"),
                       ("construct_h2d_overlap_s", "h2d_overlap")):
        if gauge in g:
            out[key] = round(float(g[gauge]), 6)
    if "construct_peak_bytes" in g:
        out["peak_host_bytes"] = int(g["construct_peak_bytes"])
    if "construct_rows" in g:
        out["rows"] = int(g["construct_rows"])
        wall = float(g.get("construct_sketch_s", 0.0)
                     + g.get("construct_bin_s", 0.0))
        if wall > 0:
            out["rows_per_sec"] = round(out["rows"] / wall, 1)
    return out


_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    return "lightgbm_tpu_" + _METRIC_NAME_RE.sub("_", str(name))


def _metric_value(value) -> str:
    """Full-precision exposition value: integral values as integers, the
    rest in repr's shortest round-trip form (6-digit rounding would freeze
    a monotonic counter past 1e6)."""
    v = float(value)
    if v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def prometheus_text(snap: Optional[Dict[str, Any]] = None) -> str:
    """A :func:`snapshot` in the Prometheus text exposition format, one
    metric a line with the JAX package's ``lightgbm_tpu_`` names: gauges
    as metrics of their own (``lightgbm_tpu_serve_p99_ms``), scopes and
    counters as labelled totals, the dispatch counters and the health
    scalars beside them. The ``ServeFrontend`` ``/metrics`` endpoint
    serves exactly this."""
    if snap is None:
        snap = snapshot()
    lines: List[str] = [
        f"# lightgbm_tpu telemetry schema {snap.get('schema', '?')}"]
    for name, value in sorted((snap.get("gauges") or {}).items()):
        lines.append(f"{_metric_name(name)} {_metric_value(value)}")
    for name, sc in sorted((snap.get("scopes") or {}).items()):
        base = _metric_name("scope")
        lines.append(f'{base}_seconds_total{{scope="{name}"}} '
                     f'{_metric_value(sc["total_s"])}')
        lines.append(f'{base}_calls_total{{scope="{name}"}} '
                     f'{int(sc["calls"])}')
    for name, value in sorted((snap.get("counters") or {}).items()):
        lines.append(f'{_metric_name("counter_total")}{{name="{name}"}} '
                     f"{_metric_value(value)}")
    for name, value in sorted((snap.get("dispatch") or {}).items()):
        lines.append(f"{_metric_name(name + '_total')} {int(value)}")
    health = snap.get("health") or {}
    for key in ("restart_count", "last_iteration"):
        if key in health:
            lines.append(f"{_metric_name(key)} {int(health[key])}")
    lines.append(f"{_metric_name('degradations_total')} "
                 f"{len(health.get('degradations') or [])}")
    for rank, entry in sorted((health.get("heartbeat") or {}).items()):
        lines.append(f'{_metric_name("heartbeat_age_seconds")}'
                     f'{{rank="{rank}"}} '
                     f'{_metric_value(entry.get("age", -1))}')
    return "\n".join(lines) + "\n"


def gang_snapshot(tag: str = "telemetry") -> List[Dict[str, Any]]:
    """Every rank's :func:`snapshot` in rank order, on every rank, over
    ``distributed.exchange_host`` (the gang's store). Called in lockstep
    on all ranks like any exchange; ``[snapshot()]`` in a gang of one."""
    from . import distributed
    payloads = distributed.exchange_host(tag, json.dumps(snapshot()))
    out = []
    for p in payloads:
        try:
            out.append(json.loads(p))
        except ValueError:
            out.append({"schema": SCHEMA_VERSION, "error": "unparseable"})
    return out


# ====================================================== flight recorder

class FlightRecorder:
    """Bounded ring of per-iteration records and flush events.

    Training (``GBDT.train_one_iter``) appends one record an update()
    from values the host already holds: wall time, dispatch-counter
    deltas, scope deltas (empty unless profiling is enabled), the OOM
    rung, heartbeat ages, memory. ``flush(reason)`` writes header, ring
    and every retained flush event to ``flight_rank{r}.jsonl`` atomically
    (``utils/atomic_write``: a kill mid-flush leaves the previous complete
    file). Thread-safe: the watchdog thread flushes while the training
    thread records."""

    def __init__(self, capacity: int = 256, directory: Optional[str] = None,
                 rank: int = 0, flush_period: int = 0,
                 incarnation: int = 0):
        self.capacity = max(1, int(capacity))
        self.directory = directory or None
        self.rank = int(rank)
        self.flush_period = max(0, int(flush_period))
        # a supervised relaunch must not overwrite the dead incarnation's
        # post-mortem: incarnation > 0 gets its own file
        self.incarnation = int(incarnation)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        # retained flush events, bounded like the ring
        self._flushes: deque = deque(maxlen=64)
        self._context: Dict[str, Any] = {}
        self._last_path: Optional[str] = None
        self._last_periodic = 0

    # ------------------------------------------------------- recording
    def set_context(self, **fields) -> None:
        """Merge resolved run context (device, histogram method, split
        fusion, ...) into the header record."""
        with self._lock:
            self._context.update(fields)

    @property
    def has_context(self) -> bool:
        return bool(self._context)

    def record(self, iteration: int, iters: int = 1, completed: bool = True,
               wall_s: float = 0.0, phases: Optional[Dict[str, float]] = None,
               dispatch: Optional[Dict[str, int]] = None,
               sentinel: str = "off", oom_level: int = 0,
               **fields) -> None:
        """Append one per-iteration record. Extra keyword fields ride
        along as they are (rows streamed, heartbeat age, memory); values
        must already be on the host."""
        rec = {"type": "iter", "t": _utcnow(), "iteration": int(iteration),
               "iters": int(iters), "completed": bool(completed),
               "wall_s": round(float(wall_s), 6),
               "phases": dict(phases or {}),
               "dispatch": {k: int(v) for k, v in (dispatch or {}).items()},
               "sentinel": sentinel, "oom_level": int(oom_level)}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self._ring.append(rec)
        if (self.flush_period and self.directory
                and iteration // self.flush_period != self._last_periodic):
            # a durable-dir run flushes every flush_period iterations, so a
            # real SIGKILL loses at most one period; the periodic event is
            # not retained (the file would grow with the run's length)
            self._last_periodic = iteration // self.flush_period
            self.flush("periodic", retain_event=False)

    def note_sentinel(self, iteration: int, flags: int) -> None:
        """Back-fill a numerics verdict into the record covering
        ``iteration``; ``flags`` 0 is clean."""
        verdict = "ok" if not flags else f"flags=0b{int(flags):05b}"
        with self._lock:
            for rec in reversed(self._ring):
                if rec["type"] != "iter":
                    continue
                if rec["iteration"] <= iteration \
                        < rec["iteration"] + max(rec["iters"], 1):
                    rec["sentinel"] = verdict
                    return

    def records(self) -> List[dict]:
        """Current ring contents (oldest first; copies)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    # --------------------------------------------------------- flushing
    @property
    def _filename(self) -> str:
        if self.incarnation > 0:
            return f"flight_rank{self.rank}.r{self.incarnation}.jsonl"
        return f"flight_rank{self.rank}.jsonl"

    def _resolve_path(self) -> str:
        d = self.directory
        if not d:
            # an event flush lands somewhere even without a configured
            # directory: a temp dir beats losing the post-mortem
            import tempfile
            d = tempfile.mkdtemp(prefix="lgbm_flight_")
            self.directory = d
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, self._filename)

    def path(self) -> Optional[str]:
        """Where this recorder flushes (None until a directory is known)."""
        if self._last_path:
            return self._last_path
        if self.directory:
            return os.path.join(self.directory, self._filename)
        return None

    def flush(self, reason: str, retain_event: bool = True) -> Optional[str]:
        """Write header, ring and flush events to the JSONL atomically and
        return the path. A flush must never turn a crash diagnosis into a
        crash of its own: on failure it warns and returns None. Each flush
        appends its own event first (the reason, and the health, scope,
        gauge and dispatch state at flush time), so the last line of the
        file names what ended the run. ``retain_event=False`` (periodic
        flushes) writes the event into this file only."""
        from . import distributed
        from .utils import profiling
        from .utils.atomic_write import atomic_write_text
        try:
            health = distributed.health_snapshot()
        except Exception:    # noqa: BLE001 -- see docstring
            health = {}
        event = {"type": "flush", "t": _utcnow(), "reason": str(reason),
                 "health": health, "scopes": profiling.scopes(),
                 "gauges": profiling.gauges(),
                 "dispatch": profiling.dispatch_stats()}
        try:
            # the whole flush runs under the lock: the watchdog thread and
            # the training thread's error flush fire together by design,
            # and racing _resolve_path would split the post-mortem
            with self._lock:
                if retain_event:
                    self._flushes.append(event)
                header = {"type": "run", "schema": SCHEMA_VERSION,
                          "rank": self.rank, "pid": os.getpid(),
                          "capacity": self.capacity,
                          "context": dict(self._context)}
                lines = [header] + [dict(r) for r in self._ring] \
                    + [dict(f) for f in self._flushes]
                if not retain_event:
                    lines.append(event)
                path = self._resolve_path()
                atomic_write_text(path, "\n".join(
                    json.dumps(r, sort_keys=True, default=str)
                    for r in lines) + "\n")
                self._last_path = path
            return path
        except Exception as e:       # noqa: BLE001 -- see docstring
            log.warning(f"flight recorder flush failed ({reason}): {e}")
            return None


# the process's recorder (the training plane is process-wide, like the
# heartbeats, the watchdog and the degradation log), rebuilt by
# configure() whenever a training run initializes
_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def configure(config=None) -> Optional[FlightRecorder]:
    """(Re)build the process's flight recorder from ``config``
    (``GBDT._init_train`` calls it, so every training run starts a fresh
    ring); None, and no recorder, when ``telemetry_flight_recorder`` is
    off. Its directory: ``telemetry_dir`` > the supervisor's diagnosis
    directory (supervised ranks inherit it, so their post-mortems land
    beside the diagnoses) > ``checkpoint_path``/telemetry > none (an event
    flush then takes a temp dir)."""
    global _recorder
    get = (lambda k, d: getattr(config, k, d)) if config is not None \
        else (lambda k, d: d)
    if not bool(get("telemetry_flight_recorder", True)):
        with _recorder_lock:
            _recorder = None
        return None
    from . import distributed, network
    directory = str(get("telemetry_dir", "") or "")
    if not directory:
        directory = os.environ.get(distributed._DIAG_DIR_ENV, "") or ""
    if not directory:
        ck = str(get("checkpoint_path", "") or "")
        if ck:
            directory = os.path.join(ck, "telemetry")
    rec = FlightRecorder(
        capacity=int(get("telemetry_ring_size", 256)),
        directory=directory or None,
        rank=network.current().rank,
        flush_period=int(get("telemetry_flush_period", 64)),
        incarnation=int(os.environ.get(distributed._RESTART_COUNT_ENV,
                                       "0") or 0))
    with _recorder_lock:
        _recorder = rec
    return rec


def recorder() -> Optional[FlightRecorder]:
    """The live process recorder (None when disabled or never built)."""
    return _recorder


def recorder_path() -> Optional[str]:
    """The live recorder's JSONL path, for health snapshots, checkpoint
    manifests and diagnoses to carry by reference."""
    rec = _recorder
    return rec.path() if rec is not None else None


def flush_recorder(reason: str) -> Optional[str]:
    """Flush the process's recorder (None when there is none). For the
    paths with no booster in hand (the watchdog thread, the divergence
    verdict, ``faults._hard_exit``); a booster's own paths flush
    ``GBDT._flight``, so a process of several boosters (cv folds) never
    flushes another's ring."""
    rec = _recorder
    if rec is None:
        return None
    return rec.flush(reason)


# ------------------------------------------------- JSONL validation

def validate_flight_record(rec: Dict[str, Any]) -> List[str]:
    """Schema-check one flight-recorder record; the violations (empty:
    valid)."""
    errs = []
    rtype = rec.get("type")
    if rtype not in FLIGHT_RECORD_FIELDS:
        return [f"unknown record type {rtype!r}"]
    for f in FLIGHT_RECORD_FIELDS[rtype]:
        if f not in rec:
            errs.append(f"{rtype} record missing field {f!r}")
    if rtype == "run" and rec.get("schema") != SCHEMA_VERSION:
        errs.append(f"schema {rec.get('schema')!r} != {SCHEMA_VERSION}")
    return errs


def validate_flight_jsonl(path: str):
    """Parse and schema-check a flushed flight-recorder JSONL: ``(records,
    errors)``. A valid file has a ``run`` header first, at least one
    ``flush`` event, and no record violations."""
    records: List[dict] = []
    errors: List[str] = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                errors.append(f"line {i + 1}: unparseable JSON ({e})")
                continue
            errors.extend(f"line {i + 1}: {m}"
                          for m in validate_flight_record(rec))
            records.append(rec)
    if not records or records[0].get("type") != "run":
        errors.append("first record is not a 'run' header")
    if not any(r.get("type") == "flush" for r in records):
        errors.append("no 'flush' event record")
    return records, errors


# ==================================================== trace capture

TRACE_SUFFIX = ".pt.trace.json"


class TraceResult:
    """Outcome of a :func:`trace_window` capture (``path``: the Chrome
    trace written)."""

    def __init__(self, trace_dir: str, iters: Optional[int]):
        self.trace_dir = trace_dir
        self.iters = iters
        self.ok = False
        self.error: Optional[str] = None
        self.path: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return {"dir": self.trace_dir, "iters": self.iters,
                "ok": self.ok, "error": self.error, "path": self.path}


@contextmanager
def trace_window(trace_dir: str,
                 iters: Optional[int] = None) -> Iterator[TraceResult]:
    """Capture a trace around a window of boosting iterations::

        with telemetry.trace_window(d, iters=N) as tw:
            for _ in range(N):
                booster.update()

    Drives ``torch.profiler`` (the host's operations, and the card's
    kernels where CUDA is available) and writes a Chrome trace
    ``<trace_dir>/trace_rank<r>_<pid>.pt.trace.json``. While it captures,
    the ``profiling.timer`` scopes open their ``record_function``, so the
    grower's phases arrive labelled. ``iters`` is metadata.

    Tolerant by design, as the JAX package's: a profiler that cannot start
    or stop records ``tw.error`` instead of raising (measurement must not
    end the run it measures); ``tw.ok`` is True only when the trace was
    written. A caller that needs the trace asserts ``tw.ok``."""
    import torch
    from . import network
    from .utils import profiling
    tw = TraceResult(trace_dir, iters)
    prof = None
    try:
        os.makedirs(trace_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:       # noqa: BLE001 -- tolerance contract above
        prof = None
        tw.error = f"profiler start failed: {e}"
        log.warning(f"trace_window: {tw.error}")
    if prof is not None:
        profiling._tracing += 1
    try:
        yield tw
    finally:
        if prof is not None:
            profiling._tracing -= 1
            try:
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                path = os.path.join(
                    trace_dir, f"trace_rank{network.current().rank}_"
                    f"{os.getpid()}{TRACE_SUFFIX}")
                prof.export_chrome_trace(path)
                tw.path = path
                tw.ok = True
            except Exception as e:   # noqa: BLE001
                tw.error = f"profiler stop failed: {e}"
                log.warning(f"trace_window: {tw.error}")


def trace_files(trace_dir: str) -> List[str]:
    """Trace files under a capture directory (the Chrome traces
    ``trace_window`` writes)."""
    out = []
    for root, _dirs, files in os.walk(trace_dir):
        for f in files:
            if f.endswith((TRACE_SUFFIX, ".json.gz")):
                out.append(os.path.join(root, f))
    return sorted(out)
