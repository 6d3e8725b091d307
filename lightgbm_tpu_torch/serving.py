"""The serving front end over the predict engine.

The port of lightgbm_tpu's ``serving.py``: what production traffic needs
above one predict call, the serve-side twin of the training plane's
watchdogs, degradation ladder and health snapshots.

- **Micro-batching with a flush deadline.** Concurrent small requests
  coalesce into one engine flush: the dispatcher thread flushes the queue
  ``serve_flush_ms`` after the first request arrives (or as soon as
  ``serve_max_batch_rows`` rows are queued), concatenates same-model
  requests in arrival order, predicts once (one ``predict_ensemble``
  launch on the card) and splits the result by row ranges. A row's
  traversal reads no other row, so a coalesced answer is bitwise the
  unbatched predict: batching is throughput, never a numerics knob.
- **Per-request deadlines.** A request not answered by its deadline raises
  a :class:`ServeTimeoutError` naming the phase it died in: ``queue-wait``
  (never dispatched; the batcher drops it without spending device time)
  or ``dispatch`` (the engine call itself overran).
- **Admission control.** A request that would push queued + in-flight rows
  past ``serve_max_queue_rows`` is refused at admission with a retriable
  :class:`ServeOverloadError`; shed episodes are recorded through
  ``distributed.record_degradation`` and show in ``health_snapshot()``.
- **A registry with validated hot swap.** Models are named and versioned;
  :meth:`ServeFrontend.swap` loads a candidate, checks it against the
  entry's pinned probe batch (the predict succeeds, which builds the
  engine and launches its kernel; the shape and class arity hold; every
  value is finite) and only then replaces the registry's pointer. On any
  failure the old model keeps serving and a :class:`ServeSwapError` says
  why. A request finishes on the version it was admitted under (a batch
  holds the entry, not the name).
- **Serve mode.** A registered trained booster predicts through its
  engine's serve slots (``GBDT.enable_serve_mode``,
  ``models/predict_engine.py``): per power-of-two row bucket, device
  buffers allocated once, so the serve loop allocates no device memory in
  the steady state. A file-loaded model predicts as the JAX one does, by
  the host tree walk.
- **Degradation, not death.** An allocation failure at serve time rides
  the predict-chunk rung of the OOM ladder
  (``GBDT._maybe_degrade_predict_oom``): the chunk shrinks, the event lands
  in ``health_snapshot()``, the request is retried; the training rungs are
  never spent.

The JAX frontend's ``_warm_serve_bucket`` and its ``compile_cache`` warmup
have no counterpart: nothing is compiled per shape here (the kernels are
built once, at first use), and the registration's probe predict builds
and launches the kernel; if that fails, registration raises (a swap,
``ServeSwapError``).

Health gauges (``utils/profiling.set_gauge``, always on, in
``distributed.health_snapshot()["serve"]``): ``serve_queue_rows``,
``serve_inflight_rows``, ``serve_shed_count``, ``serve_timeout_count``,
``serve_requests``, ``serve_batches``, ``serve_p50_ms``, ``serve_p99_ms``.

Metrics (``serve_metrics=True`` / ``metrics=True``): ``GET /metrics`` on
a daemon HTTP listener at ``serve_metrics_port`` (0: an ephemeral port;
:attr:`ServeFrontend.metrics_addr`) renders ``telemetry.prometheus_text()``
after mirroring the frontend's own counters into the gauges, so a scrape
never reads stale percentiles.

Fault drills (``utils/faults.py``, environment and config twins):
``LGBM_TPU_FAULT_SLOW_PREDICT_MS`` delays inside the predict call;
``LGBM_TPU_FAULT_OOM_AT_PREDICT`` raises a simulated allocation failure
from the next N predict calls.
"""

from __future__ import annotations

import copy
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np

from .utils import log, profiling

__all__ = ["ServeFrontend", "ServeTimeoutError", "ServeOverloadError",
           "ServeSwapError"]


class ServeTimeoutError(Exception):
    """A request missed its deadline. ``phase`` names where it died:
    ``"queue-wait"`` — never dispatched (the batcher dropped it without
    spending device time) — or ``"dispatch"`` — the engine call itself
    overran. Mirrors DistributedTimeoutError's diagnosable-message
    contract: model, version, row count, the deadline and the time
    actually waited, plus the queue state at the moment of death."""

    def __init__(self, *, phase: str, model: str, version: int, rows: int,
                 deadline_ms: float, waited_ms: float,
                 queued_rows: int = 0, inflight_rows: int = 0):
        self.phase = phase
        self.model = model
        self.version = version
        self.rows = rows
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms
        super().__init__(
            f"serve deadline ({deadline_ms:g} ms) exceeded in {phase}: "
            f"request of {rows} row(s) for model {model!r} v{version} "
            f"waited {waited_ms:.1f} ms "
            f"(queued {queued_rows} rows, in-flight {inflight_rows}). "
            f"The request was "
            + ("never dispatched — raise the deadline, shrink "
               "serve_flush_ms, or add capacity."
               if phase == "queue-wait" else
               "dispatched but the engine call overran — look for a slow "
               "dispatch (health_snapshot() serve gauges) or shrink the "
               "batch caps."))


class ServeOverloadError(Exception):
    """Admission control shed this request: accepting it would push
    queued + in-flight rows past ``serve_max_queue_rows``. RETRIABLE —
    the queue is full, not broken; back off and resend (``retriable`` is
    the attribute load balancers should branch on)."""

    retriable = True

    def __init__(self, *, model: str, rows: int, queued_rows: int,
                 inflight_rows: int, limit: int):
        self.model = model
        self.rows = rows
        self.queued_rows = queued_rows
        self.inflight_rows = inflight_rows
        self.limit = limit
        super().__init__(
            f"serve queue full: admitting {rows} row(s) for model "
            f"{model!r} would exceed serve_max_queue_rows={limit} "
            f"(queued {queued_rows} + in-flight {inflight_rows}). "
            f"Retriable — back off and resend.")


class ServeSwapError(Exception):
    """A hot-swap candidate failed load or smoke validation. The registry
    is untouched: the OLD version keeps serving (callers observe the
    failure, traffic never does)."""


class _Request:
    """One admitted predict request, owned by the caller thread until the
    dispatcher completes it (``event``). Phase transitions (queued ->
    dispatch) happen under the frontend lock; the caller reads ``phase``
    after a timed-out wait to name the phase it died in."""

    __slots__ = ("X", "rows", "raw_score", "entry", "deadline", "enqueue_t",
                 "event", "result", "error", "phase", "abandoned")

    def __init__(self, X, rows, raw_score, entry, deadline):
        self.X = X
        self.rows = rows
        self.raw_score = raw_score
        self.entry = entry
        self.deadline = deadline          # absolute monotonic, or None
        self.enqueue_t = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.phase = "queued"
        self.abandoned = False            # caller gave up (deadline)


class _ModelEntry:
    """One registered (name, version): the booster, its pinned probe batch
    and the validated output arity. Immutable after registration — a swap
    installs a NEW entry, so in-flight batches holding the old reference
    complete on the version they were admitted under."""

    __slots__ = ("name", "version", "booster", "probe", "arity")

    def __init__(self, name, version, booster, probe, arity):
        self.name = name
        self.version = version
        self.booster = booster
        self.probe = probe
        self.arity = arity


def _clone_exc(e: BaseException) -> BaseException:
    """Shallow-copy an exception so each of a coalesced batch's caller
    threads re-raises its own instance (falling back to the shared one
    for exceptions copy.copy cannot handle)."""
    try:
        c = copy.copy(e)
        c.__cause__ = e.__cause__
        return c
    except Exception:
        return e


def _as_request_matrix(X) -> np.ndarray:
    """Canonical request payload: a C-contiguous float64 [n, F] matrix.
    Coalescing concatenates payloads, so every request must carry the
    SAME dtype the unbatched predict would see (float64, what a float64
    matrix bins as): batched == unbatched, bit for bit."""
    if hasattr(X, "dtypes") or hasattr(X, "toarray"):
        raise TypeError(
            "ServeFrontend.predict takes dense numeric arrays; convert "
            "pandas/sparse inputs on the client (Booster.predict still "
            "accepts them directly)")
    X = np.ascontiguousarray(np.asarray(X, np.float64))
    if X.ndim == 1:
        X = X.reshape(1, -1)
    if X.ndim != 2 or X.shape[0] == 0:
        raise ValueError(f"expected a non-empty [n, F] matrix, got shape "
                         f"{X.shape}")
    return X


class ServeFrontend:
    """Deadline-aware micro-batching serving front end (module docstring
    has the full model).

    >>> fe = ServeFrontend(booster)                  # registers "default"
    >>> out = fe.predict(X_batch, deadline_ms=50.0)
    >>> fe.swap("default", "model_v2.txt")           # validated hot swap
    >>> fe.close()

    Thread-safe: ``predict`` may be called from any number of caller
    threads; a single dispatcher thread owns batching and the engine's
    serve slots. Batching policy comes from the ``serve_*``
    params (keyword overrides win, then the first registered booster's
    config, then the dataclass defaults)."""

    def __init__(self, model=None, *, name: str = "default",
                 probe: Optional[np.ndarray] = None,
                 flush_ms: Optional[float] = None,
                 max_batch_rows: Optional[int] = None,
                 max_queue_rows: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 metrics: Optional[bool] = None,
                 metrics_port: Optional[int] = None):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._queued_rows = 0
        self._inflight_rows = 0
        self._registry: Dict[str, _ModelEntry] = {}
        self._policy_name: Optional[str] = None   # first-registered model
        self._next_version: Dict[str, int] = {}
        self._closing = False
        self._requests = 0
        self._batches = 0
        self._shed_count = 0
        self._timeout_count = 0
        self._lat_ms: deque = deque(maxlen=2048)   # completed-request ring
        self._lat_gauge_t = 0.0                    # last percentile refresh
        self._shed_episode: Optional[dict] = None
        self._last_shed_t = 0.0
        # coerce overrides NOW: a malformed knob must fail the
        # constructor, not poison the dispatcher thread later
        self._flush_ms = None if flush_ms is None else float(flush_ms)
        self._max_batch_rows = None if max_batch_rows is None \
            else int(max_batch_rows)
        self._max_queue_rows = None if max_queue_rows is None \
            else int(max_queue_rows)
        self._default_deadline_ms = None if default_deadline_ms is None \
            else float(default_deadline_ms)
        self._metrics = None if metrics is None else bool(metrics)
        self._metrics_port = None if metrics_port is None \
            else int(metrics_port)
        self._metrics_server = None
        self._metrics_thread: Optional[threading.Thread] = None
        self._thread = threading.Thread(
            target=self._run, name="lgbm-tpu-serve-dispatch", daemon=True)
        self._thread.start()
        if model is not None:
            try:
                self.register(name, model, probe=probe)
            except BaseException:
                # a failed constructor must not leak the dispatcher
                # thread (the thread's bound-method target keeps self
                # alive, so __del__ would never run it down)
                self.close()
                raise

    # ------------------------------------------------------------ registry
    def _load(self, model):
        from .booster import Booster
        if isinstance(model, str):
            try:
                return Booster(model_file=model)
            except Exception as e:
                raise ServeSwapError(
                    f"candidate model file {model!r} failed to load: "
                    f"{e}") from e
        if isinstance(model, Booster):
            return model
        raise TypeError(f"model must be a Booster or a model-file path, "
                        f"got {type(model).__name__}")

    def _policy(self, cfg_attr: str, override, default):
        """Serve knob resolution: explicit kwarg > the first-registered
        model's CURRENT config (swaps included) > dataclass default.
        Lock-free — called both from caller threads pre-lock and from the
        dispatcher while it holds the (non-reentrant) frontend lock, so
        it reads single atomic attribute/dict-get snapshots instead of
        iterating the registry."""
        if override is not None:
            return override
        name = self._policy_name
        entry = self._registry.get(name) if name is not None else None
        if entry is not None:
            return getattr(entry.booster.config, cfg_attr, default)
        return default

    @property
    def flush_s(self) -> float:
        return float(self._policy("serve_flush_ms", self._flush_ms,
                                  2.0)) / 1e3

    @property
    def max_batch_rows(self) -> int:
        return int(self._policy("serve_max_batch_rows",
                                self._max_batch_rows, 8192))

    @property
    def max_queue_rows(self) -> int:
        return int(self._policy("serve_max_queue_rows",
                                self._max_queue_rows, 65536))

    @property
    def default_deadline_ms(self) -> float:
        return float(self._policy("serve_deadline_ms",
                                  self._default_deadline_ms, 0.0))

    @property
    def metrics_enabled(self) -> bool:
        return bool(self._policy("serve_metrics", self._metrics, False))

    @property
    def metrics_port(self) -> int:
        return int(self._policy("serve_metrics_port", self._metrics_port,
                                0))

    @property
    def metrics_host(self) -> str:
        return str(self._policy("serve_metrics_host", None, "127.0.0.1"))

    def _validate(self, booster, probe: np.ndarray,
                  expect_arity: Optional[int] = None) -> int:
        """Smoke-validate a candidate against the pinned probe batch: the
        predict must SUCCEED (which builds the engine and launches its
        kernel: a model whose kernel cannot build or launch is caught
        here, not by live traffic), return
        one row per probe row with the expected class arity, and every
        value must be finite. Returns the arity."""
        try:
            out = np.asarray(booster.predict(probe, raw_score=True))
        except ServeSwapError:
            raise
        except Exception as e:
            raise ServeSwapError(
                f"candidate failed to predict the probe batch "
                f"({type(e).__name__}: {e})") from e
        if out.shape[0] != probe.shape[0]:
            raise ServeSwapError(
                f"candidate probe output has {out.shape[0]} rows for a "
                f"{probe.shape[0]}-row probe (shape {out.shape})")
        arity = 1 if out.ndim == 1 else int(out.shape[1])
        if expect_arity is not None and arity != expect_arity:
            raise ServeSwapError(
                f"candidate predicts {arity} value(s) per row where the "
                f"serving version predicts {expect_arity} — class arity "
                f"is part of the serving contract")
        if not np.all(np.isfinite(out)):
            bad = int(np.size(out) - np.isfinite(out).sum())
            raise ServeSwapError(
                f"candidate probe output contains {bad} non-finite "
                f"value(s) — refusing to serve NaN/Inf")
        return arity

    def register(self, name: str, model, *,
                 probe: Optional[np.ndarray] = None) -> int:
        """Register (or replace, validated) a named model. ``probe``: the
        pinned smoke-validation batch every later :meth:`swap` candidate
        is judged against; defaults to the first rows the model was
        trained to see (an all-zeros [4, num_feature] matrix when the
        feature count is discoverable). Returns the installed version."""
        booster = self._load(model)
        existing = self._registry.get(name)
        if probe is None:
            if existing is not None:
                probe = existing.probe
            else:
                nf = int(booster.num_feature())
                probe = np.zeros((4, nf), np.float64)
        probe = _as_request_matrix(probe)
        arity = self._validate(booster, probe)
        if existing is not None and arity != existing.arity:
            # register() is the UNGUARDED replace path (swap() enforces
            # same-arity): changing the serving contract is allowed here
            # but must never be silent
            log.warning(f"serve: re-registering {name!r} changes the "
                        f"class arity {existing.arity} -> {arity} (use "
                        f"swap() for a contract-preserving reload)")
        gb = getattr(booster, "_boosting", None)
        if gb is not None and hasattr(gb, "enable_serve_mode"):
            gb.enable_serve_mode(True)
        with self._lock:
            version = self._next_version.get(name, 0) + 1
            self._next_version[name] = version
            self._registry[name] = _ModelEntry(name, version, booster,
                                               probe, arity)
            if self._policy_name is None:
                self._policy_name = name
        profiling.set_gauge("serve_models", float(len(self._registry)))
        # metrics endpoint policy resolves through the registered
        # booster's config — (re)check it now that one exists. Best
        # effort: the model is already committed to the registry, and a
        # bind failure (port in use by another frontend, a stale
        # listener) must not turn a successful registration into an
        # error — explicit start_metrics_server() calls still raise
        if self.metrics_enabled:
            try:
                self.start_metrics_server()
            except Exception as e:
                log.warning(f"serve: metrics endpoint failed to start "
                            f"(continuing without it): {e}")
        log.info(f"serve: registered model {name!r} v{version} "
                 f"(arity {arity}, probe {probe.shape[0]} rows)")
        return version

    def swap(self, name: str, model, *,
             probe: Optional[np.ndarray] = None) -> int:
        """Validated hot swap: load the candidate, smoke-validate it
        against the pinned probe (same class arity required), then
        atomically replace the registry entry. On ANY failure the old
        version keeps serving and a ServeSwapError is raised (the event
        is also recorded in health_snapshot()'s degradation log).
        Requests already admitted complete on the old version; requests
        admitted after the return serve the new one. Returns the new
        version number."""
        with self._lock:
            old = self._registry.get(name)
        if old is None:
            raise KeyError(f"unknown model {name!r}; register() it first")
        try:
            booster = self._load(model)
            use_probe = _as_request_matrix(probe) if probe is not None \
                else old.probe
            self._validate(booster, use_probe, expect_arity=old.arity)
        except Exception as e:
            # ANY candidate failure — load, probe conversion, validation —
            # honors the contract: the registry is untouched, the event is
            # recorded, and the caller sees a ServeSwapError
            from . import distributed
            distributed.record_degradation({
                "kind": "serve_swap_rejected", "model": name,
                "serving_version": old.version, "error": str(e)[:200]})
            profiling.inc_gauge("serve_swap_rejected")
            log.warning(f"serve: hot-swap candidate for {name!r} REJECTED "
                        f"(v{old.version} keeps serving): {e}")
            if isinstance(e, ServeSwapError):
                raise
            raise ServeSwapError(
                f"candidate for {name!r} rejected "
                f"({type(e).__name__}: {e})") from e
        gb = getattr(booster, "_boosting", None)
        if gb is not None and hasattr(gb, "enable_serve_mode"):
            gb.enable_serve_mode(True)
        with self._lock:
            version = self._next_version.get(name, 0) + 1
            self._next_version[name] = version
            self._registry[name] = _ModelEntry(name, version, booster,
                                               use_probe, old.arity)
            still_serving = any(e.booster is old.booster
                                for e in self._registry.values())
        if not still_serving:
            # the swapped-OUT booster leaves serve mode: a user-held
            # reference to the old model must not keep pinning per-bucket
            # device buffers (in-flight batches on the old entry still
            # complete: the ordinary path is bitwise the same)
            gb = getattr(old.booster, "_boosting", None)
            if gb is not None and hasattr(gb, "enable_serve_mode"):
                gb.enable_serve_mode(False)
        profiling.set_gauge(f"serve_version_{name}", float(version))
        log.info(f"serve: model {name!r} hot-swapped "
                 f"v{old.version} -> v{version}")
        return version

    def version(self, name: str = "default") -> int:
        with self._lock:
            entry = self._registry.get(name)
        if entry is None:
            raise KeyError(f"unknown model {name!r}")
        return entry.version

    # ------------------------------------------------------------ predict
    def predict(self, X, model: str = "default", *,
                raw_score: bool = False,
                deadline_ms: Optional[float] = None) -> np.ndarray:
        """Blocking predict through the micro-batcher. Bit-identical to
        ``booster.predict(X, raw_score=...)`` on the registered model —
        coalescing never changes bits. Raises ServeOverloadError (shed at
        admission, retriable), ServeTimeoutError (deadline exceeded,
        ``.phase`` names queue-wait vs dispatch), or re-raises the
        dispatch error for this request's batch."""
        X = _as_request_matrix(X)
        rows = int(X.shape[0])
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline_ms = float(deadline_ms or 0.0)
        now = time.monotonic()
        deadline = (now + deadline_ms / 1e3) if deadline_ms > 0 else None
        with self._lock:
            if self._closing:
                raise RuntimeError("ServeFrontend is closed")
            entry = self._registry.get(model)
            if entry is None:
                raise KeyError(f"unknown model {model!r}; register() it "
                               f"first")
            total = self._queued_rows + self._inflight_rows
            limit = self.max_queue_rows
            # an oversized LONE request (rows > limit on an idle frontend)
            # still admits — like the batch-row cap, the head always ships
            # and the engine chunks internally; shedding it "retriable"
            # would never come true
            if total + rows > limit and not (total == 0 and rows > limit):
                self._record_shed(model, rows, limit)
                raise ServeOverloadError(
                    model=model, rows=rows, queued_rows=self._queued_rows,
                    inflight_rows=self._inflight_rows, limit=limit)
            req = _Request(X, rows, bool(raw_score), entry, deadline)
            self._queue.append(req)
            self._queued_rows += rows
            self._requests += 1
            profiling.set_gauge("serve_queue_rows",
                                float(self._queued_rows))
            profiling.set_gauge("serve_requests", float(self._requests))
            self._cond.notify()
        remaining = None if deadline is None else max(deadline - now, 0.0)
        completed = req.event.wait(remaining)
        if completed:
            if req.error is not None:
                if isinstance(req.error, ServeTimeoutError):
                    # dropped by the dispatcher at flush time (deadline
                    # already past): count it here, where it surfaces
                    with self._lock:
                        self._timeout_count += 1
                    profiling.inc_gauge("serve_timeout_count")
                raise req.error
            self._note_latency(req)
            return req.result
        # deadline expired before completion: name the phase it died in
        with self._lock:
            if req.event.is_set():          # completion raced the timeout
                pass
            else:
                req.abandoned = True
                if req.phase == "queued":
                    # still queued: remove it so the batcher never pays
                    # for a dead request
                    try:
                        self._queue.remove(req)
                        self._queued_rows -= rows
                        profiling.set_gauge("serve_queue_rows",
                                            float(self._queued_rows))
                    except ValueError:
                        pass
            phase = req.phase
            queued, inflight = self._queued_rows, self._inflight_rows
        if req.event.is_set():
            if req.error is None:
                self._note_latency(req)
                return req.result
            if not isinstance(req.error, ServeTimeoutError):
                # completion raced the deadline with a REAL dispatch
                # error (e.g. an exhausted OOM ladder): surface the root
                # cause — reporting it as a timeout would send the
                # operator chasing latency instead of memory
                raise req.error
        with self._lock:
            self._timeout_count += 1
        profiling.inc_gauge("serve_timeout_count")
        raise ServeTimeoutError(
            phase=("dispatch" if phase == "dispatch" else "queue-wait"),
            model=entry.name, version=entry.version, rows=rows,
            deadline_ms=deadline_ms,
            waited_ms=(time.monotonic() - req.enqueue_t) * 1e3,
            queued_rows=queued, inflight_rows=inflight)

    # -------------------------------------------------------- shed events
    def _record_shed(self, model: str, rows: int, limit: int) -> None:
        """Count a shed and record the overload in health_snapshot().
        Degradation events are recorded per EPISODE (a burst of sheds
        separated by <5 s quiet updates one event's count in place) so a
        sustained overload can't grow the process degradation log without
        bound."""
        from . import distributed
        self._shed_count += 1
        profiling.inc_gauge("serve_shed_count")
        now = time.monotonic()
        if self._shed_episode is None or now - self._last_shed_t > 5.0 \
                or self._shed_episode["model"] != model:
            # a new episode per model too: folding model B's sheds into
            # A's event would hide B's overload from the log entirely
            # keep the STORED dict (record_degradation copies its input)
            # so the in-place episode updates below reach the log
            self._shed_episode = distributed.record_degradation({
                "kind": "serve_shed", "model": model, "count": 1,
                "queued_rows": int(self._queued_rows),
                "inflight_rows": int(self._inflight_rows),
                "limit": int(limit)})
        else:
            # recorded dict updated in place: one episode, one log entry
            self._shed_episode["count"] += 1
            self._shed_episode["queued_rows"] = int(self._queued_rows)
        self._last_shed_t = now

    def _note_latency(self, req: _Request) -> None:
        """Record a completed request's latency and refresh the percentile
        gauges. Ring append and snapshot both run under the frontend lock —
        caller threads complete concurrently, and an unlocked np.fromiter
        over the deque races appends (deque mutated during iteration)."""
        dt = (time.monotonic() - req.enqueue_t) * 1e3
        now = time.monotonic()
        with self._lock:
            self._lat_ms.append(dt)
            # gauge refresh is throttled: rebuilding the 2048-entry ring
            # + two percentile sorts per completed request would tax the
            # hot path just to update telemetry (stats() computes fresh
            # percentiles on demand either way)
            if len(self._lat_ms) > 16 and now - self._lat_gauge_t < 0.25:
                return
            self._lat_gauge_t = now
            lat = np.fromiter(self._lat_ms, dtype=np.float64)
        profiling.set_gauge("serve_p50_ms", float(np.percentile(lat, 50)))
        profiling.set_gauge("serve_p99_ms", float(np.percentile(lat, 99)))

    # ---------------------------------------------------------- dispatcher
    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._closing and not self._queue:
                    # untimed: every state change this waits for
                    # (admission, close) notifies the condition — an idle
                    # frontend costs zero wakeups
                    self._cond.wait()
                if self._closing and not self._queue:
                    return
                head = self._queue[0]
                try:
                    flush_at = head.enqueue_t + self.flush_s
                    cap = self.max_batch_rows
                except BaseException as e:  # noqa: BLE001 — relayed
                    # a poisoned policy knob (e.g. a registered booster
                    # whose config carries a non-numeric serve_flush_ms)
                    # must fail the head REQUEST, never kill the
                    # dispatcher thread
                    self._queue.popleft()
                    self._queued_rows -= head.rows
                    profiling.set_gauge("serve_queue_rows",
                                        float(self._queued_rows))
                    head.error = e
                    head.event.set()
                    continue
                now = time.monotonic()
                if now < flush_at and self._queued_rows < cap:
                    self._cond.wait(min(flush_at - now, 0.05))
                    continue
                batch = self._take_batch(cap)
                rows = sum(r.rows for r in batch)
                self._inflight_rows += rows
                profiling.set_gauge("serve_queue_rows",
                                    float(self._queued_rows))
                profiling.set_gauge("serve_inflight_rows",
                                    float(self._inflight_rows))
            try:
                self._dispatch(batch)
            except BaseException as e:       # noqa: BLE001 — relayed
                # _dispatch relays predict errors itself; anything that
                # escapes it (batch concatenate / result split) must not
                # kill the dispatcher thread — a dead dispatcher strands
                # every queued and future request forever
                first = True
                for req in batch:
                    if not req.event.is_set():
                        req.error = e if first else _clone_exc(e)
                        first = False
                        req.event.set()
            finally:
                with self._lock:
                    self._inflight_rows -= rows
                    self._batches += 1
                    profiling.set_gauge("serve_inflight_rows",
                                        float(self._inflight_rows))
                    profiling.set_gauge("serve_batches",
                                        float(self._batches))

    def _take_batch(self, cap: int) -> List[_Request]:
        """Pop the flush batch under the lock: same-(entry, raw_score,
        feature-width) requests as the queue head, in arrival order, up
        to ``cap`` rows (the head always ships, even oversized — the
        engine chunks internally). Non-matching requests keep their
        relative order for the next flush."""
        head = self._queue[0]
        key = (head.entry, head.raw_score, head.X.shape[1])
        batch: List[_Request] = []
        rows = 0
        full = False
        keep: deque = deque()
        while self._queue:
            req = self._queue.popleft()
            match = (req.entry, req.raw_score, req.X.shape[1]) == key
            if match and not full and (not batch
                                       or rows + req.rows <= cap):
                batch.append(req)
                rows += req.rows
                req.phase = "dispatch"
                self._queued_rows -= req.rows
            else:
                if match:
                    # cap reached: later same-key requests must NOT jump
                    # this one (FIFO within a key)
                    full = True
                keep.append(req)
        self._queue = keep
        return batch

    def _queue_wait_timeout(self, req: _Request,
                            now: float) -> ServeTimeoutError:
        """The dispatcher-side queue-wait drop error: a dead request
        found at flush time was never dispatched, and its caller must
        see (or already saw) a deadline timeout naming that phase."""
        return ServeTimeoutError(
            phase="queue-wait", model=req.entry.name,
            version=req.entry.version, rows=req.rows,
            deadline_ms=0.0 if req.deadline is None else
            (req.deadline - req.enqueue_t) * 1e3,
            waited_ms=(now - req.enqueue_t) * 1e3,
            queued_rows=self._queued_rows,
            inflight_rows=self._inflight_rows)

    def _dispatch(self, batch: List[_Request]) -> None:
        """One coalesced engine dispatch (dispatcher thread only). Dead
        requests (abandoned or past deadline) are dropped BEFORE the
        predict so the device never works for a caller that stopped
        listening."""
        now = time.monotonic()
        live: List[_Request] = []
        for req in batch:
            if req.abandoned:
                # the caller timed out (usually it has already raised) —
                # but in the narrow race where its post-wait re-check sees
                # our event first, it must find a timeout ERROR, never a
                # None "result"
                req.error = self._queue_wait_timeout(req, now)
                req.event.set()
            elif req.deadline is not None and now >= req.deadline:
                # dispatcher-side queue-wait shed: the caller's wait will
                # wake to the error (phase stays pre-dispatch semantics)
                req.phase = "queued"
                req.error = self._queue_wait_timeout(req, now)
                req.event.set()
            else:
                live.append(req)
        if not live:
            return
        entry = live[0].entry
        raw = live[0].raw_score
        X = live[0].X if len(live) == 1 else \
            np.concatenate([r.X for r in live], axis=0)
        try:
            out = entry.booster.predict(X, raw_score=raw)
        except BaseException as e:          # noqa: BLE001 — relayed
            for i, req in enumerate(live):
                # each caller re-raises its OWN instance: N threads
                # raising one shared exception object race on its
                # __traceback__/__context__ mutation
                req.error = e if i == 0 else _clone_exc(e)
                req.event.set()
            return
        out = np.asarray(out)
        off = 0
        for req in live:
            # copy, not slice: a contiguous row slice is a VIEW keeping
            # the whole coalesced batch output alive in every caller
            # that retains its (possibly 1-row) result
            req.result = out[off:off + req.rows].copy()
            off += req.rows
            req.phase = "done"
            req.event.set()

    # ------------------------------------------------------------ metrics
    def metrics_text(self) -> str:
        """The Prometheus-style exposition of :func:`telemetry.snapshot`
        — what ``GET /metrics`` serves. Mirrors the frontend's
        AUTHORITATIVE counters (requests/batches/shed/timeouts/latency
        percentiles, computed under the frontend lock) into the serve_*
        gauges first, so a scrape never reads the throttled refresh's
        stale percentiles."""
        from . import telemetry
        st = self.stats()
        profiling.set_gauge("serve_requests", float(st["requests"]))
        profiling.set_gauge("serve_batches", float(st["batches"]))
        profiling.set_gauge("serve_shed_count", float(st["shed"]))
        profiling.set_gauge("serve_timeout_count", float(st["timeouts"]))
        profiling.set_gauge("serve_queue_rows", float(st["queued_rows"]))
        profiling.set_gauge("serve_inflight_rows",
                            float(st["inflight_rows"]))
        if "p50_ms" in st:
            profiling.set_gauge("serve_p50_ms", st["p50_ms"])
            profiling.set_gauge("serve_p99_ms", st["p99_ms"])
        return telemetry.prometheus_text()

    def start_metrics_server(self, port: Optional[int] = None,
                             host: Optional[str] = None) -> str:
        """Start (idempotently) the daemon HTTP listener serving
        ``GET /metrics`` and return its ``host:port`` address. ``port``/
        ``host`` override the ``serve_metrics_port``/``serve_metrics_host``
        policies (0 = ephemeral port; the default host is LOOPBACK — the
        exposition has no auth, so off-host scraping requires opting in
        with ``serve_metrics_host="0.0.0.0"`` or an interface address)."""
        with self._lock:
            if self._metrics_server is not None:
                return self.metrics_addr
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        frontend = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 — http.server API
                if self.path.split("?", 1)[0].rstrip("/") \
                        not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    body = frontend.metrics_text().encode()
                    status = 200
                except Exception as e:
                    # the scrape must not kill the server, but a broken
                    # exposition must read as a FAILED scrape (500), not
                    # a successful empty one — up==1 with every series
                    # silently stale would defeat scrape alerting
                    body = f"# metrics render failed: {e}\n".encode()
                    status = 500
                self.send_response(status)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not log events
                pass

        srv = ThreadingHTTPServer(
            (self.metrics_host if host is None else str(host),
             int(self.metrics_port if port is None else port)),
            _Handler)
        srv.daemon_threads = True
        thread = threading.Thread(target=srv.serve_forever,
                                  name="lgbm-tpu-serve-metrics", daemon=True)
        with self._lock:
            if self._metrics_server is not None:   # lost the race
                srv.server_close()
                return self.metrics_addr
            self._metrics_server = srv
            self._metrics_thread = thread
        thread.start()
        addr = self.metrics_addr
        log.info(f"serve: metrics endpoint at http://{addr}/metrics")
        return addr

    @property
    def metrics_addr(self) -> Optional[str]:
        """``host:port`` of the live metrics listener (None when off)."""
        srv = self._metrics_server
        if srv is None:
            return None
        host, port = srv.server_address[:2]
        return f"{host}:{port}"

    # ------------------------------------------------------------- status
    def stats(self) -> dict:
        """Frontend counters (authoritative; the serve_* gauges mirror
        them into health_snapshot())."""
        with self._lock:
            lat = list(self._lat_ms)
            out = {
                "requests": self._requests,
                "batches": self._batches,
                "shed": self._shed_count,
                "timeouts": self._timeout_count,
                "queued_rows": self._queued_rows,
                "inflight_rows": self._inflight_rows,
                "models": {n: e.version
                           for n, e in self._registry.items()},
            }
        if lat:
            arr = np.asarray(lat)
            out["p50_ms"] = float(np.percentile(arr, 50))
            out["p99_ms"] = float(np.percentile(arr, 99))
        return out

    # ------------------------------------------------------------ shutdown
    def close(self) -> None:
        """Stop the dispatcher. Queued requests still flush (their callers
        are waiting); new admissions fail."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            self._cond.notify_all()
            srv, self._metrics_server = self._metrics_server, None
            mthread, self._metrics_thread = self._metrics_thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            if mthread is not None:
                mthread.join(timeout=10.0)
        self._thread.join(timeout=30.0)
        # release serve resources: a closed frontend must not leave its
        # boosters pinning per-bucket device buffers or routing later
        # direct predicts through the (now pointless) serve path
        with self._lock:
            entries = list(self._registry.values())
        for entry in entries:
            gb = getattr(entry.booster, "_boosting", None)
            if gb is not None and hasattr(gb, "enable_serve_mode"):
                gb.enable_serve_mode(False)

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        # NOTE: there is deliberately no __del__ — the dispatcher
        # thread's bound-method target keeps the frontend alive, so
        # finalizer-based cleanup can never run while the thread does.
        # Owners must close() (or use the context manager).
