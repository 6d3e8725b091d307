"""Process-level distributed state: the gang, its front end and supervision.

The port of lightgbm_tpu's ``distributed.py``, in three parts.

The multi-process front end of the distributed learners (``tree_learner``
data, feature or voting; ROADMAP Queue 1 item 15):

- ``init(machines=, num_machines=, local_listen_port=, time_out=,
  params=)`` joins this process to a gang: its rank from the machine list
  (the local-IP match of the reference's linkers, ``_rank_from_machines``,
  ``local_listen_port`` telling apart several processes of one host; or
  ``machine_list_filename``), or from torchrun's ``RANK`` / ``WORLD_SIZE``
  / ``MASTER_ADDR`` / ``MASTER_PORT``; ``time_out`` (minutes, the
  reference's) is the group's timeout. The first machine entry hosts the
  gang's ``TCPStore``. The rank's device is ``cuda:(local_rank mod
  device_count)``, or the CPU with ``device_type="cpu"``; the collective
  backend is chosen once from the ranks' devices (``network.choose_backend``:
  NCCL with a card per rank, else gloo) and logged. ``is_initialized``,
  ``shutdown``, ``maybe_init_from_config`` (the Booster's, with
  ``num_machines`` > 1), a real ``barrier``, ``exchange_host`` over the
  gang's store and ``allgather_f64`` complete it;
- ``spawn(fn, nproc, args)`` runs ``fn(rank, *args)`` in ``nproc`` fresh
  local processes joined into one gang and returns rank 0's result (a
  rank that fails fails the gang, reported with its exit code and the tail
  of its output); ``train_distributed(params, parts, num_boost_round)``
  trains one pre-partitioned part a process through it;
  ``load_partitioned`` builds a rank's pre-partitioned Dataset: bin
  mappers fitted from an allgathered row sample, so every rank holds the
  same ones, and only the rank's own rows binned; ``repartition_rows``
  reassembles a rank's rows from shards written under another partition
  (the load half of resuming at another world size, ``checkpoint.py``).

Training supervision, the detection half of the gang supervisor
(``supervisor.py`` holds the restart half): ``notify_step_begin`` /
``notify_step_end`` / ``notify_step_retry`` keep this process's progress
(``_Progress``: a stack of open phases and the last completed iteration),
``watchdog_phase`` marks a collective phase (``barrier`` and
``exchange_host`` run inside one); ``HeartbeatMonitor`` reports every
rank's progress to rank 0 over a TCP side channel in plain sockets and
hands the table back, and ``CollectiveWatchdog`` judges the open phase
against ``collective_deadline``: past it, the rank writes a JSON
diagnosis naming the suspect rank(s) and the last completed iteration,
then exits with ``WATCHDOG_EXIT_CODE`` when supervised, or raises
``DistributedTimeoutError`` in the main thread. ``start_health`` starts
both from a config; ``health_snapshot`` (every checkpoint manifest
carries it) and ``heartbeat_ages`` read them, beside the OOM ladder's
degradation log (``record_degradation`` / ``degradations`` /
``reset_degradations``).

The watchdog's thread takes the GIL while the main thread waits inside a
gloo collective or a store read (both release it), so a rank blocked
behind a hung peer still exits. Ordering of the timeouts: the watchdog
must fire before torch's own. The group's timeout is ``time_out``
minutes (120 by default) and ``start_health`` refuses a
``collective_deadline`` that is not below half of it; ``exchange_host``
waits on the store for twice the deadline. Under NCCL the communicator's
watchdog (``TORCH_NCCL_ASYNC_ERROR_HANDLING``) aborts a collective only
at the group's timeout, so the same ordering holds; that ordering has not
been run, for want of a machine with two cards.

Training integrity: ``check_model_integrity`` exchanges every rank's
``model_fingerprint`` (a hash of the trees and of the float32 score cache
over the rank's rows) over the store each ``integrity_check_period``
iterations, and ``divergence_verdict`` majority-votes a mismatch: a
supervised minority rank exits with ``DIVERGENCE_EXIT_CODE``, an
unsupervised gang raises ``RankDivergenceError`` on every rank.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import network
from .utils import log, profiling

# exit code of a supervised rank whose collective watchdog fired: apart
# from the fault harness's 137, so the supervisor can tell "rank died"
# from "rank declared the gang stalled"
WATCHDOG_EXIT_CODE = 97

# exit code of a spawned child that could not come up (before the gang's
# init): the supervisor classifies the rank permanently lost and shrinks
# the gang
SPAWN_FAIL_EXIT_CODE = 96

# exit code of a supervised rank the integrity vote names as the minority
# whose state diverged: the supervisor charges that rank's restart budget
# and restarts the gang from the last valid checkpoint, or shrinks the
# rank away once the budget is spent
DIVERGENCE_EXIT_CODE = 95

# the supervisor's environment, read by its children (the JAX package's
# names)
_SUPERVISED_ENV = "LGBM_TPU_SUPERVISED"
_HEARTBEAT_ADDR_ENV = "LGBM_TPU_HEARTBEAT_ADDR"
_DIAG_DIR_ENV = "LGBM_TPU_DIAG_DIR"
_RESTART_COUNT_ENV = "LGBM_TPU_RESTART_COUNT"

_last_diagnosis: Optional[dict] = None


class DistributedTimeoutError(Exception):
    """A collective (boosting step or barrier) exceeded the configured
    ``collective_deadline``. Carries the diagnosing rank, the last
    completed iteration and the suspect rank(s) the heartbeat table
    implicates. Constructed without arguments by the watchdog's
    asynchronous raise, the message then comes from the last diagnosis."""

    def __init__(self, *args, rank=None, iteration=None, suspects=None,
                 phase=None):
        diag = _last_diagnosis or {}
        self.rank = rank if rank is not None else diag.get("rank")
        self.iteration = iteration if iteration is not None \
            else diag.get("iteration")
        self.suspects = suspects if suspects is not None \
            else diag.get("suspects")
        self.phase = phase if phase is not None else diag.get("phase")
        if not args:
            args = (format_timeout_message(self.rank, self.iteration,
                                           self.suspects, self.phase,
                                           diag.get("deadline")),)
        super().__init__(*args)


def format_timeout_message(rank, iteration, suspects, phase,
                           deadline) -> str:
    """The JAX package's diagnosis, word for word."""
    if suspects:
        sus = "rank(s) " + ", ".join(str(s) for s in suspects)
    elif suspects is not None:
        sus = "none identified (heartbeat table shows all ranks current)"
    else:
        sus = "unknown rank (no heartbeat table)"
    return (f"collective deadline"
            + (f" ({deadline:g}s)" if deadline else "")
            + f" exceeded on rank {rank} in {phase or 'step'}: "
            f"last completed iteration {iteration}; suspect {sus}. "
            f"The gang is stalled — restart it from the latest checkpoint "
            f"(lightgbm_tpu.supervisor does this automatically).")


class _Progress:
    """This process's training progress, which the heartbeat reports and
    the watchdog judges: a stack of open phases (step, barrier, exchange)
    and the last completed boosting iteration."""

    def __init__(self):
        self.lock = threading.Lock()
        self.last_iter = -1            # last completed boosting iteration
        self.step_iter = -1            # iteration inside a step now
        self.steps_done = 0            # steps completed in this process:
        #   the warm-up exemptions' clock (last_iter is the global
        #   iteration and starts at k on a resumed incarnation)
        self.phases = []               # [(label, start monotonic)]
        self.last_transition = None    # monotonic time of the last begin/end

    def reset(self) -> None:
        """A fresh training run: the first-step exemption applies again."""
        with self.lock:
            self.last_iter = -1
            self.step_iter = -1
            self.steps_done = 0
            self.phases = []
            self.last_transition = None

    def begin(self, label: str, iteration: Optional[int] = None) -> None:
        with self.lock:
            now = time.monotonic()
            self.phases.append((label, now))
            self.last_transition = now
            if iteration is not None:
                self.step_iter = iteration

    def end(self, iteration: Optional[int] = None) -> None:
        with self.lock:
            if self.phases:
                self.phases.pop()
            self.last_transition = time.monotonic()
            if iteration is not None:
                if iteration > self.last_iter:
                    self.steps_done += 1
                self.last_iter = iteration
                if not self.phases:
                    self.step_iter = -1

    def snapshot(self) -> dict:
        with self.lock:
            now = time.monotonic()
            top = self.phases[-1] if self.phases else None
            return {"iter": self.last_iter, "step": self.step_iter,
                    "steps_done": self.steps_done,
                    "phase": top[0] if top else None,
                    "phase_elapsed": (now - top[1]) if top else 0.0,
                    "idle_elapsed": (now - self.last_transition)
                    if self.last_transition is not None else 0.0}


_progress = _Progress()
_lock = threading.Lock()
# degradation events this process recorded (models/gbdt.py
# _maybe_degrade_oom and _maybe_degrade_predict_oom), surfaced through
# health_snapshot() and so through every later checkpoint manifest
_degradations: List[dict] = []


def notify_step_begin(iteration: int, label: str = "step") -> None:
    """The training loop entered boosting iteration ``iteration`` (the
    watchdog's clock starts; the heartbeat reports it in flight)."""
    _progress.begin(f"{label}:{iteration}", iteration)


def notify_step_end(iteration: int) -> None:
    """Boosting iteration ``iteration`` completed (on a failed step, the
    caller passes the one before)."""
    _progress.end(iteration)


def notify_step_retry(iteration: int) -> None:
    """Re-arm the step clock for an iteration the OOM ladder retries: the
    failed attempt's time is not charged to the retry, and the
    ``step-retry:`` phase has the first step's exemption (the ladder runs
    in one process only, so no peer waits behind it). The counters stay:
    the iteration did not complete."""
    _progress.end()
    _progress.begin(f"step-retry:{iteration}", iteration)


class watchdog_phase:
    """Context manager marking a collective phase other than a step
    (barriers, exchanges), so the watchdog times it too. Reentrant; a few
    list operations when no watchdog is armed."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        _progress.begin(self.label)
        return self

    def __exit__(self, *exc):
        _progress.end()
        return False


def record_degradation(event: dict) -> dict:
    """Record one degradation event (kind, iteration, level, action,
    error); each stored event gains a wall and a monotonic timestamp and,
    without one, the last completed iteration. Returns the stored dict."""
    event = dict(event)
    with _lock:
        event["seq"] = len(_degradations)
        event.setdefault("t", time.time())
        event["t_mono"] = time.monotonic()
        event.setdefault("iteration", int(_progress.snapshot()["iter"]))
        _degradations.append(event)
        n_oom = sum(1 for d in _degradations if "oom" in d.get("kind", ""))
    profiling.set_gauge("oom_degradations", float(n_oom))
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
    profiling.set_gauge("oom_degradations", 0.0)


def health_snapshot() -> dict:
    """The restart count (from the supervisor's environment), this
    process's progress, the heartbeat table and the deadline when they are
    live, every degradation event, the serving layer's ``serve_*`` gauges
    (``serve``), the memory gauges the flight recorder samples
    (``memory``) and the flight recorder's path (``flight_recorder``): the
    supervision record of every checkpoint manifest."""
    snap = _progress.snapshot()
    out = {
        "restart_count": int(os.environ.get(_RESTART_COUNT_ENV, "0") or 0),
        "last_iteration": snap["iter"],
        "in_step_iteration": snap["step"],
    }
    h = _active_health
    if h is not None and h.heartbeat is not None:
        out["heartbeat"] = {str(r): {"iter": e.get("iter", -1),
                                     "step": e.get("step", -1),
                                     "age": e.get("age", -1.0)}
                            for r, e in h.heartbeat.table().items()}
        out["heartbeat_interval"] = h.heartbeat.interval
    if h is not None and h.watchdog is not None:
        out["collective_deadline"] = h.watchdog.deadline
    with _lock:
        if _degradations:
            out["degradations"] = list(_degradations)
    g = profiling.gauges()
    serve = {k: v for k, v in g.items() if k.startswith("serve_")}
    if serve:
        out["serve"] = serve
    mem = {k: int(v) for k, v in g.items()
           if k in ("hbm_bytes_in_use", "hbm_peak_bytes", "host_rss_bytes",
                    "host_rss_peak_bytes")}
    if mem:
        out["memory"] = mem
    from . import telemetry
    fr = telemetry.recorder_path()
    if fr:
        out["flight_recorder"] = fr
    return out


# ------------------------------------------------------- the gang front end
# the group's timeout (seconds) orders torch's own timeouts after the
# watchdog's deadline (start_health)
_gang = {"store": None, "pg": None, "timeout_s": None}


def is_initialized() -> bool:
    """Whether this process joined a gang (``init``)."""
    return _gang["pg"] is not None


def _local_addresses() -> set:
    addrs = {"127.0.0.1", "::1", "localhost", "0.0.0.0"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        for info in socket.getaddrinfo(hostname, None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return addrs


def _split_host_port(entry: str):
    """host[:port] -> (host, port string or None); [v6]:port and a bare
    IPv6 address (never split at its last hextet) included."""
    if entry.startswith("["):
        host, _, rest = entry[1:].partition("]")
        return host, (rest[1:] if rest.startswith(":") else None)
    if entry.count(":") > 1:
        return entry, None
    host, _, port = entry.partition(":")
    return host, (port or None)


def _entry_matches_local(host: str, local: set) -> bool:
    if host in local:
        return True
    # the reference compares resolved addresses (linkers_socket.cpp:38)
    try:
        return any(info[4][0] in local
                   for info in socket.getaddrinfo(host, None))
    except OSError:
        return False


def _rank_from_machines(machines: list,
                        listen_port: Optional[int] = None) -> Optional[int]:
    """This process's rank by local-IP match against the machine list (the
    reference's protocol, linkers_socket.cpp:38). With several entries of
    this host, ``listen_port`` (local_listen_port) picks the one whose port
    it is; an ambiguous match without it is fatal, never rank 0."""
    local = _local_addresses()
    parsed = [_split_host_port(m) for m in machines]
    matches = [i for i, (host, _port) in enumerate(parsed)
               if _entry_matches_local(host, local)]
    if listen_port is not None:
        exact = [i for i in matches if parsed[i][1] == str(listen_port)]
        if len(exact) == 1:
            return exact[0]
    if len(matches) > 1:
        log.fatal(f"multiple machines entries match this host "
                  f"({[machines[i] for i in matches]}); set "
                  f"local_listen_port or the rank to disambiguate")
    return matches[0] if matches else None


def _machine_list(machines, machine_list_filename: str = "") -> list:
    """The machine entries: the ``machines`` string (comma-separated
    host:port) or list, else the lines of ``machine_list_filename`` (one
    "host port" or "host:port" an entry, the reference's mlist file)."""
    if machines:
        if isinstance(machines, str):
            machines = machines.split(",")
        return [m.strip() for m in machines if str(m).strip()]
    if machine_list_filename:
        out = []
        with open(machine_list_filename) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if line:
                    parts = line.replace(":", " ").split()
                    out.append(":".join(parts[:2]))
        return out
    return []


def _param(params, key, default=None):
    if params is None:
        return default
    get = params.get if hasattr(params, "get") else \
        (lambda k, d=None: getattr(params, k, d))
    v = get(key, default)
    return default if v in (None, "") else v


def init(machines=None, num_machines: Optional[int] = None,
         local_listen_port: Optional[int] = None,
         time_out: Optional[float] = None, params=None,
         rank: Optional[int] = None, device=None,
         backend: Optional[str] = None) -> network.Network:
    """Join this process to a gang and make its network the process's
    (``network.current()``); idempotent while joined. Arguments absent
    here are read from ``params`` (a dict or Config: ``machines``,
    ``machine_list_filename``, ``num_machines``, ``local_listen_port``,
    ``time_out`` in minutes, ``device_type``); without a machine list,
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``). ``rank`` overrides the local-IP
    match, ``device`` the rank's device, ``backend`` ("nccl" or "gloo")
    the topology's choice (``network.choose_backend``). Returns the
    network."""
    import torch
    import torch.distributed as dist
    if is_initialized():
        log.warning("distributed.init called twice; keeping the gang")
        return network.current()
    mlist = _machine_list(machines or _param(params, "machines", ""),
                          _param(params, "machine_list_filename", ""))
    num_machines = int(num_machines or _param(params, "num_machines", 0)
                       or 0) or None
    if local_listen_port is None:
        lp = _param(params, "local_listen_port")
        local_listen_port = int(lp) if lp is not None else None
    if time_out is None:
        time_out = float(_param(params, "time_out", 120))
    env = os.environ
    local_rank = None
    if mlist:
        world = num_machines or len(mlist)
        if len(mlist) < world:
            log.fatal(f"num_machines={world} but the machine list has "
                      f"{len(mlist)} entries")
        mlist = mlist[:world]
        if rank is None:
            rank = _rank_from_machines(mlist, local_listen_port)
            if rank is None:
                log.fatal(f"none of this host's addresses match the "
                          f"machines list {mlist} (pass the rank)")
        host, port = _split_host_port(mlist[0])
        port = int(port or local_listen_port or 12400)
        mine = _split_host_port(mlist[rank])[0]
        local_rank = sum(1 for m in mlist[:rank]
                         if _split_host_port(m)[0] == mine)
    elif "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        rank = int(env["RANK"]) if rank is None else rank
        local_rank = int(env.get("LOCAL_RANK", rank))
        host = env.get("MASTER_ADDR", "127.0.0.1")
        port = int(env.get("MASTER_PORT", local_listen_port or 12400))
    else:
        log.fatal("distributed.init needs machines (or "
                  "machine_list_filename) or torchrun's environment")
    if device is None:
        dtype = str(_param(params, "device_type", "cuda"))
        if dtype == "cpu":
            device = "cpu"
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device_type='cuda' but no CUDA device is available "
                    "(pass device_type='cpu' to train on the CPU)")
            device = f"cuda:{local_rank % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=float(time_out) * 60.0)
    store = dist.TCPStore(host, port, world, is_master=(rank == 0),
                          timeout=timeout)
    # every rank's device, so the backend is chosen once from the topology
    store.set(f"device/{rank}", f"{socket.gethostname()}|{device}")
    devices = [store.get(f"device/{r}").decode() for r in range(world)]
    chosen, reason = network.choose_backend(devices, backend)
    dist.init_process_group(chosen, store=dist.PrefixStore("pg", store),
                            rank=rank, world_size=world, timeout=timeout)
    pg = dist.distributed_c10d._get_default_group()
    net = network.Network(pg, rank, world, device, chosen,
                          dist.PrefixStore("host", store), reason)
    _gang.update(store=store, pg=pg, timeout_s=timeout.total_seconds())
    network.set_process_network(net)
    network.log_choice(net)
    return net


def shutdown() -> None:
    """Leave the gang (``Booster.free_network``); the process trains alone
    afterwards."""
    import torch.distributed as dist
    if not is_initialized():
        return
    network.set_process_network(None)
    if dist.is_initialized():
        dist.destroy_process_group()
    _gang.update(store=None, pg=None, timeout_s=None)


def maybe_init_from_config(config) -> None:
    """Join the gang a Booster's config describes (``num_machines`` > 1),
    unless this process joined one already (the CLI flow,
    application.cpp:167-178: Network::Init before training)."""
    if is_initialized():
        return
    if int(getattr(config, "num_machines", 1) or 1) > 1:
        init(params=config)


def barrier(name: str = "barrier", timeout: Optional[float] = None) -> None:
    """Cross-process synchronization point of the calling thread's or
    process's gang (a no-op alone; the checkpoint writer's). It runs
    inside a watchdog phase, so a peer that died or hung before reaching
    it surfaces as the watchdog's diagnosis, not an endless wait. The
    group's own timeout bounds it otherwise (``timeout`` is accepted for
    the JAX package's signature)."""
    net = network.current()
    if net.world <= 1:
        return
    with watchdog_phase(f"barrier:{name}"):
        net.barrier()


def _store_timeout(deadline: float) -> float:
    """The store's wait under an armed watchdog: twice the deadline, so
    the watchdog fires first and names the suspects."""
    return 2.0 * float(deadline)


def exchange_host(tag: str, payload: str,
                  timeout: Optional[float] = None) -> List[str]:
    """Every rank's small string ``payload`` in rank order, over the gang's
    store; every rank calls it in lockstep with the same ``tag``. Inside a
    watchdog phase; with a watchdog armed and no ``timeout``, the store
    waits twice its deadline."""
    net = network.current()
    if net.world <= 1:
        return [payload]
    wd = _active_health.watchdog if _active_health is not None else None
    if timeout is None and wd is not None:
        timeout = _store_timeout(wd.deadline)
    with watchdog_phase(f"exchange:{tag}"):
        return net.exchange_host(tag, payload, timeout)


def allgather_f64(arr) -> np.ndarray:
    """Every rank's float64 array, bit for bit: [W, *arr.shape]."""
    import torch
    a = np.ascontiguousarray(np.asarray(arr, np.float64))
    parts = network.current().allgather(torch.from_numpy(a.copy()))
    return np.stack([p.numpy() for p in parts])


def free_port() -> int:
    """An ephemeral localhost port (bind, then close)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_child(q, fn, rank, nproc, machines, device_type, args):
    import pickle
    import traceback
    from .utils import faults
    # the spawn-failure injection point: the child dies before the gang's
    # init (the "machine cannot start" shape the supervisor answers with a
    # shrink)
    faults.maybe_fail_spawn(rank)
    try:
        init(machines=machines, num_machines=nproc, rank=rank,
             params={"device_type": device_type})
        result = fn(rank, *args)
        # pickled here, inside the try: the queue pickles in a feeder
        # thread, where an unpicklable result would vanish
        pickle.dumps(result)
        q.put((rank, True, result))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn(fn, nproc: int = 2, args: tuple = (),
          per_rank_args: Optional[list] = None, device_type: str = "cuda",
          timeout: Optional[float] = 600.0):
    """Run ``fn(rank, *args)`` -- with ``per_rank_args``, ``fn(rank,
    per_rank_args[rank], *args)``, each process getting only its own
    payload -- in ``nproc`` fresh local processes joined into one gang on
    a free localhost port (each child calls ``init`` with
    ``device_type``), and return rank 0's result. ``fn`` must be picklable
    (a module-level function). A rank that raises, or dies without
    reporting, fails the gang: RuntimeError with its rank, exit code and
    traceback; ``timeout`` bounds the whole gang. Every process is joined,
    or killed, before it returns (the analog of the reference's Dask
    orchestration, python-package/lightgbm/dask.py:211-330)."""
    import multiprocessing as mp
    import queue as _queue
    if per_rank_args is not None and len(per_rank_args) != nproc:
        raise ValueError(f"per_rank_args has {len(per_rank_args)} entries "
                         f"for {nproc} ranks")
    port = free_port()
    machines = ",".join(f"127.0.0.1:{port}" for _ in range(nproc))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(
        target=_spawn_child,
        args=(q, fn, r, nproc, machines, device_type,
              tuple(args) if per_rank_args is None
              else (per_rank_args[r],) + tuple(args)))
        for r in range(nproc)]
    for p in procs:
        p.start()
    results = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(results) < nproc:
            try:
                r, ok, payload = q.get(timeout=1.0)
            except _queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and not p.is_alive() \
                            and p.exitcode not in (0, None):
                        raise RuntimeError(
                            f"distributed.spawn rank {r} died with exit "
                            f"code {p.exitcode} before reporting")
                if deadline is not None and time.monotonic() > deadline:
                    missing = [r for r in range(nproc) if r not in results]
                    raise RuntimeError(
                        f"distributed.spawn timed out after {timeout}s "
                        f"waiting for ranks {missing}")
                continue
            if not ok:
                raise RuntimeError(
                    f"distributed.spawn rank {r} failed:\n{payload}")
            results[r] = payload
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return results.get(0)


def _train_part(rank, part, params, num_boost_round, train_kwargs):
    """One process of ``train_distributed``: its part as a pre-partitioned
    Dataset, the standard train loop, the model text."""
    from .engine import train as _train
    ds = load_partitioned(part["data"], label=part.get("label"),
                          weight=part.get("weight"),
                          init_score=part.get("init_score"), params=params)
    return _train(params, ds, num_boost_round,
                  **train_kwargs).model_to_string()


def train_distributed(params, parts, num_boost_round: int = 100,
                      timeout: Optional[float] = 900.0, **train_kwargs):
    """Train over pre-partitioned data, one process a part (``parts``: one
    dict per rank, {"data": X, "label": y, "weight", "init_score"
    optional}; each process sees only its own), and return rank 0's model
    as a Booster. ``tree_learner`` defaults to "data" and must be data,
    voting or feature (the reference's dask layer has the same
    restriction, dask.py:301-311); the processes run on ``device_type``."""
    from .booster import Booster
    params = dict(params or {})
    learner = str(params.get("tree_learner", "data") or "data")
    allowed = {"data", "voting", "feature"}
    if learner not in allowed:
        log.fatal(f"train_distributed requires tree_learner in {allowed} "
                  f"(got {learner!r}) -- the reference's dask layer has the "
                  f"same restriction (dask.py:301-311)")
    params["tree_learner"] = learner
    if "num_machines" in params and int(params["num_machines"]) != len(parts):
        log.fatal(f"num_machines={params['num_machines']} but {len(parts)} "
                  f"parts given")
    model_str = spawn(_train_part, nproc=len(parts),
                      args=(params, num_boost_round, dict(train_kwargs)),
                      per_rank_args=list(parts),
                      device_type=str(params.get("device_type", "cuda")),
                      timeout=timeout)
    return Booster(params=params, model_str=model_str)


def load_partitioned(data, label=None, weight=None, init_score=None,
                     params: Optional[dict] = None, feature_name="auto",
                     categorical_feature="auto"):
    """This rank's pre-partitioned Dataset: the rank passes its own rows.
    Each rank samples ``bin_construct_sample_cnt / W`` of its rows, the
    samples are allgathered (float64, bit for bit) and every rank fits the
    same bin mappers from them (the reference's distributed bin finding,
    dataset_loader.cpp:1046-1128); only the local rows are binned, padded
    to the gang's largest local count (the padded rows carry no mass).
    ``num_data`` is the gang's row count, ``num_local_data`` the rank's;
    labels, weights and scores stay local, and metrics evaluate on the
    rank's rows. Train it with ``tree_learner`` data or voting. Dense
    input; not with dart, linear_tree or rollback_one_iter (as in the JAX
    package)."""
    import torch
    from . import binning
    from .basic import Dataset, _load_forced_bins, _to_2d_float
    from .config import Config
    config = Config.from_params(dict(params or {}))
    if config.boosting == "dart":
        log.fatal("load_partitioned does not support boosting=dart")
    if config.linear_tree:
        log.fatal("linear_tree is not supported with pre-partitioned "
                  "Datasets (raw features are not retained)")
    net = network.current()
    X = _to_2d_float(data)
    n_local, f = X.shape
    w = net.world
    per = max(1, config.bin_construct_sample_cnt // w)
    idx = binning.sample_indices(n_local, per,
                                 config.data_random_seed + net.rank)
    sample = np.full((per, f), np.nan)
    sample[:len(idx)] = X[idx]
    valid = np.zeros((per,), np.float64)
    valid[:len(idx)] = 1.0
    gathered = allgather_f64(np.concatenate([sample, valid[:, None]], 1))
    gathered = gathered.reshape(-1, f + 1)
    sample = gathered[gathered[:, f] == 1.0, :f]
    counts = [int(c) for c in allgather_f64(np.asarray([n_local]))[:, 0]]
    n_global = int(sum(counts))

    ds = Dataset(X, label=label, weight=weight, init_score=init_score,
                 params=dict(params or {}), feature_name=feature_name,
                 categorical_feature=categorical_feature)
    ds.device = config.torch_device()
    ds.num_data, ds.num_total_features = n_local, f
    ds._set_feature_names()
    cats = ds._resolve_categorical(config)
    forced = _load_forced_bins(config, f, cats)
    filter_cnt = binning.filter_cnt_for_sample(config, len(sample), n_global)
    ds.mappers = [binning.fit_mapper_for_column(
        j, np.asarray(sample[:, j]), len(sample), config,
        set(int(c) for c in cats), filter_cnt, forced) for j in range(f)]
    ds.used_features = np.array(
        [j for j, m in enumerate(ds.mappers) if not m.is_trivial], np.int32)
    ds._build_feature_meta(config)
    local = ds.bin_new_data(X)
    target = max(counts)
    if target > n_local:
        local = torch.cat([local, local.new_zeros(
            (local.shape[0], target - n_local))], dim=1)
    ds.binsT = local.contiguous()
    ds.raw_data_np = None
    ds.num_data = n_global
    ds.num_local_data = n_local
    ds.is_pre_partitioned = True
    ds.partition_counts = counts
    ds.local_row_start = int(sum(counts[:net.rank]))
    ds._finish_construct()
    log.info(f"pre-partitioned dataset: {n_local} local rows of "
             f"{n_global} on {w} ranks")
    return ds


def load_partitioned_chunks(chunks, *args, **kwargs):
    """Not ported yet: the streaming pre-partitioned construct."""
    raise NotImplementedError(
        "load_partitioned_chunks (streaming construct) is not ported to "
        "lightgbm_tpu_torch yet; it arrives with ROADMAP.md Queue 1 item 15 "
        "(distributed)")


def repartition_rows(old_ranges, row_start: int, row_count: int,
                     fetch_shard):
    """One rank's row slice ``[row_start, row_start + row_count)`` of a
    row-partitioned array, reassembled from shards written under another
    (or the same) partition: the load half of resuming at another world
    size.

    ``old_ranges``: each old rank's ``(row_start, row_count)`` in rank
    order, tiling ``[0, sum(counts))``; ``fetch_shard(old_rank)`` returns
    that rank's shard (rows first) and is called only for the shards that
    overlap the slice, so a resume under the same partition reads its own
    shard alone. Pure row movement: the rows come back bit for bit.
    ValueError when the old ranges do not tile the slice."""
    lo, hi = int(row_start), int(row_start) + int(row_count)
    if row_count == 0:
        # keep the trailing dims and dtype (multiclass caches are [n, k])
        if old_ranges:
            return fetch_shard(0)[:0]
        return np.zeros((0,), np.float32)
    pieces = []
    covered = lo
    for old_rank, (s, c) in enumerate(old_ranges):
        s, e = int(s), int(s) + int(c)
        if e <= lo or s >= hi:
            continue
        a, b = max(s, lo), min(e, hi)
        if a != covered:
            raise ValueError(
                f"shard ranges do not tile rows [{lo}, {hi}): gap at row "
                f"{covered} (old rank {old_rank} covers [{s}, {e}))")
        shard = fetch_shard(old_rank)
        if shard.shape[0] != c:
            raise ValueError(
                f"shard for old rank {old_rank} has {shard.shape[0]} rows, "
                f"its recorded partition says {c}")
        pieces.append(shard[a - s:b - s])
        covered = b
    if covered != hi:
        raise ValueError(
            f"shard ranges do not tile rows [{lo}, {hi}): rows "
            f"[{covered}, {hi}) are not covered by any shard")
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)


# ===================================================== training supervision
class HeartbeatMonitor:
    """Rank liveness over a TCP side channel (newline-JSON request and
    reply in plain sockets). Rank 0 runs the aggregation server; every
    rank (0 included) sends its progress every ``interval`` seconds and
    receives the aggregated table back, rank -> {iter, step, age}, where
    ``age`` is the seconds since that rank's last report reached rank 0."""

    def __init__(self, rank: int, nproc: int, addr: str,
                 interval: float = 5.0):
        self.rank = int(rank)
        self.nproc = int(nproc)
        host, _, port = addr.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.interval = max(0.2, float(interval))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._server_table: Dict[int, dict] = {}   # rank 0: rank -> report
        self._table: Dict[int, dict] = {}          # last aggregated view
        self._threads = []
        self._server_sock = None

    # ------------------------------------------------------------- server
    def _serve(self) -> None:
        srv = self._server_sock
        srv.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True, name="lgbm-hb-conn")
            t.start()
            self._threads.append(t)

    def _handle(self, conn) -> None:
        conn.settimeout(max(4 * self.interval, 10.0))
        try:
            fh = conn.makefile("rw", encoding="utf-8", newline="\n")
            for line in fh:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                now = time.monotonic()
                with self._lock:
                    self._server_table[int(msg.get("rank", -1))] = {
                        "iter": msg.get("iter", -1),
                        "step": msg.get("step", -1),
                        "recv": now}
                    reply = json.dumps({"table": self._aggregated()})
                fh.write(reply + "\n")
                fh.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _aggregated(self) -> dict:
        # the caller holds self._lock
        mine = _progress.snapshot()
        now = time.monotonic()
        self._server_table[self.rank] = {"iter": mine["iter"],
                                         "step": mine["step"], "recv": now}
        out = {str(r): {"iter": e["iter"], "step": e["step"],
                        "age": round(now - e["recv"], 3)}
               for r, e in self._server_table.items()}
        for r, e in out.items():
            profiling.set_gauge(f"heartbeat_age_rank{r}", e["age"])
            profiling.set_gauge(f"last_iter_rank{r}", e["iter"])
        return out

    # ------------------------------------------------------------- client
    def _beat(self) -> None:
        fh = None
        while not self._stop.is_set():
            if fh is None:
                try:
                    conn = socket.create_connection(self.addr, timeout=5.0)
                    conn.settimeout(max(4 * self.interval, 10.0))
                    fh = conn.makefile("rw", encoding="utf-8", newline="\n")
                except OSError:
                    self._stop.wait(self.interval)
                    continue
            mine = _progress.snapshot()
            try:
                fh.write(json.dumps({"rank": self.rank,
                                     "iter": mine["iter"],
                                     "step": mine["step"],
                                     "t": time.time()}) + "\n")
                fh.flush()
                reply = json.loads(fh.readline())
                with self._lock:
                    self._table = {int(r): dict(e) for r, e in
                                   reply.get("table", {}).items()}
            except (OSError, ValueError):
                try:
                    fh.close()
                except OSError:
                    pass
                fh = None
            self._stop.wait(self.interval)
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass

    # -------------------------------------------------------------- api
    def start(self) -> "HeartbeatMonitor":
        if self.rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(self.addr)
            srv.listen(max(self.nproc, 8))
            self._server_sock = srv
            t = threading.Thread(target=self._serve, daemon=True,
                                 name="lgbm-hb-server")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._beat, daemon=True,
                             name="lgbm-hb-client")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass

    def table(self) -> Dict[int, dict]:
        """The latest aggregated liveness table (rank -> iter/step/age)."""
        if self.rank == 0:
            with self._lock:
                return {int(r): dict(e)
                        for r, e in self._aggregated().items()}
        with self._lock:
            return {r: dict(e) for r, e in self._table.items()}

    def suspects(self, my_step: int, my_iter: int = -1) -> Optional[list]:
        """Ranks implicated in a stall: dead (stale heartbeat), missing
        (never reported), or lagging (their reported progress, completed
        iteration or step in flight, is behind this rank's: the hung
        rank's signature, alive with a fresh heartbeat but never in the
        step everyone else is blocked in). None (unknown) when the table
        is empty: an unanswered heartbeat is no evidence against every
        rank."""
        table = self.table()
        if not table:
            return None
        out = set()
        stale_after = max(3 * self.interval, 5.0)
        my_progress = max(my_step, my_iter)
        for r in range(self.nproc):
            e = table.get(r)
            if e is None:
                out.add(r)
                continue
            progress = max(e.get("step", -1), e.get("iter", -1))
            if e.get("age", 0.0) > stale_after:
                out.add(r)
            elif my_progress >= 0 and progress < my_progress \
                    and r != self.rank:
                out.add(r)
        return sorted(out)


class CollectiveWatchdog:
    """Deadline monitor over the progress stack: ``deadline`` seconds after
    a phase (boosting step, barrier, exchange) began without ending, it
    diagnoses the stall and ends it. A supervised rank exits with
    WATCHDOG_EXIT_CODE for the supervisor to reap; an unsupervised run
    gets a DistributedTimeoutError raised in its main thread."""

    def __init__(self, deadline: float, rank: int = 0,
                 heartbeat: Optional[HeartbeatMonitor] = None,
                 supervised: Optional[bool] = None,
                 diag_dir: Optional[str] = None):
        self.deadline = float(deadline)
        self.rank = int(rank)
        self.heartbeat = heartbeat
        self.supervised = (os.environ.get(_SUPERVISED_ENV) == "1"
                           if supervised is None else bool(supervised))
        self.diag_dir = diag_dir if diag_dir is not None \
            else os.environ.get(_DIAG_DIR_ENV)
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._main_thread = threading.main_thread()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "CollectiveWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lgbm-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        tick = min(0.25, self.deadline / 4)
        while not self._stop.wait(tick):
            snap = _progress.snapshot()
            if snap["phase"] is None:
                # between steps: the training loop itself went quiet, the
                # hung rank's own signature (its peers see a stalled step,
                # it sees nothing moving). Judged only after two steps of
                # this process: the first interval holds the valid set's
                # first evaluation, which says nothing about a stalled
                # peer (an in-process count, so a relaunched incarnation
                # keeps the exemption for its own first interval)
                if snap["steps_done"] >= 2 \
                        and snap["idle_elapsed"] > self.deadline:
                    snap = dict(snap, phase="between-steps (host-side)")
                    self._fire(snap)
                    return
                continue
            # the first step of this process is exempt (the kernels' first
            # loads and the card's warm-up); barriers and exchanges are
            # always judged, and a rank that dies before anyone's first
            # step ends is the supervisor's incarnation timeout's
            if snap["phase"].startswith("step:") and snap["steps_done"] < 1:
                continue
            # an OOM-ladder retry: the first step's exemption
            if snap["phase"].startswith("step-retry:"):
                continue
            if snap["phase_elapsed"] > self.deadline:
                self._fire(snap)
                return

    def _diagnose(self, snap: dict) -> dict:
        suspects = None
        table = None
        if self.heartbeat is not None:
            suspects = self.heartbeat.suspects(snap["step"], snap["iter"])
            table = {str(r): e for r, e in self.heartbeat.table().items()}
        if self.heartbeat is not None \
                and str(snap["phase"]).startswith("between-steps"):
            # this rank's own training loop went quiet: in a gang it is the
            # stalled party, whatever its peers report
            suspects = sorted(set(suspects or []) | {self.rank})
        return {"rank": self.rank, "iteration": snap["iter"],
                "stalled_iteration": snap["step"], "phase": snap["phase"],
                "elapsed": round(snap["phase_elapsed"], 3),
                "deadline": self.deadline, "suspects": suspects,
                "heartbeat_table": table,
                "t": time.time(), "t_mono": time.monotonic(),
                "kind": "watchdog"}

    def _fire(self, snap: dict) -> None:
        global _last_diagnosis
        diag = self._diagnose(snap)
        _last_diagnosis = diag
        self._fired.set()
        msg = format_timeout_message(diag["rank"], diag["iteration"],
                                     diag["suspects"], diag["phase"],
                                     self.deadline)
        log.warning(f"watchdog: {msg}")
        # flush the flight recorder now (the training thread is stalled
        # inside the phase being diagnosed) and carry its path in the
        # diagnosis: the supervisor's report then points at a
        # per-iteration post-mortem
        from . import telemetry
        diag["flight_recorder"] = telemetry.flush_recorder(
            f"watchdog: {msg}")
        if self.diag_dir:
            try:
                os.makedirs(self.diag_dir, exist_ok=True)
                with open(os.path.join(
                        self.diag_dir,
                        f"watchdog_rank{self.rank}.json"), "w") as fh:
                    json.dump(diag, fh, indent=1)
            except OSError as e:
                log.warning(f"watchdog: cannot write the diagnosis: {e}")
        if self.supervised:
            # a rank blocked inside a native collective cannot be unstuck
            # from Python: exit and let the supervisor relaunch the gang
            import sys
            sys.stderr.write(f"[watchdog] {msg}\n")
            sys.stderr.flush()
            os._exit(WATCHDOG_EXIT_CODE)
        # unsupervised: raise in the main thread. It lands when that thread
        # runs Python bytecode again: at once in a Python-level stall (the
        # hang fault's sleep loop), on return from a native wait
        import ctypes
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_long(self._main_thread.ident),
            ctypes.py_object(DistributedTimeoutError))

    @property
    def fired(self) -> bool:
        return self._fired.is_set()


class _Health:
    """One training run's supervision: a heartbeat and a watchdog (each
    optional), started together by ``engine.train`` and stopped in its
    ``finally``."""

    def __init__(self, heartbeat, watchdog):
        self.heartbeat = heartbeat
        self.watchdog = watchdog

    def stop(self) -> None:
        global _active_health
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if _active_health is self:
            _active_health = None


_active_health: Optional[_Health] = None


def start_health(config=None, heartbeat_addr: Optional[str] = None
                 ) -> _Health:
    """Start this process's training supervision from a config:

    - a HeartbeatMonitor when ``heartbeat_interval`` > 0, the gang has
      more than one rank and the side channel's address is known (the
      supervisor's ``LGBM_TPU_HEARTBEAT_ADDR``, or ``heartbeat_addr``);
    - a CollectiveWatchdog when ``collective_deadline`` > 0; the gang's
      group timeout must be more than twice the deadline, or torch's own
      timeout would fire first with another message.

    A nested ``train`` gets an inert handle, and so does a ``train`` off
    the main thread (a thread-rank of ``network.thread_gang``: the
    thread-ranks of a process share its one progress record, and the
    watchdog raises in the main thread). The caller owns ``stop()``."""
    global _active_health
    if _active_health is not None \
            or threading.current_thread() is not threading.main_thread():
        return _Health(None, None)
    interval = float(getattr(config, "heartbeat_interval", 0.0) or 0.0)
    deadline = float(getattr(config, "collective_deadline", 0.0) or 0.0)
    addr = heartbeat_addr or os.environ.get(_HEARTBEAT_ADDR_ENV)
    net = network.current()
    rank, nproc = net.rank, net.world
    group_timeout = _gang["timeout_s"]
    if deadline > 0 and nproc > 1 and group_timeout is not None \
            and group_timeout <= 2.0 * deadline:
        log.fatal(f"collective_deadline={deadline:g}s needs the gang's "
                  f"time_out above {2.0 * deadline / 60.0:g} minutes (it "
                  f"is {group_timeout / 60.0:g}): the process group's "
                  f"timeout would end a stalled collective before the "
                  f"watchdog names the suspects")
    if interval > 0 or deadline > 0:
        _progress.reset()
    heartbeat = None
    if interval > 0 and nproc > 1 and addr:
        try:
            heartbeat = HeartbeatMonitor(rank, nproc, addr,
                                         interval).start()
        except OSError as e:
            log.warning(f"heartbeat disabled: cannot reach side-channel "
                        f"{addr}: {e}")
    watchdog = None
    if deadline > 0:
        watchdog = CollectiveWatchdog(deadline, rank,
                                      heartbeat=heartbeat).start()
    health = _Health(heartbeat, watchdog)
    if heartbeat is not None or watchdog is not None:
        _active_health = health
    return health


def heartbeat_ages() -> Optional[Dict[str, float]]:
    """Each rank's heartbeat age (seconds since its last report) while a
    monitor is live in this process, else None."""
    h = _active_health
    if h is None or h.heartbeat is None:
        return None
    return {str(r): float(e.get("age", -1.0))
            for r, e in h.heartbeat.table().items()}


# ====================================================== training integrity
class RankDivergenceError(Exception):
    """The integrity vote found ranks whose model state does not match the
    gang's majority. ``corrupt_ranks`` names the minority; with
    ``indeterminate`` no majority exists (a 1:1 split at world size 2) and
    the listed ranks are only the disagreeing parties."""

    def __init__(self, iteration: int, corrupt_ranks, table,
                 indeterminate: bool = False):
        self.iteration = int(iteration)
        self.corrupt_ranks = list(corrupt_ranks)
        self.table = table
        self.indeterminate = bool(indeterminate)
        if indeterminate:
            msg = (f"model-state divergence detected at iteration "
                   f"{iteration}: ranks {self.corrupt_ranks} disagree and "
                   f"no majority exists — cannot name the corrupt rank; "
                   f"restart the gang from the last valid checkpoint")
        else:
            msg = (f"model-state divergence detected at iteration "
                   f"{iteration}: rank(s) {self.corrupt_ranks} hold state "
                   f"that differs from the gang's majority (silent "
                   f"corruption — bit flip, bad memory, or "
                   f"nondeterministic kernel). Restart the corrupt "
                   f"rank(s) from the last valid checkpoint "
                   f"(lightgbm_tpu.supervisor does this automatically).")
        super().__init__(msg)


def model_fingerprint(boosting) -> dict:
    """One rank's fingerprint of the model state, the JAX package's bytes:

    - ``trees``: sha256 over every tree's leaf count (int32), split
      features (int32), threshold bins (int64) and leaf values (float64):
      the same on every rank;
    - ``score``: sha256 of the float32 train-score cache over this rank's
      rows, with the row range, so the vote compares only ranks that hold
      the same rows.

    Reading it copies the score cache to the host once."""
    import hashlib
    h = hashlib.sha256()
    for ht in boosting.host_trees:
        nl = int(ht.num_leaves)
        nn = max(nl - 1, 0)
        h.update(np.int32(nl).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(ht.split_feature[:nn], np.int32)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(ht.threshold_bin[:nn], np.int64)).tobytes())
        h.update(np.ascontiguousarray(
            np.asarray(ht.leaf_value[:nl], np.float64)).tobytes())
    score = np.ascontiguousarray(
        boosting.train_score.detach().cpu().numpy().astype(np.float32,
                                                          copy=False))
    ts = boosting.train_set
    row_start = int(getattr(ts, "local_row_start", 0) or 0) \
        if ts is not None else 0
    return {
        "rank": network.current().rank,
        "trees": h.hexdigest(),
        "score": hashlib.sha256(score.tobytes()).hexdigest(),
        "row_start": row_start,
        "row_count": int(score.shape[0]),
    }


def divergence_verdict(entries):
    """Majority vote over the ranks' fingerprints: ``(corrupt_ranks,
    indeterminate)``, the minority whose fingerprints differ from a strict
    majority or, where some disputed component has no strict majority,
    every disagreeing rank with ``indeterminate``. Tree hashes vote over
    the gang; score hashes only within a group of ranks that hold the same
    row range (pre-partitioned ranks hold disjoint rows, whose hashes
    differ by design)."""
    from collections import Counter
    suspects = set()
    indeterminate = False

    def vote(group, key):
        nonlocal indeterminate
        counts = Counter(key(e) for e in group)
        if len(counts) <= 1:
            return
        _, best_n = counts.most_common(1)[0]
        if best_n * 2 <= len(group):
            indeterminate = True
            suspects.update(int(e["rank"]) for e in group)
        else:
            best = counts.most_common(1)[0][0]
            suspects.update(int(e["rank"]) for e in group
                            if key(e) != best)

    vote(entries, lambda e: e["trees"])
    by_range: Dict[tuple, list] = {}
    for e in entries:
        by_range.setdefault(
            (int(e.get("row_start", 0)), int(e.get("row_count", -1))),
            []).append(e)
    for group in by_range.values():
        if len(group) > 1:
            vote(group, lambda e: e["score"])
    return sorted(suspects), indeterminate


def check_model_integrity(boosting, iteration: int,
                          timeout: Optional[float] = None) -> None:
    """The cross-rank divergence check, called in lockstep on every rank
    every ``integrity_check_period`` iterations (``engine.train``):
    exchanges each rank's ``model_fingerprint`` over the gang's store and
    majority-votes a mismatch. A clean gang returns. Divergence,
    unsupervised: RankDivergenceError on every rank, naming the minority.
    Divergence, supervised (``LGBM_TPU_SUPERVISED=1``): the corrupt rank
    writes ``divergence_rank<r>.json`` and exits with
    DIVERGENCE_EXIT_CODE, and the honest ranks log and go on until the
    supervisor tears them down; with no majority every rank raises. A
    no-op in a gang of one. The gauge ``integrity_check_ms`` keeps the
    host milliseconds of the last check."""
    net = network.current()
    if net.world <= 1:
        return
    t0 = time.perf_counter()
    mine = model_fingerprint(boosting)
    payloads = exchange_host(f"integrity_{iteration}", json.dumps(mine),
                             timeout=timeout)
    entries = [json.loads(p) for p in payloads]
    corrupt, indeterminate = divergence_verdict(entries)
    profiling.inc_gauge("integrity_checks_run")
    profiling.set_gauge("integrity_last_iteration", float(iteration))
    # the checkpoint callback votes before every save, but not again at an
    # iteration engine.train has voted already
    boosting._integrity_checked_iter = int(iteration)
    profiling.set_gauge("integrity_check_ms",
                        (time.perf_counter() - t0) * 1e3)
    if not corrupt:
        return
    table = {str(e["rank"]): {"trees": e["trees"][:16],
                              "score": e["score"][:16]} for e in entries}
    err = RankDivergenceError(iteration, corrupt, table,
                              indeterminate=indeterminate)
    rank = mine["rank"]
    supervised = os.environ.get(_SUPERVISED_ENV) == "1"
    if supervised and not indeterminate:
        if rank in corrupt:
            # by the gang's vote this rank's state is bad: a restore from
            # the last valid checkpoint is the way back
            diag_dir = os.environ.get(_DIAG_DIR_ENV)
            diag = {"rank": rank, "iteration": int(iteration),
                    "corrupt_ranks": corrupt, "fingerprints": table,
                    "kind": "divergence",
                    "t": time.time(), "t_mono": time.monotonic()}
            from . import telemetry
            diag["flight_recorder"] = telemetry.flush_recorder(
                f"divergence: rank {rank} voted corrupt at iteration "
                f"{iteration}")
            if diag_dir:
                try:
                    os.makedirs(diag_dir, exist_ok=True)
                    with open(os.path.join(
                            diag_dir, f"divergence_rank{rank}.json"),
                            "w") as fh:
                        json.dump(diag, fh, indent=1)
                except OSError as e:
                    log.warning(f"integrity check: cannot write the "
                                f"diagnosis: {e}")
            import sys
            sys.stderr.write(f"[integrity] {err}\n")
            sys.stderr.flush()
            os._exit(DIVERGENCE_EXIT_CODE)
        log.warning(f"integrity check: {err} (this rank is in the "
                    f"majority; awaiting supervisor restart)")
        return
    raise err
