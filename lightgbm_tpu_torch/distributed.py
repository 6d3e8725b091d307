"""Process-level distributed state: the gang, its front end and supervision.

The port of lightgbm_tpu's ``distributed.py``, in two parts.

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
  same ones, and only the rank's own rows binned.

The single-process part: ``notify_step_begin`` / ``notify_step_end`` (the
training loop's progress), the OOM ladder's degradation log
(``record_degradation`` / ``degradations`` / ``reset_degradations``) and
``health_snapshot``, the supervision record every checkpoint manifest
carries. The gang supervisor, heartbeats and the collective watchdog,
elastic resume and the cross-rank integrity vote come later with item 15
(their parameters raise naming it).
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import time
from typing import List, Optional

import numpy as np

from . import network
from .utils import log

# the supervisor's restart counter, read from the environment as the JAX
# package reads it (a relaunched process inherits it)
_RESTART_COUNT_ENV = "LGBM_TPU_RESTART_COUNT"

_lock = threading.Lock()
_progress = {"iter": -1, "step": -1}
# degradation events this process recorded (models/gbdt.py
# _maybe_degrade_oom and _maybe_degrade_predict_oom), surfaced through
# health_snapshot() and so through every later checkpoint manifest
_degradations: List[dict] = []




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


# ------------------------------------------------------- the gang front end
_gang = {"store": None, "pg": None}


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
    _gang.update(store=store, pg=pg)
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
    _gang.update(store=None, pg=None)


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
    process's gang (a no-op alone; the checkpoint writer's)."""
    network.current().barrier()


def exchange_host(tag: str, payload: str,
                  timeout: Optional[float] = None) -> List[str]:
    """Every rank's small string ``payload`` in rank order, over the gang's
    store; every rank calls it in lockstep with the same ``tag``."""
    return network.current().exchange_host(tag, payload, timeout)


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
