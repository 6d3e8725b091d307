"""The collective layer of the distributed tree learners.

The counterpart of the ``jax.lax`` collectives lightgbm_tpu's grower calls
inside its ``shard_map`` (``psum``, ``psum_scatter``, ``pmax``,
``all_gather``) and of the reference's ``Network`` (src/network/), over
``torch.distributed``. A ``Network`` wraps one EXPLICIT process group --
never the global default -- so several ranks can run as threads of one
process over a ``ProcessGroupGloo`` and a ``HashStore`` (``thread_gang``),
as the tests run them.

What it offers, each with this rank's contribution as its input:

- ``allreduce_max``, ``allgather`` (tensors) and ``allgather_object``;
- ``fold_sum``: an allgather, then a left fold in rank order,
  ``((x0 + x1) + x2) + ...``, which is what XLA:CPU's ``psum`` computes bit
  for bit; the float path of the CPU learners;
- ``fold_sum_scatter``: the same for ``psum_scatter(tiled=True)``: rank r
  receives the r-th of W equal contiguous slices along ``dim`` (the
  caller pads that axis to a multiple of W, as the JAX learners pad
  their features);
- ``reduce_scatter_int``: exact integer sums of each rank's slice, for
  the histograms' fixed-point planes (``hist_tile(raw=True)``), in which
  any order of the adds gives the same bits;
- ``sync_best``: the per-leaf best split over ranks, an allgather and an
  argmax with ties to the lowest rank (``ops/split.py sync_best_splits``);
- ``barrier``.

Backend. ``choose_backend`` decides once, from the topology: NCCL when
every rank's device is a card of its own, else gloo. Gloo runs on host
tensors: the layer copies a CUDA tensor to the host before the collective
and back after it (several ranks on one card -- NCCL refuses two ranks on
one device -- and every CPU gang). The choice is logged and kept in
``Network.backend``; it is never made by catching a failure, and an
explicit ``backend="nccl"`` on a shared card raises.

Counters. ``Network.counters`` holds calls, payload bytes (this rank's
input tensor) and wall seconds per collective (with a CUDA tensor the
seconds include the host copies and a stream synchronisation, so they are
what the grower waits).
"""

from __future__ import annotations

import datetime
import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .utils import log

COLLECTIVES = ("allreduce_max", "allgather", "allgather_object", "fold_sum",
               "fold_sum_scatter", "reduce_scatter_int", "sync_best",
               "barrier")


def choose_backend(devices: Sequence[str], requested: Optional[str] = None
                   ) -> tuple:
    """(backend, reason) for a gang whose ranks hold ``devices`` (one
    ``"host|device"`` string per rank, in rank order). NCCL when every
    rank's device is a CUDA card no other rank holds; gloo otherwise.
    ``requested`` ("nccl" or "gloo") overrides the choice; "nccl" on a CPU
    or a shared card raises."""
    kinds = [d.split("|", 1)[1].split(":")[0] for d in devices]
    cuda = all(k == "cuda" for k in kinds)
    distinct = len(set(devices)) == len(devices)
    if requested not in (None, "", "auto", "nccl", "gloo"):
        raise ValueError(f"unknown collective backend {requested!r} "
                         f"(nccl, gloo or auto)")
    if requested == "nccl":
        if not cuda:
            raise ValueError("backend=nccl needs every rank on a CUDA card")
        if not distinct:
            raise ValueError(
                "backend=nccl needs a card per rank, and ranks share one "
                f"({', '.join(devices)}); NCCL refuses two ranks on one "
                "device -- use gloo")
        return "nccl", "requested"
    if requested == "gloo":
        return "gloo", "requested"
    if not cuda:
        return "gloo", "CPU ranks"
    if not distinct:
        return "gloo", "ranks share a card (reduced through host memory)"
    return "nccl", "a card per rank"


class Network:
    """One rank's view of a gang: ``rank``, ``world``, ``device``, the
    backend and the process group ``group`` (None for a world of 1, where
    every collective is the identity). ``store`` is the gang's key-value
    store, which ``exchange_host`` needs."""

    def __init__(self, group=None, rank: int = 0, world: int = 1,
                 device="cpu", backend: str = "gloo", store=None,
                 reason: str = ""):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = backend
        self.reason = reason
        self.store = store
        self._seq = 0
        self.counters: Dict[str, Dict[str, float]] = {}
        self.reset_counters()

    def __repr__(self) -> str:
        return (f"Network(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend})")

    # ------------------------------------------------------------ counters
    def reset_counters(self) -> None:
        self.counters = {c: {"calls": 0, "bytes": 0, "seconds": 0.0}
                         for c in COLLECTIVES}

    def _tally(self, name: str, nbytes: int, t0: float) -> None:
        c = self.counters[name]
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        c["seconds"] += time.perf_counter() - t0

    def totals(self) -> dict:
        """Calls, bytes and seconds summed over every collective."""
        return {k: sum(c[k] for c in self.counters.values())
                for k in ("calls", "bytes", "seconds")}

    # ------------------------------------------------------------- moves
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend reads, contiguous: on the host for gloo,
        on the rank's card for NCCL (the caller gets its result back on
        ``t``'s device)."""
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.cpu()
        if self.backend == "nccl" and t.device != self.device:
            return t.to(self.device)
        return t

    def _sync(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()

    def _gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        src = self._wire(t)
        outs = [torch.empty_like(src) for _ in range(self.world)]
        self.group.allgather([outs], [src]).wait()
        self._sync(src)
        return [o.to(t.device) for o in outs]

    # -------------------------------------------------------- collectives
    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Element-wise max over ranks (``jax.lax.pmax``; exact)."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        import torch.distributed as dist
        src = self._wire(t).clone()
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MAX
        self.group.allreduce([src], opts).wait()
        self._sync(src)
        out = src.to(t.device)
        self._tally("allreduce_max", t.numel() * t.element_size(), t0)
        return out

    def allgather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        if self.world == 1:
            return [t]
        t0 = time.perf_counter()
        out = self._gather(t)
        self._tally("allgather", t.numel() * t.element_size(), t0)
        return out

    def allgather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (pickled bytes,
        padded to the longest)."""
        if self.world == 1:
            return [obj]
        t0 = time.perf_counter()
        raw = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        n = torch.tensor([raw.size], dtype=torch.int64)
        lens = [int(v) for v in self._gather(n)]
        buf = torch.zeros((max(lens),), dtype=torch.uint8)
        buf[:raw.size] = torch.from_numpy(raw.copy())
        parts = self._gather(buf)
        self._tally("allgather_object", raw.size, t0)
        return [pickle.loads(p[:ln].numpy().tobytes())
                for p, ln in zip(parts, lens)]

    def fold_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks as XLA:CPU's ``psum`` adds it: a left fold in
        rank order. Exact for integers; for floats the same bits on every
        rank and every backend."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        parts = self._gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        self._tally("fold_sum", t.numel() * t.element_size(), t0)
        return out

    def _slice(self, t: torch.Tensor, dim: int, r: int) -> torch.Tensor:
        size = t.shape[dim]
        if size % self.world:
            raise ValueError(f"axis {dim} of {size} does not split into "
                             f"{self.world} equal slices (pad it)")
        c = size // self.world
        return t.narrow(dim, r * c, c)

    def fold_sum_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum over ranks, each
        element a left fold in rank order (``psum_scatter(tiled=True)`` on
        XLA:CPU)."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        parts = self._gather(t)
        out = self._slice(parts[0], dim, self.rank)
        for p in parts[1:]:
            out = out + self._slice(p, dim, self.rank)
        self._tally("fold_sum_scatter", t.numel() * t.element_size(), t0)
        return out.contiguous()

    def reduce_scatter_int(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the integer sum over ranks
        (int32 or int64; exact in any order, so the backend's own
        reduce-scatter is used)."""
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"reduce_scatter_int sums integers, not {t.dtype}")
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        src = self._wire(t)
        ins = [self._slice(src, dim, r).contiguous()
               for r in range(self.world)]
        out = torch.empty_like(ins[0])
        self.group.reduce_scatter([out], [ins]).wait()
        self._sync(out)
        out = out.to(t.device)
        self._tally("reduce_scatter_int", t.numel() * t.element_size(), t0)
        return out

    def sync_best(self, info):
        """The per-leaf best of every rank's ``SplitInfo`` (torch fields of
        leading size L): the largest gain, a tie to the lowest rank (the
        reference's SyncUpGlobalBestSplit reducer keeps the destination on
        ties, parallel_tree_learner.h:191-214)."""
        if self.world == 1:
            return info
        t0 = time.perf_counter()
        # the fields travel as one float64 buffer per rank: float32,
        # float64, int32, bool and the 32-bit words of the bitsets are all
        # exact in float64
        shapes = [tuple(v.shape) for v in info]
        flat = torch.cat([v.reshape(v.shape[0], -1).to(torch.float64)
                          for v in info], dim=1)
        parts = torch.stack(self._gather(flat))                 # [W, L, c]
        gains = parts[:, :, 0]
        best = gains.max(dim=0).values
        order = torch.arange(self.world, 0, -1, device=gains.device)[:, None]
        win = torch.where(gains == best[None, :], order,
                          torch.zeros_like(order)).argmax(dim=0)  # [L]
        stack = parts[win, torch.arange(gains.shape[1],
                                        device=gains.device)]   # [L, c]
        out, col = [], 0
        for v, shp in zip(info, shapes):
            w = int(np.prod(shp[1:])) if len(shp) > 1 else 1
            out.append(stack[:, col:col + w].reshape(shp).to(v.dtype))
            col += w
        self._tally("sync_best", flat.numel() * 8, t0)
        return type(info)(*out)

    def barrier(self) -> None:
        if self.world == 1:
            return
        t0 = time.perf_counter()
        self.group.barrier().wait()
        self._tally("barrier", 0, t0)

    def exchange_host(self, tag: str, payload: str,
                      timeout: Optional[float] = None) -> List[str]:
        """Every rank's small string ``payload`` in rank order, over the
        gang's store (keys sequence-numbered per call, so every rank must
        call in lockstep with the same ``tag``)."""
        if self.world == 1:
            return [payload]
        self._seq += 1
        prefix = f"xchg/{tag}/{self._seq}"
        self.store.set(f"{prefix}/r{self.rank}", payload)
        if timeout is not None:
            self.store.set_timeout(datetime.timedelta(seconds=timeout))
        return [self.store.get(f"{prefix}/r{r}").decode()
                for r in range(self.world)]


_local = threading.local()
_process: Dict[str, Optional[Network]] = {"net": None}


def current() -> Network:
    """The calling thread's network (``bind``), else the process's
    (``distributed.init``), else a world of 1 on the CPU."""
    net = getattr(_local, "net", None) or _process["net"]
    return net if net is not None else Network()


def set_process_network(net: Optional[Network]) -> None:
    _process["net"] = net


class bind:
    """``with bind(net):`` makes ``net`` the calling thread's network (a
    thread-rank of ``thread_gang``)."""

    def __init__(self, net: Network):
        self.net = net

    def __enter__(self):
        self.old = getattr(_local, "net", None)
        _local.net = self.net
        return self.net

    def __exit__(self, *exc):
        _local.net = self.old
        return False


def thread_gang(world: int, fn, *, device="cpu", timeout: float = 120.0
                ) -> list:
    """Run ``fn(net)`` as ``world`` thread-ranks of one process, each over
    its own ``ProcessGroupGloo`` on one shared ``HashStore`` and bound as
    its thread's network; returns every rank's result in rank order and
    re-raises the first rank's error. A rank that fails fails the gang:
    the others' collectives time out after ``timeout`` seconds."""
    import torch.distributed as dist
    store = dist.HashStore()
    results: list = [None] * world
    errors: list = [None] * world

    def run(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("gang", store), r,
                                       world,
                                       datetime.timedelta(seconds=timeout))
            net = Network(pg, r, world, device, "gloo",
                          dist.PrefixStore("host", store), "thread ranks")
            with bind(net):
                results[r] = fn(net)
        except BaseException as e:          # noqa: BLE001 -- re-raised below
            errors[r] = e

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r, e in enumerate(errors):
        if e is not None:
            raise RuntimeError(f"thread rank {r} of {world} failed: "
                               f"{type(e).__name__}: {e}") from e
    return results


def log_choice(net: Network) -> None:
    log.info(f"distributed: rank {net.rank} of {net.world} on {net.device}, "
             f"backend {net.backend} ({net.reason})")
