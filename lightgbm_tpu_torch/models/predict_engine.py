"""Device-resident batched inference engine.

The port of lightgbm_tpu's ``models/predict_engine.py``: a full-ensemble
predict over a bin matrix is one kernel launch a row chunk
(``ops/predict.py predict_ensemble``, ``csrc/predict_ensemble.cu`` on the
card), and only the ``[N, K]`` result crosses to the host.

- **On-device accumulation, in tree order.** Each tree's output is added
  to the carry in tree order (class ``t % K`` of tree ``t``), with no
  multiply feeding the adds (leaf values arrive shrunk, biases come off
  before the add), so the float64 mode is bitwise the host loop. The
  ``compensated`` (two-float f32) and ``float32`` modes do the JAX
  engine's own operations in its order.
- **Depth-bounded traversal.** The plain version walks each tree for the
  ensemble's true max leaf depth (measured once at engine build) with no
  host sync; the kernel walks each row to its leaf.
- **Chunked streaming.** Inputs larger than ``predict_chunk_rows`` (auto:
  4M rows) run in row chunks, the carry fetched a chunk at a time.

- **Serve mode** (``serve_mode``, set by ``GBDT.enable_serve_mode`` when
  a ``ServeFrontend`` registers the booster): the JAX engine recycles a
  padded bin matrix and a carry a power-of-two row bucket by buffer
  donation (``_serve_chunk``). Here each bucket (``bucket_rows``: the
  smallest power of two >= max(n, ``predict_bucket_min_rows``)) keeps one
  slot of device buffers allocated at its first flush: the raw rows with
  a pinned host staging buffer, the bins (``binning.BinSlot``), the carry
  and a pinned output buffer. A flush copies its rows in with
  ``non_blocking=True``, bins them in place, launches ``predict_ensemble``
  into the slot's carry over its first n rows and fetches n rows: in the
  steady state it allocates no device memory (a converted predict's
  conversion excepted: it is the objective's own code, shared with the
  ordinary path so the bits agree). Bitwise the ordinary path, since a
  row's traversal reads no other row. The engine's lock holds for a whole
  flush, as in the JAX package.

The JAX engine's XLA-only parts have no counterpart here:
- ``TRACE_COUNTS``: nothing is traced or compiled per shape (the kernel is
  built once, at first use);
- ``warm_aot``: there is no program to compile ahead of time;
- padding outside serve mode: nothing is compiled per row count, so the
  ordinary path pads no rows, and results do not depend on padding in
  either package.
Outside serve mode an engine call makes its own carry, so callers may
share one (``GBDT._predict_engine``'s lock guards building it).

- **Row-sharded predict** (``sharded``, the ``predict_sharded``
  parameter): the JAX engine runs its scan under ``shard_map`` over every
  visible device (``jax.devices()``), rows sharded and trees replicated.
  Here the engine takes its device list (``devices``; by default every
  visible CUDA device of the process, or the CPU), keeps one packed table
  a device (``tables_on``), splits each row chunk into contiguous, equal
  shards over the devices (``shards``: ceil(n / D) rows each, the last
  shorter and nothing padded, as the ordinary path pads nothing) and bins
  and walks each shard on its own device, one launch a shard; the shards'
  results come back in row order. A row's accumulation order is
  unchanged, so the result is bitwise the unsharded one. With one device
  there is one shard through the same code, and the engine logs so. An
  unsharded engine is the same code over the one device list
  ``[device]``: every operand is a list over the shards (``prepare_bins``,
  ``upload_rows``, ``make_carry``), and ``predict_sharded`` only chooses
  the list. A serve-mode flush never shards.

The engine is built per (booster, tree range) by ``GBDT._predict_engine``
and also serves ``score_dataset`` (per-tree bias subtraction) and
``predict_leaf``.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import BinSlot, bin_data_device
from ..ops.predict import Carry, new_carry, pack_ensemble, predict_ensemble
from ..utils import log, profiling
from .tree import TreeArrays

# the rows of a predict: a callable ``rows(lo, hi, device)`` giving the
# bins [F, hi - lo] of rows [lo, hi) on ``device``
Rows = Callable[[int, int, torch.device], torch.Tensor]

_AUTO_CHUNK_ROWS = 1 << 22      # auto: ~4M-row chunks bound device residency


def resolve_accum(mode: str) -> str:
    """Map the ``predict_accum`` param to an engine mode. ``auto`` means
    float64 (exact, bitwise the host float64 accumulation); ``compensated``
    is the two-float f32 mode, ``float32`` plain f32 sums."""
    mode = (mode or "auto").lower()
    if mode in ("auto", "float64", "f64", "double"):
        return "float64"
    if mode in ("compensated", "kahan", "twofloat"):
        return "compensated"
    if mode in ("float32", "f32", "single"):
        return "float32"
    raise ValueError(f"unknown predict_accum mode: {mode!r}")


def visible_devices(device) -> List[torch.device]:
    """The devices a sharded engine spreads over by default: every visible
    CUDA device of the process for a CUDA ``device`` (as ``shard_map``
    spans ``jax.devices()``), else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def tensor_rows(binsT: torch.Tensor) -> Rows:
    """A bin matrix [F, N] as rows: a shard is its column slice, a view on
    the matrix's own device, copied only to another device."""
    return lambda lo, hi, dev: binsT[:, lo:hi].to(dev)


def slice_rows(rows: Rows, a: int, b: int) -> Rows:
    """Rows [a, b) of ``rows``."""
    return lambda lo, hi, dev: rows(a + lo, a + hi, dev)


def host_tree_depth(left_child: np.ndarray, right_child: np.ndarray,
                    num_leaves: int) -> int:
    """Max leaf depth (edge count from the root) of one tree, walked from
    the host child arrays: the depth-bounded traversal's trip count."""
    if num_leaves <= 1:
        return 0
    best = 1
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        for ch in (int(left_child[node]), int(right_child[node])):
            if ch >= 0:
                stack.append((ch, d + 1))
            elif d > best:
                best = d
    return best


class PredictEngine:
    """Inference engine over one stacked ensemble, resident on ``device``.

    ``biases``: optional per-tree float64 bias (the boost-from-average fold
    recorded in GBDT.tree_bias), taken off before accumulation by
    ``score_dataset``; raw prediction leaves it on (the stored trees carry
    it)."""

    def __init__(self, stacked: TreeArrays, k: int, num_trees: int,
                 max_depth: int, *, biases: Optional[np.ndarray] = None,
                 accum: str = "auto", chunk_rows: int = 0, device="cpu",
                 bucket_min_rows: int = 1024, sharded: bool = False,
                 devices: Optional[Sequence] = None):
        self.k = int(k)
        self.T = int(num_trees)
        self.depth = int(max_depth)
        self.accum = resolve_accum(accum)
        self.chunk_rows = int(chunk_rows)
        self.device = torch.device(device)
        self.stacked = stacked
        self.tables = pack_ensemble(stacked, self.depth, self.device)
        self.biases = (None if biases is None else torch.as_tensor(
            np.asarray(biases, np.float64), device=self.device))
        self.sharded = bool(sharded)
        # the shards' devices: unsharded, the engine's device alone
        self.devices = ([torch.device(d) for d in devices] if devices
                        else visible_devices(self.device)) \
            if self.sharded else [self.device]
        self._tables: Dict[torch.device, tuple] = {
            self.device: (self.tables, self.biases)}
        if self.sharded and len(self.devices) == 1:
            log.info(f"predict_sharded: one device ({self.devices[0]}), so "
                     f"one shard through the sharded path")
        self.bucket_min = max(1, int(bucket_min_rows))
        self.serve_mode = False
        self._serve_slots: Dict[int, ServeSlot] = {}
        self._lock = threading.Lock()

    def _chunk_rows(self, n: int) -> int:
        return self.chunk_rows if self.chunk_rows > 0 else _AUTO_CHUNK_ROWS

    # ------------------------------------------------------------ shards
    def tables_on(self, device) -> tuple:
        """The packed tables and biases replicated on ``device``, packed
        once and kept."""
        device = torch.device(device)
        hit = self._tables.get(device)
        if hit is None:
            with self._lock:
                hit = self._tables.get(device)
                if hit is None:
                    hit = (pack_ensemble(self.stacked, self.depth, device),
                           None if self.biases is None
                           else self.biases.to(device))
                    self._tables[device] = hit
        return hit

    def shards(self, n: int) -> List[Tuple[torch.device, int, int]]:
        """The contiguous row shards ``(device, lo, hi)`` of n rows, one a
        device in order, ceil(n / D) rows each (the last shorter, empty
        ones dropped)."""
        if n == 0:
            return [(self.devices[0], 0, 0)]
        d = len(self.devices)
        size = -(-n // d)
        return [(dev, i * size, min(n, (i + 1) * size))
                for i, dev in enumerate(self.devices) if i * size < n]

    def prepare_bins(self, rows: Rows, n: int) -> List[torch.Tensor]:
        """The bins the launches read, one matrix a shard on its own
        device."""
        return [rows(lo, hi, dev) for dev, lo, hi in self.shards(n)]

    def upload_rows(self, arr: np.ndarray) -> List[torch.Tensor]:
        """A host per-row array (the early stop's active mask) split over
        the shards, each on its device."""
        return [torch.as_tensor(arr[lo:hi], device=dev)
                for dev, lo, hi in self.shards(len(arr))]

    # ------------------------------------------------------- accumulation
    def make_carry(self, base: Optional[np.ndarray], n: int) -> List[Carry]:
        """The device carries [rows, K] of the shards, seeded from a host
        float64 base [n, K] (None: zeros) and cast to the accumulation
        mode (compensated pairs the seed with a zero compensation term)."""
        b = (None if base is None
             else np.asarray(base, np.float64).reshape(n, self.k))
        return [self._carry(None if b is None else b[lo:hi], hi - lo, dev)
                for dev, lo, hi in self.shards(n)]

    def _carry(self, b: Optional[np.ndarray], n: int, device) -> Carry:
        if b is None:
            return new_carry(n, self.k, self.accum, device)
        if self.accum == "compensated":
            s = torch.as_tensor(b.astype(np.float32), device=device)
            return (s, torch.zeros_like(s))
        dt = np.float64 if self.accum == "float64" else np.float32
        return torch.as_tensor(np.ascontiguousarray(b.astype(dt)),
                               device=device)

    def accumulate(self, bins: List[torch.Tensor], missing_bin: torch.Tensor,
                   carry: Optional[List[Carry]] = None,
                   active: Optional[List[torch.Tensor]] = None,
                   tree_range: Optional[Tuple[int, int]] = None,
                   use_bias: bool = True) -> List[Carry]:
        """Trees [a, b) over the shards' bins (``prepare_bins``), added
        into their carries (None: zeros), one launch a shard on its device
        with that device's tables. Returns the shards' device carries."""
        a, b = tree_range if tree_range is not None else (0, self.T)
        carry = [None] * len(bins) if carry is None else carry
        active = [None] * len(bins) if active is None else active
        out = []
        for bt, c, act in zip(bins, carry, active):
            dev = bt.device
            if c is None:
                c = new_carry(bt.shape[1], self.k, self.accum, dev)
            if b > a:
                tables, biases = self.tables_on(dev)
                with _on(dev):
                    c = predict_ensemble(
                        tables, bt, missing_bin.to(dev), (a, b), self.k,
                        bias=biases if use_bias else None, active=act,
                        carry=c, accum=self.accum)
            out.append(c)
        return out

    def fetch(self, carry: List[Carry]) -> np.ndarray:
        """The result to the host as float64, the shards in row order: [n],
        or [n, K] with K > 1 -- the only device-to-host transfer of a
        predict."""
        out = np.concatenate([
            (c[0] if self.accum == "compensated" else c).cpu().numpy()
            for c in carry], axis=0).astype(np.float64)
        return out[:, 0] if self.k == 1 else out

    # ------------------------------------------------------------ predict
    def predict(self, rows: Rows, missing_bin: torch.Tensor, *, n: int,
                base: Optional[np.ndarray] = None, use_bias: bool = True,
                postprocess=None,
                tree_range: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Full predict over n rows (``tensor_rows`` wraps a device bin
        matrix): row-chunked, each chunk over the shards, accumulated on
        the device; returns the host ``[n, K]`` (or ``[n]``) result.
        ``base``: optional float64 initial scores. ``postprocess``: the
        objective's output conversion, applied on the device to each
        shard's carry ([rows] or [rows, K]) before the fetch; it returns
        the host array."""
        chunk = self._chunk_rows(n)
        outs = []
        for a0 in range(0, max(n, 1), chunk):
            b0 = min(n, a0 + chunk)
            outs.append(self._predict_chunk(
                slice_rows(rows, a0, b0), b0 - a0, missing_bin,
                None if base is None else base[a0:b0], postprocess,
                tree_range, use_bias))
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _predict_chunk(self, rows, n, missing_bin, base, postprocess,
                       tree_range, use_bias) -> np.ndarray:
        carry = self.accumulate(self.prepare_bins(rows, n), missing_bin,
                                self.make_carry(base, n),
                                tree_range=tree_range, use_bias=use_bias)
        if postprocess is None:
            return self.fetch(carry)
        outs = []
        for c in carry:
            s = c[0] if self.accum == "compensated" else c
            outs.append(np.asarray(postprocess(s[:, 0] if self.k == 1
                                               else s)))
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    # -------------------------------------------------------------- serve
    def bucket_rows(self, n: int) -> int:
        """The serve slot of an n-row flush: the smallest power of two
        >= max(n, ``predict_bucket_min_rows``)."""
        b = self.bucket_min
        while b < n:
            b <<= 1
        return b

    def serve_predict(self, X: np.ndarray, mappers: Sequence,
                      missing_bin: torch.Tensor,
                      postprocess=None) -> np.ndarray:
        """Serve-mode predict of raw rows ``X [n, F]`` (the used features,
        ``mappers`` theirs) over the whole ensemble, row-chunked like
        ``predict``; each chunk through its bucket's slot
        (``_serve_chunk``)."""
        n = X.shape[0]
        chunk = self._chunk_rows(n)
        outs = [self._serve_chunk(X[a0:a0 + chunk], mappers, missing_bin,
                                  postprocess)
                for a0 in range(0, n, chunk)]
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _serve_chunk(self, X: np.ndarray, mappers: Sequence,
                     missing_bin: torch.Tensor, postprocess) -> np.ndarray:
        """One flush through a slot, under the engine's lock (two threads
        in one slot would overwrite each other's rows). A failure drops the
        slot, so the next flush starts it afresh."""
        n = X.shape[0]
        bucket = self.bucket_rows(n)
        with self._lock:
            slot = self._serve_slots.get(bucket)
            if slot is None or not slot.bins.fits(X):
                slot = ServeSlot(mappers, bucket, X.dtype, self.k,
                                 self.accum, missing_bin, self.device)
                self._serve_slots[bucket] = slot
            try:
                return slot.run(self, X, postprocess)
            except BaseException:
                self._serve_slots.pop(bucket, None)
                raise

    def release_serve_slots(self) -> None:
        """Drop the serve slots (the owning frontend closed or swapped the
        booster out): their buffers go back to the allocator."""
        with self._lock:
            self._serve_slots.clear()

    # ------------------------------------------------------------- leaves
    def leaves(self, bins: List[torch.Tensor], missing_bin: torch.Tensor,
               tree_range: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """[t, n] int32 per-tree leaf indices over the range of the shards'
        bins (``prepare_bins``), one launch a shard (the [t, n] transfer
        is inherent to the predict_leaf API)."""
        a, b = tree_range if tree_range is not None else (0, self.T)
        outs = []
        for bt in bins:
            tables, _ = self.tables_on(bt.device)
            with _on(bt.device):
                outs.append(predict_ensemble(
                    tables, bt, missing_bin.to(bt.device), (a, b), self.k,
                    leaves=True).cpu().numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)


def _on(device: torch.device):
    """The device's context for a launch (a ctypes launch goes to the
    current CUDA device); nothing on the CPU."""
    from contextlib import nullcontext
    return torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()


class ServeSlot:
    """One serve bucket's buffers (``PredictEngine._serve_chunk``): the
    binning slot (raw rows, their pinned host staging, the bins), the
    carry [rows, K] in the accumulation mode's dtype, a pinned host output
    buffer and the missing bins as the kernel reads them, all allocated
    here, once."""

    def __init__(self, mappers: Sequence, rows: int, dtype, k: int,
                 accum: str, missing_bin: torch.Tensor, device):
        self.rows = int(rows)
        self.device = torch.device(device)
        self.bins = BinSlot(mappers, self.rows, dtype, self.device)
        self.carry = new_carry(self.rows, k, accum, self.device)
        s = self.carry[0] if accum == "compensated" else self.carry
        self.out = torch.empty(tuple(s.shape), dtype=s.dtype,
                               pin_memory=self.device.type == "cuda")
        self.out_np = self.out.numpy()
        self.mb = missing_bin.to(device=self.device,
                                 dtype=torch.int32).contiguous()
        self.k = int(k)
        self.accum = accum

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every buffer of the slot by name (their ``data_ptr`` stays the
        same from flush to flush)."""
        parts = self.carry if self.accum == "compensated" else (self.carry,)
        b = self.bins
        out = {"host_rows": b.host, "rows": b.raw, "rowsT": b.xT,
               "nan": b.nan, "cnt": b.cnt, "binsT": b.binsT,
               "out": self.out, "missing_bin": self.mb}
        out.update({f"carry{i}": p for i, p in enumerate(parts)})
        return out

    def run(self, eng: PredictEngine, X: np.ndarray,
            postprocess) -> np.ndarray:
        n = X.shape[0]
        binsT = bin_data_device(X, self.bins.mappers, self.device,
                                out=self.bins)
        with profiling.timer("serve_kernel", sync=self.device):
            parts = (self.carry if self.accum == "compensated"
                     else (self.carry,))
            for p in parts:
                p[:n].zero_()
            carry = (tuple(p[:n] for p in parts) if self.accum ==
                     "compensated" else parts[0][:n])
            predict_ensemble(eng.tables, binsT, self.mb, (0, eng.T), eng.k,
                             carry=carry, accum=self.accum)
        with profiling.timer("serve_fetch", sync=self.device):
            s = carry[0] if self.accum == "compensated" else carry
            if postprocess is not None:
                return np.asarray(postprocess(s[:, 0] if self.k == 1
                                              else s))
            cuda = self.device.type == "cuda"
            self.out[:n].copy_(s, non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
            res = self.out_np[:n].astype(np.float64)
        return res[:, 0] if self.k == 1 else res
