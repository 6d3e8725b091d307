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
``predict_sharded`` (several devices) comes with ROADMAP Queue 1 item 15.

The engine is built per (booster, tree range) by ``GBDT._predict_engine``
and also serves ``score_dataset`` (per-tree bias subtraction) and
``predict_leaf``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..binning import BinSlot, bin_data_device
from ..ops.predict import Carry, new_carry, pack_ensemble, predict_ensemble
from ..utils import profiling
from .tree import TreeArrays

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
                 bucket_min_rows: int = 1024):
        self.k = int(k)
        self.T = int(num_trees)
        self.depth = int(max_depth)
        self.accum = resolve_accum(accum)
        self.chunk_rows = int(chunk_rows)
        self.device = torch.device(device)
        self.tables = pack_ensemble(stacked, self.depth, self.device)
        self.biases = (None if biases is None else torch.as_tensor(
            np.asarray(biases, np.float64), device=self.device))
        self.bucket_min = max(1, int(bucket_min_rows))
        self.serve_mode = False
        self._serve_slots: Dict[int, ServeSlot] = {}
        self._lock = threading.Lock()

    def _chunk_rows(self, n: int) -> int:
        return self.chunk_rows if self.chunk_rows > 0 else _AUTO_CHUNK_ROWS

    # ------------------------------------------------------- accumulation
    def make_carry(self, base: Optional[np.ndarray], n: int) -> Carry:
        """Device carry [n, K] seeded from a host float64 base (None:
        zeros), cast to the accumulation mode (compensated pairs the seed
        with a zero compensation term)."""
        if base is None:
            return new_carry(n, self.k, self.accum, self.device)
        b = np.asarray(base, np.float64).reshape(n, self.k)
        if self.accum == "compensated":
            s = torch.as_tensor(b.astype(np.float32), device=self.device)
            return (s, torch.zeros_like(s))
        dt = np.float64 if self.accum == "float64" else np.float32
        return torch.as_tensor(np.ascontiguousarray(b.astype(dt)),
                               device=self.device)

    def accumulate(self, binsT: torch.Tensor, missing_bin: torch.Tensor,
                   carry: Optional[Carry] = None,
                   active: Optional[torch.Tensor] = None,
                   tree_range: Optional[Tuple[int, int]] = None,
                   use_bias: bool = True) -> Carry:
        """One launch: trees [a, b) over ``binsT`` [F, n], added into
        ``carry`` (None: zeros). Returns the device carry."""
        a, b = tree_range if tree_range is not None else (0, self.T)
        n = binsT.shape[1]
        if carry is None:
            carry = new_carry(n, self.k, self.accum, self.device)
        if b <= a:
            return carry
        return predict_ensemble(
            self.tables, binsT, missing_bin.to(self.device), (a, b), self.k,
            bias=self.biases if use_bias else None, active=active,
            carry=carry, accum=self.accum)

    def fetch(self, carry: Carry, n: int) -> np.ndarray:
        """The result to the host as float64: [n], or [n, K] with K > 1 --
        the only device-to-host transfer of a predict."""
        s = carry[0] if self.accum == "compensated" else carry
        out = s[:n].cpu().numpy().astype(np.float64)
        return out[:, 0] if self.k == 1 else out

    # ------------------------------------------------------------ predict
    def predict(self, binsT: torch.Tensor, missing_bin: torch.Tensor, *,
                base: Optional[np.ndarray] = None, use_bias: bool = True,
                postprocess=None,
                tree_range: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Full predict over a device bin matrix ``binsT`` [F, N]:
        row-chunked, accumulated on the device; returns the host ``[n,
        K]`` (or ``[n]``) result. ``base``: optional float64 initial
        scores. ``postprocess``: the objective's output conversion, applied
        on the device to the carry ([n] or [n, K]) before the fetch; it
        returns the host array."""
        n = binsT.shape[1]
        chunk = self._chunk_rows(n)
        outs = []
        for a0 in range(0, max(n, 1), chunk):
            b0 = min(n, a0 + chunk)
            outs.append(self._predict_chunk(
                binsT[:, a0:b0], missing_bin,
                None if base is None else base[a0:b0], postprocess,
                tree_range, use_bias))
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def _predict_chunk(self, binsT, missing_bin, base, postprocess,
                       tree_range, use_bias) -> np.ndarray:
        n = binsT.shape[1]
        carry = self.make_carry(base, n)
        carry = self.accumulate(binsT, missing_bin, carry,
                                tree_range=tree_range, use_bias=use_bias)
        if postprocess is not None:
            s = carry[0] if self.accum == "compensated" else carry
            return np.asarray(postprocess(s[:, 0] if self.k == 1 else s))
        return self.fetch(carry, n)

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
    def leaves(self, binsT: torch.Tensor, missing_bin: torch.Tensor,
               tree_range: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """[t, n] int32 per-tree leaf indices over the range, in one
        launch (the [t, n] transfer is inherent to the predict_leaf API)."""
        a, b = tree_range if tree_range is not None else (0, self.T)
        return predict_ensemble(self.tables, binsT,
                                missing_bin.to(self.device), (a, b), self.k,
                                leaves=True).cpu().numpy()


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
