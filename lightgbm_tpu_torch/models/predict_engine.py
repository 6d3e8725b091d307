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

The JAX engine's XLA-only parts have no counterpart here:
- ``TRACE_COUNTS``: nothing is traced or compiled per shape (the kernel is
  built once, at first use);
- buffer donation (``_serve_*_jit``): PyTorch's caching allocator reuses
  the buffers;
- ``warm_aot``: there is no program to compile ahead of time;
- power-of-two row buckets: nothing is compiled per row count, so rows are
  not padded (``predict_bucket_min_rows`` is accepted and has no effect),
  and results do not depend on padding in either package.
An engine holds no mutable state: each call makes its own carry, so
callers may share one (``GBDT._predict_engine``'s lock guards building
it).
``predict_sharded`` (several devices) comes with ROADMAP Queue 1 item 15,
serve mode with item 16.

The engine is built per (booster, tree range) by ``GBDT._predict_engine``
and also serves ``score_dataset`` (per-tree bias subtraction) and
``predict_leaf``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.predict import Carry, new_carry, pack_ensemble, predict_ensemble
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
                 accum: str = "auto", chunk_rows: int = 0, device="cpu"):
        self.k = int(k)
        self.T = int(num_trees)
        self.depth = int(max_depth)
        self.accum = resolve_accum(accum)
        self.chunk_rows = int(chunk_rows)
        self.device = torch.device(device)
        self.tables = pack_ensemble(stacked, self.depth, self.device)
        self.biases = (None if biases is None else torch.as_tensor(
            np.asarray(biases, np.float64), device=self.device))

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

    # ------------------------------------------------------------- leaves
    def leaves(self, binsT: torch.Tensor, missing_bin: torch.Tensor,
               tree_range: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """[t, n] int32 per-tree leaf indices over the range, in one
        launch (the [t, n] transfer is inherent to the predict_leaf API)."""
        a, b = tree_range if tree_range is not None else (0, self.T)
        return predict_ensemble(self.tables, binsT,
                                missing_bin.to(self.device), (a, b), self.k,
                                leaves=True).cpu().numpy()
