"""Hopper kernels of the histogram tile pass, their wrappers and plain versions.

The port of lightgbm_tpu's ``ops/pallas_hist.py``. On the TPU a Pallas
kernel accumulates a tile's histogram planes in VMEM: plane-only for the
classic split path (``_fused_kernel`` for full-row passes, ``_gather_kernel``
for compaction-rung passes), or with the split epilogue on its last grid
step for the fused path (``_fused_epi_kernel``, ``_gather_epi_kernel``). On
Hopper that is two hand-written CUDA kernels (``csrc/``):

- ``hist_tile`` (``csrc/hist_tile.cu``): the ``[P, F, B, 3]`` planes of the
  tile's computed slots, in the full-row form (``idx=None``) or the gather
  form (rows ``idx[M]``, entries >= N are padding). The gather form
  partitions the rung's rows once into slot-grouped runs of (row id,
  stats) and accumulates each run over all features at once (plain
  versions ``gather_partition_plain`` and ``gather_accumulate_plain``).
  The full form of a tile with one computed slot -- the root pass, the one
  full pass a tree takes with ``hist_subtraction`` -- reads every row once
  for all features of a block, with no partition (``full_accumulate``;
  plain version ``full_accumulate_plain``); a tile of several computed
  slots runs the gather form over all N rows. Both read the rows' bins
  from one row-major copy of the bin matrix (``bins_by_row``). Both are
  deterministic, so two launches give the same bits. Two modes, chosen by
  the stats' dtype: f32 (float stats, 64-bit fixed-point sums, float32
  planes) and q8 (the quantized-gradient mode: int8 stats, exact int32
  sums, int32 planes); the f32 mode of the plane-only forms also writes
  float64 planes (``dtype=torch.float64``, the f64 mode of ``gpu_use_dp``:
  the same sums, rounded once to double); and two bin widths, chosen by
  the bins' dtype:
  uint8 (up to 256 bins) and the wide mode (int16 bins, up to
  ``MAX_BINS_WIDE`` bins: the kernels hold one feature's [B, 3] plane in
  a block's shared memory). ``plane=True`` marks a launch of the classic
  path (the plane-only kernels 3-4). Each mode counts its own launches:
  ``launches``, ``gather_launches`` and ``launches_plane`` for f32 at
  uint8 bins, each with ``_q8`` for q8, ``_dp`` for the f64 mode and with
  ``_wide`` (before ``_q8`` / ``_dp``) for the wide mode;
- ``split_epilogue`` (``csrc/split_epilogue.cu``): in q8 mode the int32
  tile dequantized by ``q_scale`` first, then the derived slots' planes as
  parent - computed sibling, then the numerical split scan (``ops/split.py
  numerical_candidates``) -> the ``[P, F, 12]`` table; in its monotone
  mode (``with_monotone``, basic monotone constraints) the scan clips each
  candidate's outputs to its slot's bounds and zeroes the gain of those
  that break the feature's direction. Above 256 bins its wide mode
  spreads a plane over one block of a warp per 256-bin chunk and carries
  the scan in XLA's three-level block order.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on the current stream, raises if the launch failed, and
adds one to its ``launches`` counter. On a CPU tensor it runs the kernel's
plain PyTorch version instead (``hist_tile_plain``, ``split_epilogue_plain``),
and only then: on a CUDA tensor it launches the kernel or raises.
``hist_tile_exact`` is the plain version of ``hist_tile``'s own fixed-point
arithmetic (bitwise the kernel's planes on float stats too; in q8 mode the
plain version is exact already);
``kernel_sums_on_cpu`` makes the CPU path use it, for a CPU run that gives a
card run's bits.

Learning to rank's pairwise lambda kernel (``csrc/lambdarank.cu``, no TPU
counterpart) has its wrapper and plain versions in ``ops/rank.py``, and
the ensemble traversal of a predict (``csrc/predict_ensemble.cu``, no TPU
counterpart either) in ``ops/predict.py``; both are built and bound here
with the others and counted with them (``register_counters``).

Off the training path, ``hist_onehot`` (``csrc/hist_onehot.cu``) is the
experiment script's one-hot histogram on the bf16 tensor cores
(``scripts/exp_hist_variants.py``), with its plain version
``hist_onehot_plain`` and its own ``launches`` counter.

Each kernel source is built on the first use of one of its kernels, with
``nvcc`` into one shared library per source under
``lightgbm_tpu_torch/_build/`` (``build_kernels()`` builds them all, the
compiles started together), and bound through ``ctypes`` with a plain
C interface -- no PyTorch headers, so a build takes seconds. ``nvcc``
runs with ``--fmad=false``: the epilogue's candidate table must be bitwise
equal to the plain version's.

The argument-layout helpers (``_chan_layout``, ``chan_leaf_table``,
``_epilogue_lanes``, ``pack_leaf_aux``, ``pack_feature_meta``,
``pack_scan_params``, ``structural_tile_leaves``) are the JAX package's, so
the tables the kernels take compare one to one with the TPU kernels'.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling

_PAD = 128                  # lane width of the TPU layout tables
_STATS = 3                  # (grad, hess, count) per row
MAX_BINS = 256              # uint8 bins; split_epilogue: 8 bins a lane
MAX_BINS_WIDE = 4096        # the wide mode's cap: one f32 [B, 3] plane of
                            # 24 bytes a bin fits a block (ROADMAP Queue 2
                            # item 3 splits a feature's bins beyond it)
Q8_MAX_ROWS = (2 ** 31 - 1) // 127   # q8: |sum| <= 127 * rows fits int32
SMEM_PER_BLOCK = 232_448    # Hopper: dynamic shared memory a block can use
_STATIC_SMEM = 1024         # room left for a gather kernel's static arrays
_GATHER_THREADS = 1024      # threads of a gather accumulate block
_FULL_THREADS = 1024        # threads of a full_accumulate block (32 warps)
_SCATTER_TILE = 256         # rung entries (threads) of a gather scatter block
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("hist_tile", "split_epilogue", "hist_onehot", "lambdarank",
            "predict_ensemble")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")


# ------------------------------------------------------------ layout helpers
def _chan_layout(p: int, s: int):
    """Static per-lane channel layout: lane q carries stat ``s_of_q[q]`` of
    slot ``p_of_q[q]`` (q < p*s; higher lanes are dead padding)."""
    q = np.arange(_PAD)
    valid = q < p * s
    p_of_q = np.where(valid, np.minimum(q // s, p - 1), 0)
    s_of_q = np.where(valid, q % s, 0)
    return p_of_q, s_of_q, valid


def chan_leaf_table(sel: torch.Tensor, s: int = _STATS) -> torch.Tensor:
    """[1, 128] int32: the leaf id each lane accumulates, -9 for dead
    lanes. ``hist_tile`` reads the leaf of slot p at lane 3p."""
    p = sel.shape[0]
    p_of_q, _, valid = _chan_layout(p, s)
    dev = sel.device
    out = torch.where(torch.as_tensor(valid, device=dev),
                      sel.to(torch.int32)[torch.as_tensor(p_of_q, device=dev)],
                      torch.tensor(-9, dtype=torch.int32, device=dev))
    return out[None, :].contiguous()


def _epilogue_lanes(sel: torch.Tensor, derive: torch.Tensor,
                    s: int = _STATS) -> torch.Tensor:
    """[1, 128] int32 derive-lane table: lane q of a derived slot (sibling
    at slot p-1) is 1. ``split_epilogue`` reads slot p at lane 3p."""
    p = sel.shape[0]
    p_of_q, _, valid = _chan_layout(p, s)
    dev = sel.device
    pq = torch.as_tensor(p_of_q, device=dev)
    dl = (torch.as_tensor(valid, device=dev) & derive.to(torch.bool)[pq]
          & (sel[pq] >= 0))
    return dl.to(torch.int32)[None, :].contiguous()


def pack_leaf_aux(sum_g, sum_h, cnt, output, leaf_min=None,
                  leaf_max=None) -> torch.Tensor:
    """[P, 8] f32 per-slot leaf aggregates (columns: sum_g, sum_h, cnt,
    output, min, max, 0, 0): min/max are the slots' monotone output
    bounds, -FLT_MAX / FLT_MAX (unconstrained) where not given."""
    p = sum_g.shape[0]
    big = float(np.finfo(np.float32).max)
    dev = sum_g.device
    lmin = torch.full((p,), -big, device=dev) if leaf_min is None \
        else leaf_min
    lmax = torch.full((p,), big, device=dev) if leaf_max is None \
        else leaf_max
    cols = [sum_g, sum_h, cnt, output, lmin, lmax,
            torch.zeros((p,), device=dev), torch.zeros((p,), device=dev)]
    return torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous()


def pack_feature_meta(num_bins_f, missing_type_f, default_bin_f,
                      monotone_f) -> torch.Tensor:
    """[F, 8] f32 per-feature scan metadata (columns: num_bins,
    missing_type, default_bin, monotone, 0...)."""
    f = num_bins_f.shape[0]
    cols = [num_bins_f, missing_type_f, default_bin_f, monotone_f]
    cols = [c.to(torch.float32) for c in cols] + \
        [torch.zeros((f,), device=num_bins_f.device)] * 4
    return torch.stack(cols, dim=1).contiguous()


def pack_scan_params(p) -> torch.Tensor:
    """[8] f32 packed numerical-scan SplitParams (7 fields + one pad, the
    TPU kernel's ``pv2d`` row)."""
    vals = [p.lambda_l1, p.lambda_l2, p.max_delta_step, p.path_smooth,
            p.min_data_in_leaf, p.min_sum_hessian_in_leaf,
            p.min_gain_to_split]
    out = torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in vals])
    return torch.cat([out, out.new_zeros((1,))]).contiguous()


def structural_tile_leaves(stats_channels: int = _STATS) -> int:
    """The widest leaf tile whose (slot x stat) channels fit the 128-lane
    layout tables: 42 slots of 3 stats."""
    return max(1, _PAD // max(stats_channels, 1))


# --------------------------------------------------------------------- build
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # source name -> nvcc output (ptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("building the CUDA kernels needs nvcc (CUDA toolkit), "
                       "which was not found on PATH or in /usr/local/cuda")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD / f"lib{name}_{key}.so"


def build_kernels(names: Tuple[str, ...] = _SOURCES) -> float:
    """Compile each of the kernel sources ``names`` that has no up-to-date
    library, one ``nvcc`` per source, all started together; load them.
    Returns the seconds spent."""
    t0 = time.time()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _libs:
            continue
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        build_log[name] = text
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{text}")
        os.replace(tmp, out)
    for name in names:
        if name not in _libs:
            _libs[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return time.time() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "hist_tile":
        ll = ctypes.c_longlong
        lib.hist_full_launch.argtypes = ([vp] * 4 + [ci, vp, ll]
                                         + [vp] * 2 + [ci] * 11
                                         + [ll, ci, vp])
        lib.hist_full_launch.restype = ci
        lib.hist_gather_launch.argtypes = ([vp] * 6 + [ci, vp, ll]
                                           + [vp] * 4 + [ci] * 13
                                           + [ll, ci, vp])
        lib.hist_gather_launch.restype = ci
        lib.hist_convert_launch.argtypes = [vp] * 3 + [ll, ll, ci, vp]
        lib.hist_convert_launch.restype = ci
    elif name == "split_epilogue":
        lib.split_epilogue_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp]
        lib.split_epilogue_launch.restype = ci
    elif name == "lambdarank":
        lib.lambdarank_launch.argtypes = ([vp] * 10 + [ci] * 3
                                          + [ctypes.c_float, ci]
                                          + [vp] * 5 + [ci, vp])
        lib.lambdarank_launch.restype = ci
    elif name == "predict_ensemble":
        lib.predict_ensemble_launch.argtypes = ([vp, ci, ctypes.c_longlong,
                                                 ci, ci] + [vp] * 3
                                                + [ci] * 2 + [vp, ci, vp]
                                                + [ci] * 3 + [vp] * 5
                                                + [ci] * 2 + [vp]
                                                + [ci] * 8 + [vp])
        lib.predict_ensemble_launch.restype = ci
    else:
        ll = ctypes.c_longlong
        lib.hist_onehot_launch.argtypes = ([vp] * 4 + [ci, ll] + [ci] * 5
                                           + [ll, ci, vp])
        lib.hist_onehot_launch.restype = ci
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_kernels((name,))
    return _libs[name]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# ------------------------------------------------------------------ hist_tile
def _slot_table(chan: torch.Tensor, num_slots: int, num_leaves: int):
    """The tile's computed slots, read on the host: (each slot's lane leaf
    [P] int32, each slot's compact index among the computed slots [P] int32,
    -1 for a slot that computes nothing)."""
    lanes = chan.reshape(-1)[0:num_slots * _STATS:_STATS].cpu().numpy()
    computed = (lanes >= 0) & (lanes < num_leaves)
    comp = np.where(computed, np.cumsum(computed) - 1, -1).astype(np.int32)
    return lanes.astype(np.int32), comp


def _tile_cells(binsT, leaf_ids, chan, num_slots, num_bins, num_leaves, idx):
    """The rows a tile pass adds (in row order) and each one's flattened
    (slot, feature, bin) cell per feature: (rows [R], cells [R, F])."""
    f, n = binsT.shape
    dev = binsT.device
    rows = (torch.arange(n, device=dev) if idx is None
            else idx[idx < n].to(torch.int64))
    slot_of_leaf = torch.full((num_leaves + 1,), -1, dtype=torch.int64,
                              device=dev)
    lane_leaf = chan.reshape(-1)[0:num_slots * _STATS:_STATS].to(torch.int64)
    ok = lane_leaf >= 0
    slot_of_leaf[torch.where(ok, lane_leaf, num_leaves)] = torch.where(
        ok, torch.arange(num_slots, device=dev), -1)
    slot_of_leaf[num_leaves] = -1
    lid = leaf_ids[rows].to(torch.int64)
    slot = slot_of_leaf[torch.where((lid >= 0) & (lid < num_leaves), lid,
                                    num_leaves)]
    keep = slot >= 0
    rows, slot = rows[keep], slot[keep]
    cells = ((slot[:, None] * f + torch.arange(f, device=dev)[None, :])
             * num_bins + binsT[:, rows].T.to(torch.int64))
    return rows, cells


def hist_tile_plain(binsT: torch.Tensor, leaf_ids: torch.Tensor,
                    stats: torch.Tensor, chan: torch.Tensor, num_slots: int,
                    num_bins: int, num_leaves: int,
                    idx: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of ``hist_tile``: one flat ``index_add_`` over the kept
    rows in row order. f32 mode: sums in ``dtype`` (float32, or float64 in
    the f64 mode), on the CPU bitwise equal to the JAX package's
    ``histogram_scatter`` / scatter-method tile at that dtype, and the CPU
    path's histogram; q8 mode (int8 ``stats``): int32 sums, exact and
    order-free. Returns [P, F, B, 3] in ``dtype``, or int32 in q8 mode."""
    f = binsT.shape[0]
    acc = torch.int32 if stats.dtype == torch.int8 else dtype
    rows, cells = _tile_cells(binsT, leaf_ids, chan, num_slots, num_bins,
                              num_leaves, idx)
    contrib = stats[rows].to(acc)[:, None, :].expand(
        rows.shape[0], f, _STATS).reshape(-1, _STATS)
    hist = torch.zeros((num_slots * f * num_bins, _STATS), dtype=acc,
                       device=binsT.device)
    hist.index_add_(0, cells.reshape(-1), contrib)
    return hist.reshape(num_slots, f, num_bins, _STATS)


def _fixed_exponent(amax: torch.Tensor, rows: int) -> torch.Tensor:
    """The kernel's fixed-point exponent k per stat channel: the largest
    that keeps max|stat| * rows * 2^k below 2^61 (csrc/hist_tile.cu
    fixed_exponent), as int64."""
    bound = amax.to(torch.float64) * rows
    _, e = torch.frexp(bound)
    k = torch.where(bound == 0, torch.full_like(e, 61), 61 - e)
    return k.clamp(-1000, 1000).to(torch.int64)


def _to_fixed(stats_rows: torch.Tensor, amax: torch.Tensor, rows: int):
    """The kernel's fixed-point form of float stats [R, 3] over a pass of
    ``rows`` rows whose max|stat| per channel is ``amax`` [3]: (int64
    [R, 3], exponent k [3], which channels are finite [3])."""
    finite = torch.isfinite(amax)
    k = torch.where(finite, _fixed_exponent(amax, rows), 0)
    one = torch.ones((_STATS,), dtype=torch.float64, device=stats_rows.device)
    fixed = torch.round(stats_rows.to(torch.float64)
                        * torch.ldexp(one, k)).to(torch.int64)
    return fixed, k, finite


def _from_fixed(acc: torch.Tensor, k: torch.Tensor, finite: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int64 fixed-point sums [..., 3] -> ``dtype``: float32 (the integer
    rounded to double, then to float32, as the kernel's convert), or
    float64 (one rounding); a channel with a non-finite stat is NaN."""
    one = torch.ones((_STATS,), dtype=torch.float64, device=acc.device)
    out = (acc.to(torch.float64) * torch.ldexp(one, -k)).to(dtype)
    return torch.where(finite, out, torch.full_like(out, float("nan")))


def _absmax(stats: torch.Tensor) -> torch.Tensor:
    """[3] float32 max|stat| of each channel over all rows (NaN wins)."""
    return stats.to(torch.float32).abs().amax(0)


def hist_tile_exact(binsT: torch.Tensor, leaf_ids: torch.Tensor,
                    stats: torch.Tensor, chan: torch.Tensor, num_slots: int,
                    num_bins: int, num_leaves: int,
                    idx: Optional[torch.Tensor] = None,
                    amax: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32,
                    rows: Optional[int] = None,
                    raw: bool = False) -> torch.Tensor:
    """``hist_tile``'s own arithmetic in plain PyTorch: each stat scaled by
    2^k and rounded to a 64-bit integer, integer sums (order-free), one
    conversion back to ``dtype`` (float32, or float64 in the f64 mode) --
    bitwise the kernel's planes on any stats (a non-finite stat makes its
    channel NaN). ``amax`` and ``rows`` (the exponent's row count, by
    default the pass's) as ``hist_tile``'s; ``raw``: the int64 sums
    before the conversion (``hist_convert_plain`` converts them). Returns
    [P, F, B, 3] in ``dtype``, or int64 with ``raw``."""
    f, n = binsT.shape
    m = n if idx is None else idx.shape[0]
    kept, cells = _tile_cells(binsT, leaf_ids, chan, num_slots, num_bins,
                              num_leaves, idx)
    fixed, k, finite = _to_fixed(stats[kept], _absmax(stats) if amax is None
                                 else amax, m if rows is None else rows)
    contrib = fixed[:, None, :].expand(kept.shape[0], f, _STATS).reshape(
        -1, _STATS)
    acc = torch.zeros((num_slots * f * num_bins, _STATS), dtype=torch.int64,
                      device=binsT.device)
    acc.index_add_(0, cells.reshape(-1), contrib)
    acc = acc.reshape(num_slots, f, num_bins, _STATS)
    return acc if raw else _from_fixed(acc, k, finite, dtype)


def hist_convert_plain(acc: torch.Tensor, amax: torch.Tensor, rows: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of ``hist_convert``: int64 fixed-point planes [..., 3]
    whose exponent came from ``amax`` [3] and ``rows`` -> ``dtype``, as
    ``hist_tile``'s convert rounds them (``_from_fixed``)."""
    finite = torch.isfinite(amax)
    k = torch.where(finite, _fixed_exponent(amax, rows), 0)
    return _from_fixed(acc, k, finite, dtype)


def gather_partition_plain(leaf_ids: torch.Tensor, chan: torch.Tensor,
                           num_slots: int, num_leaves: int,
                           idx: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the gather form's partition pass
    (``csrc/hist_tile.cu`` ``gather_count`` + ``gather_scatter``): the
    rung's kept rows grouped by computed slot. An entry is kept when it is
    no padding (0 <= idx < N) and its row's leaf is the leaf of a computed
    slot; compact slot c is the c-th slot of the tile that computes a
    leaf; ``idx`` None is the implicit rung of all N rows (the full form of
    a tile with several computed slots). Returns (offsets [A + 1] int64,
    rows [R] int64): compact slot c's rows are
    ``rows[offsets[c]:offsets[c + 1]]``, in rung order (the kernel's order
    within a slot is free: its sums are integers)."""
    n = leaf_ids.shape[0]
    dev = leaf_ids.device
    lanes, comp = _slot_table(chan, num_slots, num_leaves)
    slot_of = np.full((num_leaves,), -1, dtype=np.int64)
    slot_of[lanes[comp >= 0]] = comp[comp >= 0]
    rows = (torch.arange(n, device=dev) if idx is None
            else idx.to(torch.int64))
    rows = rows[(rows >= 0) & (rows < n)]
    lid = leaf_ids[rows].to(torch.int64)
    ok = (lid >= 0) & (lid < num_leaves)
    rows, lid = rows[ok], lid[ok]
    slot = torch.as_tensor(slot_of, device=dev)[lid]
    rows, slot = rows[slot >= 0], slot[slot >= 0]
    order = torch.sort(slot, stable=True).indices
    counts = torch.bincount(slot, minlength=int((comp >= 0).sum()))
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return offsets, rows[order]


def gather_accumulate_plain(binsT: torch.Tensor, stats: torch.Tensor,
                            offsets: torch.Tensor, rows: torch.Tensor,
                            chan: torch.Tensor, num_slots: int,
                            num_bins: int, num_leaves: int, m: int,
                            amax: Optional[torch.Tensor] = None,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain version of the gather form's accumulation
    (``gather_accumulate`` + the convert) over a partition
    (``gather_partition_plain``'s offsets and slot-grouped rows) of a rung
    of ``m`` entries. f32 mode: the kernel's fixed-point sums (scale 2^k
    from ``amax``, by default max|stat| over all N rows, and m, converted
    to ``dtype``), bitwise ``hist_tile_exact``; q8 mode (int8 stats):
    exact int32 sums. Slots that compute nothing come out zero. Returns
    [P, F, B, 3] in ``dtype``, or int32 in q8 mode."""
    f = binsT.shape[0]
    dev = binsT.device
    q8 = stats.dtype == torch.int8
    _, comp = _slot_table(chan, num_slots, num_leaves)
    active = offsets.shape[0] - 1
    slot = torch.repeat_interleave(torch.arange(active, device=dev),
                                   offsets[1:] - offsets[:-1])
    cells = ((slot[:, None] * f + torch.arange(f, device=dev)[None, :])
             * num_bins + binsT[:, rows].T.to(torch.int64))
    if q8:
        contrib = stats[rows].to(torch.int32)
    else:
        contrib, k, finite = _to_fixed(stats[rows], _absmax(stats)
                                       if amax is None else amax, m)
    acc = torch.zeros((active * f * num_bins, _STATS), dtype=contrib.dtype,
                      device=dev)
    acc.index_add_(0, cells.reshape(-1), contrib[:, None, :].expand(
        rows.shape[0], f, _STATS).reshape(-1, _STATS))
    planes = acc.reshape(active, f, num_bins, _STATS)
    if not q8:
        planes = _from_fixed(planes, k, finite, dtype)
    out = torch.zeros((num_slots, f, num_bins, _STATS), dtype=planes.dtype,
                      device=dev)
    on = torch.as_tensor(comp >= 0, device=dev)
    out[on] = planes[torch.as_tensor(comp[comp >= 0], dtype=torch.int64,
                                     device=dev)]
    return out


def _block_cells(vals: torch.Tensor, bins: torch.Tensor,
                 num_bins: int) -> torch.Tensor:
    """[gf * B, 3] sums of ``vals`` [R, 3] over a block's rows at their
    ``bins`` [R, gf] of a feature group (bins >= B are dropped, as the
    kernel drops them), in the dtype of ``vals``."""
    r, gf = bins.shape
    ok = (bins < num_bins).reshape(-1, 1)
    cells = (torch.arange(gf, device=bins.device)[None, :] * num_bins
             + bins.clamp(max=num_bins - 1)).reshape(-1)
    contrib = vals[:, None, :].expand(r, gf, _STATS).reshape(-1, _STATS)
    acc = torch.zeros((gf * num_bins, _STATS), dtype=vals.dtype,
                      device=bins.device)
    return acc.index_add_(0, cells, torch.where(ok, contrib, 0))


def full_accumulate_plain(binsT: torch.Tensor, leaf_ids: torch.Tensor,
                          stats: torch.Tensor, chan: torch.Tensor,
                          num_slots: int, num_bins: int, num_leaves: int,
                          amax: Optional[torch.Tensor] = None,
                          blocks: int = 3,
                          dtype: torch.dtype = torch.float32,
                          rows: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``hist_tile``'s full form (``idx=None``). One
    computed slot (the root pass): ``full_accumulate``'s decomposition --
    ``blocks`` row ranges of a multiple of 32 rows, each block's rows of the
    slot's leaf summed per feature group of ``full_layout`` into cells of
    its own; in f32 mode each cell is the two 32-bit words ``add_split``
    keeps (the low word's carries added to the high word, both modulo 2^32)
    of the fixed-point values of ``hist_tile_exact`` (scale 2^k from
    ``amax``, by default max|stat| over all N rows, and N); the blocks'
    cells added as int64 (the flush), one conversion to ``dtype`` (the
    convert): bitwise ``hist_tile_exact``. Several computed slots: the
    gather form's plain pipeline over all N rows. q8 mode (int8 stats):
    exact int32 sums. Slots that compute nothing come out zero. ``rows``:
    the exponent's row count (default N). Returns [P, F, B, 3] in
    ``dtype``, or int32 in q8 mode."""
    f, n = binsT.shape
    dev = binsT.device
    q8 = stats.dtype == torch.int8
    m = n if rows is None else rows
    lanes, comp = _slot_table(chan, num_slots, num_leaves)
    if int((comp >= 0).sum()) > 1:
        offsets, kept = gather_partition_plain(leaf_ids, chan, num_slots,
                                               num_leaves)
        return gather_accumulate_plain(binsT, stats, offsets, kept, chan,
                                       num_slots, num_bins, num_leaves, m,
                                       amax, dtype)
    out = torch.zeros((num_slots, f, num_bins, _STATS),
                      dtype=torch.int32 if q8 else dtype, device=dev)
    on = np.flatnonzero(comp == 0)
    if not on.size or n == 0 or f == 0:
        return out
    slot = int(on[0])
    group = full_layout(f, num_bins, q8)[0]
    if q8:
        vals = stats.to(torch.int32)
    else:
        vals, k, finite = _to_fixed(stats, _absmax(stats) if amax is None
                                    else amax, m)
        lo, hi = vals & 0xFFFFFFFF, vals >> 32     # the two words of a value
    sums = torch.zeros((f * num_bins, _STATS), dtype=vals.dtype, device=dev)
    kept = leaf_ids == int(lanes[slot])
    per = -(-n // blocks)
    per = -(-per // 32) * 32
    for r0 in range(0, n, per):
        r = r0 + torch.nonzero(kept[r0:r0 + per]).reshape(-1)
        for g0 in range(0, f, group):
            gf = min(group, f - g0)
            bins = binsT[g0:g0 + gf, r].T.to(torch.int64)       # [R, gf]
            if q8:
                cell = _block_cells(vals[r], bins, num_bins)
            else:
                lo_sum = _block_cells(lo[r], bins, num_bins)
                hi_word = (_block_cells(hi[r], bins, num_bins)
                           + (lo_sum >> 32))
                hi_word = ((hi_word + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
                cell = hi_word * 2 ** 32 + (lo_sum & 0xFFFFFFFF)
            sums[g0 * num_bins:(g0 + gf) * num_bins] += cell
    planes = sums.reshape(f, num_bins, _STATS)
    out[slot] = planes if q8 else _from_fixed(planes, k, finite, dtype)
    return out


_cpu_sums = threading.local()      # the calling thread's switch (``on``)


def kernel_sums_active() -> bool:
    """Whether the calling thread is inside ``kernel_sums_on_cpu()``."""
    return getattr(_cpu_sums, "on", False)


@contextlib.contextmanager
def kernel_sums_on_cpu():
    """Within the block, ``hist_tile`` on a CPU tensor sums as the kernel
    does (``hist_tile_exact``, in the f32 and the f64 mode) instead of in
    the JAX package's float order, and ``ops/rank.lambdarank_grads`` adds in the kernel's partner
    order (``lambdarank_grads_exact``): a CPU run that reproduces a card
    run's bits. The switch is the calling thread's (thread-ranks of one
    process each enter it for their own run)."""
    old = kernel_sums_active()
    _cpu_sums.on = True
    try:
        yield
    finally:
        _cpu_sums.on = old


def gather_layout(num_features: int, num_bins: int,
                  q8: bool) -> Tuple[int, int, int]:
    """The gather form's launch shape: (features a block accumulates, bytes
    of a row of the row-major bin copy, rung entries a scatter block
    stages). A block's planes ([group, B, 3] cells of 8 bytes in f32 mode,
    4 in q8) fill at most its shared memory: 37 features at 255 bins in
    f32, so the 28 Higgs features take one group."""
    check_bins_cap(num_bins)
    cell = 4 if q8 else 8
    fit = min(_GATHER_THREADS, (SMEM_PER_BLOCK - _STATIC_SMEM)
              // (num_bins * _STATS * cell))
    ngroups = -(-num_features // fit)
    group = -(-num_features // ngroups)
    return group, _row_width(num_features), _SCATTER_TILE


def check_bins_cap(num_bins: int) -> None:
    """Raise for more bins a device column than the kernels hold: one
    feature's [B, 3] plane in one block's shared memory (every layout fits
    up to ``MAX_BINS_WIDE``)."""
    if num_bins > MAX_BINS_WIDE:
        raise NotImplementedError(
            f"{num_bins} bins in a device column exceed the kernels' cap of "
            f"{MAX_BINS_WIDE} (one feature's plane in one block's shared "
            f"memory); splitting a feature's bins across blocks arrives "
            f"with ROADMAP.md Queue 2 item 3")


def _row_width(num_features: int) -> int:
    """Elements of a row of the row-major bin copy: F padded to a power of
    two up to 32 (then to a multiple of 32), so no uint8 row straddles a
    32-byte sector (a 16-bit row of up to 32 features fills whole
    sectors)."""
    width = 4
    while width < min(num_features, 32):
        width *= 2
    if num_features > 32:
        width = -(-num_features // 32) * 32
    return width


def full_layout(num_features: int, num_bins: int,
                q8: bool) -> Tuple[int, int]:
    """The launch shape of ``full_accumulate`` (the full form of a tile
    with one computed slot): (features a block accumulates, bytes of a row
    of the row-major bin copy -- ``gather_layout``'s, so both forms share
    one copy). A block's shared memory holds its 32 warps' staged rows (32
    a warp: row id and stats, 28 bytes a row in f32 mode, 8 in q8) and its
    planes ([group, B, 3] cells of 8 bytes in f32 mode, 4 in q8): 33
    features fit at 255 bins in f32, so the 28 Higgs features take one
    group; 8 fit at 1,023 bins, so they take 4 groups of 7, and the rows
    are read 4 times."""
    check_bins_cap(num_bins)
    room = SMEM_PER_BLOCK - _STATIC_SMEM - _FULL_THREADS * (8 if q8 else 28)
    fit = room // (num_bins * _STATS * (4 if q8 else 8))
    ngroups = -(-num_features // fit)
    return -(-num_features // ngroups), _row_width(num_features)


def bins_by_row(binsT: torch.Tensor, width: int) -> torch.Tensor:
    """[N, width] row-major copy of the bin matrix in its dtype (uint8, or
    int16 in the wide mode; zero-padded past F), which the kernels read
    rows of. Kept on the ``binsT`` tensor
    itself and made again only after an in-place write to it (its version
    counter) or for another width, so a trainer makes it once per
    Dataset (the blocked pass once per column block:
    ``models/grower.column_blocks``); ``bins_by_row.copies`` counts the
    copies made."""
    kept = getattr(binsT, "_bins_by_row", None)
    if kept is not None and kept[0] == binsT._version \
            and kept[1].shape[1] == width:
        return kept[1]
    f, n = binsT.shape
    rows = torch.zeros((n, width), dtype=binsT.dtype, device=binsT.device)
    rows[:, :f] = binsT.T
    binsT._bins_by_row = (binsT._version, rows)
    bins_by_row.copies += 1
    return rows


bins_by_row.copies = 0      # row-major copies made (not a launch count)


def hist_tile(binsT: torch.Tensor, leaf_ids: torch.Tensor,
              stats: torch.Tensor, chan: torch.Tensor, num_slots: int,
              num_bins: int, num_leaves: int,
              idx: Optional[torch.Tensor] = None,
              plane: bool = False,
              amax: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.float32,
              rows: Optional[int] = None,
              raw: bool = False) -> torch.Tensor:
    """[P, F, B, 3] histogram planes of the computed slots (see the module
    docstring). ``binsT`` [F, N] uint8, ``leaf_ids`` [N] int32, ``stats``
    [N, 3] f32 (f32 mode; float32 planes) or int8 (q8 mode; int32 planes),
    ``chan`` [1, 128] int32 (chan_leaf_table of the computed selection;
    read on the host to size the launch), ``idx`` [M] int32 or None;
    ``plane`` marks a classic-path launch. ``amax`` (f32 mode only): [3]
    float32 max|stat| of each channel over all N rows, which sets the
    fixed-point scale; a caller that keeps the stats for several passes
    computes it once, and without it every launch computes it. int16
    ``binsT`` selects the wide mode (up to ``MAX_BINS_WIDE`` bins).
    ``dtype`` torch.float64 selects the f64 mode (``gpu_use_dp``): float
    stats, the same fixed-point sums converted once to float64 planes; a
    plane-only launch only (the fused path's epilogue takes float32).

    The integer-planes mode (the distributed learners' passes, whose
    planes other ranks' planes add to): ``rows`` is the row count the
    fixed-point exponent is taken over (by default the pass's own, N or
    the rung's M), and ``raw=True`` returns the f32 mode's int64 sums
    before the convert; with the gang's max|stat| as ``amax`` and the
    gang's row count as ``rows``, every rank's planes share one exponent,
    so they add exactly, in any order, and ``hist_convert`` turns the sum
    into the planes one pass over all the gang's rows gives. In q8 mode
    the planes are integer already (int32) and ``raw`` changes nothing."""
    q8 = stats.dtype == torch.int8
    wide = binsT.dtype == torch.int16
    dp = dtype == torch.float64
    raw = raw and not q8
    _check(not raw or (plane and not dp), "hist_tile: the integer-planes "
           "mode is a plane-only launch of the f32 mode")
    _check(dtype in (torch.float32, torch.float64), f"hist_tile: planes are "
           f"float32 or float64, not {dtype}")
    _check(not dp or (plane and not q8), "hist_tile: the f64 mode is the "
           "plane-only forms' (classic path) and takes float stats")
    _check(not q8 or binsT.shape[1] <= Q8_MAX_ROWS, f"hist_tile: q8 sums "
           f"overflow int32 beyond {Q8_MAX_ROWS} rows (got {binsT.shape[1]})")
    _check(amax is None or not q8, "hist_tile: amax sets the f32 mode's "
           "fixed-point scale; the q8 mode has none")
    if binsT.device.type == "cpu":
        if raw:
            return hist_tile_exact(binsT, leaf_ids, stats, chan, num_slots,
                                   num_bins, num_leaves, idx, amax, rows=rows,
                                   raw=True)
        if kernel_sums_active() and not q8:
            if idx is None:
                return full_accumulate_plain(binsT, leaf_ids, stats, chan,
                                             num_slots, num_bins,
                                             num_leaves, amax, dtype=dtype,
                                             rows=rows)
            return hist_tile_exact(binsT, leaf_ids, stats, chan, num_slots,
                                   num_bins, num_leaves, idx, amax, dtype,
                                   rows=rows)
        return hist_tile_plain(binsT, leaf_ids, stats, chan, num_slots,
                               num_bins, num_leaves, idx, dtype)
    _check(binsT.device.type == "cuda", f"hist_tile: no kernel for device "
           f"{binsT.device}")
    f, n = binsT.shape
    dev = binsT.device
    for name, t, dt in (("binsT", binsT, torch.int16 if wide
                         else torch.uint8),
                        ("leaf_ids", leaf_ids, torch.int32),
                        ("stats", stats, torch.int8 if q8 else torch.float32),
                        ("chan", chan, torch.int32)) + (
            (("idx", idx, torch.int32),) if idx is not None else ()) + (
            (("amax", amax, torch.float32),) if amax is not None else ()):
        _check(t.device == dev or name == "chan", f"hist_tile: {name} on "
               f"{t.device}, binsT on {dev}")
        _check(t.dtype == dt, f"hist_tile: {name} must be {dt}, got {t.dtype}")
        _check(t.is_contiguous(), f"hist_tile: {name} must be contiguous")
    _check(leaf_ids.shape == (n,), f"hist_tile: leaf_ids {tuple(leaf_ids.shape)}"
           f" != ({n},)")
    _check(stats.shape == (n, _STATS), f"hist_tile: stats "
           f"{tuple(stats.shape)} != ({n}, 3)")
    _check(amax is None or amax.shape == (_STATS,), "hist_tile: amax must "
           "hold 3 channels")
    _check(chan.numel() == _PAD, "hist_tile: chan must hold 128 lanes")
    _check(1 <= num_slots and num_slots * _STATS <= _PAD,
           f"hist_tile: {num_slots} slots exceed the 128-lane tables")
    cap = MAX_BINS_WIDE if wide else MAX_BINS
    if wide:
        check_bins_cap(num_bins)
    _check(1 <= num_bins <= cap, f"hist_tile: num_bins {num_bins} outside "
           f"[1, {cap}] for {binsT.dtype} bins")
    _check(n < 2 ** 31, "hist_tile: more than 2^31 rows")
    lanes, comp_np = _slot_table(chan, num_slots, num_leaves)
    active = int((comp_np >= 0).sum())
    m = n if idx is None else idx.shape[0]
    exp_rows = m if rows is None else int(rows)
    _check(exp_rows >= m, f"hist_tile: the exponent's {exp_rows} rows are "
           f"fewer than the pass's {m}")
    out = torch.empty((num_slots, f, num_bins, _STATS),
                      dtype=torch.int32 if q8 else torch.int64 if raw
                      else dtype, device=dev)
    if m == 0 or f == 0:
        return out.zero_()
    lib = _lib("hist_tile")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if idx is None and active <= 1:
        err = _launch_full(lib, binsT, leaf_ids, stats, lanes, comp_np, amax,
                           out, q8, dp, n, f, num_slots, num_bins, stream,
                           exp_rows, raw)
    else:
        err = _launch_gather(lib, binsT, leaf_ids, stats, lanes, comp_np,
                             idx, amax, out, q8, dp, n, f, m, num_slots,
                             num_bins, num_leaves, active, stream, exp_rows,
                             raw)
    sfx = ("_wide" if wide else "") + ("_q8" if q8 else "_dp" if dp
                                       else "_raw" if raw else "")
    _count(hist_tile, "launches" + sfx)
    if idx is not None:
        _count(hist_tile, "gather_launches" + sfx)
    if plane:
        _count(hist_tile, "launches_plane" + sfx)
    _raise_on(err, "hist_tile")
    return out


def _launch_full(lib, binsT, leaf_ids, stats, lanes, comp_np, amax, out,
                 q8, dp, n, f, p, b, stream, exp_rows, raw) -> int:
    """The full-row form of a tile with one computed slot: full_accumulate
    over the row-major bins, convert (csrc/hist_tile.cu); a tile with none
    launches the convert alone, which writes zeros. No slot table on the
    device (the slot and its leaf go as arguments) and one scratch buffer,
    zeroed by the launcher (the integer sums and stat_absmax's words when
    ``amax`` is None); no host sync. Returns the launcher's cudaError."""
    group, width = full_layout(f, b, q8)
    rows = bins_by_row(binsT, width)
    on = np.flatnonzero(comp_np == 0)
    slot, target = (int(on[0]), int(lanes[on[0]])) if on.size else (-1, -1)
    amax_off = -(-f * b * _STATS * (4 if q8 else 8) // 8) * 8
    scratch = torch.empty((amax_off // 8 + 2,), dtype=torch.int64,
                          device=binsT.device)
    base = scratch.data_ptr()
    return lib.hist_full_launch(
        _ptr(rows), _ptr(leaf_ids), _ptr(stats),
        None if q8 else (base + amax_off if amax is None else _ptr(amax)),
        int(amax is None and not q8), base, scratch.numel() * 8, base,
        _ptr(out), int(q8), int(rows.dtype == torch.int16), int(dp), n, f,
        p, b, slot, target, group, width, exp_rows, int(raw), stream)


def _launch_gather(lib, binsT, leaf_ids, stats, lanes, comp_np, idx, amax,
                   out, q8, dp, n, f, m, p, b, l, active, stream, exp_rows,
                   raw) -> int:
    """The gather form: partition the rung's rows into slot-grouped runs of
    (row, stats), accumulate them over the row-major bins, convert
    (csrc/hist_tile.cu); ``idx`` None is the full form of a tile with
    several computed slots, over the implicit rung of all N rows. One
    host-to-device copy (the leaf -> compact slot table and the slots'
    compact indices; from pageable memory without waiting for the stream)
    and one scratch buffer, zeroed by the launcher (the integer sums, the
    slot counts and cursors, and stat_absmax's words when ``amax`` is
    None); no host sync. Returns the launcher's cudaError."""
    dev = binsT.device
    group, width, tile = gather_layout(f, b, q8)
    rows = bins_by_row(binsT, width)
    table = np.full((l + p,), -1, dtype=np.int32)
    table[lanes[comp_np >= 0]] = comp_np[comp_np >= 0]
    table[l:] = comp_np
    slotmap = torch.from_numpy(table).to(dev, non_blocking=True)
    acc_bytes = active * f * b * _STATS * (4 if q8 else 8)
    cnt_off = -(-acc_bytes // 8) * 8
    amax_off = cnt_off + -(-8 * active // 8) * 8
    scratch = torch.empty((amax_off // 8 + 2,), dtype=torch.int64,
                          device=dev)
    base = scratch.data_ptr()
    payload = torch.empty((m * (2 if q8 else 8),), dtype=torch.int32,
                          device=dev)
    return lib.hist_gather_launch(
        _ptr(rows), _ptr(leaf_ids), _ptr(stats), _ptr(slotmap), _ptr(idx),
        None if q8 else (base + amax_off if amax is None else _ptr(amax)),
        int(amax is None and not q8), base, scratch.numel() * 8,
        base + cnt_off, _ptr(payload), base, _ptr(out), int(q8),
        int(rows.dtype == torch.int16), int(dp), n, f, m, p, b, l, active,
        group, width, tile, exp_rows, int(raw), stream)


def hist_convert(acc: torch.Tensor, amax: torch.Tensor, rows: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The integer-planes mode's convert as a launch of its own
    (``csrc/hist_tile.cu`` ``hist_convert``): int64 fixed-point planes
    [P, F, B, 3] -- one rank's ``hist_tile(raw=True)``, or the gang's sum of
    them -- whose exponent came from ``amax`` [3] float32 and ``rows``, to
    ``dtype`` planes (float32, or float64 in the f64 mode), with
    ``hist_tile``'s convert's rounding. On a CPU tensor its plain version
    (``hist_convert_plain``)."""
    _check(acc.dtype == torch.int64 and acc.shape[-1] == _STATS,
           f"hist_convert: int64 [..., 3] planes, got {acc.dtype} "
           f"{tuple(acc.shape)}")
    _check(dtype in (torch.float32, torch.float64),
           f"hist_convert: planes are float32 or float64, not {dtype}")
    if acc.device.type == "cpu":
        return hist_convert_plain(acc, amax.to(torch.float32), rows, dtype)
    _check(acc.device.type == "cuda", f"hist_convert: no kernel for device "
           f"{acc.device}")
    _check(acc.is_contiguous(), "hist_convert: acc must be contiguous")
    _check(amax.device == acc.device and amax.dtype == torch.float32
           and amax.shape == (_STATS,) and amax.is_contiguous(),
           "hist_convert: amax must be [3] float32 on the planes' device")
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    if acc.numel() == 0:
        return out
    dp = dtype == torch.float64
    err = _lib("hist_tile").hist_convert_launch(
        _ptr(acc), _ptr(amax), _ptr(out), acc.numel() // _STATS, int(rows),
        int(dp), torch.cuda.current_stream(acc.device).cuda_stream)
    _count(hist_convert, "launches_dp" if dp else "launches")
    _raise_on(err, "hist_convert")
    return out


_COUNTERS: Dict[str, Tuple[str, ...]] = {}   # wrapper name -> counters
_COUNTED = {}                                # wrapper name -> wrapper


def register_counters(fn, names: Tuple[str, ...]) -> None:
    """Count the kernel wrapper ``fn`` (this module's or another's) with
    the counters ``names``, set to 0 here; ``reset_launch_counts`` and
    ``launch_counts`` cover every registered wrapper."""
    _COUNTERS[fn.__name__] = tuple(names)
    _COUNTED[fn.__name__] = fn
    for c in names:
        setattr(fn, c, 0)


def _count(fn, name: str) -> None:
    setattr(fn, name, getattr(fn, name) + 1)
    profiling.note_launch()


# ------------------------------------------------------------- split_epilogue
def split_epilogue_plain(tile: torch.Tensor, parent: torch.Tensor,
                         der: torch.Tensor, la: torch.Tensor, fm: torch.Tensor,
                         pv: torch.Tensor,
                         q_scale: Optional[torch.Tensor] = None,
                         with_monotone: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``split_epilogue``: ops/histogram.py
    ``derive_and_scan`` with the derived slots read from the lane table
    (q8 mode with ``q_scale``; the monotone mode with ``with_monotone``).
    Returns (full planes [P, F, B, 3], cand [P, F, 12])."""
    from .histogram import derive_and_scan
    p = tile.shape[0]
    derive = der.reshape(-1)[0:p * _STATS:_STATS] != 0
    return derive_and_scan(tile, derive, parent, la, fm, pv,
                           q8=q_scale is not None, q_scale=q_scale,
                           with_monotone=with_monotone)


def split_epilogue(tile: torch.Tensor, parent: torch.Tensor,
                   der: torch.Tensor, la: torch.Tensor, fm: torch.Tensor,
                   pv: torch.Tensor, q_scale: Optional[torch.Tensor] = None,
                   with_monotone: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Derive + numerical split scan of one tile (see the module
    docstring). ``tile`` [P, F, B, 3] f32, or int32 in q8 mode with
    ``q_scale`` [3] f32; ``parent`` [P, F, B, 3] f32, ``der`` [1, 128]
    int32 (_epilogue_lanes), ``la`` [P, 8], ``fm`` [F, 8], ``pv`` [8] f32.
    ``with_monotone``: the basic monotone mode, each slot's candidates
    clipped to its bounds ``la[:, 4:6]`` and those breaking their
    feature's direction ``fm[:, 3]`` at gain 0. Returns (full planes
    [P, F, B, 3] f32, cand [P, F, 12]). Each of the four modes counts its
    own launches (``launches``, ``launches_q8``, ``launches_mono``,
    ``launches_mono_q8``), and each of them above 256 bins (the wide
    mode, up to ``MAX_BINS_WIDE``) its own again (``launches_wide``,
    ``launches_wide_q8``, ``launches_wide_mono``,
    ``launches_wide_mono_q8``)."""
    q8 = q_scale is not None
    if tile.device.type == "cpu":
        return split_epilogue_plain(tile, parent, der, la, fm, pv, q_scale,
                                    with_monotone)
    _check(tile.device.type == "cuda", f"split_epilogue: no kernel for "
           f"device {tile.device}")
    dev = tile.device
    p, f, b, s = tile.shape
    checks = (("tile", tile, torch.int32 if q8 else torch.float32,
               (p, f, b, 3)),
              ("parent", parent, torch.float32, (p, f, b, 3)),
              ("der", der, torch.int32, (1, _PAD)),
              ("la", la, torch.float32, (p, 8)),
              ("fm", fm, torch.float32, (f, 8)),
              ("pv", pv, torch.float32, (8,)))
    if q8:
        checks += (("q_scale", q_scale, torch.float32, (_STATS,)),)
    for name, t, dt, shape in checks:
        _check(t.device == dev, f"split_epilogue: {name} on {t.device}")
        _check(t.dtype == dt, f"split_epilogue: {name} must be {dt}")
        _check(tuple(t.shape) == shape, f"split_epilogue: {name} "
               f"{tuple(t.shape)} != {shape}")
        _check(t.is_contiguous(), f"split_epilogue: {name} not contiguous")
    check_bins_cap(b)
    _check(s == _STATS and p * _STATS <= _PAD and 1 <= b <= MAX_BINS_WIDE,
           f"split_epilogue: tile shape {tuple(tile.shape)} unsupported")
    from .split import CAND_CHANNELS
    full = torch.empty_like(parent)
    cand = torch.empty((p, f, CAND_CHANNELS), dtype=torch.float32, device=dev)
    err = _lib("split_epilogue").split_epilogue_launch(
        _ptr(tile), _ptr(q_scale), _ptr(parent), _ptr(der), _ptr(la),
        _ptr(fm), _ptr(pv), _ptr(full), _ptr(cand), p, f, b,
        int(with_monotone), torch.cuda.current_stream(dev).cuda_stream)
    _count(split_epilogue, "launches" + ("_wide" if b > MAX_BINS else "")
           + ("_mono" if with_monotone else "") + ("_q8" if q8 else ""))
    _raise_on(err, "split_epilogue")
    return full, cand


# ---------------------------------------------------------------- hist_onehot
_ONEHOT_LANES = 128         # folded output lanes
_ONEHOT_RHS = 2 * _ONEHOT_LANES   # rhs lanes: the hi and lo halves
_ONEHOT_TILE = 256          # output rows of one block's tile
_ONEHOT_STAGE = 64          # data rows of one stage (chunks are whole stages)


def hist_onehot_plain(binsT: torch.Tensor, rhs: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """Plain version of ``hist_onehot``: per feature, one float32
    ``index_add_`` of the folded rhs rows (``rhs[:, :128] + rhs[:, 128:]``
    in float32) at their bins. Returns out [F * B, 128] f32."""
    f, n = binsT.shape
    folded = (rhs[:, :_ONEHOT_LANES].to(torch.float32)
              + rhs[:, _ONEHOT_LANES:].to(torch.float32))
    out = torch.zeros((f * num_bins, _ONEHOT_LANES), dtype=torch.float32,
                      device=binsT.device)
    for j in range(f):
        bins = binsT[j].to(torch.int64)
        keep = bins < num_bins
        out[j * num_bins:(j + 1) * num_bins].index_add_(
            0, bins[keep], folded[keep])
    return out


def onehot_layout(f: int, n: int, num_bins: int, fg: int, sms: int):
    """The launch's geometry: (tiles per group, tiles, features a tile's
    bins box holds, chunks, rows a chunk).
    The chunk count makes the blocks (one per SM) fill whole waves where it
    can, with chunks of at least 16 stages."""
    ngroups = -(-f // fg)
    tpg = -(-fg * num_bins // _ONEHOT_TILE)
    ntiles = ngroups * tpg
    nf_box = min(fg, (_ONEHOT_TILE + num_bins - 2) // num_bins + 1)
    most = max(1, min(128, n // (16 * _ONEHOT_STAGE)))
    nchunk = max(range(1, most + 1), key=lambda c: (
        ntiles * c / (-(-ntiles * c // sms) * sms), -c))
    per_chunk = -(-(-(-n // nchunk)) // _ONEHOT_STAGE) * _ONEHOT_STAGE
    nchunk = max(1, -(-n // per_chunk))
    return tpg, ntiles, nf_box, nchunk, per_chunk


def hist_onehot(binsT: torch.Tensor, rhs: torch.Tensor, num_bins: int,
                fg: int, blk: int) -> torch.Tensor:
    """out [F * B, 128] f32: out[f*B + b, q] = sum over rows r with
    binsT[f, r] == b of rhs[r, q] + rhs[r, q + 128], accumulated in f32.
    ``binsT`` [F, N] uint8, ``rhs`` [N, 256] bf16, N a multiple of ``blk``;
    ``fg`` features per group (on this design it sets the padding of a
    group's one-hot rows to whole 256-row tiles), ``blk`` rows per block
    (it sets nothing in the kernel, whose chunks are whole 64-row stages).
    On the card N must be a multiple of 16 (the bins' TMA row stride)."""
    f, n = binsT.shape
    _check(rhs.shape == (n, _ONEHOT_RHS), f"hist_onehot: rhs "
           f"{tuple(rhs.shape)} != ({n}, {_ONEHOT_RHS})")
    _check(fg >= 1 and blk >= 1 and n % blk == 0, f"hist_onehot: {n} rows "
           f"are no multiple of blk={blk} (or fg={fg} < 1)")
    _check(1 <= num_bins <= MAX_BINS, f"hist_onehot: num_bins {num_bins} "
           f"outside [1, {MAX_BINS}]")
    if binsT.device.type == "cpu":
        return hist_onehot_plain(binsT, rhs, num_bins)
    _check(binsT.device.type == "cuda", f"hist_onehot: no kernel for device "
           f"{binsT.device}")
    dev = binsT.device
    for name, t, dt in (("binsT", binsT, torch.uint8),
                        ("rhs", rhs, torch.bfloat16)):
        _check(t.device == dev, f"hist_onehot: {name} on {t.device}, binsT "
               f"on {dev}")
        _check(t.dtype == dt, f"hist_onehot: {name} must be {dt}")
        _check(t.is_contiguous(), f"hist_onehot: {name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"hist_onehot: {name} must be "
               f"16-byte aligned (TMA)")
    _check(n % 16 == 0, f"hist_onehot: {n} rows are no multiple of 16 (the "
           f"bins' row stride for TMA)")
    out = torch.empty((f * num_bins, _ONEHOT_LANES), dtype=torch.float32,
                      device=dev)
    if n == 0 or f == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tpg, ntiles, nf_box, nchunk, per_chunk = onehot_layout(
        f, n, num_bins, fg, sms)
    partial = torch.empty((nchunk, ntiles, _ONEHOT_TILE, _ONEHOT_LANES),
                          dtype=torch.float32, device=dev)
    err = _lib("hist_onehot").hist_onehot_launch(
        _ptr(binsT), _ptr(rhs), _ptr(partial), _ptr(out), f, n, num_bins, fg,
        tpg, ntiles, nchunk, per_chunk, nf_box,
        torch.cuda.current_stream(dev).cuda_stream)
    _count(hist_onehot, "launches")
    _raise_on(err, "hist_onehot")
    return out


def reset_launch_counts() -> None:
    """Set every kernel's launch counters to 0."""
    for name, counters in _COUNTERS.items():
        for c in counters:
            setattr(_COUNTED[name], c, 0)


def launch_counts() -> Dict[str, int]:
    """Every launch counter, as ``kernel.counter``."""
    return {f"{name}.{c}": getattr(_COUNTED[name], c)
            for name, counters in _COUNTERS.items() for c in counters}


register_counters(hist_tile, tuple(
    c + w + q for w in ("", "_wide") for q in ("", "_q8", "_dp", "_raw")
    for c in ("launches", "gather_launches", "launches_plane")))
register_counters(hist_convert, ("launches", "launches_dp"))
register_counters(split_epilogue, tuple(
    "launches" + w + m + q for w in ("", "_wide") for m in ("", "_mono")
    for q in ("", "_q8")))
register_counters(hist_onehot, ("launches",))
