"""Hopper kernels of the histogram tile pass, their wrappers and plain versions.

The port of lightgbm_tpu's ``ops/pallas_hist.py``. On the TPU a Pallas
kernel accumulates a tile's histogram planes in VMEM: plane-only for the
classic split path (``_fused_kernel`` for full-row passes, ``_gather_kernel``
for compaction-rung passes), or with the split epilogue on its last grid
step for the fused path (``_fused_epi_kernel``, ``_gather_epi_kernel``). On
Hopper that is two hand-written CUDA kernels (``csrc/``):

- ``hist_tile`` (``csrc/hist_tile.cu``): the ``[P, F, B, 3]`` planes of the
  tile's computed slots, in the full-row form (``idx=None``) or the gather
  form (rows ``idx[M]``, entries >= N are padding); deterministic, so two
  launches give the same bits. Two modes, chosen by the stats' dtype: f32
  (float stats, 64-bit fixed-point sums, float32 planes) and q8 (the
  quantized-gradient mode: int8 stats, exact int32 sums, int32 planes).
  ``plane=True`` marks a launch of the classic path (the plane-only
  kernels 3-4). Each mode counts its own launches: ``launches``,
  ``gather_launches`` and ``launches_plane`` for f32, ``launches_q8``,
  ``gather_launches_q8`` and ``launches_plane_q8`` for q8;
- ``split_epilogue`` (``csrc/split_epilogue.cu``): in q8 mode the int32
  tile dequantized by ``q_scale`` first, then the derived slots' planes as
  parent - computed sibling, then the numerical split scan (``ops/split.py
  numerical_candidates``) -> the ``[P, F, 12]`` table.

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
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_PAD = 128                  # lane width of the TPU layout tables
_STATS = 3                  # (grad, hess, count) per row
MAX_BINS = 256              # split_epilogue: one thread per bin
Q8_MAX_ROWS = (2 ** 31 - 1) // 127   # q8: |sum| <= 127 * rows fits int32
SMEM_PER_BLOCK = 232_448    # Hopper: dynamic shared memory a block can use
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_SOURCES = ("hist_tile", "split_epilogue", "hist_onehot")
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


def pack_leaf_aux(sum_g, sum_h, cnt, output) -> torch.Tensor:
    """[P, 8] f32 per-slot leaf aggregates (columns: sum_g, sum_h, cnt,
    output, min, max, 0, 0; min/max are the unconstrained bounds)."""
    p = sum_g.shape[0]
    big = float(np.finfo(np.float32).max)
    dev = sum_g.device
    cols = [sum_g, sum_h, cnt, output,
            torch.full((p,), -big, device=dev), torch.full((p,), big, device=dev),
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
        lib.hist_tile_launch.argtypes = [vp] * 9 + [ci] * 10 + [vp]
        lib.hist_tile_launch.restype = ci
        lib.hist_tile_q8_launch.argtypes = [vp] * 8 + [ci] * 10 + [vp]
        lib.hist_tile_q8_launch.restype = ci
    elif name == "split_epilogue":
        lib.split_epilogue_launch.argtypes = [vp] * 9 + [ci] * 3 + [vp]
        lib.split_epilogue_launch.restype = ci
    else:
        ll = ctypes.c_longlong
        lib.hist_onehot_launch.argtypes = ([vp] * 4 + [ci, ll] + [ci] * 5
                                           + [ll, vp])
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
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``hist_tile``: one flat ``index_add_`` over the kept
    rows in row order. f32 mode: float32 sums, on the CPU bitwise equal to
    the JAX package's ``histogram_scatter`` / scatter-method tile, and the
    CPU path's histogram; q8 mode (int8 ``stats``): int32 sums, exact and
    order-free. Returns [P, F, B, 3] f32, or int32 in q8 mode."""
    f = binsT.shape[0]
    acc = torch.int32 if stats.dtype == torch.int8 else torch.float32
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


def hist_tile_exact(binsT: torch.Tensor, leaf_ids: torch.Tensor,
                    stats: torch.Tensor, chan: torch.Tensor, num_slots: int,
                    num_bins: int, num_leaves: int,
                    idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``hist_tile``'s own arithmetic in plain PyTorch: each stat scaled by
    2^k and rounded to a 64-bit integer, integer sums (order-free), one
    conversion back to float32 -- bitwise the kernel's planes on any stats
    (a non-finite stat makes its channel NaN). Returns [P, F, B, 3] f32."""
    f, n = binsT.shape
    m = n if idx is None else idx.shape[0]
    dev = binsT.device
    rows, cells = _tile_cells(binsT, leaf_ids, chan, num_slots, num_bins,
                              num_leaves, idx)
    amax = stats.to(torch.float32).abs().amax(0)
    finite = torch.isfinite(amax)
    k = torch.where(finite, _fixed_exponent(amax, m), 0)
    one = torch.ones((_STATS,), dtype=torch.float64, device=dev)
    fixed = torch.round(stats[rows].to(torch.float64)
                        * torch.ldexp(one, k)).to(torch.int64)
    contrib = fixed[:, None, :].expand(rows.shape[0], f, _STATS).reshape(
        -1, _STATS)
    acc = torch.zeros((num_slots * f * num_bins, _STATS), dtype=torch.int64,
                      device=dev)
    acc.index_add_(0, cells.reshape(-1), contrib)
    out = (acc.to(torch.float64) * torch.ldexp(one, -k)).to(torch.float32)
    out = torch.where(finite, out, torch.full_like(out, float("nan")))
    return out.reshape(num_slots, f, num_bins, _STATS)


_cpu_sums = {"kernel": False}


@contextlib.contextmanager
def kernel_sums_on_cpu():
    """Within the block, ``hist_tile`` on a CPU tensor sums as the kernel
    does (``hist_tile_exact``) instead of in the JAX package's float32
    order: a CPU run that reproduces a card run's bits."""
    old = _cpu_sums["kernel"]
    _cpu_sums["kernel"] = True
    try:
        yield
    finally:
        _cpu_sums["kernel"] = old


def _hist_chunks(blocks_per_chunk: int, m: int, dev: torch.device) -> int:
    """Row chunks: one wave of blocks over the card's SMs (one block per
    SM fits at the main path's shared-memory size), no chunk under 1024
    rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return int(max(1, min(max(1, sms // max(blocks_per_chunk, 1)),
                          -(-m // 1024))))


def hist_slot_parts(active: int, num_bins: int, num_leaves: int,
                    cell_bytes: int = 8) -> Tuple[int, int]:
    """(parts, slots per part): the planes of ``active`` computed slots
    (``cell_bytes`` a cell: 8 for the f32 mode's int64 sums, 4 for q8's
    int32) split into parts that each fit a block's shared memory."""
    fit = (SMEM_PER_BLOCK - num_leaves * 4) // (num_bins * _STATS
                                                 * cell_bytes)
    _check(fit >= 1, f"hist_tile: {num_bins} bins + {num_leaves} leaves "
           f"leave no room for one slot in {SMEM_PER_BLOCK} bytes of shared "
           f"memory")
    parts = -(-active // fit)
    return parts, -(-active // parts)


def hist_tile(binsT: torch.Tensor, leaf_ids: torch.Tensor,
              stats: torch.Tensor, chan: torch.Tensor, num_slots: int,
              num_bins: int, num_leaves: int,
              idx: Optional[torch.Tensor] = None,
              plane: bool = False) -> torch.Tensor:
    """[P, F, B, 3] histogram planes of the computed slots (see the module
    docstring). ``binsT`` [F, N] uint8, ``leaf_ids`` [N] int32, ``stats``
    [N, 3] f32 (f32 mode; float32 planes) or int8 (q8 mode; int32 planes),
    ``chan`` [1, 128] int32 (chan_leaf_table of the computed selection;
    read on the host to size the launch), ``idx`` [M] int32 or None;
    ``plane`` marks a classic-path launch."""
    q8 = stats.dtype == torch.int8
    _check(not q8 or binsT.shape[1] <= Q8_MAX_ROWS, f"hist_tile: q8 sums "
           f"overflow int32 beyond {Q8_MAX_ROWS} rows (got {binsT.shape[1]})")
    if binsT.device.type == "cpu":
        exact = _cpu_sums["kernel"] and not q8
        plain = hist_tile_exact if exact else hist_tile_plain
        return plain(binsT, leaf_ids, stats, chan, num_slots, num_bins,
                     num_leaves, idx)
    _check(binsT.device.type == "cuda", f"hist_tile: no kernel for device "
           f"{binsT.device}")
    f, n = binsT.shape
    dev = binsT.device
    for name, t, dt in (("binsT", binsT, torch.uint8),
                        ("leaf_ids", leaf_ids, torch.int32),
                        ("stats", stats, torch.int8 if q8 else torch.float32),
                        ("chan", chan, torch.int32)) + (
            (("idx", idx, torch.int32),) if idx is not None else ()):
        _check(t.device == dev or name == "chan", f"hist_tile: {name} on "
               f"{t.device}, binsT on {dev}")
        _check(t.dtype == dt, f"hist_tile: {name} must be {dt}, got {t.dtype}")
        _check(t.is_contiguous(), f"hist_tile: {name} must be contiguous")
    _check(leaf_ids.shape == (n,), f"hist_tile: leaf_ids {tuple(leaf_ids.shape)}"
           f" != ({n},)")
    _check(stats.shape == (n, _STATS), f"hist_tile: stats "
           f"{tuple(stats.shape)} != ({n}, 3)")
    _check(chan.numel() == _PAD, "hist_tile: chan must hold 128 lanes")
    _check(1 <= num_slots and num_slots * _STATS <= _PAD,
           f"hist_tile: {num_slots} slots exceed the 128-lane tables")
    _check(1 <= num_bins <= MAX_BINS, f"hist_tile: num_bins {num_bins} "
           f"outside [1, {MAX_BINS}]")
    _check(n < 2 ** 31, "hist_tile: more than 2^31 rows")
    # the computed slots, in slot order, get compact plane indices
    lanes = chan.reshape(-1)[0:num_slots * _STATS:_STATS].cpu().numpy()
    computed = (lanes >= 0) & (lanes < num_leaves)
    comp_np = np.where(computed, np.cumsum(computed) - 1, -1).astype(np.int32)
    active = int(computed.sum())
    m = n if idx is None else idx.shape[0]
    out = torch.empty((num_slots, f, num_bins, _STATS),
                      dtype=torch.int32 if q8 else torch.float32, device=dev)
    if m == 0 or f == 0:
        return out.zero_()
    # a tile with no computed slot still launches (its blocks return at
    # once and the reduce writes zeros)
    parts, per_part = hist_slot_parts(max(active, 1), num_bins, num_leaves,
                                      4 if q8 else 8)
    nchunk = _hist_chunks(f * parts, m, dev)
    comp = torch.as_tensor(comp_np).to(dev)
    chan_d = chan.to(dev).contiguous()
    partial = torch.empty((nchunk, active, f, num_bins, _STATS),
                          dtype=torch.int32 if q8 else torch.int64,
                          device=dev)
    lib = _lib("hist_tile")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if q8:
        err = lib.hist_tile_q8_launch(
            _ptr(binsT), _ptr(leaf_ids), _ptr(stats), _ptr(chan_d),
            _ptr(comp), _ptr(idx), _ptr(partial), _ptr(out), n, f, m,
            num_slots, num_bins, num_leaves, nchunk, active, per_part, parts,
            stream)
    else:
        amax = torch.zeros((_STATS,), dtype=torch.int32, device=dev)
        err = lib.hist_tile_launch(
            _ptr(binsT), _ptr(leaf_ids), _ptr(stats), _ptr(chan_d),
            _ptr(comp), _ptr(idx), _ptr(amax), _ptr(partial), _ptr(out), n,
            f, m, num_slots, num_bins, num_leaves, nchunk, active, per_part,
            parts, stream)
    sfx = "_q8" if q8 else ""
    _count(hist_tile, "launches" + sfx)
    if idx is not None:
        _count(hist_tile, "gather_launches" + sfx)
    if plane:
        _count(hist_tile, "launches_plane" + sfx)
    _raise_on(err, "hist_tile")
    return out


_COUNTERS = {"hist_tile": ("launches", "gather_launches", "launches_plane",
                           "launches_q8", "gather_launches_q8",
                           "launches_plane_q8"),
             "split_epilogue": ("launches", "launches_q8"),
             "hist_onehot": ("launches",)}


def _count(fn, name: str) -> None:
    setattr(fn, name, getattr(fn, name) + 1)


# ------------------------------------------------------------- split_epilogue
def split_epilogue_plain(tile: torch.Tensor, parent: torch.Tensor,
                         der: torch.Tensor, la: torch.Tensor, fm: torch.Tensor,
                         pv: torch.Tensor,
                         q_scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``split_epilogue``: ops/histogram.py
    ``derive_and_scan`` with the derived slots read from the lane table
    (q8 mode with ``q_scale``). Returns (full planes [P, F, B, 3], cand
    [P, F, 12])."""
    from .histogram import derive_and_scan
    p = tile.shape[0]
    derive = der.reshape(-1)[0:p * _STATS:_STATS] != 0
    return derive_and_scan(tile, derive, parent, la, fm, pv,
                           q8=q_scale is not None, q_scale=q_scale)


def split_epilogue(tile: torch.Tensor, parent: torch.Tensor,
                   der: torch.Tensor, la: torch.Tensor, fm: torch.Tensor,
                   pv: torch.Tensor, q_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Derive + numerical split scan of one tile (see the module
    docstring). ``tile`` [P, F, B, 3] f32, or int32 in q8 mode with
    ``q_scale`` [3] f32; ``parent`` [P, F, B, 3] f32, ``der`` [1, 128]
    int32 (_epilogue_lanes), ``la`` [P, 8], ``fm`` [F, 8], ``pv`` [8] f32.
    Returns (full planes [P, F, B, 3] f32, cand [P, F, 12])."""
    q8 = q_scale is not None
    if tile.device.type == "cpu":
        return split_epilogue_plain(tile, parent, der, la, fm, pv, q_scale)
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
    _check(s == _STATS and p * _STATS <= _PAD and 1 <= b <= MAX_BINS,
           f"split_epilogue: tile shape {tuple(tile.shape)} unsupported")
    from .split import CAND_CHANNELS
    full = torch.empty_like(parent)
    cand = torch.empty((p, f, CAND_CHANNELS), dtype=torch.float32, device=dev)
    err = _lib("split_epilogue").split_epilogue_launch(
        _ptr(tile), _ptr(q_scale), _ptr(parent), _ptr(der), _ptr(la),
        _ptr(fm), _ptr(pv), _ptr(full), _ptr(cand), p, f, b,
        torch.cuda.current_stream(dev).cuda_stream)
    _count(split_epilogue, "launches_q8" if q8 else "launches")
    _raise_on(err, "split_epilogue")
    return full, cand


# ---------------------------------------------------------------- hist_onehot
_ONEHOT_LANES = 128         # folded output lanes
_ONEHOT_RHS = 2 * _ONEHOT_LANES   # rhs lanes: the hi and lo halves
_ONEHOT_TILE = 128          # output rows of one block's tile


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


def _onehot_chunks(blocks: int, nblk: int, dev: torch.device) -> int:
    """Row chunks (whole blk-row blocks each): about two blocks per SM."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return int(max(1, min(nblk, -(-2 * sms // max(blocks, 1)))))


def hist_onehot(binsT: torch.Tensor, rhs: torch.Tensor, num_bins: int,
                fg: int, blk: int) -> torch.Tensor:
    """out [F * B, 128] f32: out[f*B + b, q] = sum over rows r with
    binsT[f, r] == b of rhs[r, q] + rhs[r, q + 128], accumulated in f32.
    ``binsT`` [F, N] uint8, ``rhs`` [N, 256] bf16, N a multiple of ``blk``;
    ``fg`` features per group, ``blk`` rows per block (on this design they
    set only the tiles' padding and the chunks' edges)."""
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
    ngroups = -(-f // fg)
    tiles = -(-fg * num_bins // _ONEHOT_TILE)
    nblk = n // blk
    nchunk = _onehot_chunks(ngroups * tiles, nblk, dev) if nblk else 1
    per_chunk = -(-nblk // nchunk) * blk
    nchunk = max(1, -(-n // per_chunk)) if n else 1
    out = torch.empty((f * num_bins, _ONEHOT_LANES), dtype=torch.float32,
                      device=dev)
    if n == 0 or f == 0:
        return out.zero_()
    partial = torch.empty((nchunk, ngroups, tiles * _ONEHOT_TILE,
                           _ONEHOT_LANES), dtype=torch.float32, device=dev)
    err = _lib("hist_onehot").hist_onehot_launch(
        _ptr(binsT), _ptr(rhs), _ptr(partial), _ptr(out), f, n, num_bins, fg,
        tiles, ngroups, nchunk, per_chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    _count(hist_onehot, "launches")
    _raise_on(err, "hist_onehot")
    return out


def reset_launch_counts() -> None:
    """Set every kernel's launch counters to 0."""
    for name, counters in _COUNTERS.items():
        for c in counters:
            setattr(globals()[name], c, 0)


def launch_counts() -> Dict[str, int]:
    """Every launch counter, as ``kernel.counter``."""
    return {f"{name}.{c}": getattr(globals()[name], c)
            for name, counters in _COUNTERS.items() for c in counters}


reset_launch_counts()
