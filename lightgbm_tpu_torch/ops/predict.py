"""The ensemble traversal of a predict: a Hopper kernel, its wrapper and
its plain version.

The JAX package walks a stacked ensemble in ``models/predict_engine.py``'s
``_accum_core`` / ``_leaves_core``, plain ``jnp`` scans with no Pallas
kernel. On the card that "one dispatch" is a kernel written by hand,
``csrc/predict_ensemble.cu`` (a port-only kernel, like ``lambdarank.cu``):
one thread a row walks trees a..b-1 in tree order over the feature-major
bin matrix and adds each tree's leaf value (less its bias) into the row's
carry, in one of the three accumulation modes (``float64``, two-float
``compensated``, ``float32``), or writes the per-tree leaf indices
(``leaves``). The adds are single IEEE operations in tree order and the
library is built with ``--fmad=false``, so the kernel is bitwise its plain
version, ``predict_ensemble_plain``: the depth-bounded torch traversal
(``models/tree.py predict_leaf_bins_depth``) and the same adds.

The kernel's second design walks a tile of rows a block with the tile's
bins and the trees' staged records in shared memory (``stage_ensemble``
packs each tree once, ``launch_geometry`` lays out the block's shared
memory); the shapes it does not win on take the first design (a thread
a row), chosen from the shape alone (``launch_geometry``'s rule).

``predict_ensemble`` runs the plain version on a CPU tensor and only
there: on a CUDA tensor it launches the kernel (built with the others by
``ops/cuda_hist.build_kernels``) or raises. Each launch adds one to its
accumulation mode's counter (``launches`` for float64,
``launches_compensated``, ``launches_f32``, ``launches_leaves``; ``_wide``
for int16 and int32 bins) and one to its geometry's
(``predict_ensemble_geometry.launches_<mode>``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..models.tree import TreeArrays, predict_leaf_bins_depth, tree_at
from . import cuda_hist
from .cuda_hist import _check, _lib, _ptr, _raise_on

ACCUM_MODES = ("float64", "compensated", "float32")
_MODE = {"float64": 0, "compensated": 1, "float32": 2}
_NODE_INTS = 8              # ints of a node record (see EnsembleTables)
GEOMETRY_MODES = ("global", "tiled")   # the kernel's codes
_SLOTS = 4                  # rows a thread walks in lock step (tiled)
_TILE_THREADS = (256, 128, 64)   # a tile block's threads, largest first
_GLOBAL_THREADS = 256       # the global mode's threads (a row each)
_REC_BYTES = 8              # a staged node record (see stage_ensemble)
_REC_MAX = 4096             # node ids, leaves, columns and bins a record holds
_STAGE_MAX = 16 * 1024      # a tree's stage in the tiled mode at most
_TREE_BUFFERS = 40 * 1024   # the two chunk buffers' target bytes
_MAX_CHUNK_TREES = 16
_SMS = 132                  # H100 SXM: streaming multiprocessors

Carry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class EnsembleTables(NamedTuple):
    """A stacked ensemble as the kernel and its plain version read it, on
    one device. ``nodes`` [T, C, 8] int32 holds each node's feature,
    threshold bin, default-left flag, left and right child, categorical
    flag and EFB segment bounds (C = max(L - 1, 1)); ``bits`` [T, C, W]
    int32 the categorical bitsets' 32-bit words; ``depth`` the deepest
    leaf's edge count, the plain version's trip count; ``stage`` [T,
    stage_bytes] uint8 the trees as the tiled mode reads them
    (``stage_ensemble``; packed for a CUDA device when the trees can take
    that mode, None otherwise); ``has_cat`` / ``has_seg`` / ``has_wide``
    whether any node is categorical / an EFB segment's / split at a bin
    of 4,096 or more, past a record's 12-bit field (such ensembles take
    the global mode)."""
    stacked: TreeArrays
    nodes: torch.Tensor
    bits: torch.Tensor
    depth: int
    stage: Optional[torch.Tensor] = None
    has_cat: bool = False
    has_seg: bool = False
    has_wide: bool = False


class StageLayout(NamedTuple):
    """One tree's stage: ``bytes`` in all (a multiple of 16), the 8-byte
    node records at 0 (one more than the nodes: the sentinel a finished
    row waits on) and the leaf values at ``off_leaf``."""
    bytes: int
    off_leaf: int


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def stage_layout(node_cap: int, leaf_cap: int) -> StageLayout:
    """The stage of a tree of ``node_cap`` records and ``leaf_cap`` leaf
    values."""
    off_leaf = _align16((node_cap + 1) * _REC_BYTES)
    return StageLayout(off_leaf + _align16(leaf_cap * 4), off_leaf)


def stageable(node_cap: int, leaf_cap: int, has_cat: bool,
              has_seg: bool, has_wide: bool = False) -> bool:
    """Whether trees of this shape can take the tiled mode: numerical
    nodes only, every threshold below 4,096 (a record's field; the kernel
    folds larger bins, ``csrc/predict_ensemble.cu`` fold_bin) and a stage
    of at most 16 KB (1,023 leaves)."""
    return (not has_cat and not has_seg and not has_wide
            and stage_layout(node_cap, leaf_cap).bytes <= _STAGE_MAX)


def _breadth_first(left: torch.Tensor, right: torch.Tensor,
                   count: torch.Tensor, depth: int) -> torch.Tensor:
    """Every node's breadth-first index from its tree's root [T, C] int64
    (-1 past a tree's ``count`` nodes), all trees at once, one depth of
    ``depth`` at a time and no host round trip: a node reached at a depth
    is ranked among that depth's nodes by its parent's index, the left
    child first (children >= 0 are nodes)."""
    t_count, cap = left.shape
    dev = left.device
    col = torch.arange(cap, device=dev).expand(t_count, cap)
    real = col < count[:, None]
    # each node's parent and side (left 0, right 1); column cap collects
    # the leaves' and the unused records' entries
    parent = torch.zeros((t_count, cap + 1), dtype=torch.int64, device=dev)
    side = torch.zeros_like(parent)
    for s, child in enumerate((left, right)):
        at = torch.where((child >= 0) & real, child, cap)
        parent.scatter_(1, at, col)
        side.scatter_(1, at, torch.full_like(col, s))
    parent, side = parent[:, :cap], side[:, :cap]
    bfs = torch.where(real & (col == 0), 0, -1)
    done = (count >= 1).to(torch.int64)
    marks = torch.zeros((t_count, 2 * cap + 1), dtype=torch.int64,
                        device=dev)
    for _ in range(1, max(depth, 1)):
        up = bfs.gather(1, parent)
        new = real & (bfs < 0) & (up >= 0)
        key = torch.where(new, 2 * up + side, 2 * cap)
        marks.zero_().scatter_(1, key, new.to(torch.int64))
        rank = marks.cumsum(1).gather(1, key) - 1
        bfs = torch.where(new, done[:, None] + rank, bfs)
        done = done + new.sum(1)
    _check(bool(((bfs >= 0) == real).all()), "stage_ensemble: a node lies "
           "deeper than the ensemble's depth")
    return bfs


def stage_ensemble(stacked: TreeArrays, nodes: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """Each tree's stage [T, stage_bytes] uint8, built where ``nodes``
    lies (on the card for a CUDA device: no host pass over the trees), the
    layout of ``stage_layout``, its nodes numbered breadth first: an
    8-byte record a node, two little-endian words, x = feature | threshold
    bin << 12 | (e & 0xff) << 24 and y = e >> 8 | left << 5 | right << 18,
    a child a node id or 4096 + a leaf (e holds the default direction; the
    kernel turns it into the exception bin from the call's missing bins),
    then the float32 leaf values. Numerical nodes only (``stageable``).

    Records past a tree's last node are zeros, record ``node_cap`` is the
    sentinel (both children itself), and a tree of one leaf gets a root
    whose children are both leaf 0 (a visit that reads feature 0's bin and
    adds leaf 0's value: the plain version's result). All trees are packed
    together, one pass a depth (``depth``: the deepest leaf's edge count)
    for the order."""
    t_count, cap, _ = nodes.shape
    dev = nodes.device
    leaf_cap = int(stacked.leaf_value.shape[1])
    lay = stage_layout(cap, leaf_cap)
    nd = nodes.to(torch.int64)
    count = stacked.num_leaves.to(dev, torch.int64) - 1
    new = _breadth_first(nd[:, :, 3], nd[:, :, 4], count, depth)
    real = new >= 0
    # order[t, i]: the node whose index is i (column cap collects the rest)
    order = torch.full((t_count, cap + 1), -1, dtype=torch.int64,
                       device=dev)
    order.scatter_(1, torch.where(real, new, cap),
                   torch.arange(cap, device=dev).expand(t_count, cap))
    order = order[:, :cap]
    real = order >= 0
    new = new.clamp(min=0)
    src = nd.gather(1, order.clamp(min=0)[:, :, None].expand(-1, -1,
                                                             _NODE_INTS))

    def code(c):
        return torch.where(c >= 0, new.gather(1, c.clamp(min=0)),
                           _REC_MAX + ~c.clamp(max=-1))

    dl = (src[:, :, 2] != 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    rec = torch.zeros((t_count, cap + 1, 2), dtype=torch.int64, device=dev)
    rec[:, :cap, 0] = torch.where(real, (src[:, :, 0] & 0xFFF) | (
        (src[:, :, 1] & 0xFFF) << 12) | (dl << 24), zero)
    rec[:, :cap, 1] = torch.where(real, (code(src[:, :, 3]) << 5)
                                  | (code(src[:, :, 4]) << 18), zero)
    rec[:, cap, 1] = cap << 5 | cap << 18
    one = count < 1
    rec[:, 0, 0] = torch.where(one, zero, rec[:, 0, 0])
    rec[:, 0, 1] = torch.where(one, zero + (_REC_MAX << 5 | _REC_MAX << 18),
                               rec[:, 0, 1])
    out = torch.zeros((t_count, lay.bytes), dtype=torch.uint8, device=dev)
    # every word is below 2**31: int32 keeps its bits
    out[:, :(cap + 1) * _REC_BYTES] = rec.to(torch.int32).view(
        torch.uint8).reshape(t_count, -1)
    out[:, lay.off_leaf:lay.off_leaf + leaf_cap * 4] = (
        stacked.leaf_value.to(dev, torch.float32).contiguous().view(
            torch.uint8))
    return out


class Geometry(NamedTuple):
    """A launch's layout (``launch_geometry``): the mode (one of
    ``GEOMETRY_MODES``), ``blocks`` of ``threads`` threads, each thread
    walking ``slots`` rows (a tile of ``rows`` rows a block); the bins'
    row ``stride`` in shared memory (bytes); ``chunk_trees`` trees a staged
    chunk; the tree stage; dynamic shared memory ``smem`` bytes a block,
    the bins at 0 and the two chunk buffers at ``off_trees``."""
    mode: str
    blocks: int
    threads: int
    slots: int
    rows: int
    stride: int
    chunk_trees: int
    stage: StageLayout
    smem: int
    off_trees: int


def launch_geometry(n: int, f: int, bin_bytes: int, node_cap: int,
                    leaf_cap: int, has_cat: bool, has_seg: bool = False,
                    sms: int = _SMS, has_wide: bool = False) -> Geometry:
    """The kernel's geometry for ``n`` rows of ``f`` bins of ``bin_bytes``
    each over trees of ``node_cap`` records and ``leaf_cap`` leaves. The
    rule, from the shape alone:

    1. ``tiled`` needs trees that can be staged (``stageable``: numerical
       nodes only, a stage of at most 16 KB) and 1..4,096 columns (a
       record's feature field), else ``global``: a thread a row,
       everything read from global memory.
    2. A thread walks 4 rows; a block has the most threads of 256, 128, 64
       whose tiles still make two blocks an SM (else 64).
    3. A chunk holds as many trees as fit two buffers of 40 KB (1..16).
    4. The tile's bins (``rows`` x ``stride``, a stride of an odd number
       of words) must fit the block's shared memory beside the two chunk
       buffers, else ``global``.

    Measured on an H100 (``scripts/exp_predict_geometry.py``): the tiled
    mode wins at 255 and 1,023 leaves on numerical trees; ``global`` wins
    on categorical and EFB-segment ensembles and from 2,047 leaves, and
    ties when the bins cannot be staged (2,000 columns)."""
    lay = stage_layout(node_cap, leaf_cap)
    glob = Geometry("global", max(-(-n // _GLOBAL_THREADS), 1),
                    _GLOBAL_THREADS, 1, _GLOBAL_THREADS, 0, 0, lay, 0, 0)
    if not (stageable(node_cap, leaf_cap, has_cat, has_seg, has_wide)
            and 1 <= f <= _REC_MAX):
        return glob
    threads = next((th for th in _TILE_THREADS
                    if -(-n // (th * _SLOTS)) >= 2 * sms), _TILE_THREADS[-1])
    rows = threads * _SLOTS
    word_count = -(-f * bin_bytes // 4)
    stride = 4 * (word_count + 1 - word_count % 2)
    bins_bytes = _align16(rows * stride)
    chunk = min(max(_TREE_BUFFERS // (2 * lay.bytes), 1), _MAX_CHUNK_TREES)
    smem = bins_bytes + 2 * chunk * lay.bytes
    if smem > cuda_hist.SMEM_PER_BLOCK:
        return glob
    return Geometry("tiled", max(-(-n // rows), 1), threads, _SLOTS, rows,
                    stride, chunk, lay, smem, bins_bytes)


def pack_ensemble(stacked: TreeArrays, depth: int, device) -> EnsembleTables:
    """The kernel's tables of a stacked ensemble (``models/tree.py
    stack_trees``), placed on ``device``."""
    t_count, li = stacked.node_feature.shape
    cols = (stacked.node_feature, stacked.node_threshold_bin,
            stacked.node_default_left, stacked.node_left, stacked.node_right,
            stacked.node_cat, stacked.node_seg_lo, stacked.node_seg_hi)
    nodes = torch.zeros((t_count, max(li, 1), _NODE_INTS), dtype=torch.int32)
    bits = stacked.node_cat_bitset.to(torch.int64)
    words = max(int(bits.shape[2]) if bits.dim() == 3 else 1, 1)
    bits32 = torch.zeros((t_count, max(li, 1), words), dtype=torch.int32)
    if li:
        nodes[:, :li] = torch.stack([c.cpu().to(torch.int32) for c in cols],
                                    dim=2)
        # the words hold 32 bits each: their bit patterns as int32
        w = bits.cpu() & 0xFFFFFFFF
        bits32[:, :li] = torch.where(w >= 2 ** 31, w - 2 ** 32,
                                     w).to(torch.int32)
    dev_stacked = TreeArrays(*(x.to(device) for x in stacked))
    dev_nodes = nodes.contiguous().to(device)
    has_cat = bool(stacked.node_cat.any()) if li else False
    has_seg = bool((stacked.node_seg_lo >= 0).any()) if li else False
    has_wide = bool((nodes[:, :li, 1] >= _REC_MAX).any()) if li else False
    stage = None
    if torch.device(device).type == "cuda" and stageable(
            nodes.shape[1], stacked.leaf_value.shape[1], has_cat, has_seg,
            has_wide):
        stage = stage_ensemble(dev_stacked, dev_nodes, int(depth))
    return EnsembleTables(dev_stacked, dev_nodes,
                          bits32.contiguous().to(device), int(depth), stage,
                          has_cat, has_seg, has_wide)


def predict_ensemble_plain(tables: EnsembleTables, binsT: torch.Tensor,
                           missing_bin: torch.Tensor,
                           tree_range: Tuple[int, int], k: int = 1,
                           bias: Optional[torch.Tensor] = None,
                           active: Optional[torch.Tensor] = None,
                           carry: Optional[Carry] = None,
                           accum: str = "float64",
                           leaves: bool = False) -> Union[Carry,
                                                          torch.Tensor]:
    """Plain version of the kernel: each tree of [a, b) by the
    depth-bounded traversal, then ``_accum_core``'s adds in tree order into
    ``carry`` (updated in place and returned), or the leaves [b - a, N]
    int32."""
    a, b = tree_range
    n = binsT.shape[1]
    st = tables.stacked
    if leaves:
        out = torch.empty((b - a, n), dtype=torch.int32, device=binsT.device)
        for t in range(a, b):
            out[t - a] = predict_leaf_bins_depth(
                tree_at(st, t), binsT, missing_bin, tables.depth).to(
                    torch.int32)
        return out
    act = None if active is None else active.to(torch.bool)
    for t in range(a, b):
        leaf = predict_leaf_bins_depth(tree_at(st, t), binsT, missing_bin,
                                       tables.depth)
        lv = st.leaf_value[t][leaf]
        c = t % k
        if accum == "float64":
            v = lv.to(torch.float64)
            if bias is not None:
                v = v - bias[t]
            col = carry[:, c]
            new = col + v
            carry[:, c] = new if act is None else torch.where(act, new, col)
            continue
        v = lv
        if bias is not None:
            v = v - bias[t].to(torch.float32)
        if accum == "float32":
            col = carry[:, c]
            new = col + v
            carry[:, c] = new if act is None else torch.where(act, new, col)
            continue
        s, comp = carry
        sc, cc = s[:, c], comp[:, c]
        y = v - cc
        ts = sc + y
        nc = (ts - sc) - y
        if act is not None:
            ts = torch.where(act, ts, sc)
            nc = torch.where(act, nc, cc)
        s[:, c] = ts
        comp[:, c] = nc
    return carry


_SM_COUNTS = {}


def _sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors, read once a device."""
    if dev.index not in _SM_COUNTS:
        _SM_COUNTS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SM_COUNTS[dev.index]


def new_carry(n: int, k: int, accum: str, device) -> Carry:
    """A zero carry [n, k] in the accumulation mode's dtype (compensated:
    the sum and its compensation term)."""
    if accum == "compensated":
        return (torch.zeros((n, k), dtype=torch.float32, device=device),
                torch.zeros((n, k), dtype=torch.float32, device=device))
    dt = torch.float64 if accum == "float64" else torch.float32
    return torch.zeros((n, k), dtype=dt, device=device)


def predict_ensemble(tables: EnsembleTables, binsT: torch.Tensor,
                     missing_bin: torch.Tensor, tree_range: Tuple[int, int],
                     k: int = 1, *, bias: Optional[torch.Tensor] = None,
                     active: Optional[torch.Tensor] = None,
                     carry: Optional[Carry] = None, accum: str = "float64",
                     leaves: bool = False) -> Union[Carry, torch.Tensor]:
    """Walk trees [a, b) of ``tables`` over ``binsT`` [F, N] (uint8, or
    int16 / int32 in the wide mode; a column slice of a wider matrix is
    fine) and
    accumulate into ``carry`` [N, k] (None: zeros; updated in place and
    returned), or (``leaves``) return the leaves [b - a, N] int32.
    ``bias`` [T] float64 comes off each tree's value first; rows whose
    ``active`` [N] is 0 keep their carry. On a CUDA tensor it launches
    ``csrc/predict_ensemble.cu`` (and counts the launch) or raises; on a
    CPU tensor it runs ``predict_ensemble_plain``."""
    a, b = int(tree_range[0]), int(tree_range[1])
    dev = binsT.device
    f, n = binsT.shape
    t_count = int(tables.nodes.shape[0])
    _check(accum in ACCUM_MODES, f"predict_ensemble: unknown accumulation "
           f"mode {accum!r}")
    _check(0 <= a <= b <= t_count, f"predict_ensemble: tree range "
           f"[{a}, {b}) outside [0, {t_count}]")
    _check(binsT.dtype in (torch.uint8, torch.int16, torch.int32),
           f"predict_ensemble: bins must be uint8, int16 or int32, not "
           f"{binsT.dtype}")
    _check(n == 0 or binsT.stride(1) == 1,
           "predict_ensemble: the bins' rows must be contiguous")
    _check(tuple(missing_bin.shape) == (f,) and missing_bin.dtype in
           (torch.int32, torch.int64), f"predict_ensemble: missing_bin "
           f"{tuple(missing_bin.shape)} {missing_bin.dtype} != ({f},) int")
    for name, t in (("nodes", tables.nodes), ("bits", tables.bits),
                    ("missing_bin", missing_bin)):
        _check(t.device == dev, f"predict_ensemble: {name} on {t.device}, "
               f"bins on {dev}")
    if bias is not None:
        _check(bias.dtype == torch.float64 and tuple(bias.shape) ==
               (t_count,) and bias.device == dev,
               f"predict_ensemble: bias must be float64 [{t_count}] on {dev}")
    if active is not None:
        _check(tuple(active.shape) == (n,) and active.device == dev,
               f"predict_ensemble: active must be [{n}] on {dev}")
    if not leaves:
        if carry is None:
            carry = new_carry(n, k, accum, dev)
        parts = carry if accum == "compensated" else (carry,)
        want = torch.float64 if accum == "float64" else torch.float32
        _check(len(parts) == (2 if accum == "compensated" else 1),
               "predict_ensemble: a compensated carry is (sum, compensation)")
        for p in parts:
            _check(p.dtype == want and tuple(p.shape) == (n, k)
                   and p.is_contiguous() and p.device == dev,
                   f"predict_ensemble: carry must be contiguous {want} "
                   f"[{n}, {k}] on {dev}")
    if dev.type == "cpu":
        return predict_ensemble_plain(tables, binsT, missing_bin, (a, b), k,
                                      bias, active, carry, accum, leaves)
    _check(dev.type == "cuda", f"predict_ensemble: no kernel for device "
           f"{dev}")
    wide = binsT.dtype != torch.uint8
    mb = missing_bin.to(torch.int32).contiguous()
    lv = tables.stacked.leaf_value
    nl = tables.stacked.num_leaves.to(torch.int32).contiguous()
    act = None if active is None else active.to(torch.uint8).contiguous()
    out = None
    if leaves:
        out = torch.empty((b - a, n), dtype=torch.int32, device=dev)
        mode, c0, c1 = 3, None, None
    elif accum == "compensated":
        mode, (c0, c1) = 1, carry
    else:
        mode, c0, c1 = _MODE[accum], carry, None
    geo = launch_geometry(n, f, binsT.element_size(),
                          int(tables.nodes.shape[1]), int(lv.shape[1]),
                          tables.has_cat, tables.has_seg, _sm_count(dev),
                          tables.has_wide)
    stage = tables.stage if geo.mode == "tiled" else None
    if geo.mode == "tiled":
        _check(stage is not None and stage.device == dev
               and tuple(stage.shape) == (t_count, geo.stage.bytes),
               f"predict_ensemble: the tables need their stages "
               f"[{t_count}, {geo.stage.bytes}] uint8 on {dev} "
               f"(pack_ensemble for that device)")
    err = _lib("predict_ensemble").predict_ensemble_launch(
        _ptr(binsT), binsT.element_size(), int(binsT.stride(0)), n, f,
        _ptr(mb),
        _ptr(tables.nodes), _ptr(tables.bits), int(tables.bits.shape[2]),
        int(tables.nodes.shape[1]), _ptr(lv), int(lv.shape[1]), _ptr(nl), a,
        b, int(k), _ptr(bias), _ptr(act), _ptr(c0), _ptr(c1), _ptr(out),
        mode, GEOMETRY_MODES.index(geo.mode), _ptr(stage), geo.stage.bytes,
        geo.stage.off_leaf, geo.stride, geo.chunk_trees, geo.off_trees,
        geo.smem, geo.threads, geo.blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    name = ("launches_leaves" if leaves else
            {"float64": "launches", "compensated": "launches_compensated",
             "float32": "launches_f32"}[accum]) + ("_wide" if wide else "")
    cuda_hist._count(predict_ensemble, name)
    cuda_hist._count(predict_ensemble_geometry, "launches_" + geo.mode)
    _raise_on(err, "predict_ensemble")
    return out if leaves else carry


def node_visits(tables: EnsembleTables, leaves: torch.Tensor,
                tree_range: Tuple[int, int]) -> int:
    """The node visits of a traversal whose leaves are ``leaves`` [t, N]:
    each row's leaf depth in each tree, summed (a kernel bound's count of
    the work these inputs need)."""
    a, b = tree_range
    depth = tables.stacked.leaf_depth[a:b].to(torch.int64)
    nl = tables.stacked.num_leaves[a:b].to(torch.int64)
    d = torch.gather(depth, 1, leaves.to(torch.int64))
    d = torch.where(nl[:, None] > 1, d, torch.zeros_like(d))
    return int(d.sum())


def predict_ensemble_geometry():
    """Holds the launches of each geometry (``launches_tiled``,
    ``launches_global``): every ``predict_ensemble`` launch counts once
    here and once in its accumulation mode's counter."""


cuda_hist.register_counters(predict_ensemble, tuple(
    c + w for c in ("launches", "launches_compensated", "launches_f32",
                    "launches_leaves") for w in ("", "_wide")))
cuda_hist.register_counters(predict_ensemble_geometry, tuple(
    "launches_" + m for m in GEOMETRY_MODES))
