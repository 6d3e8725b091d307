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

``predict_ensemble`` runs the plain version on a CPU tensor and only
there: on a CUDA tensor it launches the kernel (built with the others by
``ops/cuda_hist.build_kernels``) or raises. Each launch adds one to its
mode's counter (``launches`` for float64, ``launches_compensated``,
``launches_f32``, ``launches_leaves``; ``_wide`` for int16 bins).
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
_THREADS = 256              # rows (threads) of a block

Carry = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


class EnsembleTables(NamedTuple):
    """A stacked ensemble as the kernel and its plain version read it, on
    one device. ``nodes`` [T, C, 8] int32 holds each node's feature,
    threshold bin, default-left flag, left and right child, categorical
    flag and EFB segment bounds (C = max(L - 1, 1)); ``bits`` [T, C, W]
    int32 the categorical bitsets' 32-bit words; ``depth`` the deepest
    leaf's edge count, the plain version's trip count."""
    stacked: TreeArrays
    nodes: torch.Tensor
    bits: torch.Tensor
    depth: int


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
    return EnsembleTables(dev_stacked, nodes.contiguous().to(device),
                          bits32.contiguous().to(device), int(depth))


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
    int16 in the wide mode; a column slice of a wider matrix is fine) and
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
    _check(binsT.dtype in (torch.uint8, torch.int16),
           f"predict_ensemble: bins must be uint8 or int16, not "
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
    wide = binsT.dtype == torch.int16
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
    err = _lib("predict_ensemble").predict_ensemble_launch(
        _ptr(binsT), int(wide), int(binsT.stride(0)), n, _ptr(mb),
        _ptr(tables.nodes), _ptr(tables.bits), int(tables.bits.shape[2]),
        int(tables.nodes.shape[1]), _ptr(lv), int(lv.shape[1]), _ptr(nl), a,
        b, int(k), _ptr(bias), _ptr(act), _ptr(c0), _ptr(c1), _ptr(out),
        mode, _THREADS, torch.cuda.current_stream(dev).cuda_stream)
    name = ("launches_leaves" if leaves else
            {"float64": "launches", "compensated": "launches_compensated",
             "float32": "launches_f32"}[accum]) + ("_wide" if wide else "")
    cuda_hist._count(predict_ensemble, name)
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


cuda_hist.register_counters(predict_ensemble, tuple(
    c + w for c in ("launches", "launches_compensated", "launches_f32",
                    "launches_leaves") for w in ("", "_wide")))
