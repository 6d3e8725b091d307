"""Leaf-wise tree growth, serial learner: the fused and the classic split path.

The port of lightgbm_tpu's ``models/grower.py`` (``grow_tree``): leaf
membership is a per-row int32 vector, the histogram-pending leaves are
histogrammed in tiles of up to P slots per data pass, and growth runs in
ROUNDS:

  a TILE PASS while any leaf is pending; with the compaction ladder the
  pass reads only the tile's rows through the gather form when they fit
  the smallest rung that holds them. Two forms, as ``split_fusion`` says:

  - ``tile_pass_fused`` (the fused path): sibling pairs share the pass on
    adjacent slots -- the smaller child computed at the even slot, the
    larger derived at the odd slot as parent - smaller (the reference's
    subtraction trick) -- and every (leaf, feature) reduces to its best
    numerical candidate in the same pass (``histogram_tiles_with_candidates``);
  - ``tile_pass`` (the classic path, for categorical features, sparse
    device columns or ``split_fusion=off``): the first P candidate leaves
    are histogrammed plane-only (``histogram_tiles``; the sparse columns'
    planes come from their streams, ``combine_sparse``), and each computed
    leaf's pending sibling is derived by subtraction on the resident
    ``[L, F, B, 3]`` planes; or

  a SPLIT PHASE when nothing is pending: on the classic path the search
  runs now over the resident planes (``find_best_splits``, numerical and
  categorical); then every leaf's best split, in gain order, until the
  leaf budget is spent (one split per phase in ``exact`` mode).

The JAX package runs this as one ``lax.while_loop`` with ``lax.cond``
branches. Here the loop and its branches are host Python. The per-leaf
state (sums, outputs, depths, siblings, the best splits and the tree under
growth, all O(num_leaves)) lives in numpy arrays on the host -- float32
values stay ``np.float32``, so every sum and output keeps its rounding --
and only the O(N) and plane-sized state (the leaf ids, the gradient stats,
the resident histograms) lives on the device. The host waits for the
device at a few points per frontier level: the tile pass's pending-row
count (the ladder's rung choice), the copy of the small ``[P, F, 12]``
candidate table (fused) or of the ``[L]`` best splits (classic), and the
lane table the histogram kernel is sized by. A split phase routes all of
its splits' rows in one device pass at its end (a phase splits each leaf
at most once, so the order of the routings does not matter), through the
index tables sent once per phase.

Row sampling enters as the JAX package's does: a 0/1 ``sample_mask``
(bagging's mask mode, GOSS's support) makes the stats ``[g*m, h*m, m]``,
so the count channel counts the kept rows only; bagging's subset mode
hands the grower the in-bag rows' indices and their bin columns, and the
histogram passes and root sums read those ``k`` rows alone (a second leaf
id vector over them, routed beside the one over all N rows, which the
score update reads). By-tree ``feature_fraction`` is a feature mask on
every split search (the fused path's candidate pick and the classic
``find_best_splits``).

The split constraints enter as the JAX package threads them: monotone
constraints as per-leaf output bounds ``leaf_min``/``leaf_max`` -- in the
basic mode the children's mid-point tightens them at each split on a
monotone feature, and the fused path's epilogue runs its monotone mode;
the intermediate and advanced modes recompute them before every search
from all leaves' outputs and bin boxes (``intermediate_bounds``,
``advanced_child_bounds``), one split a phase -- interaction
constraints and by-node sampling as per-leaf feature masks
(``leaf_feature_mask``), and extra_trees as one random threshold per
(leaf, feature) a search (``rand_bins``), the draws keyed on the tree's
key and the growth round.

The data layer's options, on the classic path: EFB bundles (``bundle``,
the segment-relative search; a bundle column's split routes the rows
outside its member's segment by the default direction), CEGB
(``cegb``: each search's per-(leaf, feature) cost, with the
used-feature state ``used_split`` [F] and, in the lazy mode, ``row_used``
[N, F] carried across trees) and forced splits (``forced``: each forced
node in preorder runs the regular search restricted to its feature and
bin with the min_gain, min_data and min_hessian screens off, before any
unforced split; a node its constraints reject is skipped with its
subtree).

In the quantized-gradient mode (a ``*_q8`` histogram method) the
gradients and hessians become int8 before growth, with per-tree scales and
stochastic rounding drawn from the tree's key (``utils/random.py``, the
JAX package's draw bit for bit); the tile passes sum them exactly in int32
and dequantize once per pass (in the epilogue on the fused path, after
``combine_sparse`` on the classic one), so the resident planes stay
float32.

``hist_dp`` (``gpu_use_dp``, the classic path only) makes the grower's
one dtype attribute float64, as the JAX package's ``hist_dtype`` under
x64: the stats go to the histogram passes as float32 and come back as
float64 planes (the kernels' f64 mode), and the root sums, the resident
planes, the leaf sums, counts and outputs and the monotone bounds are
float64, host state included; the split search computes its gains in
float64 and keeps them as float32, and the tree under growth stays
float32. The random draws of by-node sampling and extra_trees are float64
then too, as JAX's ``uniform`` is under x64.

The memory-bounded mode (``feature_block`` > 0, the JAX package's
blocked mode, which ``histogram_pool_size`` and the OOM ladder's rungs 1-2
engage) keeps no ``[L, F, B, 3]`` state: each ``blocked_pass``
histograms the pending tile one column block at a time (``histogram_tiles``
on a persistent ``binsT[s:e]`` view, into a transient ``[P, Fb, B, 3]``),
searches it with ``find_best_splits`` and merges the blocks' bests with
the JAX package's tie order (``merge_best``: the earlier block, the lower
feature, keeps a tie); only the ``SplitInfo`` survives, and
``split_phase_blocked`` applies splits from those stored bests. It runs
the classic search with no subtraction and no compaction ladder, and
reads all N rows once a block; every block's pass takes the tree's one
``amax``, so on the card its planes are the resident pass's bit for bit.

``numerics_sentinels`` (``check_numerics``) judges the final state: a
non-finite leaf sum or output, or a non-finite resident plane, sets the
histogram-sums bit of the flag word the trainer reads (``counters``'
``sentinel``).

The distributed learners (``learner`` "data", "feature" or "voting", each
rank a ``Grower`` over its rows with a ``network.Network``; the JAX
package's ``_grower_fns`` under its ``shard_map``, ``parallel/learners.py``
pads and slices the inputs) hook the collectives in where the JAX grower
calls ``jax.lax``'s, on the classic path with no compaction ladder:

- rows sharded (``data``, ``voting``): the gang's max|stat| (q8's scales,
  ``pmax``), the root sums (``psum``: a rank-order fold), the rows the
  passes read and the numerics sentinel at the end;
- ``data``: each tile pass's planes reduce-scattered over feature
  ownership (rank r owns the r-th of W equal feature slices; ``psum_scatter``),
  the owner's search over its slice, the best splits synchronised
  (``sync_best_splits``);
- ``feature``: rows replicated, each rank histograms and searches only its
  slice (a persistent ``column_blocks`` view), then the sync;
- ``voting``: local planes; each rank's local best gain per feature (local
  leaf sums, ``min_data`` / ``min_hess`` over W) votes its top ``top_k``
  features, the tally elects the top 2k per leaf, and only the elected
  columns are summed over ranks before the search.

On the CPU the float planes are summed by the fold (``fold_sum_scatter``),
bitwise the JAX learners. On the card, and on the CPU inside
``kernel_sums_on_cpu()``, the data learner's passes run ``hist_tile``'s
integer-planes mode (the gang's max|stat| and row count set one exponent):
the int64 planes are reduce-scattered exactly, then converted
(``hist_convert``), so the planes are those of one pass over all the
gang's rows, whatever W. q8 planes are integers in every mode.

Equivalence to the reference's leaf-wise order, the dead-leaf guard
(BeforeFindBestSplit) and the tie rules are the JAX package's; trees are
bitwise equal to its ``grow_tree`` on the same inputs where the histograms
are (the CPU plain path is; q8 sums are exact everywhere).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_hist
from ..ops.histogram import (compact_indices, epilogue_supported,
                             histogram_tiles, histogram_tiles_with_candidates)
from ..ops.split import (BundleMeta, FeatureMeta, SplitInfo, SplitParams,
                         calculate_leaf_output, candidates_to_splitinfo,
                         cat_words_for, find_best_splits, sync_best_splits)
from ..utils import profiling
from ..utils.ordered import fma_f32, tree_sum
from ..utils.random import fold_in, prng_key, uniform
from .tree import TreeArrays, empty_tree

NEG_INF = float("-inf")
F32_MAX = float(np.finfo(np.float32).max)


def _key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in the floats' order, -0 below +0: the max
    and min of keys are XLA's float max and min (+0 over -0) for every
    non-NaN value, exact in any order (``scatter_reduce``'s included).
    Its own inverse."""
    i = x.to(torch.float32).view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def _unkey(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)


def _pair_overlap(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """[L, L', F] bool: the boxes of leaves l and l' overlap in feature
    f."""
    return ((lo[:, None, :] <= hi[None, :, :])
            & (lo[None, :, :] <= hi[:, None, :]))


def intermediate_bounds(lo: torch.Tensor, hi: torch.Tensor,
                        out: torch.Tensor, act: torch.Tensor,
                        monotone: torch.Tensor, mono_features: tuple):
    """The intermediate monotone mode's per-leaf output bounds from all
    current leaf outputs ``out`` [L] and the leaves' bin boxes ``lo``,
    ``hi`` [L, F] (the JAX package's ``intermediate_bounds``, the
    vectorised form of monotone_constraints.hpp:514-698
    IntermediateLeafConstraints). Leaf l' bounds l when their boxes
    overlap in every feature but one monotone feature, in which l' lies
    strictly on one side: below l in an increasing feature (or above in a
    decreasing one) it is a lower bound, else an upper one. Returns
    (lb, ub) [L] float32; a leaf with no such partner keeps -FLT_MAX /
    FLT_MAX."""
    f = lo.shape[1]
    outk = _key(out)
    cnt = _pair_overlap(lo, hi).sum(2, dtype=torch.int32)       # [L, L']
    mf = torch.as_tensor(list(mono_features), dtype=torch.long,
                         device=lo.device)
    lo_m, hi_m = lo[:, mf], hi[:, mf]                           # [L, Fm]
    ovl_m = _pair_overlap(lo_m, hi_m)
    except_f = (cnt[:, :, None] - ovl_m.to(torch.int32)) == (f - 1)
    below = hi_m[None, :, :] < lo_m[:, None, :]                 # l' below l
    above = lo_m[None, :, :] > hi_m[:, None, :]
    mono = monotone[mf].to(torch.int32)
    up, dn = (mono > 0)[None, None, :], (mono < 0)[None, None, :]
    pair_ok = act[:, None, None] & act[None, :, None] & except_f
    lb_mask = (pair_ok & ((up & below) | (dn & above))).any(2)
    ub_mask = (pair_ok & ((up & above) | (dn & below))).any(2)
    lb = torch.where(lb_mask, outk[None, :],
                     _key(torch.tensor(-F32_MAX))).amax(1)
    ub = torch.where(ub_mask, outk[None, :],
                     _key(torch.tensor(F32_MAX))).amin(1)
    return _unkey(lb), _unkey(ub)


def advanced_child_bounds(lo: torch.Tensor, hi: torch.Tensor,
                          out: torch.Tensor, act: torch.Tensor,
                          monotone: torch.Tensor, num_bins: int,
                          mono_features: tuple):
    """Per-threshold child output bounds of the advanced monotone mode
    (the JAX package's ``advanced_child_bounds``, a vectorised
    re-derivation of monotone_constraints.hpp:856-1171
    AdvancedLeafConstraints). For a split of leaf l on feature g at
    threshold bin t, the left child holds ``[lo[l, g], t]`` of l's box
    and the right child ``[t + 1, hi[l, g]]``; a leaf l' bounds a child
    whose region it overlaps in every feature but exactly one monotone
    feature, in which it lies strictly on one side. Every contribution
    starts or stops at one breakpoint bin, so the bounds are extrema
    scattered at the breakpoints, then prefix and suffix extrema over the
    bin axis. The extrema run on ``_key``s: max and min are exact in any
    order, and -0 / +0 resolve as XLA's scatter and cumulative max and
    min resolve them.

    lo, hi [L, F] int32 (inclusive boxes); out [L]; act [L] bool;
    monotone [F]. Returns (lmin, lmax, rmin, rmax) [L, F, B] float32."""
    L, F = lo.shape
    B = num_bins
    dev = lo.device
    size = L * F * B
    neg = int(_key(torch.tensor(-F32_MAX)))
    pos = int(_key(torch.tensor(F32_MAX)))
    outk = _key(out.to(dev))
    li = torch.arange(L, device=dev)
    lo, hi = lo.long(), hi.long()
    ovl = _pair_overlap(lo, hi)                                 # [L, L', F]
    cnt = ovl.sum(2, dtype=torch.int32)
    pair = (act[:, None] & act[None, :]
            & ~torch.eye(L, dtype=torch.bool, device=dev))

    # scatter planes: pre_* act for t >= the breakpoint (prefix extremum),
    # suf_* for t <= it (suffix extremum); an index of ``size`` is a
    # dropped write, left out before the scatter (on the card, atomics on
    # one spare cell would serialise)
    def plane(fill):
        return torch.full((size,), fill, dtype=torch.int32, device=dev)

    pre_lmin, suf_lmin, pre_rmin, suf_rmin = (plane(neg) for _ in range(4))
    pre_lmax, suf_lmax, pre_rmax, suf_rmax = (plane(pos) for _ in range(4))

    def put(dst, idx, val, how):
        keep = idx < size
        dst.scatter_reduce_(0, idx[keep], val.expand(idx.shape)[keep], how)

    val2 = outk[None, :].expand(L, L)
    # case A: the separating monotone feature is the split feature g; l'
    # overlaps l in every other feature, and its place beside the child's
    # slice of g decides the bound and the breakpoint
    for m in mono_features:
        case_a = pair & (cnt - ovl[:, :, m].to(torch.int32) == F - 1)
        mpos = bool(monotone[m] > 0)
        base = ((li * F + m) * B)[:, None]
        # left child, l' strictly above the slice (lo_g(l') > t): t <=
        # lo_g(l') - 1
        tau = (lo[None, :, m] - 1).expand(L, L)
        idx = torch.where(case_a & (tau >= 0), base + tau, size)
        put(suf_lmax if mpos else suf_lmin, idx, val2,
            "amin" if mpos else "amax")
        # left child, l' below the slice (= below the box): every t
        idx0 = torch.where(case_a & (hi[None, :, m] < lo[:, None, m]),
                           base, size).expand(L, L)
        put(pre_lmin if mpos else pre_lmax, idx0, val2,
            "amax" if mpos else "amin")
        # right child, l' strictly below the slice (hi_g(l') <= t): t >=
        # hi_g(l')
        idxr = torch.where(case_a, base + hi[None, :, m], size)
        put(pre_rmin if mpos else pre_rmax, idxr, val2,
            "amax" if mpos else "amin")
        # right child, l' above the slice (= above the box): every t
        idx0r = torch.where(case_a & (lo[None, :, m] > hi[:, None, m]),
                            base, size).expand(L, L)
        put(pre_rmax if mpos else pre_rmin, idx0r, val2,
            "amin" if mpos else "amax")

    # case B: the separator is a monotone feature m* other than g; t
    # enters through l' overlapping the child's slice of g
    bmin = torch.zeros((L, L, F), dtype=torch.bool, device=dev)
    bmax = torch.zeros((L, L, F), dtype=torch.bool, device=dev)
    ovl_i = ovl.to(torch.int32)
    for m in mono_features:
        above = lo[None, :, m] > hi[:, None, m]
        below = hi[None, :, m] < lo[:, None, m]
        ok = (cnt[:, :, None] - ovl_i - ovl_i[:, :, m][:, :, None]) == F - 2
        ok = ok & (pair & (above | below))[:, :, None]
        ok[:, :, m] = False                  # m* == g is case A
        is_min = (below if bool(monotone[m] > 0) else above)[:, :, None]
        bmin |= ok & is_min
        bmax |= ok & ~is_min
    base3 = ((li[:, None, None] * F
              + torch.arange(F, device=dev)[None, None, :]) * B)
    val3 = outk[None, :, None].expand(L, L, F)
    # left child: needs hi_g(l') >= lo_g(l); from t >= lo_g(l')
    ok_l = hi[None, :, :] >= lo[:, None, :]
    tau_l = lo[None, :, :].clamp(0, B - 1)
    put(pre_lmin, torch.where(bmin & ok_l, base3 + tau_l, size), val3,
        "amax")
    put(pre_lmax, torch.where(bmax & ok_l, base3 + tau_l, size), val3,
        "amin")
    # right child: needs lo_g(l') <= hi_g(l); up to t <= hi_g(l') - 1
    tau_r = hi[None, :, :] - 1
    ok_r = (lo[None, :, :] <= hi[:, None, :]) & (tau_r >= 0)
    put(suf_rmin, torch.where(bmin & ok_r, base3 + tau_r, size), val3,
        "amax")
    put(suf_rmax, torch.where(bmax & ok_r, base3 + tau_r, size), val3,
        "amin")

    def cum(x, fn, reverse=False):
        x = x.reshape(L, F, B)
        if reverse:
            return fn(x.flip(2), 2).values.flip(2)
        return fn(x, 2).values

    lmin = torch.maximum(cum(pre_lmin, torch.cummax),
                         cum(suf_lmin, torch.cummax, True))
    lmax = torch.minimum(cum(pre_lmax, torch.cummin),
                         cum(suf_lmax, torch.cummin, True))
    rmin = torch.maximum(cum(pre_rmin, torch.cummax),
                         cum(suf_rmin, torch.cummax, True))
    rmax = torch.minimum(cum(pre_rmax, torch.cummin),
                         cum(suf_rmax, torch.cummin, True))
    return tuple(_unkey(k) for k in (lmin, lmax, rmin, rmax))


@dataclass
class CegbSpec:
    """CEGB's settings in used-feature space (``GBDT`` builds it): the
    tradeoff, the split penalty, the coupled and lazy per-feature
    penalties (float32 [F] or None), and ``state``, the cross-tree record
    (``used_split`` [F] bool on the host; ``row_used`` [N, F] bool on the
    device in the lazy mode), which the grower updates in place."""
    tradeoff: float
    penalty_split: float
    coupled: Optional[np.ndarray]
    lazy: Optional[np.ndarray]
    state: dict


@dataclass
class GrowState:
    """One tree's growth state: device tensors (``leaf_id``, ``hist``) and
    numpy arrays for everything per-leaf."""
    leaf_id: torch.Tensor        # [N] int32, device
    leaf_id_sub: Optional[torch.Tensor]  # [k] int32 (bagging subset) or None
    hist: Optional[torch.Tensor]  # [L, F, B, 3] f32, device (None: blocked)
    hist_valid: np.ndarray       # [L] bool
    leaf_dead: np.ndarray        # [L] bool (guard-failed)
    leaf_sum_g: np.ndarray       # [L] f32
    leaf_sum_h: np.ndarray
    leaf_cnt: np.ndarray
    leaf_output: np.ndarray
    leaf_depth: np.ndarray       # [L] int32
    leaf_min: np.ndarray         # [L] f32 monotone output lower bound
    leaf_max: np.ndarray         # [L] f32 monotone output upper bound
    leaf_lo: Optional[np.ndarray]  # [L, F] int32 bin box (intermediate,
    leaf_hi: Optional[np.ndarray]  # advanced monotone), inclusive
    used_path: Optional[np.ndarray]  # [L, F] bool: features on the path
    #                                  (interaction constraints)
    sib: np.ndarray              # [L] int32 sibling slot (-1 = none)
    parent_hist: np.ndarray      # [L] bool: slot holds the PARENT's planes
    best: SplitInfo              # [L] per-leaf best split, numpy fields
    tree: TreeArrays             # the tree under growth, numpy fields
    num_leaves: int = 1
    rounds: int = 0
    done: bool = False
    rows_streamed: float = 0.0
    rows_real: float = 0.0        # of them, rows of the computed leaves
    # the current split phase's splits: (leaf, new_leaf, feature,
    # threshold_bin, default_left, is_cat, bitset, seg_lo, seg_hi), routed
    # together at the phase's end
    pending_routes: List[tuple] = field(default_factory=list)
    forced_idx: int = 0           # next forced-split node
    forced_slot: Optional[np.ndarray] = None  # [K] leaf per forced node


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _fmax(a, b):
    """XLA's maximum of two numpy float scalars of one dtype (NaN
    propagates, +0 over -0)."""
    if a != a or b != b:
        return type(a)(np.nan)
    if a == b:
        return type(a)(a + b) if a == 0 else a
    return a if a > b else b


def _fmin(a, b):
    """XLA's minimum of two numpy float scalars of one dtype (NaN
    propagates, -0 over +0)."""
    if a != a or b != b:
        return type(a)(np.nan)
    if a == b:
        return type(a)(-((-a) + (-b))) if a == 0 else a
    return a if a < b else b


def merge_best(a: SplitInfo, b: SplitInfo) -> SplitInfo:
    """Cross-block best merge (the JAX package's): a strictly greater gain
    replaces, a tie keeps the earlier block, i.e. the lower feature index
    (the reference's cross-feature tie rule,
    serial_tree_learner.cpp:374-448)."""
    take = b.gain > a.gain

    def w(x, y):
        m = take if x.dim() == 1 else take[:, None]
        return torch.where(m, y, x)

    return SplitInfo(*(w(x, y) for x, y in zip(a, b)))


def column_blocks(binsT: torch.Tensor, width: int) -> List[tuple]:
    """(start, end, view) of ``binsT``'s column blocks of ``width``
    device columns. The views are kept on ``binsT`` (remade after an
    in-place write or for another width), so each keeps the row-major copy
    the kernels read (``cuda_hist.bins_by_row``, cached on the view) for
    as long as the bin matrix lives: a fresh ``binsT[s:e]`` on every pass
    would rebuild an N x Fb copy on every launch."""
    kept = getattr(binsT, "_column_blocks", None)
    if kept is not None and kept[0] == binsT._version and kept[1] == width:
        return kept[2]
    f = binsT.shape[0]
    blocks = [(s, min(s + width, f), binsT[s:min(s + width, f)])
              for s in range(0, f, width)]
    binsT._column_blocks = (binsT._version, width, blocks)
    return blocks


class Grower:
    """The static configuration and data of one tree's growth (the JAX
    ``_grower_fns`` closure).

    ``binsT`` holds the dense device columns; with ``sp`` = (sp_cols,
    sp_rows, sp_bins, sp_default) the columns ``sp_cols`` live as (row,
    bin) streams instead (``Dataset._maybe_extract_sparse``), and feature
    indices, ``meta`` and ``missing_bin`` span all columns.
    ``sample_mask`` [N] f32 (0/1) keeps rows out of the sums;
    ``subset`` = (sub_idx [k], sub_binsT [F, k]) histograms the in-bag rows
    alone (dense columns only); ``feature_mask`` [F] bool, the columns the
    searches may split on.

    The split constraints and the randomised search, as the JAX package
    threads them through its grower: ``mono_mode`` ("" = no monotone
    constraint, else "basic", "intermediate" or "advanced") with the
    directions ``meta.monotone``; ``interaction_groups`` [G, F] bool;
    ``extra_trees`` (one random threshold per (leaf, feature) a search);
    ``bynode_fraction`` (a random feature subset per leaf a search). The
    draws come from ``rng_key`` (the tree's key) folded with the growth
    round, as the JAX package draws them. Intermediate and advanced
    monotone constraints force one split per phase (``exact``).

    The data layer: ``bundle`` (``BundleMeta``, EFB), ``cegb`` (a
    ``CegbSpec``) and ``forced`` ((feature, threshold bin, left node,
    right node) int arrays [K], the forced splits in preorder)."""

    def __init__(self, binsT: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor, meta: FeatureMeta, params: SplitParams,
                 missing_bin: torch.Tensor, *, max_leaves: int, num_bins: int,
                 max_depth: int = -1, exact: bool = False,
                 tile_leaves: int = 0, hist_subtraction: bool = True,
                 compaction_ladder: tuple = (), split_fusion: bool = True,
                 with_categorical: bool = False, sp: Optional[tuple] = None,
                 hist_method: str = "",
                 rng_key: Optional[torch.Tensor] = None,
                 sample_mask: Optional[torch.Tensor] = None,
                 subset: Optional[tuple] = None,
                 feature_mask: Optional[np.ndarray] = None,
                 mono_mode: str = "",
                 interaction_groups: Optional[np.ndarray] = None,
                 extra_trees: bool = False,
                 bynode_fraction: Optional[float] = None,
                 bundle: Optional[BundleMeta] = None,
                 cegb: Optional["CegbSpec"] = None,
                 forced: Optional[tuple] = None,
                 hist_dp: bool = False, feature_block: int = 0,
                 net=None, learner: str = "serial", vote_top_k: int = 20,
                 gang_rows: Optional[int] = None):
        assert tuple(sorted(compaction_ladder)) == tuple(compaction_ladder), \
            "compaction_ladder must be ascending"
        assert not (split_fusion and (with_categorical or sp is not None)), \
            ("split_fusion covers the numerical dense search only: "
             "categorical features and sparse columns take the classic path")
        assert not (split_fusion and (extra_trees or bynode_fraction
                                      is not None
                                      or mono_mode not in ("", "basic"))), \
            ("split_fusion covers basic monotone constraints only: "
             "extra_trees, by-node sampling and the intermediate and "
             "advanced monotone modes take the classic path")
        assert not (split_fusion and (bundle is not None or cegb is not None
                                      or forced is not None)), \
            ("split_fusion covers the unbundled search only: EFB bundles, "
             "CEGB and forced splits take the classic path")
        assert subset is None or (sp is None and sample_mask is None), \
            "the bagging subset copy holds dense columns and no mask"
        assert not (hist_dp and split_fusion), \
            "f64 histograms take the classic path (the epilogue is float32)"
        assert learner in ("serial", "data", "feature", "voting"), learner
        self.learner = learner
        self.net = net
        self.world = 1 if net is None else net.world
        self.rank = 0 if net is None else net.rank
        # rows sharded over the gang (root sums, scales and counts summed)
        self.rows_sharded = learner in ("data", "voting") and self.world > 1
        if learner != "serial":
            assert not split_fusion and not compaction_ladder and sp is None \
                and subset is None and not feature_block and cegb is None \
                and interaction_groups is None and bynode_fraction is None, (
                    "the distributed learners take the classic search over "
                    "dense columns without compaction, the bagging subset "
                    "copy, blocking, CEGB, interaction constraints or "
                    "by-node sampling")
            assert not (learner == "voting" and forced is not None), \
                "voting keeps planes local: no forced splits"
        self.vote_top_k = int(vote_top_k)
        self.fb = int(feature_block)
        if self.fb:
            assert not split_fusion and sp is None and subset is None \
                and cegb is None and forced is None and not hist_dp \
                and mono_mode in ("", "basic") and not hist_method.endswith(
                    "_q8"), ("the feature-blocked mode is the classic "
                             "search on dense columns without CEGB, forced "
                             "splits, box monotone constraints, the subset "
                             "copy, f64 or q8 histograms")
            hist_subtraction = False    # no resident parent planes
            compaction_ladder = ()
        # the per-leaf state's dtype: float64 planes and sums with hist_dp
        self.dtype = torch.float64 if hist_dp else torch.float32
        self.np_dtype = np.float64 if hist_dp else np.float32
        self.binsT = binsT
        self.dev = binsT.device
        self.f_dense, self.n_all = binsT.shape
        self.subset = subset
        # the histogram passes' rows: all N, or the subset's k
        self.hist_binsT = binsT if subset is None else subset[1]
        self.n = self.hist_binsT.shape[1]
        self.sp = sp
        self.f_sp = 0 if sp is None else len(sp[0])
        self.f = self.f_dense + self.f_sp
        # feature ownership (data: the owner search after the
        # reduce-scatter; feature: each rank's slice), padded to W slices
        self.sliced = learner in ("data", "feature")
        if self.sliced:
            assert self.f % self.world == 0, (
                f"features {self.f} not divisible into {self.world} slices "
                f"(pad in the caller)")
        self.f_loc = self.f // self.world if self.sliced else self.f
        self.off = self.rank * self.f_loc if self.sliced else 0
        self.L = max_leaves
        self.B = num_bins
        self.cat_words = cat_words_for(num_bins)
        self.max_depth = max_depth
        self.with_monotone = bool(mono_mode)
        self.mono_intermediate = mono_mode in ("intermediate", "advanced")
        self.mono_advanced = mono_mode == "advanced"
        self.mono_features = tuple(
            int(i) for i in np.nonzero(meta.monotone.cpu().numpy())[0])
        # the intermediate and advanced bounds come from all leaves'
        # current outputs, so each split is searched after the last
        self.exact = exact or self.mono_intermediate
        self.igroups = (None if interaction_groups is None
                        else np.asarray(interaction_groups, bool))
        self.extra_trees = extra_trees
        # by-node sampling keeps ceil(frac * F) features, computed in
        # float32 as the JAX package computes it (in float64 under x64,
        # which hist_dp stands for)
        ft = self.np_dtype
        self.bynode_k = None if bynode_fraction is None else max(int(
            np.ceil(ft(bynode_fraction) * ft(self.f))), 1)
        self.rng_key = prng_key(0) if rng_key is None else rng_key
        self.split_fusion = split_fusion
        self.with_categorical = with_categorical
        self.P = min(tile_leaves or cuda_hist.structural_tile_leaves(),
                     max_leaves)
        self.hist_subtraction = hist_subtraction
        self.ladder = tuple(compaction_ladder)
        self.meta = meta.to("cpu")
        self.meta_dev = meta.to(self.dev)
        # the slice this rank searches (all features but for data/feature)
        self.meta_s = FeatureMeta(*(a[self.off:self.off + self.f_loc]
                                    for a in self.meta_dev))
        if learner == "feature":
            # the replicated rows' columns of this rank's slice, a view
            # kept on binsT (its row-major copy is made once)
            self.hist_binsT = column_blocks(binsT, self.f_loc)[self.rank][2]
        self.params = params.to("cpu")
        self.params_dev = params.to(self.dev)
        self.missing_bin_dev = missing_bin.to(self.dev).to(torch.int32)
        self.fmask = (np.ones((self.f,), bool) if feature_mask is None
                      else np.asarray(feature_mask, bool))
        if subset is not None:
            grad, hess = grad[subset[0]], hess[subset[0]]
        if sample_mask is not None:
            grad, hess, cnt = grad * sample_mask, hess * sample_mask, \
                sample_mask
        else:
            cnt = torch.ones_like(grad)
        stats = torch.stack([grad, hess, cnt],
                            dim=1).to(torch.float32).contiguous()
        base = "cuda" if self.dev.type == "cuda" else "plain"
        hist_method = hist_method or base
        assert hist_method in (base, base + "_q8"), \
            f"histogram method {hist_method!r} on device {self.dev}"
        self.quant8 = hist_method.endswith("_q8")
        assert not (self.quant8 and hist_dp), \
            "q8 and f64 histograms are exclusive"
        # the gang's rows: the fixed-point exponent's row count of the
        # sharded passes, so every rank's planes share one scale
        assert gang_rows is not None or not self.rows_sharded, \
            "a rows-sharded learner needs the gang's row count"
        self.exp_rows = int(gang_rows) if self.rows_sharded else None
        # the data learner's passes in the integer-planes mode: on the card
        # and in the CPU's kernel order (q8 planes are integers anyway)
        self.int_planes = (learner == "data" and self.world > 1
                           and not self.quant8
                           and (self.dev.type == "cuda"
                                or cuda_hist.kernel_sums_active()))
        self.q_scale = None
        # f32 mode: the stats' max|stat| per channel, which sets the
        # histogram kernel's fixed-point scale, taken once per tree
        self.amax = None
        if self.quant8:
            self.stats, self.q_scale, self.root = self._quantize(
                stats, self.rng_key)
        else:
            self.stats = stats
            root = tree_sum(stats.to(self.dtype), 0)
            self.amax = stats.abs().amax(0)
            if self.rows_sharded:
                root = self.net.fold_sum(root)
                self.amax = self.net.allreduce_max(self.amax)
            self.root = root.cpu()
        self.iota = np.arange(self.L, dtype=np.int32)
        self.two_min_data = np.float32(2.0) * np.float32(
            self.params.min_data_in_leaf)
        self.two_min_hess = np.float32(2.0) * np.float32(
            self.params.min_sum_hessian_in_leaf)
        if split_fusion:
            self.fm_pack = cuda_hist.pack_feature_meta(
                meta.num_bins, meta.missing_type, meta.default_bin,
                meta.monotone).to(self.dev)
            self.pvec = cuda_hist.pack_scan_params(params).to(self.dev)
        if sp is not None:
            sp_cols = np.asarray(sp[0], dtype=np.int64)
            is_sp = np.zeros((self.f,), dtype=bool)
            is_sp[sp_cols] = True
            self.sp_cols = sp_cols
            self.dense_cols = np.nonzero(~is_sp)[0]
            col2dense = np.zeros((self.f,), dtype=np.int64)
            col2dense[self.dense_cols] = np.arange(len(self.dense_cols))
            self.col2sp = np.zeros((self.f,), dtype=np.int64)
            self.col2sp[sp_cols] = np.arange(self.f_sp)
            self.col2dense_dev = torch.as_tensor(col2dense).to(self.dev)
        self.bundle = None if bundle is None else bundle.to(self.dev)
        self.cegb = cegb
        self.forced = (None if forced is None
                       else tuple(np.asarray(a, np.int64) for a in forced))
        # each forced node takes a round even when its subtree is dead
        k_forced = 0 if forced is None else len(self.forced[0])
        self.max_rounds = 3 * self.L + 8 + k_forced

    def _quantize(self, stats: torch.Tensor, rng_key: torch.Tensor):
        """The quantized-gradient mode's int8 stats (JAX ``grow_tree``'s
        quant8 block): per-tree scales max(max|stat|, 1e-12) / 127 for
        grad and hess (the count channel's scale is exactly 1, so
        ``floor(1 + u)`` keeps every count 1), stochastic rounding
        ``floor(stat / scale + u)`` with ``u`` the JAX package's
        ``uniform(fold_in(key, 0x5138), [N, 3])``, clipped to +-127.
        Returns (int8 stats [N, 3], q_scale [3] f32, root sums on the host:
        the float32 sum of the int8 stats in XLA's order, times the
        scale)."""
        if self.n > cuda_hist.Q8_MAX_ROWS:
            raise ValueError(
                f"quantized histograms overflow int32 beyond "
                f"{cuda_hist.Q8_MAX_ROWS} rows (got {self.n}); use the "
                f"pallas_hilo method at this scale")
        floor = torch.tensor(1e-12, dtype=torch.float32, device=self.dev)
        amax = torch.maximum(stats[:, :2].abs().amax(0), floor)
        if self.rows_sharded:
            amax = self.net.allreduce_max(amax)
        # XLA compiles the JAX package's ``amax / 127.0`` into a multiply
        # by the float32 reciprocal of its constant divisor; the stochastic
        # rounding's ``stats / q_scale`` (a divisor known at run time only)
        # stays a true division
        q_scale = torch.cat([amax * np.float32(1.0 / 127.0),
                             torch.ones((1,), device=self.dev)])
        u = uniform(fold_in(rng_key, 0x5138), (self.n, 3), device=self.dev)
        q = torch.clamp(torch.floor(stats / q_scale[None, :] + u), -127,
                        127).to(torch.int8).contiguous()
        root = tree_sum(q.to(torch.float32), 0) * q_scale
        if self.rows_sharded:
            root = self.net.fold_sum(root)
        return q, q_scale, root.cpu()

    # ------------------------------------------------------------- state
    def init_state(self) -> GrowState:
        L, W = self.L, self.cat_words
        root = self.root
        root_out = calculate_leaf_output(root[0], root[1], self.params,
                                         root[2], torch.tensor(0.0))

        def zf():
            return np.zeros((L,), dtype=self.np_dtype)

        zi = np.zeros((L,), dtype=np.int32)
        best = SplitInfo(
            gain=np.full((L,), NEG_INF, np.float32), feature=zi.copy(),
            threshold=zi.copy(), default_left=np.zeros((L,), bool),
            left_sum_g=zf(), left_sum_h=zf(), left_count=zf(),
            right_sum_g=zf(), right_sum_h=zf(), right_count=zf(),
            left_output=zf(), right_output=zf(),
            is_cat=np.zeros((L,), bool),
            cat_bitset=np.zeros((L, W), np.int64),
            seg_lo=np.full((L,), -1, np.int32),
            seg_hi=np.full((L,), -1, np.int32))
        sums = [zf() for _ in range(4)]
        for s, v in zip(sums, (root[0], root[1], root[2], root_out)):
            s[0] = v.numpy()
        boxes = None, None
        if self.mono_intermediate:
            nb = self.meta.num_bins.numpy().astype(np.int32)
            boxes = (np.zeros((L, self.f), np.int32),
                     np.broadcast_to(nb - 1, (L, self.f)).copy())
        return GrowState(
            leaf_id=torch.zeros((self.n_all,), dtype=torch.int32,
                                device=self.dev),
            leaf_id_sub=(None if self.subset is None else torch.zeros(
                (self.n,), dtype=torch.int32, device=self.dev)),
            hist=(None if self.fb else torch.zeros(
                (L, self.f_loc, self.B, 3), dtype=self.dtype,
                device=self.dev)),
            hist_valid=np.zeros((L,), bool), leaf_dead=np.zeros((L,), bool),
            leaf_sum_g=sums[0], leaf_sum_h=sums[1], leaf_cnt=sums[2],
            leaf_output=sums[3], leaf_depth=zi.copy(),
            leaf_min=np.full((L,), -F32_MAX, self.np_dtype),
            leaf_max=np.full((L,), F32_MAX, self.np_dtype),
            leaf_lo=boxes[0], leaf_hi=boxes[1],
            used_path=(None if self.igroups is None
                       else np.zeros((L, self.f), bool)),
            sib=np.full((L,), -1, np.int32),
            parent_hist=np.zeros((L,), bool),
            best=best, tree=empty_tree(L, W).numpy(),
            forced_slot=(None if self.forced is None else np.concatenate(
                [[0], np.full((len(self.forced[0]) - 1,), -1)]).astype(
                    np.int64)))

    def hist_leaf_id(self, st: GrowState) -> torch.Tensor:
        """The leaf ids of the histogram passes' rows."""
        return st.leaf_id if st.leaf_id_sub is None else st.leaf_id_sub

    def active_mask(self, st: GrowState) -> np.ndarray:
        return self.iota < st.num_leaves

    def pending_mask(self, st: GrowState) -> np.ndarray:
        return self.active_mask(st) & ~st.hist_valid & ~st.leaf_dead

    def outer_cond(self, st: GrowState) -> bool:
        more = bool(self.pending_mask(st).any()) or not st.done
        return st.num_leaves < self.L and more and st.rounds < self.max_rounds

    def leaf_feature_mask(self, st: GrowState) -> np.ndarray:
        """[L, F] bool: the features each leaf's search may split on --
        by-tree column sampling, interaction constraints and by-node
        sampling (the JAX package's ``leaf_feature_mask``; its draw keyed
        on this growth round)."""
        out = np.broadcast_to(self.fmask, (self.L, self.f))
        if self.igroups is not None:
            # a leaf may use the union of the groups that hold every
            # feature on its path. The JAX package counts with two float32
            # matmuls; the counts are small exact integers, so this
            # boolean form gives the same mask
            grp = self.igroups                                   # [G, F]
            viol = (st.used_path[:, None, :] & ~grp[None]).any(2)  # [L, G]
            out = out & ((~viol)[:, :, None] & grp[None]).any(1)
        if self.bynode_k is not None:
            # the ceil(frac * F) lowest ranks of a uniform draw per leaf
            u = uniform(fold_in(self._round_key(st), 1), (self.L, self.f),
                        dtype=self.dtype).numpy()
            rank = np.argsort(np.argsort(u, axis=1, kind="stable"), axis=1,
                              kind="stable")
            out = out & (rank < self.bynode_k)
        return out

    def _round_key(self, st: GrowState) -> torch.Tensor:
        """The key of this growth round's draws."""
        return fold_in(self.rng_key, st.rounds)

    def rand_bins(self, st: GrowState) -> torch.Tensor:
        """extra_trees' random threshold [L, F] int32 per (leaf, feature):
        ``u * max(num_bins - 2, 1)`` truncated, as the JAX package draws
        it (feature_histogram.hpp USE_RAND)."""
        nbm = torch.clamp(self.meta.num_bins - 2, min=1).to(torch.float32)
        u = uniform(fold_in(self._round_key(st), 2), (self.L, self.f),
                    dtype=self.dtype)
        return (u * nbm[None, :]).to(torch.int32)

    def dead_guard(self, st: GrowState) -> None:
        """BeforeFindBestSplit guards (serial_tree_learner.cpp:282-322)."""
        guard = ((st.leaf_cnt >= self.two_min_data)
                 & (st.leaf_sum_h >= self.two_min_hess))
        newly = self.active_mask(st) & ~st.hist_valid & ~st.leaf_dead & ~guard
        st.leaf_dead |= newly

    # -------------------------------------------------------- tile pass
    def _candidates(self, st: GrowState):
        """The pending leaves a pass may compute (with subtraction, the
        smaller of each derivable sibling pair), their siblings and the
        slots holding the pairs' parent planes."""
        iota = self.iota
        pending = self.pending_mask(st)
        sibc = np.maximum(st.sib, 0)
        has_sib = st.sib >= 0
        p_slot = np.minimum(iota, sibc)
        if not self.hist_subtraction:
            return pending, pending, sibc, has_sib, p_slot, None
        derivable = (pending & pending[sibc] & has_sib
                     & st.parent_hist[p_slot])
        cnt_sib = st.leaf_cnt[sibc]
        is_smaller = ((st.leaf_cnt < cnt_sib)
                      | ((st.leaf_cnt == cnt_sib) & (iota < sibc)))
        cand = pending & (~derivable | is_smaller)
        return pending, cand, sibc, has_sib, p_slot, derivable

    def _first(self, cand: np.ndarray, k: int):
        """The first ``k`` slots in ascending slot order, candidates first:
        (slots, which are candidates)."""
        order = np.argsort(np.where(cand, self.iota, self.L + self.iota),
                           kind="stable")[:k].astype(np.int32)
        return order, cand[order]

    def _rung(self, st: GrowState, sel_compute: np.ndarray):
        """The compaction ladder's choice for a tile computing the leaves
        ``sel_compute`` (-1 = none): (row-index buffer or None, rows the
        pass reads, rows it adds: the tile's rows in a gather pass, all N
        in a full one)."""
        if not self.ladder or self.f_dense == 0:
            return None, float(self.n), float(self.n)
        p2 = sel_compute.shape[0]
        slot_map = np.full((self.L + 1,), p2, dtype=np.int32)
        ok = sel_compute >= 0
        slot_map[sel_compute[ok]] = np.nonzero(ok)[0]
        in_tile = torch.as_tensor(slot_map).to(self.dev)[
            self.hist_leaf_id(st).long()] < p2
        n_pend = int(in_tile.sum())
        for m in self.ladder:             # smallest rung that fits
            if n_pend <= m:
                return compact_indices(in_tile, m), float(m), float(n_pend)
        return None, float(self.n), float(self.n)

    def _select_pairs(self, st: GrowState):
        """The fused tile's slots: (sel [P2] int32, derive [P2] bool,
        p_slot [L])."""
        pending, cand, sibc, _, p_slot, derivable = self._candidates(st)
        if self.hist_subtraction:
            chosen, chosen_ok = self._first(cand, max(self.P // 2, 1))
            sel_even = np.where(chosen_ok, chosen, -1)
            partner_ok = chosen_ok & derivable[chosen]
            sel_odd = np.where(partner_ok, sibc[chosen], -1)
            sel = np.stack([sel_even, sel_odd], 1).reshape(-1)
            derive = np.stack([np.zeros_like(partner_ok), partner_ok],
                              1).reshape(-1)
        else:
            chosen, chosen_ok = self._first(pending, self.P)
            sel = np.where(chosen_ok, chosen, -1)
            derive = np.zeros((self.P,), dtype=bool)
        return sel.astype(np.int32), derive, p_slot

    def tile_pass_fused(self, st: GrowState) -> None:
        """One frontier pass: planes + candidates for a tile of pending
        leaves, with the larger sibling of each pair derived in-pass."""
        sel, derive, p_slot = self._select_pairs(st)
        p2 = sel.shape[0]
        assert epilogue_supported(p2, 3), f"{p2} slots exceed the epilogue"
        selc = np.maximum(sel, 0)
        ok = sel >= 0
        dev = self.dev
        derive_d = torch.as_tensor(derive).to(dev)
        pp = torch.as_tensor(p_slot[selc].astype(np.int64)).to(dev)
        parent_planes = torch.where(derive_d[:, None, None, None],
                                    st.hist[pp], 0.0).contiguous()
        aggs = [torch.from_numpy(a[selc]) for a in
                (st.leaf_sum_g, st.leaf_sum_h, st.leaf_cnt, st.leaf_output)]
        bounds = ((torch.from_numpy(st.leaf_min[selc]),
                   torch.from_numpy(st.leaf_max[selc]))
                  if self.with_monotone else (None, None))
        la = cuda_hist.pack_leaf_aux(*aggs, *bounds).to(dev)
        gather_idx, streamed, real = self._rung(st, np.where(derive, -1,
                                                             sel))
        tile, cand = histogram_tiles_with_candidates(
            self.hist_binsT, self.stats, self.hist_leaf_id(st),
            torch.from_numpy(sel),
            torch.from_numpy(derive), parent_planes, la, self.fm_pack,
            self.pvec, self.B, self.L, gather_idx, q_scale=self.q_scale,
            amax=self.amax, with_monotone=self.with_monotone)

        slots = sel[ok]
        st.hist[torch.as_tensor(slots.astype(np.int64)).to(dev)] = tile[
            torch.as_tensor(np.nonzero(ok)[0]).to(dev)]
        info = candidates_to_splitinfo(
            cand.cpu(), *aggs, torch.from_numpy(st.leaf_depth[selc]),
            self.meta, self.params,
            torch.from_numpy(self.leaf_feature_mask(st)[selc].copy()),
            self.max_depth, self.cat_words,
            with_monotone=self.with_monotone, leaf_min=bounds[0],
            leaf_max=bounds[1])
        for cur, new in zip(st.best, info):
            cur[slots] = _np(new)[ok]
        st.hist_valid[slots] = True
        st.parent_hist[slots] = False
        st.rounds += 1
        st.rows_streamed += streamed
        st.rows_real += real

    def combine_sparse(self, tile: torch.Tensor, sel: np.ndarray,
                       leaf_id: torch.Tensor) -> torch.Tensor:
        """Planes of the sparse columns: an O(nnz) scatter-add of the
        non-default (row, bin) stream entries, and the elided default bin
        rebuilt from per-slot totals -- the reference's most_freq elision
        + FixHistogram (sparse_bin.hpp ConstructHistogram; dataset.h:506).
        Returns the full [P, F, B, 3] tile with the dense planes at their
        column ids: in the grower's dtype, or in q8 mode exact int32 sums of
        the int8 stats."""
        sp_cols, sp_rows, sp_bins, sp_default = self.sp
        n, B, f_sp = self.n, self.B, self.f_sp
        p = sel.shape[0]
        dev = self.dev
        valid = sp_rows < n                                  # [F_sp, M]
        rclip = sp_rows.clamp(max=n - 1).long()
        slot_map = np.full((self.L + 1,), p, dtype=np.int64)
        ok = sel >= 0
        slot_map[sel[ok]] = np.nonzero(ok)[0]
        slot = torch.as_tensor(slot_map).to(dev)[leaf_id[rclip].long()]
        acc = torch.int32 if self.quant8 else self.dtype
        st = torch.where(valid[..., None], self.stats[rclip].to(acc),
                         torch.zeros((), dtype=acc, device=dev))
        col = torch.arange(f_sp, device=dev)[:, None]
        idx = (slot * f_sp + col) * B + sp_bins.long()
        # an accumulating index_put_ adds each cell's entries one by one
        # in entry (row) order on both devices -- on CUDA through a stable
        # sort, not atomics -- so the planes are the same bits every run
        # (q8's integer sums are exact in any order)
        flat = torch.zeros(((p + 1) * f_sp * B, 3), dtype=acc, device=dev)
        flat.index_put_((idx.reshape(-1),), st.reshape(-1, 3),
                        accumulate=True)
        sp_t = flat.reshape(p + 1, f_sp, B, 3)[:p]
        # per-slot totals: any dense column's plane partitions the rows
        if self.f_dense > 0:
            totals = tree_sum(tile[:, 0], 1)                 # [P, 3]
        elif self.quant8:
            slot_all = torch.as_tensor(slot_map).to(dev)[leaf_id.long()]
            totals = torch.zeros((p + 1, 3), dtype=acc, device=dev)
            totals = totals.index_add_(0, slot_all, self.stats.to(acc))[:p]
        else:
            eq = (leaf_id[:, None] == torch.as_tensor(sel).to(dev)[None, :])
            totals = eq.to(acc).T @ self.stats.to(acc)
        others = tree_sum(sp_t, 2)                           # [P, F_sp, 3]
        defm = (torch.arange(B, device=dev)[None, :]
                == sp_default.long()[:, None])               # [F_sp, B]
        recon = (totals[:, None, :] - others)[:, :, None, :]
        sp_t = torch.where(defm[None, :, :, None], recon, sp_t)
        full = torch.zeros((p, self.f, B, 3), dtype=acc, device=dev)
        full[:, torch.as_tensor(self.dense_cols).to(dev)] = tile
        full[:, torch.as_tensor(self.sp_cols).to(dev)] = sp_t
        return full

    def tile_pass(self, st: GrowState) -> None:
        """One plane-only histogram pass for the first P candidate leaves;
        each computed leaf's pending sibling is derived as parent -
        computed on the resident planes."""
        pending, cand, sibc, has_sib, p_slot, _ = self._candidates(st)
        chosen, chosen_ok = self._first(cand, self.P)
        sel = np.where(chosen_ok, chosen, -1).astype(np.int32)
        dev = self.dev
        gather_idx, streamed, real = self._rung(st, sel)
        if self.f_dense > 0:
            tile = self._planes(st, sel, gather_idx)
        else:
            tile = torch.zeros((sel.shape[0], 0, self.B, 3),
                               dtype=torch.int32 if self.quant8
                               else self.dtype, device=dev)
        if self.f_sp:
            tile = self.combine_sparse(tile, sel, st.leaf_id)
        if self.quant8:
            # exact int32 sums, dequantized once; the JAX package fences
            # this product (_round_fence) against FMA contraction into the
            # subtraction below, which eager torch never does
            tile = tile.to(torch.float32) * self.q_scale

        computed = np.zeros((self.L,), dtype=bool)
        computed[chosen] = chosen_ok
        comp_slots = chosen[chosen_ok]
        pos = np.full((self.L,), -1, dtype=np.int64)
        pos[comp_slots] = np.nonzero(chosen_ok)[0]
        derived = np.zeros((self.L,), dtype=bool)
        if self.hist_subtraction:
            derived = (pending & ~computed & computed[sibc]
                       & st.parent_hist[p_slot] & has_sib)
        der = np.nonzero(derived)[0]
        if len(der):
            # the parents' planes are still resident at p_slot (this
            # pass's writes come after)
            der_planes = (st.hist[torch.as_tensor(p_slot[der].astype(
                np.int64)).to(dev)]
                - tile[torch.as_tensor(pos[sibc[der]]).to(dev)])
        st.hist[torch.as_tensor(comp_slots.astype(np.int64)).to(dev)] = tile[
            torch.as_tensor(pos[comp_slots]).to(dev)]
        if len(der):
            st.hist[torch.as_tensor(der).to(dev)] = der_planes
        resolved = computed | derived
        st.hist_valid |= resolved
        st.parent_hist &= ~resolved
        st.rounds += 1
        st.rows_streamed += streamed
        st.rows_real += real

    def _planes(self, st: GrowState, sel: np.ndarray,
                gather_idx: Optional[torch.Tensor]) -> torch.Tensor:
        """The tile's planes this rank keeps: all columns (serial, voting),
        its slice's (feature), or for the data learner its owned slice of
        the gang's sum -- exact integer planes reduce-scattered (q8, or the
        integer-planes mode, then converted), else float planes folded in
        rank order (XLA:CPU's ``psum_scatter``)."""
        args = (self.hist_binsT, self.stats, self.hist_leaf_id(st),
                torch.from_numpy(sel), self.B, self.L, gather_idx)
        if self.learner != "data" or self.world == 1:
            return histogram_tiles(*args, amax=self.amax, dtype=self.dtype,
                                   rows=self.exp_rows)
        if self.int_planes:
            raw = histogram_tiles(*args, amax=self.amax, rows=self.exp_rows,
                                  raw=True)
            return cuda_hist.hist_convert(
                self.net.reduce_scatter_int(raw, 1), self.amax,
                self.exp_rows, self.dtype)
        tile = histogram_tiles(*args, amax=self.amax, dtype=self.dtype)
        if self.quant8:
            # int32 sums of the gang's rows overflow past Q8_MAX_ROWS
            if self.exp_rows > cuda_hist.Q8_MAX_ROWS:
                tile = tile.to(torch.int64)
            return self.net.reduce_scatter_int(tile, 1)
        return self.net.fold_sum_scatter(tile, 1)

    # ----------------------------------------------------- blocked mode
    def blocked_pass(self, st: GrowState) -> None:
        """Histogram + search for a tile of pending leaves, one column
        block at a time (the JAX package's ``blocked_pass``): the block's
        planes live only through its search, and the blocks' bests merge
        as ``merge_best`` does; only the SplitInfo is kept."""
        pending = self.pending_mask(st)
        chosen, chosen_ok = self._first(pending, self.P)
        sel = np.where(chosen_ok, chosen, -1).astype(np.int32)
        dev = self.dev
        cidx = torch.as_tensor(chosen.astype(np.int64))
        fmask = torch.from_numpy(np.ascontiguousarray(
            self.leaf_feature_mask(st)[chosen])).to(dev)
        rand = (self.rand_bins(st)[cidx].to(dev) if self.extra_trees
                else None)
        aggs = [torch.from_numpy(a[chosen]).to(dev) for a in
                (st.leaf_sum_g, st.leaf_sum_h, st.leaf_cnt, st.leaf_output,
                 st.leaf_depth)]
        bounds = ([torch.from_numpy(a[chosen]).to(dev)
                   for a in (st.leaf_min, st.leaf_max)]
                  if self.with_monotone else (None, None))
        sel_t = torch.from_numpy(sel)
        best = None
        blocks = column_blocks(self.binsT, self.fb)
        for s_, e_, bins_b in blocks:
            tile = histogram_tiles(bins_b, self.stats, st.leaf_id, sel_t,
                                   self.B, self.L, amax=self.amax,
                                   dtype=self.dtype)
            meta_b = FeatureMeta(*(a[s_:e_] for a in self.meta_dev))
            bundle_b = (None if self.bundle is None else type(self.bundle)(
                *(a[s_:e_] for a in self.bundle)))
            bb = find_best_splits(
                tile, *aggs, meta_b, self.params_dev, fmask[:, s_:e_],
                self.max_depth, with_categorical=self.with_categorical,
                cat_words=self.cat_words, leaf_min=bounds[0],
                leaf_max=bounds[1],
                rand_bin=None if rand is None else rand[:, s_:e_],
                bundle=bundle_b)
            bb = bb._replace(feature=bb.feature + s_)
            best = bb if best is None else merge_best(best, bb)
        slots = chosen[chosen_ok]
        for cur, new in zip(st.best, best):
            cur[slots] = _np(new)[chosen_ok]
        st.hist_valid[chosen] |= chosen_ok
        st.rounds += 1
        st.rows_streamed += float(self.n * len(blocks))
        st.rows_real += float(self.n * len(blocks))

    def split_phase_blocked(self, st: GrowState) -> None:
        """Apply splits from the stored per-leaf bests (no re-search: the
        planes are gone). A leaf's best holds until it is split: basic
        monotone bounds and interaction masks change only for the split
        leaf's children, which are searched afresh."""
        st.rounds += 1
        self.split_apply(st)

    # ------------------------------------------------------- split phase
    def split_search(self, st: GrowState) -> None:
        """The classic search: every leaf's best split over the resident
        planes, numerical and categorical (find_best_splits), under the
        leaves' monotone bounds -- in the intermediate and advanced modes
        recomputed first from all current leaves -- the feature masks and
        extra_trees' random thresholds."""
        dev = self.dev
        adv = None
        if self.mono_intermediate:
            act = torch.from_numpy(self.active_mask(st))
            boxes = torch.from_numpy(st.leaf_lo), torch.from_numpy(st.leaf_hi)
            out = torch.from_numpy(st.leaf_output)
            lb, ub = intermediate_bounds(*boxes, out, act, self.meta.monotone,
                                         self.mono_features)
            st.leaf_min = lb.numpy().astype(self.np_dtype)
            st.leaf_max = ub.numpy().astype(self.np_dtype)
            if self.mono_advanced:
                adv = advanced_child_bounds(
                    *(t.to(dev) for t in boxes), out.to(dev), act.to(dev),
                    self.meta.monotone, self.B, self.mono_features)
        aggs = [torch.from_numpy(a).to(dev) for a in
                (st.leaf_sum_g, st.leaf_sum_h, st.leaf_cnt, st.leaf_output,
                 st.leaf_depth)]
        bounds = ([torch.from_numpy(a).to(dev)
                   for a in (st.leaf_min, st.leaf_max)]
                  if self.with_monotone else (None, None))
        fmask = (self.fmask if self.igroups is None and self.bynode_k is None
                 else self.leaf_feature_mask(st))
        fmask = self._slice_f(torch.from_numpy(np.ascontiguousarray(
            fmask)).to(dev))
        rand = (self._slice_f(self.rand_bins(st).to(dev)) if self.extra_trees
                else None)
        if adv is not None:
            adv = tuple(a[:, self.off:self.off + self.f_loc] for a in adv)
        hist = st.hist
        if self.learner == "voting" and self.world > 1:
            hist, fmask = self._vote(st, aggs, fmask, rand)
        best = find_best_splits(
            hist, *aggs, self.meta_s, self.params_dev, fmask,
            self.max_depth, with_categorical=self.with_categorical,
            cat_words=self.cat_words, leaf_min=bounds[0],
            leaf_max=bounds[1], adv_bounds=adv, rand_bin=rand,
            gain_adjust=self.cegb_adjust(st), bundle=self._bundle_s())
        st.best = SplitInfo(*(_np(v) for v in self._sync(best)))
        st.rounds += 1

    def _slice_f(self, arr: torch.Tensor) -> torch.Tensor:
        """A per-feature trailing axis cut to this rank's slice."""
        if not self.sliced:
            return arr
        return arr[..., self.off:self.off + self.f_loc]

    def _bundle_s(self) -> Optional[BundleMeta]:
        if self.bundle is None or not self.sliced:
            return self.bundle
        return type(self.bundle)(*(a[self.off:self.off + self.f_loc]
                                   for a in self.bundle))

    def _sync(self, best: SplitInfo) -> SplitInfo:
        """A sliced search's best splits: local feature index to global,
        then the best over ranks (ties to the lowest rank)."""
        if not self.sliced or self.world == 1:
            return best
        best = best._replace(feature=best.feature + self.off)
        return sync_best_splits(best, self.net)

    def _vote(self, st: GrowState, aggs, fmask: torch.Tensor,
              rand: Optional[torch.Tensor]):
        """The voting learner's election (the JAX package's, after
        voting_parallel_tree_learner.cpp:137-182): each rank's best gain
        per (leaf, feature) on its local planes and local leaf sums, with
        ``min_data`` and ``min_hess`` over W; its top ``top_k`` features
        vote, the tally elects the top 2k per leaf (ties to the lower
        feature), and only the elected columns are summed over ranks.
        Returns (planes with the elected columns summed and zeros
        elsewhere, the search's feature mask). The JAX package selects the
        columns with one-hot matmuls; here a gather, whose result is
        normalised as the matmul's sum from +0 leaves it (-0 becomes +0)."""
        dev = self.dev
        L, f = self.L, self.f
        hist = st.hist
        lsum = tree_sum(hist[:, 0], 1)                          # [L, 3]
        ndev = torch.tensor(float(self.world), dtype=torch.float32)
        p = self.params_dev
        pv = p._replace(min_data_in_leaf=p.min_data_in_leaf / ndev.to(dev),
                        min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf
                        / ndev.to(dev))
        _, fgain = find_best_splits(
            hist, lsum[:, 0], lsum[:, 1], lsum[:, 2], aggs[3], aggs[4],
            self.meta_s, pv, fmask, self.max_depth,
            with_categorical=self.with_categorical,
            cat_words=self.cat_words, rand_bin=rand, bundle=self.bundle,
            return_feature_gains=True)
        kk = min(self.vote_top_k, f)
        k2 = min(2 * self.vote_top_k, f)
        rank_local = torch.argsort(torch.argsort(-fgain, dim=1, stable=True),
                                   dim=1, stable=True)
        local_top = (rank_local < kk) & torch.isfinite(fgain)
        votes = self.net.fold_sum(local_top.to(torch.float32))
        key = votes * np.float32(f + 1) - torch.arange(
            f, dtype=torch.float32, device=dev)[None, :]
        el = torch.argsort(-key, dim=1, stable=True)[:, :k2]     # [L, k2]
        li = torch.arange(L, device=dev)[:, None]
        hist_el = self.net.fold_sum(hist[li, el] + 0.0)         # [L, k2, B, 3]
        search = torch.zeros_like(hist)
        search[li, el] = hist_el + 0.0
        elected = torch.zeros((L, f), dtype=torch.bool, device=dev)
        elected[li, el] = True
        fm = fmask.to(torch.bool)
        if fm.dim() == 1:
            fm = fm[None, :].expand(L, f)
        return search, (fm & elected).to(torch.float32)

    def cegb_adjust(self, st: GrowState) -> Optional[torch.Tensor]:
        """CEGB's cost per (leaf, feature), taken off the keyed gains
        (cost_effective_gradient_boosting.hpp:66-84 DeltaGain), as the JAX
        package computes it in float32: tradeoff * penalty_split * the
        leaf's count, plus tradeoff * coupled penalty of each feature no
        split has used yet, plus (lazy) tradeoff * lazy penalty * the
        leaf's rows that have not used the feature yet. Those row counts
        are exact integers, counted with an integer ``index_add_``."""
        c = self.cegb
        if c is None:
            return None
        L, dev = self.L, self.dev
        t = np.float32(c.tradeoff)
        delta = (t * np.float32(c.penalty_split)) * st.leaf_cnt     # [L]
        delta = np.broadcast_to(delta[:, None], (L, self.f))
        if c.coupled is not None:
            delta = delta + np.where(c.state["used_split"][None, :],
                                     np.float32(0.0), t * c.coupled[None, :])
        delta = torch.from_numpy(np.ascontiguousarray(delta)).to(dev)
        if c.lazy is not None:
            unused = (~c.state["row_used"]).to(torch.int32)           # [N, F]
            cnt = torch.zeros((L, self.f), dtype=torch.int32, device=dev)
            cnt.index_add_(0, st.leaf_id.long(), unused)
            if self.rows_sharded:
                # the gang's rows (the JAX package's psum of cnt_unused;
                # the learners refuse CEGB, as the JAX package's do)
                cnt = self.net.fold_sum(cnt)
            tl = torch.from_numpy(t * c.lazy).to(dev)
            if delta.dtype == torch.float64:
                # f64 leaf counts: the float32 product is converted before
                # the add, so nothing contracts
                delta = delta + (tl[None, :] * cnt.to(torch.float32)).to(
                    torch.float64)
            else:
                delta = fma_f32(tl[None, :], cnt.to(torch.float32), delta)
        return delta

    def _apply_split(self, st: GrowState, gain_eff: np.ndarray) -> None:
        """Split the best leaf (SerialTreeLearner::Split + Tree::Split):
        the tree arrays and per-leaf state now, in place (the host state is
        this tree's alone), the row routing at the end of the phase."""
        l = int(np.argmax(gain_eff))
        best, t = st.best, st.tree
        new_leaf = st.num_leaves
        node = st.num_leaves - 1
        feat = int(best.feature[l])
        thr = int(best.threshold[l])
        dleft = bool(best.default_left[l])
        is_cat = bool(best.is_cat[l])
        bits = best.cat_bitset[l].copy()
        seg_lo, seg_hi = int(best.seg_lo[l]), int(best.seg_hi[l])

        parent = int(t.leaf_parent[l])
        if parent >= 0:
            if t.node_left[parent] == ~l:
                t.node_left[parent] = node
            if t.node_right[parent] == ~l:
                t.node_right[parent] = node
        # the node takes the parent leaf's aggregates before they change
        for arr, v in ((t.node_left, ~l), (t.node_right, ~new_leaf),
                       (t.node_feature, feat), (t.node_threshold_bin, thr),
                       (t.node_default_left, dleft),
                       (t.node_gain, best.gain[l]),
                       (t.node_value, st.leaf_output[l]),
                       (t.node_weight, st.leaf_sum_h[l]),
                       (t.node_count, st.leaf_cnt[l]),
                       (t.node_cat, is_cat), (t.node_cat_bitset, bits),
                       (t.node_seg_lo, seg_lo), (t.node_seg_hi, seg_hi)):
            arr[node] = v
        depth = st.leaf_depth[l] + 1
        lo, ro = best.left_output[l], best.right_output[l]
        lh, rh = best.left_sum_h[l], best.right_sum_h[l]
        lc, rc = best.left_count[l], best.right_count[l]
        for arr, a, b in (
                (t.leaf_value, lo, ro), (t.leaf_weight, lh, rh),
                (t.leaf_count, lc, rc), (t.leaf_depth, depth, depth),
                (t.leaf_parent, node, node),
                (st.hist_valid, False, False),
                (st.leaf_sum_g, best.left_sum_g[l], best.right_sum_g[l]),
                (st.leaf_sum_h, lh, rh), (st.leaf_cnt, lc, rc),
                (st.leaf_output, lo, ro), (st.leaf_depth, depth, depth),
                # slot l inherits the parent's planes (the subtraction trick)
                (st.sib, new_leaf, l), (st.parent_hist, True, False)):
            arr[l] = a
            arr[new_leaf] = b
        if self.with_monotone:
            self._update_bounds(st, l, new_leaf, feat, is_cat, lo, ro)
        if self.mono_intermediate:
            # the children take the parent's bin box; a numerical split
            # cuts the feature's interval, a categorical one nothing
            st.leaf_lo[new_leaf] = st.leaf_lo[l]
            st.leaf_hi[new_leaf] = st.leaf_hi[l]
            if not is_cat:
                st.leaf_lo[new_leaf, feat] = max(st.leaf_lo[l, feat],
                                                 thr + 1)
                st.leaf_hi[l, feat] = min(st.leaf_hi[l, feat], thr)
        if self.igroups is not None:
            st.used_path[l, feat] = True
            st.used_path[new_leaf] = st.used_path[l]
        if self.cegb is not None:
            self.cegb.state["used_split"][feat] = True
        st.pending_routes.append((l, new_leaf, feat, thr, dleft, is_cat,
                                  bits, seg_lo, seg_hi))
        st.num_leaves += 1
        gain_eff[l] = NEG_INF
        gain_eff[new_leaf] = NEG_INF

    def _update_bounds(self, st: GrowState, l: int, new_leaf: int, feat: int,
                       is_cat: bool, lo, ro) -> None:
        """The basic mode's bounds (monotone_constraints.hpp:485-501): the
        children inherit the parent's [min, max]; a split on a monotone
        feature tightens them at the children's mid-point, the left child
        keeping slot ``l``. The arithmetic is the grower's dtype with XLA's
        max and min."""
        mono = 0 if is_cat else int(self.meta.monotone[feat])
        t = self.np_dtype
        mid = (t(lo) + t(ro)) / t(2.0)
        pmin, pmax = st.leaf_min[l], st.leaf_max[l]
        st.leaf_min[l] = _fmax(pmin, mid) if mono < 0 else pmin
        st.leaf_max[l] = _fmin(pmax, mid) if mono > 0 else pmax
        st.leaf_min[new_leaf] = _fmax(pmin, mid) if mono > 0 else pmin
        st.leaf_max[new_leaf] = _fmin(pmax, mid) if mono < 0 else pmax

    def _split_column(self, binsT: torch.Tensor, feat_r: torch.Tensor,
                      feats: set) -> torch.Tensor:
        """Each row's bin of its leaf's split feature (``feat_r`` [N], -1
        for rows of unsplit leaves): a gather from the dense columns
        ``binsT``, and the sparse columns among ``feats`` rebuilt from
        their streams (the analog of SparseBin::Split's stream walk)."""
        fr = feat_r.clamp(min=0)
        if self.sp is None:
            return binsT.gather(0, fr[None, :])[0].to(torch.int32)
        if self.f_dense > 0:
            col = binsT.gather(0, self.col2dense_dev[fr][None, :])[0]
            col = col.to(torch.int32)
        else:
            col = torch.zeros((self.n_all,), dtype=torch.int32,
                              device=self.dev)
        _, sp_rows, sp_bins, sp_default = self.sp
        for f in sorted(feats):
            if f not in set(self.sp_cols.tolist()):
                continue
            i = int(self.col2sp[f])
            ok = sp_rows[i] < self.n_all
            colv = torch.full((self.n_all,), 0, dtype=torch.int32,
                              device=self.dev) + sp_default[i]
            colv[sp_rows[i][ok].long()] = sp_bins[i][ok].to(torch.int32)
            col = torch.where(feat_r == f, colv, col)
        return col

    def _route(self, st: GrowState) -> None:
        """Move the rows of every leaf split in this phase to its children
        in one device pass (_apply_split's routing, batched); in the
        bagging subset mode the subset's rows too, over their own bins."""
        if not st.pending_routes:
            return
        L, W = self.L, self.cat_words
        feat_t = np.full((L,), -1, dtype=np.int64)
        thr_t = np.zeros((L,), dtype=np.int32)
        dl_t = np.zeros((L,), dtype=bool)
        new_t = np.zeros((L,), dtype=np.int32)
        cat_t = np.zeros((L,), dtype=bool)
        bits_t = np.zeros((L, W), dtype=np.int64)
        seg_t = np.full((2, L), -1, dtype=np.int32)
        for (l, nl, feat, thr, dleft, is_cat, bits, slo,
             shi) in st.pending_routes:
            feat_t[l], thr_t[l], dl_t[l], new_t[l] = feat, thr, dleft, nl
            cat_t[l], bits_t[l] = is_cat, bits
            seg_t[:, l] = slo, shi
        feats = {r[2] for r in st.pending_routes}
        st.pending_routes = []
        dev = self.dev

        tables = [torch.as_tensor(a).to(dev)
                  for a in (feat_t, thr_t, dl_t, new_t, cat_t, bits_t,
                            seg_t)]
        if self.cegb is not None and self.cegb.lazy is not None:
            # the rows of each split leaf have now used its feature
            fr = tables[0][st.leaf_id.long()]
            rows = torch.nonzero(fr >= 0).reshape(-1)
            self.cegb.state["row_used"][rows, fr[rows]] = True
        st.leaf_id = self._route_rows(self.binsT, st.leaf_id, tables, feats,
                                      bool(cat_t.any()))
        if st.leaf_id_sub is not None:
            st.leaf_id_sub = self._route_rows(self.hist_binsT,
                                              st.leaf_id_sub, tables, feats,
                                              bool(cat_t.any()))

    def _route_rows(self, binsT, leaf_id, tables, feats, any_cat):
        """New leaf ids of the rows of ``binsT`` under one phase's split
        tables (by leaf: feature or -1, threshold, default left, new leaf,
        categorical, bitset)."""
        feat_t, thr_t, dl_t, new_t, cat_t, bits_t, seg_t = tables
        W = self.cat_words
        lid = leaf_id.long()
        feat_r = feat_t[lid]
        split_rows = feat_r >= 0
        col = self._split_column(binsT, feat_r, feats)
        mb = self.missing_bin_dev[feat_r.clamp(min=0)]
        go_left = torch.where((col == mb) & (mb >= 0), dl_t[lid],
                              col <= thr_t[lid])
        if self.bundle is not None:
            # a bundle split: rows outside the member's segment hold its
            # default mass and take the default direction
            slo, shi = seg_t[0][lid], seg_t[1][lid]
            in_seg = (col >= slo) & (col <= shi)
            go_left = torch.where(slo >= 0, torch.where(
                in_seg, col <= thr_t[lid], dl_t[lid]), go_left)
        if any_cat:
            word = bits_t.reshape(-1)[lid * W + (col >> 5).long()]
            cat_left = ((word >> (col & 31).long()) & 1) == 1
            go_left = torch.where(cat_t[lid], cat_left, go_left)
        return torch.where(split_rows & ~go_left, new_t[lid], leaf_id)

    def split_apply(self, st: GrowState) -> None:
        """Apply every available split from st.best in gain order (one in
        ``exact`` mode), then route the rows."""
        before = st.num_leaves
        gain_eff = np.where(self.active_mask(st) & st.hist_valid
                            & ~st.leaf_dead, st.best.gain,
                            np.float32(NEG_INF)).astype(np.float32)
        while st.num_leaves < self.L and float(gain_eff.max()) > 0.0:
            self._apply_split(st, gain_eff)
            if self.exact:
                break
        self._route(st)
        st.done = st.num_leaves == before

    def split_phase(self, st: GrowState) -> None:
        if self.fb:
            self.split_phase_blocked(st)
            return
        if self.split_fusion:
            # the search already ran in the tile passes' epilogues
            st.rounds += 1
        else:
            with profiling.timer("split_search", sync=self.dev):
                self.split_search(st)
        with profiling.timer("apply_split", sync=self.dev):
            self.split_apply(st)

    def forced_phase(self, st: GrowState) -> None:
        """Apply the next forced split (reference:
        SerialTreeLearner::ForceSplits, serial_tree_learner.cpp:450-562):
        the regular search with the candidates restricted to the forced
        feature and bin and the min_gain, min_data and min_hessian screens
        off, so the sums and the missing-value direction are the search's
        own; a forced split its constraints reject (no finite candidate) is
        skipped with its whole subtree."""
        dev = self.dev
        adv = None
        if self.mono_intermediate:
            act = torch.from_numpy(self.active_mask(st))
            boxes = torch.from_numpy(st.leaf_lo), torch.from_numpy(st.leaf_hi)
            out = torch.from_numpy(st.leaf_output)
            lb, ub = intermediate_bounds(*boxes, out, act, self.meta.monotone,
                                         self.mono_features)
            st.leaf_min = lb.numpy().astype(self.np_dtype)
            st.leaf_max = ub.numpy().astype(self.np_dtype)
            if self.mono_advanced:
                adv = advanced_child_bounds(
                    *(t.to(dev) for t in boxes), out.to(dev), act.to(dev),
                    self.meta.monotone, self.B, self.mono_features)
        ff, ft, fl, fr = self.forced
        k = st.forced_idx
        l = int(st.forced_slot[k])
        lsafe = max(l, 0)
        pf = self.params_dev

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        params = pf._replace(min_gain_to_split=f32(-1e30),
                             min_data_in_leaf=f32(0.0),
                             min_sum_hessian_in_leaf=f32(0.0))
        aggs = [torch.from_numpy(a).to(dev) for a in
                (st.leaf_sum_g, st.leaf_sum_h, st.leaf_cnt, st.leaf_output,
                 st.leaf_depth)]
        bounds = ([torch.from_numpy(a).to(dev)
                   for a in (st.leaf_min, st.leaf_max)]
                  if self.with_monotone else (None, None))
        if adv is not None:
            adv = tuple(a[:, self.off:self.off + self.f_loc] for a in adv)
        # ff holds global feature indices: under a feature slice only the
        # owner's mask lights up, and the sync picks its split
        best = find_best_splits(
            st.hist, *aggs, self.meta_s, params,
            torch.arange(self.f_loc, device=dev) + self.off == int(ff[k]),
            self.max_depth, with_categorical=False,
            cat_words=self.cat_words, leaf_min=bounds[0],
            leaf_max=bounds[1], adv_bounds=adv,
            rand_bin=torch.full((self.L, self.f_loc), int(ft[k]),
                                dtype=torch.int32, device=dev),
            bundle=self._bundle_s())
        st.best = SplitInfo(*(_np(v) for v in self._sync(best)))
        st.rounds += 1
        ok = (l >= 0 and st.num_leaves < self.L and bool(st.hist_valid[lsafe])
              and not bool(st.leaf_dead[lsafe])
              and bool(np.isfinite(st.best.gain[lsafe])))
        new_leaf = st.num_leaves
        if ok:
            gain_eff = np.full((self.L,), NEG_INF, np.float32)
            gain_eff[lsafe] = 1.0
            self._apply_split(st, gain_eff)
            self._route(st)
        # the children inherit slots (the left keeps the split leaf's, the
        # right takes the new one); a skipped node kills its subtree
        for child, leaf in ((fl[k], lsafe), (fr[k], new_leaf)):
            if child >= 0:
                st.forced_slot[child] = leaf if ok else -1
        st.forced_idx = k + 1
        st.done = False

    def hist_phase(self, st: GrowState) -> None:
        if self.fb:
            self.blocked_pass(st)
        elif self.split_fusion:
            self.tile_pass_fused(st)
        else:
            self.tile_pass(st)

    def sentinel(self, st: GrowState) -> bool:
        """The histogram-plane numerics sentinel on the final state (the
        JAX package's): the leaf sums and outputs integrate every
        histogram the tree used, and the resident planes are checked
        directly where they exist (not in the blocked mode)."""
        bad = not (np.isfinite(st.leaf_sum_g).all()
                   and np.isfinite(st.leaf_sum_h).all()
                   and np.isfinite(st.leaf_output).all())
        if not bad and st.hist is not None:
            bad = bool((~torch.isfinite(st.hist)).any())
        if self.rows_sharded:
            # any rank's verdict (the JAX package's psum of the flags)
            bad = float(self.net.fold_sum(torch.tensor([float(bad)]))) > 0
        return bad

    def finalize(self, st: GrowState):
        tree = TreeArrays(*(torch.as_tensor(np.asarray(a)) for a in st.tree))
        tree = tree._replace(
            num_leaves=torch.tensor(st.num_leaves, dtype=torch.int32))
        streamed = st.rows_streamed
        if self.rows_sharded:
            # the gang's rows per tree (each rank counted its own)
            streamed = float(self.net.fold_sum(
                torch.tensor([streamed], dtype=torch.float64)))
        return tree, st.leaf_id, streamed


def grow_tree(binsT: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              meta: FeatureMeta, params: SplitParams,
              missing_bin: torch.Tensor, *, max_leaves: int, num_bins: int,
              max_depth: int = -1, exact: bool = False, tile_leaves: int = 0,
              hist_subtraction: bool = True, compaction_ladder: tuple = (),
              split_fusion: bool = True, with_categorical: bool = False,
              sp: Optional[tuple] = None, hist_method: str = "",
              rng_key: Optional[torch.Tensor] = None,
              counters: Optional[Dict[str, float]] = None,
              sample_mask: Optional[torch.Tensor] = None,
              subset: Optional[tuple] = None,
              feature_mask: Optional[np.ndarray] = None,
              mono_mode: str = "",
              interaction_groups: Optional[np.ndarray] = None,
              extra_trees: bool = False,
              bynode_fraction: Optional[float] = None,
              bundle: Optional[BundleMeta] = None,
              cegb: Optional["CegbSpec"] = None,
              forced: Optional[tuple] = None,
              hist_dp: bool = False, feature_block: int = 0,
              numerics_sentinels: bool = False, net=None,
              learner: str = "serial", vote_top_k: int = 20,
              gang_rows: Optional[int] = None
              ) -> Tuple[TreeArrays, torch.Tensor, float]:
    """Grow one tree from per-row gradients/hessians. ``hist_method`` is
    ``ops/histogram.resolve_method``'s answer (empty: the f32 mode of the
    device's path); a ``*_q8`` method quantizes with ``rng_key`` (the
    JAX package's ``PRNGKey(0)`` when None). Returns (tree arrays on the
    host, per-row leaf index on the device, rows read by the histogram
    passes); ``counters``, when given, gains the tree's ``rows_real``: the
    rows those passes added (a gather pass's tile rows, a full pass's N),
    beside which the rows read show the rungs' padding. ``sample_mask``,
    ``subset``, ``feature_mask``, the constraint options, the data
    layer's (``bundle``, ``cegb``, ``forced``), ``hist_dp`` (float64
    histograms and per-leaf state) and ``feature_block`` (the blocked
    mode's column width, 0 = the resident state) as ``Grower``'s; the leaf
    ids cover all N rows either way. ``numerics_sentinels`` judges the
    final state (``Grower.sentinel``) into ``counters["sentinel"]``.
    ``net``, ``learner``, ``vote_top_k`` and ``gang_rows`` (the gang's
    padded row count): one rank of a distributed learner, as
    ``parallel/learners.ParallelGrower`` calls it; the leaf ids are then
    this rank's rows'."""
    g = Grower(binsT, grad, hess, meta, params, missing_bin,
               max_leaves=max_leaves, num_bins=num_bins, max_depth=max_depth,
               exact=exact, tile_leaves=tile_leaves,
               hist_subtraction=hist_subtraction,
               compaction_ladder=compaction_ladder, split_fusion=split_fusion,
               with_categorical=with_categorical, sp=sp,
               hist_method=hist_method, rng_key=rng_key,
               sample_mask=sample_mask, subset=subset,
               feature_mask=feature_mask, mono_mode=mono_mode,
               interaction_groups=interaction_groups,
               extra_trees=extra_trees, bynode_fraction=bynode_fraction,
               bundle=bundle, cegb=cegb, forced=forced, hist_dp=hist_dp,
               feature_block=feature_block, net=net, learner=learner,
               vote_top_k=vote_top_k, gang_rows=gang_rows)
    st = g.init_state()
    k_forced = 0 if g.forced is None else len(g.forced[0])
    while g.outer_cond(st):
        g.dead_guard(st)
        if bool(g.pending_mask(st).any()):
            with profiling.timer("hist_pass", sync=g.dev):
                g.hist_phase(st)
        elif st.forced_idx < k_forced:
            g.forced_phase(st)
        else:
            g.split_phase(st)
    if counters is not None:
        counters["rows_real"] = counters.get("rows_real", 0.0) + st.rows_real
        if numerics_sentinels:
            counters["sentinel"] = int(g.sentinel(st))
    return g.finalize(st)
