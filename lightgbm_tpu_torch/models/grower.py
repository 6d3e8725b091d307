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

In the quantized-gradient mode (a ``*_q8`` histogram method) the
gradients and hessians become int8 before growth, with per-tree scales and
stochastic rounding drawn from the tree's key (``utils/random.py``, the
JAX package's draw bit for bit); the tile passes sum them exactly in int32
and dequantize once per pass (in the epilogue on the fused path, after
``combine_sparse`` on the classic one), so the resident planes stay
float32.

Equivalence to the reference's leaf-wise order, the dead-leaf guard
(BeforeFindBestSplit) and the tie rules are the JAX package's; trees are
bitwise equal to its ``grow_tree`` on the same inputs where the histograms
are (the CPU plain path is; q8 sums are exact everywhere).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_hist
from ..ops.histogram import (compact_indices, epilogue_supported,
                             histogram_tiles, histogram_tiles_with_candidates)
from ..ops.split import (FeatureMeta, SplitInfo, SplitParams,
                         calculate_leaf_output, candidates_to_splitinfo,
                         cat_words_for, find_best_splits)
from ..utils.ordered import tree_sum
from ..utils.random import fold_in, prng_key, uniform
from .tree import TreeArrays, empty_tree

NEG_INF = float("-inf")


@dataclass
class GrowState:
    """One tree's growth state: device tensors (``leaf_id``, ``hist``) and
    numpy arrays for everything per-leaf."""
    leaf_id: torch.Tensor        # [N] int32, device
    hist: torch.Tensor           # [L, F, B, 3] f32, device
    hist_valid: np.ndarray       # [L] bool
    leaf_dead: np.ndarray        # [L] bool (guard-failed)
    leaf_sum_g: np.ndarray       # [L] f32
    leaf_sum_h: np.ndarray
    leaf_cnt: np.ndarray
    leaf_output: np.ndarray
    leaf_depth: np.ndarray       # [L] int32
    sib: np.ndarray              # [L] int32 sibling slot (-1 = none)
    parent_hist: np.ndarray      # [L] bool: slot holds the PARENT's planes
    best: SplitInfo              # [L] per-leaf best split, numpy fields
    tree: TreeArrays             # the tree under growth, numpy fields
    num_leaves: int = 1
    rounds: int = 0
    done: bool = False
    rows_streamed: float = 0.0
    # the current split phase's splits: (leaf, new_leaf, feature,
    # threshold_bin, default_left, is_cat, bitset), routed together at the
    # phase's end
    pending_routes: List[tuple] = field(default_factory=list)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class Grower:
    """The static configuration and data of one tree's growth (the JAX
    ``_grower_fns`` closure).

    ``binsT`` holds the dense device columns; with ``sp`` = (sp_cols,
    sp_rows, sp_bins, sp_default) the columns ``sp_cols`` live as (row,
    bin) streams instead (``Dataset._maybe_extract_sparse``), and feature
    indices, ``meta`` and ``missing_bin`` span all columns."""

    def __init__(self, binsT: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor, meta: FeatureMeta, params: SplitParams,
                 missing_bin: torch.Tensor, *, max_leaves: int, num_bins: int,
                 max_depth: int = -1, exact: bool = False,
                 tile_leaves: int = 0, hist_subtraction: bool = True,
                 compaction_ladder: tuple = (), split_fusion: bool = True,
                 with_categorical: bool = False, sp: Optional[tuple] = None,
                 hist_method: str = "",
                 rng_key: Optional[torch.Tensor] = None):
        assert tuple(sorted(compaction_ladder)) == tuple(compaction_ladder), \
            "compaction_ladder must be ascending"
        assert not (split_fusion and (with_categorical or sp is not None)), \
            ("split_fusion covers the numerical dense search only: "
             "categorical features and sparse columns take the classic path")
        self.binsT = binsT
        self.dev = binsT.device
        self.f_dense, self.n = binsT.shape
        self.sp = sp
        self.f_sp = 0 if sp is None else len(sp[0])
        self.f = self.f_dense + self.f_sp
        self.L = max_leaves
        self.B = num_bins
        self.cat_words = cat_words_for(num_bins)
        self.max_depth = max_depth
        self.exact = exact
        self.split_fusion = split_fusion
        self.with_categorical = with_categorical
        self.P = min(tile_leaves or cuda_hist.structural_tile_leaves(),
                     max_leaves)
        self.hist_subtraction = hist_subtraction
        self.ladder = tuple(compaction_ladder)
        self.meta = meta.to("cpu")
        self.meta_dev = meta.to(self.dev)
        self.params = params.to("cpu")
        self.params_dev = params.to(self.dev)
        self.missing_bin_dev = missing_bin.to(self.dev).to(torch.int32)
        stats = torch.stack([grad, hess, torch.ones_like(grad)],
                            dim=1).to(torch.float32).contiguous()
        base = "cuda" if self.dev.type == "cuda" else "plain"
        hist_method = hist_method or base
        assert hist_method in (base, base + "_q8"), \
            f"histogram method {hist_method!r} on device {self.dev}"
        self.quant8 = hist_method.endswith("_q8")
        self.q_scale = None
        if self.quant8:
            self.stats, self.q_scale, self.root = self._quantize(
                stats, prng_key(0) if rng_key is None else rng_key)
        else:
            self.stats = stats
            self.root = tree_sum(stats, 0).cpu()
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
        self.max_rounds = 3 * self.L + 8

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
        return q, q_scale, root.cpu()

    # ------------------------------------------------------------- state
    def init_state(self) -> GrowState:
        L, W = self.L, self.cat_words
        root = self.root
        root_out = calculate_leaf_output(root[0], root[1], self.params,
                                         root[2], torch.tensor(0.0))

        def zf():
            return np.zeros((L,), dtype=np.float32)

        zi = np.zeros((L,), dtype=np.int32)
        best = SplitInfo(
            gain=np.full((L,), NEG_INF, np.float32), feature=zi.copy(),
            threshold=zi.copy(), default_left=np.zeros((L,), bool),
            left_sum_g=zf(), left_sum_h=zf(), left_count=zf(),
            right_sum_g=zf(), right_sum_h=zf(), right_count=zf(),
            left_output=zf(), right_output=zf(),
            is_cat=np.zeros((L,), bool),
            cat_bitset=np.zeros((L, W), np.int64))
        sums = [zf() for _ in range(4)]
        for s, v in zip(sums, (root[0], root[1], root[2], root_out)):
            s[0] = v.numpy()
        return GrowState(
            leaf_id=torch.zeros((self.n,), dtype=torch.int32, device=self.dev),
            hist=torch.zeros((L, self.f, self.B, 3), dtype=torch.float32,
                             device=self.dev),
            hist_valid=np.zeros((L,), bool), leaf_dead=np.zeros((L,), bool),
            leaf_sum_g=sums[0], leaf_sum_h=sums[1], leaf_cnt=sums[2],
            leaf_output=sums[3], leaf_depth=zi.copy(),
            sib=np.full((L,), -1, np.int32),
            parent_hist=np.zeros((L,), bool),
            best=best, tree=empty_tree(L, W).numpy())

    def active_mask(self, st: GrowState) -> np.ndarray:
        return self.iota < st.num_leaves

    def pending_mask(self, st: GrowState) -> np.ndarray:
        return self.active_mask(st) & ~st.hist_valid & ~st.leaf_dead

    def outer_cond(self, st: GrowState) -> bool:
        more = bool(self.pending_mask(st).any()) or not st.done
        return st.num_leaves < self.L and more and st.rounds < self.max_rounds

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
        pass reads)."""
        if not self.ladder or self.f_dense == 0:
            return None, float(self.n)
        p2 = sel_compute.shape[0]
        slot_map = np.full((self.L + 1,), p2, dtype=np.int32)
        ok = sel_compute >= 0
        slot_map[sel_compute[ok]] = np.nonzero(ok)[0]
        in_tile = torch.as_tensor(slot_map).to(self.dev)[
            st.leaf_id.long()] < p2
        n_pend = int(in_tile.sum())
        for m in self.ladder:             # smallest rung that fits
            if n_pend <= m:
                return compact_indices(in_tile, m), float(m)
        return None, float(self.n)

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
        la = cuda_hist.pack_leaf_aux(*aggs).to(dev)
        gather_idx, streamed = self._rung(st, np.where(derive, -1, sel))
        tile, cand = histogram_tiles_with_candidates(
            self.binsT, self.stats, st.leaf_id, torch.from_numpy(sel),
            torch.from_numpy(derive), parent_planes, la, self.fm_pack,
            self.pvec, self.B, self.L, gather_idx, q_scale=self.q_scale)

        slots = sel[ok]
        st.hist[torch.as_tensor(slots.astype(np.int64)).to(dev)] = tile[
            torch.as_tensor(np.nonzero(ok)[0]).to(dev)]
        info = candidates_to_splitinfo(
            cand.cpu(), *aggs, torch.from_numpy(st.leaf_depth[selc]),
            self.meta, self.params, torch.ones((p2, self.f), dtype=bool),
            self.max_depth, self.cat_words)
        for cur, new in zip(st.best, info):
            cur[slots] = _np(new)[ok]
        st.hist_valid[slots] = True
        st.parent_hist[slots] = False
        st.rounds += 1
        st.rows_streamed += streamed

    def combine_sparse(self, tile: torch.Tensor, sel: np.ndarray,
                       leaf_id: torch.Tensor) -> torch.Tensor:
        """Planes of the sparse columns: an O(nnz) scatter-add of the
        non-default (row, bin) stream entries, and the elided default bin
        rebuilt from per-slot totals -- the reference's most_freq elision
        + FixHistogram (sparse_bin.hpp ConstructHistogram; dataset.h:506).
        Returns the full [P, F, B, 3] tile with the dense planes at their
        column ids: float32, or in q8 mode exact int32 sums of the int8
        stats."""
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
        acc = torch.int32 if self.quant8 else torch.float32
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
            totals = eq.to(torch.float32).T @ self.stats
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
        gather_idx, streamed = self._rung(st, sel)
        if self.f_dense > 0:
            tile = histogram_tiles(self.binsT, self.stats, st.leaf_id,
                                   torch.from_numpy(sel), self.B, self.L,
                                   gather_idx)
        else:
            tile = torch.zeros((sel.shape[0], 0, self.B, 3),
                               dtype=torch.int32 if self.quant8
                               else torch.float32, device=dev)
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

    # ------------------------------------------------------- split phase
    def split_search(self, st: GrowState) -> None:
        """The classic search: every leaf's best split over the resident
        planes, numerical and categorical (find_best_splits)."""
        dev = self.dev
        aggs = [torch.from_numpy(a).to(dev) for a in
                (st.leaf_sum_g, st.leaf_sum_h, st.leaf_cnt, st.leaf_output,
                 st.leaf_depth)]
        best = find_best_splits(
            st.hist, *aggs, self.meta_dev, self.params_dev,
            torch.ones((self.f,), dtype=torch.bool, device=dev),
            self.max_depth, with_categorical=self.with_categorical,
            cat_words=self.cat_words)
        st.best = SplitInfo(*(_np(v) for v in best))
        st.rounds += 1

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
                       (t.node_cat, is_cat), (t.node_cat_bitset, bits)):
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
        st.pending_routes.append((l, new_leaf, feat, thr, dleft, is_cat,
                                  bits))
        st.num_leaves += 1
        gain_eff[l] = NEG_INF
        gain_eff[new_leaf] = NEG_INF

    def _split_column(self, feat_r: torch.Tensor, feats: set) -> torch.Tensor:
        """Each row's bin of its leaf's split feature (``feat_r`` [N], -1
        for rows of unsplit leaves): a gather from the dense columns, and
        the sparse columns among ``feats`` rebuilt from their streams (the
        analog of SparseBin::Split's stream walk)."""
        fr = feat_r.clamp(min=0)
        if self.sp is None:
            return self.binsT.gather(0, fr[None, :])[0].to(torch.int32)
        if self.f_dense > 0:
            col = self.binsT.gather(0, self.col2dense_dev[fr][None, :])[0]
            col = col.to(torch.int32)
        else:
            col = torch.zeros((self.n,), dtype=torch.int32, device=self.dev)
        _, sp_rows, sp_bins, sp_default = self.sp
        for f in sorted(feats):
            if f not in set(self.sp_cols.tolist()):
                continue
            i = int(self.col2sp[f])
            ok = sp_rows[i] < self.n
            colv = torch.full((self.n,), 0, dtype=torch.int32,
                              device=self.dev) + sp_default[i]
            colv[sp_rows[i][ok].long()] = sp_bins[i][ok].to(torch.int32)
            col = torch.where(feat_r == f, colv, col)
        return col

    def _route(self, st: GrowState) -> None:
        """Move the rows of every leaf split in this phase to its children
        in one device pass (_apply_split's routing, batched)."""
        if not st.pending_routes:
            return
        L, W = self.L, self.cat_words
        feat_t = np.full((L,), -1, dtype=np.int64)
        thr_t = np.zeros((L,), dtype=np.int32)
        dl_t = np.zeros((L,), dtype=bool)
        new_t = np.zeros((L,), dtype=np.int32)
        cat_t = np.zeros((L,), dtype=bool)
        bits_t = np.zeros((L, W), dtype=np.int64)
        for l, nl, feat, thr, dleft, is_cat, bits in st.pending_routes:
            feat_t[l], thr_t[l], dl_t[l], new_t[l] = feat, thr, dleft, nl
            cat_t[l], bits_t[l] = is_cat, bits
        feats = {r[2] for r in st.pending_routes}
        st.pending_routes = []
        dev = self.dev

        def d(a):
            return torch.as_tensor(a).to(dev)

        lid = st.leaf_id.long()
        feat_r = d(feat_t)[lid]
        split_rows = feat_r >= 0
        col = self._split_column(feat_r, feats)
        mb = self.missing_bin_dev[feat_r.clamp(min=0)]
        go_left = torch.where((col == mb) & (mb >= 0), d(dl_t)[lid],
                              col <= d(thr_t)[lid])
        if cat_t.any():
            word = d(bits_t).reshape(-1)[lid * W + (col >> 5).long()]
            cat_left = ((word >> (col & 31).long()) & 1) == 1
            go_left = torch.where(d(cat_t)[lid], cat_left, go_left)
        st.leaf_id = torch.where(split_rows & ~go_left, d(new_t)[lid],
                                 st.leaf_id)

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
        if self.split_fusion:
            # the search already ran in the tile passes' epilogues
            st.rounds += 1
        else:
            self.split_search(st)
        self.split_apply(st)

    def hist_phase(self, st: GrowState) -> None:
        if self.split_fusion:
            self.tile_pass_fused(st)
        else:
            self.tile_pass(st)

    def finalize(self, st: GrowState):
        tree = TreeArrays(*(torch.as_tensor(np.asarray(a)) for a in st.tree))
        tree = tree._replace(
            num_leaves=torch.tensor(st.num_leaves, dtype=torch.int32))
        return tree, st.leaf_id, st.rows_streamed


def grow_tree(binsT: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              meta: FeatureMeta, params: SplitParams,
              missing_bin: torch.Tensor, *, max_leaves: int, num_bins: int,
              max_depth: int = -1, exact: bool = False, tile_leaves: int = 0,
              hist_subtraction: bool = True, compaction_ladder: tuple = (),
              split_fusion: bool = True, with_categorical: bool = False,
              sp: Optional[tuple] = None, hist_method: str = "",
              rng_key: Optional[torch.Tensor] = None
              ) -> Tuple[TreeArrays, torch.Tensor, float]:
    """Grow one tree from per-row gradients/hessians. ``hist_method`` is
    ``ops/histogram.resolve_method``'s answer (empty: the f32 mode of the
    device's path); a ``*_q8`` method quantizes with ``rng_key`` (the
    JAX package's ``PRNGKey(0)`` when None). Returns (tree arrays on the
    host, per-row leaf index on the device, rows read by the histogram
    passes)."""
    g = Grower(binsT, grad, hess, meta, params, missing_bin,
               max_leaves=max_leaves, num_bins=num_bins, max_depth=max_depth,
               exact=exact, tile_leaves=tile_leaves,
               hist_subtraction=hist_subtraction,
               compaction_ladder=compaction_ladder, split_fusion=split_fusion,
               with_categorical=with_categorical, sp=sp,
               hist_method=hist_method, rng_key=rng_key)
    st = g.init_state()
    while g.outer_cond(st):
        g.dead_guard(st)
        if bool(g.pending_mask(st).any()):
            g.hist_phase(st)
        else:
            g.split_phase(st)
    return g.finalize(st)
