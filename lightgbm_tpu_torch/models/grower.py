"""Leaf-wise tree growth, serial learner, on the fused split path.

The port of lightgbm_tpu's ``models/grower.py`` (``grow_tree`` with
``split_fusion`` on): leaf membership is a per-row int32 vector, the
histogram-pending leaves are histogrammed in tiles of up to P slots per
data pass, and every pass reduces each (leaf, feature) to its best
numerical split candidate in the same pass (``ops/histogram.py
histogram_tiles_with_candidates``: the Hopper kernels on CUDA, their plain
versions on the CPU). Growth runs in ROUNDS:

  a TILE PASS (``tile_pass_fused``) while any leaf is pending: sibling
  pairs share the pass on adjacent slots -- the smaller child computed at
  the even slot, the larger derived at the odd slot as parent - smaller
  (the reference's subtraction trick); with the compaction ladder the pass
  reads only the tile's rows through the gather form when they fit the
  smallest rung that holds them; or

  a SPLIT PHASE (``split_apply``) when nothing is pending: every leaf's
  best split, in gain order, until the leaf budget is spent (one split per
  phase in ``exact`` mode).

The JAX package runs this as one ``lax.while_loop`` with ``lax.cond``
branches. Here the loop and its branches are host Python: the per-leaf
state (sums, outputs, depths, the best splits and the tree arrays, all
O(num_leaves)) lives on the host as CPU tensors, and only the O(N) and
plane-sized state (the leaf ids, the gradient stats, the resident
``[L, F, B, 3]`` histograms) lives on the device. The host waits for the
device at one point per frontier level: the tile pass's pending-row count
(the ladder's rung choice) and, after the kernels, the copy of the small
``[P, F, 12]`` candidate table that the stop test and the split phase read
on the host. A split phase routes all of its splits' rows in one device pass
at its end (a phase splits each leaf at most once, so the order of the
routings does not matter).

Equivalence to the reference's leaf-wise order, the dead-leaf guard
(BeforeFindBestSplit) and the tie rules are the JAX package's; trees are
bitwise equal to its ``grow_tree`` on the same inputs where the
histograms are (the CPU plain path is).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from ..ops import cuda_hist
from ..ops.histogram import compact_indices, histogram_tiles_with_candidates
from ..ops.split import (FeatureMeta, SplitInfo, SplitParams,
                         calculate_leaf_output, candidates_to_splitinfo)
from ..utils.ordered import tree_sum
from .tree import TreeArrays, empty_tree

NEG_INF = float("-inf")


@dataclass
class GrowState:
    """One tree's growth state: device tensors (``leaf_id``, ``hist``) and
    host CPU tensors for everything per-leaf."""
    leaf_id: torch.Tensor        # [N] int32, device
    hist: torch.Tensor           # [L, F, B, 3] f32, device
    hist_valid: torch.Tensor     # [L] bool
    leaf_dead: torch.Tensor      # [L] bool (guard-failed)
    leaf_sum_g: torch.Tensor     # [L] f32
    leaf_sum_h: torch.Tensor
    leaf_cnt: torch.Tensor
    leaf_output: torch.Tensor
    leaf_depth: torch.Tensor     # [L] int32
    sib: torch.Tensor            # [L] int32 sibling slot (-1 = none)
    parent_hist: torch.Tensor    # [L] bool: slot holds the PARENT's planes
    best: SplitInfo              # [L] per-leaf best split
    tree: TreeArrays
    num_leaves: int = 1
    rounds: int = 0
    done: bool = False
    rows_streamed: float = 0.0
    # the current split phase's splits: (leaf, new_leaf, feature,
    # threshold_bin, default_left), routed together at the phase's end
    pending_routes: List[tuple] = field(default_factory=list)


class Grower:
    """The static configuration and data of one tree's growth (the JAX
    ``_grower_fns`` closure)."""

    def __init__(self, binsT: torch.Tensor, grad: torch.Tensor,
                 hess: torch.Tensor, meta: FeatureMeta, params: SplitParams,
                 missing_bin: torch.Tensor, *, max_leaves: int, num_bins: int,
                 max_depth: int = -1, exact: bool = False,
                 tile_leaves: int = 0, hist_subtraction: bool = True,
                 compaction_ladder: tuple = ()):
        assert tuple(sorted(compaction_ladder)) == tuple(compaction_ladder), \
            "compaction_ladder must be ascending"
        self.binsT = binsT
        self.dev = binsT.device
        self.f, self.n = binsT.shape
        self.L = max_leaves
        self.B = num_bins
        self.max_depth = max_depth
        self.exact = exact
        self.P = min(tile_leaves or cuda_hist.structural_tile_leaves(),
                     max_leaves)
        self.hist_subtraction = hist_subtraction
        self.ladder = tuple(compaction_ladder)
        self.meta = meta.to("cpu")
        self.params = params.to("cpu")
        self.missing_bin_dev = missing_bin.to(self.dev)
        self.missing_bin = missing_bin.to("cpu")
        self.stats = torch.stack([grad, hess, torch.ones_like(grad)],
                                 dim=1).to(torch.float32).contiguous()
        self.iota = torch.arange(self.L, dtype=torch.int32)
        self.fm_pack = cuda_hist.pack_feature_meta(
            meta.num_bins, meta.missing_type, meta.default_bin,
            meta.monotone).to(self.dev)
        self.pvec = cuda_hist.pack_scan_params(params).to(self.dev)
        self.max_rounds = 3 * self.L + 8

    # ------------------------------------------------------------- state
    def init_state(self) -> GrowState:
        L = self.L
        root = tree_sum(self.stats, 0).cpu()
        root_out = calculate_leaf_output(root[0], root[1], self.params,
                                         root[2], torch.tensor(0.0))

        def zf():
            return torch.zeros((L,), dtype=torch.float32)

        zi = torch.zeros((L,), dtype=torch.int32)
        best = SplitInfo(
            gain=torch.full((L,), NEG_INF), feature=zi.clone(),
            threshold=zi.clone(), default_left=torch.zeros((L,), dtype=bool),
            left_sum_g=zf(), left_sum_h=zf(), left_count=zf(),
            right_sum_g=zf(), right_sum_h=zf(), right_count=zf(),
            left_output=zf(), right_output=zf())
        sums = [zf() for _ in range(4)]
        for s, v in zip(sums, (root[0], root[1], root[2], root_out)):
            s[0] = v
        return GrowState(
            leaf_id=torch.zeros((self.n,), dtype=torch.int32, device=self.dev),
            hist=torch.zeros((L, self.f, self.B, 3), dtype=torch.float32,
                             device=self.dev),
            hist_valid=torch.zeros((L,), dtype=bool),
            leaf_dead=torch.zeros((L,), dtype=bool),
            leaf_sum_g=sums[0], leaf_sum_h=sums[1], leaf_cnt=sums[2],
            leaf_output=sums[3], leaf_depth=torch.zeros((L,), dtype=torch.int32),
            sib=torch.full((L,), -1, dtype=torch.int32),
            parent_hist=torch.zeros((L,), dtype=bool),
            best=best, tree=empty_tree(L))

    def active_mask(self, st: GrowState) -> torch.Tensor:
        return self.iota < st.num_leaves

    def pending_mask(self, st: GrowState) -> torch.Tensor:
        return self.active_mask(st) & ~st.hist_valid & ~st.leaf_dead

    def outer_cond(self, st: GrowState) -> bool:
        more = bool(self.pending_mask(st).any()) or not st.done
        return st.num_leaves < self.L and more and st.rounds < self.max_rounds

    def dead_guard(self, st: GrowState) -> None:
        """BeforeFindBestSplit guards (serial_tree_learner.cpp:282-322)."""
        p = self.params
        guard = ((st.leaf_cnt >= 2.0 * p.min_data_in_leaf)
                 & (st.leaf_sum_h >= 2.0 * p.min_sum_hessian_in_leaf))
        newly = self.active_mask(st) & ~st.hist_valid & ~st.leaf_dead & ~guard
        st.leaf_dead = st.leaf_dead | newly

    # -------------------------------------------------------- tile pass
    def _select(self, st: GrowState):
        """The tile's slots: (sel [P2] int32, derive [P2] bool, p_slot)."""
        L, P = self.L, self.P
        iota = self.iota
        pending = self.pending_mask(st)
        sibc = st.sib.clamp(min=0).long()
        has_sib = st.sib >= 0
        p_slot = torch.minimum(iota, sibc.to(torch.int32)).long()
        sib_pending = pending[sibc] & has_sib
        if self.hist_subtraction:
            derivable = pending & sib_pending & st.parent_hist[p_slot]
            cnt_sib = st.leaf_cnt[sibc]
            is_smaller = ((st.leaf_cnt < cnt_sib)
                          | ((st.leaf_cnt == cnt_sib) & (iota < sibc)))
            cand = pending & (~derivable | is_smaller)
            npairs = max(P // 2, 1)
            order = torch.argsort(torch.where(cand, iota, L + iota))
            chosen = order[:npairs].to(torch.int32)
            chosen_ok = cand[chosen.long()]
            sel_even = torch.where(chosen_ok, chosen, -1)
            partner = sibc[chosen.long()].to(torch.int32)
            partner_ok = chosen_ok & derivable[chosen.long()]
            sel_odd = torch.where(partner_ok, partner, -1)
            sel = torch.stack([sel_even, sel_odd], 1).reshape(-1)
            derive = torch.stack([torch.zeros_like(partner_ok), partner_ok],
                                 1).reshape(-1)
        else:
            order = torch.argsort(torch.where(pending, iota, L + iota))
            chosen = order[:P].to(torch.int32)
            chosen_ok = pending[chosen.long()]
            sel = torch.where(chosen_ok, chosen, -1)
            derive = torch.zeros((P,), dtype=bool)
        return sel, derive, p_slot

    def tile_pass_fused(self, st: GrowState) -> None:
        """One frontier pass: planes + candidates for a tile of pending
        leaves, with the larger sibling of each pair derived in-pass."""
        L = self.L
        sel, derive, p_slot = self._select(st)
        p2 = sel.shape[0]
        selc = sel.clamp(min=0).long()
        ok = sel >= 0

        dev = self.dev
        sel_d, derive_d = sel.to(dev), derive.to(dev)
        pp = p_slot[selc].to(dev)
        parent_planes = torch.where(derive_d[:, None, None, None],
                                    st.hist[pp], 0.0).contiguous()
        la = cuda_hist.pack_leaf_aux(
            st.leaf_sum_g[selc], st.leaf_sum_h[selc], st.leaf_cnt[selc],
            st.leaf_output[selc]).to(dev)

        gather_idx, streamed = None, float(self.n)
        if self.ladder:
            sel_compute = torch.where(derive_d, -1, sel_d)
            slot_map = torch.full((L + 1,), p2, dtype=torch.int32, device=dev)
            slot_map[torch.where(sel_compute >= 0, sel_compute, L).long()] = \
                torch.arange(p2, dtype=torch.int32, device=dev)
            in_tile = slot_map[st.leaf_id.long()] < p2
            n_pend = int(in_tile.sum())
            for m in self.ladder:             # smallest rung that fits
                if n_pend <= m:
                    gather_idx = compact_indices(in_tile, m)
                    streamed = float(m)
                    break
        tile, cand = histogram_tiles_with_candidates(
            self.binsT, self.stats, st.leaf_id, sel_d, derive_d,
            parent_planes, la, self.fm_pack, self.pvec, self.B, L,
            gather_idx)

        # slot indices from the host copy of sel: no device sync
        st.hist[sel[ok].long().to(dev)] = tile[
            torch.nonzero(ok).reshape(-1).to(dev)]
        resolved = torch.zeros((L,), dtype=bool)
        resolved[sel[ok].long()] = True

        cand = cand.cpu()
        fmask = torch.ones((p2, self.f), dtype=bool)
        info = candidates_to_splitinfo(
            cand, st.leaf_sum_g[selc], st.leaf_sum_h[selc],
            st.leaf_cnt[selc], st.leaf_output[selc], st.leaf_depth[selc],
            self.meta, self.params, fmask, self.max_depth)
        slots = sel[ok].long()
        st.best = SplitInfo(*(cur.index_put((slots,), new[ok].to(cur.dtype))
                              for cur, new in zip(st.best, info)))
        st.hist_valid = st.hist_valid | resolved
        st.parent_hist = st.parent_hist & ~resolved
        st.rounds += 1
        st.rows_streamed += streamed

    # ------------------------------------------------------- split phase
    def _apply_split(self, st: GrowState, gain_eff: torch.Tensor) -> None:
        """Split the best leaf (SerialTreeLearner::Split + Tree::Split):
        the tree arrays and per-leaf state now, in place (the host state is
        this tree's alone), the row routing at the end of the phase."""
        l = int(torch.argmax(gain_eff))
        best, t = st.best, st.tree
        new_leaf = st.num_leaves
        node = st.num_leaves - 1
        feat = int(best.feature[l])
        thr = int(best.threshold[l])
        dleft = bool(best.default_left[l])

        parent = int(t.leaf_parent[l])
        if parent >= 0:
            if int(t.node_left[parent]) == ~l:
                t.node_left[parent] = node
            if int(t.node_right[parent]) == ~l:
                t.node_right[parent] = node
        # the node takes the parent leaf's aggregates before they change
        for arr, v in ((t.node_left, ~l), (t.node_right, ~new_leaf),
                       (t.node_feature, feat), (t.node_threshold_bin, thr),
                       (t.node_default_left, dleft),
                       (t.node_gain, best.gain[l]),
                       (t.node_value, st.leaf_output[l]),
                       (t.node_weight, st.leaf_sum_h[l]),
                       (t.node_count, st.leaf_cnt[l])):
            arr[node] = v
        depth = int(st.leaf_depth[l]) + 1
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
        st.tree = t._replace(
            num_leaves=torch.tensor(st.num_leaves + 1, dtype=torch.int32))
        st.pending_routes.append((l, new_leaf, feat, thr, dleft))
        st.num_leaves += 1
        gain_eff[l] = NEG_INF
        gain_eff[new_leaf] = NEG_INF

    def _route(self, st: GrowState) -> None:
        """Move the rows of every leaf split in this phase to its children
        in one device pass (_apply_split's routing, batched)."""
        if not st.pending_routes:
            return
        L = self.L
        feat_t = torch.full((L,), -1, dtype=torch.int64)
        thr_t = torch.zeros((L,), dtype=torch.int32)
        dl_t = torch.zeros((L,), dtype=bool)
        new_t = torch.zeros((L,), dtype=torch.int32)
        for l, nl, feat, thr, dleft in st.pending_routes:
            feat_t[l], thr_t[l], dl_t[l], new_t[l] = feat, thr, dleft, nl
        st.pending_routes = []
        dev = self.dev
        lid = st.leaf_id.long()
        feat_r = feat_t.to(dev)[lid]
        split_rows = feat_r >= 0
        col = self.binsT.gather(0, feat_r.clamp(min=0)[None, :])[0].to(
            torch.int32)
        mb = self.missing_bin_dev.to(torch.int32)[feat_r.clamp(min=0)]
        go_left = torch.where((col == mb) & (mb >= 0), dl_t.to(dev)[lid],
                              col <= thr_t.to(dev)[lid])
        st.leaf_id = torch.where(split_rows & ~go_left, new_t.to(dev)[lid],
                                 st.leaf_id)

    def split_apply(self, st: GrowState) -> None:
        """Apply every available split from st.best in gain order (one in
        ``exact`` mode), then route the rows."""
        before = st.num_leaves
        gain_eff = torch.where(self.active_mask(st) & st.hist_valid
                               & ~st.leaf_dead, st.best.gain,
                               torch.tensor(NEG_INF))
        while st.num_leaves < self.L and float(gain_eff.max()) > 0.0:
            self._apply_split(st, gain_eff)
            if self.exact:
                break
        self._route(st)
        st.done = st.num_leaves == before

    def split_phase(self, st: GrowState) -> None:
        # the search already ran in the tile passes' epilogues
        st.rounds += 1
        self.split_apply(st)

    def finalize(self, st: GrowState):
        return st.tree, st.leaf_id, st.rows_streamed


def grow_tree(binsT: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              meta: FeatureMeta, params: SplitParams,
              missing_bin: torch.Tensor, *, max_leaves: int, num_bins: int,
              max_depth: int = -1, exact: bool = False, tile_leaves: int = 0,
              hist_subtraction: bool = True, compaction_ladder: tuple = ()
              ) -> Tuple[TreeArrays, torch.Tensor, float]:
    """Grow one tree from per-row gradients/hessians. Returns (tree arrays
    on the host, per-row leaf index on the device, rows read by the
    histogram passes)."""
    g = Grower(binsT, grad, hess, meta, params, missing_bin,
               max_leaves=max_leaves, num_bins=num_bins, max_depth=max_depth,
               exact=exact, tile_leaves=tile_leaves,
               hist_subtraction=hist_subtraction,
               compaction_ladder=compaction_ladder)
    st = g.init_state()
    while g.outer_cond(st):
        g.dead_guard(st)
        if bool(g.pending_mask(st).any()):
            g.tile_pass_fused(st)
        else:
            g.split_phase(st)
    return g.finalize(st)
