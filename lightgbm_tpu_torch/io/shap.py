"""TreeSHAP feature contributions (pred_contrib).

Implements the polynomial-time TreeSHAP algorithm (Lundberg et al.) that the
reference exposes as ``Tree::PredictContrib`` / ``PredictContribByMap``
(reference: include/LightGBM/tree.h:139-141, src/io/tree.cpp TreeSHAP
implementation; surfaced via predict(..., pred_contrib=True),
c_api.h:802). Output layout matches the reference: per class, one column per
feature plus a final bias column holding the tree-ensemble expected value
(tests/python_package_test/test_engine.py:1011-1117 contract: contribs sum
to the raw prediction).

The port of lightgbm_tpu's ``io/shap.py``. Two implementations:

- ``predict_contrib_trees`` (default): a batched leaf-path decomposition.
  Each leaf's root path is reduced on the host to its unique features with
  merged zero-fractions (the on-the-fly merge the recursive algorithm does
  when it re-encounters a feature); rows then enter the computation only
  through binary one-fractions (the trees' own per-node decisions, taken
  on the host in numpy), so the extend/unwind DP runs over stacked
  ``[leaves, depth]`` arrays with the row axis vectorized, in torch
  float64 on the model's device (the H100 has float64; the JAX package
  runs this DP on its CPU backend only because TPUs lack it). The unwind
  is one batched product against host-precomputed coefficients
  (``torch.einsum``, a plain product outside any kernel, as the JAX
  package leaves it to XLA).
- ``predict_contrib_trees_reference``: the per-row explicit-stack walk in
  numpy, the parity oracle, and the path ``LIGHTGBM_TPU_SHAP=reference``
  selects. ``LIGHTGBM_TPU_SHAP_DTYPE=float32`` runs the DP in float32.
"""

from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch


def _tree_decisions(tree, X: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Fill ``out[node] = go_left`` for every internal node of one tree,
    vectorized over rows via the tree's own ``_go_left`` (the single
    source of numerical/categorical/missing decision semantics for both
    the oracle and the batched SHAP paths)."""
    nodes_arr = np.empty(X.shape[0], dtype=np.int64)
    for node in range(tree.num_leaves - 1):
        nodes_arr.fill(node)
        out[node] = tree._go_left(nodes_arr,
                                  X[:, int(tree.split_feature[node])])
    return out


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, feature_index=-1, zero_fraction=0.0, one_fraction=0.0,
                 pweight=0.0):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight

    def copy(self):
        return _PathElement(self.feature_index, self.zero_fraction,
                            self.one_fraction, self.pweight)


def _extend_path(path: List[_PathElement], unique_depth: int,
                 zero_fraction: float, one_fraction: float,
                 feature_index: int) -> None:
    path[unique_depth].feature_index = feature_index
    path[unique_depth].zero_fraction = zero_fraction
    path[unique_depth].one_fraction = one_fraction
    path[unique_depth].pweight = 1.0 if unique_depth == 0 else 0.0
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += (one_fraction * path[i].pweight * (i + 1)
                                / (unique_depth + 1))
        path[i].pweight = (zero_fraction * path[i].pweight
                           * (unique_depth - i) / (unique_depth + 1))


def _unwind_path(path: List[_PathElement], unique_depth: int,
                 path_index: int) -> None:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0.0:
            tmp = path[i].pweight
            path[i].pweight = (next_one_portion * (unique_depth + 1)
                               / ((i + 1) * one_fraction))
            next_one_portion = tmp - (path[i].pweight * zero_fraction
                                      * (unique_depth - i) / (unique_depth + 1))
        else:
            path[i].pweight = (path[i].pweight * (unique_depth + 1)
                               / (zero_fraction * (unique_depth - i)))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction


def _unwound_path_sum(path: List[_PathElement], unique_depth: int,
                      path_index: int) -> float:
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0.0:
            tmp = (next_one_portion * (unique_depth + 1)
                   / ((i + 1) * one_fraction))
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * (
                (unique_depth - i) / (unique_depth + 1))
        else:
            total += (path[i].pweight / zero_fraction
                      / ((unique_depth - i) / (unique_depth + 1)))
    return total


def tree_shap_values_batch(tree, X: np.ndarray,
                           num_features: int) -> np.ndarray:
    """TreeSHAP contributions of one tree for ALL rows: [N, num_features+1]
    (last column = expected value).

    Iterative (explicit stack, no Python recursion — a 255-leaf leaf-wise
    chain would otherwise flirt with the recursion limit) with the per-node
    routing decisions precomputed VECTORIZED across rows, so the per-row
    walk does no numpy work beyond float accumulation."""
    n = X.shape[0]
    out = np.zeros((n, num_features + 1), np.float64)
    out[:, -1] = tree_expected_value(tree)
    if tree.num_leaves <= 1 or n == 0:
        return out
    n_nodes = tree.num_leaves - 1
    # row-batched decisions: one vectorized _go_left per node
    dec = _tree_decisions(tree, X, np.zeros((n_nodes, n), bool))
    sf = [int(s) for s in tree.split_feature]
    lc = [int(c) for c in tree.left_child]
    rc = [int(c) for c in tree.right_child]
    icount = [float(c) for c in tree.internal_count]
    lcount = [float(c) for c in tree.leaf_count]
    lvalue = [float(v) for v in tree.leaf_value]

    for r in range(n):
        phi = out[r]
        stack = [(0, 0, [], 1.0, 1.0, -1)]
        while stack:
            node, ud, parent_path, pzf, pof, pfi = stack.pop()
            path = [p.copy() for p in parent_path[:ud]]
            path.extend(_PathElement() for _ in range(2))
            _extend_path(path, ud, pzf, pof, pfi)

            if node < 0:   # leaf
                lv = lvalue[~node]
                for i in range(1, ud + 1):
                    w = _unwound_path_sum(path, ud, i)
                    el = path[i]
                    phi[el.feature_index] += (
                        w * (el.one_fraction - el.zero_fraction) * lv)
                continue

            feat = sf[node]
            left, right = lc[node], rc[node]
            hot, cold = (left, right) if dec[node, r] else (right, left)
            node_count = icount[node]

            def child_count(c):
                return lcount[~c] if c < 0 else icount[c]

            hot_zero = child_count(hot) / node_count if node_count > 0 else 0.0
            cold_zero = child_count(cold) / node_count if node_count > 0 else 0.0
            izf = iof = 1.0

            # if this feature was seen before on the path, undo that split
            pi = 0
            while pi <= ud and path[pi].feature_index != feat:
                pi += 1
            if pi != ud + 1:
                izf = path[pi].zero_fraction
                iof = path[pi].one_fraction
                _unwind_path(path, ud, pi)
                ud -= 1

            stack.append((hot, ud + 1, path, hot_zero * izf, iof, feat))
            stack.append((cold, ud + 1, path, cold_zero * izf, 0.0, feat))
    return out


def tree_expected_value(tree) -> float:
    """Count-weighted mean leaf output (reference: Tree::ExpectedValue)."""
    if tree.num_leaves == 1:
        return float(tree.leaf_value[0])
    counts = np.asarray(tree.leaf_count[:tree.num_leaves], np.float64)
    total = counts.sum()
    if total <= 0:
        return 0.0
    return float((counts * np.asarray(
        tree.leaf_value[:tree.num_leaves], np.float64)).sum() / total)


def tree_shap_values(tree, x: np.ndarray, num_features: int) -> np.ndarray:
    """SHAP contributions of one tree for one row: [num_features + 1]
    (last = expected value)."""
    return tree_shap_values_batch(tree, x.reshape(1, -1), num_features)[0]


def predict_contrib_trees_reference(trees, X: np.ndarray, num_features: int,
                                    num_tree_per_iteration: int = 1,
                                    average: bool = False) -> np.ndarray:
    """SHAP contributions over an ensemble, per-row oracle path.

    Returns [N, (num_features + 1) * k] with per-class blocks
    (reference: gbdt.cpp PredictContrib layout)."""
    n = X.shape[0]
    k = max(num_tree_per_iteration, 1)
    width = num_features + 1
    out = np.zeros((n, width * k), np.float64)
    # row chunks bound the per-tree [n_nodes, rows] decision matrix
    # (255-leaf trees at 10M rows would otherwise allocate ~2.5 GB per tree)
    chunk = 65536
    for r0 in range(0, n, chunk):
        Xc = X[r0:r0 + chunk]
        for ti, tree in enumerate(trees):
            c = ti % k
            out[r0:r0 + chunk, c * width:(c + 1) * width] += \
                tree_shap_values_batch(tree, Xc, num_features)
    if average and trees:
        out /= (len(trees) // k)
    return out


# ---------------------------------------------------------------------------
# Batched leaf-path TreeSHAP
# ---------------------------------------------------------------------------
def _leaf_paths(tree):
    """Per-leaf unique-feature path elements of one ModelTree/HostTree.

    Walks every root->leaf path and merges repeated features exactly like
    the recursive algorithm's unwind-and-re-extend (tree.cpp TreeSHAP: a
    re-encountered feature multiplies its zero/one fractions instead of
    adding a path element). Returns, per leaf:
      feats:  unique feature ids in first-encounter order
      zs:     merged zero fractions (product of child_count/node_count)
      splits: per element, list of (node, went_left) whose conjunction is
              the element's binary one-fraction for a row
    """
    n_nodes = tree.num_leaves - 1
    icount = tree.internal_count
    lcount = tree.leaf_count
    sf = tree.split_feature
    out = [None] * tree.num_leaves
    if n_nodes == 0:
        out[0] = ([], [], [])
        return out
    # DFS with explicit stack: (node, path list of (node_idx, went_left))
    stack = [(0, [])]
    while stack:
        node, path = stack.pop()
        if node < 0:
            leaf = ~node
            feats, zs, splits = [], [], []
            pos = {}
            for nd, went_left in path:
                f = int(sf[nd])
                child = tree.left_child[nd] if went_left else tree.right_child[nd]
                ccount = (float(lcount[~child]) if child < 0
                          else float(icount[child]))
                ncount = float(icount[nd])
                zfrac = ccount / ncount if ncount > 0 else 0.0
                if f in pos:
                    p = pos[f]
                    zs[p] *= zfrac
                    splits[p].append((nd, went_left))
                else:
                    pos[f] = len(feats)
                    feats.append(f)
                    zs.append(zfrac)
                    splits.append([(nd, went_left)])
            out[leaf] = (feats, zs, splits)
            continue
        stack.append((int(tree.left_child[node]), path + [(node, True)]))
        stack.append((int(tree.right_child[node]), path + [(node, False)]))
    return out


class _DepthBucket:
    """One stacked leaf group: every (tree, leaf) pair of a class whose
    unique-path length fits ``Db``. Flat leaf axis P (padded to a multiple
    of 64) — no per-tree leaf padding, no shared Dmax, so each leaf only
    pays its own depth class in the O(P * Db^2 * rows) DP."""

    __slots__ = ("Db", "P", "z", "leafD", "leaf_value", "elem_feat",
                 "split_elem", "split_node", "split_dir", "rho")

    def __init__(self, entries, Db: int, num_features: int):
        # entries: list of (leaf_value, feats, zs, splits-with-global-nodes)
        self.Db = Db
        P = -(-len(entries) // 64) * 64
        self.P = P
        self.z = np.ones((P, Db), np.float64)
        self.leafD = np.zeros((P,), np.int32)
        self.leaf_value = np.zeros((P,), np.float64)
        # padded elements scatter into a dump column (index num_features)
        self.elem_feat = np.full((P, Db), num_features, np.int32)
        split_elem, split_node, split_dir = [], [], []
        for p, (lv, feats, zs, splits) in enumerate(entries):
            self.leafD[p] = len(feats)
            self.leaf_value[p] = lv
            for d, (f, zv, sp) in enumerate(zip(feats, zs, splits)):
                self.z[p, d] = zv
                self.elem_feat[p, d] = f
                for gnode, went_left in sp:
                    split_elem.append(p * Db + d)
                    split_node.append(gnode)
                    split_dir.append(went_left)
        order = np.argsort(np.asarray(split_elem, np.int64), kind="stable")
        self.split_elem = np.asarray(split_elem, np.int32)[order]
        self.split_node = np.asarray(split_node, np.int32)[order]
        self.split_dir = np.asarray(split_dir, bool)[order]
        self.rho = self._unwind_coefficients()

    def _unwind_coefficients(self) -> np.ndarray:
        """[P, Db+1, Db+1] row-independent unwind coefficients.

        The unwound path SUM is linear in the extend DP vector m:
        ``w_j = sum_k rho[p, j, k] * m[k]``. Row j < Db holds the
        one_fraction=1 coefficients of element j (the _unwound_path_sum
        recursion run on unit vectors, vectorized over leaves); row Db
        holds the one_fraction=0 sum ``S0 = sum_k m[k]*(D+1)/(D-k)``
        (whose 1/z_j factor cancels against the (0 - z_j) multiplier, so
        every unmatched element contributes exactly -leaf_value * S0).
        This turns the per-(row, element) unwind into one batched matmul.
        """
        P, Db = self.P, self.Db
        K = Db + 1
        D = self.leafD.astype(np.float64)[:, None]      # [P, 1]
        Dp1 = D + 1.0
        kidx = np.arange(K)[None, :]                    # [1, K]
        rho = np.zeros((P, K, K), np.float64)
        # the recursion applied to the identity (all basis vectors at once)
        for j in range(Db):
            zj = self.z[:, j][:, None]
            npo = (self.leafD[:, None] == kidx).astype(np.float64)
            total = np.zeros((P, K))
            for i in range(Db - 1, -1, -1):
                act = (i < self.leafD)[:, None]
                tmp = np.where(act, npo * Dp1 / (i + 1.0), 0.0)
                total += tmp
                mi = (kidx == i).astype(np.float64)
                npo = np.where(act, mi - tmp * zj * (D - i) / Dp1, npo)
            rho[:, j, :] = total
        rho[:, Db, :] = np.where(kidx < self.leafD[:, None],
                                 Dp1 / np.maximum(D - kidx, 1e-300), 0.0)
        return rho


# bucket ceilings: leaves grouped by the smallest ceiling >= their D
_DEPTH_BUCKETS = (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _bucket_ceiling(D: int) -> int:
    """Smallest bucket ceiling >= D (beyond the table: next multiple of
    64, so arbitrarily deep paths never crash the fast path)."""
    return next((b for b in _DEPTH_BUCKETS if b >= D), -(-D // 64) * 64)


class _ClassStack:
    """Host precompute for one class: global node table + depth buckets."""

    def __init__(self, trees, num_features: int):
        self.trees = trees
        self.num_features = num_features
        self.node_offset = np.zeros(len(trees) + 1, np.int64)
        for t, tree in enumerate(trees):
            self.node_offset[t + 1] = self.node_offset[t] + max(
                tree.num_leaves - 1, 0)
        self.total_nodes = int(self.node_offset[-1])
        by_depth: dict = {}
        for t, tree in enumerate(trees):
            off = int(self.node_offset[t])
            for leaf, (feats, zs, splits) in enumerate(_leaf_paths(tree)):
                D = len(feats)
                if D == 0:
                    continue
                Db = _bucket_ceiling(D)
                gsplits = [[(off + nd, wl) for nd, wl in sp]
                           for sp in splits]
                by_depth.setdefault(Db, []).append(
                    (float(tree.leaf_value[leaf]), feats, zs, gsplits))
        self.buckets = [
            _DepthBucket(entries, Db, num_features)
            for Db, entries in sorted(by_depth.items())]
        self.expected = sum(tree_expected_value(t) for t in trees)

    def decisions(self, X: np.ndarray) -> np.ndarray:
        """[total_nodes, N] uint8 go-left decisions via the trees' own
        _go_left (handles numerical/categorical/missing semantics),
        computed once over all rows."""
        dec = np.zeros((max(self.total_nodes, 1), X.shape[0]), np.uint8)
        for t, tree in enumerate(self.trees):
            off = int(self.node_offset[t])
            _tree_decisions(tree, X, dec[off:off + tree.num_leaves - 1])
        return dec


def _shap_bucket(dec, z, leafD, leaf_value, onehot, split_elem,
                 split_node, split_dir, rho, nf: int, Db: int):
    """The DP of one depth bucket over the row block ``dec`` [nodes, C]
    (uint8 go-left decisions), on the device of its operands: [C, nf].
    Deterministic on the card: no floating-point atomics.

    Extend runs as an unrolled loop with a growing lane axis (after i
    pushes only lanes 0..i are nonzero), and the whole per-element unwind is
    one batched product against the host-precomputed ``rho`` coefficients
    (see ``_DepthBucket._unwind_coefficients``)."""
    P = z.shape[0]
    C = dec.shape[1]
    dt = z.dtype
    dev = z.device
    # binary one-fractions: the AND of each element's split decisions (an
    # element with no split -- padding -- reads as matched, as the JAX
    # segment_min's identity does; the masks below drop it)
    miss = (dec[split_node] != split_dir[:, None]).to(torch.int32)
    bad = torch.zeros((P * Db, C), dtype=torch.int32, device=dev)
    bad.index_add_(0, split_elem, miss)
    o = (bad == 0).reshape(P, Db, C)

    # extend: m[k] = pweights after pushing all D elements (transcribes
    # _extend_path with the root sentinel at lane 0)
    m = torch.ones((P, 1, C), dtype=dt, device=dev)
    for d in range(Db):
        i = d + 1
        lanes = torch.arange(d + 2, dtype=dt, device=dev)
        a = (i - lanes) / (i + 1.0)
        b = lanes / (i + 1.0)
        mpad = torch.nn.functional.pad(m, (0, 0, 0, 1))
        shifted = torch.nn.functional.pad(m, (0, 0, 1, 0))
        za = z[:, d][:, None] * a[None, :]
        new = (za[:, :, None] * mpad
               + o[:, d, :][:, None, :] * (b[None, :, None] * shifted))
        act = (d < leafD)[:, None, None]
        m = torch.where(act, new, mpad)

    # unwind: one batched product against the rho coefficients
    W = torch.einsum("pjk,pkc->pjc", rho, m)
    W1 = W[:, :Db, :]
    S0 = W[:, Db, :]
    # matched elements: w_j * (1 - z_j) * v; unmatched: -v * S0 (z cancels)
    c1 = (1.0 - z) * leaf_value[:, None]
    contrib = torch.where(o, c1[:, :, None] * W1,
                          (-leaf_value)[:, None, None] * S0[:, None, :])
    maskj = (torch.arange(Db, device=dev)[None, :] < leafD[:, None])[..., None]
    contrib = torch.where(maskj, contrib, torch.zeros_like(contrib))
    # each element's contribution to its feature: a product with the
    # bucket's [nf, P * Db] one-hot (a fixed summation order, where a
    # scatter-add on the card would add in atomics' order; padding
    # elements have no row)
    return (onehot @ contrib.reshape(-1, C)).T


# byte budget for one [total_nodes, rows] uint8 decision block (the row
# block shrinks as the ensemble's node count grows)
_DEC_BLOCK_BYTES = 512 * 1024 * 1024
_DEC_ROW_BLOCK_MAX = 65536


def _dec_row_block(total_nodes: int) -> int:
    return max(1024, min(_DEC_ROW_BLOCK_MAX,
                         _DEC_BLOCK_BYTES // max(total_nodes, 1)))


def _class_stack_cached(cls_trees, num_features: int) -> "_ClassStack":
    """Cache the stack on the first tree object, so repeated pred_contrib
    calls with the same tree list skip the leaf-path walk and rho build,
    and the precompute's lifetime is tied to the trees."""
    tree0 = cls_trees[0]
    hit = getattr(tree0, "_shap_stack", None)
    if (hit is not None and hit.num_features == num_features
            and len(hit.trees) == len(cls_trees)
            and all(a is b for a, b in zip(hit.trees, cls_trees))):
        return hit
    stack = _ClassStack(cls_trees, num_features)
    try:
        tree0._shap_stack = stack
    except AttributeError:
        pass            # slotted/frozen tree types just skip the cache
    return stack


def _device_consts(stack: "_ClassStack", dt, device) -> list:
    """The buckets' operands on ``device`` in the DP's dtype, kept on the
    stack per (dtype, device) so repeat calls skip the copies."""
    key = (dt, str(device))
    hit = getattr(stack, "_device_consts", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    consts = []
    for b in stack.buckets:
        def put(v, dtype):
            return torch.as_tensor(v).to(device=device, dtype=dtype)
        flat = b.elem_feat.reshape(-1)
        onehot = np.zeros((stack.num_features, flat.size), np.float64)
        real = flat < stack.num_features
        onehot[flat[real], np.flatnonzero(real)] = 1.0
        consts.append((put(b.z, dt), put(b.leafD, torch.int64),
                       put(b.leaf_value, dt), put(onehot, dt),
                       put(b.split_elem, torch.int64),
                       put(b.split_node, torch.int64),
                       put(b.split_dir, torch.uint8), put(b.rho, dt)))
    stack._device_consts = (key, consts)
    return consts


# seconds of the last ``predict_contrib_trees_fast`` call: the host's
# per-node decisions, and the DP (its device work ends in each row block's
# fetch)
last_split = {"decisions_s": 0.0, "dp_s": 0.0}


def predict_contrib_trees_fast(trees, X: np.ndarray, num_features: int,
                               num_tree_per_iteration: int = 1,
                               average: bool = False,
                               device="cpu") -> np.ndarray:
    """Batched TreeSHAP over the ensemble (see the module docstring): the
    decisions on the host, the DP in float64 on ``device``
    (``LIGHTGBM_TPU_SHAP_DTYPE=float32``: float32, ~1e-6 relative
    contribution error)."""
    dt = (torch.float32 if os.environ.get("LIGHTGBM_TPU_SHAP_DTYPE")
          == "float32" else torch.float64)
    device = torch.device(device)
    last_split.update(decisions_s=0.0, dp_s=0.0)
    n = X.shape[0]
    k = max(num_tree_per_iteration, 1)
    width = num_features + 1
    out = np.zeros((n, width * k), np.float64)
    budget = 256 * 1024 * 1024
    itemsize = 4 if dt == torch.float32 else 8
    for c in range(k):
        cls_trees = [t for ti, t in enumerate(trees) if ti % k == c]
        if not cls_trees:
            continue
        stack = _class_stack_cached(cls_trees, num_features)
        out[:, c * width + num_features] = stack.expected
        if not stack.buckets:
            continue
        consts = _device_consts(stack, dt, device)
        # DP chunk: keep the [P, 3 * Db, C] state within the budget
        chunks = [max(128, min(16384, budget // (b.P * (3 * b.Db + 2)
                                                 * itemsize)))
                  for b in stack.buckets]
        # outer row blocks bound the [total_nodes, rows] decision matrix
        row_block = _dec_row_block(stack.total_nodes)
        for q0 in range(0, n, row_block):
            qn = min(row_block, n - q0)
            t0 = time.perf_counter()
            dec_all = stack.decisions(X[q0:q0 + qn])
            t1 = time.perf_counter()
            last_split["decisions_s"] += t1 - t0
            dec_all = torch.as_tensor(dec_all).to(device)
            acc = torch.zeros((qn, num_features), dtype=torch.float64,
                              device=device)
            for b, cs, chunk in zip(stack.buckets, consts, chunks):
                for r0 in range(0, qn, chunk):
                    rows = min(chunk, qn - r0)
                    phi = _shap_bucket(dec_all[:, r0:r0 + rows], *cs,
                                       num_features, b.Db)
                    acc[r0:r0 + rows] += phi.to(torch.float64)
            out[q0:q0 + qn, c * width:c * width + num_features] += \
                acc.cpu().numpy()
            last_split["dp_s"] += time.perf_counter() - t1
    if average and trees:
        out /= (len(trees) // k)
    return out


def predict_contrib_trees(trees, X: np.ndarray, num_features: int,
                          num_tree_per_iteration: int = 1,
                          average: bool = False, device="cpu") -> np.ndarray:
    """SHAP contributions over an ensemble: [N, (num_features + 1) * k]
    (reference: gbdt.cpp PredictContrib layout). The batched path unless
    ``LIGHTGBM_TPU_SHAP=reference``."""
    if os.environ.get("LIGHTGBM_TPU_SHAP") == "reference":
        return predict_contrib_trees_reference(
            trees, X, num_features, num_tree_per_iteration, average)
    return predict_contrib_trees_fast(
        trees, X, num_features, num_tree_per_iteration, average, device)
