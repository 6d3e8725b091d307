"""Tree model object: fixed-capacity arrays + traversal over binned data.

The port of lightgbm_tpu's ``models/tree.py`` for numerical and
categorical trees. A tree
with leaf capacity L has L-1 internal-node slots and L leaf slots; child
links follow the reference's encoding (``child >= 0`` is a node,
``child < 0`` is ``~leaf``, reference tree.h left_child_/right_child_).
Thresholds are bin indices for traversal over the binned matrix; the real
thresholds for model text come from the bin mappers (``HostTree``). A
categorical node sends left the bins whose bit is set in its bitset (32-bit
words held as int64). EFB segments wait for ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TreeArrays(NamedTuple):
    """One tree as tensors: node arrays [L-1], leaf arrays [L]."""
    num_leaves: torch.Tensor        # int32 scalar (leaves used)
    node_feature: torch.Tensor      # int32 [L-1] inner feature index
    node_threshold_bin: torch.Tensor  # int32 [L-1]
    node_default_left: torch.Tensor   # bool [L-1]
    node_left: torch.Tensor         # int32 [L-1] (>= 0 node, < 0 ~leaf)
    node_right: torch.Tensor        # int32 [L-1]
    node_gain: torch.Tensor         # f32 [L-1]
    node_value: torch.Tensor        # f32 [L-1] internal output
    node_weight: torch.Tensor       # f32 [L-1] sum_hessian at node
    node_count: torch.Tensor        # f32 [L-1]
    node_cat: torch.Tensor          # bool [L-1] categorical split
    node_cat_bitset: torch.Tensor   # int64 [L-1, CAT_WORDS] left bins' bits
    leaf_value: torch.Tensor        # f32 [L]
    leaf_weight: torch.Tensor       # f32 [L]
    leaf_count: torch.Tensor        # f32 [L]
    leaf_depth: torch.Tensor        # int32 [L]
    leaf_parent: torch.Tensor       # int32 [L]
    shrinkage: torch.Tensor         # f32 scalar

    def to(self, device) -> "TreeArrays":
        return TreeArrays(*(t.to(device) for t in self))

    def numpy(self) -> "TreeArrays":
        """The same fields as numpy arrays (host view)."""
        return TreeArrays(*(t.detach().cpu().numpy() for t in self))


def empty_tree(max_leaves: int, cat_words: int = 8,
               device="cpu") -> TreeArrays:
    li, lf = max(max_leaves - 1, 0), max_leaves

    def i32(n, v=0):
        return torch.full((n,), v, dtype=torch.int32, device=device)

    def f32(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return TreeArrays(
        num_leaves=torch.tensor(1, dtype=torch.int32, device=device),
        node_feature=i32(li), node_threshold_bin=i32(li),
        node_default_left=torch.zeros((li,), dtype=torch.bool, device=device),
        node_left=i32(li, -1), node_right=i32(li, -1),
        node_gain=f32(li), node_value=f32(li), node_weight=f32(li),
        node_count=f32(li),
        node_cat=torch.zeros((li,), dtype=torch.bool, device=device),
        node_cat_bitset=torch.zeros((li, cat_words), dtype=torch.int64,
                                    device=device),
        leaf_value=f32(lf), leaf_weight=f32(lf), leaf_count=f32(lf),
        leaf_depth=i32(lf), leaf_parent=i32(lf, -1),
        shrinkage=torch.tensor(1.0, dtype=torch.float32, device=device))


def _decide_left_bins(bin_val, threshold_bin, default_left, missing_bin,
                      is_cat, cat_word):
    """Split decision in bin space. Numerical: the bin routed by the
    default direction (``missing_bin`` >= 0) follows ``default_left``,
    every other bin goes left iff ``bin <= threshold``. Categorical: left
    iff the bin's bit is set in ``cat_word``, the bitset word that holds
    it (reference Tree::CategoricalDecision, tree.h:349)."""
    num_default = (bin_val == missing_bin) & (missing_bin >= 0)
    num_left = torch.where(num_default, default_left, bin_val <= threshold_bin)
    cat_left = ((cat_word >> (bin_val & 31).long()) & 1) == 1
    return torch.where(is_cat, cat_left, num_left)


def predict_leaf_bins(tree: TreeArrays, binsT: torch.Tensor,
                      missing_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index per row by traversing the feature-major bin matrix
    ``binsT`` [F, N] level by level (every active row descends one edge per
    step; the loop ends when no row is at an internal node). [N] int64."""
    n = binsT.shape[1]
    dev = binsT.device
    leaf = torch.zeros((n,), dtype=torch.int64, device=dev)
    if int(tree.num_leaves) <= 1 or binsT.shape[0] == 0:
        return leaf
    t = tree.to(dev)
    cols = torch.arange(n, device=dev)
    cur = torch.zeros((n,), dtype=torch.int64, device=dev)
    words = t.node_cat_bitset.shape[1]
    bits = t.node_cat_bitset.reshape(-1)
    for _ in range(int(tree.num_leaves) - 1):   # depth <= num_leaves - 1
        node = cur.clamp(min=0)
        feat = t.node_feature[node].to(torch.int64)
        b = binsT[feat, cols].to(torch.int32)
        word = bits[node * words + (b >> 5).long()]
        go_left = _decide_left_bins(b, t.node_threshold_bin[node],
                                    t.node_default_left[node],
                                    missing_bin[feat], t.node_cat[node], word)
        nxt = torch.where(go_left, t.node_left[node],
                          t.node_right[node]).to(torch.int64)
        active = cur >= 0
        nxt = torch.where(active, nxt, cur)
        leaf = torch.where(active & (nxt < 0), ~nxt, leaf)
        cur = nxt
        if not bool((cur >= 0).any()):
            break
    return leaf


class HostTree:
    """Host-side (numpy) view of a trained tree for model text and the
    carrying of weights across: the fields of the JAX package's HostTree."""

    def __init__(self, arrays: TreeArrays, real_thresholds: np.ndarray,
                 feature_indices: np.ndarray,
                 missing_types: np.ndarray | None = None):
        t = arrays.numpy()
        self.num_leaves = int(t.num_leaves)
        n = max(self.num_leaves - 1, 0)
        self.split_feature = t.node_feature[:n].astype(np.int32)
        self.threshold_bin = t.node_threshold_bin[:n]
        self.threshold = np.asarray(real_thresholds[:n], np.float64)
        self.default_left = t.node_default_left[:n]
        self.left_child = t.node_left[:n]
        self.right_child = t.node_right[:n]
        self.split_gain = t.node_gain[:n]
        self.internal_value = t.node_value[:n]
        self.internal_weight = t.node_weight[:n]
        self.internal_count = t.node_count[:n]
        self.is_cat = t.node_cat[:n]
        self.cat_bitset = t.node_cat_bitset[:n]
        self.leaf_value = t.leaf_value[:self.num_leaves]
        self.leaf_weight = t.leaf_weight[:self.num_leaves]
        self.leaf_count = t.leaf_count[:self.num_leaves]
        self.leaf_depth = t.leaf_depth[:self.num_leaves]
        self.leaf_parent = t.leaf_parent[:self.num_leaves]
        self.shrinkage = float(t.shrinkage)
        self.feature_indices = np.asarray(feature_indices)
        self.missing_type = (np.asarray(missing_types[:n]).astype(np.int8)
                             if missing_types is not None
                             else np.zeros(n, dtype=np.int8))


def tree_from_host_fields(fields: dict, max_leaves: int | None = None
                          ) -> TreeArrays:
    """TreeArrays from HostTree-shaped numpy fields (``convert.py``)."""
    nl = int(fields["num_leaves"])
    cap = max(nl, max_leaves or nl)
    bits = np.asarray(fields.get("cat_bitset", np.zeros((0, 1))))
    t = empty_tree(cap, max(bits.shape[1] if bits.ndim == 2 else 1, 1))
    n = nl - 1
    # (TreeArrays field, HostTree field, entries, required); an optional
    # field that is absent keeps empty_tree's values
    for arr, key, k, required in (
            (t.node_feature, "split_feature", n, True),
            (t.node_threshold_bin, "threshold_bin", n, True),
            (t.node_default_left, "default_left", n, True),
            (t.node_left, "left_child", n, True),
            (t.node_right, "right_child", n, True),
            (t.node_gain, "split_gain", n, False),
            (t.node_value, "internal_value", n, False),
            (t.node_weight, "internal_weight", n, False),
            (t.node_count, "internal_count", n, False),
            (t.node_cat, "is_cat", n, False),
            (t.node_cat_bitset, "cat_bitset", n, False),
            (t.leaf_value, "leaf_value", nl, True),
            (t.leaf_weight, "leaf_weight", nl, False),
            (t.leaf_count, "leaf_count", nl, False),
            (t.leaf_depth, "leaf_depth", nl, False),
            (t.leaf_parent, "leaf_parent", nl, False)):
        vals = np.asarray(fields[key] if required else fields.get(key, ()))
        vals = vals[:k]
        if len(vals):
            arr[:len(vals)] = torch.as_tensor(vals, dtype=arr.dtype)
    return t._replace(
        num_leaves=torch.tensor(nl, dtype=torch.int32),
        shrinkage=torch.tensor(float(fields.get("shrinkage", 1.0)),
                               dtype=torch.float32))
