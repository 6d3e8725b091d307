"""Exclusive Feature Bundling (EFB).

The port's own copy of lightgbm_tpu's ``bundling.py`` (pure numpy; the
port imports nothing of the JAX package). Host-side greedy bundling of mutually-exclusive sparse features into shared
device columns (reference: src/io/dataset.cpp:100-237 ``FindGroups`` /
``FastFeatureBundling``; NeurIPS'17 LightGBM paper §4). Without it,
wide-sparse data (Allstate 13.2M x 4228) cannot fit a dense ``[N, F]`` bin
matrix.

Semantics carried over:

- conflict budget: ``total_sample_cnt / 10000`` per bundle
  (dataset.cpp:108-109), a feature joins the first bundle where its
  conflicts fit the remaining budget and at most half its non-default rows
  (dataset.cpp:154-158);
- bundles capped at 256 total bins (dataset.cpp:107 max_bin_per_group) so a
  bundle column still fits uint8;
- two greedy passes — original feature order and by non-default count
  descending — keeping whichever yields fewer bundles (dataset.cpp:293-303);
- conflict marks are over rows where the feature is NOT at its
  most-frequent bin (dataset.cpp:76-97 FixSampleIndices).

Bundle column layout (the analog of FeatureGroup::bin_offsets,
feature_group.h): bundle bin 0 = every member at its most-frequent bin;
member ``f`` with ``nb`` bins occupies ``nb`` bins
``[offset_f, offset_f + nb)`` — one leading PHANTOM bin (never populated;
it hosts the threshold candidate whose left side is only the member's
most-frequent mass) followed by the ``nb - 1`` data bins in the member's
own bin order with the most-frequent bin elided. Rows in another member's
range (or bin 0) are ``f``-default — at split time their mass is
reconstructed from the leaf totals exactly like the reference's
``FixHistogram`` (dataset.cpp), and the per-bin scan-direction masks
(basic.py _build_feature_meta_bundled) restrict candidates so every
original-feature threshold is evaluated exactly once with exact sums,
reproducing the unbundled scan.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

MAX_BIN_PER_BUNDLE = 256          # dataset.cpp:107 max_bin_per_group
MAX_SEARCH_GROUP = 100            # dataset.cpp:106


class Bundle(NamedTuple):
    members: List[int]            # used-feature indices (inner, pre-bundle)
    offsets: List[int]            # bundle-bin offset per member
    num_bin: int                  # total bundle bins (incl. shared bin 0)


def _member_span(num_bin: int) -> int:
    """Bins a member occupies in the bundle: a leading phantom candidate bin
    + (num_bin - 1) data bins (most-frequent bin elided)."""
    return num_bin


def find_groups(nonzero_rows: List[Optional[np.ndarray]], num_bins: List[int],
                order: np.ndarray, total_cnt: int,
                max_conflict: int) -> List[List[int]]:
    """One greedy pass (reference: dataset.cpp:100-187 first round)."""
    groups: List[List[int]] = []
    marks: List[np.ndarray] = []
    group_total: List[int] = []
    group_used: List[int] = []
    group_bins: List[int] = []
    rng = np.random.RandomState(total_cnt)
    for fi in order:
        fi = int(fi)
        rows = nonzero_rows[fi]
        cnt = len(rows)
        span = _member_span(num_bins[fi])
        available = [g for g in range(len(groups))
                     if group_total[g] + cnt <= total_cnt + max_conflict
                     and group_bins[g] + span <= MAX_BIN_PER_BUNDLE]
        if len(available) > MAX_SEARCH_GROUP:
            # sample a search subset but always keep the most recent group
            picked = rng.choice(len(available) - 1, MAX_SEARCH_GROUP - 1,
                                replace=False)
            available = [available[-1]] + [available[i] for i in picked]
        best = -1
        for g in available:
            rest = max_conflict - group_total[g] + group_used[g]
            conflicts = int(marks[g][rows].sum())
            if conflicts <= rest and conflicts <= cnt // 2:
                best = g
                best_conflicts = conflicts
                break
        if best >= 0:
            groups[best].append(fi)
            marks[best][rows] = True
            group_total[best] += cnt
            group_used[best] += cnt - best_conflicts
            group_bins[best] += span
        else:
            groups.append([fi])
            m = np.zeros(total_cnt, dtype=bool)
            m[rows] = True
            marks.append(m)
            group_total.append(cnt)
            group_used.append(cnt)
            group_bins.append(1 + span)
    return groups


def fast_feature_bundling(nonzero_rows: List[Optional[np.ndarray]],
                          num_bins: List[int],
                          bundle_ok: np.ndarray,
                          total_cnt: int) -> List[Bundle]:
    """Greedy EFB over the bundle-eligible features.

    Args:
      nonzero_rows: per used-feature sampled row indices where the feature is
        NOT at its most-frequent bin (None for ineligible features).
      num_bins: per used-feature bin counts.
      bundle_ok: [F] bool eligibility (numerical, zero-default, no NaN bin,
        unconstrained).
      total_cnt: number of sampled rows the indices refer to.

    Returns one Bundle per output column (singles included), covering every
    input feature exactly once, in input feature order by first member.
    """
    f = len(num_bins)
    eligible = [i for i in range(f) if bundle_ok[i]]
    singles = [i for i in range(f) if not bundle_ok[i]]
    max_conflict = total_cnt // 10000           # dataset.cpp:108-109
    groups: List[List[int]] = []
    if eligible:
        counts = np.array([len(nonzero_rows[i]) for i in eligible])
        order_a = np.array(eligible)
        order_b = order_a[np.argsort(-counts, kind="stable")]
        ga = find_groups(nonzero_rows, num_bins, order_a, total_cnt,
                         max_conflict)
        gb = find_groups(nonzero_rows, num_bins, order_b, total_cnt,
                         max_conflict)
        groups = gb if len(gb) < len(ga) else ga
    groups = groups + [[i] for i in singles]
    groups.sort(key=lambda g: min(g))

    bundles = []
    for g in groups:
        g = sorted(g)
        if len(g) == 1:
            # single-member groups stay regular columns (no elision)
            bundles.append(Bundle(members=g, offsets=[0],
                                  num_bin=num_bins[g[0]]))
            continue
        offsets = []
        off = 1                                  # bin 0 = all-default
        for fi in g:
            offsets.append(off)
            off += _member_span(num_bins[fi])
        bundles.append(Bundle(members=g, offsets=offsets, num_bin=off))
    return bundles
