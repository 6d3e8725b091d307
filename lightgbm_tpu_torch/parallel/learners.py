"""tree_learner dispatch: the data, feature and voting learners.

The port of lightgbm_tpu's ``parallel/learners.py`` (the analog of the
reference's TreeLearner factory, tree_learner.h:104). The JAX package runs
one grower under a ``shard_map`` over a device mesh; here each rank of a
gang (a process, or a thread-rank of ``network.thread_gang``) runs the
grower over its own rows and features, and ``network.Network`` carries the
collectives the JAX grower's ``jax.lax`` calls make:

- ``data``: rows sharded; each tile pass's planes reduce-scattered to the
  feature owners, the owners' search, the best-split sync (reference:
  data_parallel_tree_learner.cpp:184-186, parallel_tree_learner.h:191);
- ``feature``: rows replicated, features sliced; only the best-split sync
  (feature_parallel_tree_learner.cpp:59-78);
- ``voting``: rows sharded; a local top-k vote elects 2k features per leaf
  and only those columns are summed (voting_parallel_tree_learner.cpp:
  151-182).

The padding rules are the JAX package's (``pad_replicated_inputs``): rows to
a multiple of W for data and voting (zero gradients, hessians and mask, so
the padded rows add nothing), features to a multiple of W for data and
feature (inert columns: 2 bins, no missing value, numerical, masked off).
Rank r takes the r-th contiguous block of rows, and owns the r-th
contiguous slice of features.
"""

from __future__ import annotations

import torch

from ..models.grower import grow_tree
from ..ops.split import BundleMeta, FeatureMeta

PARALLEL_MODES = ("data", "feature", "voting")


def pad_features(meta: FeatureMeta, f_pad: int) -> FeatureMeta:
    """Per-feature metadata padded with inert features (2 bins, no missing
    value, numerical, unconstrained, contri 1)."""
    def pad(a, value=0):
        return torch.cat([a, torch.full((f_pad,), value, dtype=a.dtype,
                                        device=a.device)])
    return FeatureMeta(num_bins=pad(meta.num_bins, 2),
                       missing_type=pad(meta.missing_type),
                       default_bin=pad(meta.default_bin),
                       is_categorical=pad(meta.is_categorical, False),
                       monotone=pad(meta.monotone),
                       penalty=pad(meta.penalty, 1.0))


def pad_bundle_meta(bundle: BundleMeta, f_pad: int) -> BundleMeta:
    """EFB metadata padded with inert columns whose one segment spans every
    bin; preference 0 keeps them below every real candidate."""
    b = bundle.seg_lo.shape[1]

    def pad(a, value=0):
        tail = torch.full((f_pad,) + tuple(a.shape[1:]), value,
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, tail])
    return BundleMeta(seg_lo=pad(bundle.seg_lo),
                      seg_hi=pad(bundle.seg_hi, b - 1),
                      is_bundle=pad(bundle.is_bundle, False),
                      fwd_ok=pad(bundle.fwd_ok, False),
                      rev_ok=pad(bundle.rev_ok, False),
                      pref_fwd=pad(bundle.pref_fwd),
                      pref_rev=pad(bundle.pref_rev))


class ParallelGrower:
    """One rank's learner of mode ``mode`` over ``net``. The padded bin
    matrix of this rank is built once per Dataset tensor (``_local_bins``),
    so the kernels' row-major copy of it is made once too."""

    def __init__(self, mode: str, net):
        assert mode in PARALLEL_MODES, mode
        self.mode = mode
        self.net = net
        self.world = net.world
        self.rank = net.rank
        self._bins = None            # (source tensor, version, padded)

    @property
    def rows_sharded(self) -> bool:
        return self.mode in ("data", "voting")

    def pads(self, n: int, f: int, pre_part: bool = False):
        """(row padding, feature padding) of the replicated inputs; a
        pre-partitioned matrix arrives padded to the gang's common local
        row count already."""
        w = self.world
        n_pad = (-n) % w if self.rows_sharded and not pre_part else 0
        f_pad = (-f) % w if self.mode in ("data", "feature") else 0
        return n_pad, f_pad

    def _local_bins(self, binsT: torch.Tensor, pre_part: bool):
        """This rank's [F + f_pad, rows] bin matrix: its contiguous row
        block of the padded rows (data, voting), all rows (feature), or the
        pre-partitioned local rows, with the padded features as zero
        columns."""
        kept = self._bins
        if kept is not None and kept[0] is binsT \
                and kept[1] == binsT._version:
            return kept[2]
        f, n = binsT.shape
        n_pad, f_pad = self.pads(n, f, pre_part)
        out = binsT
        if self.rows_sharded and not pre_part:
            c = (n + n_pad) // self.world
            lo, hi = self.rank * c, min((self.rank + 1) * c, n)
            out = torch.zeros((f, c), dtype=binsT.dtype, device=binsT.device)
            if hi > lo:
                out[:, :hi - lo] = binsT[:, lo:hi]
        if f_pad:
            out = torch.cat([out, torch.zeros((f_pad, out.shape[1]),
                                              dtype=out.dtype,
                                              device=out.device)])
        out = out.contiguous()
        self._bins = (binsT, binsT._version, out)
        return out

    def _local_rows(self, a: torch.Tensor, n: int, rows: int,
                    pre_part: bool) -> torch.Tensor:
        """This rank's block of a per-row vector (replicated input), or the
        local vector (pre-partitioned), zero-padded to ``rows``."""
        if self.rows_sharded and not pre_part:
            lo = min(self.rank * rows, n)
            a = a[lo:min(lo + rows, n)]
        if a.shape[0] < rows:
            a = torch.cat([a, a.new_zeros((rows - a.shape[0],))])
        return a.contiguous()

    def __call__(self, binsT, grad, hess, sample_mask, meta, params,
                 feature_mask, missing_bin, *, pre_part: bool = False,
                 bundle=None, forced=None, counters=None, **grow_kwargs):
        """Grow one tree: ``binsT`` [F, N] and the per-row ``grad``,
        ``hess``, ``sample_mask`` (None = every row) of the whole data
        (replicated, every rank holds all rows) or of this rank's rows
        (``pre_part``, ``binsT`` padded to the gang's common local count).
        Returns (tree, leaf ids of the caller's rows -- all N rows when
        replicated, the local rows when pre-partitioned -- rows read). The
        learners run the classic search (the JAX package's fusion reason
        "parallel learner") with no compaction ladder."""
        f = binsT.shape[0]
        n = grad.shape[0]
        _, f_pad = self.pads(n, f, pre_part)
        local = self._local_bins(binsT, pre_part)
        rows = local.shape[1]
        if sample_mask is None:
            sample_mask = torch.ones((n,), dtype=torch.float32,
                                     device=grad.device)
        g, h, m = (self._local_rows(a, n, rows, pre_part)
                   for a in (grad, hess, sample_mask))
        if f_pad:
            meta = pad_features(meta, f_pad)
            missing_bin = torch.cat([missing_bin, torch.full(
                (f_pad,), -1, dtype=missing_bin.dtype,
                device=missing_bin.device)])
            if feature_mask is not None:
                feature_mask = torch.cat([torch.as_tensor(feature_mask),
                                          torch.zeros((f_pad,),
                                                      dtype=torch.bool)])
            else:
                feature_mask = torch.cat([torch.ones((f,), dtype=torch.bool),
                                          torch.zeros((f_pad,),
                                                      dtype=torch.bool)])
            if bundle is not None:
                bundle = pad_bundle_meta(bundle, f_pad)
        if feature_mask is not None:
            feature_mask = torch.as_tensor(feature_mask).numpy()
        gang_rows = rows * self.world if self.rows_sharded else rows
        tree, leaf_id, streamed = grow_tree(
            local, g, h, meta, params, missing_bin, sample_mask=m,
            feature_mask=feature_mask, bundle=bundle, forced=forced,
            counters=counters, net=self.net, learner=self.mode,
            gang_rows=gang_rows, split_fusion=False, **grow_kwargs)
        if self.rows_sharded and not pre_part:
            # every rank routes its own rows; the score update of the
            # replicated data takes all of them
            leaf_id = torch.cat(self.net.allgather(leaf_id))[:n]
        else:
            leaf_id = leaf_id[:n]
        return tree, leaf_id, streamed
