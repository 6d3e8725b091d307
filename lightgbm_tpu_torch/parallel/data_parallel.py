"""``grow_tree_dp``: one tree of the data-parallel learner over a network.

The port of lightgbm_tpu's ``parallel/data_parallel.py``: a thin alias
over ``ParallelGrower("data", net)`` for callers that hold a network
explicitly (the JAX package's takes a device mesh). Rows sharded over the
ranks, histogram planes reduce-scattered to the feature owners, the owners'
search and the best-split sync (reference: data_parallel_tree_learner.cpp:
184-186).
"""

from __future__ import annotations

from .learners import ParallelGrower


def grow_tree_dp(net, binsT, grad, hess, sample_mask, meta, params,
                 feature_mask, missing_bin, **grow_kwargs):
    """Grow one tree with rows sharded over ``net``'s ranks; every rank
    passes all rows (replicated) and gets (tree, leaf ids of all rows,
    rows read)."""
    return ParallelGrower("data", net)(
        binsT, grad, hess, sample_mask, meta, params, feature_mask,
        missing_bin, **grow_kwargs)
