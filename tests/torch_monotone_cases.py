"""Inputs for the split epilogue's monotone mode (``split_epilogue`` and its
plain version with ``with_monotone=True``), shared by the card tests
(tests/test_torch_cuda.py) and the CPU comparison with the JAX package's
interpreted Pallas epilogue (tests/test_torch_constraints.py).

A case is raw rows made with numpy from a seed -- bins, stats
(integer-valued float32, or int8 in q8 mode, so every plane sum is exact
in any order) and a leaf per row -- with the tile the grower would hand
the epilogue: slot p holds leaf p, the odd slots derived (their planes
from the parent less the computed sibling). The features cycle through
the directions +1, -1, 0 and the missing types None, Zero, NaN. The
slots' output bounds, by kind:

- ``open``: -FLT_MAX / FLT_MAX, the unconstrained bounds;
- ``tight``: a window around each slot's output a quarter as wide as its
  children's outputs spread, so that clipping changes the winner of
  some (slot, feature);
- ``equal``: ``tight``, and slot 0 with ``leaf_min == leaf_max``;
- ``violate``: open bounds, and feature 0 (+1) binned by gradient with a
  constant hessian, so that every candidate of it breaks the direction
  (its left child always has the higher output) in every slot.
"""

import numpy as np
import torch

from lightgbm_tpu_torch.ops import cuda_hist

KINDS = ("open", "tight", "equal", "violate")
DIRECTIONS = (1, -1, 0)
PV = [0.0, 1.0, 0.0, 0.0, 20.0, 1e-3, 0.0, 0.0]
Q_SCALE = np.array([0.0173, 0.00291, 1.0], np.float32)
F32_MAX = float(np.finfo(np.float32).max)


def _outputs(g, h, l2):
    return -g / (h + np.float32(l2))


def monotone_case(kind, q8, p=6, f=6, b=63, n=3001, seed=0):
    """One case: a dict of the raw rows (``binsT`` [F, N] uint8, ``stats``
    [N, 3], ``leaf`` [N] int32), ``sel`` / ``derive`` [P], and the
    epilogue's arguments as CPU tensors (``tile``, ``parent``, ``der``,
    ``la``, ``fm``, ``pv``, ``q_scale`` or None)."""
    rng = np.random.RandomState(seed + 101 * KINDS.index(kind) + 7 * b
                                + 13 * f + (1 if q8 else 0))
    binsT = rng.randint(0, b, size=(f, n)).astype(np.uint8)
    if q8:
        stats = rng.randint(-127, 128, size=(n, 3)).astype(np.int8)
        stats[:, 1] = 64 if kind == "violate" else rng.randint(1, 128, n)
        stats[:, 2] = 1
    else:
        stats = (rng.randint(-1023, 1024, size=(n, 3)) / 1024.0
                 ).astype(np.float32)
        stats[:, 1] = (0.5 if kind == "violate"
                       else rng.randint(1, 1024, n) / 1024.0)
        stats[:, 2] = 1.0
    if kind == "violate":
        # feature 0 in gradient order: each threshold's left side has the
        # lower gradients, so the higher output
        order = np.argsort(stats[:, 0].astype(np.float64), kind="stable")
        binsT[0, order] = (np.arange(n) * b // n).astype(np.uint8)
    leaf = rng.randint(0, p, n).astype(np.int32)
    sel = np.arange(p, dtype=np.int32)
    derive = np.zeros(p, bool)
    derive[1::2] = True

    nb = np.full(f, b, np.int32)
    mt = np.array([j % 3 for j in range(f)], np.int32)
    db = np.where(mt == 1, rng.randint(0, b, f), 0).astype(np.int32)
    mono = np.array([DIRECTIONS[j % 3] for j in range(f)], np.int32)
    if kind == "violate":
        mt[0] = 0

    planes = cuda_hist.hist_tile_plain(
        torch.from_numpy(binsT), torch.from_numpy(leaf),
        torch.from_numpy(stats), cuda_hist.chan_leaf_table(
            torch.from_numpy(sel)), p, b, p).numpy()
    scale = Q_SCALE if q8 else np.ones(3, np.float32)
    full = planes.astype(np.float32) * scale
    parent = np.zeros_like(full)
    for i in np.nonzero(derive)[0]:
        parent[i] = full[i] + full[i - 1]
    tile = np.where(derive[:, None, None, None], 0, planes)
    sums = full[:, 0].sum(1)
    l2 = PV[1]
    out = _outputs(sums[:, 0], sums[:, 1], l2).astype(np.float32)
    lmin = np.full(p, -F32_MAX, np.float32)
    lmax = np.full(p, F32_MAX, np.float32)
    if kind in ("tight", "equal"):
        # each slot's children: the outputs of the bins' prefix sums of
        # feature 1, a spread the window cuts to a quarter
        csum = np.cumsum(full[:, 1], axis=1)
        child = _outputs(csum[..., 0], csum[..., 1], l2)
        spread = np.abs(child - out[:, None])
        w = (0.125 * np.median(spread, axis=1)).astype(np.float32)
        lmin, lmax = out - w, out + w
        if kind == "equal":
            lmin[0] = lmax[0] = out[0]
    la = cuda_hist.pack_leaf_aux(*(torch.from_numpy(np.ascontiguousarray(c))
                                   for c in (sums[:, 0], sums[:, 1],
                                             sums[:, 2], out, lmin, lmax)))
    fm = cuda_hist.pack_feature_meta(*(torch.from_numpy(c)
                                       for c in (nb, mt, db, mono)))
    return {
        "binsT": binsT, "stats": stats, "leaf": leaf, "sel": sel,
        "derive": derive,
        "tile": torch.from_numpy(np.ascontiguousarray(tile)),
        "parent": torch.from_numpy(parent),
        "der": cuda_hist._epilogue_lanes(torch.from_numpy(sel),
                                         torch.from_numpy(derive)),
        "la": la, "fm": fm, "pv": torch.tensor(PV, dtype=torch.float32),
        "q_scale": torch.from_numpy(Q_SCALE) if q8 else None}


def epilogue_args(case, device="cpu"):
    """The epilogue's positional arguments (tile, parent, der, la, fm, pv,
    q_scale) on ``device``."""
    return tuple(None if case[k] is None else case[k].to(device)
                 for k in ("tile", "parent", "der", "la", "fm", "pv",
                           "q_scale"))
