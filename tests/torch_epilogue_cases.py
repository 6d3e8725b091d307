"""Edge-case planes for the split epilogue (``split_epilogue`` and its plain
version), shared by the card tests (tests/test_torch_cuda.py) and the CPU
comparison with the JAX package (tests/test_torch_hist.py).

Each case is built with numpy from a seed and is made to break a parallel
scan or argmax:

- ``ties``: integer-valued planes, 70% of the bins empty and every other
  feature mirrored bin for bin, so that thresholds give exactly equal
  gains within one direction (an empty bin repeats the sums), across the
  two (a missing bin that is empty makes both scans' sums equal) and
  between mirrored thresholds; the q8 scales are powers of two, so the
  dequantized sums stay exact and the ties stay ties;
- ``all_inf``: a feature of empty bins and a feature whose count never
  meets ``min_data``: every key -inf, where the winner is the reverse
  threshold B-1;
- ``nan``: NaN cells in the tile (f32) and in the parents of derived slots;
- ``derived0``: slot 0 derived (parent - 0: it has no sibling);
- ``missing``: every feature with fewer bins than B (``nb < B``) and the
  NaN or Zero missing type, its default bin inside.

The scan parameters are the caller's; ``EDGE_BINS`` holds the plane widths
at the edges of the kernel's 8 bins a lane and 16-bin scan blocks.
"""

import numpy as np
import torch

from lightgbm_tpu_torch.ops import cuda_hist

EDGE_CASES = ("ties", "all_inf", "nan", "derived0", "missing")
EDGE_BINS = (1, 8, 16, 17, 255, 256)
PV_DEFAULT = [0.0, 1.0, 0.0, 0.0, 20.0, 1e-3, 0.0, 0.0]
PV_REGULARISED = [0.5, 2.0, 0.7, 3.0, 5.0, 1.0, 0.01, 0.0]


def _meta(case, f, b, rng):
    nb = np.full(f, b, np.int32)
    mt = np.zeros(f, np.int32)
    db = np.zeros(f, np.int32)
    if case == "missing":
        for j in range(f):
            nb[j] = max(1, b - 1 - (j * b) // (2 * f))
            mt[j] = 2 if j % 2 == 0 else 1
            db[j] = rng.randint(0, nb[j])
    elif f >= 4:
        nb[1], mt[2], mt[3] = max(1, b - b // 3), 2, 1
        db[3] = b // 2
    return nb, mt, db


def epilogue_case(case, b, q8, p=6, f=6, seed=0):
    """One edge case at P=p slots, F=f features, B=b bins: (tile, parent,
    der, la, fm, q_scale, derive) as CPU tensors -- an int32 tile and a
    [3] q_scale in q8 mode, a float32 tile and None otherwise; ``der`` the
    kernel's lane table, ``derive`` the [P] flags it encodes."""
    rng = np.random.RandomState(
        seed + 1009 * EDGE_CASES.index(case) + 7 * b + (1 if q8 else 0))
    derive = np.zeros(p, bool)
    derive[1::2] = True
    if case == "derived0":
        derive[0] = True
    cnt = rng.randint(1, 30, (p, f, b)) * (rng.rand(p, f, b) < 0.3)
    grad = rng.randint(-4, 5, (p, f, b)) * cnt
    hess = rng.randint(1, 4, (p, f, b)) * cnt
    plane = np.stack([grad, hess, cnt], -1).astype(np.int64)
    if case == "ties":
        plane[:, 1::2] = plane[:, 0::2][:, : f // 2, ::-1]
    if case == "all_inf":
        plane[:, 0] = 0
        plane[:, 1] = 0
        plane[:, 1, 0] = (3, 2, 1)
    q_scale = (np.array([0.5, 0.25, 1.0], np.float32) if case == "ties"
               else np.array([0.0173, 0.00291, 1.0], np.float32))
    # computed slots hold their plane; a derived slot's parent is its plane
    # plus the computed sibling's (slot 0 derived: no sibling)
    tile = np.where(derive[:, None, None, None], 0, plane)
    sib = np.concatenate([np.zeros_like(tile[:1]), tile[:-1]])
    parent_int = np.where(derive[:, None, None, None], plane + sib, 0)
    if q8:
        tile_t = torch.from_numpy(tile.astype(np.int32))
        parent = parent_int.astype(np.float32) * q_scale
    else:
        tile_t = torch.from_numpy(tile.astype(np.float32))
        parent = parent_int.astype(np.float32)
    if case == "nan":
        parent[derive, 1, min(3, b - 1), 0] = np.nan
        if not q8:
            tile_t[0, 2, b // 2, 1] = float("nan")
            tile_t[2, 4, 0, 0] = float("nan")
    scale = q_scale if q8 else np.ones(3, np.float32)
    full = np.where(derive[:, None, None, None], parent,
                    tile_t.numpy().astype(np.float32) * scale)
    tot = np.nan_to_num(full[:, -1].sum(1), nan=1.0).astype(np.float32)
    out = (np.float32(-0.1) * tot[:, 0] / (tot[:, 1] + 1)).astype(np.float32)
    la = cuda_hist.pack_leaf_aux(*(torch.from_numpy(np.ascontiguousarray(x))
                                   for x in (tot[:, 0], tot[:, 1], tot[:, 2],
                                             out)))
    nb, mt, db = _meta(case, f, b, rng)
    fm = cuda_hist.pack_feature_meta(*(torch.from_numpy(x) for x in
                                       (nb, mt, db, np.zeros(f, np.int32))))
    der = cuda_hist._epilogue_lanes(torch.arange(p, dtype=torch.int32),
                                    torch.from_numpy(derive))
    return (tile_t.contiguous(), torch.from_numpy(parent).contiguous(), der,
            la.contiguous(), fm.contiguous(),
            torch.from_numpy(q_scale) if q8 else None,
            torch.from_numpy(derive))
