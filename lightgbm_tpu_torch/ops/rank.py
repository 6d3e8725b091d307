"""The pairwise lambda pass of lambdarank: its Hopper kernel, wrapper and
plain versions.

The JAX package computes lambdarank's gradients as plain ``jnp`` over a
padded ``[Q, M, M]`` pair tensor (``lightgbm_tpu/ranking.py``
``LambdarankNDCG._padded_grads`` + ``_scatter_grads``); it has no Pallas
kernel. At MS LTR width (18,919 queries, the longest 1,251 documents, so
M = 1,256) one such tensor is 119 GB, so the port computes the same
function another way:

- ``lambdarank_grads`` (``csrc/lambdarank.cu``) on the card: one block a
  query (longest first), walking the real pairs (the reference's loop,
  rank_objective.hpp:142-227): the documents ranked above the truncation
  level four at a time in ascending index, a warp each, its lanes over
  all the document's partners, each pair's terms added to both of its
  documents. It reads per-document arrays and writes the per-document
  sums; no pair tensor exists.
- ``lambdarank_grads_plain`` on the CPU: the JAX arithmetic over
  ``[Q, M, M]``, chunked over queries, with XLA:CPU's reduction order
  (``xla_sum``) and flush-to-zero, so the gradients are bitwise the JAX
  package's.
- ``lambdarank_grads_exact``: the kernel's own summation order in plain
  PyTorch (a top document's terms as the higher label and as the lower
  label summed apart in 32 lanes, lane l over partners l, l + 32, ... in
  ascending index, the lanes combined by a xor butterfly; another
  document's summed over the top list in ascending index; the query's
  higher lambdas summed by ``_THREADS`` strided partial sums and a halving
  tree). The card holds the kernel to it bit for bit; inside
  ``cuda_hist.kernel_sums_on_cpu()`` a CPU run uses it and reproduces a
  card run's gradients.

Every path shares the ranks (one stable sort of (query, -score) keys, ties
in index order as ``jnp.argsort(-s, stable=True)``), the discounts
``1 / log2(2 + rank)`` and the ``log2(1 + S) / S`` normalisation, all in
the port's XLA-order float32 operations (``objectives.exp_f32``,
``log_f32``): a pair's lambda and hessian are the same bits on every path,
and only the order of the sums differs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..objectives import _c32, _ftz, exp_f32, log_f32
from . import cuda_hist
from .cuda_hist import _check, _lib, _ptr, _raise_on

K_EPSILON = 1e-15
PAD_SCORE = -1e30           # the padded slots' score (JAX ranking.py)
_WINDOW = 32                # XLA:CPU's tree-reduction window
_INV_LN2 = _c32(1.0 / np.log(2.0))
_THREADS = 128              # threads of a lambdarank_grads block
_LANES = 32                 # lanes of a warp: a top document's partial sums


def log2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` of float32, as XLA:CPU computes it: ``log(x)`` times
    the float32 constant ``1 / log(2)``."""
    return _ftz(log_f32(x) * _INV_LN2)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` of float32 on XLA:CPU: ``1 / (1 + exp(-x))``,
    flushed to zero below the smallest normal float."""
    return _ftz(1.0 / (1.0 + exp_f32(-x)))


# ------------------------------------------------------ XLA's sum order
def _seq_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """Sum over ``dims`` one element after another in row-major order,
    from +0, each add flushed to zero (XLA:CPU's plain reduce loop)."""
    other = [d for d in range(x.dim()) if d not in dims]
    flat = x.permute(*other, *dims).reshape(
        *[x.shape[d] for d in other], -1)
    acc = torch.zeros(flat.shape[:-1], dtype=torch.float32, device=x.device)
    for k in range(flat.shape[-1]):
        acc = _ftz(acc + flat[..., k])
    return acc


def xla_sum(x: torch.Tensor, dims, full: Optional[int] = None
            ) -> torch.Tensor:
    """``jnp.sum(x, axis=dims)`` of float32 in XLA:CPU's order, for a
    reduce that reads a materialised operand. XLA's tree reduction
    rewriter turns a reduce with a reduced dimension longer than 32 into a
    reduce-window (each reduced dimension of 32 or more cut into windows of
    32, zero-padded to a multiple of 32 with the lower half of the padding
    in front), each window summed in row-major order, then a reduce of the
    window sums, rewritten the same way if still longer. Shorter reduces
    run in row-major order, except that a reduce over two dimensions, the
    outer of 2, 4 or 8 and the inner of 2 to 8, is vectorised over the
    outer one: each row summed, then the row sums as a halving tree.

    ``full``: every reduced dimension is ``full`` long and ``x`` holds its
    leading part, the rest zeros; only the windows that part reaches are
    summed (the others sum to +0)."""
    dims = sorted(d % x.dim() for d in dims)
    size = {d: (full if full is not None else x.shape[d]) for d in dims}
    if not any(size[d] > _WINDOW for d in dims):
        for d in dims:                      # a short prefix: the zeros
            if x.shape[d] < size[d]:
                z = list(x.shape)
                z[d] = size[d] - x.shape[d]
                x = torch.cat([x, x.new_zeros(z)], dim=d)
        if (len(dims) == 2 and x.shape[dims[0]] in (2, 4, 8)
                and 2 <= x.shape[dims[1]] <= 8):
            acc = _seq_sum(x, [dims[1]])
            while acc.shape[dims[0]] > 1:
                h = acc.shape[dims[0]] // 2
                acc = _ftz(acc.narrow(dims[0], 0, h)
                           + acc.narrow(dims[0], h, h))
            return acc.squeeze(dims[0])
        return _seq_sum(x, dims)
    shape, win, windows = [], [], {}
    for d in range(x.dim()):
        have = x.shape[d]
        if d in dims:
            total = (-size[d]) % _WINDOW if size[d] >= _WINDOW else 0
            lo = total // 2
            reach = size[d] if size[d] < _WINDOW else \
                -(-(lo + have) // _WINDOW) * _WINDOW
            z = list(x.shape)
            z[d] = lo
            front = x.new_zeros(z)
            z[d] = reach - lo - have
            x = torch.cat([front, x, x.new_zeros(z)], dim=d)
            if size[d] >= _WINDOW:
                windows[d] = (size[d] + total) // _WINDOW
                shape += [reach // _WINDOW, _WINDOW]
                win.append(len(shape) - 1)
                continue
        shape.append(x.shape[d])
    ws = _seq_sum(x.reshape(shape), win)
    for d, nw in windows.items():           # the windows never reached
        if ws.shape[d] < nw:
            z = list(ws.shape)
            z[d] = nw - ws.shape[d]
            ws = torch.cat([ws, ws.new_zeros(z)], dim=d)
    return xla_sum(ws, dims)


def _tree(acc: torch.Tensor) -> torch.Tensor:
    """The lanes of the last dimension added as a halving tree (LLVM's
    reassociating vector reduce)."""
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = _ftz(acc[..., :h] + acc[..., h:])
    return acc[..., 0]


def _lanes(x: torch.Tensor, vf: int) -> torch.Tensor:
    """Sum over the last dimension in ``vf`` vector lanes (lane l adds
    elements l, l + vf, ...; lane 0 from +0, the others from -0, the
    vectorised loop's start), then the lanes as a halving tree."""
    acc = torch.full_like(x[..., :vf], -0.0)
    acc[..., 0] = 0.0
    for k in range(0, x.shape[-1], vf):
        acc = _ftz(acc + x[..., k:k + vf])
    return _tree(acc)


def _fused_rows(x: torch.Tensor, same: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` [Q, M, M] over (1, 2) as XLA:CPU's vectorised loop
    adds it: the rows in order, the running total in lane 0 of an 8-lane
    vector that adds the row's 8-wide chunks in order, then a halving
    tree of the lanes. At M = 32 the loop is unswitched on ``same`` (the
    query's scores all equal), and that version adds the chunks as
    (c1 + c3) + ((v + c0) + c2)."""
    q, m, _ = x.shape
    acc = x.new_zeros((q,))
    neg0 = x.new_full((q, 7), -0.0)
    for i in range(m):
        v = torch.cat([acc[:, None], neg0], dim=1)
        c = [x[:, i, k:k + 8] for k in range(0, m, 8)]
        seq = v
        for ck in c:
            seq = _ftz(seq + ck)
        if m == 32:
            inter = _ftz(_ftz(c[1] + c[3]) + _ftz(_ftz(v + c[0]) + c[2]))
            seq = torch.where(same[:, None], inter, seq)
        acc = _tree(seq)
    return acc


def pair_sums(pl: torch.Tensor, ph: torch.Tensor, same: torch.Tensor,
              norm: bool, m: int):
    """The JAX text's ``sum(p_lambda, axis=2) - sum(p_lambda, axis=1)``,
    ``sum(p_hess, axis=2) + sum(p_hess, axis=1)`` and
    ``sum(p_lambda, axis=(1, 2))`` in XLA:CPU's order. From M = 40 the
    reduces read the materialised pair tensor in windows (``xla_sum``).
    For M of 16 to 32 XLA fuses them with the pair arithmetic into loops
    that LLVM vectorises: the axis sums in 8 lanes (axis 2, and axis 1
    without ``lambdarank_norm``, at M = 32: 16), the (1, 2) sum row by row
    (``_fused_rows``). At M = 8 they are plain reduces. ``pl``/``ph`` hold
    the leading [Q, e, e] of the [Q, M, M] tensors (e = M up to 32)."""
    if 16 <= m <= _WINDOW:
        vf2 = 16 if m == 32 and not norm else 8
        vf1 = 16 if m == 32 else 8
        s2 = (_lanes(pl, vf2), _lanes(ph, vf2))
        s1 = (_lanes(pl.transpose(1, 2), vf1), _lanes(ph.transpose(1, 2), vf1))
        total = _fused_rows(pl, same) if norm else None
    else:
        s2 = (xla_sum(pl, [2], m), xla_sum(ph, [2], m))
        s1 = (xla_sum(pl, [1], m), xla_sum(ph, [1], m))
        total = xla_sum(pl, [1, 2], m) if norm else None
    return _ftz(s2[0] - s1[0]), _ftz(s2[1] + s1[1]), total


# ------------------------------------------------------------- the layout
class RankLayout:
    """What the pass reads of a query layout, built once per (groups,
    device): each document's query (``qid`` [N] int64), the boundaries
    (``bounds`` [Q+1] int32 on the device, int64 on the host), the
    padded ``[Q, M]`` gather plan of ``ranking._PaddedQueries`` (host
    ``doc_index``/``mask``, the CPU paths' layout), M, and ``by_length``
    [Q] int32 on the device: the queries longest first (ties by index),
    the kernel's block order."""

    def __init__(self, bounds: np.ndarray, doc_index: np.ndarray,
                 mask: np.ndarray, device):
        self.bounds_np = np.asarray(bounds, np.int64)
        self.num_queries = len(self.bounds_np) - 1
        self.num_data = int(self.bounds_np[-1])
        self.m = int(doc_index.shape[1])
        sizes = np.diff(self.bounds_np)
        self.qid = torch.as_tensor(
            np.repeat(np.arange(self.num_queries), sizes), device=device)
        self.device = self.qid.device          # with its index (cuda:0)
        self.bounds = torch.as_tensor(self.bounds_np.astype(np.int32),
                                      device=self.device)
        self.doc_index = torch.as_tensor(doc_index, device=self.device)
        self.mask = torch.as_tensor(mask, device=self.device)
        self.by_length = torch.as_tensor(
            np.argsort(-sizes, kind="stable").astype(np.int32),
            device=self.device)


def doc_ranks(score: torch.Tensor, layout: RankLayout
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each document's rank in its query under a stable descending sort of
    the scores (ties by index, ``argsort(argsort(-s))``), and the order:
    (rank [N] int64, order [N] int64, the documents by (query, rank)).
    One stable sort of int64 keys (query << 32 | the float's order bits of
    -score, -0 counted as +0), exact on every device."""
    neg = -(score.to(torch.float32) + 0.0)
    b = neg.view(torch.int32).to(torch.int64)
    key = torch.where(b >= 0, b + 2 ** 31, -1 - b)      # uint32 order
    order = torch.sort((layout.qid << 32) | key, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=order.device)
    rank = pos - layout.bounds.to(torch.int64)[layout.qid]
    return rank, order


def discounts(rank: torch.Tensor) -> torch.Tensor:
    """``1 / log2(2 + rank)`` in float32 (JAX ranking.py:174)."""
    return _ftz(1.0 / log2_f32(2.0 + rank.to(torch.float32)))


def _preamble(score: torch.Tensor, layout: RankLayout):
    """What every path computes first: (rank, order, discount, same) --
    ``same`` [Q]: the query's best score equals its worst (JAX
    ranking.py:177-181, the padded slots' -1e30 in the max and +1e30 in the
    min), which skips the ``lambdarank_norm`` division."""
    rank, order = doc_ranks(score, layout)
    q = layout.num_queries
    best = torch.full((q,), PAD_SCORE, dtype=torch.float32,
                      device=score.device)
    best = best.scatter_reduce(0, layout.qid, score, "amax")
    worst = torch.full((q,), -PAD_SCORE, dtype=torch.float32,
                       device=score.device)
    worst = worst.scatter_reduce(0, layout.qid, score, "amin")
    return rank, order, discounts(rank), best == worst


def _pair_terms(s_i, s_j, l_i, l_j, g_i, g_j, d_i, d_j, ok, inv, same,
                sigmoid: float, norm: bool):
    """The lambda and hessian of pairs (i higher label, j lower) where
    ``ok``, +0 elsewhere: JAX ranking.py:196-214, each operation flushed
    to zero as XLA:CPU does. Arguments broadcast."""
    sig = _c32(sigmoid)
    ds = _ftz(s_i - s_j)
    dn = _ftz(_ftz(_ftz(g_i - g_j) * torch.abs(_ftz(d_i - d_j))) * inv)
    if norm:
        dn = torch.where(same | ~ok, dn,
                         _ftz(dn / (_c32(0.01) + torch.abs(ds))))
    p = sigmoid_f32(_ftz(-sig * ds))
    ph = _ftz(p * (1.0 - p))
    lam = torch.where(ok, _ftz(_ftz(-sig * dn) * p), 0.0)
    hess = torch.where(ok, _ftz(_ftz(_c32(sig * sig) * dn) * ph), 0.0)
    return lam, hess


def _padded(x: torch.Tensor, layout: RankLayout, rows, e: int, fill=0.0):
    """[N] per-document values -> [rows, e] padded (the first e slots of
    the [Q, M] layout), for a chunk of queries."""
    idx, mask = layout.doc_index[rows, :e], layout.mask[rows, :e]
    return torch.where(mask, x[idx], torch.full_like(x[idx], fill))


def _chunks(layout: RankLayout, cost, budget: int, extent=None):
    """Chunks of queries in ascending size order, each (query indices,
    extent e: the chunk's longest query, or ``extent``): a chunk's sizes
    lie within a factor of 2 (it pads only to its own longest query) and
    len(chunk) * cost(e) <= ``budget`` (one query at least)."""
    sizes = np.maximum(np.diff(layout.bounds_np), 1)
    order = np.argsort(sizes, kind="stable")
    i, q = 0, len(order)
    while i < q:
        j = i
        while (j + 1 < q and sizes[order[j + 1]] <= 2 * sizes[order[i]]
               and (j + 2 - i) * cost(extent or int(sizes[order[j + 1]]))
               <= budget):
            j += 1
        yield (torch.as_tensor(order[i:j + 1], device=layout.device),
               extent or int(sizes[order[j]]))
        i = j + 1


def _normalise(lam, hess, sum_high, qid, norm: bool):
    """``S = -2 * sum_high`` per query and, with ``lambdarank_norm``, the
    ``log2(1 + S) / S`` factor (JAX ranking.py:216-223); then the scatter's
    ``0 + value`` (JAX ``_scatter_grads``)."""
    if norm:
        s = _ftz(-2.0 * sum_high)
        nf = torch.where(
            s > 0, _ftz(log2_f32(_ftz(1.0 + s))
                        / torch.clamp(s, min=_c32(K_EPSILON))),
            torch.ones_like(s))[qid]
        lam, hess = _ftz(lam * nf), _ftz(hess * nf)
    return lam + 0.0, hess + 0.0


def _chunk_pairs(score, label, gain, rank, disc, same, inv_max_dcg,
                 layout: RankLayout, rows, e: int, sigmoid: float,
                 trunc: int, norm: bool):
    """A chunk's [Qc, e, e] pair tensors, i the higher label and j the
    lower: (mask [Qc, e], ok, lambda, hessian); +0 where not ok."""
    mask = layout.mask[rows, :e]
    s = _padded(score, layout, rows, e, PAD_SCORE)
    lab = _padded(label, layout, rows, e)
    g = _padded(gain, layout, rows, e)
    d = _padded(disc, layout, rows, e)
    r = _padded(rank, layout, rows, e)
    ok = (mask[:, :, None] & mask[:, None, :]
          & (lab[:, :, None] > lab[:, None, :])
          & (torch.minimum(r[:, :, None], r[:, None, :]) < trunc))
    pl, ph = _pair_terms(
        s[:, :, None], s[:, None, :], lab[:, :, None], lab[:, None, :],
        g[:, :, None], g[:, None, :], d[:, :, None], d[:, None, :], ok,
        inv_max_dcg[rows, None, None], same[rows, None, None], sigmoid, norm)
    return mask, ok, pl, ph


def lambdarank_grads_plain(score, label, gain, inv_max_dcg,
                           layout: RankLayout, sigmoid: float, trunc: int,
                           norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the JAX arithmetic: per chunk of queries the masked
    ``[Q, M, M]`` pair tensors, then ``sum(axis=2) - sum(axis=1)``,
    ``sum(axis=2) + sum(axis=1)`` and the lambda sum over ``(1, 2)`` in
    XLA:CPU's order (``pair_sums``); from M = 40 a chunk's tensors reach
    only its longest query (the rest of M is zeros, whose windows sum to
    +0). [N] lambdas and hessians."""
    rank, _, disc, same = _preamble(score, layout)
    lam = torch.zeros((layout.num_data,), dtype=torch.float32,
                      device=score.device)
    hess = torch.zeros_like(lam)
    sum_high = torch.zeros((layout.num_queries,), dtype=torch.float32,
                           device=score.device)
    fused = layout.m <= _WINDOW             # XLA's order needs all of M
    for rows, e in _chunks(layout, lambda e: e * e, 1 << 26,
                           layout.m if fused else None):
        mask, _, pl, ph = _chunk_pairs(score, label, gain, rank, disc, same,
                                       inv_max_dcg, layout, rows, e, sigmoid,
                                       trunc, norm)
        lq, hq, total = pair_sums(pl, ph, same[rows], norm, layout.m)
        if norm:
            sum_high[rows] = total
        idx = layout.doc_index[rows, :e][mask]
        lam[idx], hess[idx] = lq[mask], hq[mask]
    return _normalise(lam, hess, sum_high, layout.qid, norm)


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The lanes of the last dimension (32) combined as the kernel's warp
    does: v + v[lane ^ m] for m = 16, 8, 4, 2, 1; lane 0's value."""
    lane = torch.arange(_LANES, device=v.device)
    for m in (16, 8, 4, 2, 1):
        v = _ftz(v + v[..., lane ^ m])
    return v[..., 0]


def _lane_sums(ok: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """[Qc, e, e] terms where ``ok`` summed over the last dimension as a
    warp's lanes sum them: lane l adds partners l, l + 32, ... in order
    from +0, then the butterfly. [Qc, e]."""
    acc = torch.zeros(term.shape[:-1] + (_LANES,), dtype=term.dtype,
                      device=term.device)
    e = term.shape[-1]
    for k0 in range(0, e, _LANES):
        w = min(_LANES, e - k0)
        part = acc[..., :w]
        acc[..., :w] = torch.where(ok[..., k0:k0 + w],
                                   _ftz(part + term[..., k0:k0 + w]), part)
    return _butterfly(acc)


def _seq_sums(ok: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """[Qc, e, e] terms where ``ok`` summed over the last dimension one
    after another in order from +0. [Qc, e]."""
    acc = torch.zeros_like(term[..., 0])
    for k in range(term.shape[-1]):
        acc = torch.where(ok[..., k], _ftz(acc + term[..., k]), acc)
    return acc


def _block_sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[Qc, e] summed as the kernel's block sums a query's higher lambdas:
    thread t adds documents t, t + _THREADS, ... (where ``mask``) in order
    from +0, then the threads' sums as a halving tree (t += t + s for s =
    _THREADS / 2, ..., 1). [Qc]."""
    acc = x.new_zeros(x.shape[:-1] + (_THREADS,))
    e = x.shape[-1]
    for k0 in range(0, e, _THREADS):
        w = min(_THREADS, e - k0)
        part = acc[..., :w]
        acc[..., :w] = torch.where(mask[..., k0:k0 + w],
                                   _ftz(part + x[..., k0:k0 + w]), part)
    s = _THREADS // 2
    while s:
        acc = torch.cat([_ftz(acc[..., :s] + acc[..., s:2 * s]),
                         acc[..., s:]], dim=-1)
        s //= 2
    return acc[..., 0]


def lambdarank_grads_exact(score, label, gain, inv_max_dcg,
                           layout: RankLayout, sigmoid: float, trunc: int,
                           norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version in the kernel's order: for each document its terms as
    the higher label and as the lower label summed apart (only the pairs
    the truncation admits) -- a document ranked above the truncation level
    in 32 lanes over its partners in ascending index, the lanes combined
    by the warp's butterfly; any other over the top list in ascending
    index one after another -- then higher - lower (hessians: +); the
    query's lambda sum by the block's strided sums and halving tree. [N]
    lambdas and hessians, bitwise the kernel's."""
    rank, _, disc, same = _preamble(score, layout)
    lam = torch.zeros((layout.num_data,), dtype=torch.float32,
                      device=score.device)
    hess = torch.zeros_like(lam)
    sum_high = torch.zeros((layout.num_queries,), dtype=torch.float32,
                           device=score.device)
    for rows, e in _chunks(layout, lambda e: e * e, 1 << 26):
        mask, ok, pl, ph = _chunk_pairs(score, label, gain, rank, disc,
                                        same, inv_max_dcg, layout, rows, e,
                                        sigmoid, trunc, norm)
        # [:, d, k]: d higher and partner k lower (okt: k higher, d lower)
        okt, plt, pht = (t.transpose(1, 2) for t in (ok, pl, ph))
        top = _padded(rank, layout, rows, e) < trunc
        sums = []
        for o, term in ((ok, pl), (ok, ph), (okt, plt), (okt, pht)):
            sums.append(torch.where(top, _lane_sums(o, term),
                                    _seq_sums(o, term)))
        hl, hh, ll, lh = sums
        sum_high[rows] = _block_sum(hl, mask)
        idx = layout.doc_index[rows, :e][mask]
        lam[idx] = _ftz(hl - ll)[mask]
        hess[idx] = _ftz(hh + lh)[mask]
    return _normalise(lam, hess, sum_high, layout.qid, norm)


def _top_docs(order: torch.Tensor, layout: RankLayout,
              trunc: int) -> Tuple[torch.Tensor, int]:
    """[Q, T] int32, T = min(trunc, M): each query's documents ranked above
    the truncation level, in ascending index order, padded with N."""
    t = max(1, min(trunc, layout.m))
    q = layout.num_queries
    dev = order.device
    b = layout.bounds.to(torch.int64)
    pos = b[:-1, None] + torch.arange(t, device=dev)[None, :]
    real = pos < b[1:, None]
    top = torch.where(real, order[pos.clamp(max=max(layout.num_data - 1, 0))],
                      torch.full_like(pos, layout.num_data))
    top = torch.sort(top, dim=1).values
    return top.to(torch.int32).reshape(q, t).contiguous(), t


def lambdarank_grads(score: torch.Tensor, label: torch.Tensor,
                     gain: torch.Tensor, inv_max_dcg: torch.Tensor,
                     layout: RankLayout, sigmoid: float, trunc: int,
                     norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lambdas and hessians of every document (before document weights):
    ``score``, ``label``, ``gain`` [N] float32 in document order,
    ``inv_max_dcg`` [Q] float32. On a CUDA tensor it launches
    ``csrc/lambdarank.cu`` (and counts the launch) or raises; on a CPU
    tensor it runs ``lambdarank_grads_plain``, or inside
    ``cuda_hist.kernel_sums_on_cpu()`` ``lambdarank_grads_exact``."""
    dev = score.device
    n, q = layout.num_data, layout.num_queries
    for name, t, dt, shape in (("score", score, torch.float32, (n,)),
                               ("label", label, torch.float32, (n,)),
                               ("gain", gain, torch.float32, (n,)),
                               ("inv_max_dcg", inv_max_dcg, torch.float32,
                                (q,))):
        _check(t.device == dev and layout.device == dev,
               f"lambdarank_grads: {name} on {t.device}, layout on "
               f"{layout.device}, score on {dev}")
        _check(t.dtype == dt, f"lambdarank_grads: {name} must be {dt}")
        _check(tuple(t.shape) == shape,
               f"lambdarank_grads: {name} {tuple(t.shape)} != {shape}")
        _check(t.is_contiguous(), f"lambdarank_grads: {name} not "
               f"contiguous")
    if dev.type == "cpu":
        fn = (lambdarank_grads_exact if cuda_hist.kernel_sums_active()
              else lambdarank_grads_plain)
        return fn(score, label, gain, inv_max_dcg, layout, sigmoid, trunc,
                  norm)
    _check(dev.type == "cuda", f"lambdarank_grads: no kernel for device "
           f"{dev}")
    rank, order, disc, same = _preamble(score, layout)
    top, t = _top_docs(order, layout, trunc)
    lam = torch.empty((n,), dtype=torch.float32, device=dev)
    hess = torch.empty_like(lam)
    sum_high = torch.empty((q,), dtype=torch.float32, device=dev)
    high = torch.empty_like(lam)     # scratch: each document's higher sum
    part = torch.empty((4, n), dtype=torch.float32, device=dev)  # scratch
    rank32, same32 = rank.to(torch.int32), same.to(torch.int32)
    err = _lib("lambdarank").lambdarank_launch(
        _ptr(score), _ptr(label), _ptr(gain), _ptr(disc), _ptr(rank32),
        _ptr(layout.bounds), _ptr(layout.by_length), _ptr(top),
        _ptr(inv_max_dcg), _ptr(same32), q,
        t, int(trunc), float(_c32(sigmoid)), int(bool(norm)), _ptr(lam),
        _ptr(hess), _ptr(high), _ptr(part), _ptr(sum_high), _THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_hist._count(lambdarank_grads, "launches")
    _raise_on(err, "lambdarank_grads")
    return _normalise(lam, hess, sum_high, layout.qid, norm)


cuda_hist.register_counters(lambdarank_grads, ("launches",))
