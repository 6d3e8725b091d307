"""Float32 reductions in the JAX package's summation order.

A float sum depends on the order its terms are added in. The JAX package,
run on the CPU (the reference the port is held to bit for bit), lets XLA
choose that order; two of its reductions sit on the tree-growth path, and
the port reproduces XLA's order for both so root aggregates and split
candidates come out with the same bits:

- ``tree_sum``: XLA's CPU reduction of a long axis is a tree of 32-wide
  windows. Each level pads the axis to a multiple of 32 (half the padding
  before, half after), sums every window left to right from +0, and
  repeats on the window sums until at most 32 remain, which are summed
  left to right from +0 (``jnp.sum(stats, axis=0)``, the grower's root).
- ``blocked_cumsum``: XLA's CPU cumulative sum is a two-level scan over
  16-wide blocks: a left-to-right prefix inside each block (from +0), an
  exclusive prefix of the block totals (computed the same way, recursively
  once there are more than 16 blocks), and one add of the two
  (``jnp.cumsum`` over the bin axis in the split scan). The CUDA split
  epilogue scans in the same order.

Both run as a handful of vectorised torch ops; the sequential parts loop
over at most 32 (resp. 16) positions in Python.
"""

from __future__ import annotations

import torch

_SUM_WINDOW = 32
_SCAN_BLOCK = 16


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in XLA's CPU tree-reduction order (module doc)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > _SUM_WINDOW:
        n = x.shape[0]
        m = -(-n // _SUM_WINDOW)
        pad = m * _SUM_WINDOW - n
        lo = pad // 2
        z = x.new_zeros((1,) + tuple(x.shape[1:]))
        x = torch.cat([z.expand((lo,) + tuple(x.shape[1:])), x,
                       z.expand((pad - lo,) + tuple(x.shape[1:]))], 0)
        x = _seq_sum(x.reshape((m, _SUM_WINDOW) + tuple(x.shape[1:])), 1)
    return _seq_sum(x, 0)


def _seq_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive left-to-right prefix along the last axis, from +0."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def _blocked_scan_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _seq_scan(x)
    nb = -(-n // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - n
    if pad:
        x = torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (pad,))], -1)
    xr = x.reshape(tuple(x.shape[:-1]) + (nb, _SCAN_BLOCK))
    within = _seq_scan(xr)
    tot = _blocked_scan_last(within[..., -1])
    excl = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], -1)
    out = (within + excl[..., None]).reshape(tuple(x.shape[:-1]) + (-1,))
    return out[..., :n]


def blocked_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum over ``dim`` in XLA's CPU scan order."""
    return _blocked_scan_last(x.movedim(dim, -1)).movedim(-1, dim)
