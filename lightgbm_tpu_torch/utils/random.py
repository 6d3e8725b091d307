"""The JAX package's random numbers, bit for bit, in plain torch.

The quantized-gradient mode rounds each gradient stochastically with
``u = jax.random.uniform(fold_in(key, 0x5138), [N, 3])``; a q8 tree can
match the JAX package's only if the port draws the same ``u``. This module
reproduces the ``jax.random`` calls the port needs under JAX's
defaults (the ``threefry2x32`` generator with
``jax_threefry_partitionable=True``, 32-bit integers):

- ``prng_key(seed)``: ``jax.random.PRNGKey(seed)``, the pair
  ``(0, seed mod 2^32)``;
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data mod 2^32))``;
- ``uniform(key, shape)``: float32 in [0, 1). Element i of the flattened
  shape hashes the counter pair ``(i >> 32, i mod 2^32)``; its 32 random
  bits are the XOR of the two output words, the top 23 become the
  mantissa of a float in [1, 2), and 1 is subtracted. With
  ``dtype=torch.float64`` it is the draw JAX makes with x64 on (the
  ``gpu_use_dp`` runs): 64 random bits, the first output word high and
  the second low, whose top 52 become a double's mantissa;
- ``bits(key, shape)``: ``jax.random.bits(key, shape, uint32)``, the same
  32 random bits of each element, whole (the bagging subset's and GOSS's
  draws).

``stable_argsort`` is ``jnp.argsort``'s stable sort of such values (torch
sorts them as int64) and ``stable_ranks`` its inverse permutation, each
element's position in that sort.

A key is an int64 tensor of two entries, each a uint32 value. The hash
runs on int64 tensors with 32-bit masks (torch's uint32 arithmetic is
thin), with the same integer ops on the CPU and the card, so both give the
same bits. There is no global generator: every draw takes its key.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Device = Union[str, torch.device, None]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2): int64 tensors of uint32 values in and out."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ _PARITY) & _M32)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int, device: Device = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds: the high word is 0)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: a new key."""
    k1, k2 = (int(v) for v in key.tolist())
    c = torch.tensor([0, int(data) & _M32], dtype=torch.int64,
                     device=key.device)
    y1, y2 = threefry2x32(k1, k2, c[:1], c[1:])
    return torch.cat([y1, y2])


def _counter_words(key: torch.Tensor, shape: Sequence[int],
                   device: Device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two words threefry2x32 gives for each element's counter pair
    (int64 of uint32 values, flattened)."""
    k1, k2 = (int(v) for v in key.tolist())
    count = torch.arange(int(torch.Size(shape).numel()), dtype=torch.int64,
                         device=key.device if device is None else device)
    return threefry2x32(k1, k2, count >> 32, count & _M32)


def _counter_bits(key: torch.Tensor, shape: Sequence[int],
                  device: Device) -> torch.Tensor:
    """The 32 random bits of each element of ``shape`` (int64 of uint32
    values, flattened): the XOR of the two words."""
    y1, y2 = _counter_words(key, shape, device)
    return y1 ^ y2


def uniform(key: torch.Tensor, shape: Sequence[int],
            device: Device = None,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), on
    ``device`` (default: the key's); ``dtype=torch.float64``: the float64
    draw of JAX with x64 on."""
    if dtype == torch.float64:
        y1, y2 = _counter_words(key, shape, device)
        mant = (y1 << 20) | (y2 >> 12)          # the top 52 of 64 bits
        return (mant | 0x3FF0000000000000).view(torch.float64).reshape(
            tuple(shape)) - 1.0
    bits_ = (_counter_bits(key, shape, device) >> 9) | 0x3F800000
    return bits_.to(torch.int32).view(torch.float32).reshape(tuple(shape)) \
        - 1.0


def bits(key: torch.Tensor, shape: Sequence[int],
         device: Device = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32), on ``device`` (default: the key's)."""
    return _counter_bits(key, shape, device).reshape(tuple(shape))


def stable_argsort(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort`` of a 1-D integer tensor: ascending, equal values in
    index order (int64 indices)."""
    return torch.argsort(x.to(torch.int64), stable=True)


def stable_ranks(x: torch.Tensor) -> torch.Tensor:
    """``argsort(argsort(x))``: each element's position in the stable
    ascending sort of ``x`` (int64)."""
    order = stable_argsort(x)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], device=order.device)
    return ranks
