"""JAX's threefry PRNG in PyTorch, bit for bit.

The JAX package draws GOSS's sample (``_goss_impl``,
``lightgbm_tpu/boosting/gbdt.py:862``) and quantized training's
stochastic rounding (``_quantize_impl``, ``:1353``) from
``jax.random``. These three functions give the same bits as
``jax.random.PRNGKey``, ``jax.random.fold_in`` and
``jax.random.uniform`` (float32) under jax's default ``threefry2x32``
implementation with ``jax_threefry_partitionable`` on: element ``i`` of
a draw takes its bits from counter ``i`` of the flattened shape, so a
draw does not depend on the shape it is made at (``uniform(key,
(1000,))[:777]`` equals ``uniform(key, (777,))``).

A key is an int32 tensor of shape [2] holding the two uint32 words, or
a batch of keys [..., 2]: ``fold_in`` and ``uniform`` then give one
result per key, each equal to that key's own (the per-class keys of a
class-batched build draw in one call).
Torch has no full uint32 arithmetic, so the words ride in int32:
addition wraps modulo 2^32 as uint32 addition does, and a logical right
shift is an arithmetic one masked to the bits that stay. Every function
runs on the key's device with no host sync (``fold_in`` takes its data
as a Python int or as an integer device tensor), so a CUDA graph can
hold them.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

__all__ = ["prng_key", "fold_in", "random_bits", "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _i32(word: int) -> int:
    """A uint32 word as the int32 value with its bits."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return (x << d) | ((x >> (32 - d)) & ((1 << d) - 1))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (jax ``_threefry2x32_lowering``) over
    int32 words; ``x0``/``x1`` broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed)."""
    seed = int(seed)
    return torch.tensor([_i32(seed >> 32), _i32(seed)], dtype=torch.int32,
                        device=device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]
            ) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    (0, uint32(data)) under ``key``. ``data`` may be an integer tensor
    on the key's device, read there; keys [..., 2] and data broadcast
    against each other (key [2] with data [K] gives [K, 2])."""
    if isinstance(data, torch.Tensor):
        x1 = (data.to(torch.int64) & 0xFFFFFFFF).to(torch.int32)
    else:
        # a fill on the device: a host tensor copied over would sync
        x1 = torch.full((), _i32(int(data)), dtype=torch.int32,
                        device=key.device)
    x0 = torch.zeros((), dtype=torch.int32, device=key.device)
    y0, y1 = _threefry2x32(key[..., 0], key[..., 1], x0, x1)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``, uint32 words in
    int32): the xor of threefry's two output words at counter
    (i >> 32, i) for the flat index i. Keys [..., 2] give
    [..., *shape]."""
    n = math.prod(shape)
    if n >= 1 << 31:
        raise ValueError("draws of 2^31 elements or more are not "
                         "supported")
    lo = torch.arange(n, dtype=torch.int32, device=key.device)
    hi = torch.zeros((), dtype=torch.int32, device=key.device)
    b0, b1 = _threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (b0 ^ b1).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top
    23 bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    return mant.view(torch.float32) - 1.0
