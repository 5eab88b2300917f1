"""``jax.random``'s threefry2x32 stream in plain PyTorch.

The serve engine samples with keys folded from (engine seed, request seed,
token index) and ``jax.random.categorical``, as the JAX package's engine
does (``repro/runtime/engine.py``: ``sample_rows``).  This module gives the
same bits without JAX: 32-bit words live in int64 tensors masked to 32 bits,
so the integer results are identical on every device, and the float steps
(``uniform``, ``gumbel``) are ``jax.random``'s own bit manipulations, so
they differ only where ``log`` differs between libraries (an ulp or two).

What is covered, with the JAX source it follows (jax 0.9.0, whose
``jax_threefry_partitionable`` is on and ``jax_enable_x64`` off):

- :func:`threefry2x32`, the 20-round hash (``jax/_src/prng.py``:
  ``_threefry2x32_lowering``);
- :func:`prng_key` = ``PRNGKey(int)``: ``(0, seed mod 2^32)`` under 32-bit
  ints;
- :func:`fold_in` (``_threefry_fold_in``): ``threefry2x32(key, (0, data))``;
- :func:`random_bits`, the 32-bit bits of the partitionable layout
  (``_threefry_random_bits_partitionable``): element ``i`` of a 1-d draw
  hashes the counter ``(0, i)``, and the two output words are xor-ed;
- :func:`uniform` (``jax/_src/random.py:_uniform``), :func:`gumbel` in
  ``"low"`` mode (``_gumbel``) and :func:`categorical` with replacement
  (``argmax(logits + gumbel)``).

Every function is vectorised over rows: a key is a pair of int64 tensors of
any (broadcast) shape, and a draw of ``n`` values per key has shape
``key.shape + (n,)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[torch.Tensor, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


def _u32(x, device=None) -> torch.Tensor:
    """``x`` (int, array or tensor) as int64 words in [0, 2^32)."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Key:
    """Threefry-2x32 with 20 rounds of the counter pair ``(x0, x1)`` under
    ``key``; every argument is an int64 tensor of 32-bit words (broadcast)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` with 32-bit ints: ``(0, seed mod 2^32)``."""
    return _u32(0, device), _u32(seed, device)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)`` for every element of ``data`` (int
    tensor or array, taken mod 2^32), broadcast against the key's shape."""
    k0, _ = key
    d = _u32(data, k0.device)
    return threefry2x32(key, torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: shape
    ``key.shape + (n,)``, int64 words in [0, 2^32)."""
    k0, k1 = key
    count = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32((k0[..., None], k1[..., None]),
                          torch.zeros_like(count), count)
    return b0 ^ b1


def uniform(key: Key, n: int, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per key:
    23 random mantissa bits under the exponent of 1.0, minus 1, scaled."""
    bits = (random_bits(key, n) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (``mode="low"``) per key."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` for float32 ``logits`` of
    shape ``key.shape + (V,)``: ``argmax(logits + gumbel)`` over the last
    axis, one draw per key."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
