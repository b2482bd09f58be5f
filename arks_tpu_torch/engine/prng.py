"""Threefry-2x32 random numbers on torch integer tensors: the part of
``jax.random`` the sampler uses, bit for bit, so that a seeded request
draws the same tokens as on the reference engine.

What is ported is the mode the reference runs in: ``jax.random`` with
``jax_threefry_partitionable`` on (the default of the installed JAX) and
the "low" Gumbel mode of ``categorical``.  A key is two 32-bit words; a
batch of keys is a ``[..., 2]`` tensor.  The words are held in
``torch.int64`` and masked to 32 bits after every add and shift, so the
integer path is exact, and the same, on the CPU and on CUDA.

- ``threefry2x32``: the 20-round hash (``jax/_src/prng.py``
  ``_threefry2x32_lowering``).
- ``split(key, n)``: hashes the counter pairs (0, i), i < n
  (partitionable ``_threefry_split_foldlike``); ``fold_in(key, d)``
  hashes (0, d) (``_threefry_fold_in``); ``random_bits(key, n)`` hashes
  (0, i) and returns the xor of the two output words
  (``_threefry_random_bits_partitionable``).
- ``uniform``: the top 23 bits fill the mantissa of a float in [1, 2),
  minus 1, scaled, then floored at ``minval`` (``random._uniform``).
- ``gumbel``: -log(-log(uniform(tiny, 1))); ``categorical`` is the
  argmax of logits + Gumbel noise over the last axis.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def np_prng_key(seed: int) -> np.ndarray:
    """Host-side ``jax.random.PRNGKey(seed)`` for the threefry impl: the
    words (0, seed mod 2**32) as uint32 [2].  Seeds outside the 32-bit
    range are MASKED, never rejected, exactly as the reference's
    ``np_prng_key`` does."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def key_tensor(key: np.ndarray, device=None) -> torch.Tensor:
    """uint32 key words (numpy, [..., 2]) -> the int64 tensor form."""
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64)).to(
        device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of counter words (x1, x2) under key words (k1, k2).
    All are int64 tensors (or ints) holding uint32 values, broadcast
    together; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash_counts(keys: torch.Tensor, lo: torch.Tensor):
    """Hash the counter pairs (0, lo) under every key: keys [..., 2],
    lo [n] -> two words [..., n]."""
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], torch.zeros_like(lo),
                        lo)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: [..., 2] -> [..., num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=keys.device)
    return torch.stack(_hash_counts(keys, lo), dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with a 32-bit ``data``."""
    # A fill, not an upload: no host copy (and no stream sync) per call.
    lo = torch.full((1,), int(data) & _MASK, dtype=torch.int64,
                    device=keys.device)
    return torch.stack(_hash_counts(keys, lo), dim=-1)[..., 0, :]


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of shape (n,) per key: [..., 2] ->
    [..., n] int64 holding uint32 values."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    y1, y2 = _hash_counts(keys, lo)
    return y1 ^ y2


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` float32 of shape (n,) per key, in
    [minval, maxval)."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=keys.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel`` float32 of shape (n,) per key ("low" mode)."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` per row: keys [B, 2], logits [B, W] f32
    -> indices [B] (int64), the argmax of logits + Gumbel noise."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
