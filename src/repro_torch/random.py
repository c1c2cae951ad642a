"""The draws of ``jax.random`` that the package makes, bit for bit, in torch.

Port of the threefry2x32 key derivation and sampling of jax 0.9
(``jax/_src/prng.py``: ``threefry_2x32``, ``threefry_seed``,
``_threefry_split_original`` / ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_original`` /
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``fold_in``, ``_uniform``, ``_randint``, ``_bernoulli``), for legacy keys
(``jax.random.PRNGKey``) with 64-bit types off, as the package runs.

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words, on
the device its draws are made on.  Every uint32 operation runs in int64
and is masked back to 32 bits, so the wraparound of the reference is kept
and the bits are the same on the CPU and on the card.

JAX has two layouts of the counter stream, and they give different bits
for ``split`` and every draw (``fold_in`` is the same in both):

* partitionable (``jax.threefry_partitionable(True)``, the default since
  jax 0.5): the counter of element i is the 64-bit i, split into a high
  and a low word that are hashed together;
* legacy (``threefry_partitionable(False)``): the counters 0..n-1 are cut
  in two halves that are hashed against each other (an odd count is
  padded with one zero).

:func:`threefry_partitionable` selects the layout, as its JAX namesake
does, and defaults to partitionable.  This is integer arithmetic, not a
kernel: the reference draws through XLA, not Pallas.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from .device import resolve_device

I64 = torch.int64
F32 = torch.float32
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000      # the bits of 1.0f
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1

_partitionable = contextvars.ContextVar("threefry_partitionable", default=True)


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Draw in the partitionable (``True``) or the legacy (``False``)
    layout inside the ``with`` block, as ``jax.threefry_partitionable``."""
    token = _partitionable.set(bool(flag))
    try:
        yield
    finally:
        _partitionable.reset(token)


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x0, x1)``
    under the key words ``(k1, k2)``; int64 operands holding uint32."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_halves(key, count):
    """``threefry_2x32(key, count)`` of the reference: the flat counters cut
    in two halves (an odd count padded with a zero) hashed as pairs."""
    n = count.numel()
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    h = count.numel() // 2
    y0, y1 = _threefry2x32(key[0], key[1], count[:h], count[h:])
    return torch.cat([y0, y1])[:n]


def _hash_iota(key, n: int):
    """The partitionable layout: ``(bits1, bits2)`` of the 64-bit counters
    0..n-1, each split into a high and a low word."""
    iota = torch.arange(n, dtype=I64, device=key.device)
    return _threefry2x32(key[0], key[1], iota >> 32, iota & _M32)


def PRNGKey(seed: int, *, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is taken
    as a 32-bit integer, so the key is ``(0, seed mod 2^32)``."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & _M32], dtype=I64, device=dev)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``
    (the same in both layouts)."""
    d = key.new_tensor([int(data) & _M32])
    y0, y1 = _threefry2x32(key[0], key[1], d.new_zeros(1), d)
    return torch.cat([y0, y1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys, shape ``(num, 2)``."""
    if _partitionable.get():
        b1, b2 = _hash_iota(key, num)
        return torch.stack([b1, b2], dim=-1)
    count = torch.arange(2 * num, dtype=I64, device=key.device)
    return _hash_halves(key, count).reshape(num, 2)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), the reference's
    ``_random_bits(key, 32, shape)``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    if _partitionable.get():
        b1, b2 = _hash_iota(key, n)
        return (b1 ^ b2).reshape(shape)
    if n >= _M32:
        raise NotImplementedError("the legacy layout draws fewer than 2^32 - 1 "
                                  "words from one key here")
    count = torch.arange(n, dtype=I64, device=key.device)
    return _hash_halves(key, count).reshape(shape)


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1) in float32: the top 23 bits as the
    mantissa of a number in [1, 2), minus 1 (exact)."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | _ONE_F32_BITS
    return fbits.to(torch.int32).view(F32) - 1.0


def _mul32(a, m: int):
    """``a * m`` modulo 2^32 for uint32 ``a`` (int64) and ``m``, without
    overflowing int64: ``m`` is multiplied in two 16-bit halves."""
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (a * (m & 0xFFFF) + hi) & _M32


def _clip_int32(v: int) -> int:
    return min(max(int(v), _INT32_MIN), _INT32_MAX)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32: two 32-bit draws from the two
    halves of ``split(key)`` folded through ``span = maxval - minval``
    with uint32 wraparound (``span = 1`` when ``maxval <= minval``)."""
    lo, hi = _clip_int32(minval), _clip_int32(maxval)
    k1, k2 = split(key)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = (hi - lo) & _M32 if hi > lo else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = _mul32(higher % span, mult)
    off = ((off + lower % span) & _M32) % span
    out = (off + lo) & _M32                 # int32 addition with wraparound
    return torch.where(out > _INT32_MAX, out - (1 << 32), out).to(torch.int32)


def bernoulli(key: torch.Tensor, p=0.5, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli`` (``mode="low"``): ``uniform < p`` with p in
    float32; ``shape`` defaults to p's."""
    p = torch.as_tensor(p, dtype=F32, device=key.device)
    if shape is None:
        shape = tuple(p.shape)
    return uniform(key, shape) < p
