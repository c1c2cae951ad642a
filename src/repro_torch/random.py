"""The draws of ``jax.random`` that the package makes, bit for bit, in torch.

Port of the threefry2x32 key derivation and sampling of jax 0.9
(``jax/_src/prng.py``: ``threefry_2x32``, ``threefry_seed``,
``_threefry_split_original`` / ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_original`` /
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``fold_in``, ``_uniform``, ``_randint``, ``_bernoulli``, ``_normal_real``,
``_shuffle``), for legacy keys (``jax.random.PRNGKey``) with 64-bit types
off, as the package runs.

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words, on
the device its draws are made on.  A key on the CPU hashes in numpy
uint32, which wraps by itself; a key on the card hashes on the card in
int64, each operation masked back to 32 bits, so the bits are the same
on both.  Reading a card key's words on the host would wait for the
card's queue, so a stream of small draws for the card's work keeps its
keys on the CPU and copies each draw over (the engine's minibatch
stream, the fault and participation draws).

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

:func:`normal` is float work on top of the integer draws: XLA's CPU
float32 ``erf_inv`` and ``log1p`` (:func:`_erf_inv`, :func:`_log1p`),
written one IEEE float32 operation at a time, so that the card and the
CPU give the reference's bits.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import struct

import numpy as np
import torch

from .core.quantize import fma_f32
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


def _threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter pairs ``(x0, x1)``
    under the key words ``(k1, k2)``: int64 tensors holding uint32, or
    numpy uint32 arrays (the operators are the same)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _counters(key, n: int):
    """The counters 0..n-1 of a draw from ``key``: a numpy uint32 array for
    a key on the CPU, else an int64 tensor on the key's device."""
    if key.device.type == "cpu":
        return np.arange(n, dtype=np.uint32)
    return torch.arange(n, dtype=I64, device=key.device)


def _hash(key, x0, x1) -> torch.Tensor:
    """``y0`` then ``y1`` of :func:`_threefry2x32` over counters made by
    :func:`_counters`, as one int64 tensor on the key's device."""
    if isinstance(x0, np.ndarray):
        # (1,)-shaped words, not numpy scalars: numpy 1.x promotes a
        # scalar with a Python int by other rules
        k1, k2 = (np.array([v], dtype=np.uint32) for v in key.tolist())
        y = np.concatenate(_threefry2x32(k1, k2, x0, x1)).astype(np.int64)
        return torch.from_numpy(y)
    return torch.cat(_threefry2x32(key[0], key[1], x0, x1))


def _hash_halves(key, n: int):
    """``threefry_2x32(key, arange(n))`` of the reference: the counters cut
    in two halves (an odd count padded with a zero) hashed as pairs."""
    count = _counters(key, n + n % 2)
    count[n:] = 0
    h = (n + n % 2) // 2
    return _hash(key, count[:h], count[h:])[:n]


def _hash_iota(key, n: int):
    """The partitionable layout: ``(bits1, bits2)`` of the 64-bit counters
    0..n-1, each split into a high and a low word."""
    iota = _counters(key, n)
    # numpy's uint32 counters have no high word (a draw there is < 2^32)
    hi = iota * 0 if isinstance(iota, np.ndarray) else iota >> 32
    y = _hash(key, hi, iota & _M32)
    return y[:n], y[n:]


def PRNGKey(seed: int, *, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed is taken
    as a 32-bit integer, so the key is ``(0, seed mod 2^32)``."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & _M32], dtype=I64, device=dev)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``
    (the same in both layouts)."""
    d = _counters(key, 1) * 0 + (int(data) & _M32)
    return _hash(key, d * 0, d)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys, shape ``(num, 2)``."""
    if _partitionable.get():
        b1, b2 = _hash_iota(key, num)
        return torch.stack([b1, b2], dim=-1)
    return _hash_halves(key, 2 * num).reshape(num, 2)


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
    return _hash_halves(key, n).reshape(shape)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a number in [1, 2), minus 1 (exact), then ``floats * (maxval -
    minval) + minval`` and ``max(minval, .)``, with both bounds and their
    difference rounded to float32.  The reference's ``uniform`` is jitted,
    so XLA contracts the multiply-add into one FMA; on [0, 1) it is exact
    and is skipped."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | _ONE_F32_BITS
    floats = fbits.to(torch.int32).view(F32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=F32, device=key.device)
    span = torch.tensor(maxval, dtype=F32, device=key.device) - lo
    return torch.maximum(lo, fma_f32(floats, span, lo))


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


# ---------------------------------------------------------------------------
# normal: XLA's CPU float32 erf_inv and log1p, one IEEE operation at a time
# ---------------------------------------------------------------------------

_FLT_MIN = 2.0 ** -126
_SQRT2_F32 = 1.41421354          # np.float32(np.sqrt(2)), exactly
_NORMAL_MINVAL = -(1.0 - 2.0 ** -24)   # nextafter(-1, 0) in float32


def _f32_hex(h: str) -> float:
    """A float32 constant as LLVM's IR prints it: the hex digits of the
    double that holds it."""
    return struct.unpack(">d", bytes.fromhex(h[2:]))[0]


# logf for t = 1 + x away from 0 (Cephes): mantissa in [sqrt(1/2), sqrt(2))
_LOGF_SQRTH = _f32_hex("0x3FE6A09E60000000")
_LOGF_P = tuple(_f32_hex(h) for h in (
    "0x3FB2043760000000", "0xBFBD7A3700000000", "0xBFBFCBA9E0000000",
    "0x3FC23D37E0000000", "0x3FC999D580000000", "0xBFCFFFFF80000000",
    "0x3FBDE4A340000000", "0xBFC555CA00000000", "0x3FD5555540000000"))
_LOGF_Q1 = _f32_hex("0xBF2BD01060000000")
_LOGF_Q2 = _f32_hex("0x3FE6300000000000")
# expf (Cephes): the clamps, log2(e), ln(2) in two parts, the polynomial
_EXPF_LO = _f32_hex("0xC055F33340000000")
_EXPF_HI = _f32_hex("0x4056333340000000")
_EXPF_LOG2E = _f32_hex("0x3FF7154760000000")
_EXPF_C1 = _f32_hex("0x3FE6300000000000")
_EXPF_C2 = _f32_hex("0xBF2BD01060000000")
_EXPF_P = tuple(_f32_hex(h) for h in (
    "0x3F2A0D2CE0000000", "0x3F56E879C0000000", "0x3F81112100000000",
    "0x3FA5553820000000", "0x3FC5555540000000")) + (0.5,)
# log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 * N(x) / D(x)
_LOG1P_SMALL = _f32_hex("0x3FDA8279A0000000")
_LOG1P_D = tuple(_f32_hex(h) for h in (
    "0x402E2035A0000000", "0x4054C30B60000000", "0x406BB865A0000000",
    "0x4073519460000000", "0x406B0DB140000000", "0x404E0F3040000000"))
_LOG1P_N = tuple(_f32_hex(h) for h in (
    "0x3F07BC0960000000", "0x3FDFE818A0000000", "0x401A509F40000000",
    "0x403DE97380000000", "0x404E798EC0000000", "0x404C8E75A0000000",
    "0x40340A2020000000"))
# chlo.erf_inv (Giles), float32: the branch w < 5, then w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to a zero of their sign: XLA's CPU code
    runs with denormals flushed, on its inputs and its results."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _const(x, c: float) -> torch.Tensor:
    return torch.full_like(x, c)


def xla_log(t: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` in float32 as XLA's CPU backend computes it (jax 0.9):
    the Cephes ``logf`` (exponent and mantissa split on the bits, the
    mantissa in ``[sqrt(1/2), sqrt(2))``, a degree-8 polynomial in the
    reduced mantissa).  Every ``fmul`` whose one use is an ``fadd`` is
    contracted to an FMA by LLVM's code generator; the rest are single
    float32 operations, in the order of XLA's IR.  ``t <= 0`` or NaN gives
    NaN (all bits set), 0 (and a subnormal, flushed) gives -inf, +inf
    gives +inf."""
    t = _ftz(t)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    tm = torch.where(t > _FLT_MIN, t, _const(t, _FLT_MIN))
    bits = tm.view(torch.int32)
    e = ((bits >> 23) - 127).to(F32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(F32)     # [0.5, 1)
    low = m < _LOGF_SQRTH
    r = (m - 1.0) + torch.where(low, m, zero)
    e = e - torch.where(low, one, zero)
    z = r * r
    r3 = z * r
    P = _LOGF_P
    a = fma_f32(fma_f32(r, P[0], P[1]), r, P[6])
    b = fma_f32(fma_f32(r, P[2], P[3]), r, P[7])
    c = fma_f32(fma_f32(r, P[4], P[5]), r, P[8])
    poly = fma_f32(fma_f32(fma_f32(a, r3, b), r3, c), r3, e * _LOGF_Q1)
    big = fma_f32(e, _LOGF_Q2, (r - z * 0.5) + poly)
    out = big.view(torch.int32)
    izero = torch.zeros_like(out)
    finite_t = (t != 0) & (t != math.inf)
    special = torch.where(t != 0,
                          torch.where(t != math.inf, izero,
                                      _const(out, 0x7F800000)),
                          _const(out, -0x800000))
    out = torch.where(t > 0, out, _const(out, -1))
    return (special | torch.where(finite_t, out, izero)).view(F32)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` in float32 as XLA's CPU backend computes it (jax 0.9),
    read off its IR: ``x`` clamped to ``[-87.8, 88.7]``, ``n =
    floor(x log2(e) + 1/2)`` clamped to ``[-127, 127]``, ``r = x - n
    ln(2)`` in two steps (Cody-Waite), a degree-5 polynomial in ``r``,
    ``1 + r + r^2 p(r)``, times ``2^n`` built on the bits.  The FMAs are
    LLVM's contractions, as in :func:`xla_log`; NaN passes through the
    clamps.  Subnormal inputs and results are flushed to zero (XLA's CPU
    code runs with denormals off)."""
    x = _ftz(x)
    x = torch.where(x < _EXPF_LO, _const(x, _EXPF_LO), x)
    x = torch.where(x > _EXPF_HI, _const(x, _EXPF_HI), x)
    n = torch.floor(fma_f32(x, _EXPF_LOG2E, 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma_f32(-n, _EXPF_C1, x)
    r = fma_f32(-n, _EXPF_C2, r)
    y = fma_f32(r, _EXPF_P[0], _EXPF_P[1])
    for k in _EXPF_P[2:]:
        y = fma_f32(y, r, k)
    y = fma_f32(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(F32)
    return _ftz(y * scale)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` in float32 as XLA's CPU backend computes it (jax 0.9).

    Two branches, both computed and one selected by ``|x| < sqrt(2) - 1``:
    a rational ``x - x^2/2 + x^3 N(x) / D(x)`` near 0, and otherwise
    :func:`xla_log` of ``1 + x``.  Subnormal inputs are flushed to zero
    first."""
    x = _ftz(x)
    big = xla_log(x + 1.0)
    # --- near 0 ---
    x2 = x * x
    x0 = x * 0.0
    d = x0 + 1.0
    for k in _LOG1P_D:
        d = fma_f32(d, x, k)
    n = x0 + _LOG1P_N[0]
    for k in _LOG1P_N[1:]:
        n = fma_f32(n, x, k)
    small = x + fma_f32(x2, -0.5, (x * x2) * (n / d))
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


def _sqrt_f32(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on either device: the float64 sqrt
    rounded once (53 >= 2 * 24 + 2 bits, so that rounding is exact)."""
    return w.double().sqrt().to(F32)


def _erf_inv(v: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` in float32 as ``chlo.erf_inv`` lowers on XLA's CPU
    backend: ``w = -log1p(-v^2)``; at ``w < 5`` the polynomial in ``w -
    2.5``, else in ``sqrt(w) - 3``, nine coefficients in Horner steps that
    are each one FMA; ``v * p``, and ``+-inf`` at ``|v| == 1``."""
    v = _ftz(v)
    lw = _log1p(_ftz(v * (-v)))          # -w
    lt5 = lw > -5.0
    t = torch.where(lt5, -2.5 - lw, _sqrt_f32(-lw) - 3.0)
    p = torch.where(lt5, _const(v, _ERFINV_LT5[0]), _const(v, _ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma_f32(p, t, torch.where(lt5, _const(v, a), _const(v, b)))
    p = torch.where(v.abs() == 1.0, _const(v, math.inf), p)
    return _ftz(v * p)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform on ``[nextafter(-1, 0), 1)`` (``_normal_real``).  The bits are
    the jitted reference's on XLA's CPU backend, and the same on the card:
    the work is float32 ``mul``, ``add`` and ``where``, FMAs through
    :func:`~repro_torch.core.quantize.fma_f32`, and a float64 sqrt."""
    u = uniform(key, shape, minval=_NORMAL_MINVAL, maxval=1.0)
    return _ftz(_erf_inv(u) * _SQRT2_F32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int64) shuffled as
    ``_shuffle`` does, in ``ceil(3 ln n / ln(2^32 - 1))`` rounds (one up to
    n = 1625, two past it).  Each round splits the key, draws 32 random
    bits per element from the new subkey and sorts by them.

    The sort here is stable.  The reference's ``lax.sort_key_val`` is not
    asked to be: where two 32-bit keys tie (probability about 4e-5 at n =
    600), XLA's CPU sort may put the pair in either order, and the two
    permutations can differ there."""
    n = int(n)
    x = torch.arange(n, dtype=I64, device=key.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M32))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
