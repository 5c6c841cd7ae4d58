"""JAX's default random numbers and flax's parameter keys, in PyTorch.

The JAX package draws its initial weights with JAX's threefry2x32 PRNG
(``jax_threefry_partitionable`` on, JAX's default) through flax's
parameter keys.  This module computes the same draws without JAX, so the
port can start a run from the weights the JAX package draws from the
same seed:

* a key is a pair of uint32 words; ``prng_key(seed)`` is
  ``jax.random.PRNGKey(seed)``, ``fold_in`` and ``split`` are
  ``jax.random.fold_in`` / ``jax.random.split``;
* ``normal(key, shape)`` is ``jax.random.normal(key, shape, float32)``:
  random bits ``b0 ^ b1`` of threefry over the counters ``(0, i)``, 23 of
  them as a float in [-1, 1), then ``sqrt(2) * erfinv`` with XLA's
  float32 inverse error function (Giles' polynomials).  Its ``log1p`` is
  taken in float64 and rounded, so that every device draws the same
  float32 values; XLA's float32 ``log1p`` may round an ulp apart, so a
  value may be an ulp or two from JAX's (within 1e-6 at |x| < 6);
* ``uniform(key, shape, minval, maxval)`` is ``jax.random.uniform``: the
  same 23 bits as a float in [1, 2) less 1, scaled to the interval and
  held at ``minval`` from below; ``normal`` draws it on [nextafter(-1,
  0), 1);
* ``truncated_normal(key, lower, upper, shape)`` is
  ``jax.random.truncated_normal``: ``uniform`` between ``erf(lower/sqrt2)``
  and ``erf(upper/sqrt2)``, then ``sqrt(2) * erfinv``, clipped inside the
  bounds;
* ``orthogonal(key, shape)`` is flax's ``orthogonal()`` initialiser (JAX's
  ``random.orthogonal``): the QR of a normal matrix with the signs of
  ``diag(r)`` on the columns of ``q``.  Its float32 QR runs on the CPU
  and may be an ulp or so from LAPACK's in JAX (within 1e-5);
* ``flax_key(root, path)`` is the key that flax's ``make_rng('params')``
  gives a parameter: ``root`` folded once with the first four bytes of the
  SHA-1 of the scope's path names followed by the parameter's position in
  its scope (1 for the first parameter a module creates), without
  separators (flax's ``flax_fix_rng_separator`` off, its default).

Words are held in int64 tensors (values in ``[0, 2**32)``) so that the
arithmetic is exact on any device; the draws run on ``device``
(``orthogonal`` on the CPU).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
MASK = 0xFFFFFFFF
CHUNK = 1 << 18
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's ErfInv for float32: Giles, "Approximating the erfinv function"
# (2010), for w = -log(1 - x^2) below 5 and from 5 on
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                   1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                2.83297682)


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``, elementwise (on new tensors)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            high = x1 >> (32 - r)                          # x1 rotated left by r
            x1.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(high).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def _words(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64)


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry2x32(key, _words([0]), _words([data & MASK]))
    return int(y0), int(y1)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: key ``i`` enciphers the counter
    ``(0, i)``."""
    y0, y1 = threefry2x32(key, torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return tuple((int(a), int(b)) for a, b in zip(y0.tolist(), y1.tolist()))


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function on ``x`` in (-1, 1), its
    ``log1p`` rounded from float64 (the same on every device)."""
    w = -torch.log1p(-(x * x).double()).float()
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_CENTRAL, _ERFINV_TAIL):
        p = torch.where(central, a, b) + p * w
    return p * x


def _unit(key: Key, start: int, stop: int, device) -> torch.Tensor:
    """JAX's uniform float32 draws in [0, 1) for the counters
    ``start..stop-1``: 23 random bits as the mantissa of a float in [1, 2),
    less 1."""
    count = torch.arange(start, stop, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, torch.zeros_like(count), count)
    bits = y0.bitwise_xor_(y1).bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def uniform(key: Key, shape: Sequence[int], minval=0.0, maxval=1.0,
            device: Union[str, torch.device] = 'cpu', post=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``, drawn in chunks of ``CHUNK`` counters (which keeps the
    cipher's rounds in the CPU's caches); ``post``, when given, maps each
    chunk in place of a second pass."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    lo, hi = _f32(minval, device), _f32(maxval, device)
    for start in range(0, n, CHUNK):
        u = torch.maximum(lo, _unit(key, start, min(n, start + CHUNK), device)
                          * (hi - lo) + lo)
        out[start:start + CHUNK] = u if post is None else post(u)
    return out.reshape(shape)


def normal(key: Key, shape: Sequence[int], device: Union[str, torch.device] = 'cpu'
           ) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 on ``device``."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0))
    sqrt2 = _f32(math.sqrt(2.0), device)
    return uniform(key, shape, lo, 1.0, device, post=lambda u: erfinv32(u) * sqrt2)


def truncated_normal(key: Key, lower: float, upper: float, shape: Sequence[int],
                     device: Union[str, torch.device] = 'cpu') -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32
    on ``device``; the bounds' ``erf`` is rounded from float64."""
    sqrt2 = _f32(math.sqrt(2.0), device)
    lower, upper = _f32(lower, device), _f32(upper, device)
    a, b = (torch.erf((x / sqrt2).double()).float() for x in (lower, upper))
    inf = _f32(math.inf, device)
    lo, hi = torch.nextafter(lower, inf), torch.nextafter(upper, -inf)
    return uniform(key, shape, a, b, device,
                   post=lambda u: torch.clamp(sqrt2 * erfinv32(u), lo, hi))


def orthogonal(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """flax's ``initializers.orthogonal()`` (scale 1, columns on the last
    axis) of ``shape``, in float32 on the CPU."""
    cols = shape[-1]
    rows = math.prod(shape) // cols
    z = normal(key, (max(rows, cols), min(rows, cols)))
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return q.reshape(shape)


def flax_key(root: Key, path: Sequence[Union[str, int]]) -> Key:
    """The key flax folds for ``path``: scope names, then the parameter's
    1-based position among the parameters its scope creates."""
    digest = hashlib.sha1()
    for part in path:
        if isinstance(part, str):
            digest.update(part.encode('utf-8'))
        else:
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, 'big'))
    return fold_in(root, int.from_bytes(digest.digest()[:4], 'big'))
