"""The parts of ``jax.random`` the package draws from, bit for bit.

A port of JAX's default PRNG as jax 0.9.0 configures it
(``jax_default_prng_impl = "threefry2x32"``,
``jax_threefry_partitionable = True``): :func:`PRNGKey`, :func:`fold_in`,
:func:`split`, :func:`random_bits`, :func:`uniform` and :func:`normal`.
The same key gives the same bits as ``jax.random``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(JAX's ``key_data``). Leading axes batch keys: :func:`fold_in` of one
key with a tensor of M ids gives M keys in one set of elementwise ops,
and every draw from a batch of keys has the batch axes in front.

The words ride in int64 because PyTorch has no uint32 arithmetic on the
CPU: every sum is masked back to 32 bits and each rotation is two shifts
and an or. Results land on the key's device, which :func:`PRNGKey` takes
under the package's device rule.

``uniform`` is integer and bit arithmetic, so it matches JAX exactly.
``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's own ``erf_inv``
polynomials (one for f32, three pieces for f64) in XLA's order of
operations, on PyTorch's ``log1p`` and ``sqrt``; where the log differs
from XLA's by an ulp the draw can differ by a few ulps, a bound
``tests/test_torch_random.py`` states and holds.
"""
from __future__ import annotations

import math

import torch

from .device import resolve_device

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: elements per pass of a large draw: bounds the int64 temporaries
CHUNK = 1 << 24


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Random123), on uint32 words held in
    int64 tensors that broadcast against each other. Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def PRNGKey(seed: int, *, x64: bool = True, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s ``key_data`` as a (2,) int64 tensor.

    With ``x64`` (JAX's ``jax_enable_x64``) the seed is an int64 whose
    high and low words make the key; without it JAX wraps the seed to
    int32 first and the high word is 0. ``device=None`` means CUDA (and
    raises without it); every draw from the key lands on its device.
    """
    seed = int(seed)
    if x64:
        if not -(1 << 63) <= seed < (1 << 63):
            raise OverflowError(f"seed {seed} does not fit in int64")
        hi, lo = (seed >> 32) & MASK32, seed & MASK32
    else:
        hi, lo = 0, seed & MASK32
    return torch.tensor([hi, lo], dtype=torch.int64,
                        device=resolve_device(device))


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, shaped to broadcast against ``ndim`` trailing
    axes of counters."""
    pad = (1,) * ndim
    return (key[..., 0].reshape(key.shape[:-1] + pad),
            key[..., 1].reshape(key.shape[:-1] + pad))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``(..., 2)`` with ``data`` (an int or
    an integer tensor, each taken as uint32) broadcast over the batch
    axes. Returns the folded keys."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    x2 = data & MASK32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(x2),
                          x2)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _counters(start: int, n: int, device):
    """The (hi, lo) words of the linear indices ``start .. start+n-1``."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys ``(..., num, 2)``."""
    hi, lo = _counters(0, num, key.device)
    k1, k2 = _words(key, 1)
    y1, y2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack((y1, y2), dim=-1)


def _bits_flat(key, start: int, n: int, bit_width: int) -> torch.Tensor:
    """Bits of linear indices ``start .. start+n-1`` for each key."""
    hi, lo = _counters(start, n, key.device)
    k1, k2 = _words(key, 1)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        # the uint64 (b1 << 32) | b2, read as int64 (two's complement)
        return (b1 << 32) | b2
    raise ValueError("random_bits draws 32 or 64 bits")


def random_bits(key: torch.Tensor, bit_width: int = 32, shape=()):
    """``jax.random.bits``: uint32 words (in int64) or the uint64 words
    read as int64, of shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    return _bits_flat(key, 0, n, bit_width).reshape(key.shape[:-1] + shape)


def _unit_floats(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Random mantissa bits under the exponent of 1.0, minus 1: [0, 1)."""
    if dtype == torch.float32:
        fb = (bits >> 9) | 0x3F800000
        return fb.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        fb = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
        return fb.view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, not {dtype}")


def _nbits(dtype: torch.dtype) -> int:
    return 64 if dtype == torch.float64 else 32


def _draw(key, shape, dtype, fn) -> torch.Tensor:
    """``fn(unit floats)`` over ``shape`` per key, in passes of
    :data:`CHUNK` elements so that a large draw needs few temporaries."""
    shape = tuple(shape)
    n = math.prod(shape)
    batch = key.shape[:-1]
    out = torch.empty(batch + (n,), dtype=dtype, device=key.device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        u = _unit_floats(_bits_flat(key, s, e - s, _nbits(dtype)), dtype)
        out[..., s:e] = fn(u)
    return out.reshape(batch + shape)


def uniform(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: ``max(minval, u * (maxval - minval) +
    minval)`` with ``minval``/``maxval`` rounded to ``dtype`` first and the
    multiply-add rounded once, as XLA's CPU code contracts it."""
    return _draw(key, shape, dtype, _affine(dtype, minval, maxval))


def _affine(dtype, minval: float, maxval: float):
    """``u -> max(lo, fma(u, hi - lo, lo))`` in ``dtype``."""
    lo = torch.tensor(minval, dtype=dtype)
    span = float(torch.tensor(maxval, dtype=dtype) - lo)
    lo = float(lo)
    return lambda u: torch.clamp_min(_fma(u, span, lo), lo)


def _select(cond, a: float, b: float, like: torch.Tensor) -> torch.Tensor:
    """``where(cond, a, b)`` for two constants, in ``like``'s dtype."""
    return torch.where(cond, _const(a, like), _const(b, like))


def _const(c, like: torch.Tensor) -> torch.Tensor:
    """A constant as a 0-d tensor of ``like``'s dtype and device."""
    if isinstance(c, torch.Tensor):
        return c
    return torch.tensor(c, dtype=like.dtype, device=like.device)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA's CPU code contracts it; ``b``
    and ``c`` may be constants."""
    return torch.addcmul(_const(c, a), a, _const(b, a))


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    p = _fma(x, coefs[0], coefs[1])
    for c in coefs[2:]:
        p = _fma(p, x, c)
    return p


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU: Cephes' ``logf`` with its degree-8
    polynomial evaluated in three interleaved parts, for positive normal
    ``x``."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    z = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z2 = z * z
    z3 = z2 * z
    p = _LOGF_P
    y = _fma(z, p[0], p[1])
    y1 = _fma(z, p[3], p[4])
    y2 = _fma(z, p[6], p[7])
    y = _fma(y, z, p[2])
    y1 = _fma(y1, z, p[5])
    y2 = _fma(y2, z, p[8])
    y = _fma(y, z3, y1)
    y = _fma(y, z3, y2)
    y = _fma(y, z3, e * -2.12194440e-4)
    z = z - z2 * 0.5
    return (z + y) + e * 0.693359375


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log1p``: Cephes' rational approximation for
    ``|x| < sqrt(2) - 1``, else ``log(1 + x)`` (f32: XLA's own ``log``;
    f64: PyTorch's, which can differ from XLA's correctly rounded libm
    ``log`` in the last bit)."""
    x2 = x * x
    q = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    near = x + (-0.5 * x2 + (x * x2) * q)
    far = _log_f32(1.0 + x) if x.dtype == torch.float32 \
        else torch.log(1.0 + x)
    return torch.where(torch.abs(x) < 0.41421356237309504880, near, far)


def _erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles' single-precision approximation)."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    c = [_select(lt, a, b, w) for a, b in _ERFINV32]
    z = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = c[0]
    for ci in c[1:]:
        p = _fma(p, z, ci)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def _erf_inv64(x: torch.Tensor) -> torch.Tensor:
    """XLA's f64 ``erf_inv``: three pieces (w < 6.25, < 16, else) merged
    into one Horner chain of selects, in XLA's order."""
    w = -_log1p(x * -x)
    lt6 = w < 6.25
    lt16 = w < 16.0

    def coef(c1, c2, c3):
        return torch.where(lt16, _select(lt6, c1, c2, w), c3)

    z = torch.where(lt6, w - 3.125,
                    torch.sqrt(w) - _select(lt16, 3.25, 5.0, w))
    p = coef(*_ERFINV64_SHARED[0])
    for c in _ERFINV64_SHARED[1:]:
        p = _fma(p, z, coef(*c))
    for c1, c2 in _ERFINV64_MID:          # pieces 1 and 2 only
        p = torch.where(lt16, _fma(p, z, _select(lt6, c1, c2, w)), p)
    for c1 in _ERFINV64_LOW:              # piece 1 only
        p = torch.where(lt6, _fma(p, z, c1), p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` with ``u`` uniform
    on ``(nextafter(-1, 0), 1)``."""
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    to_range = _affine(dtype, lo, 1.0)
    erf_inv = _erf_inv32 if dtype == torch.float32 else _erf_inv64
    sqrt2 = float(torch.tensor(math.sqrt(2), dtype=dtype))
    return _draw(key, shape, dtype, lambda u: erf_inv(to_range(u)) * sqrt2)


# Cephes' logf polynomial and log1p rational function, as XLA's CPU
# code evaluates them
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
           -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
           2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)

# XLA's erf_inv coefficients, highest degree first; (w < 5, w >= 5) for f32
_ERFINV32 = (
    (2.81022636e-08, -0.000200214257),
    (3.43273939e-07, 0.000100950558),
    (-3.5233877e-06, 0.00134934322),
    (-4.39150654e-06, -0.00367342844),
    (0.00021858087, 0.00573950773),
    (-0.00125372503, -0.0076224613),
    (-0.00417768164, 0.00943887047),
    (0.246640727, 1.00167406),
    (1.50140941, 2.83297682),
)

# f64 (w < 6.25, 6.25 <= w < 16, w >= 16), the 17 leading coefficients
_ERFINV64_SHARED = (
    (-3.64441206401782e-21, 2.2137376921775787e-09, -2.7109920616438573e-11),
    (-1.6850591381820166e-19, 9.0756561938885391e-08,
     -2.5556418169965252e-10),
    (1.28584807152564e-18, -2.7517406297064545e-07, 1.5076572693500548e-09),
    (1.1157877678025181e-17, 1.8239629214389228e-08, -3.789465440126737e-09),
    (-1.3331716628546209e-16, 1.5027403968909828e-06, 7.61570120807834e-09),
    (2.0972767875968562e-17, -4.013867526981546e-06, -1.496002662714924e-08),
    (6.6376381343583238e-15, 2.9234449089955446e-06, 2.9147953450901081e-08),
    (-4.0545662729752069e-14, 1.2475304481671779e-05,
     -6.7711997758452339e-08),
    (-8.1519341976054722e-14, -4.7318229009055734e-05,
     2.2900482228026655e-07),
    (2.6335093153082323e-12, 6.8284851459573175e-05, -9.9298272942317e-07),
    (-1.2975133253453532e-11, 2.4031110387097894e-05, 4.5260625972231537e-06),
    (-5.4154120542946279e-11, -0.00035503752036284748,
     -1.9681778105531671e-05),
    (1.0512122733215323e-09, 0.0009532893797373805, 7.5995277030017761e-05),
    (-4.1126339803469837e-09, -0.0016882755560235047,
     -0.00021503011930044477),
    (-2.9070369957882005e-08, 0.0024914420961078508,
     -0.00013871931833623122),
    (4.2347877827932404e-07, -0.0037512085075692412, 1.0103004648645344),
    (-1.3654692000834679e-06, 0.0053709145535900636, 4.8499064014085844),
)
_ERFINV64_MID = (
    (-1.3882523362786469e-05, 1.0052589676941592),
    (0.00018673420803405714, 3.0838856104922208),
)
_ERFINV64_LOW = (-0.000740702534166267, -0.0060336708714301491,
                 0.24015818242558962, 1.6536545626831027)
