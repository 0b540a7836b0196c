"""Double-word float32 ("df64") arithmetic: ~49-bit-mantissa reals built
from pairs of f32, giving float64-grade spectral accuracy without float64
execution (``config.hp_impl="emulate"``).

Every value is (hi, lo) with hi = fl(hi+lo) and |lo| <= ulp(hi)/2.  The
primitives are the classical error-free transformations (Knuth TwoSum; a
float32 TwoProduct built from exact partial products, see
:func:`two_prod`) and are exact in IEEE f32 arithmetic; XLA does not
reassociate floating-point ops, so the sequences survive compilation.

FMA contraction is the one rewrite that can break such sequences: XLA:CPU
lets LLVM contract multiplies into their consumers (and GPU code
generators may do the same).  :func:`split` and :func:`two_prod` therefore
never rely on a product being rounded: in float32 every product they form
is exact, so a contracted and an uncontracted program compute the same
values.

Used by :mod:`.df64_fft`, :mod:`.int8_dft` and :mod:`.hp` for the
emulated high-precision path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# significand masks of split(): float32 keeps 11 of its 23 stored bits
# (12 + 12-bit halves), float64 26 of its 52 (27 + 26-bit halves)
_MASKS = {4: (jnp.uint32, np.uint32(0xFFFFF000)),
          8: (jnp.uint64, np.uint64(0xFFFFFFFFFC000000))}


def two_sum(a, b):
    """Error-free a+b: returns (s, e) with s+e == a+b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free a+b assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Split into halves by masking the significand: (hi, lo) with
    hi + lo == a, both exact, and no product rounded on the way (so no
    compiler rewrite can perturb it).

    float32 halves carry 12 bits each, so their pairwise products are
    exact.  float64 (the planes of the native hp mode) splits 27 + 26
    bits; a product of two 27-bit halves may round in its last bit, which
    leaves float64 accuracy, all that mode needs.
    """
    a = jnp.asarray(a)
    utype, mask = _MASKS[a.dtype.itemsize]
    bits = jax.lax.bitcast_convert_type(a, utype)
    hi = jax.lax.bitcast_convert_type(bits & mask, a.dtype)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a*b: returns (p, e) with p == fl(a*b) and p+e == a*b
    (float32; float64 to float64 accuracy, see :func:`split`).

    p is formed from the four partial products of the split halves, each
    exact, summed with error-free additions, and ``a*b`` itself is never
    multiplied: a compiler that contracts a rounded ``a*b`` into its
    consumers as an unrounded FMA operand (XLA:CPU's LLVM backend does)
    would otherwise pair an exact product with a rounded one and lose
    ``e``.  Contracting any product formed here changes nothing, since
    every one of them is exact.
    """
    ah, al = split(a)
    bh, bl = split(b)
    hh, hl, lh, ll = ah * bh, ah * bl, al * bh, al * bl
    s, e1 = two_sum(hh, hl)
    s, e2 = two_sum(s, lh)
    s, e3 = two_sum(s, ll)
    p = s + (e1 + (e2 + e3))
    e = ((hh - p) + hl + lh) + ll
    return p, e


def add(xh, xl, yh, yl):
    """df64 + df64."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def mul(xh, xl, yh, yl):
    """df64 * df64."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def mul_f32(xh, xl, y):
    """df64 * f32."""
    p, e = two_prod(xh, y)
    e = e + xl * y
    return quick_two_sum(p, e)


def neg(xh, xl):
    return -xh, -xl


# -- complex df64: (re_hi, re_lo, im_hi, im_lo) -----------------------------


def cmul(a, b):
    """Complex df64 multiply of 4-tuples."""
    arh, arl, aih, ail = a
    brh, brl, bih, bil = b
    rr = add(*mul(arh, arl, brh, brl), *neg(*mul(aih, ail, bih, bil)))
    ii = add(*mul(arh, arl, bih, bil), *mul(aih, ail, brh, brl))
    return (*rr, *ii)


def cadd(a, b):
    arh, arl, aih, ail = a
    brh, brl, bih, bil = b
    return (*add(arh, arl, brh, brl), *add(aih, ail, bih, bil))


# -- host conversion --------------------------------------------------------


def split_f64_np(x64: np.ndarray):
    """Split host float64 into (hi, lo) float32 numpy pair."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_np(hi, lo) -> np.ndarray:
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
