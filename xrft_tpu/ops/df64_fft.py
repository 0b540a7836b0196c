"""Float64-emulated FFT: double-word (two-float32) DFT.

A float32 dot accumulates in float32, so no matmul formulation of the DFT
beats ~1e-7 relative error; reaching the 1e-10 accuracy contract without
float64 arithmetic needs compensated (error-free) arithmetic.  This module
implements the DFT in complex df64 (see :mod:`.df64`):

  * a direct DFT over the last axis (``_df64_dft_last``) that contracts
    against a df64 DFT matrix with error-free rank-1 updates in a
    ``lax.fori_loop``;
  * a four-step recursion (``df64_fft_nd``) with df64 twiddle multiplies,
    so any factorable size composes from direct stages of at most
    ``_DIRECT_MAX`` points.

It serves ``config.hp_impl="emulate"`` and the eager ``fft64``/``ifft64``
fallback for sizes the int8-limb engine cannot factor; with x64 on, the
hp path runs native float64 instead.  The df64 primitives form no
rounded product, so FMA contraction by the compiler (XLA:CPU does it)
leaves them exact; tests/test_df64_fft.py pins the strict-IEEE primitives
and the compiled engine at ~1e-12.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import df64
from .carray import ComplexPair, is_pair
from .matmul_fft import _dft_matrix_np, _largest_small_divisor, _twiddle_np

__all__ = ["df64_fft_nd", "df64_to_numpy", "as_df64"]

_DIRECT_MAX = 256  # largest axis transformed by one direct df64 DFT


# -- representation ---------------------------------------------------------


def as_df64(x):
    """Promote real array / complex array / ComplexPair / df64 4-tuple to a
    df64 4-tuple.  Host float64/complex128 numpy inputs are split exactly
    into hi/lo halves (no precision loss)."""
    if isinstance(x, tuple) and len(x) == 4:
        return x
    if is_pair(x):
        z = jnp.zeros_like(x.re)
        return (x.re, jnp.zeros_like(x.re), x.im, z)
    if isinstance(x, np.ndarray) and x.dtype == np.complex128:
        re_h, re_l = df64.split_f64_np(np.ascontiguousarray(x.real))
        im_h, im_l = df64.split_f64_np(np.ascontiguousarray(x.imag))
        return tuple(jnp.asarray(v) for v in (re_h, re_l, im_h, im_l))
    if isinstance(x, np.ndarray) and x.dtype == np.float64:
        hi, lo = df64.split_f64_np(x)
        z = np.zeros_like(hi)
        return tuple(jnp.asarray(v) for v in (hi, lo, z, z))
    x = jnp.asarray(x)
    if np.dtype(x.dtype).kind == "c":
        re = jnp.real(x).astype(jnp.float32)
        im = jnp.imag(x).astype(jnp.float32)
        return (re, jnp.zeros_like(re), im, jnp.zeros_like(im))
    x = x.astype(jnp.float32)
    z = jnp.zeros_like(x)
    return (x, z, jnp.zeros_like(x), z)


def df64_to_numpy(x4) -> np.ndarray:
    """Combine a df64 4-tuple into a host complex128 array."""
    rh, rl, ih, il = (np.asarray(v) for v in x4)
    return (df64.join_np(rh, rl) + 1j * df64.join_np(ih, il))


@lru_cache(maxsize=None)
def _w_consts(n: int, sign: int):
    w = _dft_matrix_np(n, sign)
    return tuple(
        np.ascontiguousarray(v)
        for v in (*df64.split_f64_np(w.real), *df64.split_f64_np(w.imag))
    )


@lru_cache(maxsize=None)
def _tw_consts(n1: int, n2: int, sign: int):
    t = _twiddle_np(n1, n2, sign)
    return tuple(
        np.ascontiguousarray(v)
        for v in (*df64.split_f64_np(t.real), *df64.split_f64_np(t.imag))
    )


# -- direct DFT -------------------------------------------------------------


def _df64_dft_last(x4, n, sign):
    """Direct df64 DFT over the last axis: the contraction against the
    df64 DFT matrix is a sequence of compensated rank-1 updates (column j
    of the input times row j of the matrix, added into a df64
    accumulator), run as a ``lax.fori_loop`` over XLA arrays."""
    w4 = tuple(jnp.asarray(c) for c in _w_consts(n, sign))
    zero = jnp.zeros(x4[0].shape, jnp.float32)

    def step(j, acc):
        xcol = tuple(jax.lax.dynamic_index_in_dim(v, j, axis=-1)
                     for v in x4)                       # (..., 1)
        wrow = tuple(jax.lax.dynamic_index_in_dim(w, j, axis=0,
                                                  keepdims=False)
                     for w in w4)                       # (n,)
        return df64.cadd(acc, df64.cmul(xcol, wrow))

    return jax.lax.fori_loop(0, n, step, (zero,) * 4)


# -- recursion --------------------------------------------------------------


def _moveaxis4(x4, src, dst):
    return tuple(jnp.moveaxis(v, src, dst) for v in x4)


def _reshape4(x4, shape):
    return tuple(v.reshape(shape) for v in x4)


def _df64_fft_last(x4, n, sign):
    if n <= _DIRECT_MAX:
        return _df64_dft_last(x4, n, sign)
    n1 = _largest_small_divisor(n, _DIRECT_MAX)
    if n1 == 1:
        raise NotImplementedError(
            f"df64 FFT of prime size {n} (Bluestein in df64) is not "
            f"implemented; pad to a composite size."
        )
    n2 = n // n1
    shape = x4[0].shape
    a = _reshape4(x4, shape[:-1] + (n1, n2))
    # stage 1: DFT over n1 (bring it last, recurse)
    a = _moveaxis4(a, -2, -1)
    a = _df64_fft_last(a, n1, sign)      # (..., n2, k1)
    a = _moveaxis4(a, -1, -2)                       # (..., k1, n2)
    # twiddle T[k1, m2] in df64 at the XLA level
    trh, trl, tih, til = (jnp.asarray(c) for c in _tw_consts(n1, n2, sign))
    a = df64.cmul(a, (trh, trl, tih, til))
    # stage 2: DFT over n2 (last axis)
    a = _df64_fft_last(a, n2, sign)      # (..., k1, k2)
    # output index k = k1 + n1*k2
    a = tuple(jnp.swapaxes(v, -1, -2) for v in a)
    return _reshape4(a, shape[:-1] + (n,))


def df64_fft_nd(x, axes, kind: str = "fft"):
    """N-D FFT in emulated float64; returns a df64 4-tuple
    (re_hi, re_lo, im_hi, im_lo).

    kind: 'fft' | 'ifft'.  Use :func:`df64_to_numpy` to read results back
    as complex128.
    """
    x4 = as_df64(x)
    ndim = x4[0].ndim
    axes = [a % ndim for a in axes]
    sign = -1 if kind == "fft" else +1
    out = x4
    scale = 1.0
    for a in axes:
        n = out[0].shape[a]
        if a != ndim - 1:
            out = _moveaxis4(out, a, -1)
            out = _df64_fft_last(out, n, sign)
            out = _moveaxis4(out, -1, a)
        else:
            out = _df64_fft_last(out, n, sign)
        scale *= n
    if kind == "ifft":
        inv = np.float64(1.0 / scale)
        ih = np.float32(inv)
        il = np.float32(inv - np.float64(ih))
        rr = df64.mul(out[0], out[1], ih, il)
        ii = df64.mul(out[2], out[3], ih, il)
        out = (*rr, *ii)
    return out
