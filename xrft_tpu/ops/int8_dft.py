"""High-precision DFT from exact int8 matmuls (Ozaki-style limb scheme).

The df64 path (:mod:`.df64_fft`) reaches ~2e-14 but costs ~1000x a matmul
in elementwise work.  This module gets comparable accuracy out of matrix
units, using an operation they perform *exactly*: int8 x int8 matmuls
accumulated in int32 (products <= 2^14, so sums stay exact for
K <= 2^17).  It serves the emulated hp mode (``config.hp_impl``), kept
reachable until ROADMAP.md Design 1.3 removes it.

Scheme (classical multi-word / Ozaki splitting):

  * W (DFT matrix, |entries| <= 1): rounded on host to 7*LW-bit fixed
    point and decomposed into LW balanced base-2^7 int8 limbs — exact by
    construction.
  * X: two-level on-device quantization against a power-of-two row-block
    scale: X ~= (X1 + 2^-21 X2) * S with X1, X2 21-bit integers, the
    level-2 residual extracted error-free (two_prod) so together they
    carry ~42 significant bits of each input element.  Each level splits
    into 3 int8 limbs.
  * Y = sum over limb pairs (p, q) of (X_p @ W_q) * 2^(-7(p+q)) — int8
    matmuls, combined in df64 (each int32 partial converts to an exact
    f32 hi/lo pair).  Pairs below the target precision are truncated.

Accuracy ~1e-14 (n=256) to ~1e-13 (n=1024) relative (tests/test_int8_dft.py)
— at or beyond the df64 path — at matmul speed.  Shipped surface:
:func:`int8_dft_last` (direct DFT, n <= ~2000 for the K-exactness bound
with margin), :func:`int8_fft_last` (four-step composition to larger
sizes), and :func:`int8_fft_nd` (N-D fft/ifft/rfft/irfft with absorbed
pre/post shifts) — the driver behind ``engine="hp"`` pipelines
(:mod:`..highprec`) and the f64-grade sharded pencil path
(``parallel/pencil.py``, ``precision='hp'``).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import df64
from .matmul_fft import _dft_matrix_np

__all__ = ["int8_dft_last"]

LW = 7   # W limbs (7 bits each)
LX = 3   # int8 limbs per X quantization level
# one bit of headroom everywhere: balanced base-2^7 digits only cover
# ~+-0.496 * 128^L, so quantize to (7L - 2) bits
W_Q = 7 * LW - 2
X_Q = 7 * LX - 2


@lru_cache(maxsize=None)
def _w_limbs_np(n: int, sign: int, part: str):
    """Balanced base-2^7 int8 limb decomposition of the DFT matrix part.

    Returns (limbs[LW][n,n] int8, scale) with
    W ~= scale * sum_q limbs[q] * 2^(7*(LW-1-q)), scale = 2^-W_Q.
    """
    w = _dft_matrix_np(n, sign)
    m = w.real if part == "re" else w.imag
    fixed = np.rint(m * float(2 ** W_Q)).astype(object)  # exact ints
    limbs = []
    v = fixed
    for _ in range(LW):
        d = ((v + 64) % 128) - 64          # balanced digit in [-64, 63]
        limbs.append(np.asarray(d, dtype=np.int8))
        v = (v - d) // 128
    assert not np.any(v.astype(np.int64)), "W limb decomposition overflow"
    # limbs[0] is least significant; reverse to most-significant-first
    limbs = limbs[::-1]
    scale = 2.0 ** -W_Q
    return limbs, scale


def _x_limbs(x, rows_shape):
    """Two-level quantization + int8 limb split of a real f32 array
    against a per-row power-of-two scale.  Returns (limb list (int8),
    per-limb scales (f32 (...,1) arrays))."""
    absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    absmax = jnp.where(absmax == 0, 1.0, absmax)
    # power-of-two scale S > absmax, so divisions are exact: one above
    # absmax's binary exponent, built from its bits (log2/exp2 may be
    # approximate on a GPU, and an inexact S breaks the exact split)
    biased = jax.lax.shift_right_logical(
        jax.lax.bitcast_convert_type(absmax.astype(jnp.float32), jnp.uint32),
        np.uint32(23))
    S = jax.lax.bitcast_convert_type(
        jax.lax.shift_left(biased + np.uint32(1), np.uint32(23)), jnp.float32)
    u = x / S  # exact (power-of-two divide), |u| <= 1
    q1f = jnp.rint(u * (2.0 ** X_Q))
    q1 = q1f.astype(jnp.int32)
    # error-free residual: r = u - q1 * 2^-X_Q (power-of-two product is
    # exact; nearby subtraction is exact by Sterbenz)
    r = u - q1f * jnp.float32(2.0 ** -X_Q)
    q2 = jnp.rint(r * (2.0 ** (2 * X_Q))).astype(jnp.int32)

    limbs = []
    scales = []
    for lvl, q in enumerate((q1, q2)):
        v = q
        lvl_limbs = []
        for _ in range(LX):
            d = ((v + 64) % 128) - 64
            lvl_limbs.append(d.astype(jnp.int8))
            v = (v - d) // 128
        lvl_limbs = lvl_limbs[::-1]  # most significant first
        for p, lb in enumerate(lvl_limbs):
            limbs.append(lb)
            # limb p of level lvl weighs 2^(7*(LX-1-p)) * 2^-((lvl+1)*X_Q)
            scales.append(2.0 ** (7 * (LX - 1 - p) - (lvl + 1) * X_Q))
    return limbs, scales, S


def _int8_real_transform(x, n, sign, sig_cutoff):
    """DFT of a *real* f32 array along the last axis; returns a df64
    4-tuple.  ``sig_cutoff``: drop limb pairs below this relative
    significance (2^-52 for full precision; larger for low-order inputs
    in the linearity decomposition)."""
    xl, xs, S = _x_limbs(x, x.shape[:-1])
    out = {}
    for part in ("re", "im"):
        wl, wscale = _w_limbs_np(n, sign, part)
        wl = [jnp.asarray(w) for w in wl]
        acc_h = jnp.zeros(x.shape, jnp.float32)
        acc_l = jnp.zeros(x.shape, jnp.float32)
        for xlimb, xsc in zip(xl, xs):
            for q, wlimb in enumerate(wl):
                wsc = 2.0 ** (7 * (LW - 1 - q))
                scale = xsc * wsc * wscale
                # significance truncation: xsc and wsc*wscale are both
                # relative scales <= ~1
                if abs(scale) < sig_cutoff:
                    continue
                prod = jax.lax.dot_general(
                    xlimb, wlimb, (((xlimb.ndim - 1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                # int32 -> exact f32 hi/lo pair
                ph = prod.astype(jnp.float32)
                pl = (prod - ph.astype(jnp.int32)).astype(jnp.float32)
                sh, sl = df64.mul_f32(ph, pl, jnp.float32(scale))
                acc_h, acc_l = df64.add(acc_h, acc_l, sh, sl)
        out[part] = (acc_h, acc_l)
    # restore the per-row scale S (power of two -> exact multiplies)
    return (out["re"][0] * S, out["re"][1] * S,
            out["im"][0] * S, out["im"][1] * S)


def int8_dft_last(x, sign: int = -1):
    """Direct high-precision DFT along the last axis via int8 matmuls.

    x: real f32 array OR df64 4-tuple (re_hi, re_lo, im_hi, im_lo),
    shape (..., n) with n <= 2000.  Returns a df64 4-tuple; combine with
    :func:`xrft_tpu.ops.df64_fft.df64_to_numpy`.

    Complex / df64 inputs use linearity: each of the four real components
    transforms independently (the lo components need only the high limb
    pairs — they sit ~2^-19 below the hi components).
    """
    if isinstance(x, tuple):
        n = x[0].shape[-1]
    else:
        n = x.shape[-1]
    if n > 2000:
        raise ValueError("int8 DFT spike supports n <= 2000 (int32 "
                         "accumulation exactness bound with margin)")
    if not isinstance(x, tuple):
        return _int8_real_transform(
            jnp.asarray(x).astype(jnp.float32), n, sign, 2.0 ** -52
        )

    rh, rl, ih, il = (jnp.asarray(v).astype(jnp.float32) for v in x)
    # hi components at full precision; lo components only need the top
    # ~33 bits (they are ~2^-19 of the total)
    Fr_h = _int8_real_transform(rh, n, sign, 2.0 ** -52)
    Fr_l = _int8_real_transform(rl, n, sign, 2.0 ** -33)
    Fi_h = _int8_real_transform(ih, n, sign, 2.0 ** -52)
    Fi_l = _int8_real_transform(il, n, sign, 2.0 ** -33)

    def dadd(a, b):
        return df64.add(a[0], a[1], b[0], b[1])

    # F = (Fr_h + Fr_l) + i (Fi_h + Fi_l), with each F* complex df64:
    # re = Re(Fr) - Im(Fi), im = Im(Fr) + Re(Fi)
    Rr = dadd(Fr_h[0:2], Fr_l[0:2])
    Ri = dadd(Fr_h[2:4], Fr_l[2:4])
    Ir = dadd(Fi_h[0:2], Fi_l[0:2])
    Ii = dadd(Fi_h[2:4], Fi_l[2:4])
    re = dadd(Rr, (-Ii[0], -Ii[1]))
    im = dadd(Ri, Ir)
    return (*re, *im)


@lru_cache(maxsize=None)
def _balanced_factors_int8(n: int, cap: int = 2000):
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0 and d <= cap and n // d <= cap:
            best = (n // d, d)
        d += 1
    return best


def int8_fft_last(x, sign: int = -1):
    """High-precision FFT along the last axis for composite sizes, built
    from two int8 DFT stages with df64 twiddles (four-step):

        reshape (n1, n2) -> int8 DFT over n1 -> twiddle (df64 cmul)
        -> int8 DFT over n2 -> output permutation

    Supports any n = n1*n2 with n1, n2 <= 2000 (n up to 4M).  Input: real
    f32 array or df64 4-tuple; output df64 4-tuple.  ~1e-13 relative
    error at n=4096.
    """
    is4 = isinstance(x, tuple)
    shape = (x[0] if is4 else x).shape
    n = shape[-1]
    if n <= 1024:
        return int8_dft_last(x, sign)
    fac = _balanced_factors_int8(n)
    if fac is None:
        raise ValueError(f"no factorization of {n} with both factors <= 2000")
    n1, n2 = fac
    from .df64_fft import _tw_consts

    comps = x if is4 else (jnp.asarray(x).astype(jnp.float32),)

    def reshape_all(c, shp):
        return tuple(v.reshape(shp) for v in c)

    def move_all(c, src, dst):
        return tuple(jnp.moveaxis(v, src, dst) for v in c)

    a = reshape_all(comps, shape[:-1] + (n1, n2))
    a = move_all(a, -2, -1)
    a = int8_dft_last(a if is4 else a[0], sign)      # (..., n2, k1)
    a = move_all(a, -1, -2)                          # (..., k1, n2)
    trh, trl, tih, til = (jnp.asarray(c) for c in _tw_consts(n1, n2, sign))
    a = df64.cmul(a, (trh, trl, tih, til))
    a = int8_dft_last(a, sign)                       # (..., k1, k2)
    a = tuple(jnp.swapaxes(v, -1, -2) for v in a)
    return reshape_all(a, shape[:-1] + (n,))


# --------------------------------------------------------------------------
# N-D driver (round 2): rfft / fft / ifft / irfft over any axes
# --------------------------------------------------------------------------


def _roll4(x4, shift, axis):
    return tuple(jnp.roll(v, shift, axis=axis) for v in x4)


def int8_fft_nd(x, axes, kind: str = "fft", pre_shift_axes=(),
                post_shift_axes=(), post_kind: str = "fftshift"):
    """High-precision N-D transform via per-axis int8-limb DFTs.

    x: f32/f64 array, 4-tuple, or anything :func:`..hp.as_quad` accepts.
    kind: 'fft' | 'ifft' | 'rfft' | 'irfft' (real axis = last of ``axes``
    and trailing, as in :func:`.matmul_fft.matmul_fft_nd`).  Shifts are
    explicit rolls (this is the precision path; the absorbed-shift
    machinery of the f32 engines is not needed here).  Returns a complex
    df64 4-tuple; 'irfft' returns a real df64 (hi, lo) 2-tuple.

    Accuracy: ~1e-13 relative (tests/test_int8_dft.py); axis sizes
    up to 4M (two int8 DFT stages of <= 2000 each).
    """
    from . import df64 as _df64
    from .hp import as_quad

    x4 = as_quad(x)
    ndim = x4[0].ndim
    axes = [a % ndim for a in axes]
    pre = {a % ndim for a in pre_shift_axes}
    post = {a % ndim for a in post_shift_axes}
    sign = +1 if kind in ("ifft", "irfft") else -1

    def tf_axis(z4, ax, sgn):
        if ax != ndim - 1:
            z4 = tuple(jnp.moveaxis(v, ax, -1) for v in z4)
        z4 = int8_fft_last(z4, sgn)
        if ax != ndim - 1:
            z4 = tuple(jnp.moveaxis(v, -1, ax) for v in z4)
        return z4

    if kind == "irfft":
        m = x4[0].shape[-1]
        n = 2 * (m - 1)
        out = x4
        for a in axes[:-1]:
            if a in pre:
                out = _roll4(out, -(out[0].shape[a] // 2), a)
            out = tf_axis(out, a, sign)
        # Hermitian extension of the last axis, then full inverse
        tail = tuple(v[..., -2:0:-1] for v in out)
        tail = (tail[0], tail[1], -tail[2], -tail[3])
        out = tuple(jnp.concatenate([a_, b_], axis=-1)
                    for a_, b_ in zip(out, tail))
        out = int8_fft_last(out, sign)
        scale = 1.0
        for a in axes[:-1]:
            scale *= x4[0].shape[a]
        scale *= n
        sh, sl = (np.float32(v) for v in
                  _split_scalar(1.0 / scale))
        re = _df64.mul(out[0], out[1], sh, sl)
        # post-shift rolls on the FULL-length real output (the reference
        # shifts every transformed axis of the ifft output, including the
        # real one — /root/reference/xrft/xrft.py:617-621)
        for a in axes:
            if a in post:
                nn = re[0].shape[a]
                amt = nn // 2 if post_kind == "fftshift" else -(nn // 2)
                re = tuple(jnp.roll(v, amt, axis=a) for v in re)
        return re

    # rfft: transform (and halve) the real trailing axis first, so the
    # remaining axes work on the one-sided array (numpy rfftn order)
    order = ([axes[-1]] + axes[:-1]) if kind == "rfft" else axes
    out = x4
    for a in order:
        if a in pre:
            out = _roll4(out, -(out[0].shape[a] // 2), a)
        out = tf_axis(out, a, sign)
        if kind == "rfft" and a == axes[-1]:
            n = out[0].shape[a]
            idx = [slice(None)] * ndim
            idx[a] = slice(0, n // 2 + 1)
            out = tuple(v[tuple(idx)] for v in out)
        elif a in post:
            amt = out[0].shape[a] // 2
            out = _roll4(out, amt if post_kind == "fftshift" else -amt, a)

    if kind == "ifft":
        scale = 1.0
        for a in axes:
            scale *= x4[0].shape[a]
        sh, sl = (np.float32(v) for v in _split_scalar(1.0 / scale))
        re = df64.mul(out[0], out[1], sh, sl)
        im = df64.mul(out[2], out[3], sh, sl)
        out = (*re, *im)
    return out


def _split_scalar(v: float):
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return hi, lo
