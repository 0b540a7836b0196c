"""Matmul FFT engine (split-complex), ``config.fft_engine="matmul"``.

The transform is built from dense real-valued matmuls over a split
(re, im) representation (``carray.ComplexPair``).  The default engine is
XLA's FFT (cuFFT on a GPU); this one is plain JAX, kept reachable until
ROADMAP.md Design 1.2 removes it.  The construction follows the classical
Cooley-Tukey "four-step" factorization (cf. arXiv:2002.03260 — see
PAPERS.md):

  * N <= direct_dft_max          : one dense DFT matmul, O(N) work/element
                                   (2 real matmuls for real input, 4 for
                                   complex).
  * N = N1 * N2 (N1 small)       : DFT_N1 matmul over the leading factor,
                                   twiddle multiply, recursive FFT over N2,
                                   transpose-and-flatten.  O(sum of radices)
                                   work/element with matmul-sized radices.
  * N prime (no small divisor)   : Bluestein chirp-z; the chirp spectrum is
                                   precomputed on host in float64 and baked
                                   in as a constant, so only two
                                   power-of-two FFTs run on device.

All DFT/twiddle/chirp constants are computed host-side with exact integer
modular angle arithmetic ((j*k) mod N) and float64 trig, then embedded as
trace-time constants — the device never evaluates transcendentals for them.
Matmuls run at ``Precision.HIGHEST`` (full f32 products: no bf16 passes,
no TF32); in float64 mode they are exact f64 matmuls, giving
~1e-12 numpy parity (validated in tests/test_matmul_fft.py).

This engine replaces what numpy/pocketfft provides to the reference library
(reference dispatch: ``/root/reference/xrft/xrft.py:32-36``).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from . import carray
from .carray import ComplexPair, as_pair, is_pair

__all__ = ["fft_last", "matmul_fft_nd"]

_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def _precision():
    return _PRECISIONS[config.matmul_precision]


# --------------------------------------------------------------------------
# Host-side constant factories (exact modular angles, float64 trig)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _dft_matrix_np(n: int, sign: int, pre: bool = False,
                   post: str | None = None) -> np.ndarray:
    """Dense DFT matrix W[j,k] = exp(sign*2*pi*i*j*k/n), complex128.

    ``pre`` bakes an input ifftshift into the matrix (row permutation);
    ``post`` ('fftshift' | 'ifftshift') bakes an output shift (column
    permutation) — shifts become free host-side index permutations
    instead of device memory passes.
    """
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n)  # exact for any practical n
    ang = (2.0 * np.pi * sign / n) * jk
    w = np.cos(ang) + 1j * np.sin(ang)
    if pre:
        # x' = ifftshift(x): sum_j x'[j] W[j,k] = sum_i x[i] W[pinv[i],k]
        # with pinv = the fftshift permutation (inverse of ifftshift)
        w = w[np.fft.fftshift(np.arange(n)), :]
    if post == "fftshift":
        # out' = fftshift(out): out'[k] = out[fs[k]]
        w = w[:, np.fft.fftshift(np.arange(n))]
    elif post == "ifftshift":
        w = w[:, np.fft.ifftshift(np.arange(n))]
    return w


@lru_cache(maxsize=None)
def _twiddle_np(n1: int, n2: int, sign: int) -> np.ndarray:
    """Four-step twiddle T[k1,m2] = exp(sign*2*pi*i*k1*m2/(n1*n2))."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)
    m2 = np.arange(n2, dtype=np.int64)
    prod = np.mod(np.outer(k1, m2), n)
    ang = (2.0 * np.pi * sign / n) * prod
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=None)
def _chirp_np(n: int, sign: int) -> np.ndarray:
    """Bluestein chirp c[j] = exp(sign*pi*i*j^2/n) with exact (j^2 mod 2n)."""
    j = np.arange(n, dtype=np.int64)
    sq = np.mod(j * j, 2 * n)
    ang = (np.pi * sign / n) * sq
    return np.cos(ang) + 1j * np.sin(ang)


@lru_cache(maxsize=None)
def _bluestein_plan(n: int, sign: int):
    """(m, chirp, chirp_spectrum): the wrapped conjugate-chirp spectrum is
    computed on host with numpy's float64 FFT and embedded as a constant."""
    m = 1
    while m < 2 * n - 1:
        m *= 2
    c = _chirp_np(n, sign)
    v = np.zeros(m, dtype=np.complex128)
    v[:n] = np.conj(c)
    v[m - n + 1:] = np.conj(c[1:][::-1])
    V = np.fft.fft(v)
    return m, c, V


@lru_cache(maxsize=None)
def _largest_small_divisor(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap (1 if none beyond the trivial)."""
    best = 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            if d <= cap and d > best:
                best = d
            q = n // d
            if q <= cap and q > best:
                best = q
        d += 1
    return best


# --------------------------------------------------------------------------
# Device-side transform (split representation throughout)
# --------------------------------------------------------------------------


def _rdtype_of(x) -> np.dtype:
    dt = np.dtype(x.dtype)
    if dt in (np.dtype(np.complex128), np.dtype(np.float64)):
        return np.dtype(np.float64)
    return np.dtype(np.float32)


def _wparts(w_np: np.ndarray, rdtype):
    wr = jnp.asarray(np.ascontiguousarray(w_np.real).astype(rdtype))
    wi = jnp.asarray(np.ascontiguousarray(w_np.imag).astype(rdtype))
    return wr, wi


def _apply_dft(x, w_np: np.ndarray, rdtype, contract_axis: int,
               out_swapped: bool = False) -> ComplexPair:
    """Contract x (real array or ComplexPair) along ``contract_axis``
    (-1 or -2) with the DFT matrix: 2 real matmuls for real input, 4 for
    complex — all at full f32/f64 precision.

    out_swapped=True (with contract_axis=-1 on a (..., m, j) input) emits
    the result with the last two axes already swapped: (..., k, m)."""
    if out_swapped:
        eq = "...mj,jk->...km"
    else:
        eq = "...j,jk->...k" if contract_axis == -1 else "...jm,jk->...km"
    wr, wi = _wparts(w_np, rdtype)

    prec = _precision()

    def mm(a, w):
        return jnp.einsum(eq, a, w, precision=prec)

    if not is_pair(x):
        xr = x.astype(rdtype)
        return ComplexPair(mm(xr, wr), mm(xr, wi))
    re = mm(x.re, wr) - mm(x.im, wi)
    im = mm(x.re, wi) + mm(x.im, wr)
    return ComplexPair(re, im)


def _tw_const(w_np: np.ndarray, rdtype) -> ComplexPair:
    return ComplexPair(*_wparts(w_np, rdtype))


def fft_last(x, sign: int = -1, pre_shift: bool = False,
             post_shift: str | None = None) -> ComplexPair:
    """Unnormalized DFT along the last axis; any static size.

    Input: real jax array, native complex array, or ComplexPair.
    Output: always a ComplexPair (callers pick the final representation).
    ``sign=-1`` is the forward transform, ``+1`` the unnormalized inverse.
    ``pre_shift`` applies an input ifftshift and ``post_shift`` an output
    fftshift — absorbed into the constant matrices wherever the
    factorization allows (even factors), falling back to explicit rolls.
    """
    if post_shift is True:  # backward-compatible boolean spelling
        post_shift = "fftshift"
    if not is_pair(x):
        x = jnp.asarray(x) if not isinstance(x, jax.Array) else x
        if np.dtype(x.dtype).kind == "c":
            x = as_pair(x)
    rdtype = _rdtype_of(x)
    n = x.shape[-1]
    return _fft_last_impl(x, n, sign, rdtype, pre_shift, post_shift)


def _roll_last(x, shift):
    return carray._map(x, lambda v: jnp.roll(v, shift, axis=-1)) \
        if is_pair(x) else jnp.roll(x, shift, axis=-1)


def _post_roll_amount(n, post):
    return n // 2 if post == "fftshift" else -(n // 2)


def _fft_last_impl(x, n, sign, rdtype, pre=False, post=None) -> ComplexPair:
    if n == 1:
        return x if is_pair(x) else ComplexPair(x.astype(rdtype), jnp.zeros_like(x, dtype=rdtype))
    if n <= config.direct_dft_max:
        return _apply_dft(x, _dft_matrix_np(n, sign, pre, post), rdtype, -1)
    n1 = _largest_small_divisor(n, config.direct_dft_max)
    if n1 == 1:
        if pre:   # explicit ifftshift: roll by -(n//2)
            x = _roll_last(x, -(n // 2))
        out = _bluestein_last(x, n, sign, rdtype)
        if post:
            out = _roll_last(out, _post_roll_amount(n, post))
        return out
    n2 = n // n1
    # absorb shifts into factor-level permutations where the factor parity
    # allows (input ifftshift -> j1 permutation iff n1 even; output
    # fftshift -> k2 permutation iff n2 even); else fall back to rolls
    pre1 = pre and n1 % 2 == 0
    post2 = post if (post and n2 % 2 == 0) else None
    if pre and not pre1:
        x = _roll_last(x, -(n // 2))
    shape = x.shape
    a = carray.reshape(x, shape[:-1] + (n1, n2)) if is_pair(x) else x.reshape(shape[:-1] + (n1, n2))
    # DFT over the n1 axis (axis -2): B[k1, m2] = sum_j A[j, m2] W[j, k1]
    a = _apply_dft(a, _dft_matrix_np(n1, sign, pre1, None), rdtype, -2)
    a = a * _tw_const(_twiddle_np(n1, n2, sign), rdtype)
    if n2 <= config.direct_dft_max:
        # fuse the tail DFT with the output permutation: one einsum emits
        # the (k2, k1) layout directly, saving a full memory pass
        a = _apply_dft(a, _dft_matrix_np(n2, sign, False, post2), rdtype, -1,
                       out_swapped=True)
    else:
        a = _fft_last_impl(a, n2, sign, rdtype, False, post2)
        # X[k1 + n1*k2] = D[k1, k2] -> swap so flattening yields k2*n1+k1
        a = carray.swapaxes(a, -1, -2)
    out = carray.reshape(a, shape[:-1] + (n,))
    if post and not post2:
        out = _roll_last(out, _post_roll_amount(n, post))
    return out


def _bluestein_last(x, n, sign, rdtype) -> ComplexPair:
    m, c, V = _bluestein_plan(n, sign)
    u = _tw_const(c, rdtype) * x  # pair * (real array | pair)
    if not is_pair(u):  # pragma: no cover - chirp is always a pair
        u = as_pair(u)
    pad = [(0, 0)] * (u.ndim - 1) + [(0, m - n)]
    u = carray.pad(u, pad)
    U = _fft_last_impl(u, m, -1, rdtype)
    conv = _fft_last_impl(U * _tw_const(V, rdtype), m, +1, rdtype) * (1.0 / m)
    return _tw_const(c, rdtype) * conv[..., :n]


# --------------------------------------------------------------------------
# N-D driver
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _pack_twiddle_np(n: int) -> np.ndarray:
    """w^k = exp(-2*pi*i*k/n) for k = 0..n/2-1 (rfft untangle)."""
    k = np.arange(n // 2, dtype=np.int64)
    ang = (-2.0 * np.pi / n) * k
    return np.cos(ang) + 1j * np.sin(ang)


def _rfft_packed_last(x, n) -> ComplexPair:
    """rfft of real x (last axis, even n) via the even/odd packing trick:

        z = x[0::2] + i x[1::2];  Z = FFT_{n/2}(z)
        E = (Z + conj(Z[-k]))/2,  O = -i (Z - conj(Z[-k]))/2
        X[k] = E[k] + w^k O[k] (k < n/2),  X[n/2] = E[0] - O[0]
    """
    rdtype = _rdtype_of(x)
    m = n // 2
    z = ComplexPair(x[..., 0::2].astype(rdtype), x[..., 1::2].astype(rdtype))
    Z = _fft_last_impl(z, m, -1, rdtype)
    # Z[(-k) % m] == roll(flip(Z), 1): reverse/slice HLOs instead of a
    # gather
    Zc = carray.conj(carray.roll(carray.flip(Z, [-1]), 1, -1))
    E = (Z + Zc) * 0.5
    Od = (Z - Zc) * 0.5          # = i * O
    O = ComplexPair(Od.im, -Od.re)  # multiply by -i
    W = _tw_const(_pack_twiddle_np(n), rdtype)
    head = E + W * O
    nyq = carray.getitem(E, (Ellipsis, slice(0, 1))) \
        - carray.getitem(O, (Ellipsis, slice(0, 1)))
    return carray.concatenate([head, nyq], axis=-1)


def _irfft_packed_last(X, n, rdtype, post_roll=False) -> jnp.ndarray:
    """irfft of a one-sided pair X (last axis, m+1 = n/2+1 columns) via the
    inverse even/odd packing trick — the half-length dual of
    :func:`_rfft_packed_last`:

        E[k] = (X[k] + conj(X[m-k]))/2
        O[k] = (X[k] - conj(X[m-k]))/2 * w^{-k}   (w = exp(-2*pi*i/n))
        z    = IFFT_m(E + i O);  x[2j] = Re z[j], x[2j+1] = Im z[j]

    The imaginary parts of the DC and Nyquist columns are dropped first,
    matching pocketfft's c2r semantics (``np.fft.irfft`` ignores them), so
    the result is bit-equal in expectation to the Hermitian-mirror +
    full-length-ifft formulation at half the trailing-axis traffic.

    ``post_roll=True`` emits ``fftshift`` of the real output (an n/2
    roll; fftshift == ifftshift for even n) absorbed as an m/2 roll of
    ``z`` — valid only when ``n % 4 == 0`` (the n/2 roll then preserves
    the even/odd interleave parity); callers gate on that.  Rides the
    half-length engine's absorbed output permutation (zero memory
    passes) instead of an explicit roll of the full-size real result.
    """
    m = n // 2
    assert not post_roll or n % 4 == 0
    Xh = carray.getitem(X, (Ellipsis, slice(0, m)))
    Xr = carray.flip(carray.getitem(X, (Ellipsis, slice(1, m + 1))), [-1])
    # zero the DC (Xh col 0) / Nyquist (Xr col 0) imaginary parts
    mask_np = np.ones(m)
    mask_np[0] = 0.0
    mask = jnp.asarray(mask_np.astype(rdtype))
    Xh = ComplexPair(Xh.re, Xh.im * mask)
    Xr = ComplexPair(Xr.re, Xr.im * mask)
    E = ComplexPair((Xh.re + Xr.re) * 0.5, (Xh.im - Xr.im) * 0.5)
    Ow = ComplexPair((Xh.re - Xr.re) * 0.5, (Xh.im + Xr.im) * 0.5)
    Wc = _tw_const(np.conj(_pack_twiddle_np(n)), rdtype)
    O = Wc * Ow
    Z = ComplexPair(E.re - O.im, E.im + O.re)
    from . import stacked_fft

    post_axes = {Z.ndim - 1} if post_roll else set()
    if stacked_fft.stacked_supported(Z, [Z.ndim - 1], "ifft", set(),
                                     post_axes):
        z = stacked_fft.fft_nd_stacked(Z, [Z.ndim - 1], "ifft", (),
                                       tuple(post_axes), "fftshift")
    else:
        z = _fft_last_impl(Z, m, +1, rdtype) * (1.0 / m)
        if post_roll:
            z = carray.fftshift(z, [-1])
    # interleave: x[2j] = Re z[j], x[2j+1] = Im z[j]
    out = jnp.stack([z.re, z.im], axis=-1)
    return out.reshape(out.shape[:-2] + (n,))


def _transform_axis(x, axis, sign, pre=False, post=None) -> ComplexPair:
    ndim = x.ndim
    if axis in (-1, ndim - 1):
        return fft_last(x, sign, pre, post)
    y = carray.moveaxis(x, axis, -1)
    y = fft_last(y, sign, pre, post)
    return carray.moveaxis(y, -1, axis)


def matmul_fft_nd(x, axes, kind: str, pre_shift_axes=(), post_shift_axes=(),
                  post_kind="fftshift"):
    """N-D FFT via per-axis matmul transforms; returns a ComplexPair for
    the complex kinds and a real array for 'irfft'.

    kind: 'fft' | 'ifft' | 'rfft' | 'irfft'.  For the real kinds the real
    axis must be the last entry of ``axes`` and the last axis of ``x``
    (callers arrange this, mirroring the reference's move-to-last handling
    at ``/root/reference/xrft/xrft.py:380-404``).
    """
    if not is_pair(x) and not isinstance(x, jax.Array):
        x = as_pair(x) if np.dtype(np.asarray(x).dtype).kind == "c" else jnp.asarray(x)
    ndim = x.ndim
    axes = [a % ndim for a in axes]
    pre_shift_axes = {a % ndim for a in pre_shift_axes}
    post_shift_axes = {a % ndim for a in post_shift_axes}

    from . import stacked_fft

    if axes and stacked_fft.stacked_supported(
            x, axes, kind, pre_shift_axes, post_shift_axes):
        return stacked_fft.fft_nd_stacked(
            x, axes, kind, pre_shift_axes, post_shift_axes, post_kind)

    def post_of(a):
        return post_kind if a in post_shift_axes else None

    if kind == "fft":
        out = x
        for a in axes:
            out = _transform_axis(out, a, -1, a in pre_shift_axes,
                                  post_of(a))
        return out
    if kind == "ifft":
        out = x
        scale = 1.0
        for a in axes:
            out = _transform_axis(out, a, +1, a in pre_shift_axes,
                                  post_of(a))
            scale *= x.shape[a]
        return out * (1.0 / scale)
    if kind == "rfft":
        if axes[-1] != ndim - 1:
            raise ValueError("rfft axis must be the last axis")
        n = x.shape[-1]
        pre_last = axes[-1] in pre_shift_axes
        if n % 2 == 0 and not is_pair(x) \
                and np.dtype(x.dtype).kind != "c":
            # even/odd packing: one complex FFT of length n/2 plus an
            # elementwise untangle — halves the trailing-axis work
            if pre_last:
                x = _roll_last(x, -(n // 2))
            out = _rfft_packed_last(x, n)
        else:
            out = fft_last(x, -1, pre_last, None)[..., : n // 2 + 1]
        for a in axes[:-1]:
            out = _transform_axis(out, a, -1, a in pre_shift_axes,
                                  post_of(a))
        return out
    if kind == "irfft":
        if axes[-1] != ndim - 1:
            raise ValueError("irfft axis must be the last axis")
        if ndim - 1 in pre_shift_axes:
            raise ValueError(
                "input ifftshift on the one-sided real axis is undefined")
        mm = x.shape[-1]
        n = 2 * (mm - 1)
        out = as_pair(x) if not is_pair(x) else x
        # inverse-transform the non-real axes (on the cheap half-spectrum
        # array), then rebuild the Hermitian-symmetric full spectrum and
        # inverse the real axis; each stage prefers the stacked engine.
        # Input/output shifts on the non-real axes are absorbed into the
        # engine weights; the real-axis OUTPUT shift (an n/2 roll,
        # fftshift == ifftshift for the structurally even n) is absorbed
        # as an m/2 roll of the packed half-length transform when
        # n % 4 == 0, else applied explicitly
        post_real = (ndim - 1) in post_shift_axes
        scale = 1.0
        if axes[:-1]:
            pre_nr = {a for a in axes[:-1] if a in pre_shift_axes}
            post_nr = {a for a in axes[:-1] if a in post_shift_axes}
            if stacked_fft.stacked_supported(out, axes[:-1], "ifft",
                                             pre_nr, post_nr):
                out = stacked_fft.fft_nd_stacked(
                    out, axes[:-1], "ifft", tuple(pre_nr), tuple(post_nr),
                    post_kind)
            else:
                for a in axes[:-1]:
                    out = _transform_axis(out, a, +1, a in pre_nr,
                                          post_of(a))
                    scale *= x.shape[a]
        if n >= 2:
            # half-length packed inverse (even n is structural here:
            # n = 2*(mm-1)); halves the trailing-axis dot + memory work
            rdtype = _rdtype_of(out)
            absorb_real = post_real and n % 4 == 0
            res = _irfft_packed_last(out, n, rdtype, post_roll=absorb_real)
            if post_real and not absorb_real:
                res = (carray.fftshift if post_kind == "fftshift"
                       else carray.ifftshift)(res, [ndim - 1])
            return res * (1.0 / scale) if scale != 1.0 else res
        tail = carray.conj(out[..., -2:0:-1])
        full = carray.concatenate([out, tail], axis=-1)
        if stacked_fft.stacked_supported(full, [ndim - 1], "ifft",
                                         set(), set()):
            out = stacked_fft.fft_nd_stacked(full, [ndim - 1], "ifft")
        else:
            out = fft_last(full, +1)
            scale *= n
        res = out.re * (1.0 / scale) if scale != 1.0 else out.re
        if post_real:
            res = (carray.fftshift if post_kind == "fftshift"
                   else carray.ifftshift)(res, [ndim - 1])
        return res
    raise ValueError(f"unknown kind {kind!r}")
