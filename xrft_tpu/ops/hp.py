"""High-precision (df64) pipeline primitives for the engine='hp' path.

The BASELINE contract (BASELINE.md) asks for <= 1e-10 relative agreement
with float64 numpy for full *pipelines* — detrend, window, transform,
magnitude, scaling — without float64 execution (the emulated hp mode).
A high-precision
DFT alone is not enough: every elementwise and reduction stage must also
carry ~2x f32 precision.  This module provides those stages over the
double-word representation of :mod:`.df64` (value = hi + lo):

- ``as_quad`` / ``quad_real``: representation adapters (complex df64 is the
  4-tuple (rh, rl, ih, il) convention of :mod:`.df64_fft`).
- ``dsum``: compensated pairwise tree reduction (error-free TwoSum folds,
  log-depth), the df64 analogue of ``jnp.sum``.
- ``detrend_quad``: the closed-form orthogonal-regressor hyperplane fit of
  :mod:`..detrend` in df64 arithmetic.
- ``window_quad``: separable window multiply with host-float64 windows
  split exactly into (hi, lo) constants.
- ``masked_bin_sums``: per-bin compensated sums (the df64 analogue of the
  isotropic grouped scatter-add in :mod:`.binning`).

Accuracy (see :mod:`.df64`): the float32 primitives never depend on a
rounded product, so FMA contraction (XLA:CPU's LLVM backend contracts)
leaves them exact; the strict bounds are pinned in tests/test_hp_*.py and
by chip_smoke.py's emulated-hp phase on the GPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from . import df64
from .carray import CDF64, DF64, is_pair

__all__ = [
    "as_quad", "dsum", "detrend_quad", "window_quad", "masked_bin_sums",
]


def as_quad(x) -> tuple:
    """Any input -> complex df64 4-tuple (rh, rl, ih, il)."""
    if isinstance(x, CDF64):
        return x.quad
    if isinstance(x, DF64):
        z = jnp.zeros_like(x.hi)
        return (x.hi, x.lo, z, z)
    if isinstance(x, tuple):
        return x
    if is_pair(x):
        rh = jnp.asarray(x.re).astype(jnp.float32)
        ih = jnp.asarray(x.im).astype(jnp.float32)
        return (rh, jnp.zeros_like(rh), ih, jnp.zeros_like(ih))
    if isinstance(x, np.ndarray) and x.dtype == np.float64:
        hi, lo = df64.split_f64_np(x)
        return (jnp.asarray(hi), jnp.asarray(lo),
                jnp.zeros(hi.shape, jnp.float32),
                jnp.zeros(hi.shape, jnp.float32))
    if isinstance(x, np.ndarray) and x.dtype == np.complex128:
        rh, rl = df64.split_f64_np(np.ascontiguousarray(x.real))
        ih, il = df64.split_f64_np(np.ascontiguousarray(x.imag))
        return tuple(jnp.asarray(v) for v in (rh, rl, ih, il))
    xr = jnp.asarray(x)

    def dev_split(v):
        """Exact (hi, lo) split of a device float64 array (x64 backends
        only)."""
        if np.dtype(v.dtype) == np.dtype(np.float64):
            hi = v.astype(jnp.float32)
            lo = (v - hi.astype(jnp.float64)).astype(jnp.float32)
            return hi, lo
        hi = v.astype(jnp.float32)
        return hi, jnp.zeros_like(hi)

    if np.dtype(xr.dtype).kind == "c":
        rh, rl = dev_split(jnp.real(xr))
        ih, il = dev_split(jnp.imag(xr))
        return (rh, rl, ih, il)
    rh, rl = dev_split(xr)
    z = jnp.zeros_like(rh)
    return (rh, rl, z, z)


def _split_const(v) -> tuple[np.ndarray, np.ndarray]:
    """Host float64 scalar/array -> exact (hi, lo) f32 constants."""
    hi, lo = df64.split_f64_np(np.asarray(v, dtype=np.float64))
    return hi, lo


def _dsum_axis(h, l, ax):
    n = h.shape[ax]
    while n > 1:
        half = n // 2
        ah = lax.slice_in_dim(h, 0, half, axis=ax)
        bh = lax.slice_in_dim(h, half, 2 * half, axis=ax)
        al = lax.slice_in_dim(l, 0, half, axis=ax)
        bl = lax.slice_in_dim(l, half, 2 * half, axis=ax)
        s, e = df64.two_sum(ah, bh)
        lo = al + bl + e
        if n % 2:
            rh = lax.slice_in_dim(h, 2 * half, n, axis=ax)
            rl = lax.slice_in_dim(l, 2 * half, n, axis=ax)
            h = jnp.concatenate([s, rh], axis=ax)
            l = jnp.concatenate([lo, rl], axis=ax)
            n = half + 1
        else:
            h, l = s, lo
            n = half
    return df64.two_sum(h, l)


def dsum(h, l, axes, keepdims=True):
    """Compensated sum of a df64 array over ``axes`` (pairwise TwoSum tree,
    log-depth; relative error ~2^-45 independent of length)."""
    if isinstance(axes, int):
        axes = (axes,)
    for ax in sorted(a % h.ndim for a in axes):
        h, l = _dsum_axis(h, l, ax)
    if not keepdims:
        h = jnp.squeeze(h, axis=tuple(sorted(a % h.ndim for a in axes)))
        l = jnp.squeeze(l, axis=tuple(sorted(a % l.ndim for a in axes)))
    return h, l


def detrend_quad(h, l, axes, kind):
    """df64 'constant'/'linear' detrend over ``axes`` (the closed-form
    orthogonal-regressor fit of detrend.py, reference
    /root/reference/xrft/detrend.py:100-138, in double-word arithmetic)."""
    if kind is None:
        return h, l
    n_el = 1.0
    for a in axes:
        n_el *= h.shape[a]
    inv_h, inv_l = _split_const(1.0 / n_el)
    sh, sl = dsum(h, l, axes)
    mh, ml = df64.mul(sh, sl, jnp.float32(inv_h), jnp.float32(inv_l))
    fit_h, fit_l = jnp.broadcast_to(mh, h.shape), jnp.broadcast_to(ml, h.shape)
    if kind == "linear":
        for a in axes:
            n = h.shape[a]
            if n == 1:
                continue
            shape = [1] * h.ndim
            shape[a] = n
            c64 = (np.arange(n) - (n - 1) / 2.0).reshape(shape)
            ch_np, cl_np = _split_const(c64)
            ch, cl = jnp.asarray(ch_np), jnp.asarray(cl_np)
            css = float(np.sum((np.arange(n) - (n - 1) / 2.0) ** 2)) \
                * (n_el / n)
            ih_np, il_np = _split_const(1.0 / css)
            ph, pl = df64.mul(h, l, ch, cl)
            nh, nl = dsum(ph, pl, axes)
            slope = df64.mul(nh, nl, jnp.float32(ih_np), jnp.float32(il_np))
            term = df64.mul(jnp.broadcast_to(slope[0], h.shape),
                            jnp.broadcast_to(slope[1], h.shape), ch, cl)
            fit_h, fit_l = df64.add(fit_h, fit_l, *term)
    elif kind != "constant":
        raise NotImplementedError(
            f"{kind} is not a valid detrending option. Valid options are: "
            "'constant','linear', or None."
        )
    return df64.add(h, l, -fit_h, -fit_l)


def window_quad(h, l, dims_axes_sizes, window_type):
    """Separable window multiply in df64: host-f64 1-D windows split
    exactly into (hi, lo) constants per axis.

    dims_axes_sizes: list of (axis, n).  Returns (h, l) and the list of
    host-f64 1-D windows (correction factors are products of their means,
    since the mean of a separable outer product factorizes — exact host
    math).
    """
    import scipy.signal as sps

    from .window import WINDOW_TYPES

    if window_type is True:
        window_type = "hann"
    if window_type not in WINDOW_TYPES:
        raise NotImplementedError(
            f"Window type {window_type} not supported. Please adhere to "
            "scipy.signal.windows for naming convention."
        )
    win_func = getattr(sps.windows, window_type)
    wins_1d = []
    for ax, n in dims_axes_sizes:
        w = np.asarray(win_func(n, sym=False), dtype=np.float64)
        shape = [1] * h.ndim
        shape[ax] = n
        wh, wl = _split_const(w.reshape(shape))
        h, l = df64.mul(h, l, jnp.asarray(wh), jnp.asarray(wl))
        wins_1d.append(w)
    return h, l, wins_1d


def masked_bin_sums(h, l, codes: np.ndarray, nbins: int):
    """Per-bin compensated sums: (h, l) flattened over the binned dims
    (trailing axis = flattened points matching ``codes``), returns
    (nbins,)-leading df64 sums.  codes < 0 are dropped (pd.cut NaN)."""
    flat_h = h.reshape(h.shape[: h.ndim - codes.ndim] + (-1,))
    flat_l = l.reshape(flat_h.shape)
    cflat = codes.reshape(-1)
    masks = np.zeros((nbins, cflat.size), np.float32)
    valid = cflat >= 0
    masks[cflat[valid], np.nonzero(valid)[0]] = 1.0
    mj = jnp.asarray(masks)
    # broadcast-mask then tree-sum: exact selection (x*1 or x*0), then a
    # compensated reduction -> per-bin relative error ~2^-45
    mh = flat_h[..., None, :] * mj
    ml = flat_l[..., None, :] * mj
    sh, sl = dsum(mh, ml, (-1,), keepdims=False)
    return sh, sl
