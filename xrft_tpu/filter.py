"""FIR design and polyphase resampling: firwin / upfirdn / resample_poly
/ decimate (scipy.signal namesakes).

Beyond the reference (xrft has no filtering; its surface stops at forward
spectral estimates, ``/root/reference/xrft/xrft.py:17-29``) — matching
scipy.signal semantics:

* :func:`firwin` — window-method FIR design.  Pure host/static numpy (a
  filter is a function of its static parameters only), so the taps embed
  in the jaxpr as constants exactly like the spectral windows in
  :mod:`.ops.window`.
* :func:`upfirdn` — upsample (zero-stuff), FIR filter, downsample.  The
  shape is *static-stride surgery around one convolution*: the
  zero-stuffing is a reshape + zero-pad on an inserted axis (no scatter),
  the filter is an engine-routed FFT convolution
  (:func:`.convolve._fft_convolve`), and the downsampling is a static
  strided slice — one XLA program, fully jit-traceable.  scipy iterates a
  compiled C polyphase loop per output sample; here the dense formulation
  lets XLA fuse the stuffing/slicing into neighbors.
* :func:`resample_poly` — gcd reduction, kaiser-designed lowpass,
  centered-delay trimming, exactly scipy's bookkeeping (all host/static).
* :func:`decimate` — FIR decimation via :func:`resample_poly` (zero-phase)
  or causal :func:`upfirdn`.  **Deviation**: ``ftype`` defaults to
  ``"fir"`` and ``"iir"`` raises — scipy's default 8th-order Chebyshev
  ``sosfiltfilt`` is a sequential recursion along the dim, which is
  hostile to XLA (a length-n ``lax.scan`` of scalar work); the FIR
  path is the data-parallel decimator and matches
  ``scipy.signal.decimate(..., ftype='fir')`` exactly.

Coordinate-aware beyond scipy: when the resampled dim carries an evenly
spaced coordinate, :func:`resample_poly` / :func:`decimate` rebuild it as
``x0 + arange(n_out) * (dx * down / up)`` (the zero-phase filter delay is
compensated, so output samples sit on the input's time base);
:func:`upfirdn` is index-based like scipy's and drops the dim coordinate.
"""

from __future__ import annotations

import math

import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray
from .convolve import _fft_convolve
from .spectra import _norm_1d_dim

__all__ = ["firwin", "upfirdn", "resample_poly", "decimate",
           "savgol_coeffs", "savgol_filter"]


# ---------------------------------------------------------------------------
# firwin: host/static window-method FIR design (scipy.signal.firwin)
# ---------------------------------------------------------------------------


def _kaiser_beta(a):
    """scipy.signal.kaiser_beta: empirical attenuation->beta map."""
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def _kaiser_atten(numtaps, width):
    """scipy.signal.kaiser_atten: attenuation of a numtaps kaiser filter
    with normalized transition width `width`."""
    return 2.285 * (numtaps - 1) * np.pi * width + 7.95


def firwin(numtaps, cutoff, width=None, window="hamming", pass_zero=True,
           scale=True, fs=None) -> np.ndarray:
    """Window-method FIR filter design — ``scipy.signal.firwin``: returns
    the ``numtaps`` coefficients of a linear-phase filter whose passbands
    are delimited by ``cutoff`` (in units of ``fs/2``, or of ``fs`` when
    given).  ``pass_zero`` in {True, False, 'lowpass', 'highpass',
    'bandpass', 'bandstop'}; ``width`` selects a kaiser window by
    transition width.  Host-side numpy (taps are static constants); feed
    the result to :func:`upfirdn`, :func:`resample_poly`, or
    :func:`xrft_tpu.convolve`.
    """
    nyq = 0.5 * (2.0 if fs is None else float(fs))
    cutoff = np.atleast_1d(np.asarray(cutoff, dtype=np.float64)) / nyq
    if cutoff.ndim > 1:
        raise ValueError("The cutoff argument must be at most "
                         "one-dimensional.")
    if cutoff.size == 0:
        raise ValueError("At least one cutoff frequency must be given.")
    if cutoff.min() <= 0 or cutoff.max() >= 1:
        raise ValueError("Invalid cutoff frequency: frequencies must be "
                         "greater than 0 and less than fs/2.")
    if np.any(np.diff(cutoff) <= 0):
        raise ValueError("Invalid cutoff frequencies: the frequencies "
                         "must be strictly increasing.")

    if width is not None:
        window = ("kaiser",
                  _kaiser_beta(_kaiser_atten(numtaps, float(width) / nyq)))

    if pass_zero in ("bandstop", "lowpass"):
        if pass_zero == "lowpass" and cutoff.size != 1:
            raise ValueError("cutoff must have one element if "
                             f"pass_zero=='lowpass', got {cutoff.shape}")
        if pass_zero == "bandstop" and cutoff.size <= 1:
            raise ValueError("cutoff must have at least two elements if "
                             f"pass_zero=='bandstop', got {cutoff.shape}")
        pass_zero = True
    elif pass_zero in ("bandpass", "highpass"):
        if pass_zero == "highpass" and cutoff.size != 1:
            raise ValueError("cutoff must have one element if "
                             f"pass_zero=='highpass', got {cutoff.shape}")
        if pass_zero == "bandpass" and cutoff.size <= 1:
            raise ValueError("cutoff must have at least two elements if "
                             f"pass_zero=='bandpass', got {cutoff.shape}")
        pass_zero = False
    elif pass_zero is not True and pass_zero is not False:
        raise ValueError(
            f"Parameter pass_zero={pass_zero!r} not in (True, False, "
            "'bandpass', 'lowpass', 'highpass', 'bandstop')")

    pass_nyquist = (cutoff.size % 2 == 0) == pass_zero
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError("A filter with an even number of coefficients "
                         "must have zero response at the Nyquist "
                         "frequency.")

    bands = np.concatenate([
        np.zeros(int(pass_zero)), cutoff, np.ones(int(pass_nyquist))
    ]).reshape(-1, 2)

    m = np.arange(numtaps, dtype=np.float64) - 0.5 * (numtaps - 1)
    h = np.zeros(numtaps)
    for left, right in bands:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)

    import scipy.signal as sps  # host-static, like ops/window.py

    h *= np.asarray(sps.get_window(window, numtaps, fftbins=False),
                    dtype=np.float64)

    if scale:
        left, right = bands[0]
        scale_frequency = (0.0 if left == 0
                           else 1.0 if right == 1
                           else 0.5 * (left + right))
        h /= np.sum(h * np.cos(np.pi * m * scale_frequency))
    return h


# ---------------------------------------------------------------------------
# upfirdn: zero-stuff -> FFT-convolve -> strided slice (one XLA program)
# ---------------------------------------------------------------------------


def _output_len(len_h, in_len, up, down):
    """scipy.signal.upfirdn's output length."""
    return ((in_len - 1) * up + len_h - 1) // down + 1


def _zero_stuff(x, ax, up):
    """Insert ``up - 1`` zeros after every sample along ``ax`` (static
    reshape + pad; no scatter)."""
    if up == 1:
        return x
    shape = list(x.shape)
    expanded = carray.reshape(x, shape[:ax + 1] + [1] + shape[ax + 1:])
    pads = [(0, 0)] * (len(shape) + 1)
    pads[ax + 1] = (0, up - 1)
    stuffed = carray.pad(expanded, pads)
    return carray.reshape(
        stuffed, shape[:ax] + [shape[ax] * up] + shape[ax + 1:])


def upfirdn(h, da, up=1, down=1, dim=None, mode="constant", cval=0,
            engine=None) -> LabeledArray:
    """Upsample by ``up`` (zero-stuffing), apply the FIR filter ``h``
    (a 1-D host array of taps), downsample by ``down`` —
    ``scipy.signal.upfirdn`` values along ``dim`` (default: last dim).
    Output length is ``((n-1)*up + len(h) - 1) // down + 1``.  Index-based
    like scipy's: the dim's coordinate is dropped (its length changes);
    use :func:`resample_poly` for the coordinate-aware estimator.  Only
    scipy's default boundary (``mode='constant', cval=0``) is supported —
    other modes pre-pad explicitly with :func:`xrft_tpu.pad`.
    """
    if mode != "constant" or cval != 0:
        raise NotImplementedError(
            "upfirdn: only mode='constant' with cval=0 is supported; "
            "pre-pad the signal explicitly with xrft_tpu.pad for other "
            "boundaries")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("upfirdn: up and down must be >= 1")
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 1 or h.size == 0:
        raise ValueError("upfirdn: h must be a non-empty 1-D array of "
                         "filter taps")
    dim = _norm_1d_dim(da, dim, "upfirdn")
    ax = da.dims.index(dim)
    n = da.sizes[dim]

    real_out = not carray.is_complex(da.data)
    x = _zero_stuff(da.data, ax, up)
    n_up = n * up
    hshape = [1] * da.ndim
    hshape[ax] = h.size
    hv = carray.constant(h.reshape(hshape), x)
    y = _fft_convolve(x, hv, [ax], [n_up], [h.size], engine)
    n_out = _output_len(h.size, n, up, down)
    key = [slice(None)] * da.ndim
    key[ax] = slice(0, (n_out - 1) * down + 1, down)
    y = carray.getitem(y, tuple(key))
    if real_out:
        y = carray.real(y)

    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


# ---------------------------------------------------------------------------
# resample_poly / decimate
# ---------------------------------------------------------------------------


def _rebuilt_coord(da, dim, n_out, up, down):
    """Output coordinate x0 + arange(n_out) * dx*down/up (signed dx)."""
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    if dim in da.coords and ce.is_valid_fft_coord(da.coords[dim]):
        old = np.asarray(da.coords[dim].values)
        dx = ce.diff_coord(da.coords[dim])[0]
        coords[dim] = Coord((dim,), old.flat[0] + np.arange(n_out)
                            * (dx * down / up),
                            dict(da.coords[dim].attrs), dim)
    return coords


def resample_poly(da, up, down, dim=None, window=("kaiser", 5.0),
                  padtype="constant", cval=None,
                  engine=None) -> LabeledArray:
    """Polyphase resampling by the rational factor ``up/down`` along
    ``dim`` — ``scipy.signal.resample_poly``: gcd-reduce the ratio,
    design a kaiser lowpass at ``1/max(up, down)`` (or take ``window`` as
    explicit taps), zero-stuff/filter/downsample with the filter delay
    centered, output length ``ceil(n * up / down)``.  ``padtype`` in
    {'constant' (zeros, scipy default), 'mean', 'median', 'minimum',
    'maximum'} — the statistic padtypes subtract the per-dim background
    before filtering and add it back, like scipy.  The dim's coordinate,
    if any, is rebuilt with spacing ``dx * down / up`` from the same
    origin.
    """
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("resample_poly: up and down must be >= 1")
    if cval is not None and padtype != "constant":
        raise ValueError("cval has no effect when padtype is "
                         f"{padtype!r}")
    if cval not in (None, 0):
        raise NotImplementedError(
            "resample_poly: nonzero cval is unsupported; pre-pad "
            "explicitly with xrft_tpu.pad")
    dim = _norm_1d_dim(da, dim, "resample_poly")
    ax = da.dims.index(dim)
    g = math.gcd(up, down)
    up //= g
    down //= g
    n_in = da.sizes[dim]
    n_out = n_in * up // down + bool(n_in * up % down)
    if up == down == 1:
        return da.copy()

    if isinstance(window, (list, np.ndarray)):
        h = np.asarray(window, dtype=np.float64)
        if h.ndim != 1:
            raise ValueError("window must be 1-D")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    h = h * up

    # center the output samples: pre/post zero-pad the taps so the first
    # kept output is the filter's group-delay-compensated sample 0
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while _output_len(h.size + n_pre_pad + n_post_pad, n_in,
                      up, down) < n_out + n_pre_remove:
        n_post_pad += 1
    h = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])

    funcs = {"mean": np.mean, "median": np.median,
             "minimum": np.min, "maximum": np.max}
    background = None
    x = da
    if padtype in funcs:
        import jax.numpy as jnp

        fn = {"mean": jnp.mean, "median": jnp.median,
              "minimum": jnp.min, "maximum": jnp.max}[padtype]
        if carray.is_pair(da.data):
            background = carray.ComplexPair(
                fn(da.data.re, axis=ax, keepdims=True),
                fn(da.data.im, axis=ax, keepdims=True))
            x = da.copy(data=carray.ComplexPair(
                da.data.re - background.re, da.data.im - background.im))
        else:
            background = fn(da.data, axis=ax, keepdims=True)
            x = da.copy(data=da.data - background)
    elif padtype != "constant":
        raise NotImplementedError(
            f"resample_poly: padtype {padtype!r} is unsupported; use "
            "'constant'/'mean'/'median'/'minimum'/'maximum' or pre-pad "
            "explicitly with xrft_tpu.pad")

    y = upfirdn(h, x, up, down, dim=dim, engine=engine)
    key = [slice(None)] * da.ndim
    key[ax] = slice(n_pre_remove, n_pre_remove + n_out)
    data = carray.getitem(y.data, tuple(key))
    if background is not None:
        if carray.is_pair(data):
            data = carray.ComplexPair(data.re + background.re,
                                      data.im + background.im)
        else:
            data = data + background

    coords = _rebuilt_coord(da, dim, n_out, up, down)
    return LabeledArray(data, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def decimate(da, q, n=None, ftype="fir", dim=None, zero_phase=True,
             engine=None) -> LabeledArray:
    """Downsample by the integer factor ``q`` after an anti-aliasing FIR
    filter — ``scipy.signal.decimate(..., ftype='fir')`` values: a
    ``firwin(n+1, 1/q, window='hamming')`` lowpass (default order
    ``n = 20*q``), applied zero-phase via :func:`resample_poly` (default)
    or causally via :func:`upfirdn` (``zero_phase=False``; the result
    then lags by the filter's group delay, like scipy's).

    **Deviation from scipy**: ``ftype`` defaults to ``'fir'`` and
    ``'iir'`` raises — scipy's default Chebyshev ``sosfiltfilt`` is a
    sequential recursion along the dim (a length-n scan of scalar work),
    hostile to XLA; the linear-phase FIR path is the data-parallel
    decimator.  The dim's coordinate, if any, is rebuilt with spacing
    ``dx * q`` from the same origin.
    """
    q = int(q)
    if q < 1:
        raise ValueError("decimate: q must be a positive integer")
    if ftype == "iir":
        raise NotImplementedError(
            "decimate: ftype='iir' (scipy's default sosfiltfilt Chebyshev "
            "cascade) is a sequential recursion along the dim and is not "
            "implemented on this backend; use ftype='fir' (matches "
            "scipy.signal.decimate(..., ftype='fir') exactly)")
    if ftype != "fir":
        raise ValueError("decimate: ftype must be 'fir'")
    if n is None:
        n = 20 * q
    b = firwin(int(n) + 1, 1.0 / q, window="hamming")
    dim = _norm_1d_dim(da, dim, "decimate")
    if zero_phase:
        res = resample_poly(da, 1, q, dim=dim, window=b, engine=engine)
    else:
        n_in = da.sizes[dim]
        n_out = n_in // q + bool(n_in % q)
        y = upfirdn(b, da, 1, q, dim=dim, engine=engine)
        ax = da.dims.index(dim)
        key = [slice(None)] * da.ndim
        key[ax] = slice(0, n_out)
        res = LabeledArray(carray.getitem(y.data, tuple(key)),
                           dims=list(da.dims),
                           coords=_rebuilt_coord(da, dim, n_out, 1, q),
                           attrs=dict(da.attrs), name=da.name)
    res.name = f"{da.name}_decimated" if da.name else None
    return res


# ---------------------------------------------------------------------------
# Savitzky-Golay smoothing: host-static design + one conv + static
# edge-fit matrices
# ---------------------------------------------------------------------------


def savgol_coeffs(window_length, polyorder, deriv=0, delta=1.0, pos=None,
                  use="conv") -> np.ndarray:
    """Savitzky-Golay FIR coefficients — ``scipy.signal.savgol_coeffs``:
    the least-squares polynomial-smoothing (or ``deriv``-th derivative)
    filter of length ``window_length`` evaluated at ``pos`` (default:
    the center).  Pure host numpy; the taps are static constants.
    """
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length.")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not 0 <= pos < window_length:
        raise ValueError("pos must be nonnegative and less than "
                         "window_length.")
    if use not in ("conv", "dot"):
        raise ValueError("`use` must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    A = x ** np.arange(polyorder + 1, dtype=np.float64)[:, None]
    y = np.zeros(polyorder + 1)
    y[deriv] = math.factorial(deriv) / (delta ** deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


def _edge_fit_matrix(window_length, polyorder, deriv, delta, interp_idx):
    """The linear map from the ``window_length`` edge samples to the
    polyfit-interpolated values at local positions ``interp_idx``
    (scipy's ``_fit_edge`` is linear in the data: polyfit o polyder o
    polyval composes into one host matrix)."""
    t = np.arange(window_length, dtype=np.float64)
    V = np.vander(t, polyorder + 1)  # highest power first, like polyfit
    P = np.linalg.pinv(V)  # samples -> poly coeffs (p+1, w)
    # polyder (highest-first convention), deriv times
    D = np.eye(polyorder + 1)
    for _ in range(deriv):
        k = D.shape[0] - 1
        if k == 0:
            D = np.zeros((1, polyorder + 1)) @ D
            break
        D = (np.arange(k, 0, -1)[:, None] * np.eye(k, k + 1)) @ D
    i = np.asarray(interp_idx, dtype=np.float64)
    Veval = np.vander(i, D.shape[0])
    return (Veval @ D @ P) / (delta ** deriv)


def savgol_filter(da, window_length, polyorder, deriv=0, delta=1.0,
                  dim=None, mode="interp", cval=0.0,
                  engine=None) -> LabeledArray:
    """Savitzky-Golay smoothing/differentiation along ``dim`` (default:
    last dim) — ``scipy.signal.savgol_filter``: one FIR convolution with
    the host-static least-squares taps; ``mode`` in {'interp' (scipy
    default: the ``window_length // 2`` edge samples are replaced by a
    polynomial fitted to the first/last ``window_length`` samples —
    here a static edge-fit *matrix* applied as one dot, since polyfit o
    polyval is linear in the data), 'mirror', 'nearest', 'constant',
    'wrap'}.  Same-length output; index-based, so dims/coords pass
    through untouched (``delta`` carries the sample spacing, like
    scipy).  Real input only.
    """
    if mode not in ("mirror", "constant", "nearest", "interp", "wrap"):
        raise ValueError("mode must be 'mirror', 'constant', 'nearest' "
                         "'wrap' or 'interp'.")
    dim = _norm_1d_dim(da, dim, "savgol_filter")
    if carray.is_complex(da.data):
        raise ValueError("savgol_filter: input must be real")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    w = int(window_length)
    halflen = w // 2
    coeffs = savgol_coeffs(w, polyorder, deriv=deriv, delta=delta)

    x = da.data
    if mode == "interp":
        if w > n:
            raise ValueError("If mode is 'interp', window_length must be "
                             "less than or equal to the size of x.")
        pads = [(0, 0)] * da.ndim
        pads[ax] = (w - 1 - halflen, halflen)
        xp = carray.pad(x, pads)
    else:
        jmode = {"mirror": "reflect", "nearest": "edge", "wrap": "wrap",
                 "constant": "constant"}[mode]
        pads = [(0, 0)] * da.ndim
        # ndimage.convolve1d centers an even-length kernel at w//2, so
        # the LEFT extension is w-1-halflen and the RIGHT is halflen
        pads[ax] = (w - 1 - halflen, halflen)
        kw = dict(constant_values=cval) if jmode == "constant" else {}
        xp = carray.pad(x, pads, mode=jmode, **kw)

    # 'valid' correlation with the (already conv-reversed) taps ==
    # ndimage.convolve1d's aligned output: full conv, keep rows
    # [w-1, w-1+n)
    hshape = [1] * da.ndim
    hshape[ax] = w
    hv = carray.constant(coeffs.reshape(hshape), xp)
    y = _fft_convolve(xp, hv, [ax], [n + w - 1], [w], engine)
    key = [slice(None)] * da.ndim
    key[ax] = slice(w - 1, w - 1 + n)
    y = carray.getitem(y, tuple(key))
    y = carray.real(y)

    if mode == "interp" and halflen > 0:
        import jax.numpy as jnp

        from .ops.matmul_fft import _precision

        El = _edge_fit_matrix(w, polyorder, deriv, delta,
                              np.arange(halflen))
        Er = _edge_fit_matrix(w, polyorder, deriv, delta,
                              np.arange(w - halflen, w))
        xm = jnp.moveaxis(x if not carray.is_pair(x) else x.re, ax, -1)
        fdt = xm.dtype
        head = jnp.einsum("ij,...j->...i", jnp.asarray(El, dtype=fdt),
                          xm[..., :w], precision=_precision())
        tail = jnp.einsum("ij,...j->...i", jnp.asarray(Er, dtype=fdt),
                          xm[..., n - w:], precision=_precision())
        ym = jnp.moveaxis(y, ax, -1)
        ym = jnp.concatenate(
            [head, ym[..., halflen:n - halflen], tail], axis=-1)
        y = jnp.moveaxis(ym, -1, ax)

    out = da.copy(data=y)
    out.name = f"{da.name}_savgol" if da.name else None
    return out
