"""Chirp-Z transform and zoom FFT (scipy.signal namesakes).

Beyond the reference (xrft's transforms sample the full DFT grid only,
``/root/reference/xrft/xrft.py:139-175``; no z-plane/band-limited
evaluation) — matching ``scipy.signal.czt`` / ``scipy.signal.zoom_fft``:
``X[k] = sum_n x[n] a^{-n} w^{nk}`` for ``k = 0..m-1``, i.e. ``m`` samples
of the z-transform along the spiral ``z_k = a * w^{-k}``; ``zoom_fft``
restricts to a unit-circle frequency band ``[f1, f2]`` without computing
the full spectrum.

Shape: Bluestein's identity ``nk = (n^2 + k^2 - (k-n)^2) / 2``
turns the evaluation into one circular convolution —

    X = c3 * ifft(fft(x * c1, L) * V)[:m]

where the input chirp ``c1[n] = a^{-n} w^{n^2/2}``, the output chirp
``c3[k] = w^{k^2/2}``, and ``V`` — the FFT of the chirp kernel
``w^{-j^2/2}`` — are all **host complex128 constants** baked into the
jaxpr (the kernel's FFT costs nothing at run time), ``L`` is the next
power of two ≥ ``n + m - 1`` so the one device FFT pair rides the engine
dispatch at its fastest plan.  The whole transform is two engine FFTs +
three elementwise complex multiplies, jit-traceable end to end.

``zoom_fft`` is coordinate-aware beyond scipy: the sampling rate defaults
to ``1/spacing`` of the dim's coordinate (scipy's ``fs=2`` applies only
when the dim has no coordinate), and the output carries a real frequency
coordinate ``freq_<dim>`` with a ``spacing`` attr like :func:`xrft_tpu.fft`.
"""

from __future__ import annotations

import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray, fft_core
from .spectra import _norm_1d_dim

__all__ = ["czt", "zoom_fft"]


def _cconst(vals_c128: np.ndarray, ndim: int, ax: int, rdt, split: bool):
    """Host complex constant broadcast along ``ax``, in the pipeline's
    complex representation."""
    shape = [1] * ndim
    shape[ax] = vals_c128.shape[0]
    v = vals_c128.reshape(shape)
    import jax.numpy as jnp

    if split:
        return carray.ComplexPair(jnp.asarray(v.real.astype(rdt)),
                                  jnp.asarray(v.imag.astype(rdt)))
    cdt = np.result_type(rdt, np.complex64)
    return jnp.asarray(v.astype(cdt))


def _real_dtype(x):
    dt = np.dtype(carray._float_of(x.dtype) if carray.is_pair(x)
                  else x.dtype)
    if dt.kind == "c":
        dt = np.dtype(np.float64 if dt == np.complex128 else np.float32)
    elif dt.kind != "f":
        dt = np.dtype(np.float64)
    return dt


def _czt_data(x, ax, n, m, w: complex, a: complex, engine):
    """Bluestein CZT of the array ``x`` along ``ax`` (host-constant
    chirps; one engine fft/ifft pair at the next power of two)."""
    k2 = np.arange(max(n, m), dtype=np.float64) ** 2 / 2.0
    logw_mag = np.log(np.abs(w))
    argw = np.angle(w)
    loga_mag = np.log(np.abs(a))
    arga = np.angle(a)

    def wpow(e):  # w**e elementwise for float64 exponents
        return np.exp(e * logw_mag) * np.exp(1j * e * argw)

    nn = np.arange(n, dtype=np.float64)
    c1 = np.exp(-nn * loga_mag) * np.exp(-1j * nn * arga) * wpow(k2[:n])
    c3 = wpow(k2[:m])
    L = 1 << int(np.ceil(np.log2(max(n + m - 1, 1))))
    v = np.zeros(L, dtype=np.complex128)
    v[:m] = wpow(-k2[:m])
    v[L - n + 1:] = wpow(-k2[1:n][::-1])
    V = np.fft.fft(v)

    # Balance the dynamic range across the three constant factors: the
    # convolution theorem is invariant under c1 <- c1/s1, V <- V/sV,
    # c3 <- c3*(s1*sV).  Off-circle spirals make |V| (and |c1| for
    # |a| > 1) huge while the matching ifft outputs are tiny; without
    # balancing, the on-device product fft(x*c1) * V overflows float32
    # even when every host constant is representable (~1.2e39 for
    # |w| = 1 - 1e-5, n = 4096).  With max|c1| = max|V| = 1
    # the intermediates are bounded by the signal's own FFT.
    s1 = float(np.abs(c1).max())          # >= 1 is not guaranteed, > 0 is
    sV = float(np.abs(V).max())
    comp = s1 * sV
    if (logw_mag != 0.0 or loga_mag != 0.0) and np.isfinite(comp) and comp:
        c1 = c1 / s1
        V = V / sV
        c3 = c3 * comp

    split = fft_core.use_split_complex() or carray.is_pair(x)
    rdt = _real_dtype(x)
    # Off-circle spirals need relative dynamic range exp(E) with
    # E = max(n,m)^2/2 * |log|w|| + n * |log|a||: the answer lives in
    # convolution outputs that are exp(-E) below the intermediate FFT's
    # own rounding floor once exp(E) exceeds 1/eps of the compute dtype.
    # No scaling can recover that — warn at trace time (sizes/dtype are
    # static, so this fires once).
    exp_range = (max(n, m) ** 2 / 2.0) * abs(logw_mag) + n * abs(loga_mag)
    if exp_range > -np.log(np.finfo(rdt).eps):
        import warnings

        warnings.warn(
            f"czt: the chirp dynamic range exp({exp_range:.1f}) exceeds "
            f"{np.dtype(rdt).name}'s relative precision "
            f"(1/eps = exp({-np.log(np.finfo(rdt).eps):.1f})); results "
            "will lose most or all accuracy. Keep |w| and |a| closer to "
            "1 at this length, or compute in float64 on a f64 backend.")
    u = carray.multiply(x, _cconst(c1, x.ndim, ax, rdt, split))
    pad_width = [(0, 0)] * u.ndim
    pad_width[ax] = (0, L - n)
    u = carray.pad(u, pad_width)
    U = fft_core.fftn(u, [ax], engine=engine)
    U = carray.multiply(U, _cconst(V, U.ndim, ax, rdt, carray.is_pair(U)))
    y = fft_core.ifftn(U, [ax], engine=engine)
    y = carray.getitem(y, tuple(slice(0, m) if i == ax else slice(None)
                                for i in range(y.ndim)))
    return carray.multiply(y, _cconst(c3, y.ndim, ax, rdt,
                                      carray.is_pair(y)))


def czt(da, dim=None, m=None, w=None, a=1 + 0j, engine=None) -> LabeledArray:
    """Chirp-Z transform along ``dim`` (default: last dim) —
    ``scipy.signal.czt``: ``m`` samples of the z-transform on the spiral
    ``z_k = a * w^{-k}``; ``w`` defaults to ``exp(-2j*pi/m)`` (the DFT
    circle, so ``czt(x)`` == ``fft(x)`` values).  Real or complex input;
    complex output (a split pair in split mode).  The transformed dim keeps its
    name with an integer sample index as its coordinate (the z-plane
    samples are not a frequency grid in general); other dims/coords pass
    through.
    """
    dim = _norm_1d_dim(da, dim, "czt")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError("czt: m must be a positive integer")
    w = complex(w) if w is not None else np.exp(-2j * np.pi / m)
    if w == 0:
        raise ValueError("czt: w must be nonzero")
    a = complex(a)
    y = _czt_data(da.data, ax, n, m, w, a, engine)
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    coords[dim] = Coord((dim,), np.arange(m), name=dim)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def zoom_fft(da, fn, m=None, dim=None, fs=None, endpoint=False,
             engine=None) -> LabeledArray:
    """Band-limited DFT along ``dim`` — ``scipy.signal.zoom_fft``:
    evaluate the spectrum only on ``m`` frequencies spanning ``fn = f1``
    (band ``[0, f1]``) or ``fn = [f1, f2]``, without computing (or
    storing) the full transform — the CZT with ``a`` and ``w`` on the
    unit circle.

    Coordinate-aware beyond scipy: ``fs`` defaults to ``1/spacing`` of
    the dim's coordinate when it has one (scipy's ``fs=2`` — bands in
    normalized [0, 1] frequency — applies only to coordinate-less dims),
    and the output dim is renamed ``freq_<dim>`` carrying the actual
    frequency grid with a ``spacing`` attr, like :func:`xrft_tpu.fft`.
    """
    dim = _norm_1d_dim(da, dim, "zoom_fft")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    fn = np.atleast_1d(np.asarray(fn, dtype=np.float64))
    if fn.size == 1:
        f1, f2 = 0.0, float(fn[0])
    elif fn.size == 2:
        f1, f2 = float(fn[0]), float(fn[1])
    else:
        raise ValueError("zoom_fft: fn must be a scalar or a length-2 "
                         "sequence [f1, f2]")
    if fs is None:
        if dim in da.coords:
            fs = 1.0 / ce.get_coordinate_spacing(da.coords[dim], 1e-3)
        else:
            fs = 2.0  # scipy's normalized-frequency default
    fs = float(fs)
    m = int(m) if m is not None else n
    if m < 1:
        raise ValueError("zoom_fft: m must be a positive integer")
    step = (f2 - f1) / (m - 1 if endpoint and m > 1 else m)
    w = np.exp(-2j * np.pi * step / fs)
    a = np.exp(2j * np.pi * f1 / fs)
    y = _czt_data(da.data, ax, n, m, complex(w), complex(a), engine)
    fdim = ce.freq_dim_name(dim)
    out_dims = [fdim if d == dim else d for d in da.dims]
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    coords[fdim] = Coord((fdim,), f1 + np.arange(m) * step,
                         {"spacing": step}, fdim)
    return LabeledArray(y, dims=out_dims, coords=coords,
                        attrs=dict(da.attrs), name=da.name)
