"""Optional xarray interop.

When xarray is installed, :func:`from_xarray` / :func:`to_xarray` convert
between ``xarray.DataArray`` and :class:`~xrft_tpu.labeled.LabeledArray`
losslessly (dims, 1-D and multi-dim coords, attrs, name), so existing
xrft-based analysis code can move to these pipelines by converting at the
boundary.  xarray is not a dependency of this package (it is not among the
packages the GPU deployment guarantees); both functions raise a clear
ImportError without it.
"""

from __future__ import annotations

import numpy as np

from .labeled import Coord, LabeledArray

__all__ = ["from_xarray", "to_xarray"]


def _require_xarray():
    try:
        import xarray
    except ImportError as e:  # pragma: no cover - xarray absent in CI image
        raise ImportError(
            "xarray is required for from_xarray/to_xarray; install it or "
            "construct LabeledArray directly."
        ) from e
    return xarray


def from_xarray(da) -> LabeledArray:
    """Convert an ``xarray.DataArray`` to a :class:`LabeledArray`."""
    _require_xarray()
    coords = {
        name: Coord(tuple(c.dims), np.asarray(c.values), dict(c.attrs), name)
        for name, c in da.coords.items()
    }
    return LabeledArray(
        np.asarray(da.values),
        dims=tuple(da.dims),
        coords=coords,
        attrs=dict(da.attrs),
        name=da.name,
    )


def to_xarray(la: LabeledArray):
    """Convert a :class:`LabeledArray` to an ``xarray.DataArray``."""
    xr = _require_xarray()
    coords = {}
    for name, c in la.coords.items():
        coords[name] = xr.DataArray(
            c.values, dims=c.dims, attrs=dict(c.attrs), name=name
        )
    return xr.DataArray(
        la.values,
        dims=la.dims,
        coords=coords,
        attrs=dict(la.attrs),
        name=la.name,
    )


def is_dataarray(obj) -> bool:
    """Duck-typed check for ``xarray.DataArray`` without importing xarray
    (works with any module exposing the DataArray surface we consume)."""
    t = type(obj)
    if t.__module__.split(".")[0] not in ("xarray",):
        return False
    return all(hasattr(obj, a) for a in ("dims", "coords", "attrs", "values"))


def xr_boundary(fn):
    """Wrap a public function so it accepts and returns
    ``xarray.DataArray`` (reference API surface,
    ``/root/reference/xrft/xrft.py:307-476``): DataArray positional args
    are converted via :func:`from_xarray`; if the first array argument was
    a DataArray, LabeledArray results convert back via :func:`to_xarray`.
    """
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        # the "first array argument" is the first positional that is a
        # DataArray or LabeledArray — e.g. upfirdn(h, da) keys off da,
        # not the numpy taps
        was_xr = False
        for a in args:
            if is_dataarray(a):
                was_xr = True
                break
            if isinstance(a, LabeledArray):
                break
        if was_xr or any(is_dataarray(a) for a in args):
            args = tuple(from_xarray(a) if is_dataarray(a) else a
                         for a in args)
        kwargs = {k: from_xarray(v) if is_dataarray(v) else v
                  for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        if was_xr:
            if isinstance(out, LabeledArray):
                return to_xarray(out)
            if isinstance(out, tuple):
                return tuple(to_xarray(o) if isinstance(o, LabeledArray)
                             else o for o in out)
        return out

    wrapper.__wrapped_la__ = fn
    return wrapper


class XrftAccessor:
    """``da.xrft.<method>`` accessor on xarray DataArrays, mirroring the
    package namespace (fft/ifft, spectra, isotropic estimators, pad/unpad,
    detrend, high-precision variants)."""

    _METHODS = (
        "fft", "ifft", "dft", "idft", "power_spectrum", "cross_spectrum",
        "cross_phase", "coherence", "spectrogram", "welch", "csd",
        "periodogram", "stft", "istft", "hilbert", "hilbert2", "envelope",
        "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
        "czt", "zoom_fft", "resample", "resample_poly", "decimate",
        "convolve", "fftconvolve", "oaconvolve", "correlate", "lombscargle",
        "fht", "ifht",
        "isotropize",
        "isotropic_power_spectrum", "isotropic_cross_spectrum",
        "pad", "unpad", "detrend", "fft64", "ifft64",
    )

    def __init__(self, da):
        self._da = da

    def __getattr__(self, name):
        if name not in self._METHODS:
            raise AttributeError(name)
        import xrft_tpu

        fn = getattr(xrft_tpu, name)

        def method(*args, **kwargs):
            return fn(self._da, *args, **kwargs)

        method.__name__ = name
        return method


def register_accessor(xarray_module=None) -> bool:
    """Register the ``.xrft`` DataArray accessor; returns True on success.
    Called at package import; a no-op when xarray is absent."""
    try:
        xr = xarray_module
        if xr is None:
            import xarray as xr
    except ImportError:
        return False
    try:
        xr.register_dataarray_accessor("xrft")(XrftAccessor)
    except Exception:
        return False
    return True
