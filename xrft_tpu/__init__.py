"""xrft_tpu: spectral analysis in JAX.

A ground-up rebuild of the capabilities of xrft (xgcm/xrft) for
accelerators: jit-compiled N-D real/complex Fourier transforms with
physically-correct phase and amplitude coordinate handling, detrending,
windowing, padding, and spectral estimators — executed as fused XLA
programs (cuFFT on an NVIDIA GPU), with `jax.sharding` pencil
decomposition in place of dask chunking.
"""

from .config import complex_mode, config, fft_engine, set_fft_engine  # noqa: F401
from .labeled import Coord, LabeledArray  # noqa: F401
from .transform import dft, fft, idft, ifft  # noqa: F401
from .spectra import (  # noqa: F401
    coherence, cross_phase, cross_spectrum, csd, periodogram,
    power_spectrum, spectrogram, welch,
)
from .isotropic import (  # noqa: F401
    fit_loglog,
    isotropic_cross_spectrum,
    isotropic_power_spectrum,
    isotropize,
)
from .stft import istft, stft  # noqa: F401
from .analytic import envelope, hilbert, hilbert2  # noqa: F401
from .trig import (  # noqa: F401
    dct, dctn, dst, dstn, idct, idctn, idst, idstn,
)
from .czt import czt, zoom_fft  # noqa: F401
from .resample import resample  # noqa: F401
from .filter import (  # noqa: F401
    decimate, firwin, resample_poly, savgol_coeffs, savgol_filter, upfirdn,
)
from .lombscargle import lombscargle  # noqa: F401
from .fht import fht, fhtoffset, ifht  # noqa: F401
from .convolve import (  # noqa: F401
    choose_conv_method, convolve, correlate, fftconvolve, oaconvolve,
)
from .detrend import detrend  # noqa: F401
from .padding import pad, unpad  # noqa: F401
from .highprec import fft64, ifft64  # noqa: F401

# xarray at the API boundary: every public array function accepts and
# returns xarray.DataArray when given one (the reference's native surface,
# /root/reference/xrft/xrft.py:307); plus the `da.xrft` accessor when
# xarray is importable.
from .xarray_compat import from_xarray, to_xarray, xr_boundary  # noqa: F401

for _name in (
    "fft", "ifft", "dft", "idft", "power_spectrum", "cross_spectrum",
    "cross_phase", "coherence", "spectrogram", "welch", "csd",
    "periodogram", "stft", "istft", "hilbert", "hilbert2", "envelope",
    "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn",
    "czt", "zoom_fft", "resample",
    "upfirdn", "resample_poly", "decimate", "savgol_filter",
    "convolve", "fftconvolve", "oaconvolve", "correlate",
    "choose_conv_method", "lombscargle", "fht", "ifht",
    "isotropize",
    "isotropic_power_spectrum", "isotropic_cross_spectrum", "pad", "unpad",
    "detrend", "fft64", "ifft64",
):
    globals()[_name] = xr_boundary(globals()[_name])
del _name

from .xarray_compat import register_accessor as _register_accessor

_register_accessor()

__version__ = "0.1.0"
