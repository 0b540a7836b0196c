# %% [markdown]
# # Discrete and inverse discrete Fourier transforms
#
# Narrative walkthrough mirroring the reference's DFT-iDFT notebook
# (`/root/reference/doc/DFT-iDFT_example.ipynb`): how the transform layer
# harnesses coordinate metadata — `true_phase` recovers the physically
# correct spectral phase for signals whose coordinates are not centered on
# zero, and `true_amplitude` matches the continuous-transform amplitude
# convention.  Executed by CI (tests/test_walkthroughs.py); every claim is
# an assertion.

# %%
import numpy as np
import numpy.testing as npt

import xrft_tpu
from xrft_tpu import LabeledArray


def main():
    # %% [markdown]
    # ## Synthetic data centered around zero
    #
    # A truncated cosine: its continuous Fourier transform is a pair of
    # sinc lobes at +-k0.

    # %%
    k0 = 1 / 0.52
    T = 4.0
    dx = 0.02
    x = np.arange(-2 * T, 2 * T, dx)
    y = np.cos(2 * np.pi * k0 * x)
    y[np.abs(x) > T / 2] = 0.0
    da = LabeledArray(y, dims=("x",), coords={"x": x})

    # %% [markdown]
    # Transform with full phase/amplitude handling (`dft` is the
    # deprecated alias the notebook uses; `fft` with flags is identical).

    # %%
    da_dft = xrft_tpu.dft(da, true_phase=True, true_amplitude=True)

    k = da_dft.coords["freq_x"].values
    TF_theory = T / 2 * (np.sinc(T * (k - k0)) + np.sinc(T * (k + k0)))
    # the notebook's grid (dx=0.02) carries ~1e-2 discretization error vs
    # the continuous-transform theory; the reference's pinned test uses
    # dx=1e-4 to reach atol=1e-3 (test_xrft.py:1210-1228)
    npt.assert_allclose(np.asarray(da_dft.values).real, TF_theory,
                        atol=1e-2)

    # %% [markdown]
    # The inverse transform round-trips to the original signal.

    # %%
    ida = xrft_tpu.idft(da_dft, true_phase=True, true_amplitude=True,
                        lag=float(x[x.size // 2]))
    npt.assert_allclose(np.asarray(ida.values).real, y, atol=1e-5)

    # %% [markdown]
    # ## Data NOT centered around zero — where the metadata matters
    #
    # Shift the coordinates: a naive FFT sees the same values, but the
    # physical position of the signal has moved, which must appear as a
    # linear spectral phase exp(-2i pi k x0).  `true_phase=True` tracks
    # this through the coordinate's lag.

    # %%
    nshift = 70
    x0 = dx * nshift
    nx = x[: x.size - nshift] + x0
    nyv = y[: x.size - nshift]
    nda = LabeledArray(nyv, dims=("x",), coords={"x": nx})

    nda_dft = xrft_tpu.dft(nda, true_phase=True, true_amplitude=True)
    nk = nda_dft.coords["freq_x"].values
    TF_ns = (T / 2 * (np.sinc(T * (nk - k0)) + np.sinc(T * (nk + k0)))
             * np.exp(-2j * np.pi * nk * x0))
    # same ~1e-2 discretization error scale as the centered case (the
    # peak amplitude is T/2 = 2.0; the roundtrip below is the tight check)
    npt.assert_allclose(np.asarray(nda_dft.values), TF_ns, atol=2e-2)

    # the lag is recorded for the inverse
    lag = nda_dft.coords["freq_x"].attrs["direct_lag"]

    # %% [markdown]
    # The inverse recovers both the values and (through `lag`) the
    # original, uncentered coordinates.

    # %%
    inda = xrft_tpu.idft(nda_dft, true_phase=True, true_amplitude=True,
                         lag=lag)
    npt.assert_allclose(np.asarray(inda.values).real, nyv, atol=1e-5)
    npt.assert_allclose(inda.coords["x"].values, nx, atol=1e-9)

    # %% [markdown]
    # ## High-precision variant
    #
    # The same pipeline at float64-grade accuracy: `engine="hp"` (native
    # float64 under x64, else int8-limb DFT + double-word arithmetic).

    # %%
    ft_hp = xrft_tpu.fft(nda, engine="hp")
    back_hp = xrft_tpu.ifft(ft_hp, engine="hp", lag=lag)
    npt.assert_allclose(np.asarray(back_hp.values).real,
                        nyv.astype(np.float32).astype(np.float64),
                        atol=1e-10)
    return True


if __name__ == "__main__":
    main()
    print("ok")
