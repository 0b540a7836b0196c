# %% [markdown]
# # Parseval's theorem
#
# Narrative walkthrough mirroring the reference's Parseval notebook
# (`/root/reference/doc/Parseval_example.ipynb`): energy conservation of
# the transforms, exactly for plain signals and via window corrections for
# windowed spectra.  Executed by CI (tests/test_walkthroughs.py).

# %%
import numpy as np
import numpy.testing as npt
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray


def main():
    rng = np.random.RandomState(0)

    # %% [markdown]
    # ## 1-D: sum_x |da|^2 dx == sum_k |F(da)|^2 dk

    # %%
    Nx = 40
    dx = rng.rand()
    da = LabeledArray(
        rng.rand(Nx) + 1j * rng.rand(Nx), dims=("x",),
        coords={"x": dx * (np.arange(Nx) - Nx // 5)})

    FT = xrft_tpu.fft(da, dim="x", true_phase=True, true_amplitude=True)
    dk = FT.coords["freq_x"].attrs["spacing"]
    lhs = (np.abs(da.values) ** 2).sum() * dx
    rhs = (np.abs(np.asarray(FT.values)) ** 2).sum() * dk
    npt.assert_allclose(lhs, rhs, rtol=1e-5)

    # %% [markdown]
    # ## 2-D, and the isotropic spectrum
    #
    # The azimuthal sum conserves the total:
    # sum_K P_iso == sum_k sum_l |F|^2.

    # %%
    Ny = 60
    dy = rng.rand()
    da2 = LabeledArray(
        rng.rand(Nx, Ny) + 1j * rng.rand(Nx, Ny), dims=("x", "y"),
        coords={"x": dx * (np.arange(Nx) - Nx // 5),
                "y": dy * (np.arange(Ny) - Ny // 4)})

    FT2 = xrft_tpu.fft(da2, dim=["x", "y"], true_phase=True,
                       true_amplitude=True)
    dk2 = np.prod([FT2.coords[d].attrs["spacing"]
                   for d in ("freq_x", "freq_y")])
    lhs2 = (np.abs(da2.values) ** 2).sum() * dx * dy
    rhs2 = (np.abs(np.asarray(FT2.values)) ** 2).sum() * dk2
    npt.assert_allclose(lhs2, rhs2, rtol=1e-5)

    ps2 = xrft_tpu.power_spectrum(da2, dim=["x", "y"])
    iso = xrft_tpu.isotropic_power_spectrum(da2, dim=["x", "y"],
                                            truncate=False)
    npt.assert_allclose(np.asarray(ps2.values).sum(),
                        np.asarray(iso.values).sum(), rtol=1e-5)

    # %% [markdown]
    # ## Windowed spectra and the two corrections
    #
    # With `scaling="density"` + `window_correction=True` the spectrum
    # divides by mean(w^2): the integrated PSD recovers the signal's
    # RMS^2 (energy correction).  With `scaling="spectrum"` it divides by
    # mean(w)^2: peak amplitudes are restored (amplitude correction).

    # %%
    A = 20.0
    fs = 1e4
    n_seg = int(fs // 10)
    fsig = 300
    ii = int(fsig * n_seg // fs)
    tt = np.arange(n_seg) / fs
    xsig = A * np.sin(2 * np.pi * fsig * tt)
    RMS = np.sqrt(np.mean(xsig ** 2))

    for window_type in ("hann", "bartlett", "tukey", "flattop"):
        x_da = LabeledArray(xsig.astype(np.float32), dims=("t",),
                            coords={"t": tt})
        psd = xrft_tpu.power_spectrum(x_da, dim="t", window=window_type,
                                      scaling="density",
                                      window_correction=True)
        df = psd.coords["freq_t"].attrs["spacing"]
        # energy correction: integral of the PSD ~ RMS^2 (trapezoid, as
        # the reference notebook does)
        total = np.trapezoid(np.asarray(psd.values),
                             psd.coords["freq_t"].values)
        npt.assert_allclose(total, RMS**2, rtol=0.2)

        spec = xrft_tpu.power_spectrum(x_da, dim="t", window=window_type,
                                       scaling="spectrum",
                                       window_correction=True)
        # amplitude correction: the peak recovers the tone's RMS^2 power
        # (A^2/4 per one of the two symmetric lines)
        vals = np.asarray(spec.values)
        peak = vals[np.argmax(vals)]
        npt.assert_allclose(peak, A**2 / 4, rtol=0.05)

    # %% [markdown]
    # ## Exact conservation at float64 grade
    #
    # The hp engine holds Parseval to ~1e-13 even for the windowed
    # pipeline's scalings (scripts/chip_checks.py pins it on the GPU).

    # %%
    da32 = LabeledArray(rng.randn(128).astype(np.float32), dims=("x",),
                        coords={"x": np.arange(128) * 0.37})
    FT64 = xrft_tpu.fft(da32, dim="x", engine="hp")
    dk64 = FT64.coords["freq_x"].attrs["spacing"]
    lhs = (np.abs(np.asarray(da32.values, np.float64)) ** 2).sum() * 0.37
    rhs = (np.abs(np.asarray(FT64.values)) ** 2).sum() * dk64
    npt.assert_allclose(lhs, rhs, rtol=1e-12)
    return True


if __name__ == "__main__":
    main()
    print("ok")
