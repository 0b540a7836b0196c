"""Parseval identities and Welch segmenting.

Runnable port of the reference's ``doc/Parseval_example.ipynb`` and
``doc/chunk_example.ipynb``: amplitude-true Parseval checks on arbitrary
grids, window corrections recovering signal RMS and peak amplitude, and
``chunks_to_segments`` Welch averaging.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import xrft_tpu
from xrft_tpu import LabeledArray

rng = np.random.RandomState(0)

# --- Parseval with true amplitude on an arbitrary grid --------------------
Nx = 40
dx = rng.rand()
x = dx * (np.arange(-Nx // 2, -Nx // 2 + Nx) + rng.randint(-Nx // 2, Nx // 2))
da = LabeledArray(rng.rand(Nx) + 1j * rng.rand(Nx), dims="x",
                  coords={"x": x})
FT = xrft_tpu.fft(da, dim="x", true_phase=True, true_amplitude=True)
lhs = (np.abs(da.values) ** 2).sum() * dx
rhs = (np.abs(FT.values) ** 2).sum() * FT["freq_x"].attrs["spacing"]
print(f"Parseval: signal energy {lhs:.12f} == spectral energy {rhs:.12f}")

# --- Welch segmenting + window corrections --------------------------------
A = 20
fs = 1e4
n_segments = int(fs // 10)
fsig = 300
tt = np.arange(fs) / fs
sig = A * np.sin(2 * np.pi * fsig * tt)
x_da = LabeledArray(sig, dims=["t"], coords={"t": tt}).chunk(
    {"t": n_segments}
)

ps = xrft_tpu.power_spectrum(
    x_da, dim="t", window="hann", chunks_to_segments=True,
    window_correction=True,
).mean("t_segment")
rms = np.sqrt(np.trapezoid(ps.values, ps["freq_t"].values))
print(f"energy-corrected Welch PSD: integral RMS {rms:.4f} "
      f"(theory {A * np.sqrt(2) / 2:.4f})")

ps_amp = xrft_tpu.power_spectrum(
    x_da, dim="t", window="hann", chunks_to_segments=True,
    scaling="spectrum", window_correction=True,
).mean("t_segment")
peak = ps_amp.sel(freq_t=fsig, method="nearest").item()
print(f"amplitude-corrected spectrum peak: {peak:.4f} "
      f"(theory {0.5 * A**2 / 2:.4f})")

# ---------------------------------------------------------------------------
# One-sided Welch estimate == scipy.signal.welch
#
# power_spectrum(real_dim=...) emits the one-sided convention directly
# (doubling on the real axis except DC/Nyquist); with density scaling,
# hann window, window_correction and non-overlapping segments the
# segment mean IS scipy.signal.welch(noverlap=0, detrend=False).
# ---------------------------------------------------------------------------
import scipy.signal as sps

ps_one = xrft_tpu.power_spectrum(
    x_da, dim="t", real_dim="t", window="hann", chunks_to_segments=True,
    window_correction=True,
).mean("t_segment")

fs = 1.0 / float(np.diff(tt)[0])
f_ref, p_ref = sps.welch(sig, fs=fs, window="hann", nperseg=n_segments,
                         noverlap=0, detrend=False)
err = np.abs(np.asarray(ps_one.values) - p_ref).max() / p_ref.max()
print(f"one-sided Welch vs scipy.signal.welch: max rel err {err:.2e}")
assert err < 1e-6, err
assert np.allclose(ps_one["freq_t"].values, f_ref)
