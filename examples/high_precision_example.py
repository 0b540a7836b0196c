"""float64-grade spectra through ``engine='hp'`` and ``fft64``.

With x64 on, the hp path runs native float64 (the c128 XLA FFT); without
it, the df64 (double-word float32) emulation with exact int8-limb DFT
dots (~1e-12 relative accuracy).  The same code meets 1e-10 either way.
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import xrft_tpu
from xrft_tpu import LabeledArray

N = 1024
dx = 0.37
rng = np.random.RandomState(0)
x = dx * (np.arange(N) - 100)
sig = rng.randn(N).astype(np.float32)
da = LabeledArray(sig, dims=["x"], coords={"x": x})

F64 = xrft_tpu.fft64(da, dim="x")           # complex128 result
F32 = xrft_tpu.fft(da, dim="x", true_phase=True, true_amplitude=True)

lhs = (np.abs(sig.astype(np.float64)) ** 2).sum() * dx
for name, F in [("fft64", F64.values),
                ("fft (f32 engine)", np.asarray(F32.values))]:
    rhs = (np.abs(F) ** 2).sum() * F64["freq_x"].attrs["spacing"]
    print(f"{name:18s} Parseval relative error: {abs(lhs - rhs) / lhs:.2e}")

back = xrft_tpu.ifft64(F64, lag=F64["freq_x"].attrs["direct_lag"])
print(f"fft64 roundtrip max error: "
      f"{np.abs(back.values.real - sig).max():.2e}")
