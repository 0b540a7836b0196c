"""int8-limb (Ozaki-style) DFT.

Exact decompositions are asserted here, and end accuracy against numpy
complex128; scripts/chip_checks.py pins it on the GPU too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from xrft_tpu.ops.df64_fft import df64_to_numpy
from xrft_tpu.ops.int8_dft import LW, _w_limbs_np, _x_limbs, int8_dft_last


def test_w_limb_reconstruction_exact():
    n = 64
    wl, wscale = _w_limbs_np(n, -1, "re")
    W = sum(l.astype(np.float64) * 2.0 ** (7 * (LW - 1 - q))
            for q, l in enumerate(wl)) * wscale
    ref = np.cos(-2 * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    npt.assert_allclose(W, ref, atol=1e-13)


def test_x_limb_reconstruction_exact():
    x = np.random.RandomState(0).randn(4, 64).astype(np.float32)
    limbs, scales, S = _x_limbs(jnp.asarray(x), None)
    u = sum(np.asarray(l, np.float64) * sc for l, sc in zip(limbs, scales))
    npt.assert_allclose(u * np.asarray(S, np.float64), x, atol=0.0)


def test_int8_dft_cpu_tolerance():
    # f32-grade bound; the compiled path holds ~1e-14 (see ops/df64.py)
    x = np.random.RandomState(1).randn(8, 256).astype(np.float32)
    got = df64_to_numpy(jax.jit(lambda a: int8_dft_last(a, -1))(x))
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    npt.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(),
                        atol=5e-6)


def test_int8_dft_size_guard():
    import pytest

    with pytest.raises(ValueError, match="2000"):
        int8_dft_last(np.zeros((2, 4096), np.float32))


def test_int8_fft_composed_cpu_tolerance():
    from xrft_tpu.ops.int8_dft import int8_fft_last

    x = np.random.RandomState(3).randn(4, 4096).astype(np.float32)
    got = df64_to_numpy(jax.jit(lambda a: int8_fft_last(a, -1))(x))
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    npt.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(),
                        atol=5e-6)


def test_int8_dft_complex_input_cpu_tolerance():
    from xrft_tpu.ops.df64_fft import as_df64
    from xrft_tpu.ops.int8_dft import int8_dft_last

    z = (np.random.RandomState(4).randn(4, 256)
         + 1j * np.random.RandomState(5).randn(4, 256))
    x4 = tuple(np.asarray(v) for v in as_df64(z))
    got = df64_to_numpy(jax.jit(lambda a: int8_dft_last(a, -1))(x4))
    ref = np.fft.fft(z, axis=-1)
    npt.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(),
                        atol=5e-6)


@pytest.mark.parametrize("exponent", [-120, -99, -40, -24, 0, 1, 37, 100])
def test_x_limb_scale_is_exact_power_of_two(exponent):
    """The per-row scale S is an exact power of two just above max|x|,
    built from exponent bits (not log2/exp2, which may be approximate on
    a GPU), and the two-level limbs reconstruct the row exactly."""
    rng = np.random.RandomState(exponent + 200)
    x = (rng.randn(3, 40) * 2.0 ** exponent).astype(np.float32)
    x[1, 7] = np.float32(2.0 ** exponent)   # a power-of-two row maximum
    limbs, scales, S = jax.jit(lambda v: _x_limbs(v, v.shape[:-1]))(x)
    S = np.asarray(S, np.float64)
    amax = np.abs(x).max(axis=-1, keepdims=True).astype(np.float64)
    npt.assert_array_equal(np.log2(S), np.round(np.log2(S)))
    assert np.all(S > amax) and np.all(S <= 2 * amax)
    rec = sum(np.asarray(lb, np.float64) * np.asarray(sc, np.float64)
              for lb, sc in zip(limbs, scales)) * S
    npt.assert_array_equal(rec, x.astype(np.float64))
