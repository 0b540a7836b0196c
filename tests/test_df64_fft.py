"""df64 (emulated float64) arithmetic and transforms.

The float32 primitives never rely on a rounded product (see
xrft_tpu/ops/df64.py), so the compiled engine keeps its ~1e-14 accuracy
even where XLA:CPU's LLVM backend contracts multiplies into FMAs.  Here we
pin:

  * exactness of the primitives in strict-IEEE (eager) evaluation,
  * the compiled engine at ~1e-12 against numpy complex128, direct and
    through the four-step recursion,
  * fft64/ifft64 1e-12 parity (on CPU they use the native f64 path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.ops import df64
from xrft_tpu.ops.df64_fft import as_df64, df64_fft_nd, df64_to_numpy


def test_primitive_exactness_numpy_sim():
    """two_sum / two_prod are error-free in strict IEEE f32 (numpy)."""
    rng = np.random.RandomState(0)
    a = rng.randn(1000).astype(np.float32)
    b = rng.randn(1000).astype(np.float32)
    s, e = df64.two_sum(a, b)
    exact = a.astype(np.float64) + b.astype(np.float64)
    npt.assert_array_equal(np.float64(s) + np.float64(e), exact)
    p, e = df64.two_prod(a, b)
    exact = a.astype(np.float64) * b.astype(np.float64)
    npt.assert_array_equal(np.float64(p) + np.float64(e), exact)
    npt.assert_array_equal(np.asarray(p), a * b)   # p is fl(a*b)



@pytest.mark.parametrize("dtype,hi_bits", [(np.float32, 12), (np.float64, 27)])
def test_split_masks_the_significand(dtype, hi_bits):
    """split() halves are exact (hi + lo == a) and hi carries at most
    ``hi_bits`` significant bits, for both widths it serves."""
    rng = np.random.RandomState(1)
    a = (rng.randn(500) * 10.0 ** rng.randint(-8, 8, 500)).astype(dtype)
    hi, lo = (np.asarray(v) for v in df64.split(jnp.asarray(a)))
    assert hi.dtype == dtype
    npt.assert_array_equal(hi + lo, a)
    mant, _ = np.frexp(hi)
    npt.assert_array_equal(np.ldexp(mant, hi_bits) % 1, 0)


def test_two_prod_float64_planes_keep_float64_accuracy():
    """On the float64 planes of the native hp mode two_prod's p + e is
    the product to float64 accuracy."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(2, 1000)
    p, e = (np.asarray(v) for v in df64.two_prod(jnp.asarray(a),
                                                  jnp.asarray(b)))
    npt.assert_allclose(p + e, a * b, rtol=4e-16, atol=0)


def test_df64_dot_accuracy_numpy_sim():
    """Sequential df64 accumulation reaches ~1e-13 in strict IEEE."""
    rng = np.random.RandomState(1)
    K = 256
    x = rng.randn(K).astype(np.float32)
    w64 = np.cos(np.arange(K) * 0.37)
    wh, wl = df64.split_f64_np(w64)
    acc = (np.float32(0), np.float32(0))
    for j in range(K):
        p = df64.mul(x[j], np.float32(0), wh[j], wl[j])
        acc = df64.add(acc[0], acc[1], p[0], p[1])
    ref = np.dot(x.astype(np.float64), w64)
    got = df64.join_np(acc[0], acc[1])
    assert abs(got - ref) / abs(ref) < 1e-12


@pytest.mark.parametrize("n", [8, 100, 256])
def test_df64_direct_dft_strict(n):
    """The direct df64 DFT (n <= 256: one compensated rank-1 fori_loop),
    compiled, at ~1e-12 against numpy complex128 — forward and inverse,
    complex input, batch dims."""
    rng = np.random.RandomState(n)
    z = rng.randn(3, 2, n) + 1j * rng.randn(3, 2, n)
    x4 = as_df64(z)
    got = df64_to_numpy(jax.jit(lambda v: df64_fft_nd(v, [-1], "fft"))(x4))
    ref = np.fft.fft(z, axis=-1)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12
    inv = df64_to_numpy(df64_fft_nd(x4, [-1], "ifft"))
    ref = np.fft.ifft(z, axis=-1)
    assert np.abs(inv - ref).max() / np.abs(ref).max() < 1e-12


@pytest.mark.parametrize("n,axes", [(512, [-1]), (768, [-1]),
                                    (1024, [-1]), (320, [0])])
def test_df64_composite_recursion_strict(n, axes):
    """Sizes above the direct limit compose four-step from direct stages
    with df64 twiddles (512 = 2*256, 768 = 3*256, 320 = 2*160 on a
    leading axis), still at ~1e-12."""
    rng = np.random.RandomState(n)
    x = rng.randn(n, 4) if axes == [0] else rng.randn(4, n)
    x = x.astype(np.float32)
    got = df64_to_numpy(df64_fft_nd(x, axes, "fft"))
    ref = np.fft.fft(x.astype(np.float64), axis=axes[0])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


def test_df64_prime_size_refused():
    with pytest.raises(NotImplementedError, match="prime size 257"):
        df64_fft_nd(np.zeros((2, 257), np.float32), [-1], "fft")


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_df64_engine_cpu_tolerance(n):
    """Engine correctness through the CPU compile path (f32-grade there)."""
    rng = np.random.RandomState(n)
    x = rng.randn(4, n).astype(np.float32)
    got = df64_to_numpy(df64_fft_nd(x, [-1], "fft"))
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    npt.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(),
                        atol=5e-6)


def test_df64_engine_roundtrip_cpu():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 256).astype(np.float32)
    back = df64_to_numpy(df64_fft_nd(df64_fft_nd(x, [-1], "fft"), [-1],
                                     "ifft"))
    npt.assert_allclose(back.real, x, atol=1e-5)


def test_as_df64_exact_c128_split():
    rng = np.random.RandomState(3)
    z = rng.randn(8) + 1j * rng.randn(8)
    x4 = as_df64(z)
    # hi+lo reconstruction carries ~49-bit mantissa (2^-49 residual)
    npt.assert_allclose(df64_to_numpy(x4), z, rtol=1e-13, atol=1e-14)


def test_fft64_parseval_and_parity():
    """fft64: 1e-12 numpy parity and amplitude-true Parseval."""
    rng = np.random.RandomState(4)
    Nx = 120
    dx = 0.37
    x = dx * (np.arange(Nx) - 17)
    sig = rng.randn(Nx).astype(np.float32)
    da = LabeledArray(sig, dims=["x"], coords={"x": x})
    F = xrft_tpu.fft64(da, dim="x", true_phase=True, true_amplitude=True)
    assert F.values.dtype == np.complex128
    # parity vs an equivalently preprocessed numpy oracle
    lag = x[Nx // 2]
    f = np.fft.fftfreq(Nx, dx)
    ref = np.fft.fft(np.fft.ifftshift(sig.astype(np.float64))) \
        * np.exp(-2j * np.pi * f * lag) * dx
    ref = np.fft.fftshift(ref)
    npt.assert_allclose(F.values, ref, rtol=1e-12, atol=1e-12)
    # Parseval
    npt.assert_allclose(
        (np.abs(F.values) ** 2).sum() * F["freq_x"].attrs["spacing"],
        (np.abs(sig.astype(np.float64)) ** 2).sum() * dx,
        rtol=1e-12,
    )


def test_fft64_ifft64_roundtrip():
    rng = np.random.RandomState(5)
    Nx = 96
    x = np.arange(Nx) * 0.25 - 3.0
    sig = rng.randn(Nx).astype(np.float32)
    da = LabeledArray(sig, dims=["x"], coords={"x": x})
    F = xrft_tpu.fft64(da, dim="x")
    back = xrft_tpu.ifft64(F, lag=F["freq_x"].attrs["direct_lag"])
    npt.assert_allclose(back.values.real, sig, atol=1e-12)
    npt.assert_allclose(back["x"].values, x, atol=1e-10)


def test_fft64_2d_complex_input():
    rng = np.random.RandomState(6)
    z = rng.randn(24, 32) + 1j * rng.randn(24, 32)
    da = LabeledArray(z, dims=["y", "x"],
                      coords={"y": np.arange(24.0), "x": np.arange(32.0)})
    F = xrft_tpu.fft64(da, true_phase=False, true_amplitude=False,
                       shift=False)
    ref = np.fft.fftn(np.asarray(da.values, np.complex128))
    npt.assert_allclose(F.values, ref, rtol=1e-12, atol=1e-12)
