"""Oracle-parity tests for the matmul FFT engine against numpy.fft.

These run the matmul engine on the CPU backend in both complex64 and
complex128; chip_smoke.py runs it on the GPU.  Mirrors the reference's oracle-parity genre
(/root/reference/xrft/tests/test_xrft.py:57-97 style), applied to the
engine layer.
"""

import numpy as np
import numpy.testing as npt
import pytest

from xrft_tpu.config import fft_engine
from xrft_tpu.ops import fft_core
from xrft_tpu.ops.matmul_fft import fft_last, matmul_fft_nd

SIZES = [1, 2, 3, 4, 8, 12, 16, 30, 64, 97, 100, 128, 127, 210, 256, 512,
         513, 1000, 1024, 2048, 4096, 5003]


@pytest.mark.parametrize("n", SIZES)
def test_fft_last_matches_numpy_c128(n):
    rng = np.random.RandomState(n)
    x = rng.randn(n) + 1j * rng.randn(n)
    got = np.asarray(fft_last(np.asarray(x)))
    ref = np.fft.fft(x)
    scale = max(np.abs(ref).max(), 1.0)
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)


@pytest.mark.parametrize("n", [8, 100, 128, 512, 1024, 4096])
def test_fft_last_c64_accuracy(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    got = np.asarray(fft_last(np.asarray(x)))
    ref = np.fft.fft(x.astype(np.complex128))
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=2e-6)


@pytest.mark.parametrize("n", [16, 24, 100, 127, 128])
def test_ifft_roundtrip(n):
    rng = np.random.RandomState(n)
    x = rng.randn(5, n) + 1j * rng.randn(5, n)
    f = matmul_fft_nd(np.asarray(x), [-1], "fft")
    back = matmul_fft_nd(np.asarray(f), [-1], "ifft")
    npt.assert_allclose(np.asarray(back), x, atol=1e-10)


@pytest.mark.parametrize("n", [16, 30, 100, 128, 257])
def test_rfft_matches_numpy(n):
    rng = np.random.RandomState(n)
    x = rng.randn(3, n)
    got = np.asarray(matmul_fft_nd(np.asarray(x), [-1], "rfft"))
    ref = np.fft.rfft(x, axis=-1)
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)


@pytest.mark.parametrize("n", [16, 30, 100, 128])
def test_irfft_roundtrip_even(n):
    n = n if n % 2 == 0 else n + 1
    rng = np.random.RandomState(n)
    x = rng.randn(3, n)
    f = matmul_fft_nd(np.asarray(x), [-1], "rfft")
    back = matmul_fft_nd(np.asarray(f), [-1], "irfft")
    npt.assert_allclose(np.asarray(back), x, atol=1e-10)


@pytest.mark.parametrize("shape,axes", [((5, 16), [1]), ((4, 8, 12), [1, 2]),
                                        ((2, 6, 10), [2]), ((7, 2), [1]),
                                        ((1, 129), [1]), ((2, 3, 4, 6), [1, 2, 3])])
def test_irfft_nonhermitian_matches_numpy(shape, axes):
    # the packed half-length irfft must reproduce pocketfft's c2r
    # semantics exactly for ARBITRARY (non-Hermitian-consistent) input:
    # DC/Nyquist imaginary parts ignored, interior taken as given
    # (/root/reference relies on np.fft.irfftn at xrft/xrft.py:583-591)
    rng = np.random.RandomState(sum(shape))
    X = rng.randn(*shape) + 1j * rng.randn(*shape)
    got = np.asarray(matmul_fft_nd(np.asarray(X), axes, "irfft"))
    ref = np.fft.irfftn(X, axes=axes)
    scale = max(np.abs(ref).max(), 1e-30)
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)



NONHERMITIAN_CASES = [((5, 16), [1]), ((4, 8, 12), [1, 2]), ((2, 6, 10), [2]),
                      ((7, 2), [1]), ((1, 129), [1]),
                      ((2, 3, 4, 6), [1, 2, 3]), ((6, 9, 5), [0, 1])]


@pytest.mark.parametrize("dtype,atol", [(np.complex128, 1e-12),
                                        (np.complex64, 2e-6)])
@pytest.mark.parametrize("shape,axes", NONHERMITIAN_CASES)
def test_xla_irfft_nonhermitian_matches_numpy(shape, axes, dtype, atol):
    # the xla engine's irfft composes numpy's c2r (complex inverse FFTs
    # over the leading axes, then a 1-D c2r reading only the real parts
    # of the DC and Nyquist bins) for arbitrary input
    rng = np.random.RandomState(sum(shape) + len(axes))
    X = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(dtype)
    got = np.asarray(fft_core.irfftn(np.asarray(X), axes, engine="xla"))
    ref = np.fft.irfftn(X.astype(np.complex128), axes=axes)
    scale = max(np.abs(ref).max(), 1e-30)
    npt.assert_allclose(got / scale, ref / scale, atol=atol)


def test_xla_irfft_ignores_edge_imaginary_parts():
    # the 1-D c2r over the last axis reads only the real parts of its
    # DC and Nyquist bins
    rng = np.random.RandomState(3)
    X = rng.randn(6, 8, 9) + 1j * rng.randn(6, 8, 9)
    clean = X.copy()
    clean[..., [0, -1]] = clean[..., [0, -1]].real
    a = np.asarray(fft_core.xla_irfftn(X, [2]))
    b = np.asarray(fft_core.xla_irfftn(clean, [2]))
    npt.assert_array_equal(a, b)


def test_fftn_2d_matches_numpy():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 48) + 1j * rng.randn(32, 48)
    got = np.asarray(matmul_fft_nd(np.asarray(x), [0, 1], "fft"))
    ref = np.fft.fftn(x)
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)


def test_fftn_3d_subset_axes():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 16, 24) + 1j * rng.randn(4, 16, 24)
    got = np.asarray(matmul_fft_nd(np.asarray(x), [1, 2], "fft"))
    ref = np.fft.fftn(x, axes=[1, 2])
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)


def test_rfftn_2d_matches_numpy():
    rng = np.random.RandomState(2)
    x = rng.randn(24, 32)
    got = np.asarray(matmul_fft_nd(np.asarray(x), [0, 1], "rfft"))
    ref = np.fft.rfftn(x)
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)


def test_irfftn_2d_roundtrip():
    rng = np.random.RandomState(3)
    x = rng.randn(24, 32)
    f = matmul_fft_nd(np.asarray(x), [0, 1], "rfft")
    back = matmul_fft_nd(np.asarray(f), [0, 1], "irfft")
    npt.assert_allclose(np.asarray(back), x, atol=1e-10)


def test_dispatcher_engines_agree():
    rng = np.random.RandomState(4)
    x = rng.randn(16, 64) + 1j * rng.randn(16, 64)
    with fft_engine("xla"):
        a = np.asarray(fft_core.fftn(x, [0, 1]))
    with fft_engine("matmul"):
        b = np.asarray(fft_core.fftn(x, [0, 1]))
    npt.assert_allclose(a, b, atol=1e-10 * np.abs(a).max())


@pytest.mark.parametrize("n", [16, 30, 100, 128, 4096, 97, 27])
def test_absorbed_shifts_match_numpy(n):
    """pre (ifftshift) / post (fftshift) flags match explicit numpy
    composition for even (absorbed) and odd (fallback-roll) sizes."""
    from xrft_tpu.ops.matmul_fft import fft_last
    rng = np.random.RandomState(n)
    x = rng.randn(3, n) + 1j * rng.randn(3, n)
    ref = np.fft.fftshift(
        np.fft.fft(np.fft.ifftshift(x, axes=-1), axis=-1), axes=-1
    )
    got = np.asarray(fft_last(np.asarray(x), -1, pre_shift=True,
                              post_shift=True))
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)
    # pre only
    ref = np.fft.fft(np.fft.ifftshift(x, axes=-1), axis=-1)
    got = np.asarray(fft_last(np.asarray(x), -1, pre_shift=True))
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)
    # post only
    ref = np.fft.fftshift(np.fft.fft(x, axis=-1), axes=-1)
    got = np.asarray(fft_last(np.asarray(x), -1, post_shift=True))
    npt.assert_allclose(got / scale, ref / scale, atol=1e-11)


@pytest.mark.parametrize("n", [16, 27, 100])
def test_ifft_absorbed_shift_kinds(n):
    """ifft with absorbed pre-ifftshift and both post kinds matches numpy
    compositions (even absorbed, odd fallback-roll)."""
    from xrft_tpu.ops.matmul_fft import matmul_fft_nd
    rng = np.random.RandomState(n)
    x = rng.randn(3, n) + 1j * rng.randn(3, n)
    # pre + post fftshift
    ref = np.fft.fftshift(
        np.fft.ifft(np.fft.ifftshift(x, axes=-1), axis=-1), axes=-1
    )
    got = np.asarray(matmul_fft_nd(np.asarray(x), [-1], "ifft",
                                   pre_shift_axes=[-1],
                                   post_shift_axes=[-1],
                                   post_kind="fftshift"))
    scale = np.abs(ref).max()
    npt.assert_allclose(got / scale, ref / scale, atol=1e-12)
    # post ifftshift
    ref = np.fft.ifftshift(np.fft.ifft(x, axis=-1), axes=-1)
    got = np.asarray(matmul_fft_nd(np.asarray(x), [-1], "ifft",
                                   post_shift_axes=[-1],
                                   post_kind="ifftshift"))
    npt.assert_allclose(got / scale, ref / scale, atol=1e-12)
