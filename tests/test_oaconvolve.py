"""Overlap-add convolution vs scipy.signal.oaconvolve / fftconvolve.

The reference has no convolution at all (its surface stops at spectral
estimates, /root/reference/xrft/xrft.py:17-29); scipy is the oracle, per
the reference's oracle-parity test genre (SURVEY.md section 4 genre 1).
"""

import jax
import numpy as np
import pytest
import scipy.signal as sps

import xrft_tpu
from xrft_tpu.labeled import LabeledArray


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(5000, 64), (4096, 129), (3001, 17)])
def test_scipy_parity(mode, n1, n2):
    rng = np.random.RandomState(0)
    a = rng.randn(n1)
    b = rng.randn(n2)
    da = LabeledArray(a, dims=["t"], coords={"t": np.arange(n1) * 0.5})
    db = LabeledArray(b, dims=["t"], coords={"t": np.arange(n2) * 0.5})
    got = xrft_tpu.oaconvolve(da, db, dims="t", mode=mode)
    want = sps.oaconvolve(a, b, mode=mode)
    np.testing.assert_allclose(np.asarray(got.values), want,
                               rtol=1e-9, atol=1e-10)
    # values identical to the direct FFT path
    ref = xrft_tpu.fftconvolve(da, db, dims="t", mode=mode)
    np.testing.assert_allclose(np.asarray(got.values),
                               np.asarray(ref.values),
                               rtol=1e-9, atol=1e-10)
    # coordinate grid identical to fftconvolve's support grid
    np.testing.assert_allclose(np.asarray(got.coords["t"].values),
                               np.asarray(ref.coords["t"].values))


def test_batched_and_kernel_broadcast():
    rng = np.random.RandomState(1)
    a = rng.randn(3, 4000)
    b = rng.randn(65)
    da = LabeledArray(a, dims=["z", "t"])
    db = LabeledArray(b, dims=["t"])
    got = np.asarray(xrft_tpu.oaconvolve(da, db, dims="t",
                                         mode="same").values)
    want = np.stack([sps.oaconvolve(row, b, mode="same") for row in a])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_transform_dim_not_last():
    rng = np.random.RandomState(2)
    a = rng.randn(3000, 2)
    b = rng.randn(33, 2)
    got = np.asarray(xrft_tpu.oaconvolve(
        LabeledArray(a, dims=["t", "z"]),
        LabeledArray(b, dims=["t", "z"]), dims="t").values)
    want = np.stack([sps.oaconvolve(a[:, j], b[:, j]) for j in range(2)],
                    axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_complex_input():
    rng = np.random.RandomState(3)
    a = rng.randn(2500) + 1j * rng.randn(2500)
    b = rng.randn(40) + 1j * rng.randn(40)
    got = np.asarray(xrft_tpu.oaconvolve(
        LabeledArray(a, dims=["t"]), LabeledArray(b, dims=["t"]),
        dims="t", mode="full").values)
    want = sps.oaconvolve(a, b, mode="full")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_fallback_when_kernel_comparable():
    # kernel nearly as long as the signal: falls back to the full-size
    # transform, still exact
    rng = np.random.RandomState(4)
    a, b = rng.randn(300), rng.randn(200)
    got = np.asarray(xrft_tpu.oaconvolve(
        LabeledArray(a, dims=["t"]), LabeledArray(b, dims=["t"]),
        dims="t").values)
    np.testing.assert_allclose(got, sps.oaconvolve(a, b),
                               rtol=1e-9, atol=1e-10)


def test_length_one_kernel():
    rng = np.random.RandomState(5)
    a, b = rng.randn(1000), rng.randn(1)
    got = np.asarray(xrft_tpu.oaconvolve(
        LabeledArray(a, dims=["t"]), LabeledArray(b, dims=["t"]),
        dims="t").values)
    np.testing.assert_allclose(got, a * b[0], rtol=1e-9, atol=1e-10)


def test_jit_traceable():
    rng = np.random.RandomState(6)
    a, b = rng.randn(2048), rng.randn(33)
    da = LabeledArray(a, dims=["t"])
    db = LabeledArray(b, dims=["t"])

    @jax.jit
    def f(u, v):
        return xrft_tpu.oaconvolve(u, v, dims="t", mode="same")

    np.testing.assert_allclose(np.asarray(f(da, db).values),
                               sps.oaconvolve(a, b, mode="same"),
                               rtol=1e-9, atol=1e-10)


def test_error_contracts():
    rng = np.random.RandomState(7)
    da = LabeledArray(rng.randn(4, 100), dims=["z", "t"])
    db = LabeledArray(rng.randn(4, 10), dims=["z", "t"])
    with pytest.raises(ValueError, match="single long dim"):
        xrft_tpu.oaconvolve(da, db)  # two shared dims
    db2 = LabeledArray(rng.randn(3, 10), dims=["z", "t"])
    with pytest.raises(ValueError, match="mismatched"):
        xrft_tpu.oaconvolve(da, db2, dims="t")
    with pytest.raises(ValueError, match="mode must be"):
        xrft_tpu.oaconvolve(
            LabeledArray(rng.randn(5000), dims=["t"]),
            LabeledArray(rng.randn(16), dims=["t"]),
            dims="t", mode="bogus")


def test_block_path_validates_before_device_work():
    """The block path must reject a stale wrong-length kernel
    coordinate and a bad mode string up front, exactly like _conv_like —
    not silently mis-grid the output (coord) or raise only after the
    transforms (mode)."""
    from xrft_tpu.labeled import Coord

    rng = np.random.RandomState(2)
    da = LabeledArray(rng.randn(5000), dims=["t"],
                      coords={"t": np.arange(5000) * 0.5})
    db = LabeledArray(rng.randn(64), dims=["t"],
                      coords={"t": np.arange(64) * 0.5})
    db.coords["t"] = Coord(("t",), np.arange(32) * 0.5, None, "t")
    with pytest.raises(ValueError, match="inconsistent coord"):
        xrft_tpu.oaconvolve(da, db, dims="t")
    db2 = LabeledArray(rng.randn(64), dims=["t"],
                       coords={"t": np.arange(64) * 0.5})
    with pytest.raises(ValueError, match="mode must be"):
        xrft_tpu.oaconvolve(da, db2, dims="t", mode="bogus")
