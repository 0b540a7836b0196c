"""Binned aggregation (ops/binning.py): the numpy ``pd.cut`` codes and the
device binned sums against a float64 bincount oracle."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from xrft_tpu.ops import binning, carray

_RNG = np.random.RandomState(0)
_K = np.fft.fftshift(np.fft.fftfreq(40, 0.5))
CUT_CASES = {
    "radial_grid": np.sqrt(_K[:, None] ** 2 + _K[None, :] ** 2),
    "randn_f64": _RNG.randn(1000),
    "randn_f32": _RNG.randn(1000).astype(np.float32),
    "with_nan": np.where(_RNG.rand(500) < 0.1, np.nan, _RNG.randn(500)),
    "negative": -np.abs(_RNG.randn(300)) - 5.0,
    "all_equal": np.full(10, 3.0),
    "all_zero": np.zeros(7),
    "all_equal_negative_f32": np.full(6, -2.5, np.float32),
    "integers": _RNG.randint(-5, 5, 200),
    "edges_exact": np.linspace(0.0, 1.0, 101),
}


@pytest.mark.parametrize("case", sorted(CUT_CASES))
def test_cut_codes_match_pandas(case):
    """numpy cut_codes gives pd.cut's codes and bin count: equal-width
    right-closed bins, the low edge extended by 0.1% of the range, NaN
    mapped to -1."""
    pd = pytest.importorskip("pandas")
    values = CUT_CASES[case]
    for nbins in (1, 3, 7, 16, 50):
        ref = pd.cut(np.ravel(values), nbins)
        codes, n = binning.cut_codes(values, nbins)
        npt.assert_array_equal(codes, np.asarray(ref.codes))
        assert n == ref.categories.size == nbins


def test_cut_codes_nan_is_dropped():
    codes, _ = binning.cut_codes(np.array([np.nan, 0.0, 1.0, np.nan]), 2)
    npt.assert_array_equal(codes, [-1, 0, 1, -1])


def test_import_without_pandas():
    """The package imports with pandas blocked (it is not a dependency)."""
    code = ("import sys; sys.modules['pandas'] = None; "
            "import xrft_tpu, xrft_tpu.ops.binning, xrft_tpu.isotropic; "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1],
                         env={"JAX_PLATFORMS": "cpu", "PATH": ""})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _case(kind, rng):
    P, nbins = 3000, 23
    codes = rng.randint(-1, nbins, P)      # -1: dropped points
    a = rng.randn(2, P)
    b = rng.randn(2, P)
    host = {"f32": a.astype(np.float32), "f64": a,
            "c64": (a + 1j * b).astype(np.complex64),
            "pair": (a + 1j * b).astype(np.complex64)}[kind]
    data = {"f32": jnp.asarray(host), "f64": jnp.asarray(host),
            "c64": jnp.asarray(host),
            "pair": carray.ComplexPair(jnp.asarray(host.real),
                                       jnp.asarray(host.imag))}[kind]
    keep = codes >= 0
    ref = np.stack([
        np.bincount(codes[keep], weights=row.real.astype(np.float64)[keep],
                    minlength=nbins)
        + 1j * np.bincount(codes[keep],
                           weights=row.imag.astype(np.float64)[keep],
                           minlength=nbins)
        for row in host])
    tol = 1e-13 if kind == "f64" else 1e-6
    return data, codes, nbins, ref, tol


def _rel(got, ref):
    return np.abs(carray.to_numpy(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kind", ["f32", "f64", "c64", "pair"])
@pytest.mark.parametrize("group", [1, 7, 1024, 3000, 8192])
def test_binned_sum_against_bincount(monkeypatch, group, kind):
    """binned_sum against a float64 bincount oracle for real, native
    complex and ComplexPair data, with one group (group >= points), many
    groups, a ragged last group (3000 % 7 != 0), and one point per
    group."""
    monkeypatch.setattr(binning, "GROUP", group)
    data, codes, nbins, ref, tol = _case(kind, np.random.RandomState(3))
    got = binning.binned_sum(data, codes, nbins)
    assert carray.is_pair(got) == (kind == "pair")
    assert _rel(got, ref) <= tol


def test_binned_sum_all_dropped_and_empty_bins():
    """Points coded -1 contribute nothing; bins no point falls in are 0."""
    codes = np.array([-1, 2, -1, 2, 0])
    x = jnp.asarray(np.array([[5.0, 1.0, 7.0, 2.0, 4.0]], np.float32))
    npt.assert_array_equal(np.asarray(binning.binned_sum(x, codes, 4)),
                           [[4.0, 0.0, 3.0, 0.0]])


def test_binned_sum_under_jit_batched():
    """Traced data with two batch dims."""
    import jax

    rng = np.random.RandomState(5)
    codes = rng.randint(-1, 9, 500)
    x = rng.randn(2, 3, 500)
    got = jax.jit(lambda v: binning.binned_sum(v, codes, 9))(jnp.asarray(x))
    keep = codes >= 0
    ref = np.stack([[np.bincount(codes[keep], weights=r[keep], minlength=9)
                     for r in b] for b in x])
    npt.assert_allclose(np.asarray(got), ref, rtol=1e-12, atol=1e-12)
