"""LabeledArray API tests: construction, selection, broadcasting, pytree
behaviour, and metadata propagation."""

import jax
import numpy as np
import numpy.testing as npt
import pytest

from xrft_tpu import LabeledArray
from xrft_tpu.config import complex_mode
from xrft_tpu.ops import carray


def make():
    return LabeledArray(
        np.arange(12.0).reshape(3, 4),
        dims=("y", "x"),
        coords={"x": np.arange(4) * 0.5, "y": [10.0, 20.0, 30.0]},
        attrs={"units": "m"},
        name="h",
    )


def test_basic_props():
    da = make()
    assert da.sizes == {"y": 3, "x": 4}
    assert da.get_axis_num("x") == 1
    assert da["x"].spacing if "spacing" in da["x"].attrs else True
    npt.assert_array_equal(da["y"].values, [10.0, 20.0, 30.0])
    assert da.attrs["units"] == "m"
    assert da.name == "h"


def test_sel_exact_and_nearest():
    da = make()
    s = da.sel(x=1.0)
    assert s.dims == ("y",)
    npt.assert_array_equal(s.values, da.values[:, 2])
    s = da.sel(x=0.9, method="nearest")
    npt.assert_array_equal(s.values, da.values[:, 2])
    with pytest.raises(KeyError):
        da.sel(x=0.9)
    s = da.sel(y=[10.0, 30.0])
    assert s.sizes["y"] == 2


def test_isel_scalar_drops_dim():
    da = make()
    s = da.isel(y=1)
    assert s.dims == ("x",)
    npt.assert_array_equal(s.values, da.values[1])
    assert "y" not in s.coords


def test_transpose_and_sortby():
    da = make()
    t = da.transpose("x", "y")
    assert t.dims == ("x", "y")
    npt.assert_array_equal(t.values, da.values.T)
    rev = LabeledArray(da.values[:, ::-1].copy(), dims=da.dims,
                       coords={"x": da["x"].values[::-1].copy(),
                               "y": da["y"].values})
    s = rev.sortby("x")
    npt.assert_array_equal(s.values, da.values)


def test_broadcasting_by_dim_name():
    da = make()
    wx = LabeledArray(np.array([1.0, 2.0, 3.0, 4.0]), dims=("x",))
    out = da * wx
    npt.assert_array_equal(out.values, da.values * np.arange(1.0, 5.0))
    # new dim appended
    wz = LabeledArray(np.array([1.0, -1.0]), dims=("z",))
    out = da * wz
    assert out.dims == ("y", "x", "z")
    # conflicting sizes rejected
    bad = LabeledArray(np.zeros(5), dims=("x",))
    with pytest.raises(ValueError, match="conflicting"):
        da + bad


def test_pytree_jit_roundtrip():
    da = make()

    @jax.jit
    def f(d):
        return (d * 2.0).mean("y")

    out = f(da)
    assert out.dims == ("x",)
    npt.assert_allclose(out.values, (da.values * 2).mean(axis=0))
    # coords survive the jit boundary
    npt.assert_array_equal(out["x"].values, da["x"].values)


def test_split_complex_data_ops():
    with complex_mode("split"):
        z = (np.random.randn(4, 4) + 1j * np.random.randn(4, 4)).astype(
            np.complex64
        )  # complex128 stays host-resident; complex64 splits
        da = LabeledArray(z, dims=("a", "b"))
        assert carray.is_pair(da.data)
        npt.assert_allclose(da.conj().values, z.conj(), atol=1e-6)
        npt.assert_allclose(abs(da).values, np.abs(z), atol=1e-6)
        npt.assert_allclose((da * da).values, z * z, atol=1e-5)
        npt.assert_allclose(da.sum("a").values, z.sum(0), atol=1e-5)
        npt.assert_allclose(da.real.values, z.real)
        npt.assert_allclose(da.transpose("b", "a").values, z.T, atol=1e-6)


def test_where_and_dropna():
    da = make()
    m = da.where(da > 5.0)
    assert np.isnan(m.values).sum() == 6
    d = m.dropna("y")  # rows with any NaN dropped
    assert d.sizes["y"] == 1


def test_chunk_metadata():
    da = make().chunk({"x": 2})
    assert da.chunks == {"x": 2}
    with pytest.raises(ValueError):
        da.chunk({"nope": 2})


def test_multidim_coord_roundtrip():
    da = LabeledArray(
        np.zeros((2, 3)), dims=("y", "x"),
        coords={"lon": (("y", "x"), np.arange(6).reshape(2, 3))},
    )
    assert da.coords["lon"].dims == ("y", "x")
    t = da.transpose("x", "y")
    assert t.coords["lon"].dims == ("y", "x")  # coord dims unchanged


def test_xarray_compat_gated():
    # xarray is not installed in this image: the adapters raise a clear error
    import xrft_tpu.xarray_compat as xc
    try:
        import xarray  # noqa: F401
        has_xr = True
    except ImportError:
        has_xr = False
    if not has_xr:
        with pytest.raises(ImportError, match="xarray"):
            xc.from_xarray(None)


def test_jit_over_host_complex128_split_mode():
    """A LabeledArray holding host-resident complex128 numpy data must be
    jit-stageable in split mode: tree_flatten emits an exact df64 quad
    (CDF64) instead of a complex leaf.  The f32 engines degrade it to a
    pair; engine='hp' consumes it at full precision."""
    import jax

    import xrft_tpu
    from xrft_tpu.config import complex_mode

    N = 16
    rng = np.random.RandomState(33)
    spec = rng.randn(N) + 1j * rng.randn(N)
    f16 = np.fft.fftshift(np.fft.fftfreq(N, 0.5))
    daft = LabeledArray(spec, dims=["freq_t"], coords={"freq_t": f16})

    with complex_mode("split"):
        out = jax.jit(lambda d: xrft_tpu.ifft(
            d, dim=["freq_t"], true_phase=True, lag=[0.25],
            true_amplitude=False, shift=False))(daft)
        pre = spec * np.exp(2j * np.pi * f16 * 0.25)
        ref = np.fft.ifft(np.fft.ifftshift(pre))
        npt.assert_allclose(np.asarray(out.values), ref, atol=1e-6)

        outh = jax.jit(lambda d: xrft_tpu.ifft(
            d, dim=["freq_t"], true_phase=True, lag=[0.0],
            true_amplitude=False, shift=False, engine="hp"))(daft)
        refh = np.fft.ifft(np.fft.ifftshift(spec))
        npt.assert_allclose(np.asarray(outh.values), refh, atol=1e-13)


@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("kind", ["roll", "reverse", "general"])
def test_sortby_permutation_fast_paths(n, kind):
    """sortby's roll/reverse detection (slices instead of a gather) must
    agree with the general take path."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    vals = rng.randn(3, n)
    if kind == "roll":
        c = np.fft.fftfreq(n)  # natural order: sort is a cyclic roll
    elif kind == "reverse":
        c = -np.arange(n, dtype=float)
    else:
        c = rng.permutation(n).astype(float)
    da = LabeledArray(jnp.asarray(vals), dims=("t", "x"), coords={"x": c})
    out = da.sortby("x")
    order = np.argsort(c, kind="stable")
    npt.assert_allclose(np.asarray(out.data), vals[:, order], atol=0)
    npt.assert_allclose(out.coords["x"].values, c[order], atol=0)
