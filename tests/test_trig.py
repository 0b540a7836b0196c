"""DCT/DST family tests: scipy.fft parity over every (type, norm, parity)
cell, both complex modes and engines, inverse round trips, batch dims, jit
staging, and error contracts.  Beyond the reference (no cosine/sine
transforms in /root/reference)."""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import scipy.fft as sfft

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import complex_mode, fft_engine

TYPES = [1, 2, 3, 4]
NORMS = [None, "backward", "ortho", "forward"]


def make_1d(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n)
    return x, LabeledArray(x, dims=["t"], coords={"t": np.arange(n) * 0.5},
                           name="u")


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_dct_dst_scipy_parity(type, norm, n):
    """Every (type, norm, even/odd-N) cell matches scipy.fft bit-tightly."""
    x, da = make_1d(n)
    for mine, ref in ((xrft_tpu.dct, sfft.dct), (xrft_tpu.dst, sfft.dst),
                      (xrft_tpu.idct, sfft.idct), (xrft_tpu.idst, sfft.idst)):
        got = np.asarray(mine(da, type=type, norm=norm).values)
        want = ref(x, type=type, norm=norm)
        npt.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["native", "split"])
@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_dct_engines_and_modes(mode, engine):
    """The split-pair + matmul-engine code path produces the same
    transform as the native path."""
    x, da = make_1d(33, seed=3)
    with complex_mode(mode), fft_engine(engine):
        for type in TYPES:
            got = np.asarray(xrft_tpu.dct(da, type=type, norm="ortho").values)
            want = sfft.dct(x, type=type, norm="ortho")
            npt.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())
            gs = np.asarray(xrft_tpu.dst(da, type=type).values)
            ws = sfft.dst(x, type=type)
            npt.assert_allclose(gs, ws, atol=1e-10 * np.abs(ws).max())


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_round_trips(type, norm):
    """idct(dct(x)) == x and idst(dst(x)) == x for every type and norm."""
    x, da = make_1d(24, seed=5)
    rt = xrft_tpu.idct(xrft_tpu.dct(da, type=type, norm=norm),
                       type=type, norm=norm)
    npt.assert_allclose(np.asarray(rt.values), x, atol=1e-12)
    rs = xrft_tpu.idst(xrft_tpu.dst(da, type=type, norm=norm),
                       type=type, norm=norm)
    npt.assert_allclose(np.asarray(rs.values), x, atol=1e-12)


def test_batch_dims_and_axis_selection():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 40)
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": np.arange(3.0), "t": np.arange(40.0)})
    got = np.asarray(xrft_tpu.dct(da, dim="t").values)
    npt.assert_allclose(got, sfft.dct(x, axis=-1), atol=1e-12)
    gz = np.asarray(xrft_tpu.dst(da, dim="z", type=3).values)
    npt.assert_allclose(gz, sfft.dst(x, type=3, axis=0), atol=1e-12)


def test_coords_names_pass_through():
    x, da = make_1d(16, seed=9)
    out = xrft_tpu.dct(da)
    assert out.dims == da.dims
    npt.assert_allclose(out["t"].values, da["t"].values)
    assert out.name == "u_dct"
    assert xrft_tpu.idst(da).name == "u_idst"


def test_jit_traceable_pipeline():
    """dct -> spectral filter -> idct stages into one XLA program."""
    x, da = make_1d(32, seed=11)

    @jax.jit
    def lowpass(la):
        c = xrft_tpu.dct(la, type=2, norm="ortho")
        mask = (np.arange(32) < 8).astype(np.float64)
        filt = c.copy(data=c.data * mask)
        return xrft_tpu.idct(filt, type=2, norm="ortho").data

    got = np.asarray(lowpass(da))
    c = sfft.dct(x, norm="ortho")
    c[8:] = 0.0
    npt.assert_allclose(got, sfft.idct(c, norm="ortho"), atol=1e-12)


def test_error_contracts():
    x, da = make_1d(8)
    with pytest.raises(ValueError, match="type must be 1, 2, 3 or 4"):
        xrft_tpu.dct(da, type=5)
    with pytest.raises(ValueError, match="invalid norm"):
        xrft_tpu.dct(da, norm="bogus")
    d1 = LabeledArray(np.ones(1), dims=["t"], coords={"t": [0.0]})
    with pytest.raises(ValueError, match="DCT-I requires"):
        xrft_tpu.dct(d1, type=1)
    dz = LabeledArray(np.ones(8) + 1j, dims=["t"],
                      coords={"t": np.arange(8.0)})
    with pytest.raises(ValueError, match="must be real"):
        xrft_tpu.dct(dz)


def test_neumann_poisson_solve():
    """Physics check: DCT-II diagonalizes the Neumann-BC 1-D Laplacian —
    solve u'' = f spectrally and verify against a dense finite-difference
    solve (the standard fast-Poisson use of the DCT)."""
    n = 64
    rng = np.random.RandomState(13)
    f = rng.randn(n)
    f -= f.mean()  # solvability (Neumann nullspace)
    # dense second-difference matrix with Neumann (reflecting) BCs
    A = -2.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
    A[0, 0] = -1.0
    A[-1, -1] = -1.0
    u_dense = np.linalg.lstsq(A, f, rcond=None)[0]
    # spectral: eigenvalues of A under DCT-II basis are 2*cos(pi k/n) - 2
    da = LabeledArray(f, dims=["x"], coords={"x": np.arange(n) * 1.0})
    fh = np.asarray(xrft_tpu.dct(da, type=2).values)
    lam = 2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0
    uh = np.zeros(n)
    uh[1:] = fh[1:] / lam[1:]
    dah = LabeledArray(uh, dims=["x"], coords={"x": np.arange(n) * 1.0})
    u = np.array(xrft_tpu.idct(dah, type=2).values)
    u -= u.mean()
    u_dense -= u_dense.mean()
    npt.assert_allclose(u, u_dense, atol=1e-9)


# ---------------------------------------------------------------------------
# N-D family: dctn/idctn/dstn/idstn (scipy.fft namesakes)
# ---------------------------------------------------------------------------


def make_3d(shape=(5, 8, 9), seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape)
    return x, LabeledArray(x, dims=["z", "y", "x"], name="u")


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_dctn_dstn_scipy_parity(type, norm):
    """dctn/dstn over a dim subset match scipy.fft.dctn/dstn on the same
    axes, for every (type, norm) cell; full-dim default matches axes=None."""
    x, da = make_3d()
    for mine, ref in ((xrft_tpu.dctn, sfft.dctn), (xrft_tpu.dstn, sfft.dstn),
                      (xrft_tpu.idctn, sfft.idctn),
                      (xrft_tpu.idstn, sfft.idstn)):
        got = np.asarray(mine(da, dim=["y", "x"], type=type,
                              norm=norm).values)
        want = ref(x, type=type, norm=norm, axes=(1, 2))
        npt.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())
    got = np.asarray(xrft_tpu.dctn(da, type=type, norm=norm).values)
    want = sfft.dctn(x, type=type, norm=norm)
    npt.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("type", TYPES)
def test_dctn_dstn_round_trips(type, norm):
    """idctn(dctn(x)) == x and idstn(dstn(x)) == x for every type/norm."""
    x, da = make_3d(seed=11)
    rt = np.asarray(xrft_tpu.idctn(
        xrft_tpu.dctn(da, type=type, norm=norm), type=type,
        norm=norm).values)
    npt.assert_allclose(rt, x, atol=1e-11)
    rt = np.asarray(xrft_tpu.idstn(
        xrft_tpu.dstn(da, dim=["z", "x"], type=type, norm=norm),
        dim=["z", "x"], type=type, norm=norm).values)
    npt.assert_allclose(rt, x, atol=1e-11)


def test_dctn_single_dim_equals_dct():
    """dctn over one dim is exactly dct along it (and a str dim works)."""
    x, da = make_3d(seed=3)
    a = np.asarray(xrft_tpu.dctn(da, dim="y", type=3, norm="ortho").values)
    b = np.asarray(xrft_tpu.dct(da, dim="y", type=3, norm="ortho").values)
    npt.assert_array_equal(a, b)


def test_dctn_is_jit_traceable():
    x, da = make_3d(seed=5)

    @jax.jit
    def f(la):
        return xrft_tpu.dctn(la, dim=["y", "x"], norm="ortho").data

    got = np.asarray(f(da))
    want = sfft.dctn(x, norm="ortho", axes=(1, 2))
    npt.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


def test_dctn_error_contracts():
    x, da = make_3d()
    with pytest.raises(ValueError, match="not found"):
        xrft_tpu.dctn(da, dim=["y", "nope"])
    with pytest.raises(ValueError, match="duplicate"):
        xrft_tpu.dstn(da, dim=["y", "y"])
    with pytest.raises(ValueError, match="at least one"):
        xrft_tpu.dctn(da, dim=[])
