"""Distributed-path tests on the 8-virtual-device CPU mesh: pencil FFT
parity vs single-device transforms, batch sharding, and the high-level
sharded API.  This is the analogue of the reference's in-process dask
tests (SURVEY.md §4): same assertions, collective execution underneath.
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest
from jax.sharding import PartitionSpec as P

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import complex_mode
from xrft_tpu.ops import carray
from xrft_tpu.parallel import (
    make_mesh,
    pencil_fftn,
    shard_labeled,
    sharded_fft,
    sharded_power_spectrum,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture
def mesh8():
    return make_mesh({"p": 8})


@pytest.fixture
def mesh24():
    return make_mesh({"p1": 2, "p2": 4})


@pytest.mark.parametrize("kind", ["fft", "ifft"])
@pytest.mark.parametrize("mode", ["native", "split"])
def test_pencil_1axis_sharded(mesh8, kind, mode):
    """FFT along a sharded axis == local FFT (global view)."""
    rng = np.random.RandomState(0)
    x = rng.randn(32, 48) + 1j * rng.randn(32, 48)
    with complex_mode(mode):
        xin = carray.as_pair(x) if mode == "split" else np.asarray(x)
        got = pencil_fftn(xin, [0, 1], mesh8, {0: "p"}, kind)
        ref = np.fft.fftn(x) if kind == "fft" else np.fft.ifftn(x)
        npt.assert_allclose(carray.to_numpy(got), ref, atol=1e-10)


@pytest.mark.parametrize("mode", ["native", "split"])
def test_pencil_2d_mesh_3d_fft(mesh24, mode):
    """3-D FFT with two sharded transform axes on a 2x4 mesh — the
    BASELINE config-5 topology at test scale."""
    rng = np.random.RandomState(1)
    x = rng.randn(16, 32, 24) + 1j * rng.randn(16, 32, 24)
    with complex_mode(mode):
        xin = carray.as_pair(x) if mode == "split" else np.asarray(x)
        got = pencil_fftn(xin, [0, 1, 2], mesh24, {0: "p1", 1: "p2"}, "fft")
        npt.assert_allclose(carray.to_numpy(got), np.fft.fftn(x), atol=1e-9)


def test_pencil_rfft(mesh8):
    rng = np.random.RandomState(2)
    x = rng.randn(32, 64)
    got = pencil_fftn(np.asarray(x), [0, 1], mesh8, {0: "p"}, "rfft")
    npt.assert_allclose(carray.to_numpy(got), np.fft.rfftn(x), atol=1e-10)
    back = pencil_fftn(got, [0, 1], mesh8, {0: "p"}, "irfft")
    npt.assert_allclose(carray.to_numpy(back), x, atol=1e-10)


def test_pencil_rfft_sharded_real_axis_raises(mesh8):
    x = np.random.randn(32, 64)
    with pytest.raises(ValueError, match="unsharded"):
        pencil_fftn(x, [0, 1], mesh8, {1: "p"}, "rfft")


def test_pencil_no_buddy_raises(mesh8):
    # 1-D: no buddy axis available for the transpose
    x = np.random.randn(32) + 0j
    with pytest.raises(ValueError, match="buddy"):
        pencil_fftn(x, [0], mesh8, {0: "p"}, "fft")


def test_pencil_batch_only_sharding(mesh8):
    """Sharded non-transform axis: pure batch parallelism, no transposes."""
    rng = np.random.RandomState(3)
    x = rng.randn(16, 32) + 1j * rng.randn(16, 32)
    got = pencil_fftn(np.asarray(x), [1], mesh8, {0: "p"}, "fft")
    npt.assert_allclose(carray.to_numpy(got), np.fft.fft(x, axis=1),
                        atol=1e-10)


@pytest.mark.parametrize("mode", ["native", "split"])
def test_sharded_fft_matches_local(mesh8, mode):
    """High-level sharded_fft == local fft, coords and all."""
    N = 32
    x = np.arange(N) * 0.5 - 3.0
    rng = np.random.RandomState(4)
    vals = rng.randn(8, N)
    with complex_mode(mode):
        da = LabeledArray(vals, dims=["b", "x"],
                          coords={"x": x, "b": np.arange(8)})
        local = xrft_tpu.fft(da, dim=["x"], true_phase=True,
                             true_amplitude=True)
        dist = sharded_fft(da, mesh8, {"b": "p"}, dim=["x"],
                           true_phase=True, true_amplitude=True)
        npt.assert_allclose(carray.to_numpy(dist.data),
                            carray.to_numpy(local.data), atol=1e-11)
        assert dist.dims == local.dims
        npt.assert_allclose(dist["freq_x"].values, local["freq_x"].values)


@pytest.mark.parametrize("mode", ["native", "split"])
def test_sharded_fft_transform_dim_sharded(mesh8, mode):
    """The genuinely-new capability: fft along a *sharded* transform dim
    (the reference's dask backend raises here)."""
    N = 64
    x = np.arange(N) * 0.25
    rng = np.random.RandomState(5)
    vals = rng.randn(N, 16)
    with complex_mode(mode):
        da = LabeledArray(vals, dims=["x", "b"],
                          coords={"x": x, "b": np.arange(16)})
        local = xrft_tpu.fft(da, dim=["x"], true_phase=True,
                             true_amplitude=True)
        dist = sharded_fft(da, mesh8, {"x": "p"}, dim=["x"],
                           true_phase=True, true_amplitude=True)
        npt.assert_allclose(carray.to_numpy(dist.data),
                            carray.to_numpy(local.data), atol=1e-11)


def test_sharded_power_spectrum_2d(mesh24):
    """Full sharded PSD pipeline (detrend + window) on a 2-D mesh."""
    N = 32
    rng = np.random.RandomState(6)
    da = LabeledArray(rng.randn(N, N), dims=["y", "x"],
                      coords={"y": np.arange(N), "x": np.arange(N)})
    local = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann",
                                    detrend="linear")
    dist = sharded_power_spectrum(da, mesh24, {"y": "p1", "x": "p2"},
                                  dim=["y", "x"], window="hann",
                                  detrend="linear")
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)


def test_shard_labeled_sharding_visible(mesh8):
    da = LabeledArray(np.random.randn(16, 8), dims=["a", "b"])
    sh = shard_labeled(da, mesh8, {"a": "p"})
    assert sh.data.sharding.spec == P("p", None)


def test_forward_chain_halves_collectives(mesh24):
    """The forward pencil chain issues ONE all_to_all per sharded
    transform axis (round-1 scheme: two) — pinned on the jaxpr
   ."""
    rng = np.random.RandomState(7)
    x = np.asarray(rng.randn(8, 16, 32), np.float32)

    def f(v):
        return pencil_fftn(v, [1, 2], mesh24, {1: "p1", 2: "p2"}, "fft")

    txt = str(jax.make_jaxpr(f)(x))
    assert txt.count("all_to_all") == 2
    got = carray.to_numpy(f(x))
    npt.assert_allclose(got, np.fft.fftn(x.astype(np.float64), axes=[1, 2]),
                        atol=1e-4)

    # roundtrip through the reverse chain restores values and layout
    back = pencil_fftn(f(x), [1, 2], mesh24, {1: "p1", 2: "p2"}, "ifft")
    npt.assert_allclose(carray.to_numpy(back).real, x, atol=1e-4)


def test_forward_chain_output_layout_planned(mesh24):
    """plan_forward_layout is the deterministic layout contract: sharding
    leaves the transform axes and parks on divisible resident axes."""
    from xrft_tpu.parallel.pencil import plan_forward_layout

    steps, final = plan_forward_layout(
        (8, 16, 32), [1, 2], {1: "p1", 2: "p2"}, {"p1": 2, "p2": 4})
    assert [s[0] for s in steps] == ["move", "move"]
    # p1 parks on the batch axis; p2 parks on the already-transformed axis 1
    assert final == {0: "p1", 1: "p2"}


def test_pencil_overlap_chunks(mesh8):
    """Chunked all_to_all/FFT interleaving (config.pencil_overlap_chunks)
    emits per-chunk collectives and preserves values."""
    from xrft_tpu.config import config

    rng = np.random.RandomState(8)
    x = np.asarray(rng.randn(8, 16, 32), np.float32)
    old = config.pencil_overlap_chunks
    config.pencil_overlap_chunks = 4
    try:
        def f(v):
            return pencil_fftn(v, [1], mesh8, {1: "p"}, "fft")

        txt = str(jax.make_jaxpr(f)(x))
        assert txt.count("all_to_all") == 4
        got = carray.to_numpy(f(x))
    finally:
        config.pencil_overlap_chunks = old
    npt.assert_allclose(got, np.fft.fft(x.astype(np.float64), axis=1),
                        atol=1e-4)


def test_sharded_one_sided_psd(mesh24):
    """Real-input sharded PSD runs the one-sided rfft + local-mirror fast
    path: parity vs the local pipeline and an
    rfft (not full fft) in the jaxpr."""
    N = 32
    rng = np.random.RandomState(9)
    da = LabeledArray(rng.randn(8, N, N).astype(np.float32),
                      dims=["b", "y", "x"],
                      coords={"y": np.arange(N) * 0.5,
                              "x": np.arange(N) * 0.5})
    local = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann")
    dist = sharded_power_spectrum(da, mesh24, {"b": "p1", "y": "p2"},
                                  dim=["y", "x"], window="hann")
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-10)

    # the engine must have been asked for an rfft over a half-sized axis:
    # output of the core transform feeding |.|^2 has n//2+1 columns; pin
    # via the half-spectrum chooser
    from xrft_tpu.parallel.api import _make_engine
    from xrft_tpu.parallel.mesh import make_mesh
    from xrft_tpu.spectra import _half_spectrum_dim

    eng = _make_engine(mesh24, da.dims, {"b": "p1", "y": "p2"})
    assert _half_spectrum_dim(da, ["y", "x"], None, {"engine": eng}) == "x"
    # sharded half axis disables it
    eng2 = _make_engine(mesh24, da.dims, {"x": "p1"})
    assert _half_spectrum_dim(da, ["y", "x"], None, {"engine": eng2}) is None


def test_sharded_cross_spectrum(mesh24):
    from xrft_tpu.parallel import sharded_cross_spectrum

    N = 32
    rng = np.random.RandomState(10)
    mk = lambda s: LabeledArray(rng.randn(8, N, N),
                                dims=["b", "y", "x"],
                                coords={"y": np.arange(N) * 0.5,
                                        "x": np.arange(N) * 0.5})
    da1, da2 = mk(0), mk(1)
    local = xrft_tpu.cross_spectrum(da1, da2, dim=["y", "x"])
    dist = sharded_cross_spectrum(da1, da2, mesh24,
                                  {"b": "p1", "y": "p2"}, dim=["y", "x"])
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-10)


def test_sharded_isotropic_power_spectrum(mesh24):
    from xrft_tpu.parallel import sharded_isotropic_power_spectrum

    N = 32
    rng = np.random.RandomState(11)
    da = LabeledArray(rng.randn(8, N, N),
                      dims=["b", "y", "x"],
                      coords={"y": np.arange(N) * 1.0,
                              "x": np.arange(N) * 1.0})
    local = xrft_tpu.isotropic_power_spectrum(da, dim=["y", "x"],
                                              truncate=True)
    dist = sharded_isotropic_power_spectrum(
        da, mesh24, {"b": "p1", "y": "p2"}, dim=["y", "x"], truncate=True)
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-10)


def test_sharded_coherence_matches_local(mesh8):
    """sharded_coherence == local coherence (batch + segment sharding;
    segment_overlap engaged)."""
    from xrft_tpu.parallel import sharded_coherence

    N, SEG = 128, 16
    rng = np.random.RandomState(21)
    tt = np.arange(N) * 0.25
    shared = np.sin(2 * np.pi * 0.5 * tt)
    xa = LabeledArray(shared + 0.5 * rng.randn(8, N), dims=["b", "t"],
                      coords={"b": np.arange(8), "t": tt},
                      name="u").chunk({"t": SEG})
    ya = LabeledArray(0.5 * shared + 0.5 * rng.randn(8, N),
                      dims=["b", "t"], coords={"b": np.arange(8), "t": tt},
                      name="v").chunk({"t": SEG})
    local = xrft_tpu.coherence(xa, ya, dim="t", real_dim="t",
                               chunks_to_segments=True,
                               segment_overlap=SEG // 2)
    dist = sharded_coherence(xa, ya, mesh8, {"b": "p"}, dim="t",
                             real_dim="t", chunks_to_segments=True,
                             segment_overlap=SEG // 2)
    assert dist.dims == local.dims
    assert dist.name == "u_v_coherence"
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-6)


def test_sharded_welch_and_csd_match_local(mesh8):
    """sharded_welch / sharded_csd == the local scipy namesakes (batch
    sharding; segment axis rides as batch parallelism)."""
    from xrft_tpu.parallel import sharded_csd, sharded_welch

    N, SEG = 128, 16
    rng = np.random.RandomState(23)
    tt = np.arange(N) * 0.25
    xa = LabeledArray(rng.randn(8, N), dims=["b", "t"],
                      coords={"b": np.arange(8), "t": tt}, name="u")
    ya = LabeledArray(rng.randn(8, N), dims=["b", "t"],
                      coords={"b": np.arange(8), "t": tt}, name="v")

    local_w = xrft_tpu.welch(xa, dim="t", seglen=SEG)
    dist_w = sharded_welch(xa, mesh8, {"b": "p"}, dim="t", seglen=SEG)
    assert dist_w.dims == local_w.dims
    assert dist_w.name == "u_welch"
    npt.assert_allclose(carray.to_numpy(dist_w.data),
                        carray.to_numpy(local_w.data), atol=1e-6)

    local_c = xrft_tpu.csd(xa, ya, dim="t", seglen=SEG)
    dist_c = sharded_csd(xa, ya, mesh8, {"b": "p"}, dim="t", seglen=SEG)
    assert dist_c.dims == local_c.dims
    assert dist_c.name == "u_v_csd"
    npt.assert_allclose(carray.to_numpy(dist_c.data),
                        carray.to_numpy(local_c.data),
                        atol=1e-6 * np.abs(
                            carray.to_numpy(local_c.data)).max())


def test_sharded_isotropic_3d_shells(mesh24):
    """3-D spherical-shell isotropize (beyond the reference) under a
    sharded transform dim: the flattened 3-axis scatter-add aggregation
    runs across GSPMD-sharded spectral dims."""
    import warnings

    from xrft_tpu.parallel import sharded_isotropic_power_spectrum

    N = 16
    rng = np.random.RandomState(15)
    da = LabeledArray(rng.randn(4, N, N, N),
                      dims=["b", "z", "y", "x"],
                      coords={"z": np.arange(N) * 1.0,
                              "y": np.arange(N) * 1.0,
                              "x": np.arange(N) * 1.0})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        local = xrft_tpu.isotropic_power_spectrum(
            da, dim=["z", "y", "x"], truncate=False)
        dist = sharded_isotropic_power_spectrum(
            da, mesh24, {"b": "p1", "z": "p2"}, dim=["z", "y", "x"],
            truncate=False)
    assert dist.dims == local.dims == ("b", "freq_r")
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-10)
    npt.assert_allclose(dist["freq_r"].values, local["freq_r"].values)


@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft", "irfft"])
def test_pencil_with_stacked_engine(mesh8, kind):
    """The stacked matmul engine inside
    shard_map: pencil local transforms forced through engine='matmul'."""
    from xrft_tpu.config import fft_engine

    rng = np.random.RandomState(12)
    if kind in ("fft", "ifft"):
        x = rng.randn(32, 64) + 1j * rng.randn(32, 64)
        ref = np.fft.fftn(x) if kind == "fft" else np.fft.ifftn(x)
        xin = np.asarray(x)
    elif kind == "rfft":
        x = rng.randn(32, 64)
        ref = np.fft.rfftn(x)
        xin = np.asarray(x)
    else:
        xr = rng.randn(32, 64)
        spec = np.fft.rfftn(xr)
        ref = xr
        xin = spec.astype(np.complex128)
    with fft_engine("matmul"):
        got = pencil_fftn(xin, [0, 1], mesh8, {0: "p"}, kind)
    npt.assert_allclose(carray.to_numpy(got), ref, atol=1e-9)


@pytest.mark.parametrize("kind", ["fft", "ifft", "rfft", "irfft"])
def test_pencil_hp(mesh8, kind):
    """float64-grade distributed transforms (precision='hp'): df64 quads
    move through the pencil chain, exact int8-limb local DFTs — f64
    accuracy AND sharded transform dims on f32 hardware."""
    rng = np.random.RandomState(13)
    x = rng.randn(32, 64)
    if kind in ("fft", "ifft"):
        xin = (x + 1j * rng.randn(32, 64)).astype(np.complex128)
        ref = np.fft.fftn(xin) if kind == "fft" else np.fft.ifftn(xin)
    elif kind == "rfft":
        xin = x
        ref = np.fft.rfftn(x)
    else:
        xin = np.fft.rfftn(x)
        ref = x
    got = pencil_fftn(np.asarray(xin), [0, 1], mesh8, {0: "p"}, kind,
                      precision="hp")
    from xrft_tpu.ops.carray import CDF64, DF64

    assert isinstance(got, DF64 if kind == "irfft" else CDF64)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(np.asarray(got) - ref).max() / scale < 1e-10


def test_sharded_segmented_power_spectrum(mesh8):
    """chunks_to_segments composes with sharding: the
    chunked transform dim's shard spec moves to the segment axis (batch
    parallelism), and the result equals the local segmented estimate
    (reference segment semantics /root/reference/xrft/xrft.py:106-136)."""
    N, SEG = 128, 16
    rng = np.random.RandomState(11)
    da = LabeledArray(rng.randn(N, 24), dims=["x", "y"],
                      coords={"x": np.arange(N) * 0.5,
                              "y": np.arange(24) * 1.0}).chunk({"x": SEG})
    local = xrft_tpu.power_spectrum(da, dim=["x"], window="hann",
                                    chunks_to_segments=True)
    dist = sharded_power_spectrum(da, mesh8, {"x": "p"}, dim=["x"],
                                  window="hann", chunks_to_segments=True)
    assert dist.dims == local.dims
    assert "x_segment" in dist.dims
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)
    npt.assert_allclose(dist["freq_x"].values, local["freq_x"].values)
    # the shard landed on the segment axis: per-device shards are full
    # segments (no collectives on the transform axis)
    seg_ax = dist.dims.index("x_segment")
    shard_shape = dist.data.sharding.shard_shape(dist.data.shape)
    assert shard_shape[seg_ax] == (N // SEG) // 8


def test_sharded_segmented_overlap_power_spectrum(mesh8):
    """segment_overlap (overlapping Welch windows, beyond the reference)
    composes with sharding: strided segments stack on host metadata first
    and the shard spec moves to the segment axis when the overlapped
    segment count divides the mesh axis."""
    N, SEG, HOP = 136, 16, 8
    nseg = (N - SEG) // HOP + 1  # 16
    rng = np.random.RandomState(13)
    da = LabeledArray(rng.randn(N, 24), dims=["x", "y"],
                      coords={"x": np.arange(N) * 0.5,
                              "y": np.arange(24) * 1.0}).chunk({"x": SEG})
    local = xrft_tpu.power_spectrum(da, dim=["x"], window="hann",
                                    chunks_to_segments=True,
                                    segment_overlap=SEG - HOP)
    dist = sharded_power_spectrum(da, mesh8, {"x": "p"}, dim=["x"],
                                  window="hann", chunks_to_segments=True,
                                  segment_overlap=SEG - HOP)
    assert dist.dims == local.dims
    assert dist.sizes["x_segment"] == nseg
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)
    seg_ax = dist.dims.index("x_segment")
    shard_shape = dist.data.sharding.shard_shape(dist.data.shape)
    assert shard_shape[seg_ax] == nseg // 8


def test_sharded_segmented_unchunked_dim_keeps_pencil(mesh8):
    """A sharded transform dim with NO declared chunks stays on the
    pencil path under chunks_to_segments (its segment axis has size 1)."""
    N = 64
    rng = np.random.RandomState(12)
    da = LabeledArray(rng.randn(N, 8), dims=["x", "b"],
                      coords={"x": np.arange(N) * 1.0,
                              "b": np.arange(8)}).chunk({"b": 4})
    local = xrft_tpu.fft(da, dim=["x"], chunks_to_segments=True,
                         true_phase=True, true_amplitude=True)
    dist = sharded_fft(da, mesh8, {"x": "p"}, dim=["x"],
                       chunks_to_segments=True, true_phase=True,
                       true_amplitude=True)
    assert dist.dims == local.dims
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)


def test_sharded_segmented_cross_spectrum(mesh8):
    """Segmented sharded cross spectrum matches the local one (both
    inputs segmented identically)."""
    from xrft_tpu.parallel import sharded_cross_spectrum

    N, SEG = 128, 16
    rng = np.random.RandomState(13)
    coords = {"x": np.arange(N) * 0.5}
    a = LabeledArray(rng.randn(N), dims=["x"], coords=coords).chunk(
        {"x": SEG})
    b = LabeledArray(rng.randn(N), dims=["x"], coords=coords).chunk(
        {"x": SEG})
    local = xrft_tpu.cross_spectrum(a, b, dim=["x"],
                                    chunks_to_segments=True)
    dist = sharded_cross_spectrum(a, b, mesh8, {"x": "p"}, dim=["x"],
                                  chunks_to_segments=True)
    assert dist.dims == local.dims
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)


# ---------------------------------------------------------------------------
# Topology-aware planning (SURVEY §7 stage 6)
# ---------------------------------------------------------------------------


def test_make_mesh_axis_links_and_order():
    """make_mesh records ICI/DCN hints and makes DCN axes outermost
    (slowest-varying) so ICI groups stay within a slice."""
    from xrft_tpu.parallel import axis_links, make_mesh

    m = make_mesh({"fp": (4, "ici"), "dp": (2, "dcn")})
    assert axis_links(m) == {"dp": "dcn", "fp": "ici"}
    assert tuple(m.axis_names)[0] == "dp"  # DCN outermost
    # consecutive devices differ only in the ICI coordinate
    dev = np.asarray(m.devices)
    assert dev.shape == (2, 4)
    # plain int values still work, default ici
    m2 = make_mesh({"p": 8})
    assert axis_links(m2) == {"p": "ici"}


def test_axis_links_warns_on_unhinted_multislice_mesh(monkeypatch):
    """A mesh spanning >1 process (host) with NO link registration warns
    (once) that pencil plans will assume all-ICI; hinted meshes and
    single-process meshes stay silent."""
    import warnings

    from xrft_tpu.parallel import axis_links, make_mesh
    from xrft_tpu.parallel import mesh as mesh_mod

    class _Dev:
        def __init__(self, process_index):
            self.process_index = process_index

    # granule detection itself, on a stubbed device list
    assert mesh_mod._granules([_Dev(0), _Dev(0), _Dev(1)]) == {0, 1}
    assert mesh_mod._granules([_Dev(None), object()]) == set()
    # the CPU test devices all live in this one process
    assert mesh_mod._granules(jax.devices()) == {0}

    # an unregistered mesh that "spans two hosts" (stubbed: the CPU test
    # devices share one process, so patch the detector)
    m = jax.make_mesh((8,), ("p",))
    mesh_mod._MESH_LINKS.pop(m, None)  # make_mesh interning may have hit it
    mesh_mod._WARNED_UNHINTED.discard(m)
    real_granules = mesh_mod._granules
    monkeypatch.setattr(mesh_mod, "_granules", lambda devs: {0, 1})
    with pytest.warns(RuntimeWarning, match="assume every axis is ICI"):
        assert axis_links(m) == {"p": "ici"}
    # second call: warned once, default registered
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert axis_links(m) == {"p": "ici"}

    # a hinted mesh never warns, even across hosts (built on the real
    # single-process devices, read back under the stubbed detector)
    monkeypatch.setattr(mesh_mod, "_granules", real_granules)
    m2 = make_mesh({"fp": (4, "ici"), "dp": (2, "dcn")})
    monkeypatch.setattr(mesh_mod, "_granules", lambda devs: {0, 1})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert axis_links(m2) == {"dp": "dcn", "fp": "ici"}

    # a make_mesh call WITHOUT hints must not register links (that would
    # suppress this warning for a later unhinted multi-host handle)
    m3 = make_mesh({"p": 8})
    assert mesh_mod._MESH_LINKS.get(m3) is None or m3 is m2

    # drop the warned marker so other tests sharing the interned Mesh
    # object see a clean registry
    mesh_mod._WARNED_UNHINTED.discard(m)


class _StubGpu:
    """Stand-in for a GPU device of a multi-host job."""

    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index

    def __repr__(self):
        return f"gpu{self.id}@p{self.process_index}"


@pytest.mark.parametrize("order,sizes,links,expect", [
    # DCN axis outermost: one row per host, ICI axis inside a host
    (["dp", "fp"], {"dp": 2, "fp": 4}, {"dp": "dcn", "fp": "ici"},
     [[0, 1, 2, 3], [4, 5, 6, 7]]),
    # two ICI axes inside each host: (dp, a, b) = (2, 2, 2)
    (["dp", "a", "b"], {"dp": 2, "a": 2, "b": 2},
     {"dp": "dcn", "a": "ici", "b": "ici"},
     [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]),
])
def test_hybrid_device_grid_process_granules(order, sizes, links, expect):
    """Hybrid meshes group devices by process: every ICI group stays
    inside one host (one process), the DCN axis steps across hosts."""
    from xrft_tpu.parallel import mesh as mesh_mod

    # devices listed host-interleaved, to show grouping is by process
    devs = [_StubGpu(i, i // 4) for i in (0, 4, 1, 5, 2, 6, 3, 7)]
    grid = mesh_mod._hybrid_device_grid(order, sizes, links, devs)
    ids = np.vectorize(lambda d: d.id)(grid)
    npt.assert_array_equal(ids, np.array(expect))
    procs = np.vectorize(lambda d: d.process_index)(grid)
    assert [set(procs[i].ravel()) for i in range(2)] == [{0}, {1}]


def test_hybrid_mesh_single_process_is_plain(monkeypatch):
    """On one process (one host, as on a four-card NVLink machine) a
    DCN-hinted mesh is a plain mesh in DCN-outermost axis order; the
    hybrid grid is never consulted."""
    from xrft_tpu.parallel import mesh as mesh_mod

    def _boom(*a, **k):
        raise AssertionError("hybrid grid used on one process")

    monkeypatch.setattr(mesh_mod, "_hybrid_device_grid", _boom)
    m = mesh_mod._hybrid_mesh(["dp", "fp"], {"dp": 2, "fp": 4},
                              {"dp": "dcn", "fp": "ici"})
    assert dict(m.shape) == {"dp": 2, "fp": 4}


def test_plan_dcn_axes_ordered_last():
    """A chain mixing ICI- and DCN-sharded transform axes transforms the
    DCN axis last, so its single inter-host all_to_all can park on an
    already-transformed (settled) axis."""
    from xrft_tpu.parallel.pencil import plan_forward_layout

    links = {"d": "dcn", "i": "ici"}
    # axes 1 (dcn) and 2 (ici) both sharded; caller order puts dcn first
    steps, final = plan_forward_layout(
        (8, 8, 8), [1, 2], {1: "d", 2: "i"}, {"d": 2, "i": 4},
        axis_links=links)
    assert [s[1] for s in steps] == [2, 1]  # ici axis first, dcn last
    assert steps[0][0] == "move" and steps[1][0] == "move"
    # the dcn sharding parks exactly once
    assert final[steps[1][2]] == "d"


def test_plan_ici_move_reserves_dcn_destination():
    """An ICI move avoids squatting on the only destination a pending DCN
    move can use (axis sizes: the batch axis divides the DCN size, the
    ici alternative does not)."""
    from xrft_tpu.parallel.pencil import plan_forward_layout

    links = {"d": "dcn", "i": "ici"}
    # shape (3, 9, 8, 8): axis 0 divides i=3 only; axis 1 divides both
    # i=3 and d=2? no — pick sizes so exactly one axis serves the dcn move
    # mesh i=3, d=2; batch axes: 0 (size 3, only i fits), 1 (size 4, only
    # d fits... also test rank-1 penalty: axis 1 size 12 fits both)
    steps, final = plan_forward_layout(
        (3, 12, 9, 8), [2, 3], {2: "i", 3: "d"}, {"i": 3, "d": 2},
        axis_links=links)
    # ici move (axis 2) must pick axis 0 (rank 0), NOT axis 1 (reserved
    # for the pending dcn move, rank 1)
    assert ("move", 2, 0, "i") in steps
    assert ("move", 3, 1, "d") in steps
    # without links, the ici move would take axis 0 anyway (tie keeps
    # lowest index) — so also check the reservation flips a real choice:
    steps2, _ = plan_forward_layout(
        (12, 3, 9, 8), [2, 3], {2: "i", 3: "d"}, {"i": 3, "d": 2},
        axis_links=links)
    # axis 0 (size 12) fits both but is reserved; axis 1 (size 3) fits i
    assert ("move", 2, 1, "i") in steps2
    assert ("move", 3, 0, "d") in steps2
    # and WITHOUT topology hints the ici move takes axis 0 greedily,
    # forcing the d move onto the transformed axis 2 (if divisible) or a
    # roundtrip — pin the contrast
    steps3, _ = plan_forward_layout(
        (12, 3, 9, 8), [2, 3], {2: "i", 3: "d"}, {"i": 3, "d": 2})
    assert ("move", 2, 0, "i") in steps3


def test_pencil_fftn_dcn_mesh_parity(mesh24):
    """Values are identical whatever the topology hints (the plan changes,
    the math doesn't): dcn-hinted mesh vs plain mesh vs local numpy."""
    from xrft_tpu.parallel import make_mesh

    mesh_hint = make_mesh({"q1": (2, "dcn"), "q2": (4, "ici")})
    rng = np.random.RandomState(21)
    x = np.asarray(rng.randn(8, 16, 32), np.float32)
    got = carray.to_numpy(
        pencil_fftn(x, [1, 2], mesh_hint, {1: "q1", 2: "q2"}, "fft"))
    ref = np.fft.fftn(x.astype(np.float64), axes=[1, 2])
    npt.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max())


def test_sharded_psd_dcn_mesh(mesh24):
    """The high-level sharded PSD runs on a topology-hinted mesh (the
    mirror-sharding reconstruction uses the same link-aware plan)."""
    from xrft_tpu.parallel import make_mesh

    mesh_hint = make_mesh({"b1": (2, "dcn"), "b2": (4, "ici")})
    N = 32
    rng = np.random.RandomState(22)
    da = LabeledArray(rng.randn(N, N), dims=["y", "x"],
                      coords={"y": np.arange(N), "x": np.arange(N)})
    local = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann")
    dist = sharded_power_spectrum(da, mesh_hint, {"y": "b1", "x": "b2"},
                                  dim=["y", "x"], window="hann")
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)


# ---------------------------------------------------------------------------
# Generic sharded() wrapper: every public estimator
# either runs under dim_shards (batch dims) or rejects with a
# prescriptive error.
# ---------------------------------------------------------------------------


def test_sharded_generic_batch_estimators(mesh8):
    """1-D namesakes under batch sharding == local results."""
    from xrft_tpu.parallel import sharded

    rng = np.random.RandomState(11)
    vals = rng.randn(8, 256)
    da = LabeledArray(vals, dims=["b", "t"],
                      coords={"t": np.arange(256) * 0.5,
                              "b": np.arange(8)})
    cases = [
        ("spectrogram", dict(dim="t", seglen=64, window="hann")),
        ("stft", dict(dim="t", seglen=64, window="hann")),
        ("dct", dict(dim="t", type=2, norm="ortho")),
        ("hilbert", dict(dim="t")),
        ("resample", dict(num=128, dim="t")),
        ("resample_poly", dict(dim="t")),
        ("decimate", dict(dim="t")),
        ("periodogram", dict(dim="t", window="hann")),
    ]
    for name, kw in cases:
        args = (2, 3) if name == "resample_poly" else \
            (4,) if name == "decimate" else ()
        local = getattr(xrft_tpu, name)(da, *args, **kw)
        dist = sharded(name, da, *args, mesh=mesh8, dim_shards={"b": "p"},
                       **kw)
        npt.assert_allclose(carray.to_numpy(dist.data),
                            carray.to_numpy(local.data),
                            atol=1e-9, err_msg=name)
        assert dist.dims == local.dims, name


def test_sharded_generic_multi_dim_estimators(mesh8):
    """hilbert2/dctn under batch sharding == local; sharding a transform
    dim (incl. the implicit all-dims default of dctn) rejects."""
    from xrft_tpu.parallel import sharded

    rng = np.random.RandomState(14)
    da = LabeledArray(rng.randn(8, 24, 16), dims=["b", "y", "x"],
                      coords={"b": np.arange(8)})
    for name, kw in [("hilbert2", dict(dim=["y", "x"])),
                     ("dctn", dict(dim=["y", "x"], norm="ortho")),
                     ("idstn", dict(dim=["y", "x"]))]:
        local = getattr(xrft_tpu, name)(da, **kw)
        dist = sharded(name, da, mesh=mesh8, dim_shards={"b": "p"}, **kw)
        npt.assert_allclose(carray.to_numpy(dist.data),
                            carray.to_numpy(local.data),
                            atol=1e-9, err_msg=name)
    with pytest.raises(ValueError, match="no distributed-transform"):
        sharded("hilbert2", da, mesh=mesh8, dim_shards={"x": "p"},
                dim=["y", "x"])
    with pytest.raises(ValueError, match="no distributed-transform"):
        # dctn with dim=None transforms every dim, so ANY shard rejects
        sharded("dctn", da, mesh=mesh8, dim_shards={"b": "p"})


def test_sharded_generic_two_input(mesh8):
    """Convolution family under batch sharding == local."""
    from xrft_tpu.parallel import sharded

    rng = np.random.RandomState(12)
    da = LabeledArray(rng.randn(8, 200), dims=["b", "t"],
                      coords={"t": np.arange(200) * 1.0,
                              "b": np.arange(8)})
    kern = LabeledArray(rng.randn(15), dims=["t"],
                        coords={"t": np.arange(15) * 1.0})
    for name in ("fftconvolve", "oaconvolve", "correlate"):
        local = getattr(xrft_tpu, name)(da, kern, dims="t", mode="same")
        dist = sharded(name, da, kern, mesh=mesh8,
                       dim_shards={"b": "p"}, dims="t", mode="same")
        npt.assert_allclose(carray.to_numpy(dist.data),
                            carray.to_numpy(local.data),
                            atol=1e-9, err_msg=name)


def test_sharded_generic_rejects_transform_dim(mesh8):
    """Sharding the transform dim of a non-pencil estimator raises the
    prescriptive error (no silent gather)."""
    from xrft_tpu.parallel import sharded

    rng = np.random.RandomState(13)
    da = LabeledArray(rng.randn(8, 256), dims=["b", "t"],
                      coords={"t": np.arange(256) * 0.5,
                              "b": np.arange(8)})
    kern = LabeledArray(rng.randn(15), dims=["t"],
                        coords={"t": np.arange(15) * 1.0})
    for name, args, kw in [
        ("spectrogram", (), dict(dim="t", seglen=64)),
        ("dct", (), dict(dim="t")),
        ("hilbert", (), dict(dim="t")),
        ("fftconvolve", (kern,), dict(dims="t")),
    ]:
        with pytest.raises(ValueError, match="no distributed-transform"):
            sharded(name, da, *args, mesh=mesh8, dim_shards={"t": "p"},
                    **kw)


def test_sharded_generic_pencil_dispatch(mesh8):
    """sharded() routes pencil-capable estimators to their sharded_*
    counterpart — transform dims may then be sharded."""
    from xrft_tpu.parallel import sharded

    rng = np.random.RandomState(14)
    da = LabeledArray(rng.randn(64, 8), dims=["x", "b"],
                      coords={"x": np.arange(64) * 0.25,
                              "b": np.arange(8)})
    local = xrft_tpu.power_spectrum(da, dim=["x"])
    dist = sharded("power_spectrum", da, mesh=mesh8,
                   dim_shards={"x": "p"}, dim=["x"])
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-11)


def test_sharded_generic_unknown_and_unroutable(mesh8):
    from xrft_tpu.parallel import sharded

    da = LabeledArray(np.zeros((4, 8)), dims=["b", "t"],
                      coords={"t": np.arange(8) * 1.0})
    with pytest.raises(ValueError, match="unknown estimator"):
        sharded("nonsense", da, mesh=mesh8, dim_shards={})
    with pytest.raises(ValueError, match="no mesh route"):
        sharded("pad", da, mesh=mesh8, dim_shards={})


def test_sharded_cross_phase_matches_local(mesh8):
    rng = np.random.RandomState(15)
    da1 = LabeledArray(rng.randn(8, 64), dims=["b", "x"],
                       coords={"x": np.arange(64) * 0.5,
                               "b": np.arange(8)}, name="u")
    da2 = LabeledArray(rng.randn(8, 64), dims=["b", "x"],
                       coords={"x": np.arange(64) * 0.5,
                               "b": np.arange(8)}, name="v")
    from xrft_tpu.parallel import sharded_cross_phase

    local = xrft_tpu.cross_phase(da1, da2, dim=["x"])
    dist = sharded_cross_phase(da1, da2, mesh8, {"x": "p"}, dim=["x"])
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-10)
    assert dist.name == "u_v_phase"


def test_sharded_isotropic_cross_spectrum_matches_local(mesh24):
    rng = np.random.RandomState(16)
    N = 32
    c = {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5}
    da1 = LabeledArray(rng.randn(N, N), dims=["y", "x"], coords=c)
    da2 = LabeledArray(rng.randn(N, N), dims=["y", "x"], coords=c)
    from xrft_tpu.parallel import sharded_isotropic_cross_spectrum

    local = xrft_tpu.isotropic_cross_spectrum(da1, da2, dim=["y", "x"])
    dist = sharded_isotropic_cross_spectrum(
        da1, da2, mesh24, {"y": "p1", "x": "p2"}, dim=["y", "x"])
    npt.assert_allclose(carray.to_numpy(dist.data),
                        carray.to_numpy(local.data), atol=1e-10)
    npt.assert_allclose(dist["freq_r"].values, local["freq_r"].values)


def test_sharded_istft_roundtrip(mesh8):
    """istft under batch sharding inverts a batch-sharded stft."""
    from xrft_tpu.parallel import sharded

    rng = np.random.RandomState(17)
    vals = rng.randn(8, 256)
    da = LabeledArray(vals, dims=["b", "t"],
                      coords={"t": np.arange(256) * 0.5,
                              "b": np.arange(8)})
    st = sharded("stft", da, mesh=mesh8, dim_shards={"b": "p"},
                 dim="t", seglen=64, window="hann")
    back = sharded("istft", st, mesh=mesh8, dim_shards={"b": "p"})
    npt.assert_allclose(carray.to_numpy(back.data)[:, :256], vals,
                        atol=1e-9)
    with pytest.raises(ValueError, match="no distributed-transform"):
        sharded("istft", st, mesh=mesh8, dim_shards={"freq_t": "p"})


# ---------------------------------------------------------------------------
# Pencil-planner property fuzz: randomized
# shape x mesh factorization (incl. the non-power-of-two 6 = 2x3)
# x transform-axis subset x sharding placement x kind, vs the local
# numpy oracle.  Catches planner interaction bugs (buddy selection,
# chain ordering, rfft placement) the enumerated cells don't combine.
# ---------------------------------------------------------------------------

def _fuzz_mesh(tag):
    if tag == "p8":
        return make_mesh({"p": 8}), [("p", 8)]
    if tag == "p24":
        return make_mesh({"p1": 2, "p2": 4}), [("p1", 2), ("p2", 4)]
    if tag == "p42":
        return make_mesh({"p1": 4, "p2": 2}), [("p1", 4), ("p2", 2)]
    if tag == "p222":
        return make_mesh({"a": 2, "b": 2, "c": 2}), \
            [("a", 2), ("b", 2), ("c", 2)]
    if tag == "p23":  # non-power-of-two: 6 of the 8 devices as 2x3
        from jax.sharding import Mesh
        devs = np.array(jax.devices()[:6]).reshape(2, 3)
        return Mesh(devs, ("q1", "q2")), [("q1", 2), ("q2", 3)]
    raise AssertionError(tag)


PENCIL_FUZZ = []
_prng = np.random.RandomState(4242)
_tags = ["p8", "p24", "p42", "p222", "p23"]
for i in range(16):
    tag = _tags[i % len(_tags)]
    ndim = int(_prng.randint(2, 4))
    PENCIL_FUZZ.append(dict(seed=2000 + i, tag=tag, ndim=ndim,
                            kind=["fft", "ifft", "rfft"][_prng.randint(3)]))


@pytest.mark.parametrize("case", PENCIL_FUZZ,
                         ids=lambda c: f"pf{c['seed']}_{c['tag']}")
def test_pencil_planner_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    mesh, axes_sizes = _fuzz_mesh(case["tag"])
    ndim, kind = case["ndim"], case["kind"]
    lcm = int(np.lcm.reduce([s for _, s in axes_sizes]))

    # sizes: multiples of every mesh-axis size, incl. odd multiples so
    # non-power-of-two local FFT lengths (12, 18, 36...) get planned
    shape = tuple(int(lcm * rs.choice([1, 2, 3])) for _ in range(ndim))
    n_t = int(rs.randint(1, ndim + 1))
    tdims = sorted(rs.choice(ndim, size=n_t, replace=False).tolist())
    if kind == "rfft":
        # real axis must be trailing and unsharded
        tdims = sorted(set(tdims) | {ndim - 1})

    # assign each mesh axis to a distinct array axis (or leave unused);
    # never shard the rfft real axis
    shardable = [a for a in range(ndim)
                 if not (kind == "rfft" and a == ndim - 1)]
    rs.shuffle(shardable)
    sharding = {}
    for (name, _), a in zip(axes_sizes, shardable):
        if rs.rand() < 0.8:  # some axes stay unsharded
            sharding[a] = name

    x = rs.randn(*shape)
    if kind != "rfft":
        x = x + 1j * rs.randn(*shape)

    got = pencil_fftn(np.asarray(x), tdims, mesh, sharding, kind)
    ref = {"fft": np.fft.fftn, "ifft": np.fft.ifftn,
           "rfft": np.fft.rfftn}[kind](x, axes=tdims)
    scale = max(np.abs(ref).max(), 1e-12)
    npt.assert_allclose(carray.to_numpy(got) / scale, ref / scale,
                        atol=1e-10)

    if kind == "rfft":  # irfft placement: invert through the same chain
        back = pencil_fftn(got, tdims, mesh, sharding, "irfft")
        npt.assert_allclose(carray.to_numpy(back), x, atol=1e-10)
