"""chip_smoke.py off the card: its refusal without a GPU, its options, its
host oracles, and every phase's code path at TINY sizes on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SINGLE = [
    "flagship_psd", "onesided_psd", "welch_psd", "welch_overlap_psd",
    "cross_spectrum", "fft_ifft_roundtrip", "irfft2_sorted",
    "irfft2_natural", "isotropic_psd_32", "isotropic_psd_64",
    "spectrogram", "stft", "dct2", "fftconvolve", "convolve_direct",
    "flagship_psd_matmul_engine", "hp_psd_emulated", "hp_psd_native",
    "hp_fft_native",
]
MULTI = ["sharded_power_spectrum", "pencil_fftn_3d"]


def _run_script(args, cwd, env_extra):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    last = stdout.strip().splitlines()[-1:] or [""]
    try:
        return not json.loads(last[0]).get("ok")
    except (ValueError, AttributeError):
        return True


@pytest.mark.parametrize("args", [[], ["--cards", "4"]])
def test_refuses_without_gpu(args):
    """On the CPU backend the script exits non-zero, names the missing
    GPU, and prints no result line."""
    res = _run_script(args, ROOT, {"JAX_PLATFORMS": "cpu"})
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert _no_result(res.stdout)


def test_fails_alone_without_the_package(tmp_path):
    """Copied into a directory without the repository, it fails too."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = _run_script([], tmp_path, {"JAX_PLATFORMS": "cpu",
                                     "PYTHONPATH": ""})
    assert res.returncode != 0
    assert _no_result(res.stdout)


@pytest.mark.parametrize("argv,cards,seed", [
    ([], 1, 0), (["--cards", "4"], 4, 0), (["--cards", "1", "--seed", "3"],
                                           1, 3),
])
def test_parse_args(argv, cards, seed):
    args = chip_smoke.parse_args(argv)
    assert (args.cards, args.seed) == (cards, seed)


@pytest.mark.parametrize("argv", [["--cards", "2"], ["--cards", "x"]])
def test_parse_args_rejects(argv):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(argv)


def test_cards_4_selects_only_the_sharded_phases():
    assert [p.name for p in chip_smoke.phases_for(4, chip_smoke.TINY)] \
        == MULTI


def test_phase_names_and_hp_last():
    """The default run has every one-card phase; the x64 phases run
    last so x64 cannot promote the float32 phases."""
    names = [p.name for p in chip_smoke.phases_for(1, chip_smoke.TINY)]
    assert names == SINGLE
    assert names[-2:] == ["hp_psd_native", "hp_fft_native"]


def test_detrend_linear_2d_removes_planes():
    rng = np.random.RandomState(0)
    y, x = np.meshgrid(np.arange(6.0), np.arange(9.0), indexing="ij")
    noise = rng.randn(2, 6, 9)
    planes = np.stack([3.0 + 0.5 * y - 2.0 * x, -1.0 + 0.1 * x])
    npt.assert_allclose(chip_smoke.detrend_linear_2d(planes + noise),
                        chip_smoke.detrend_linear_2d(noise), atol=1e-12)
    npt.assert_allclose(chip_smoke.detrend_linear_2d(planes), 0, atol=1e-12)


def test_psd_oracle_one_sided_matches_two_sided():
    """The one-sided oracle is the two-sided one folded onto kx >= 0
    (two-sided fftshifted on both axes; one-sided in numpy order)."""
    rng = np.random.RandomState(1)
    v = rng.randn(8, 8)
    two = np.fft.ifftshift(chip_smoke.psd2_oracle(v, 0.5, 0.5))
    one = chip_smoke.psd2_oracle(v, 0.5, 0.5, one_sided=True)
    assert one.shape == (8, 5)
    # DC and Nyquist columns appear once; the others are doubled
    npt.assert_allclose(one[:, 1:4] / 2, two[:, 1:4], rtol=1e-12)
    npt.assert_allclose(one[:, 0], two[:, 0], rtol=1e-12)
    npt.assert_allclose(one[:, 4], two[:, 4], rtol=1e-12)
    npt.assert_allclose(one.sum(), two.sum(), rtol=1e-12)


def test_pd_cut_codes_oracle_matches_library():
    from xrft_tpu.ops.binning import cut_codes

    k = np.fft.fftshift(np.fft.fftfreq(48))
    r = np.sqrt(k[:, None] ** 2 + k[None, :] ** 2).ravel()
    for nbins in (3, 12, 40):
        npt.assert_array_equal(chip_smoke.pd_cut_codes(r, nbins),
                               cut_codes(r, nbins)[0])


def test_rel_err_rejects_bad_results():
    ref = np.ones((2, 3))
    assert chip_smoke.rel_err(ref * 1.5, ref) == pytest.approx(0.5)
    with pytest.raises(chip_smoke.PhaseFailed, match="shape"):
        chip_smoke.rel_err(np.ones(3), ref)
    with pytest.raises(chip_smoke.PhaseFailed, match="non-finite"):
        chip_smoke.rel_err(np.full((2, 3), np.nan), ref)
    assert chip_smoke.rel_err_fields(ref * 2, lambda i: ref[i], 2) == 1.0


@pytest.fixture(scope="module")
def single_phases():
    return {p.name: p for p in chip_smoke.single_card_phases(
        chip_smoke.TINY)}


@pytest.mark.parametrize("name", SINGLE)
def test_single_card_phase_tiny(single_phases, name, capsys):
    """Every one-card phase runs through its real code path at TINY
    sizes and meets its tolerance against the float64 oracle."""
    ph = single_phases[name]
    res = chip_smoke.run_phase(ph)
    assert res["ok"] and res["err"] <= res["tol"]
    line = capsys.readouterr().out
    assert line.startswith(f"PHASE {name}: ok err=")
    for key in ("precision:", "wall_ms median=", "compile_s=", "mem ",
                "peak "):
        assert key in line
    if name == "flagship_psd_matmul_engine":
        # the config context reached the trace: dots, no FFT op
        assert " fft(" not in ph.hlo and "dot(" in ph.hlo
    if name == "flagship_psd":
        assert " fft(" in ph.hlo


@pytest.fixture(scope="module")
def multi_phases():
    return {p.name: p for p in chip_smoke.multi_card_phases(
        chip_smoke.TINY)}


@pytest.mark.parametrize("name", MULTI)
def test_multi_card_phase_tiny(multi_phases, name):
    """The sharded phases on four of the virtual CPU devices."""
    res = chip_smoke.run_phase(multi_phases[name])
    assert res["ok"]


def test_check_quarters_rejects_one_card():
    import jax

    x = jax.device_put(np.zeros((8, 4), np.float32), jax.devices()[0])
    with pytest.raises(chip_smoke.PhaseFailed, match="spans 1 cards"):
        chip_smoke._check_quarters(x, 0)


def test_check_card_bytes_catches_a_gathered_program():
    """memory_analysis of a sharded program reports per-card bytes: a
    quarter each when sharded over four cards, the whole when one card
    holds everything."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xrft_tpu.parallel import make_mesh

    mesh = make_mesh({"fp": 4})
    x = jax.device_put(np.zeros((16, 8), np.float32),
                       NamedSharding(mesh, P("fp", None)))
    quarter = x.nbytes // 4
    sharded = jax.jit(lambda v: v * 2).lower(x).compile()
    chip_smoke._check_card_bytes(sharded, (quarter, quarter))
    one = jax.device_put(np.zeros((16, 8), np.float32), jax.devices()[0])
    gathered = jax.jit(lambda v: v * 2).lower(one).compile()
    with pytest.raises(chip_smoke.PhaseFailed, match="per-card"):
        chip_smoke._check_card_bytes(gathered, (quarter, quarter))


class _Card:
    def __init__(self, peak, platform="gpu"):
        self.platform = platform
        self._peak = peak

    def memory_stats(self):
        return {"peak_bytes_in_use": self._peak}


@pytest.mark.parametrize("peaks,ok", [
    ([40, 3, 3, 3], True),       # card 0 also ran the one-card reference
    ([40, 3, 3, 12], False),     # one card reached a full copy's footprint
    ([40, 12, 12, 12], False),   # every card held a full copy
])
def test_check_card_peaks_bounds_by_the_one_card_footprint(peaks, ok):
    cards = [_Card(p << 30) for p in peaks]
    if ok:
        chip_smoke._check_card_peaks(12 << 30, cards)
    else:
        with pytest.raises(chip_smoke.PhaseFailed, match="one-card"):
            chip_smoke._check_card_peaks(12 << 30, cards)


def test_check_card_peaks_needs_peaks_on_gpu_only():
    chip_smoke._check_card_peaks(1, [_Card(None, "cpu")] * 4)
    with pytest.raises(chip_smoke.PhaseFailed, match="no peak"):
        chip_smoke._check_card_peaks(1, [_Card(None)] * 4)
