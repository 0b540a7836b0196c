"""Checks that mean something only on an NVIDIA GPU: they skip elsewhere
(the ``gpu`` fixture decides at run time).  On the card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.gpu
def test_chip_checks_pass_on_gpu(gpu):
    """scripts/chip_checks.py's scipy/numpy oracles, compiled for the
    card."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_checks

    assert chip_checks.run_checks() == 0


@pytest.mark.gpu
def test_chip_smoke_phases_tiny_on_gpu(gpu):
    """Every one-card phase of chip_smoke.py compiles for the card and
    meets its tolerance at TINY sizes (a quick first compile check)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    chip_smoke.run_phases(chip_smoke.single_card_phases(chip_smoke.TINY))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,axes", [((4, 64, 33), (1, 2)),
                                        ((16, 12, 9), (0, 1, 2))])
def test_irfft_nonhermitian_matches_numpy_on_gpu(gpu, shape, axes):
    """The xla engine's irfft (cuFFT on the card) follows numpy's c2r for
    input that is not Hermitian-consistent."""
    import numpy as np

    import jax
    import xrft_tpu.ops.fft_core as fft_core

    rng = np.random.RandomState(0)
    X = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    got = np.asarray(jax.jit(lambda v: fft_core.irfftn(
        v, list(axes), engine="xla"))(X))
    ref = np.fft.irfftn(X.astype(np.complex128), axes=axes)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
