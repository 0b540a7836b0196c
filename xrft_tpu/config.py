"""Global configuration for xrft_tpu.

Everything here is host-side, static configuration that shapes how the
jit-compiled spectral pipelines are traced.  There is deliberately no
config-file / env-flag sprawl: like the reference library (which is 100%
keyword-argument driven), per-call behaviour is controlled by kwargs; the
few process-wide knobs live here.

Reference: xrft has no config system at all (see SURVEY.md §5).  The
``"auto"`` settings resolve on the cpu and gpu backends (XLA's FFT, native
complex dtypes, native float64 for ``engine='hp'``); any other backend is
refused rather than guessed at.  The matmul/stacked FFT engines, split
complex pairs and the int8/df64 float64 emulation are plain-JAX paths kept
reachable through explicit settings until ROADMAP.md Design 1.2-1.3
removes them.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from pathlib import Path

import jax

# backends whose "auto" choices are known: XLA's FFT op, native complex
# dtypes and real float64 all execute there
SUPPORTED_BACKENDS = ("cpu", "gpu")


@dataclasses.dataclass
class _Config:
    # FFT execution engine:
    #   "auto"   - XLA's native FFT (pocketfft/ducc on cpu, cuFFT on gpu).
    #   "xla"    - always lower to the FFT HLO.
    #   "matmul" - always use the four-step/Bluestein matmul engine.
    fft_engine: str = "auto"
    # matmul engine: largest size for which a direct O(N^2) DFT matmul is
    # used before switching to the four-step factorization.
    direct_dft_max: int = 128
    # Complex-number representation:
    #   "auto"   - native complex dtypes.
    #   "native" - force native complex dtypes.
    #   "split"  - force split (re, im) pairs (tests use this on CPU to
    #              keep the split-pair code path covered).
    complex_mode: str = "auto"
    # matmul engine dot precision: "highest" (~f32 accuracy), "high", or
    # "default" (fastest, lowest accuracy; TF32 on an H100).  f64 inputs
    # always use exact f64 arithmetic.
    matmul_precision: str = "highest"
    # Stacked-complex pad-free engine (ops/stacked_fft.py), used by the
    # matmul engine: "auto" uses it for every forward fft/rfft/ifft whose
    # axis sizes factor into radices <= direct_dft_max; "never" forces the
    # pair engine.
    stacked_fft: str = "auto"
    # Raw-layout (fused-estimator) engine only: largest pruned-rfft axis
    # size planned as a SINGLE direct dot instead of the multi-level
    # factorization.  A one-level plan leaves the one-sided axis fully
    # contiguous in the raw digit layout, so the estimator's restore pass
    # is a near-free reshape; multi-level plans interleave it in
    # level-0-digit-sized runs.
    direct_prune_max: int = 1024
    # Pencil-FFT compute/communication overlap: split each
    # (all_to_all -> local FFT) pair along a resident batch axis into this
    # many independent chunks so XLA's latency-hiding scheduler can overlap
    # chunk i's collective with chunk i-1's FFT.  1 = no chunking.
    pencil_overlap_chunks: int = 1
    # engine='hp' implementation:
    #   "auto"    - native float64 when jax_enable_x64 is on (f64 quad
    #               planes + the c128 XLA FFT; <=1e-12 measured on CPU);
    #               int8-limb/df64 emulation otherwise.
    #   "emulate" - force the int8-limb/df64 emulation everywhere.
    #   "native"  - force native (errors without x64).
    hp_impl: str = "auto"
    # Hermitian row-pair packed two-sided PSD (ops/psd_packed.py, matmul
    # engine only): "auto" takes the packed route (half-size complex FFT +
    # elementwise combine, no mirror pass) for real 2-D power spectra
    # whenever applicable; "never" (default) keeps the one-sided rfft +
    # mirror route.
    psd_packed: str = "never"
    # convolve/correlate method='auto' crossover: kernels with at most
    # this many elements (over the transform dims) take the direct
    # ``conv_general_dilated`` route; larger kernels take the padded-FFT
    # route.  The value has not been re-derived for the H100: chip_smoke.py
    # prints both routes' times for a 4096^2 field and a 63^2 kernel.
    direct_conv_max: int = 8192


config = _Config()


def check_backend() -> str:
    """The default backend's platform, refused unless it is one whose
    ``"auto"`` choices are known (:data:`SUPPORTED_BACKENDS`)."""
    platform = jax.default_backend()
    if platform not in SUPPORTED_BACKENDS:
        raise RuntimeError(
            f"xrft_tpu resolves its 'auto' settings on the "
            f"{' and '.join(SUPPORTED_BACKENDS)} backends only; the "
            f"default backend is {platform!r}.  Set config.fft_engine, "
            f"config.complex_mode and config.hp_impl explicitly to run "
            f"there.")
    return platform


def compile_cache_dir(checkout: str | os.PathLike | None = None) -> str:
    """Where JAX's persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else the fixed
    ``<checkout>/.jax_cache`` (``checkout`` defaults to the directory that
    holds the ``xrft_tpu`` package).  The path is part of the cache's key,
    so it is never built from a temporary name, a process id or the time.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = Path(checkout) if checkout is not None \
        else Path(__file__).resolve().parents[1]
    return str(root / ".jax_cache")


def enable_compile_cache(checkout: str | os.PathLike | None = None) -> str:
    """Turn on JAX's persistent compilation cache for an entry point
    (chip_smoke.py, bench.py, scripts/chip_checks.py) and return its
    directory.  A set ``JAX_COMPILATION_CACHE_DIR`` is left to JAX, which
    reads it itself; no other cache is set in code then."""
    path = compile_cache_dir(checkout)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def set_fft_engine(engine: str) -> None:
    if engine not in ("auto", "xla", "matmul"):
        raise ValueError(f"Unknown fft engine {engine!r}")
    config.fft_engine = engine


def resolve_fft_engine(override: str | None = None) -> str:
    """Resolve 'auto' to a concrete engine for the default backend."""
    engine = override or config.fft_engine
    if engine == "auto":
        check_backend()
        return "xla"
    return engine


@contextmanager
def fft_engine(engine: str):
    """Context manager to temporarily force an FFT engine (used in tests)."""
    old = config.fft_engine
    set_fft_engine(engine)
    try:
        yield
    finally:
        config.fft_engine = old


@contextmanager
def hp_impl(mode: str):
    """Context manager to temporarily force the engine='hp' implementation
    ("auto" | "emulate" | "native"); tests force "emulate" on CPU to keep
    the int8-limb/df64 emulation covered."""
    if mode not in ("auto", "emulate", "native"):
        raise ValueError(f"Unknown hp implementation {mode!r}")
    old = config.hp_impl
    config.hp_impl = mode
    try:
        yield
    finally:
        config.hp_impl = old


@contextmanager
def complex_mode(mode: str):
    """Context manager to temporarily force a complex representation."""
    if mode not in ("auto", "native", "split"):
        raise ValueError(f"Unknown complex mode {mode!r}")
    old = config.complex_mode
    config.complex_mode = mode
    try:
        yield
    finally:
        config.complex_mode = old
