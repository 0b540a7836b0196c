"""Spectral estimators: power/cross spectra, cross phase, scaling rules.

Re-implements the estimator layer of the reference
(``/root/reference/xrft/xrft.py:649-874``) on top of the jit-traceable
transform core.  The |F|^2 / F1*conj(F2) kernels, the one-sided real-dim
doubling, the window corrections, and the density/spectrum scalings all
fuse into the same XLA program as the transform itself.

Complex math is representation-generic (native complex by default, split
pairs under ``complex_mode("split")``) via :mod:`.ops.carray`.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray
from .transform import _dim_coord, fft, _real_flag_warning

__all__ = ["power_spectrum", "cross_spectrum", "cross_phase", "coherence",
           "spectrogram", "welch", "csd", "periodogram"]


def _window_correction_factor(da, dim, scaling, window):
    """density -> mean(window^2); spectrum -> mean(window)^2
    (reference ``/root/reference/xrft/xrft.py:649-660``)."""
    if window is None:
        raise ValueError(
            "window_correction can only be applied when windowing is "
            "turned on."
        )
    from .ops.window import apply_window

    windows, _ = apply_window(da, dim, window_type=window)
    if scaling == "density":
        return (windows**2).mean()
    elif scaling == "spectrum":
        return windows.mean() ** 2
    raise ValueError(f"Unknown {scaling} scaling flag")


def _psd_scaling_factor(ps, dims, scaling):
    """density -> prod(freq spacing); spectrum -> prod(freq spacing)^2
    (reference ``/root/reference/xrft/xrft.py:663-670``)."""
    fs = np.prod([float(ps.coords[d].attrs["spacing"]) for d in dims])
    if scaling == "density":
        return fs
    elif scaling == "spectrum":
        return fs**2
    raise ValueError(f"Unknown {scaling} scaling flag")


def _doubling_vector(n):
    """One-sided doubling over the ``n//2 + 1`` rfft bins: 2 everywhere
    except DC (and Nyquist when ``n`` even)
    (reference ``/root/reference/xrft/xrft.py:673-682``)."""
    f = np.full(n // 2 + 1, 2.0)
    f[0] = 1.0
    if n % 2 == 0:
        f[-1] = 1.0
    return f


def _psd_real_dim_scaling(da, ps, real_dim, updated_dims):
    """One-sided spectrum doubling on the real freq axis, as a broadcast
    LabeledArray (see :func:`_doubling_vector`).

    Deliberate divergence: with ``chunks_to_segments`` the parity is the
    SEGMENT length (``da`` reaches this helper already stacked), because
    the rfft runs per segment and the last one-sided bin is Nyquist iff
    the segment length is even.  The reference takes the parity from the
    full input length (``:678``), mis-scaling that bin whenever the two
    parities differ; pinned in
    ``tests/test_spectra.py::test_segmented_real_dim_nyquist_parity``."""
    real = next(d for d in updated_dims if d.endswith(real_dim))
    f = _doubling_vector(da.sizes[real_dim])
    return LabeledArray(f, dims=(real,), coords={real: ps.coords[real]})


def _maybe_stack_segments(das, dim, kwargs):
    """Stack ``chunks_to_segments`` ONCE up front (reference order:
    segments, then detrend/window, ``xrft.py:390-433``): downstream the
    segment dims are plain batch dims, so the one-sided fast path and the
    fused engine route serve Welch estimates too, and every size-derived
    factor (density Delta-f, real-dim doubling, window correction) is
    per-segment automatically.  Returns (stacked arrays, pinned dim list,
    kwargs without the flag)."""
    if not kwargs.get("chunks_to_segments"):
        if kwargs.get("segment_overlap") is not None:
            raise ValueError(
                "segment_overlap requires chunks_to_segments=True"
            )
        return das, dim, kwargs
    from .transform import _stack_segments

    dim = _norm_dim_list(das[0], dim)  # pin BEFORE the segment dims exist
    overlap = kwargs.get("segment_overlap")
    das = tuple(_stack_segments(da, dim, overlap=overlap) for da in das)
    kwargs = {k: v for k, v in kwargs.items()
              if k not in ("chunks_to_segments", "segment_overlap")}
    return das, dim, kwargs


def _pop_density(kwargs, fname, scaling):
    if "density" in kwargs:
        density = kwargs.pop("density")
        warnings.warn(
            f"density flag will be deprecated in future version of "
            f"xrft_tpu.{fname} and replaced by scaling flag. "
            'density=True should be replaced by scaling="density" and '
            "density=False will not be maintained.\nscaling flag is ignored !",
            FutureWarning,
        )
        scaling = "density" if density else "false_density"
    return kwargs, scaling


def _half_spectrum_dim(da, dim, real_dim, kwargs):
    """If the two-sided power spectrum of real data is requested, pick the
    transform dim to compute one-sided (Hermitian symmetry halves the work
    on every *other* transform axis); None disables the optimization.

    Enabled for the default engine, the named f32 engines, and sharded
    (pencil) engines whose half dim is unsharded — the Hermitian mirror is
    then a local permutation per shard."""
    if real_dim is not None:
        return None
    engine = kwargs.get("engine")
    if kwargs.get("chunks_to_segments"):
        # defensive: power_spectrum/cross_spectrum stack segments up
        # front and strip this flag before calling here, so segmented
        # requests normally arrive as plain batched arrays; any other
        # caller that forwards the flag falls back to the generic path
        return None
    data = da.data
    if carray.is_pair(data) or np.dtype(data.dtype).kind == "c":
        return None
    dims = _norm_dim_list(da, dim)
    if len(dims) < 2:
        return None  # no other axes to save on
    half = dims[-1]
    if callable(engine):
        # pencil engine: the half (rfft) axis must be unsharded and
        # trailing (the engine advertises its dim sharding)
        shards = getattr(engine, "dim_shards", None)
        if shards is None or shards.get(half):
            return None
        if da.dims and da.dims[-1] != half:
            return None
    elif engine is not None and engine not in ("xla", "matmul", "auto"):
        return None
    return half


def _norm_dim_list(da, dim):
    if dim is None:
        return list(da.dims)
    if isinstance(dim, str):
        return [dim]
    return list(dim)


def _hermitian_expand(half, daft, da, dims, half_dim, kwargs, shift,
                      conj_mirror=False):
    """Expand a one-sided array (PSD or cross spectrum) over the half axis
    to the full two-sided grid via Hermitian symmetry, with the shift
    conventions already applied on the non-half axes.

        X[k_o, k] == conj(X[-k_o mod n_o, n - k])

    (the conjugation is a no-op for real PSDs).  Index maps are host
    constants; locally the mirror is reverse/roll HLOs, on sharded runs
    explicit-out_sharding gathers.  Returns the full LabeledArray with
    rebuilt two-sided frequency coordinates.
    """
    n_full = da.sizes[half_dim]
    fd = {d: ce.freq_dim_name(d, kwargs.get("prefix", "freq_")) for d in dims}
    half_f = fd[half_dim]
    ax_half = daft.get_axis_num(half_f)
    m = daft.sizes[half_f]

    # host-side index maps: output position o on the full (possibly
    # shifted) half axis reads unshifted freq k = (o - h) mod n; k < m is
    # the one-sided column k, k >= m mirrors to column n - k with every
    # other transform axis index negated (mod its size, in its already
    # shifted order)
    n = n_full
    h = n // 2 if shift else 0
    ks = (np.arange(n) - h) % n
    mirror = ks >= m
    src = np.where(mirror, (n - ks) % n, ks)
    # non-half-axis mirror map (-f on the possibly shifted grid) is the
    # permutation o -> (2h - o) mod n == roll(reverse(.), 2h+1-n): pure
    # reverse/slice HLOs instead of a gather.  Sharded
    # (pencil-engine) runs use an explicit gather instead — roll's
    # odd-sized slices do not type-check on sharded axes, while GSPMD
    # handles constant-index gathers with the appropriate collective.
    engine = kwargs.get("engine")
    sharded = callable(engine)
    ps_sharding = None
    if sharded:
        # reconstruct the pencil forward chain's output layout so the
        # mirror gathers can declare their (unchanged) output sharding
        from jax.sharding import NamedSharding, PartitionSpec as _P

        from .parallel.pencil import plan_forward_layout

        mesh = engine.mesh
        dim_shards = engine.dim_shards
        nd = len(da.dims)
        axis_sharding = {i: dim_shards[d] for i, d in enumerate(da.dims)
                         if dim_shards.get(d)}
        from .parallel.mesh import axis_links

        chain_axes = [da.get_axis_num(d) for d in dims if d != half_dim]
        _, final = plan_forward_layout(
            da.shape, chain_axes, axis_sharding, dict(mesh.shape),
            banned=(nd - 1,), axis_links=axis_links(mesh))
        ps_sharding = NamedSharding(
            mesh, _P(*[final.get(i) for i in range(nd)]))
    rev_rolls, perms = {}, {}
    for d in dims:
        if d == half_dim:
            continue
        na = daft.sizes[fd[d]]
        ha = na // 2 if shift else 0
        rev_rolls[daft.get_axis_num(fd[d])] = (2 * ha + 1 - na) % na
        o = np.arange(na)
        perms[daft.get_axis_num(fd[d])] = (2 * ha - o) % na

    pieces = []
    start = 0
    for i in range(1, n + 1):
        if i == n or mirror[i] != mirror[start]:
            cols = src[start:i]
            ndim = half.ndim
            key = [slice(None)] * ndim
            if mirror[start]:
                # strictly descending consecutive columns: slice + reverse
                key[ax_half] = slice(int(cols[-1]), int(cols[0]) + 1)
                piece = carray.flip(carray.getitem(half, tuple(key)),
                                    [ax_half])
                for a, sroll in rev_rolls.items():
                    if sharded:
                        piece = carray.take_with_sharding(
                            piece, jnp.asarray(perms[a]), a, ps_sharding)
                    else:
                        # (an explicit concat([row0, flip(rest)]) form of
                        # this flip+roll canonicalizes to the identical
                        # HLO)
                        piece = carray.flip(piece, [a])
                        if sroll:
                            piece = carray.roll(piece, sroll, a)
                if conj_mirror:
                    piece = carray.conj(piece)
            else:
                key[ax_half] = slice(int(cols[0]), int(cols[-1]) + 1)
                piece = carray.getitem(half, tuple(key))
            pieces.append(piece)
            start = i
    full = pieces[0] if len(pieces) == 1 \
        else carray.concatenate(pieces, axis=ax_half)

    return LabeledArray(full, dims=daft.dims,
                        coords=_two_sided_coords(daft, da, dims, half_dim,
                                                 kwargs, shift, n_full),
                        name=da.name)


def _two_sided_coords(daft, da, dims, half_dim, kwargs, shift, n_full):
    """Coordinates for the full two-sided grid reconstructed from a
    one-sided `daft`."""
    fd = {d: ce.freq_dim_name(d, kwargs.get("prefix", "freq_")) for d in dims}
    delta = [
        ce.get_coordinate_spacing(_dim_coord(da, d),
                                  kwargs.get("spacing_tol", 1e-3))
        for d in dims
    ]
    sizes = [n_full if d == half_dim else da.sizes[d] for d in dims]
    grids = ce.freq_grids(sizes, delta, False, shift)
    out_coords = {c: v.copy() for c, v in daft.coords.items()
                  if c not in fd.values()}
    for d, g in zip(dims, grids):
        out_coords[fd[d]] = Coord((fd[d],), g, {"spacing": g[1] - g[0]},
                                  fd[d])
    return out_coords


def _power_spectrum_via_rfft(da, dim, half_dim, kwargs, prescale=None):
    """|F|^2 on the full grid, computed from the one-sided transform of
    real input and mirrored via Hermitian symmetry:

        |F[k_o, k]|^2 == |F[-k_o mod n_o, n - k]|^2

    Saves ~half the transform work on every non-half axis plus half the
    |.|^2 pass.  The requested fftshift on the non-half axes rides the
    engine's absorbed output permutation (free); the half-axis expansion +
    its shift is one static-gather concat, with all mirror/shift index
    maps computed on host.  ``prescale`` (density/window-correction
    scalars) folds into the |.|^2 pass instead of a full multiply pass.
    """
    dims = _norm_dim_list(da, dim)
    shift = kwargs.pop("shift", True)
    n_full = da.sizes[half_dim]
    # true_amplitude's prod(dx) multiply also folds into the |.|^2 pass
    # (|amp*F|^2 = amp^2 |F|^2) instead of costing a full memory pass
    kwargs["true_amplitude"] = False
    amp2 = float(np.prod([
        ce.get_coordinate_spacing(_dim_coord(da, d),
                                  kwargs.get("spacing_tol", 1e-3))
        for d in dims])) ** 2

    # packed route: half-size complex FFT + elementwise combine emits the
    # two-sided grid directly — no mirror pass (see ops/psd_packed.py)
    from .ops import psd_packed

    if psd_packed.packed_psd_applicable(da, dims, half_dim, shift, kwargs):
        scale = amp2 if prescale is None else amp2 * prescale
        return psd_packed.packed_two_sided_psd(da, dims, half_dim, shift,
                                               scale, kwargs)

    # fully fused route (stacked engine): window folded into the transform
    # stage, |.|^2 computed on the raw engine layout so only the real
    # half-size PSD pays the restore pass (see ops/psd_fused.py)
    from .ops import psd_fused

    if psd_fused.fused_psd_applicable(da, dims, half_dim, shift, kwargs):
        scale = amp2 if prescale is None else amp2 * prescale
        daft = psd_fused.fused_one_sided_psd(da, dims, half_dim, shift,
                                             scale, kwargs)
        return _hermitian_expand(daft.data, daft, da, dims, half_dim,
                                 kwargs, shift, conj_mirror=False)

    daft = fft(da, dim=dims, real_dim=half_dim, shift=shift,
               _shift_nonreal=True, **kwargs)
    ps_half = carray.abs2(daft.data)
    ps_half = ps_half * (amp2 if prescale is None else amp2 * prescale)

    return _hermitian_expand(ps_half, daft, da, dims, half_dim, kwargs,
                             shift, conj_mirror=False)


def _density_prescale(da, dim, scaling, window_correction, kwargs):
    """Scalar folded into the fused routes' |.|^2 / product pass: the
    window-correction divisor and the density (prod df) / spectrum
    (prod df squared) factor; None for ``false_density`` (raw mode).
    Reference tail: ``/root/reference/xrft/xrft.py:649-670,745-748``."""
    if scaling == "false_density":
        return None
    pre = 1.0
    if window_correction:
        pre = 1.0 / _window_correction_factor(
            da, dim, scaling, kwargs.get("window")).data
    fs = 1.0
    for d in _norm_dim_list(da, dim):
        delta = ce.get_coordinate_spacing(
            _dim_coord(da, d), kwargs.get("spacing_tol", 1e-3))
        fs *= 1.0 / (da.sizes[d] * delta)
    return pre * (fs if scaling == "density" else fs**2)


def _try_fused_one_sided(das, dim, real_dim, scaling, window_correction,
                         true_phase, kwargs):
    """Route a USER-requested one-sided estimate (``real_dim=``) through
    the fused raw-layout engine: |F|^2 (one input) or F1*conj(F2) (two
    inputs) with the real-dim doubling and every density/window scalar
    folded into the engine's elementwise pass.  Returns the finished
    LabeledArray, or None when the request must take the generic path
    (complex/non-float data, unknown scaling value, real_dim not a
    transform dim, engine/kwargs outside the fused route's support).

    Matches the generic tail exactly (all factors commute):
    ``|fft(da, true_amplitude=True)|^2 * doubling [/ wcf] * fs^(1|2)``
    (reference ``/root/reference/xrft/xrft.py:685-835``; shift forced
    False for real transforms at ``:400-404``)."""
    from .ops import psd_fused

    da1 = das[0]
    for da in das:
        if carray.is_pair(da.data) or np.dtype(da.data.dtype).kind != "f":
            return None
    dims = _norm_dim_list(da1, dim)
    if real_dim not in dims:
        return None
    if scaling not in ("density", "spectrum", "false_density"):
        return None
    fdims = [d for d in dims if d != real_dim] + [real_dim]
    kw = {k: v for k, v in kwargs.items()
          if k not in ("shift", "true_amplitude")}
    kw["true_amplitude"] = False
    if len(das) == 1:
        if not psd_fused.fused_psd_applicable(da1, fdims, real_dim, False,
                                              kw):
            return None
    elif not psd_fused.fused_cross_applicable(das[0], das[1], fdims,
                                              real_dim, False, kw,
                                              true_phase):
        return None

    amp2 = 1.0
    for d in dims:
        amp2 *= ce.get_coordinate_spacing(
            _dim_coord(da1, d), kwargs.get("spacing_tol", 1e-3))
    amp2 = amp2 ** 2
    prescale = _density_prescale(da1, dim, scaling, window_correction,
                                 kwargs)
    scale = amp2 if prescale is None else amp2 * prescale
    doubling = _doubling_vector(da1.sizes[real_dim])

    if len(das) == 1:
        return psd_fused.fused_one_sided_psd(
            da1, fdims, real_dim, False, scale, kw, half_factor=doubling)
    out = psd_fused.fused_one_sided_cross(
        das[0], das[1], fdims, real_dim, False, scale, kw,
        half_factor=doubling)
    out.name = None
    return out


def _cross_spectrum_via_rfft(da1, da2, dim, half_dim, kwargs, prescale,
                             true_phase):
    """One-sided fast path for the cross spectrum of two REAL inputs:
    C(-k) = conj(C(k)) holds for F1*conj(F2) even with true_phase factors
    (conj(e^{-i\theta}) = e^{+i\theta}), so both transforms run as rffts
    and the full grid is the conjugated Hermitian expansion — ~half the
    transform work on every non-half axis."""
    dims = _norm_dim_list(da1, dim)
    shift = kwargs.pop("shift", True)
    kwargs["true_amplitude"] = False
    amp2 = float(np.prod([
        ce.get_coordinate_spacing(_dim_coord(da1, d),
                                  kwargs.get("spacing_tol", 1e-3))
        for d in dims])) ** 2

    # fully fused route: both stacked rffts share one raw layout, the
    # conjugated product runs there, and only the half-size complex
    # result pays restore passes (see ops/psd_fused.py)
    from .ops import psd_fused

    if psd_fused.fused_cross_applicable(da1, da2, dims, half_dim, shift,
                                        kwargs, true_phase):
        scale = amp2 if prescale is None else amp2 * prescale
        daft = psd_fused.fused_one_sided_cross(da1, da2, dims, half_dim,
                                               shift, scale, kwargs)
        out = _hermitian_expand(daft.data, daft, da1, dims, half_dim,
                                kwargs, shift, conj_mirror=True)
        out.name = None
        return out

    daft1 = fft(da1, dim=dims, real_dim=half_dim, shift=shift,
                _shift_nonreal=True, true_phase=true_phase, **kwargs)
    daft2 = fft(da2, dim=dims, real_dim=half_dim, shift=shift,
                _shift_nonreal=True, true_phase=true_phase, **kwargs)
    cs_half = carray.multiply(daft1.data, carray.conj(daft2.data))
    cs_half = cs_half * (amp2 if prescale is None else amp2 * prescale)
    out = _hermitian_expand(cs_half, daft1, da1, dims, half_dim, kwargs,
                            shift, conj_mirror=True)
    out.name = None
    return out


def power_spectrum(
    da: LabeledArray,
    dim=None,
    real_dim=None,
    scaling="density",
    window_correction=False,
    **kwargs,
) -> LabeledArray:
    """Power spectrum of `da`: |F(da)|^2 with amplitude-true scaling.

    scaling: 'density' normalizes to power spectral density, 'spectrum' to
    power spectrum (peak amplitudes).  window_correction=True divides by the
    window's energy (density) or squared mean (spectrum), matching
    scipy.signal.welch/periodogram conventions.  Reference:
    ``/root/reference/xrft/xrft.py:685-750``.
    """
    kwargs, scaling = _pop_density(kwargs, "power_spectrum", scaling)

    if "real" in kwargs:
        real_dim = kwargs.get("real")
        warnings.warn(_real_flag_warning, FutureWarning)

    if kwargs.get("engine") == "hp":
        from .highprec import power_spectrum_hp

        kwargs.pop("engine")
        kwargs.pop("real", None)
        return power_spectrum_hp(da, dim=dim, real_dim=real_dim,
                                 scaling=scaling,
                                 window_correction=window_correction,
                                 **kwargs)

    # true_phase does not matter for |F|^2; forced off to skip phase work
    kwargs.update({"true_amplitude": True, "true_phase": False})

    (da,), dim, kwargs = _maybe_stack_segments((da,), dim, kwargs)

    half = _half_spectrum_dim(da, dim, real_dim, kwargs)
    if half is not None:
        # fold the scalar density/window factors into the |.|^2 pass
        prescale = _density_prescale(da, dim, scaling, window_correction,
                                     kwargs)
        return _power_spectrum_via_rfft(da, dim, half, kwargs, prescale)
    else:
        # USER-requested one-sided spectrum (real_dim=...): the fused
        # raw-layout route computes exactly this before any mirror, with
        # the real-dim doubling folded into the |.|^2 pass (matmul engine
        # only; the default engine takes the generic fft()+abs2 path)
        if real_dim is not None:
            out = _try_fused_one_sided((da,), dim, real_dim, scaling,
                                       window_correction, False, kwargs)
            if out is not None:
                return out
        daft = fft(da, dim=dim, real_dim=real_dim, **kwargs)
        updated_dims = [
            d for d in daft.dims if (d not in da.dims and "segment" not in d)
        ]
        ps = daft.copy(data=carray.abs2(daft.data))
        ps.attrs = {}

    if real_dim is not None:
        ps = ps * _psd_real_dim_scaling(da, ps, real_dim, updated_dims)

    if scaling != "false_density":
        if window_correction:
            ps = ps / _window_correction_factor(
                da, dim, scaling, kwargs.get("window")
            )
        ps = ps * _psd_scaling_factor(ps, updated_dims, scaling)

    return ps


def cross_spectrum(
    da1: LabeledArray,
    da2: LabeledArray,
    dim=None,
    real_dim=None,
    scaling="density",
    window_correction=False,
    true_phase=True,
    **kwargs,
) -> LabeledArray:
    """Cross spectrum F(da1) * conj(F(da2)) with the same scaling machinery
    as :func:`power_spectrum`; true_phase defaults True here (reference
    ``/root/reference/xrft/xrft.py:753-835``)."""
    if "real" in kwargs:
        real_dim = kwargs.get("real")
        warnings.warn(_real_flag_warning, FutureWarning)

    kwargs, scaling = _pop_density(kwargs, "cross_spectrum", scaling)
    kwargs.update({"true_amplitude": True})

    if kwargs.get("engine") == "hp":
        from .highprec import cross_spectrum_hp

        kwargs.pop("engine")
        kwargs.pop("real", None)
        return cross_spectrum_hp(da1, da2, dim=dim, real_dim=real_dim,
                                 scaling=scaling,
                                 window_correction=window_correction,
                                 true_phase=true_phase, **kwargs)

    if tuple(da1.dims) != tuple(da2.dims):
        raise ValueError("The two datasets have different dimensions")

    (da1, da2), dim, kwargs = _maybe_stack_segments((da1, da2), dim, kwargs)

    # Hermitian one-sided fast path for two real inputs (the symmetry
    # survives the phase factors: conj(e^{-i t}) = e^{+i t})
    half = _half_spectrum_dim(da1, dim, real_dim, kwargs)
    if half is not None and _half_spectrum_dim(
            da2, dim, real_dim, kwargs) == half:
        prescale = _density_prescale(da1, dim, scaling, window_correction,
                                     kwargs)
        kwargs.pop("true_amplitude", None)
        return _cross_spectrum_via_rfft(da1, da2, dim, half, kwargs,
                                        prescale, true_phase)

    # USER-requested one-sided cross spectrum (real_dim=...): fused
    # raw-layout route with the real-dim doubling folded into the
    # conjugated-product pass (mirrors the power_spectrum fast path)
    if real_dim is not None:
        out = _try_fused_one_sided((da1, da2), dim, real_dim, scaling,
                                   window_correction, true_phase, kwargs)
        if out is not None:
            return out

    daft1 = fft(da1, dim=dim, real_dim=real_dim, true_phase=true_phase, **kwargs)
    daft2 = fft(da2, dim=dim, real_dim=real_dim, true_phase=true_phase, **kwargs)

    if daft1.dims != daft2.dims:
        raise ValueError("The two datasets have different dimensions")

    updated_dims = [
        d for d in daft1.dims if (d not in da1.dims and "segment" not in d)
    ]
    cs = daft1 * daft2.conj()

    if real_dim is not None:
        cs = cs * _psd_real_dim_scaling(da1, cs, real_dim, updated_dims)

    if scaling != "false_density":
        if window_correction:
            cs = cs / _window_correction_factor(
                da1, dim, scaling, kwargs.get("window")
            )
        cs = cs * _psd_scaling_factor(cs, updated_dims, scaling)

    return cs


def cross_phase(da1, da2, dim=None, true_phase=True, **kwargs) -> LabeledArray:
    """Phase of the cross spectrum, in [-pi, pi]
    (reference ``/root/reference/xrft/xrft.py:838-874``)."""
    cs = cross_spectrum(da1, da2, dim=dim, true_phase=true_phase, **kwargs)
    cp = cs.copy(data=carray.angle(cs.data))
    if da1.name and da2.name:
        cp.name = f"{da1.name}_{da2.name}_phase"
    return cp


def coherence(da1, da2, dim=None, real_dim=None, window="hann",
              true_phase=False, **kwargs) -> LabeledArray:
    """Magnitude-squared coherence ``|<Pxy>|^2 / (<Pxx><Pyy>)`` — the
    Welch-averaged scipy.signal.coherence estimate (beyond the reference,
    which stops at :func:`cross_phase`).

    The cross/auto spectral densities are estimated with identical
    window/segment settings and averaged over every ``<dim>_segment``
    axis before the ratio, so density scalings and window corrections
    cancel and the result is a dimensionless field in [0, 1].  With no
    segment averaging the estimate is identically 1 (a warning is
    emitted) — pass ``chunks_to_segments=True`` (and optionally
    ``segment_overlap=...``), the analogue of scipy's nperseg/noverlap.
    ``true_phase`` defaults False: equal-coordinate phase factors cancel
    inside ``|<Pxy>|^2`` anyway, so the phase work is skipped.
    """
    est = dict(dim=dim, real_dim=real_dim, window=window, **kwargs)
    pxx = power_spectrum(da1, **est)
    pyy = power_spectrum(da2, **est)
    pxy = cross_spectrum(da1, da2, true_phase=true_phase, **est)
    return _coherence_from_estimates(pxx, pyy, pxy, da1.name, da2.name)


def spectrogram(da, dim=None, seglen=None, segment_overlap=None,
                window="hann", detrend="constant", scaling="density",
                window_correction=True, real_dim="auto",
                **kwargs) -> LabeledArray:
    """Short-time power spectral density over sliding segments — the
    scipy.signal.spectrogram estimate (beyond the reference, whose
    segment machinery stops at per-chunk Welch estimates with an integer
    segment index).

    Computes a per-segment one-sided PSD along ``dim`` (two-sided when
    the data is complex) and attaches a *physical* segment-center
    coordinate on the ``<dim>_segment`` axis — segment ``k`` is centered
    at ``x0 + (k*hop + seglen/2) * dx`` in the units of ``dim``, with
    ``x0``/``dx`` the *signed* first value/spacing of the stored
    coordinate (scipy's ``t`` vector when the coordinate starts at 0 and
    increases; for a decreasing coordinate the centers walk downward and
    the recorded ``spacing`` attr is negative).  Trailing samples that do
    not fill a final segment are dropped with a warning, as scipy does.
    Rides the fused one-sided raw-layout engine route, so the full
    spectrogram is one XLA program.

    Parameters mirror scipy.signal.spectrogram: ``seglen`` = nperseg
    (defaults to a chunk length already declared via
    ``da.chunk({dim: n})``), ``segment_overlap`` = noverlap (int
    samples or float fraction of ``seglen``; default None = scipy's
    ``nperseg // 8``), ``detrend='constant'`` default.
    ``window_correction=True`` by default (scipy always corrects; the
    reference's estimators default off).  ``real_dim``: 'auto'
    (one-sided iff the input is real — float *or* integer dtype, like
    scipy), a dim name, or None to force a two-sided estimate.
    """
    da, dim, seglen, ov = _stft_plan(da, dim, seglen, segment_overlap, 8,
                                     "spectrogram")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None
    hop = seglen - ov

    coord = _dim_coord(da, dim)
    ce.get_coordinate_spacing(coord, kwargs.get("spacing_tol", 1e-3))
    # Signed spacing of the STORED coordinate: segments slice storage
    # order, so a decreasing coordinate walks the centers downward.
    # (dx is in SECONDS for time-like coords — see _segment_centers.)
    dx = float(ce.diff_coord(coord)[0])

    ps = power_spectrum(
        da, dim=[dim], real_dim=real_dim, scaling=scaling,
        window_correction=window_correction, window=window,
        detrend=detrend, chunks_to_segments=True,
        segment_overlap={dim: ov} if ov else None, **kwargs)

    segdim = dim + "_segment"
    nseg = ps.sizes[segdim]
    centers = _segment_centers(coord, nseg, hop, seglen, dx)
    out = ps.assign_coords(
        {segdim: Coord(segdim, centers, attrs={"spacing": hop * dx},
                       name=segdim)})
    out.name = f"{da.name}_spectrogram" if da.name else None
    return out


def _segment_centers(coord, nseg, hop, seglen, dx):
    """Segment-center coordinate values in the coordinate's OWN type:
    numeric coords get floats (scipy's t vector), datetime64 coords get
    datetime64 centers, cftime coords get cftime objects — dx from
    diff_coord is in seconds for the time-like cases, so mixing it with
    raw datetime64 integer ticks would produce garbage centers."""
    vals = np.asarray(coord.values)
    offsets = (np.arange(nseg) * hop + seglen / 2.0) * dx  # coord units/s
    if np.issubdtype(vals.dtype, np.datetime64):
        t0 = vals.ravel()[0].astype("datetime64[ns]")
        return t0 + np.round(offsets * 1e9).astype("timedelta64[ns]")
    if ce._is_cftime(vals):
        import datetime

        t0 = vals.flat[0]
        return np.array(
            [t0 + datetime.timedelta(seconds=float(o)) for o in offsets],
            dtype=object)
    return float(vals.ravel()[0]) + offsets


def _is_real_input(da) -> bool:
    """scipy's real-input test: any non-complex dtype (float OR integer)
    counts as real and yields a one-sided estimate."""
    return (not carray.is_pair(da.data)
            and np.dtype(da.data.dtype).kind in "fiu")


def _norm_1d_dim(da, dim, caller) -> str:
    """Resolve the single sliding-segment dim (None -> last dim)."""
    if dim is None:
        return da.dims[-1]
    if isinstance(dim, str):
        return dim
    dim = list(dim)
    if len(dim) != 1:
        raise ValueError(
            f"{caller} is a 1-D sliding-segment estimate; got "
            f"dim={dim!r} (transform other dims with power_spectrum)"
        )
    return dim[0]


def _stft_plan(da, dim, seglen, segment_overlap, default_div, caller):
    """Shared sliding-segment prologue for the scipy-namesake estimators
    (spectrogram / welch / csd): dim normalization, segment-length
    resolution (seglen= or a declared chunk, clamped to the input length
    with a warning like scipy), overlap resolution (``None`` ->
    ``seglen // default_div``, scipy's per-function default), and the
    scipy tail-drop for non-dividing lengths at zero overlap.  Returns
    (da, dim, seglen, overlap_samples)."""
    dim = _norm_1d_dim(da, dim, caller)

    if seglen is not None:
        da = da.chunk({dim: int(seglen)})
    chunks = da.chunks or {}
    if dim not in chunks:
        raise ValueError(
            f"{caller} needs a segment length: pass seglen= or declare "
            "one with da.chunk({dim: seglen}) first"
        )
    seglen = int(chunks[dim])
    if seglen > da.sizes[dim]:
        # scipy clamps nperseg to the input length with a warning rather
        # than erroring (scipy.signal._spectral_py._triage_segments)
        warnings.warn(
            f"seglen = {seglen} is greater than input length = "
            f"{da.sizes[dim]}, using seglen = {da.sizes[dim]}"
        )
        seglen = da.sizes[dim]
        da = da.chunk({dim: seglen})

    ov = segment_overlap
    if ov is None:
        ov = seglen // default_div  # scipy's default noverlap
    if isinstance(ov, float):
        if not 0.0 <= ov < 1.0:
            raise ValueError(
                f"fractional segment_overlap must be in [0, 1), got {ov}"
            )
        ov = int(round(ov * seglen))

    n = da.sizes[dim]
    if ov == 0 and n % seglen:
        # scipy drops the trailing partial segment; the Welch reshape
        # path would instead raise the reference's strict-divisibility
        # error ("Chunk lengths need to be the same.").
        keep = (n // seglen) * seglen
        warnings.warn(
            f"{caller} drops the last {n - keep} samples of dim "
            f"{dim!r} (scipy convention)"
        )
        da = da.isel({dim: slice(0, keep)}).chunk({dim: seglen})
    return da, dim, seglen, ov


def _segment_mean(la: LabeledArray, segdim: str) -> LabeledArray:
    """Mean over a segment dim; compensated (dsum + exact 1/n split) for
    engine='hp' quad data so the averaging does not degrade the df64
    planes to per-plane f32 sums."""
    from .ops.carray import CDF64, DF64

    if not isinstance(la.data, (DF64, CDF64)):
        return la.mean(segdim)
    from .ops import df64 as _d
    from .ops.hp import _split_const, dsum

    ax = la.dims.index(segdim)
    ih, il = (jnp.float32(v) for v in _split_const(1.0 / la.sizes[segdim]))

    def m2(h, l):
        h2, l2 = dsum(h, l, (ax,), keepdims=False)
        return _d.mul(h2, l2, ih, il)

    if isinstance(la.data, DF64):
        data = DF64(*m2(la.data.hi, la.data.lo))
    else:
        rh, rl = m2(la.data.rh, la.data.rl)
        ih2, il2 = m2(la.data.ih, la.data.il)
        data = CDF64(rh, rl, ih2, il2)
    return LabeledArray(
        data, dims=[d for d in la.dims if d != segdim],
        coords={k: c.copy() for k, c in la.coords.items()
                if segdim not in c.dims},
        attrs=dict(la.attrs), name=la.name)


def _welch_impl(power_fn, da, dim, seglen, segment_overlap, window,
                detrend, scaling, window_correction, real_dim,
                kwargs) -> LabeledArray:
    """Shared welch driver: ``power_fn`` is :func:`power_spectrum` for
    the local namesake or a mesh-bound partial for
    :func:`..parallel.sharded_welch`."""
    da, dim, seglen, ov = _stft_plan(da, dim, seglen, segment_overlap, 2,
                                     "welch")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None
    ps = power_fn(
        da, dim=[dim], real_dim=real_dim, scaling=scaling,
        window_correction=window_correction, window=window,
        detrend=detrend, chunks_to_segments=True,
        segment_overlap={dim: ov} if ov else None, **kwargs)
    out = _segment_mean(ps, dim + "_segment")
    out.name = f"{da.name}_welch" if da.name else None
    return out


def _zero_pad_to(da, dim, target) -> LabeledArray:
    """Zero-pad ``da`` along ``dim`` to ``target`` samples with the
    coordinate extrapolated (scipy.signal.csd pads the shorter input)."""
    from .padding import pad as _pad

    out = _pad(da, {dim: (0, target - da.sizes[dim])}, mode="constant")
    # the pad is part of the estimate, not an unpad-able transform step
    out.coords[dim].attrs.pop("pad_width", None)
    return out


def _csd_impl(cross_fn, da1, da2, dim, seglen, segment_overlap, window,
              detrend, scaling, window_correction, real_dim, true_phase,
              kwargs) -> LabeledArray:
    """Shared csd driver (see :func:`_welch_impl`)."""
    if tuple(da1.dims) != tuple(da2.dims):
        raise ValueError("da1 and da2 must have the same dimensions!")
    dim = _norm_1d_dim(da1, dim, "csd")
    n1, n2 = da1.sizes[dim], da2.sizes[dim]
    if n1 != n2:
        # scipy zero-pads the shorter input to the longer one
        if n1 < n2:
            da1 = _zero_pad_to(da1, dim, n2)
        else:
            da2 = _zero_pad_to(da2, dim, n1)
    da1, dim, seglen, ov = _stft_plan(da1, dim, seglen, segment_overlap, 2,
                                      "csd")
    if da2.sizes[dim] != da1.sizes[dim]:  # zero-overlap tail drop on da1
        da2 = da2.isel({dim: slice(0, da1.sizes[dim])})
    da2 = da2.chunk({dim: seglen})
    if real_dim == "auto":
        real_dim = dim if (_is_real_input(da1)
                           and _is_real_input(da2)) else None
    cs = cross_fn(
        da1, da2, dim=[dim], real_dim=real_dim, scaling=scaling,
        window_correction=window_correction, window=window,
        detrend=detrend, chunks_to_segments=True, true_phase=true_phase,
        segment_overlap={dim: ov} if ov else None, **kwargs)
    out = _segment_mean(cs, dim + "_segment")
    out = out.copy(data=carray.conj(out.data))
    out.name = (f"{da1.name}_{da2.name}_csd"
                if da1.name and da2.name else None)
    return out


def welch(da, dim=None, seglen=None, segment_overlap=None, window="hann",
          detrend="constant", scaling="density", window_correction=True,
          real_dim="auto", **kwargs) -> LabeledArray:
    """Welch PSD estimate — the scipy.signal.welch convenience over the
    reference-parity machinery (== ``power_spectrum(...,
    chunks_to_segments=True, ...).mean(<dim>_segment)``; beyond the
    reference, whose users hand-assemble this from ``chunks_to_segments``
    and a dask mean, `/root/reference/doc/chunk_example.ipynb`).

    scipy defaults throughout: ``segment_overlap=None`` means
    ``seglen // 2``, window='hann', detrend='constant',
    window_correction on, one-sided for real (float or integer) input;
    trailing samples that don't fill a segment are dropped, and a
    too-large ``seglen`` clamps to the input length, each with a warning
    (scipy conventions).  ``segment_overlap`` accepts samples or a
    fraction.  Composes with ``engine='hp'`` (compensated segment
    averaging) and extra batch dims.
    """
    return _welch_impl(power_spectrum, da, dim, seglen, segment_overlap,
                       window, detrend, scaling, window_correction,
                       real_dim, kwargs)


def csd(da1, da2, dim=None, seglen=None, segment_overlap=None,
        window="hann", detrend="constant", scaling="density",
        window_correction=True, real_dim="auto", true_phase=False,
        **kwargs) -> LabeledArray:
    """Cross power spectral density — the scipy.signal.csd convenience
    (Welch-averaged ``cross_spectrum``; beyond the reference).  Defaults
    mirror scipy: 50% overlap, hann, constant detrend, window
    correction, one-sided iff BOTH inputs are real, and a shorter input
    is zero-padded to the longer one.  ``true_phase`` defaults False
    (both inputs share coordinates, so the lag phase factors cancel
    exactly inside the conjugated product).

    Conjugate convention: scipy's ``Pxy = conj(F(x)) * F(y)`` while the
    reference's :func:`cross_spectrum` returns ``F(da1) * conj(F(da2))``
    (`/root/reference/xrft/xrft.py:825`); this scipy namesake follows
    scipy, i.e. ``csd(x, y) == conj(cross_spectrum-average)``."""
    return _csd_impl(cross_spectrum, da1, da2, dim, seglen,
                     segment_overlap, window, detrend, scaling,
                     window_correction, real_dim, true_phase, kwargs)


def periodogram(da, dim=None, window=None, detrend="constant",
                scaling="density", window_correction=True,
                real_dim="auto", **kwargs) -> LabeledArray:
    """Single-segment PSD estimate — the scipy.signal.periodogram
    convenience over :func:`power_spectrum` (beyond the reference, which
    exposes only the raw estimator; its scipy.periodogram parity is
    pinned at `/root/reference/xrft/tests/test_xrft.py:400-404`).

    scipy defaults: no window (boxcar), ``detrend='constant'``
    (``False``/``None`` disables), density scaling, one-sided for real —
    float or integer — input (``real_dim='auto'``; pass a dim name or
    ``None`` to force).  ``window_correction`` applies only when a window
    is requested (the boxcar correction is exactly 1).  Unlike scipy
    there is no ``nfft``: zero-pad explicitly with :func:`xrft_tpu.pad`.
    """
    dim = _norm_1d_dim(da, dim, "periodogram")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None
    if detrend is False:
        detrend = None
    ps = power_spectrum(
        da, dim=[dim], real_dim=real_dim, scaling=scaling,
        window=window, detrend=detrend,
        window_correction=window_correction and window is not None,
        **kwargs)
    ps.name = f"{da.name}_periodogram" if da.name else None
    return ps


def _coherence_from_estimates(pxx, pyy, pxy, name1=None,
                              name2=None) -> LabeledArray:
    """Segment-average the three Welch estimates, then the magnitude-
    squared ratio (shared with :func:`parallel.sharded_coherence`).

    engine='hp' estimates (df64 quads) are degraded to their f32 hi
    planes first: coherence is a normalized [0, 1] statistic whose
    scalings cancel in the ratio, so double-word precision adds nothing
    and DF64 carries no arithmetic operators."""
    from .transform import _degrade_quad

    pxx, pyy, pxy = (_degrade_quad(p) for p in (pxx, pyy, pxy))
    segdims = [d for d in pxy.dims if d.endswith("_segment")]
    if not segdims:
        warnings.warn(
            "coherence without segment averaging is identically 1; pass "
            "chunks_to_segments=True (and optionally segment_overlap=...) "
            "to average over Welch segments"
        )
    for d in segdims:
        pxy, pxx, pyy = pxy.mean(d), pxx.mean(d), pyy.mean(d)
    num = carray.abs2(pxy.data)
    coh = pxx.copy(data=num / (pxx.data * pyy.data))
    coh.name = f"{name1}_{name2}_coherence" if name1 and name2 else None
    return coh
