"""Pencil-decomposed distributed N-D FFT over a device mesh.

This is the capability the reference fundamentally lacks: dask-xrft errors
out when a transform dim is chunked
(``/root/reference/xrft/tests/test_xrft.py:166-170``).  Here, transform
axes sharded across mesh axes are handled with the classical pencil
decomposition (cf. AccFFT, PAPERS.md): per-axis FFTs are always *local*
(the axis is made fully resident first), and residency moves between axes
via ``all_to_all`` collective transposes (NCCL over NVLink between the
cards of one GPU host).

The **forward pencil chain**: instead of a transpose-and-back buddy
scheme (2 collectives per sharded axis, layout in == layout out), each sharded transform axis hands
its mesh sharding *forward* to a destination axis with ONE ``all_to_all``
and leaves it there:

    for each transform axis a (in order):
        a unsharded -> local FFT
        a sharded on mesh axis m -> all_to_all moves m's sharding from a
            to a divisible, currently-unsharded destination axis (prefer
            already-transformed or batch axes); local FFT along a

This halves collective volume for forward transforms (pinned by a jaxpr
collective-count test).  The output's sharding therefore differs from the
input's; the layout evolution is a *deterministic* host-side function of
(shape, axes, sharding), so the inverse kinds ('ifft'/'irfft') reconstruct
the forward chain's final layout and walk it backwards — a sharded
roundtrip is collective-minimal and ends in the original layout.  If no
divisible destination exists for an axis, that axis alone falls back to
the transpose-and-back scheme (zero-padding a destination is only
possible when the sharding comes back).

Optional compute/communication overlap: ``config.pencil_overlap_chunks``
splits each (all_to_all -> local FFT) pair along a resident batch axis
into independent per-chunk pairs, giving XLA's latency-hiding scheduler
freedom to overlap chunk i's collective with chunk i-1's FFT (AccFFT's
pipelining, expressed in dataflow rather than streams).

In split mode (``config.complex_mode``) data moves as (re, im) component
pairs; by default it moves as native complex arrays.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import config
from ..ops import carray, fft_core

__all__ = ["pencil_fftn", "plan_forward_layout"]


def _all_to_all(x, mesh_axis, split_axis, concat_axis):
    return carray._map(x, lambda v: jax.lax.all_to_all(
        v, mesh_axis, split_axis=split_axis, concat_axis=concat_axis,
        tiled=True,
    ))


def _concat(parts, axis):
    return carray.concatenate(parts, axis=axis)


def _split_chunks(x, axis, k):
    n = x.shape[axis]
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    out, start = [], 0
    for s in sizes:
        key = tuple(slice(start, start + s) if i == axis else slice(None)
                    for i in range(x.ndim))
        out.append(carray.getitem(x, key))
        start += s
    return out


def _pick_dest(ndim, axis, sharding, global_shape, P_size, transform_axes,
               done_axes, banned=(), reserve_sizes=()):
    """Forward-chain destination for the sharding leaving ``axis``: a
    currently-unsharded axis whose *global* extent divides P_size (its
    local extent is then divisible too, shard_map sees local shapes).
    Preference order: (0) settled axes (batch or already-transformed)
    that no pending DCN move will need, (1) settled axes a pending
    DCN-sharded axis could park on (``reserve_sizes`` = those moves'
    mesh-axis sizes — occupying the only such destination would force the
    DCN move into a 2-collective fallback over the slow inter-host
    links), (2) yet-untransformed transform axes (the sharding must then
    move again).  Returns the destination axis or None (-> round-trip
    fallback)."""
    cands = []
    for b in range(ndim):
        if b == axis or b in banned or sharding.get(b):
            continue
        if global_shape[b] % P_size != 0:
            continue
        if b in transform_axes and b not in done_axes:
            rank = 2
        elif any(global_shape[b] % s == 0 for s in reserve_sizes):
            rank = 1
        else:
            rank = 0
        cands.append((rank, b))
    if not cands:
        return None
    return min(cands)[1]


def plan_forward_layout(global_shape, axes, axis_sharding, mesh_shape,
                        banned=(), axis_links=None):
    """The deterministic layout evolution of the forward chain: returns
    (steps, final_sharding) where each step describes one transform axis
    as ('local', a) | ('move', a, dest, mesh_axis) |
    ('roundtrip', a, mesh_axis).  ``banned`` axes never receive a sharding
    (the real rfft/irfft axis must stay local).

    ``axis_links`` ({mesh_axis: 'ici'|'dcn'}, see ``mesh.axis_links``)
    makes the plan topology-aware: per-axis FFTs commute, so the chain is
    ordered **DCN-last** — every ICI-sharded (and unsharded) axis is
    transformed first, so by the time a DCN-sharded axis must hand its
    sharding forward, the already-transformed axes are settled
    destinations and its (unavoidable) inter-host all_to_all happens
    exactly once; a DCN move also never parks on a yet-untransformed
    transform axis while a settled one exists (see :func:`_pick_dest`).
    The step order IS the compute order in :func:`pencil_fftn`, and every
    caller (including the mirror-sharding reconstruction in
    ``spectra._hermitian_expand``) derives it from this one function."""
    links = axis_links or {}
    ndim = len(global_shape)
    sharding = dict(axis_sharding)
    # stable DCN-last ordering of the chain (ties keep caller order)
    axes = sorted(axes, key=lambda a: 1 if links.get(
        sharding.get(a), "ici") == "dcn" else 0)
    steps = []
    done = set()
    for i, a in enumerate(axes):
        m = sharding.get(a)
        if m is None:
            steps.append(("local", a))
        else:
            # sizes of the pending DCN moves (axes still to transform,
            # sharded over a DCN mesh axis): an ICI move should not squat
            # on the destinations those will need
            reserve = {mesh_shape[sharding[a2]] for a2 in axes[i + 1:]
                       if sharding.get(a2) is not None
                       and links.get(sharding[a2], "ici") == "dcn"}
            if links.get(m, "ici") == "dcn":
                reserve = ()
            dest = _pick_dest(ndim, a, sharding, global_shape,
                              mesh_shape[m], set(axes), done, banned,
                              reserve_sizes=reserve)
            if dest is None:
                steps.append(("roundtrip", a, m))
            else:
                steps.append(("move", a, dest, m))
                del sharding[a]
                sharding[dest] = m
        done.add(a)
    return steps, sharding


def pencil_fftn(
    x,
    axes,
    mesh: Mesh,
    axis_sharding: dict[int, str | None],
    kind: str = "fft",
    precision: str | None = None,
):
    """Distributed N-D FFT of a (globally-viewed) array.

    Parameters
    ----------
    x : array or ComplexPair (global view; will be shard_map-ed)
    axes : transform axes.  For 'rfft'/'irfft' the real axis is ``axes[-1]``
        and must be both the trailing axis and unsharded.
    mesh : jax.sharding.Mesh
    axis_sharding : {array_axis: mesh_axis_name} describing the
        *space-domain* layout: for forward kinds this is the input's
        sharding; for inverse kinds it is the layout the OUTPUT returns to
        (the input is expected in the forward chain's final layout — a
        roundtrip through this module is then collective-minimal; other
        inputs are resharded implicitly by GSPMD).
    kind : 'fft' | 'ifft' | 'rfft' | 'irfft'
    precision : None (backend f32 engines) or "hp" — float64-grade
        distributed transforms: data moves as double-word (df64) CDF64
        quads through the same pencil chain and the local transforms run
        on the exact int8-limb DFT.  A capability with no reference
        analogue: f64-grade *and* transform-dim-sharded without float64
        execution.
    """
    hp = precision == "hp"
    if hp:
        from ..ops.carray import CDF64
        from ..ops.hp import as_quad

        if not isinstance(x, CDF64):
            x = CDF64(*as_quad(x))
    ndim = x.ndim
    axes = [a % ndim for a in axes]
    axis_sharding = {a % ndim: m for a, m in axis_sharding.items() if m}
    if kind in ("rfft", "irfft"):
        if axes[-1] != ndim - 1:
            raise ValueError(f"{kind} axis must be the last axis")
        if axis_sharding.get(ndim - 1):
            raise ValueError(f"the real ({kind}) axis must be unsharded")

    inverse = kind in ("ifft", "irfft")
    # the chained (pencil) axes exclude the trailing real axis, which is
    # always local
    chain_axes = axes[:-1] if kind in ("rfft", "irfft") else axes

    # global shape in the space domain == x's global shape except that for
    # 'irfft' the trailing axis is the half spectrum (not chained: ignore)
    banned = (ndim - 1,) if kind in ("rfft", "irfft") else ()
    from .mesh import axis_links

    steps, final_sharding = plan_forward_layout(
        x.shape, chain_axes, axis_sharding, dict(mesh.shape), banned,
        axis_links=axis_links(mesh))

    spec_space = P(*[axis_sharding.get(a) for a in range(ndim)])
    spec_freq = P(*[final_sharding.get(a) for a in range(ndim)])
    spec_in, spec_out = (spec_freq, spec_space) if inverse \
        else (spec_space, spec_freq)

    core_kind = "ifft" if inverse else "fft"
    overlap = max(int(getattr(config, "pencil_overlap_chunks", 1)), 1)

    def _chunk_axis(shape, a, banned):
        # largest resident axis other than `a` to pipeline chunks over
        cands = [(shape[i], i) for i in range(ndim)
                 if i != a and i not in banned and shape[i] >= overlap]
        return max(cands)[1] if cands else None

    def local_fn(xl):
        out = xl

        def fft_local(v, a):
            if hp:
                from ..ops.carray import CDF64
                from ..ops.int8_dft import int8_fft_nd

                return CDF64(*int8_fft_nd(v.quad, [a], core_kind))
            core = fft_core.fftn if core_kind == "fft" else fft_core.ifftn
            return core(v, [a])

        def a2a_fft(v, m, split_axis, concat_axis, fft_axis, banned,
                    fft_first=False):
            """all_to_all + local FFT (or FFT then all_to_all for the
            inverse chain), optionally split into independent per-chunk
            pairs for overlap."""
            ca = _chunk_axis(v.shape, fft_axis, banned) if overlap > 1 \
                else None

            def one(chunk):
                if fft_first:
                    chunk = fft_local(chunk, fft_axis)
                    return _all_to_all(chunk, m, split_axis, concat_axis)
                chunk = _all_to_all(chunk, m, split_axis, concat_axis)
                return fft_local(chunk, fft_axis)

            if ca is None:
                return one(v)
            return _concat([one(c) for c in _split_chunks(v, ca, overlap)],
                           ca)

        def run_step(out, step):
            if step[0] == "local":
                return fft_local(out, step[1])
            if step[0] == "move":
                _, a, dest, m = step
                if inverse:
                    # reverse: FFT while `a` is resident, then hand the
                    # sharding back from dest to a
                    return a2a_fft(out, m, split_axis=a, concat_axis=dest,
                                   fft_axis=a, banned={a, dest},
                                   fft_first=True)
                return a2a_fft(out, m, split_axis=dest, concat_axis=a,
                               fft_axis=a, banned={a, dest})
            # round-trip fallback (transpose-and-back, with zero-padding)
            _, a, m = step
            P_size = mesh.shape[m]
            b, pad_amt = _rt_buddy(ndim, a, axis_sharding, out.shape, P_size)
            orig = out.shape[b]
            if pad_amt:
                widths = [(0, 0)] * ndim
                widths[b] = (0, pad_amt)
                out = carray.pad(out, widths)
            out = _all_to_all(out, m, split_axis=b, concat_axis=a)
            out = fft_local(out, a)
            out = _all_to_all(out, m, split_axis=a, concat_axis=b)
            if pad_amt:
                key = tuple(slice(0, orig) if i == b else slice(None)
                            for i in range(ndim))
                out = carray.getitem(out, key)
            return out

        if inverse:
            # reverse chain: inverse step order, each 'move' inverted
            order = list(reversed(steps))
        else:
            order = steps

        if kind == "rfft":
            for step in order:
                out = run_step(out, step)
            if hp:
                from ..ops.carray import CDF64
                from ..ops.int8_dft import int8_fft_nd

                return CDF64(*int8_fft_nd(out.quad, [ndim - 1], "rfft"))
            n = out.shape[-1]
            out = fft_core.fftn(out, [ndim - 1])
            return out[..., : n // 2 + 1]
        if kind == "irfft":
            # walk the chained axes back first (on the cheap half-spectrum
            # array); the per-position Hermitian symmetry along the real
            # axis then holds, so mirror locally and finish with a local
            # inverse FFT (the real axis is unsharded by contract)
            for step in order:
                out = run_step(out, step)
            if hp:
                from ..ops.carray import DF64
                from ..ops.int8_dft import int8_fft_nd

                return DF64(*int8_fft_nd(out.quad, [ndim - 1], "irfft"))
            tail = carray.conj(
                carray.getitem(out, (Ellipsis, slice(-2, 0, -1)))
            )
            out = carray.concatenate([out, tail], axis=-1)
            out = fft_core.ifftn(out, [ndim - 1])
            return carray.real(out)
        for step in order:
            out = run_step(out, step)
        return out

    if hp:
        from ..ops.carray import CDF64, DF64

        in_specs = CDF64(spec_in, spec_in, spec_in, spec_in)
        out_specs = DF64(spec_out, spec_out) if kind == "irfft" \
            else CDF64(spec_out, spec_out, spec_out, spec_out)
    elif carray.is_pair(x):
        in_specs = carray.ComplexPair(spec_in, spec_in)
        out_specs = carray.ComplexPair(spec_out, spec_out) \
            if kind != "irfft" else spec_out
    else:
        in_specs = spec_in
        out_specs = spec_out
        if kind in ("fft", "ifft", "rfft") and fft_core.use_split_complex():
            out_specs = carray.ComplexPair(spec_out, spec_out)

    # jit the shard_map: eager dispatch would execute the local program
    # op-by-op across the mesh (pathological for the many-op hp path);
    # under an outer jit this inlines
    f = jax.jit(jax.shard_map(local_fn, mesh=mesh, in_specs=(in_specs,),
                              out_specs=out_specs, check_vma=False))
    return f(x)


def _rt_buddy(ndim, axis, axis_sharding, local_shape, P_size):
    """Round-trip-fallback buddy (transpose-and-back scheme): the axis needing the
    least zero-padding, preferring unsharded hosts."""
    cands = [b for b in range(ndim) if b != axis]
    if not cands:
        raise ValueError(
            f"pencil FFT needs a buddy axis to transpose axis {axis}; "
            f"a 1-D sharded transform has none (shapes {local_shape})."
        )

    def cost(b):
        pad = (-local_shape[b]) % P_size
        return (
            0 if pad == 0 else 1,
            0 if not axis_sharding.get(b) else 1,
            pad / max(local_shape[b], 1),
        )

    b = min(cands, key=cost)
    return b, (-local_shape[b]) % P_size
