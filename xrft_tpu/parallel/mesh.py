"""Mesh construction and LabeledArray sharding helpers.

The reference's sole parallelism mechanism is dask chunking (SURVEY.md
§2.2); its replacement here is ``jax.sharding``: batch (non-transform)
dims shard freely across a device mesh with zero collectives — the direct
analogue of dask's embarrassingly parallel chunked dims — while transform
dims use the pencil decomposition in :mod:`.pencil`.
"""

from __future__ import annotations

import weakref

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..labeled import LabeledArray
from ..ops import carray

__all__ = ["make_mesh", "shard_labeled", "spec_for", "axis_links"]


def make_mesh(axis_shapes: dict[str, int | tuple[int, str]] | None = None
              ) -> Mesh:
    """Build a Mesh over all available devices.

    ``axis_shapes``: mapping of mesh-axis name to size, e.g.
    ``{"data": 2, "fft": 4}``.  Default: one axis named 'data' spanning all
    devices.

    Topology hints (SURVEY §7 stage 6 "DCN-aware axis ordering"): a value
    may be ``(size, link)`` with link ``"ici"`` (the fast interconnect
    inside a host: NVLink between the cards of one GPU host) or ``"dcn"``
    (the network between hosts, an order of magnitude slower), e.g.
    ``{"dp": (2, "dcn"), "fp": (4, "ici")}``.  Two effects:

    1. DCN axes are made *outermost* (slowest-varying) in device order, so
       on a multi-host deployment each ICI axis's device group stays
       within one host (one process) and its collectives ride NVLink — the
       hybrid-mesh recipe (``mesh_utils.create_hybrid_device_mesh`` with
       the process as the granule; on a single-process run this degrades
       to a plain reordered mesh).
    2. The link map is recorded on the mesh (see :func:`axis_links`); the
       pencil planner (:mod:`.pencil`) orders multi-axis transform chains
       DCN-last and steers DCN all_to_alls toward destinations that never
       need a second DCN hop.
    """
    if axis_shapes is None:
        axis_shapes = {"data": len(jax.devices())}
    sizes, links = {}, {}
    had_hints = False
    for name, v in axis_shapes.items():
        if isinstance(v, tuple):
            size, link = v
            had_hints = True
            if link not in ("ici", "dcn"):
                raise ValueError(f"unknown link type {link!r} for mesh axis "
                                 f"{name!r} (expected 'ici' or 'dcn')")
        else:
            size, link = v, "ici"
        sizes[name] = int(size)
        links[name] = link
    # DCN axes outermost: their device stride is then the whole ICI block,
    # i.e. consecutive devices (same slice) differ only in ICI coordinates
    order = sorted(sizes, key=lambda n: 0 if links[n] == "dcn" else 1)
    if any(link == "dcn" for link in links.values()):
        mesh = _hybrid_mesh(order, sizes, links)
    else:
        mesh = jax.make_mesh(tuple(sizes[n] for n in order), tuple(order))
    # JAX interns Mesh objects (same devices + axis names -> same object),
    # so the links live in a side registry rather than as an attribute.
    # Interning means two independent make_mesh calls can hand back the
    # SAME object: an unhinted call registers NOTHING (it expresses no
    # topology opinion — and a registration would also suppress the
    # multi-host warning in axis_links), and a hinted call that
    # conflicts with a live registration warns before replacing it — the
    # earlier handle's pencil plans would otherwise silently lose their
    # DCN awareness.
    if not had_hints:
        return mesh
    prev = _MESH_LINKS.get(mesh)
    if prev is not None and prev != links:
        import warnings

        warnings.warn(
            f"make_mesh: replacing topology hints {prev} with {links} for "
            f"an interned Mesh also in use elsewhere; pencil plans built "
            f"from the earlier handle will see the new link map.",
            RuntimeWarning, stacklevel=2)
    _MESH_LINKS[mesh] = dict(links)
    return mesh


def _hybrid_mesh(order, sizes, links) -> Mesh:
    """Hybrid ICI/DCN mesh over ``jax.devices()`` (see
    :func:`_hybrid_device_grid`)."""
    devices = jax.devices()
    if len(_granules(devices)) > 1:
        return Mesh(_hybrid_device_grid(order, sizes, links, devices),
                    tuple(order))
    return jax.make_mesh(tuple(sizes[n] for n in order), tuple(order))


def _hybrid_device_grid(order, sizes, links, devices) -> np.ndarray:
    """Device array for a mesh spanning several processes (hosts): each
    DCN axis steps across processes, each ICI axis within one process —
    ``mesh_utils.create_hybrid_device_mesh`` with the process as the
    granule."""
    from jax.experimental import mesh_utils

    dcn_shape = [sizes[n] if links[n] == "dcn" else 1 for n in order]
    ici_shape = [1 if links[n] == "dcn" else sizes[n] for n in order]
    return mesh_utils.create_hybrid_device_mesh(
        ici_shape, dcn_shape, devices=devices, process_is_granule=True)


_MESH_LINKS: "weakref.WeakKeyDictionary[Mesh, dict[str, str]]" = \
    weakref.WeakKeyDictionary()
# meshes already warned about missing hints on multi-host device sets
_WARNED_UNHINTED: "weakref.WeakSet[Mesh]" = weakref.WeakSet()


def _granules(devices) -> set:
    """Distinct processes (hosts) among ``devices``: the granule inside
    which the fast interconnect joins every device."""
    return {getattr(d, "process_index", None) for d in devices} - {None}


def axis_links(mesh: Mesh) -> dict[str, str]:
    """Per-mesh-axis link type ({axis: 'ici'|'dcn'}); axes of meshes built
    outside :func:`make_mesh` (or without hints) default to 'ici'.

    A mesh that spans several processes (hosts) but carries no link
    registration (e.g. built with the user's own ``jax.make_mesh``) warns
    once: on a multi-host deployment the all-ICI default silently plans
    pencil chains whose collectives may ride the network between hosts.
    """
    links = _MESH_LINKS.get(mesh)
    if links is None and mesh not in _WARNED_UNHINTED:
        n_granules = len(_granules(np.asarray(mesh.devices).flat))
        if n_granules > 1:
            import warnings

            warnings.warn(
                f"mesh spans {n_granules} processes (hosts) but has no "
                f"topology hints registered: pencil plans will assume "
                f"every axis is ICI, so collectives may ride the DCN. "
                f"Build the mesh with xrft_tpu.parallel.make_mesh("
                f"{{axis: (size, 'ici'|'dcn')}}) to register link types.",
                RuntimeWarning, stacklevel=2)
            # a dedicated warned-set (NOT an empty registration, which
            # make_mesh would misread as real prior hints): once per mesh
            _WARNED_UNHINTED.add(mesh)
    links = links or {}
    return {name: links.get(name, "ici") for name in mesh.shape}


def spec_for(da: LabeledArray, dim_shards: dict[str, str]) -> P:
    """PartitionSpec for a LabeledArray from a {dim: mesh_axis} mapping."""
    return P(*[dim_shards.get(d) for d in da.dims])


def shard_labeled(da: LabeledArray, mesh: Mesh, dim_shards: dict[str, str]
                  ) -> LabeledArray:
    """Place a LabeledArray's data on `mesh` sharded per {dim: mesh_axis}.

    Unlisted dims are replicated.  Split-complex data shards componentwise
    with identical layout.
    """
    for d in dim_shards:
        if d not in da.dims:
            raise ValueError(f"shard dim {d!r} not in array dims {da.dims}")
    sharding = NamedSharding(mesh, spec_for(da, dim_shards))
    data = da.data
    if isinstance(data, np.ndarray):
        from ..labeled import _asjax

        data = _asjax(data)
    if carray.is_pair(data):
        data = carray.ComplexPair(
            jax.device_put(data.re, sharding), jax.device_put(data.im, sharding)
        )
    else:
        data = jax.device_put(data, sharding)
    return da.copy(data=data)
