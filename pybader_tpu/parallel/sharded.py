"""Sharded (multi-device) partitioning pipeline.

The density grid is sharded over a 2-D mesh ('x', 'y' — the first two grid
axes); z stays replicated-contiguous so the innermost dimension keeps good
layout.  Under jit+SPMD, XLA lowers the 26-neighbour rolls of the ascent
stencil to halo exchanges (collective-permute) between devices and the segment
reductions to local sums + psum.  Pointer chains are resolved by the
shard_map halo-round chase (:mod:`pybader_tpu.parallel.chase`) — block-local
convergence per device with 1-ring halo exchanges, replacing the global
all-gather pointer doubling that dominated the naive SPMD lowering.

This module is exercised on a virtual CPU mesh in tests, and on real
devices by ``__graft_entry__.dryrun_multichip`` and
``chip_smoke.py --four-cards``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pybader_tpu.ops.stencil import (
    ongrid_parent, ongrid_step_codes, self_index,
)
from pybader_tpu.ops.pointer import resolve_roots
from pybader_tpu.parallel.chase import grid_spec_2d, sharded_chase


def _factor2(n: int):
    """n -> (a, b), a*b == n, as square as possible."""
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return max(a, 1), n // max(a, 1)


def make_mesh(n_devices: int | None = None, axis_names=("x", "y")) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    a, b = _factor2(len(devs))
    return Mesh(np.asarray(devs).reshape(a, b), axis_names)


def choose_grid_spec(mesh: Mesh, shape) -> P:
    """Pick a PartitionSpec for a 3-D grid compatible with its dimensions.

    Prefers sharding the two leading axes over the two mesh axes (z stays
    contiguous for layout); falls back to partial sharding or replication
    when grid dimensions don't divide the mesh factors.
    """
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    x, y = mesh.axis_names

    def ok(spec):
        for dim, s in zip(shape, spec):
            if s is None:
                continue
            axes = s if isinstance(s, tuple) else (s,)
            factor = int(np.prod([sizes[a] for a in axes]))
            if dim % factor:
                return False
        return True

    candidates = [
        P(x, y, None), P(y, x, None),
        P((x, y), None, None), P(None, (x, y), None),
        P(None, None, (x, y)),
        P(x, None, None), P(y, None, None),
        P(None, x, None), P(None, y, None),
        P(),
    ]
    for spec in candidates:
        if ok(spec):
            return spec
    return P()


@partial(jax.jit, static_argnames=("weights", "num_buckets"))
def _partition_step(density, weights, num_buckets=128):
    """One full partition 'step': parents -> roots -> summary reductions.

    This is the flagship compiled program: stencil (halo exchanges),
    pointer doubling (gathers), and segment reductions, all under one jit so
    SPMD partitioning spans the whole pipeline.  Returns small arrays only
    (no host round-trip of the grid).
    """
    parent = ongrid_parent(density, weights, None)
    roots = resolve_roots(parent)
    self_idx = self_index(density)
    n_maxima = jnp.sum(roots == self_idx)
    # bucketed charge reduction (dense labels need a host round-trip for
    # the maxima count; buckets exercise the same sharded segment-sum path)
    buckets = jnp.remainder(roots.reshape(-1), num_buckets)
    charge = jax.ops.segment_sum(
        density.reshape(-1), buckets, num_segments=num_buckets
    )
    return roots, n_maxima, charge


def sharded_step(mesh: Mesh, density, weights):
    """Run the fused partition step with the grid sharded over the mesh.

    returns (roots, n_maxima, bucketed_charge) with roots sharded like the
    input density.
    """
    density = jnp.asarray(density)
    grid_sharding = NamedSharding(mesh, choose_grid_spec(mesh, density.shape))
    density = jax.device_put(density, grid_sharding)
    fn = jax.jit(
        _partition_step,
        static_argnames=("weights", "num_buckets"),
        in_shardings=(grid_sharding,),
        out_shardings=(
            grid_sharding,
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P()),
        ),
    )
    return fn(density, tuple(weights))


def _seed_local(bk_loc, vac_loc, spec, mesh, has_vacuum):
    """Per-device flood-seed (runs inside shard_map).

    Maxima are seeded with a 1-based label rank (device-linear order +
    local C-order position — any consistent numbering, fixed up afterwards
    by the discovery-order renumber), everything else with 0, vacuum with
    the n_maxima+1 sentinel — the flood seed of
    :func:`pybader_tpu.ops.scanflood._flood_seed`, lifted to the mesh.
    """
    is_self = bk_loc == jnp.uint8(13)
    is_max = (is_self & ~vac_loc) if has_vacuum else is_self
    flat_max = is_max.reshape(-1)
    cnt = jnp.sum(flat_max.astype(jnp.int32))
    # rank offsets and the global count use only the mesh axes the spec
    # actually shards over: along unused axes every device holds a replica
    # and must compute identical values
    used = []
    for entry in spec:
        if entry is None:
            continue
        used += list(entry) if isinstance(entry, tuple) else [entry]
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if used:
        counts = jax.lax.all_gather(cnt, tuple(used))
        lin = jnp.int32(0)
        for a in used:
            lin = lin * np.int32(sizes[a]) + jax.lax.axis_index(a)
        before = jnp.arange(counts.shape[0], dtype=jnp.int32) < lin
        offset = jnp.sum(jnp.where(before, counts, 0)).astype(jnp.int32)
        n_max = jax.lax.psum(cnt, tuple(used))
    else:  # fully replicated grid
        offset = jnp.int32(0)
        n_max = cnt
    ranks = (offset + jnp.cumsum(flat_max.astype(jnp.int32))
             ).reshape(bk_loc.shape)
    seed = jnp.where(is_max, ranks, jnp.int32(0))
    if has_vacuum:
        seed = jnp.where(vac_loc, n_max + jnp.int32(1), seed)
    return seed, n_max


def sharded_partition(mesh: Mesh, reference, vacuum, weights):
    """Full labelled partition on a device mesh, discovery-order numbering.

    Pipeline: GSPMD ascent stencil (rolls -> halo collectives) -> per-device
    one-shot label seed (shard_map) -> halo-round chase -> discovery-order
    renumber (masked sweeps, sharding-friendly).  Labels match the
    single-device pipeline voxel-for-voxel (tests/test_sharded.py).
    """
    from pybader_tpu import pipeline

    reference = jnp.asarray(reference)
    shape = reference.shape
    spec = grid_spec_2d(mesh, shape)
    sharding = NamedSharding(mesh, spec)
    reference = jax.device_put(reference, sharding)
    vac = None
    if vacuum is not None:
        vac = jax.device_put(jnp.asarray(vacuum), sharding)

    bk = jax.jit(
        ongrid_step_codes, static_argnames=("weights",),
        out_shardings=sharding,
    )(reference, tuple(weights))
    if vac is not None:
        bk = jnp.where(vac, jnp.uint8(13), bk)

    n = int(np.prod(shape))
    has_vac = vac is not None
    seed_fn = jax.jit(jax.shard_map(
        lambda b, v: _seed_local(b, v, spec, mesh, has_vac),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, P()),
    ))
    seed, n_max_dev = seed_fn(bk, vac if has_vac else bk != bk)
    n_max = max(int(n_max_dev), 1)

    out = sharded_chase(mesh, seed, bk, spec)
    labels_mo = out - jnp.int32(1)
    labels_mo = jnp.where(labels_mo == jnp.int32(n_max),
                          jnp.int32(-1), labels_mo)
    iota = jax.jit(
        lambda: jnp.arange(n, dtype=jnp.int32).reshape(shape),
        out_shardings=sharding,
    )()
    is_max = bk == jnp.uint8(13)
    if vac is not None:
        is_max = is_max & ~vac
    return pipeline.renumber_discovery(labels_mo, is_max, vac, n_max, iota)
