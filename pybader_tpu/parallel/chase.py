"""Multi-device pointer-chain resolution: shard_map chase with halo rounds.

This is the multi-chip product path replacing global pointer doubling
(each doubling round all-gathers the full int32 grid).  It chases
pointers block-locally with a halo, one block per device:

 - the grid is sharded over a 2-D mesh on its two leading axes (z stays
   whole on every device, so z-rolls are exact locally);
 - each device pads its shard with a 1-ring halo along the sharded axes,
   received from its mesh neighbours via ``lax.ppermute`` (x slabs first,
   then y slabs of the x-padded block, so corners ride along);
 - halo cells get the *self* step code, freezing them: the local chase can
   then run to its local fixed point with plain periodic rolls — any read
   that wraps the padded block lands on a frozen cell, and interior cells
   adjacent to the ring adopt the neighbour's latest composition;
 - rounds of (exchange → local fixed point) repeat until a global pass
   changes nothing (``psum`` of per-device change flags).

Correctness rests on one invariant: every intermediate value is a valid ``parent^t`` composition, compositions only
advance, and the unique fixed point per chain is its root — so stale halos
can only delay convergence, never corrupt it.  The reference analog being
replaced is the thread-chunk merge protocol
(/root/reference/pybader/thread_handlers.py:15-75).
"""
from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pybader_tpu.grid import OFFSETS, SELF_INDEX


def _axis_factor(spec_entry, mesh: Mesh) -> int:
    """Number of shards along one array axis for a PartitionSpec entry."""
    if spec_entry is None:
        return 1
    names = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return int(np.prod([sizes[n] for n in names]))


def _exchange(v, axis, name, size):
    """Pad ``v`` with 1-slab halos along ``axis`` from mesh-axis ``name``.

    Periodic across the global boundary (modular ppermute).  With a single
    shard the neighbour is the device itself, which reproduces the local
    periodic wrap exactly.
    """
    dim = v.shape[axis]
    lo = jax.lax.slice_in_dim(v, 0, 1, axis=axis)
    hi = jax.lax.slice_in_dim(v, dim - 1, dim, axis=axis)
    fwd = [(i, (i + 1) % size) for i in range(size)]
    bwd = [(i, (i - 1) % size) for i in range(size)]
    from_prev = jax.lax.ppermute(hi, name, fwd)   # (i-1)'s high edge
    from_next = jax.lax.ppermute(lo, name, bwd)   # (i+1)'s low edge
    return jnp.concatenate([from_prev, v, from_next], axis=axis)


def _one_pass(vals, bk):
    """out[i] = vals[i + OFFSETS[bk[i]]] with periodic rolls (one step)."""
    offs = jnp.asarray(np.asarray(OFFSETS, dtype=np.int32))

    def body(k, out):
        sh = offs[k]
        rolled = jnp.roll(vals, shift=(-sh[0], -sh[1], -sh[2]),
                          axis=(0, 1, 2))
        keep = bk == k.astype(bk.dtype)
        return jnp.where(keep, rolled, out)

    # k == SELF_INDEX selects vals itself: harmless (out starts as vals)
    return jax.lax.fori_loop(jnp.int32(0), jnp.int32(27), body, vals)


def _local_fixed_point(vals, bk):
    """Iterate one-step passes until the block stops changing."""
    def cond(state):
        _, changed = state
        return changed

    def body(state):
        v, _ = state
        nv = _one_pass(v, bk)
        return nv, jnp.any(nv != v)

    # run the first pass eagerly so the carry's changed flag has the same
    # (device-varying) type as the body's output under shard_map
    out, _ = jax.lax.while_loop(cond, body, body((vals, None)))
    return out


def grid_spec_2d(mesh: Mesh, shape) -> P:
    """PartitionSpec sharding the two leading grid axes over the mesh.

    The chase requires z unsharded (z-rolls must be locally exact); axes
    whose dimensions don't divide the mesh factor are left replicated.
    """
    x, y = mesh.axis_names
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    sx = x if shape[0] % sizes[x] == 0 else None
    sy = y if shape[1] % sizes[y] == 0 else None
    if sx is None and sy is None:
        # try the transposed assignment before giving up
        sx = y if shape[0] % sizes[y] == 0 else None
        sy = x if shape[1] % sizes[x] == 0 else None
        if sx is not None or sy is not None:
            return P(sx, sy, None)
    return P(sx, sy, None)


def _chase_round(vals, bk_pinned, spec, mesh):
    """One (exchange halos → local fixed point) round; runs inside
    shard_map.  Returns (new local vals, global changed flag)."""
    padded = vals
    pads = []
    for axis, entry in enumerate(spec[:2]):
        if entry is None:
            continue
        name = entry if not isinstance(entry, tuple) else entry[0]
        size = dict(zip(mesh.axis_names, mesh.devices.shape))[name]
        padded = _exchange(padded, axis, name, size)
        pads.append(axis)
    out = _local_fixed_point(padded, bk_pinned)
    for axis in pads:
        out = jax.lax.slice_in_dim(out, 1, out.shape[axis] - 1, axis=axis)
    changed = jnp.any(out != vals)
    axes = tuple(mesh.axis_names)
    return out, jax.lax.pmax(changed.astype(jnp.int32), axes)


def _pin_codes(bk, spec):
    """Pad step codes with a frozen (self-step) ring on sharded axes."""
    for axis, entry in enumerate(spec[:2]):
        if entry is None:
            continue
        shape = list(bk.shape)
        shape[axis] = 1
        ring = jnp.full(shape, jnp.uint8(SELF_INDEX), dtype=bk.dtype)
        bk = jnp.concatenate([ring, bk, ring], axis=axis)
    return bk


def sharded_chase(mesh: Mesh, values, bk, spec: P | None = None,
                  max_rounds: int = 1024):
    """Converge ``values`` along the ascent-pointer graph on a device mesh.

    args:
        values: (nx,ny,nz) int32 — one-step parents or a one-shot label
                seed (0 unlabeled, k for basin k-1; the flood seed of
                :func:`pybader_tpu.ops.scanflood._flood_seed`).
        bk:     (nx,ny,nz) uint8 step codes in OFFSETS order (13 == self).
        spec:   grid PartitionSpec (leading two axes only); default
                :func:`grid_spec_2d`.
    returns values converged to each voxel's root value, sharded per spec.
    """
    if spec is None:
        spec = grid_spec_2d(mesh, values.shape)
    sharding = NamedSharding(mesh, spec)
    values = jax.device_put(jnp.asarray(values), sharding)
    bk = jax.device_put(jnp.asarray(bk), sharding)

    round_fn = jax.jit(jax.shard_map(
        lambda v, b: _chase_round(v, b, spec, mesh),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, P()),
    ))
    pin_fn = jax.jit(jax.shard_map(
        lambda b: _pin_codes(b, spec), mesh=mesh,
        in_specs=(spec,), out_specs=spec,
    )) if any(e is not None for e in spec[:2]) else None
    bk_pinned = pin_fn(bk) if pin_fn is not None else bk

    for _ in range(max_rounds):
        values, changed = round_fn(values, bk_pinned)
        if not int(changed):
            break
    return values
