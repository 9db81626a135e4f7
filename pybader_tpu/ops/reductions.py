"""On-device reductions and label remaps.

Data-parallel equivalents of the reference's full-grid scan kernels:
 - vacuum_assign  (ref utils.py:382-401)  -> masked where + two f64 sums
 - charge_sum     (ref utils.py:235-252)  -> segment_sum over labels
 - volume_assign  (ref utils.py:404-421)  -> lookup-table gather
 - volume_mask    (ref utils.py:461-476)  -> jnp.where
 - dtype_change   (ref utils.py:255-259)  -> astype at host export time
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def vacuum_mask(reference: jax.Array, vac_tol: jax.Array,
                density: jax.Array, voxel_vol: jax.Array):
    """Mask voxels with reference density <= vac_tol as vacuum.

    returns (mask bool array, vacuum_charge, vacuum_volume) — charge summed
    over the *density* array and scaled by the voxel volume, matching
    reference utils.py:382-401.
    """
    mask = reference <= vac_tol
    charge = jnp.sum(jnp.where(mask, density, 0.0)) * voxel_vol
    volume = jnp.sum(mask) * voxel_vol
    return mask, charge, volume


def _tile_cols(n: int, target: int = 4096) -> int:
    """Largest power-of-two divisor of n, capped at target (>= 1)."""
    c = 1
    while c < target and n % (c * 2) == 0:
        c *= 2
    return c


@partial(jax.jit, static_argnames=("num_segments",))
def charge_volume_sum(density: jax.Array, labels: jax.Array,
                      voxel_vol: jax.Array, num_segments: int):
    """Per-label integrated charge and volume (labels < 0 are excluded).

    Equivalent to reference charge_sum (utils.py:235-252): charge[l] =
    voxel_volume * sum(density where labels==l); volume[l] = voxel_volume *
    count(labels==l).

    Large grids with few labels take masked-sum sweeps (8 labels per
    grid pass, f64 tree reductions, no scatter): a scatter-add into a
    handful of segments serialises on the same few addresses, while the
    sweeps are plain streaming reductions.  Everything else takes
    segment_sum.  Both run in f64.
    """
    flat_lab = labels.reshape(-1)
    flat_rho = density.reshape(-1)
    if num_segments <= 1024 and flat_lab.size >= (1 << 22):
        group = 8  # 8 masks per grid pass (multi-output reduction fusion;
        # a broadcasted (group, n) formulation materialises ~n*group f64)
        n_groups = -(-num_segments // group)

        def one(k0):
            cs, vs = [], []
            for j in range(group):
                m = flat_lab == k0 + j
                cs.append(jnp.sum(jnp.where(m, flat_rho, 0.0)))
                vs.append(jnp.sum(jnp.where(m, 1.0, 0.0)))
            return jnp.stack(cs), jnp.stack(vs)

        starts = jnp.arange(n_groups, dtype=flat_lab.dtype) * group
        charge, volume = jax.lax.map(one, starts)
        charge = charge.reshape(-1)[:num_segments]
        volume = volume.reshape(-1)[:num_segments]
        return charge * voxel_vol, volume * voxel_vol
    seg = jnp.where(flat_lab < 0, jnp.int32(num_segments), flat_lab)
    charge = jax.ops.segment_sum(
        flat_rho, seg, num_segments=num_segments + 1
    )[:num_segments] * voxel_vol
    ones = jnp.ones(flat_lab.shape, dtype=density.dtype)
    volume = jax.ops.segment_sum(
        ones, seg, num_segments=num_segments + 1
    )[:num_segments] * voxel_vol
    return charge, volume


@partial(jax.jit, static_argnames=("num_segments", "cols"))
def masked_min_pair(values: jax.Array, labels: jax.Array,
                    mask: jax.Array, num_segments: int, cols: int = 0):
    """Per-label (min of values, min of values where mask) in one sweep.

    The renumber stage needs both the first basin member (plain min of the
    flat-index grid per label) and the maximum position (min over the
    masked maxima); computing them together shares the label-equality
    compares and the grid reads.  Two-level reduction (rows of ``cols``)
    keeps the row minima vectorised.
    """
    big = jnp.iinfo(jnp.int32).max
    if cols == 0:
        cols = _tile_cols(labels.size)
    lab2 = labels.reshape(-1, cols)
    val2 = values.reshape(-1, cols)
    vmask2 = jnp.where(mask.reshape(-1, cols), val2, big)
    group = 8
    n_groups = -(-num_segments // group)

    def one(k0):
        mins, mmins = [], []
        for j in range(group):
            m = lab2 == k0 + j
            mins.append(jnp.min(jnp.min(
                jnp.where(m, val2, big), axis=1)))
            mmins.append(jnp.min(jnp.min(
                jnp.where(m, vmask2, big), axis=1)))
        return jnp.stack(mins), jnp.stack(mmins)

    starts = jnp.arange(n_groups, dtype=labels.dtype) * group
    mins, mmins = jax.lax.map(one, starts)
    return mins.reshape(-1)[:num_segments], mmins.reshape(-1)[:num_segments]


@partial(jax.jit, static_argnames=("num_segments",))
def remap_sweep(labels: jax.Array, table: jax.Array,
                num_segments: int) -> jax.Array:
    """labels -> table[labels] without a full-grid gather (masked sweeps).

    Negative labels are preserved.  Used to renumber basins to the
    reference's discovery order, sharded grids included: every select is
    elementwise, so no device needs the whole table lookup.  Small label
    counts unroll into one fused grid pass; larger counts loop groups of
    8 selects per pass.
    """
    flat = labels.reshape(-1)
    out = jnp.where(flat < 0, flat, jnp.int32(0))
    if num_segments <= 256:
        for k in range(num_segments):
            out = jnp.where(flat == k, table[k].astype(jnp.int32), out)
        return out.reshape(labels.shape)
    group = 8  # 8 selects per grid pass

    def body(g, out):
        k0 = g * jnp.int32(group)
        for j in range(group):
            k = k0 + jnp.int32(j)
            out = jnp.where(flat == k, table[k].astype(jnp.int32), out)
        return out

    n_groups = -(-num_segments // group)
    out = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_groups), body, out)
    return out.reshape(labels.shape)


def cumsum_blocked(x: jax.Array) -> jax.Array:
    """Inclusive 1-D int32 cumsum via recursive 128-lane blocks.

    Reshaping to (n/128, 128), scanning rows, and recursing on the row
    totals keeps a long 1-D scan to a few streaming passes.  Falls back
    to jnp.cumsum when the length has no 128 factor.
    """
    n = x.shape[0]
    if n <= 4096 or n % 128 != 0:
        return jnp.cumsum(x)
    m = x.reshape(-1, 128)
    inner = jnp.cumsum(m, axis=1)
    rows = inner[:, -1]
    offs = cumsum_blocked(rows) - rows
    return (inner + offs[:, None]).reshape(-1)


@partial(jax.jit, static_argnames=("size",))
def compact_indices(mask: jax.Array, size: int) -> jax.Array:
    """Flat indices of True entries, padded with -1, via a device sort.

    A 32-bit key sort keeps the compaction out of x64 index arithmetic
    (``jnp.nonzero(size=...)`` traces 64-bit cumsums under x64).
    """
    flat = mask.reshape(-1)
    n = flat.shape[0]
    with jax.enable_x64(False):
        big = jnp.int32(np.iinfo(np.int32).max)
        keys = jnp.where(flat, jnp.arange(n, dtype=jnp.int32), big)
        out = jax.lax.sort(keys)[:size]
        return jnp.where(out == big, jnp.int32(-1), out)


@jax.jit
def relabel(labels: jax.Array, swap: jax.Array) -> jax.Array:
    """Remap non-negative labels through a lookup table (vacuum preserved).

    Equivalent to reference volume_assign (utils.py:404-421): one
    gather through the small table.
    """
    remapped = jnp.take(swap, jnp.clip(labels, 0), mode="clip").astype(
        labels.dtype
    )
    return jnp.where(labels < 0, labels, remapped)

