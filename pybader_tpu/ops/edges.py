"""Edge detection stencils.

Data-parallel equivalents of reference refinement.py:325-405 (edge_find) and
:408-508 (edge_check): one fused 26-neighbour stencil pass instead of a
serial scan with in-place neighbour marking.  The serial reference's marking
order turns out not to affect the final ``known`` state (any non-edge voxel
adjacent to an edge ends at -1 regardless of visit order), so the parallel
formulation is exact.

The 26-neighbour reductions are *separable*: the 3x3x3 box (self included)
is the composition of per-axis 3-windows, so "any neighbour label differs"
becomes per-axis min/max sweeps — 12 unit rolls of the label grid instead
of 26 arbitrary-offset rolls, and "no neighbour density is higher" becomes
6 unit rolls of the density grid.  Unit-static rolls also unroll cleanly
(the old fori-loop form serialised 26 traced-shift rolls per reduction).

``known`` encoding (reference convention): 2 = interior or local max,
-1 = near an edge, -2 = edge voxel (to be refined), 0 = untouched (vacuum
far from any edge).

Deviation from the reference (documented, deliberate): the reference's
edge_check can classify *vacuum* voxels as edges (refinement.py:448 reads
volumes[pe] == -1 without skipping), which would let refinement re-assign
vacuum voxels to basins in 'changed' mode only — inconsistent with both
edge_find and 'all' mode.  We skip vacuum voxels as edge candidates in both.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from pybader_tpu.grid import OFFSETS


def _axis3(a, axis, combine):
    """combine(a, a shifted +1, a shifted -1) along one axis (periodic)."""
    return combine(combine(a, jnp.roll(a, 1, axis)), jnp.roll(a, -1, axis))


def _box_reduce(a, combine):
    """Separable 3x3x3 reduction (self included), periodic."""
    for axis in range(3):
        a = _axis3(a, axis, combine)
    return a


def _edge_and_max(reference, labels, is_max=None):
    """is_edge / is_max per voxel, vacuum neighbours ignored in both.

    A voxel is an edge iff some non-vacuum neighbour carries a different
    label: masking vacuum labels to +-sentinel and taking the separable
    box min/max, that is exactly ``box_max != box_min`` (self is in the
    box and contributes the voxel's own label on non-vacuum voxels).

    ``is_max`` can be supplied precomputed: a voxel is a local max iff no
    neighbour has strictly higher density, which is exactly the self step
    of the ascent stencil (``bk == 13``, weights are positive so the
    weighted candidate exceeds the centre iff the raw density does) —
    passing it skips the 6 density rolls.  Vacuum neighbours can never be
    the higher one (vacuum is the low set), so the stencil's is_max agrees
    with the vacuum-ignoring definition.  Without it, the separable box
    max of the density equals the centre density iff no neighbour exceeds
    it (exact: max returns a member of the set).
    """
    vac = labels == -1
    big = jnp.int32(np.iinfo(np.int32).max)
    lab = labels.astype(jnp.int32)
    lmax = _box_reduce(jnp.where(vac, -big, lab), jnp.maximum)
    lmin = _box_reduce(jnp.where(vac, big, lab), jnp.minimum)
    is_edge = lmax != lmin
    if is_max is None:
        neg = jnp.asarray(-np.inf, dtype=reference.dtype)
        rmax = _box_reduce(jnp.where(vac, neg, reference), jnp.maximum)
        is_max = rmax == reference
    return is_edge, is_max


def _dilate26(mask):
    """Separable periodic 3x3x3 dilation (6 unit rolls)."""
    return _box_reduce(mask, jnp.logical_or)


@jax.jit
def edge_find(reference: jax.Array, labels: jax.Array,
              is_max: jax.Array | None = None) -> jax.Array:
    """Full-grid edge scan -> known int8 grid (see module docstring).

    Separable roll stencils; ``is_max`` (the self step of the ascent
    stencil) skips the density rolls when the caller has it.
    """
    nonvac = labels != -1
    is_edge, is_max = _edge_and_max(reference, labels, is_max)
    edge = nonvac & is_edge & ~is_max
    near = _dilate26(edge) & ~edge
    known = jnp.where(
        edge, jnp.int8(-2),
        jnp.where(near, jnp.int8(-1),
                  jnp.where(nonvac, jnp.int8(2), jnp.int8(0))),
    )
    return known


@partial(jax.jit, static_argnames=("shape",))
def neighbors27_flat(idx: jax.Array, shape) -> jax.Array:
    """(K,) flat voxel indices -> (K*27,) flat indices of their periodic
    27-neighbourhoods (self included).  Padding entries (idx < 0) produce
    -1 across their whole row."""
    nx, ny, nz = shape
    valid = idx >= 0
    p = jnp.clip(idx, 0)
    x = p // (ny * nz)
    y = (p // nz) % ny
    z = p % nz
    offs = jnp.asarray(np.asarray(OFFSETS, dtype=np.int32))  # (27, 3)
    xn = jnp.remainder(x[:, None] + offs[None, :, 0], nx)
    yn = jnp.remainder(y[:, None] + offs[None, :, 1], ny)
    zn = jnp.remainder(z[:, None] + offs[None, :, 2], nz)
    flat = (xn * ny + yn) * nz + zn
    return jnp.where(valid[:, None], flat, -1).reshape(-1)


@partial(jax.jit, static_argnames=())
def filter_edges_sorted(cand: jax.Array, known_flat: jax.Array):
    """Unique candidate indices with known == -2, ascending, -1-padded.

    ``cand`` is a small (K*27,) index list (next iteration's edge set is a
    subset of the changed set's neighbourhoods), so the dedupe sort runs on
    K*27 elements instead of a full-grid compaction sort.
    returns (starts (K*27,) int32 ascending with -1 tail, count).
    """
    n = known_flat.shape[0]
    big = jnp.int32(np.iinfo(np.int32).max)
    k = jnp.take(known_flat, jnp.clip(cand, 0), mode="clip")
    keep = (cand >= 0) & (k == jnp.int8(-2))
    keys = jnp.where(keep, cand.astype(jnp.int32), big)
    s = jnp.sort(keys)
    uniq = s != jnp.concatenate([jnp.full((1,), -1, jnp.int32), s[:-1]])
    keys2 = jnp.where(uniq & (s != big), s, big)
    out = jnp.sort(keys2)
    count = jnp.sum(out != big)
    return jnp.where(out == big, jnp.int32(-1), out), count


@jax.jit
def edge_check(known: jax.Array, reference: jax.Array,
               labels: jax.Array,
               is_max: jax.Array | None = None) -> jax.Array:
    """Re-scan only the 27-neighbourhoods of changed edges (known == -2).

    Returns the updated known grid; the new edge set is ``known == -2``.
    """
    nonvac = labels != -1
    changed = known == -2
    cand = _dilate26(changed) & nonvac  # self included in the box
    is_edge, is_max = _edge_and_max(reference, labels, is_max)
    new_edge = cand & is_edge & ~is_max
    not_edge = cand & ~is_edge
    out = jnp.where(not_edge, jnp.int8(-1), known)
    out = jnp.where(new_edge, jnp.int8(-2), out)
    near_new = _dilate26(new_edge) & (out >= 0)
    out = jnp.where(near_new, jnp.int8(-1), out)
    return out
