"""Maxima -> atom assignment and minimum surface distance.

Data-parallel equivalents of reference utils.py atom_assign (:185-232, serial
M x A x 27 brute force) and surface_dist (:320-379, per-edge-voxel distance
to its own atom): both become fully vectorised distance reductions.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _image_shifts(lattice):
    """(27, 3) cartesian shifts over the 3x3x3 periodic images."""
    combos = jnp.asarray(
        [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)],
        dtype=lattice.dtype,
    )
    return combos @ lattice


@jax.jit
def assign_to_atoms(maxima_cart: jax.Array, atoms_cart: jax.Array,
                    lattice: jax.Array):
    """Nearest atom (over 27 periodic images) for each maximum.

    Ties break to the lowest atom index, matching the reference's strict-<
    scan (utils.py:203-230).
    returns (atom indices (M,), distances (M,)).
    """
    shifts = _image_shifts(lattice)  # (27, 3)
    # (M, A, 27) squared distances
    delta = (
        maxima_cart[:, None, None, :]
        - (atoms_cart[None, :, None, :] + shifts[None, None, :, :])
    )
    d2 = jnp.sum(delta * delta, axis=-1)
    d2_atom = jnp.min(d2, axis=-1)  # (M, A)
    atom = jnp.argmin(d2_atom, axis=-1).astype(jnp.int64)
    dist = jnp.sqrt(jnp.take_along_axis(d2_atom, atom[:, None], axis=1)[:, 0])
    return atom, dist


def surface_distance_masked(labels: jax.Array, edge_mask: jax.Array,
                            lattice, atoms_cart, num_atoms: int):
    """Min distance from each atom to its own volume's surface, from the
    edge mask: compact the edge voxels, then
    :func:`surface_distance_from_edges` in f64.

    returns (num_atoms,) f64 distances, 0.0 for atoms with no edge voxel
    (reference thread_handlers.py:289-297).
    """
    from pybader_tpu.ops.reductions import compact_indices

    shape = tuple(labels.shape)
    mask_flat = edge_mask.reshape(-1)
    n_edges = int(jnp.sum(mask_flat))
    if n_edges == 0:
        return jnp.zeros((int(num_atoms),), jnp.float64)
    size = max(4096, 1 << (n_edges - 1).bit_length())
    if size.bit_length() % 2 == 0:
        size <<= 1  # powers of 4: fewer compile buckets
    edge_idx = compact_indices(mask_flat, size)
    return surface_distance_from_edges(
        edge_idx, labels.reshape(-1), jnp.asarray(lattice),
        jnp.asarray(atoms_cart), shape, int(num_atoms))


@partial(jax.jit, static_argnames=("num_atoms", "shape"))
def surface_distance_from_edges(edge_idx: jax.Array, labels_flat: jax.Array,
                                lattice: jax.Array, atoms_cart: jax.Array,
                                shape: tuple, num_atoms: int):
    """Min distance from each atom to the surface of its own Bader volume.

    args:
        edge_idx: (K,) flat indices of edge voxels of the atom-label map,
                  padded with -1.
        labels_flat: (N,) voxel -> atom map.
        atoms_cart: atom positions already shifted by -voxel_offset
                    (reference interface.py:530).
        shape: static grid shape.
    returns:
        (num_atoms,) distances; atoms whose volumes have no edge voxels in
        the set get 0.0 (reference thread_handlers.py:289-297 behaviour).
    """
    nx, ny, nz = shape
    valid = edge_idx >= 0
    idx = jnp.clip(edge_idx, 0)
    x = idx // (ny * nz)
    y = (idx // nz) % ny
    z = idx % nz
    # cast before dividing: int32 / int promotes to float32 in JAX
    dt = lattice.dtype
    frac = jnp.stack(
        [x.astype(dt) / nx, y.astype(dt) / ny, z.astype(dt) / nz], axis=-1
    )  # (K, 3)
    pc = frac @ lattice
    lab = jnp.take(labels_flat, idx, mode="clip").astype(jnp.int32)
    own = jnp.take(atoms_cart, jnp.clip(lab, 0), axis=0, mode="clip")
    shifts = _image_shifts(lattice)  # (27, 3)
    delta = pc[:, None, :] - (own[:, None, :] + shifts[None, :, :])
    d2 = jnp.min(jnp.sum(delta * delta, axis=-1), axis=-1)  # (K,)
    seg = jnp.where(valid & (lab >= 0), lab, jnp.int32(num_atoms))
    d2_atom = jax.ops.segment_min(d2, seg, num_segments=num_atoms + 1)
    d2_atom = d2_atom[:num_atoms]
    return jnp.where(jnp.isfinite(d2_atom), jnp.sqrt(d2_atom), 0.0)
