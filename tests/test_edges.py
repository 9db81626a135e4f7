"""Edge stencils and surface distance vs serial numpy oracles.

The separable-roll edge_find / edge_check and the edge-compaction surface
distance are the only implementations on every backend; these pin them
on non-cubic grids, with and without vacuum and a supplied ``is_max``.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest

from tests.oracle import edge_check_scan, edge_scan, gaussian_density

from pybader_tpu import grid as g
from pybader_tpu import pipeline
from pybader_tpu.ops import atoms as atoms_ops
from pybader_tpu.ops import edges as edges_ops
from pybader_tpu.ops.stencil import ongrid_step_codes

LATTICE = np.array([[6.0, 0.0, 0.3], [0.2, 5.0, 0.0], [0.0, 0.1, 7.0]])


def _field(shape, seed, n_blobs=5):
    rng = np.random.default_rng(seed)
    rho = gaussian_density(shape, LATTICE, rng.uniform(size=(n_blobs, 3)),
                           rng.uniform(0.5, 1.0, n_blobs),
                           rng.uniform(1.0, 2.0, n_blobs)) + 1e-6
    w = tuple(g.distance_weights(LATTICE, shape))
    return rho, w


@pytest.mark.parametrize("shape,vacuum,pass_is_max", [
    ((12, 10, 8), False, True),
    ((9, 14, 11), True, True),
    ((10, 7, 13), True, False),
    ((16, 12, 6), False, False),
])
def test_edge_find_vs_oracle(shape, vacuum, pass_is_max):
    rho, w = _field(shape, seed=sum(shape))
    vac = rho <= np.quantile(rho, 0.25) if vacuum else None
    labels, _ = pipeline.partition_ongrid(rho, vac, w)
    labels = np.asarray(labels)
    is_max = None
    if pass_is_max:
        bk = ongrid_step_codes(jnp.asarray(rho), w)
        is_max = (bk == 13) & jnp.asarray(labels != -1)
    known = edges_ops.edge_find(jnp.asarray(rho), jnp.asarray(labels), is_max)
    np.testing.assert_array_equal(np.asarray(known), edge_scan(rho, labels))


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_check_vs_oracle(seed):
    """Relabel scattered edge voxels to a neighbour's label, mark them
    changed (-2, the rest -1), and re-scan their neighbourhoods.  The
    moved voxels lie >= 5 apart (periodic Chebyshev distance), so their
    re-scanned neighbourhoods are disjoint and the serial scan's visit
    order cannot matter."""
    shape = (16, 15, 13)
    rho, w = _field(shape, seed=seed)
    labels, _ = pipeline.partition_ongrid(rho, None, w)
    labels = np.asarray(labels)
    known = edge_scan(rho, labels)
    rng = np.random.default_rng(seed)
    moved = []
    for p in rng.permutation(np.argwhere(known == -2)):
        d = [np.abs(p - q) for q in moved]
        if all(np.max(np.minimum(x, np.asarray(shape) - x)) >= 5
               for x in d):
            moved.append(p)
    assert len(moved) >= 3
    known[known == -2] = -1
    new = labels.copy()
    for p in moved:
        q = tuple((p + rng.integers(-1, 2, 3)) % shape)
        new[tuple(p)] = labels[q]
        known[tuple(p)] = -2
    got = edges_ops.edge_check(jnp.asarray(known), jnp.asarray(rho),
                               jnp.asarray(new))
    want = edge_check_scan(known.copy(), rho, new, skip_vacuum=True)
    np.testing.assert_array_equal(np.asarray(got), want)


def _surface_oracle(labels, known, lattice, atoms_cart):
    """Loop over edge voxels: min distance to the own atom, 27 images."""
    shape = labels.shape
    best = np.full(len(atoms_cart), np.inf)
    images = [np.array(c) @ lattice
              for c in itertools.product((-1, 0, 1), repeat=3)]
    for p in np.argwhere(known == -2):
        a = labels[tuple(p)]
        pc = (p / np.asarray(shape)) @ lattice
        for s in images:
            best[a] = min(best[a], np.sum((pc - atoms_cart[a] - s) ** 2))
    return np.where(np.isfinite(best), np.sqrt(best), 0.0)


@pytest.mark.parametrize("shape", [(12, 10, 8), (9, 14, 11)])
def test_surface_distance_vs_brute_force(shape):
    rho, w = _field(shape, seed=7)
    labels, maxima = pipeline.partition_ongrid(rho, None, w)
    atoms_cart = (np.asarray(maxima) / np.asarray(shape)) @ LATTICE + 0.1
    known = np.asarray(edges_ops.edge_find(jnp.asarray(rho), labels))
    dist = atoms_ops.surface_distance_masked(
        labels, jnp.asarray(known == -2), LATTICE, atoms_cart,
        len(atoms_cart))
    want = _surface_oracle(np.asarray(labels), known, LATTICE, atoms_cart)
    np.testing.assert_allclose(np.asarray(dist), want, rtol=1e-12)
    assert (want > 0).all()


def test_surface_distance_atom_without_edges():
    """An atom that owns no voxel (or no edge voxel) reports 0.0, and a
    grid with no edges at all returns zeros (reference behaviour)."""
    shape = (8, 8, 8)
    labels = np.zeros(shape, dtype=np.int32)
    labels[:4] = 1
    known = np.asarray(edges_ops.edge_find(
        jnp.asarray(np.ones(shape) + np.arange(8)[:, None, None] * 1e-3),
        jnp.asarray(labels)))
    atoms_cart = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0],
                           [3.0, 3.0, 3.0]])
    dist = np.asarray(atoms_ops.surface_distance_masked(
        jnp.asarray(labels), jnp.asarray(known == -2), LATTICE, atoms_cart,
        3))
    assert dist[2] == 0.0 and (dist[:2] > 0).all()
    none = np.asarray(atoms_ops.surface_distance_masked(
        jnp.asarray(labels), jnp.zeros(shape, bool), LATTICE, atoms_cart, 3))
    np.testing.assert_array_equal(none, np.zeros(3))
