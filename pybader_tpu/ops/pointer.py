"""Parallel pointer doubling and canonical basin labelling.

Replaces the reference's serial path-following with early-exit path
compression (methods.py:166-168, 211-214) and the whole thread-chunk merge
protocol (volume_offset / volume_merge / edge_assign,
thread_handlers.py:59-69): every voxel's ascent pointer chain is converged in
O(log(path length)) full-grid gathers, and basins are numbered canonically in
the reference's single-thread discovery order (first basin member in
row-major voxel order — provably identical to the order in which the serial
scan first discovers each maximum).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def resolve_roots(parent: jax.Array) -> jax.Array:
    """Converge ascent pointers: root[p] = the maximum p's chain reaches.

    ``parent`` may be any shape; gathers run on the flat view.  Terminates
    when a full doubling step changes nothing (maxima are fixed points).
    """
    shape = parent.shape
    p0 = parent.reshape(-1)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        p, _ = state
        p2 = jnp.take(p, p, mode="clip")
        return p2, jnp.any(p2 != p)

    roots, _ = jax.lax.while_loop(cond, body, (p0, jnp.asarray(True)))
    return roots.reshape(shape)


@partial(jax.jit, static_argnames=("num_maxima",))
def compact_labels(roots: jax.Array, maxima_sorted: jax.Array,
                   vacuum: jax.Array | None, num_maxima: int):
    """Map roots (flat voxel indices of maxima) to dense basin labels.

    Basins are numbered by the row-major position of their first member —
    the discovery order of the reference's serial scan with threads=1
    (methods.py:201-209), so ``bader_maxima``/``bader_charge`` orderings
    match the reference exactly.

    args:
        roots: (nx,ny,nz) int32, output of :func:`resolve_roots`.
        maxima_sorted: (M,) sorted flat indices of the maxima (host-computed).
        vacuum: optional bool mask; vacuum voxels get label -1.
        num_maxima: static M.
    returns:
        labels: (nx,ny,nz) int32 in [-1, M)
        order:  (M,) permutation s.t. maxima_sorted[order] lists maxima in
                label order (label l is the basin of maxima_sorted[order[l]]).
    """
    flat = roots.reshape(-1)
    n = flat.shape[0]
    lab = jnp.searchsorted(maxima_sorted, flat).astype(jnp.int32)
    if vacuum is not None:
        lab = jnp.where(vacuum.reshape(-1), jnp.int32(num_maxima), lab)
    first = jax.ops.segment_min(
        jnp.arange(n, dtype=jnp.int32), lab, num_segments=num_maxima + 1
    )[:num_maxima]
    order = jnp.argsort(first).astype(jnp.int32)
    rank = jnp.argsort(order).astype(jnp.int32)
    labels = jnp.take(rank, lab, mode="fill", fill_value=-1)
    if vacuum is not None:
        labels = jnp.where(vacuum.reshape(-1), jnp.int32(-1), labels)
    return labels.reshape(roots.shape), order


def resolve_roots_auto(parent, best_k=None):
    """Resolve roots: directional-scan flooding on an accelerator
    (:mod:`pybader_tpu.ops.scanflood`, any grid shape, cost set by the
    number of chain bends), pointer doubling on the CPU and on sharded
    arrays.
    """
    from pybader_tpu.ops import scanflood

    single_device = (
        not hasattr(parent, "sharding")
        or len(getattr(parent.sharding, "device_set", [None])) <= 1
    )
    if jax.default_backend() != "cpu" and single_device:
        if best_k is None:
            best_k = scanflood.step_code_from_parent(parent)
        return scanflood.resolve_roots_scan(best_k)
    return resolve_roots(parent)


def label_from_roots(roots, vacuum=None):
    """roots -> (labels, maxima voxel coords in label order).

    Returns (labels int32 array, maxima (M,3) int64 numpy array).  The maxima
    count is data-dependent so this leaves jit for one host round-trip, then
    re-enters a (shape, M)-specialised jitted compaction.
    """
    shape = roots.shape
    self_idx = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    roots_h = np.asarray(roots)
    is_max = roots_h == self_idx
    if vacuum is not None:
        is_max &= ~np.asarray(vacuum)
    maxima_sorted = np.flatnonzero(is_max.reshape(-1)).astype(np.int32)
    m = int(maxima_sorted.shape[0])
    labels, order = compact_labels(
        roots, jnp.asarray(maxima_sorted), vacuum, m
    )
    max_flat = maxima_sorted[np.asarray(order)]
    nx, ny, nz = shape
    mx = max_flat // (ny * nz)
    my = (max_flat // nz) % ny
    mz = max_flat % nz
    maxima = np.stack([mx, my, mz], axis=1).astype(np.int64)
    return labels, maxima


def label_volumes(parent, vacuum=None, best_k=None):
    """parent pointers -> (labels, maxima) via root resolution + compaction."""
    return label_from_roots(resolve_roots_auto(parent, best_k), vacuum)
