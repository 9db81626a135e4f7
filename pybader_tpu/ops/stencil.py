"""Ongrid ascent-pointer stencil.

The reference implements the ongrid method as a serial per-voxel walk: from
each voxel, repeatedly move to the neighbour maximising
``(rho(n) - rho(p)) * w(step) + rho(p)`` until no neighbour is strictly
greater (reference methods.py:87-117), with early exit into already-assigned
voxels and chunk-local windows (methods.py:119-168).

Data-parallel formulation: the ascent target of a voxel is a pure local function
of its 26-neighbourhood, so we compute every voxel's "parent" in one fused
stencil pass, then converge labels with parallel pointer doubling
(:mod:`pybader_tpu.ops.pointer`).  This removes all path buffers, window
extension and cross-chunk merge logic while producing bit-identical basins:
the ongrid walk is path-independent, and the tie-break rules are replicated
exactly (first strictly-greater neighbour in ix,iy,iz scan order wins; the
voxel itself wins all ties at its own density).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pybader_tpu.grid import OFFSETS, SELF_INDEX


def _roll(a: jax.Array, off) -> jax.Array:
    """shifted[p] == a[(p + off) % shape] (periodic neighbour fetch)."""
    return jnp.roll(a, shift=(-off[0], -off[1], -off[2]), axis=(0, 1, 2))


@partial(jax.jit, static_argnames=("weights",))
def ongrid_parent(reference: jax.Array, weights: tuple,
                  vacuum: jax.Array | None = None) -> jax.Array:
    """Per-voxel ascent pointer as a flat int32 index.

    args:
        reference: (nx, ny, nz) density used for partitioning decisions.
        weights: 27 inverse step lengths in OFFSETS scan order (static
                 python tuple so XLA constant-folds them).
        vacuum: optional boolean mask; vacuum voxels become their own parent.
    returns:
        (nx, ny, nz) int32 array of flat voxel indices; ``parent[p] == p``
        iff p is a local maximum under the ongrid rule (or vacuum).
    """
    nx, ny, nz = reference.shape
    rho = reference
    best_val = rho
    best_k = jnp.full(rho.shape, SELF_INDEX, dtype=jnp.uint8)
    for k, off in enumerate(OFFSETS):
        if k == SELF_INDEX:
            continue
        w = weights[k]
        val = (_roll(rho, off) - rho) * w + rho
        upd = val > best_val
        best_val = jnp.where(upd, val, best_val)
        best_k = jnp.where(upd, jnp.uint8(k), best_k)

    offs = np.asarray(OFFSETS, dtype=np.int32)
    ox = jnp.asarray(offs[:, 0])[best_k]
    oy = jnp.asarray(offs[:, 1])[best_k]
    oz = jnp.asarray(offs[:, 2])[best_k]
    x = jax.lax.broadcasted_iota(jnp.int32, rho.shape, 0)
    y = jax.lax.broadcasted_iota(jnp.int32, rho.shape, 1)
    z = jax.lax.broadcasted_iota(jnp.int32, rho.shape, 2)
    px = jnp.remainder(x + ox, nx)
    py = jnp.remainder(y + oy, ny)
    pz = jnp.remainder(z + oz, nz)
    parent = (px * ny + py) * nz + pz
    if vacuum is not None:
        self_idx = (x * ny + y) * nz + z
        parent = jnp.where(vacuum, self_idx, parent)
    return parent


@partial(jax.jit, static_argnames=("weights",))
def ongrid_step_codes(reference: jax.Array, weights: tuple) -> jax.Array:
    """Per-voxel ascent step code (uint8, OFFSETS order; 13 == maximum).

    Memory-bounded variant of :func:`ongrid_parent`: a fori loop over the 27
    offsets with traced roll shifts keeps XLA's live temporaries to a few
    grid-sized buffers (the fully unrolled form materialises ~27 f64 grid
    temporaries: 29 GB at 512^3).
    """
    offs = jnp.asarray(np.asarray(OFFSETS, dtype=np.int32))
    w = jnp.asarray(np.asarray(weights), dtype=reference.dtype)

    def body(k, state):
        best_val, best_k = state
        sh = offs[k]
        rolled = jnp.roll(
            reference, shift=(-sh[0], -sh[1], -sh[2]), axis=(0, 1, 2)
        )
        val = (rolled - reference) * w[k] + reference
        upd = (val > best_val) & (k != SELF_INDEX)
        best_val = jnp.where(upd, val, best_val)
        best_k = jnp.where(upd, k.astype(jnp.uint8), best_k)
        return best_val, best_k

    init = (reference, jnp.full(reference.shape, SELF_INDEX, dtype=jnp.uint8))
    _, best_k = jax.lax.fori_loop(jnp.int32(0), jnp.int32(27), body, init)
    return best_k


@jax.jit
def neargrid_init_codes(reference: jax.Array, bk: jax.Array,
                        t_grad: jax.Array) -> jax.Array:
    """First-neargrid-step codes with ongrid fallback (hybrid init).

    For every voxel, the first step a neargrid trajectory (started at
    rest, dr = 0) would take — reference methods.py:301-363: non-strict
    per-axis flatness test on the central difference, ``T_grad``
    transform, inf-norm normalisation, round-half-away-from-zero plus the
    immediate ``dr`` application (so the composed step is one of the 27
    stencil offsets).  The step is kept only where it STRICTLY ascends
    the density; everywhere else (zero gradient, self step, or a
    non-ascending step) the ongrid code ``bk`` substitutes — the same
    fallback rule the walker applies on revisits (methods.py:340-343,
    411-447).  Ascent-only steps keep the pointer graph acyclic with
    roots exactly the ongrid maxima (``bk == 13``), so the scan-flood
    labeller and the discovery-order renumber run on these codes
    unchanged.

    This is an INITIALISATION for bounded edge refinement, not the full
    trajectory semantics: it captures the first-step boundary shift of
    the neargrid method at stencil cost, and the refinement walker (full
    dr accumulation) fixes the remaining band.  Accuracy at the shipping
    config against native/serial_neargrid.cpp is recorded in PERF.md
    ("Hybrid accuracy").
    """
    rho = reference
    # per-axis central difference, non-strict flatness (methods.py:324)
    grads = []
    for j in range(3):
        up = jnp.roll(rho, -1, j)
        dn = jnp.roll(rho, 1, j)
        axis_flat = (up <= rho) & (dn <= rho)
        grads.append(jnp.where(axis_flat, 0.0, (up - dn) * 0.5))
    gd = [None, None, None]
    for i in range(3):
        gd[i] = sum(t_grad[i, j] * grads[j] for j in range(3))
    mg = jnp.maximum(jnp.maximum(jnp.abs(gd[0]), jnp.abs(gd[1])),
                     jnp.abs(gd[2]))
    use_ongrid = mg < 1e-14
    denom = jnp.where(mg > 0, mg, 1.0)

    def _round_away(x):
        return jnp.trunc(x + jnp.where(x > 0, 0.5, -0.5)).astype(jnp.int8)

    code_ng = jnp.zeros(rho.shape, dtype=jnp.uint8)
    for i in range(3):
        g = gd[i] / denom
        ig = _round_away(g)
        step = ig + _round_away(g - ig.astype(g.dtype))  # in {-1, 0, 1}
        code_ng = code_ng * jnp.uint8(3) + (step + 1).astype(jnp.uint8)

    # keep the step only where it strictly ascends: rho[target] > rho[self]
    offs = jnp.asarray(np.asarray(OFFSETS, dtype=np.int32))

    def body(k, rho_t):
        sh = offs[k]
        rolled = jnp.roll(rho, shift=(-sh[0], -sh[1], -sh[2]),
                          axis=(0, 1, 2))
        return jnp.where(code_ng == k.astype(jnp.uint8), rolled, rho_t)

    rho_t = jax.lax.fori_loop(jnp.int32(0), jnp.int32(27), body, rho)
    keep = (rho_t > rho) & ~use_ongrid
    return jnp.where(keep, code_ng, bk)


@jax.jit
def parent_from_step_codes(best_k: jax.Array,
                           vacuum: jax.Array | None = None) -> jax.Array:
    """Decode step codes to flat int32 parent indices."""
    nx, ny, nz = best_k.shape
    offs = np.asarray(OFFSETS, dtype=np.int32)
    ox = jnp.asarray(offs[:, 0])[best_k]
    oy = jnp.asarray(offs[:, 1])[best_k]
    oz = jnp.asarray(offs[:, 2])[best_k]
    x = jax.lax.broadcasted_iota(jnp.int32, best_k.shape, 0)
    y = jax.lax.broadcasted_iota(jnp.int32, best_k.shape, 1)
    z = jax.lax.broadcasted_iota(jnp.int32, best_k.shape, 2)
    px = jnp.remainder(x + ox, nx)
    py = jnp.remainder(y + oy, ny)
    pz = jnp.remainder(z + oz, nz)
    parent = (px * ny + py) * nz + pz
    if vacuum is not None:
        self_idx = (x * ny + y) * nz + z
        parent = jnp.where(vacuum, self_idx, parent)
    return parent


@jax.jit
def self_index(shape_like: jax.Array) -> jax.Array:
    """Flat index of each voxel of a 3-D array (int32)."""
    nx, ny, nz = shape_like.shape
    x = jax.lax.broadcasted_iota(jnp.int32, shape_like.shape, 0)
    y = jax.lax.broadcasted_iota(jnp.int32, shape_like.shape, 1)
    z = jax.lax.broadcasted_iota(jnp.int32, shape_like.shape, 2)
    return (x * ny + y) * nz + z
