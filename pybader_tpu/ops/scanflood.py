"""Directional-scan label flooding: long-chain basin labelling in O(bends).

Flooding labels down the ascent pointers one step per pass costs a chain
of length L about L full-grid passes — fine for compact basins,
catastrophic for smooth interstitial regions whose gradient-flow chains
span hundreds of voxels.

This module floods labels with *plane scans* instead: a +x scan processes
x-planes in ascending order, each voxel adopting its parent's label where
the parent lies in the just-updated previous plane (Gauss-Seidel at voxel
granularity).  A single scan therefore propagates a label along every
chain segment whose x-steps are monotone decreasing — the whole segment
in ONE grid traversal.  Six scans (+-x, +-y, +-z) advance every possible
link direction; chains need one extra round per direction *bend*, and
gradient-flow paths in smooth densities bend a handful of times.  Each
scan is one lax.scan over planes (plain XLA, any grid shape), so the
total cost is (number of bends) x (a few full-grid passes).

Correctness: a voxel's value changes at most once, from 0 to its root's
label (each voxel's ascent chain reaches exactly one root, so the first
label delivered along the chain is correct; scan order only affects
*when*, never *what*).  Periodic wrap across the scan axis is handled by
seeding the carry with the opposite boundary plane of the previous state
(one extra round of latency for chains that cross the boundary).

Replaces: serial path-following with early exit in the reference
(pybader's methods.py:15-219) — the data-parallel equivalent of its
path-compression work efficiency.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("axis",))
def _axis_codes(bk, axis: int):
    """Split step codes into (scan-axis component, in-plane code).

    component: 0/1/2 for parent offset -1/0/+1 along ``axis``;
    in-plane code: (c_a1 * 3 + c_a2) over the remaining two axes in
    ascending axis order — matching the roll order used by the scans.
    """
    cx = bk // 9
    cy = (bk // 3) % 3
    cz = bk % 9 % 3
    comps = (cx, cy, cz)
    a1, a2 = (a for a in range(3) if a != axis)
    return comps[axis], comps[a1] * jnp.uint8(3) + comps[a2]


def _adopt(own, cand):
    return jnp.where((own == 0) & (cand > 0), cand, own)


def _sel9(src, inplane):
    """Parent value for in-plane offsets: src[y+dy, z+dz] per code."""
    out = src  # code 4: dy = dz = 0
    for code in range(9):
        dy, dz = code // 3 - 1, code % 3 - 1
        if dy == 0 and dz == 0:
            continue
        rolled = jnp.roll(src, (-dy, -dz), (0, 1))
        out = jnp.where(inplane == jnp.uint8(code), rolled, out)
    return out


@partial(jax.jit, static_argnames=("axis", "reverse", "ppstep"),
         donate_argnums=(0,))
def scan_flood_dir(labels, comp, inplane, axis: int, reverse: bool,
                   ppstep: int = 1):
    """One directional flood scan along ``axis``.

    args:
        labels: int32 grid (0 = unlabeled; donated).
        comp / inplane: outputs of :func:`_axis_codes` for this axis.
        ppstep: planes processed per scan step (must divide the axis
            length).  Within a step the planes update sequentially, so
            the result is BIT-IDENTICAL to ppstep=1 — this is purely a
            latency knob: every lax.scan step pays a fixed launch
            overhead, and fewer, fatter steps amortise it.
    returns the updated labels grid.
    """
    lm = jnp.moveaxis(labels, axis, 0)
    cm = jnp.moveaxis(comp, axis, 0)
    im = jnp.moveaxis(inplane, axis, 0)
    # the plane "ahead" in scan direction, old values (for parents that
    # sit against the scan direction): in plane order, the next plane is
    # always un-updated when this one is processed, whatever the grouping
    ahead = jnp.roll(lm, 1 if reverse else -1, 0)
    npl = lm.shape[0]
    assert npl % ppstep == 0, (npl, ppstep)
    grp = lambda a: a.reshape(  # noqa: E731
        (npl // ppstep, ppstep) + a.shape[1:])
    # the parent component on the just-updated side of the scan
    upd = jnp.uint8(2) if reverse else jnp.uint8(0)

    def step(carry, xs):
        own, ahead_old, c, ip = xs
        behind = carry  # just-updated previous plane (scan direction)
        outs = [None] * ppstep
        order = range(ppstep - 1, -1, -1) if reverse else range(ppstep)
        for j in order:
            # descending scan: parent offset +1 is the updated side
            cand = jnp.where(
                c[j] == upd, _sel9(behind, ip[j]),
                jnp.where(c[j] == jnp.uint8(1), _sel9(own[j], ip[j]),
                          _sel9(ahead_old[j], ip[j])))
            new = _adopt(own[j], cand)
            outs[j] = new
            behind = new
        return behind, jnp.stack(outs)

    init = lm[0] if reverse else lm[-1]  # periodic wrap, previous state
    _, planes = jax.lax.scan(step, init,
                             (grp(lm), grp(ahead), grp(cm), grp(im)),
                             reverse=reverse)
    return jnp.moveaxis(planes.reshape(lm.shape), 0, axis)


@jax.jit
def _n_unlabeled(labels):
    return jnp.sum((labels == 0).astype(jnp.int32))


def _ppstep_for(n: int) -> int:
    """Planes-per-step choice: the largest supported divisor of ``n``.

    ppstep > 1 pays on an accelerator (per-step launch overhead); on the
    CPU the 8x-unrolled plane body just multiplies compile time for the
    test grids, so the host backend stays at 1.
    """
    if jax.default_backend() == "cpu":
        return 1
    for p in (8, 4, 2):
        if n % p == 0:
            return p
    return 1


@partial(jax.jit, donate_argnums=(0,), static_argnames=("pps",))
def _round_xla(lab, codes0, codes1, codes2, pps):
    """One full flood round (six directional scans) as a single program.

    The unlabeled count rides along so the convergence check costs one
    scalar fetch, not a dispatch.  returns (labels, n_unlabeled).
    """
    for axis, (comp, inplane) in enumerate((codes0, codes1, codes2)):
        lab = scan_flood_dir(lab, comp, inplane, axis, False, pps[axis])
        lab = scan_flood_dir(lab, comp, inplane, axis, True, pps[axis])
    return lab, jnp.sum((lab == 0).astype(jnp.int32))


def flood_rounds(labels, bk, max_rounds: int = 64, progress=None):
    """Alternating-direction scan rounds until every voxel is labeled.

    One round = scans along +x, -x, +y, -y, +z, -z.  The unlabeled count
    strictly decreases while any remains (every chain's labeled frontier
    has a link some direction advances), so termination is guaranteed;
    smooth densities converge in a few rounds.

    The convergence fetch is software-pipelined: round r+1 is dispatched
    before round r's unlabeled count is read on the host, so the device
    round-trip rides under real scan time (the one speculative round after
    convergence adopts nothing; its result is returned unchanged).
    """
    codes = [_axis_codes(bk, axis) for axis in range(3)]
    pps = tuple(_ppstep_for(labels.shape[axis]) for axis in range(3))
    # once the unlabeled count drops below this, check convergence with a
    # blocking scalar fetch instead of speculatively dispatching another
    # round: the tail of the decay is steep, and a wasted full round costs
    # more than one scalar fetch
    small_thresh = max(65536, labels.size // 512)

    prev_cnt = None
    left = -1  # unlabeled count from the most recently FETCHED round
    for r in range(max_rounds):
        if prev_cnt is not None and 0 <= left <= small_thresh:
            left = int(prev_cnt)  # blocking convergence check
            if progress is not None:
                progress(r - 1, left)
            if left == 0:
                return labels
        labels, cnt = _round_xla(labels, *codes, pps)
        if prev_cnt is not None and not (0 <= left <= small_thresh):
            left = int(prev_cnt)  # overlaps the round just dispatched
            if progress is not None:
                progress(r - 1, left)
            if left == 0:
                return labels  # that round was the no-op speculation
        prev_cnt = cnt
    left = int(prev_cnt)
    if progress is not None:
        progress(max_rounds - 1, left)
    if left == 0:
        return labels
    raise RuntimeError(
        f"scan flood did not converge in {max_rounds} rounds "
        f"({left} voxels unlabeled) — is the pointer graph acyclic?")


@jax.jit
def step_code_from_parent(parent: jax.Array) -> jax.Array:
    """Recover the OFFSETS step code (uint8) from a one-step pointer array."""
    nx, ny, nz = parent.shape
    x = jax.lax.broadcasted_iota(jnp.int32, parent.shape, 0)
    y = jax.lax.broadcasted_iota(jnp.int32, parent.shape, 1)
    z = jax.lax.broadcasted_iota(jnp.int32, parent.shape, 2)
    px = parent // (ny * nz)
    py = (parent // nz) % ny
    pz = parent % nz
    ox = jnp.remainder(px - x + 1, nx) - 1
    oy = jnp.remainder(py - y + 1, ny) - 1
    oz = jnp.remainder(pz - z + 1, nz) - 1
    return ((ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("has_vacuum",))
def _flood_seed(best_k, vacuum, has_vacuum):
    """Flood-seed values: 0 unlabeled, k in [1..M] basin k-1, M+1 vacuum.

    Labels are 1-based ranks of the maxima in ascending flat-index order
    (blocked cumsum), so the decoded labels match the pointer-doubling
    ordering exactly.
    """
    from pybader_tpu.ops.reductions import cumsum_blocked

    shape = best_k.shape
    is_self = best_k == jnp.uint8(13)
    is_max = (is_self & ~vacuum) if has_vacuum else is_self
    flat_max = is_max.reshape(-1)
    ranks = cumsum_blocked(flat_max.astype(jnp.int32)).reshape(shape)
    n_maxima = jnp.sum(flat_max.astype(jnp.int32))
    seed = jnp.where(is_max, ranks, jnp.int32(0))
    if has_vacuum:
        seed = jnp.where(vacuum, n_maxima + jnp.int32(1), seed)
    return seed, is_max, n_maxima


@jax.jit
def _flood_decode(out, n_max_dev):
    """Flooded values -> final labels (0-based, vacuum -1)."""
    labels = out - jnp.int32(1)
    return jnp.where(labels == n_max_dev, jnp.int32(-1), labels)


def labels_scanflood(best_k, vacuum=None, progress=None):
    """Dense basin labels by directional-scan flooding.

    Labels are numbered by maximum flat index (ascending), vacuum -1.
    Shape-agnostic (no kernel tiling constraints).

    returns (labels int32 grid, n_maxima int).
    """
    with jax.enable_x64(False):
        has_vac = vacuum is not None
        seed, _is_max, n_max_dev = _flood_seed(
            best_k, vacuum if has_vac else best_k, has_vac)
        out = flood_rounds(seed, best_k, progress=progress)
        labels = _flood_decode(out, n_max_dev)
        n_maxima = int(n_max_dev)
    return labels, n_maxima


@jax.jit
def _root_seed(best_k):
    """Seed for root resolution: every self-step voxel (maxima AND vacuum)
    is its own root; flooding delivers root_flat+1 to its whole basin."""
    shape = best_k.shape
    nx, ny, nz = shape
    x = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    y = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    self_idx = (x * ny + y) * nz + z
    is_self = best_k == jnp.uint8(13)
    return jnp.where(is_self, self_idx + jnp.int32(1), jnp.int32(0))


def resolve_roots_scan(best_k, progress=None):
    """Ascent-pointer roots via directional-scan flooding (any shape).

    Same result as :func:`pybader_tpu.ops.pointer.resolve_roots` on the
    decoded parents: (nx,ny,nz) int32 flat root indices.
    """
    with jax.enable_x64(False):
        seed = _root_seed(best_k)
        out = flood_rounds(seed, best_k, progress=progress)
        return out - jnp.int32(1)
