"""Clean-room numpy oracle for golden tests.

Independent, deliberately-naive serial implementation of grid-based Bader
partitioning per Tang, Sanville & Henkelman (2009), written from the
algorithm description to validate the device kernels.  Replicates the semantics
the reference CPU package exhibits with threads=1 (scan order, tie-breaks,
basin numbering by discovery order) without sharing any code with it.
"""
from __future__ import annotations

import numpy as np

OFFSETS = [
    (ix, iy, iz)
    for ix in (-1, 0, 1)
    for iy in (-1, 0, 1)
    for iz in (-1, 0, 1)
]


def gaussian_density(shape, lattice, centers_frac, widths, amps):
    """Periodic sum of gaussians — a synthetic 'charge density' fixture."""
    nx, ny, nz = shape
    fx, fy, fz = np.meshgrid(
        np.arange(nx) / nx, np.arange(ny) / ny, np.arange(nz) / nz,
        indexing="ij",
    )
    frac = np.stack([fx, fy, fz], axis=-1)  # (nx,ny,nz,3)
    rho = np.zeros(shape, dtype=np.float64)
    for c, w, a in zip(centers_frac, widths, amps):
        for sx in (-1, 0, 1):
            for sy in (-1, 0, 1):
                for sz in (-1, 0, 1):
                    d_frac = frac - (np.asarray(c) + np.array([sx, sy, sz]))
                    d_cart = d_frac @ lattice
                    r2 = np.sum(d_cart**2, axis=-1)
                    rho += a * np.exp(-r2 / (2.0 * w**2))
    return rho


def ongrid_step(rho, dist_flat, p):
    """Best ascent neighbour of voxel p (or p itself if p is a maximum).

    First strictly-greater value of (rho(n)-rho(p))*w + rho(p) in scan
    order wins; the voxel itself wins all ties.
    """
    shape = rho.shape
    best_val = rho[p]
    best = p
    for k, off in enumerate(OFFSETS):
        if off == (0, 0, 0):
            continue
        n = tuple((p[d] + off[d]) % shape[d] for d in range(3))
        val = (rho[n] - rho[p]) * dist_flat[k] + rho[p]
        if val > best_val:
            best_val = val
            best = n
    return best


def ongrid_parent_grid(rho, dist_flat):
    """Vectorised best-ascent-neighbour grid, same semantics as ongrid_step.

    For every voxel: the first (scan-order) neighbour whose
    ``(rho_n - rho_p) * w + rho_p`` strictly exceeds every earlier candidate
    and rho_p itself; ties keep the earlier winner; no winner -> self.
    Returns an (nx,ny,nz,3) int array of absolute voxel indices.
    """
    shape = rho.shape
    vals = []
    offs = []
    for k, off in enumerate(OFFSETS):
        if off == (0, 0, 0):
            continue
        rho_n = np.roll(rho, shift=(-off[0], -off[1], -off[2]),
                        axis=(0, 1, 2))
        vals.append((rho_n - rho) * dist_flat[k] + rho)
        offs.append(off)
    vals = np.stack(vals)  # (26, nx, ny, nz)
    best_k = np.argmax(vals, axis=0)  # first max wins, matching scan order
    best_val = np.take_along_axis(vals, best_k[None], axis=0)[0]
    is_self = best_val <= rho
    idx = np.indices(shape)  # (3, nx, ny, nz)
    offs = np.asarray(offs)  # (26, 3)
    parent = np.empty(shape + (3,), dtype=np.int64)
    for d in range(3):
        parent[..., d] = np.where(
            is_self, idx[d], (idx[d] + offs[best_k, d]) % shape[d]
        )
    return parent


def ongrid_oracle(rho, dist_flat, vacuum=None):
    """Serial ongrid partition with discovery-order basin numbering.

    returns (labels int32 [-1 vacuum, 0..M-1], maxima list of voxel tuples
    in discovery order).
    """
    shape = rho.shape
    parent = ongrid_parent_grid(rho, dist_flat)
    labels = np.full(shape, -9, dtype=np.int32)  # -9 == unassigned
    if vacuum is not None:
        labels[vacuum] = -1
    maxima = []
    for p in np.ndindex(shape):
        if labels[p] != -9:
            continue
        path = [p]
        cur = p
        while True:
            nxt = tuple(parent[cur])
            if nxt == cur:
                lab = len(maxima)
                maxima.append(cur)
                break
            if labels[nxt] != -9:
                lab = labels[nxt]
                break
            path.append(nxt)
            cur = nxt
        for q in path:
            labels[q] = lab
    return labels, maxima


def ongrid_oracle_fast(rho, dist_flat, vacuum=None):
    """Vectorised ongrid oracle, exactly equivalent to :func:`ongrid_oracle`.

    Path-following with label adoption assigns every voxel the label of its
    ascent root (an adopted voxel lies on the same ascent path, so shares
    the root), and discovery order equals first-occurrence order of roots in
    the C scan — both facts asserted against the serial oracle in
    tests/test_oracle_equiv.py.  Ascent never enters vacuum (steps are
    strictly uphill in rho; vacuum is the low set), so adoption of -1 cannot
    occur.
    """
    shape = rho.shape
    n = int(np.prod(shape))
    parent = ongrid_parent_grid(rho, dist_flat)
    strides = np.array(
        [shape[1] * shape[2], shape[2], 1], dtype=np.int64)
    parent_flat = (parent @ strides).reshape(-1)
    if vacuum is not None:
        self_idx = np.arange(n, dtype=np.int64)
        parent_flat = np.where(vacuum.reshape(-1), self_idx, parent_flat)
    roots = parent_flat
    while True:
        nxt = roots[roots]
        if np.array_equal(nxt, roots):
            break
        roots = nxt
    labels = np.full(n, -1, dtype=np.int32)
    nonvac = (np.ones(n, dtype=bool) if vacuum is None
              else ~vacuum.reshape(-1))
    uniq, first = np.unique(roots[nonvac], return_index=True)
    order = np.argsort(first, kind="stable")  # discovery order of roots
    uniq_ordered = uniq[order]
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    labels[nonvac] = rank[np.searchsorted(uniq, roots[nonvac])]
    maxima = [tuple(int(v) for v in np.unravel_index(int(r), shape))
              for r in uniq_ordered]
    return labels.reshape(shape), maxima


def neargrid_trajectory(rho, dist_flat, t_grad, start, stop_mask=None,
                        strict_grad=False, max_steps=100000):
    """Serial neargrid trajectory from one voxel (spec for the walker).

    Walks with central-difference gradient + dr correction; gradient-zero or
    a period-1/2 revisit falls back to an ongrid step with dr reset; stops on
    arrival at a stop_mask voxel or an ongrid maximum.  Returns the final
    voxel.
    """
    shape = rho.shape
    pos = start
    prev = None
    dr = np.zeros(3)
    for _ in range(max_steps):
        if stop_mask is not None and stop_mask[pos]:
            return pos
        if ongrid_step(rho, dist_flat, pos) == pos:
            return pos
        grad = np.zeros(3)
        rp = rho[pos]
        for j in range(3):
            up = list(pos)
            up[j] = (up[j] + 1) % shape[j]
            dn = list(pos)
            dn[j] = (dn[j] - 1) % shape[j]
            ru, rd = rho[tuple(up)], rho[tuple(dn)]
            if strict_grad:
                flat = ru < rp and rd < rp
            else:
                flat = ru <= rp and rd <= rp
            grad[j] = 0.0 if flat else (ru - rd) / 2.0
        gd = t_grad @ grad
        mg = np.max(np.abs(gd))
        if mg < 1e-14:
            nxt = ongrid_step(rho, dist_flat, pos)
            dr[:] = 0.0
        else:
            g = gd / mg
            step = np.trunc(g + np.where(g > 0, 0.5, -0.5)).astype(int)
            dr = dr + g - step
            corr = np.trunc(dr + np.where(dr > 0, 0.5, -0.5)).astype(int)
            dr = dr - corr
            nxt = tuple(
                (pos[d] + step[d] + corr[d]) % shape[d] for d in range(3)
            )
            if nxt == pos or nxt == prev:
                nxt = ongrid_step(rho, dist_flat, pos)
                dr[:] = 0.0
        prev = pos
        pos = nxt
    return pos


def edge_scan(rho, labels):
    """Serial edge classification: returns known int8 grid (2/-1/-2/0)."""
    shape = rho.shape
    known = np.zeros(shape, dtype=np.int8)
    edge = np.zeros(shape, dtype=bool)
    for p in np.ndindex(shape):
        if labels[p] == -1:
            continue
        is_edge = False
        is_max = True
        for off in OFFSETS:
            if off == (0, 0, 0):
                continue
            n = tuple((p[d] + off[d]) % shape[d] for d in range(3))
            if labels[n] == -1:
                continue
            if labels[n] != labels[p]:
                is_edge = True
            if rho[n] > rho[p]:
                is_max = False
        edge[p] = is_edge and not is_max
    for p in np.ndindex(shape):
        if labels[p] != -1:
            known[p] = 2
    for p in np.ndindex(shape):
        if edge[p]:
            for off in OFFSETS:
                if off == (0, 0, 0):
                    continue
                n = tuple((p[d] + off[d]) % shape[d] for d in range(3))
                if not edge[n]:
                    known[n] = -1
    known[edge] = -2
    return known


def neargrid_oracle(rho, dist_flat, t_grad, vacuum=None):
    """Serial order-dependent neargrid partition (spec: reference
    methods.py:222-611 with threads=1, clean-room).

    Scan-order walks with label adoption: a walk terminating at an assigned
    ongrid maximum or at a known==2 voxel adopts that voxel's current label;
    an unassigned maximum starts a new basin (discovery order).  After each
    walk the path is assigned and path-neighbourhood voxels whose six axis
    neighbours all share their (assigned) label are marked known==2 —
    becoming terminators and scan skips.  Assigned-but-not-known voxels are
    re-walked when the scan reaches them (the raw-pass label errors the
    reference's refinement stage exists to fix).

    returns (labels int32 [-1 vacuum, 0..M-1], maxima list in discovery
    order).
    """
    shape = rho.shape
    volumes = np.zeros(shape, dtype=np.int32)  # 0 unassigned, >=1 basins
    if vacuum is not None:
        volumes[vacuum] = -1
    known = np.zeros(shape, dtype=np.int8)
    maxima = []

    def interior_mark(pv):
        """known[pv] = 2 when pv is assigned and axis-neighbour-uniform.

        Mirrors the reference's window-bounds quirk (methods.py:556-603):
        neighbours are NOT wrapped — a voxel on the array boundary never
        qualifies as known (its out-of-window neighbour fails the test).
        """
        vol = volumes[pv]
        if -2 < vol < 1:  # unassigned or vacuum
            return
        for h in range(3):
            for s in (1, -1):
                n = pv[h] + s
                if not (0 <= n < shape[h]):
                    return
                q = list(pv)
                q[h] = n
                if volumes[tuple(q)] != vol:
                    return
        known[pv] = 2

    for i in np.ndindex(shape):
        if volumes[i] == -1 or known[i] == 2:
            continue
        known[i] = 1
        path = [i]
        pos = i
        dr = np.zeros(3)
        final = None
        vol_num = None
        while True:
            grad = np.zeros(3)
            rp = rho[pos]
            for j in range(3):
                up = list(pos)
                up[j] = (up[j] + 1) % shape[j]
                dn = list(pos)
                dn[j] = (dn[j] - 1) % shape[j]
                ru, rd = rho[tuple(up)], rho[tuple(dn)]
                grad[j] = 0.0 if (ru <= rp and rd <= rp) else (ru - rd) / 2.0
            gd = t_grad @ grad
            mg = np.max(np.abs(gd))
            if mg < 1e-14:
                nxt = pos
            else:
                g = gd / mg
                step = np.trunc(g + np.where(g > 0, 0.5, -0.5)).astype(int)
                dr = dr + g - step
                corr = np.trunc(dr + np.where(dr > 0, 0.5, -0.5)).astype(int)
                dr = dr - corr
                nxt = tuple(
                    (pos[d] + step[d] + corr[d]) % shape[d] for d in range(3)
                )
            if known[nxt] == 1:  # already on this path
                dr[:] = 0.0
                nxt = ongrid_step(rho, dist_flat, pos)
                if nxt == pos:  # ongrid maximum
                    final = pos
                    vol_num = int(volumes[pos])  # 0 => new basin
                    break
            if known[nxt] == 2:
                final = nxt
                vol_num = int(volumes[nxt])
                break
            path.append(nxt)
            known[nxt] = 1
            pos = nxt
        if vol_num == 0:
            maxima.append(final)
            vol_num = len(maxima)  # 1-based during the scan
        for q in path:
            volumes[q] = vol_num
            if known[q] != 2:
                known[q] = 0
        for q in path:
            for k in range(3):
                for s in (1, -1):
                    n = q[k] + s
                    if not (0 <= n < shape[k]):
                        continue  # reference skips out-of-window neighbours
                    pv = list(q)
                    pv[k] = n
                    interior_mark(tuple(pv))
    labels = np.where(volumes > 0, volumes - 1, volumes).astype(np.int32)
    return labels, maxima


def edge_check_scan(known, rho, labels, skip_vacuum=False):
    """Serial 'changed'-mode edge re-scan (spec: reference refinement.py
    :408-508 semantics, clean-room).

    Iterates voxels with known == -2 in C scan order, reclassifying each
    27-neighbourhood in place: non-edge -> -1, edge-and-not-max -> -3 (new
    edge; its own known>=0 neighbours -> -1); finally -3 -> -2.  The scan
    order matters (an early reclassification can demote a later -2 voxel
    before it is visited), so this is a faithful sequential loop.

    The reference quirk: unlike edge_find, this scan does NOT skip vacuum
    voxels as edge candidates (refinement.py:448 reads volumes[pe] without a
    -1 check), so 'changed'-mode refinement can reassign vacuum to basins.
    ``skip_vacuum=True`` applies the deliberate fix the production pipeline
    uses (ops/edges.py docstring).
    """
    shape = rho.shape

    def classify(pe):
        vol = labels[pe]
        is_edge = False
        is_max = True
        for off in OFFSETS:
            if off == (0, 0, 0):
                continue
            n = tuple((pe[d] + off[d]) % shape[d] for d in range(3))
            if labels[n] == -1:
                continue
            if labels[n] != vol:
                is_edge = True
            if rho[n] > rho[pe]:
                is_max = False
        return is_edge, is_max

    for i in np.ndindex(shape):
        if known[i] != -2:
            continue
        for off_e in OFFSETS:
            pe = tuple((i[d] + off_e[d]) % shape[d] for d in range(3))
            if skip_vacuum and labels[pe] == -1:
                continue
            is_edge, is_max = classify(pe)
            if not is_edge:
                known[pe] = -1
            elif not is_max:
                if known[pe] != -3:
                    known[pe] = -3
                    for off in OFFSETS:
                        if off == (0, 0, 0):
                            continue
                        n = tuple(
                            (pe[d] + off[d]) % shape[d] for d in range(3))
                        if known[n] >= 0:
                            known[n] = -1
    known[known == -3] = -2
    return known


def refine_walk(rho, dist_flat, t_grad, labels, rknown, start,
                max_steps=100000):
    """Re-walk one edge voxel (spec: reference refinement.py:16-322).

    Neargrid steps with dr correction; a gradient-zero step proposes the
    current voxel, and any step landing on the current path triggers an
    ongrid correction step with dr reset — terminating immediately if the
    voxel is an ongrid maximum.  Arrival at an rknown == 2 voxel terminates.
    Returns the terminating voxel whose (current) label the start adopts.
    """
    shape = rho.shape
    pos = start
    dr = np.zeros(3)
    on_path = {start}
    for _ in range(max_steps):
        grad = np.zeros(3)
        rp = rho[pos]
        for j in range(3):
            up = list(pos)
            up[j] = (up[j] + 1) % shape[j]
            dn = list(pos)
            dn[j] = (dn[j] - 1) % shape[j]
            ru, rd = rho[tuple(up)], rho[tuple(dn)]
            grad[j] = 0.0 if (ru < rp and rd < rp) else (ru - rd) / 2.0
        gd = t_grad @ grad
        mg = np.max(np.abs(gd))
        if mg < 1e-14:
            nxt = pos
        else:
            g = gd / mg
            step = np.trunc(g + np.where(g > 0, 0.5, -0.5)).astype(int)
            dr = dr + g - step
            corr = np.trunc(dr + np.where(dr > 0, 0.5, -0.5)).astype(int)
            dr = dr - corr
            nxt = tuple(
                (pos[d] + step[d] + corr[d]) % shape[d] for d in range(3)
            )
        if nxt in on_path:
            dr[:] = 0.0
            nxt = ongrid_step(rho, dist_flat, pos)
            if nxt == pos:
                return pos  # ongrid maximum: adopt its current label
        if rknown[nxt] == 2:
            return nxt
        on_path.add(nxt)
        pos = nxt
    raise RuntimeError("refine_walk did not terminate")


def refine_oracle(rho, dist_flat, t_grad, labels, mode, iters,
                  return_history=False, skip_vacuum_edges=False):
    """Serial refinement driver (spec: reference thread_handlers.py:128-236).

    Iteration 1 walks every edge voxel from a fresh edge scan; subsequent
    iterations re-scan either all voxels ('all') or the changed-edge
    neighbourhoods ('changed').  Walks within an iteration are independent
    (terminations only read labels at voxels that cannot change), so updates
    are applied after each sweep.  ``iters < 0`` runs to convergence.
    Returns (labels, total_changed) or, with return_history, per-iteration
    changed counts as the third element.
    """
    labels = labels.copy()
    known = edge_scan(rho, labels)
    total_changed = 0
    history = []
    it = 0
    while iters < 0 or it < int(iters):
        it += 1
        if it > 1:
            if str(mode).lower() == "all":
                known = edge_scan(rho, labels)
            else:
                known = edge_check_scan(known, rho, labels,
                                        skip_vacuum=skip_vacuum_edges)
        edges = [tuple(p) for p in np.argwhere(known == -2)]
        if not edges:
            break
        rknown = known.copy()
        updates = []
        for p in edges:
            term = refine_walk(rho, dist_flat, t_grad, labels, rknown, p)
            new_lab = labels[term]
            if new_lab != labels[p]:
                updates.append((p, new_lab))
            else:
                known[p] = -1  # unchanged edges leave the changed set
        for p, lab in updates:
            labels[p] = lab
        changed = len(updates)
        total_changed += changed
        history.append(changed)
        if changed == 0:
            break
    if return_history:
        return labels, total_changed, history
    return labels, total_changed


def charge_sums(density, labels, voxel_vol, num_segments):
    charge = np.zeros(num_segments)
    volume = np.zeros(num_segments)
    for lab in range(num_segments):
        mask = labels == lab
        charge[lab] = density[mask].sum() * voxel_vol
        volume[lab] = mask.sum() * voxel_vol
    return charge, volume
