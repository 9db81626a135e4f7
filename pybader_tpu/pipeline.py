"""Host-orchestrated partitioning pipelines.

This is the data-parallel replacement for the reference's thread scheduler
(pybader's thread_handlers.py): instead of splitting the grid
into per-thread chunks with window extension and a merge protocol, the whole
grid lives on device and each stage is a jitted program; the only host
round-trips are data-dependent sizes (number of maxima, edge-voxel lists)
which become static shapes of follow-up jits.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pybader_tpu.ops import edges as edges_ops
from pybader_tpu.ops import neargrid as neargrid_ops
from pybader_tpu.ops.pointer import (
    label_from_roots, label_volumes, resolve_roots_auto,
)
from pybader_tpu.ops.stencil import (
    neargrid_init_codes, ongrid_step_codes, parent_from_step_codes,
)


def _parent_and_codes(reference, vacuum, weights):
    """Step codes + decoded parents (memory-bounded stencil).

    Vacuum voxels are forced to the self step so they never move.
    """
    bk = ongrid_step_codes(reference, tuple(weights))
    if vacuum is not None:
        bk = jnp.where(vacuum, jnp.uint8(13), bk)
    parent = parent_from_step_codes(bk)
    return parent, bk

METHODS = ["ongrid", "neargrid"]
REFINEMENT_METHODS = ["neargrid"]

# Default batch of trajectories walked in lockstep (full-grid neargrid init).
_WALK_BATCH = 1 << 21


def _use_scanflood():
    """Label route: directional-scan flooding plus discovery renumbering
    on an accelerator, pointer doubling plus compaction on the CPU.  Both
    give identical labels (tests/test_gpu_route.py).  On an H100 pointer
    doubling resolved 384^3 roots in 3.6 ms against the flood's 59.5 ms
    (PERF.md), so which route the GPU should take is open."""
    return jax.default_backend() != "cpu"


def _labels_from_codes(bk, vac, progress=None):
    """Step codes (vacuum already forced to the self step) -> (labels,
    maxima) in discovery order, by the backend's label route."""
    from pybader_tpu.ops import scanflood

    if not _use_scanflood():
        return label_volumes(parent_from_step_codes(bk), vac, bk)
    tick = None
    if progress is not None:
        tick = lambda r, left: progress(  # noqa: E731
            f"flood round {r + 1}: {left} voxels unresolved")
    labels_mo, n_max = scanflood.labels_scanflood(bk, vac, progress=tick)
    is_max = bk == jnp.uint8(13)
    if vac is not None:
        is_max = is_max & ~vac
    n_max = max(int(n_max), 1)
    if n_max > 4096:
        # degenerate basin counts: the renumber sweeps cost a grid pass
        # per 8 labels, so fall back to the compaction path
        return label_volumes(parent_from_step_codes(bk), vac, bk)
    iota = jnp.arange(int(np.prod(bk.shape)), dtype=jnp.int32).reshape(
        bk.shape)
    return renumber_discovery(labels_mo, is_max, vac, n_max, iota)


def _partition_nginit(reference, vac, weights, t_grad, progress=None):
    """Neargrid-first-step flood partition (the hybrid initialisation).

    Same flow as the ongrid partition, on different step codes: each
    voxel's pointer is the first step a neargrid trajectory would take
    where that step strictly ascends, the ongrid step elsewhere
    (ops/stencil.neargrid_init_codes).  Roots, maxima and discovery-order
    numbering are identical to the ongrid partition; only basin
    membership near watersheds shifts — towards the reference neargrid
    method's boundaries, so the bounded refinement that follows has less
    to fix (one internal iteration instead of the ongrid init's three
    at a dense 384^3).
    """
    bk_og = ongrid_step_codes(reference, tuple(weights))
    bk = neargrid_init_codes(reference, bk_og, jnp.asarray(t_grad))
    if vac is not None:
        bk = jnp.where(vac, jnp.uint8(13), bk)
    return _labels_from_codes(bk, vac, progress)


def renumber_discovery(labels_mo, is_max, vac, n_max: int, iota):
    """Renumber arbitrary consistent basin ids to discovery order.

    Discovery order = ascending first (minimum flat-index) member per basin
    — the order the reference's serial threads=1 scan discovers maxima
    (methods.py:201-209).  All full-grid work is masked sweeps (sharding-
    friendly: elementwise selects + tree reductions, no gathers/scatters).

    ``is_max`` is the non-vacuum local-maximum mask (the self step of the
    ascent stencil).  ``iota`` is the global flat-index grid, passed in so
    callers can supply an already-sharded one.  returns (labels, maxima
    (M,3) int64).
    """
    from pybader_tpu.ops import reductions

    shape = labels_mo.shape
    nx, ny, nz = shape
    first_member, max_pos = reductions.masked_min_pair(
        iota, labels_mo, is_max, n_max
    )
    first_h = np.asarray(first_member)
    order = np.argsort(first_h, kind="stable").astype(np.int32)
    rank = np.argsort(order, kind="stable").astype(np.int32)
    labels = reductions.remap_sweep(labels_mo, jnp.asarray(rank), n_max)
    max_flat = np.asarray(max_pos)[order]
    maxima = np.stack(
        [max_flat // (ny * nz), (max_flat // nz) % ny, max_flat % nz],
        axis=1,
    ).astype(np.int64)
    return labels, maxima


def partition_ongrid(reference, vacuum, weights, mesh=None, progress=None):
    """Ongrid partition: stencil parents + pointer-chain resolution.

    args:
        reference: (nx,ny,nz) density (device or numpy, f64).
        vacuum: bool mask or None.
        weights: 27 distance weights (OFFSETS order), tuple of floats.
        mesh: optional jax.sharding.Mesh — shard the grid and run the
            multi-device pipeline (parallel/sharded.py); labels are
            voxel-identical to the single-device result.
        progress: optional callback(str) for live stage ticks (flood
            rounds); the CLI/API wires this to an in-place console line
            (reference analog: the counter-polling tqdm thread,
            utils.py:107-142).
    returns:
        (labels int32 device array [-1=vacuum, 0..M-1 basins],
         maxima (M,3) int64 voxel indices in discovery order)
    """
    if mesh is not None and len(mesh.devices.reshape(-1)) > 1:
        from pybader_tpu.parallel.sharded import sharded_partition

        return sharded_partition(mesh, reference, vacuum, weights)
    reference = jnp.asarray(reference)
    vac = None if vacuum is None else jnp.asarray(vacuum)
    bk = ongrid_step_codes(reference, tuple(weights))
    if vac is not None:
        bk = jnp.where(vac, jnp.uint8(13), bk)
    return _labels_from_codes(bk, vac, progress)


# Above this voxel count, method='neargrid' initialises with a
# neargrid-first-step flood and applies bounded neargrid edge refinement
# instead of walking every voxel's trajectory (per-voxel trajectory
# walking is a chain of dependent row gathers: ~60 steps for each of the
# 56M voxels of a 384^3 grid).
_NEARGRID_HYBRID_THRESHOLD = 1 << 24
# Base internal refinement budget of the ongrid-init hybrid per 128
# voxels of grid extent (see _hybrid_internal_budget).  This mirrors the
# reference's own sanctioned approximation: its 'speed' profile ships
# ongrid + 3 neargrid refinement iterations in place of the neargrid
# method (reference entry_points.py:340-345).  Running to convergence
# instead is NOT the default because flat interstitial regions can keep
# re-contesting the watershed for dozens of iterations (on a dense
# 384^3 field changed counts decay ~0.74x/iteration from 3.2M — a
# convergence the reference's default config never pays either); callers
# who want the converged ground-truth state pass refine_mode=
# ('changed', -1) (the reference's own accuracy-harness definition of
# truth, examples/compare_methods.py:16).
_NEARGRID_HYBRID_REFINE = ("changed", 3)
# Internal budget on top of the neargrid-first-step init (the
# single-device default): the init already lands the first-step boundary
# shift, so one full-edge walk before the user's refine_mode chains on
# suffices — accuracy vs the serial reference at the shipping config is
# recorded in PERF.md ("Hybrid accuracy").
_NGINIT_HYBRID_REFINE = ("changed", 1)


def _hybrid_internal_budget(shape):
    """Resolution-scaled internal refinement budget for the hybrid init.

    The init's mislabeled band has a fixed PHYSICAL width, and edge
    refinement moves the watershed front ~1 voxel per iteration — so a
    fixed iteration count loses accuracy linearly with resolution
    (0% voxels off at 48^3, 0.03% at 128^3, 1.2% at 192^3 under the
    old fixed ('changed', 3); PERF.md "Hybrid accuracy").
    Scaling the budget with the largest grid extent keeps the covered
    band a fixed physical width: 3 iterations at <=128 voxels extent
    (the accurate base), plus 3 per extra 128 voxels.  The extra
    iterations are cheap: the changed set decays ~0.74x per iteration,
    so late iterations walk small candidate lists.
    """
    e = max(shape)
    return ("changed", _NEARGRID_HYBRID_REFINE[1] * max(1, -(-e // 128)))

# Largest changed-set 27-neighbourhood candidate list the refinement loop
# will materialise for the sorted-filter fast path; bigger changed sets
# fall back to the full-grid compaction sort (bounded at n int32 keys).
_CAND_CAP = 1 << 26

# Largest walker bucket walked in one dispatch; bigger edge sets walk in
# chunks of this size, so the per-walk state stays bounded next to the
# rows buffer whatever the edge count.  Module constant so tests can
# exercise the chunked path at small scale.
_WALK_CHUNK_CAP = 1 << 23


def partition_neargrid(reference, vacuum, weights, t_grad,
                       batch: int = _WALK_BATCH,
                       full_trajectories: bool | None = None,
                       mesh=None, progress=None, carry_out=None,
                       stats=None):
    """Neargrid partition: every voxel walks its full trajectory.

    Order-independent formulation of reference methods.py:222-611 (see
    ops/neargrid.py docstring for the documented deviation).  On grids
    above ~16M voxels (or with full_trajectories=False, or on a multi-chip
    mesh) a hybrid substitutes: ongrid initialisation + bounded neargrid
    edge refinement (_NEARGRID_HYBRID_REFINE — the reference's own
    'speed'-profile construction), composing with whatever refine_mode
    the caller runs afterwards.  With refinement run to convergence the
    hybrid and the full-trajectory formulation land on the same charges
    (tests/test_hybrid_parity.py).

    ``carry_out``: optional dict.  When the hybrid path runs, it is filled
    with the internal refinement's continuation state so a follow-up
    ``refine_labels(..., carry_in=carry_out)`` with mode 'changed' chains
    onto the internal iterations (one continuous 'changed' sequence —
    reference thread_handlers.py:197-236 semantics for a single refine
    call) instead of re-finding and re-walking the full edge set.
    """
    reference = jnp.asarray(reference)
    vac = None if vacuum is None else jnp.asarray(vacuum)
    shape = reference.shape
    n = int(np.prod(shape))
    multi = mesh is not None and len(mesh.devices.reshape(-1)) > 1
    if full_trajectories is None:
        import os

        # PYBADER_TPU_FULL_TRAJECTORIES=1 forces the exact full-trajectory
        # initial pass at ANY grid size; =0 forces the hybrid.  The sharded
        # multi-device partition always initialises via the mesh ongrid
        # path (the full-trajectory initial walk is single-device only).
        env = os.environ.get("PYBADER_TPU_FULL_TRAJECTORIES")
        if env is not None and not multi:
            full_trajectories = env.lower() not in ("0", "off", "false")
        else:
            full_trajectories = n <= _NEARGRID_HYBRID_THRESHOLD and not multi
    if not full_trajectories:
        import os

        # default init is the ongrid partition: at equal refinement
        # budgets it lands closer to the serial reference than the
        # neargrid-first-step flood (128^3 sweep in PERF.md: 0.030% vs
        # 0.069% voxel mismatch at internal=('changed',3)) — the
        # first-step init's chain errors
        # sit deeper inside basins where edge re-walks reach them more
        # slowly.  The nginit path stays available for measurement.
        nginit = not multi and os.environ.get(
            "PYBADER_TPU_HYBRID_INIT", "ongrid") == "nginit"
        if nginit:
            labels, maxima = _partition_nginit(
                reference, vac, weights, t_grad, progress=progress)
            internal = _NGINIT_HYBRID_REFINE
        else:
            labels, maxima = partition_ongrid(
                reference, vac, weights, mesh=mesh, progress=progress)
            internal = _hybrid_internal_budget(shape)
        # PYBADER_TPU_INTERNAL_ITERS overrides the internal refinement
        # depth (-1 = run the band to convergence) for accuracy/cost
        # measurement runs
        env_it = os.environ.get("PYBADER_TPU_INTERNAL_ITERS")
        if env_it is not None:
            internal = ("changed", int(env_it))
        # internal iterations walk the 8-byte quantised rows: screened
        # (exact) by default; PYBADER_TPU_QROWS=internal|all walks them
        # unscreened — approximation machinery whose changed voxels are
        # re-walked by the exact user iterations chained via the carry;
        # =off restores exact rows
        q_internal = {"off": False, "internal": "q", "all": "q"}.get(
            os.environ.get("PYBADER_TPU_QROWS", "screened"), "qs")
        # optional internal-iteration step cap (lanes past it resolve
        # through ongrid roots — the documented cap-and-resolve
        # approximation); 0 = use the safety formula.
        icap = int(os.environ.get("PYBADER_TPU_INTERNAL_CAP", "0")) or None
        # ``stats`` (same contract as refine_labels') surfaces the
        # INTERNAL iterations too — a report of only the user iterations
        # under-reports the work done
        labels, _ = refine_labels(
            "neargrid", internal, reference, labels,
            weights, t_grad, verbose=False, mesh=mesh, progress=progress,
            carry_out=carry_out, quantized=q_internal, step_cap=icap,
            stats=stats,
        )
        # refinement reassigns edge voxels among the existing basin ids;
        # numbering and the maxima list stay those of the initialisation
        # (the reference likewise fixes them at bader_calc time)
        return labels, maxima
    parent, bk = _parent_and_codes(reference, vac, weights)
    roots_flat = None  # computed lazily, only if a trajectory hits the cap
    t_grad = jnp.asarray(t_grad)
    import os

    # full-trajectory walks also ride the screened quantised rows by
    # default (bit-identical to exact-row walking, ~half the gather
    # bytes); the exact rows build lazily for the risky re-walks only
    use_q = os.environ.get("PYBADER_TPU_QROWS", "screened") != "off"
    _ex = {"rows": None}

    def _exact_rows():
        if _ex["rows"] is None:
            _ex["rows"] = neargrid_ops.precompute_rows(
                reference, parent, t_grad, strict_grad=False)
        return _ex["rows"]

    if use_q:
        qrows = neargrid_ops.precompute_qrows(
            reference, bk, t_grad, strict_grad=False)
    else:
        qrows = None
        _exact_rows()

    vac_h = None if vac is None else np.asarray(vac).reshape(-1)
    final = np.arange(n, dtype=np.int32)
    starts_all = (
        np.arange(n, dtype=np.int32) if vac_h is None
        else np.flatnonzero(~vac_h).astype(np.int32)
    )
    n_batches = -(-len(starts_all) // batch)
    for lo in range(0, len(starts_all), batch):
        b = lo // batch + 1
        tick = None
        if progress is not None:
            tick = lambda s, alive: progress(  # noqa: E731
                f"trajectory batch {b}/{n_batches}: step {s}, "
                f"{alive} walking")
        chunk = starts_all[lo:lo + batch]
        padded = neargrid_ops.pad_starts(chunk)
        if use_q:
            pos, done = neargrid_ops.walk_drain_screened(
                jnp.asarray(padded), t_grad, shape, qrows, _exact_rows,
                strict_grad=False, progress=tick,
            )
        else:
            pos, done = neargrid_ops.walk_drain(
                jnp.asarray(padded), None, None, None, t_grad,
                shape, strict_grad=False, progress=tick,
                fields=_ex["rows"],
            )
        # step-cap stragglers resolve through their ongrid root (a maximum)
        if not bool(jnp.all(done)):
            if roots_flat is None:
                roots_flat = resolve_roots_auto(parent, bk).reshape(-1)
            pos = jnp.where(done, pos,
                            jnp.take(roots_flat, pos, mode="clip"))
        final[chunk] = np.asarray(pos)[: len(chunk)]

    final_dev = jnp.asarray(final.reshape(shape))
    # trajectories already terminate at maxima: `final` is its own root map
    return label_from_roots(final_dev, vac)


def refine_labels(method: str, refine_mode, reference, labels, weights,
                  t_grad, verbose: bool = True, mesh=None, stats=None,
                  progress=None, carry_in=None, carry_out=None,
                  quantized: bool | None = None,
                  step_cap: int | None = None):
    """Iterative neargrid edge refinement to (or towards) a fixed point.

    Mirrors reference thread_handlers.refine (:128-236): iteration 1 walks
    every edge voxel; subsequent iterations re-walk either the full fresh
    edge set ('all') or the neighbourhoods of changed voxels ('changed'),
    stopping after ``iters`` iterations or when nothing changes (iters < 0
    means run to convergence).  Unknown methods are silently skipped, like
    the reference (thread_handlers.py:140-143).

    ``stats``, if a dict, receives ``stats['iterations']`` — a list of
    (edges_walked, changed, step_cap_fires, screened_risky_lanes,
    iteration_seconds) per iteration, so production runs and the bench
    can record how often the walker's documented cap-and-resolve
    approximation fires and what the exactness screen's re-walks cost.

    With a ``mesh``, the full-grid stencil stages (edge_find/edge_check and
    the ascent stencil) run sharded over the mesh (rolls -> halo
    collectives), and the trajectory walker keeps the f64 density and the
    parent grid sharded too, gathering per step via masked-local-gather +
    psum (parallel/walk.py) — no device materialises a full-grid f64
    array.  Small int32/int8 stages (edge compaction sort, label pickup)
    still reshard through XLA collectives.

    ``carry_in`` / ``carry_out`` chain successive 'changed'-mode calls on
    the SAME labels into one continuous 'changed' sequence (reference
    thread_handlers.py:197-236 semantics for a single call): a call given
    ``carry_out`` stashes its continuation state (post-final-iteration
    edge bookkeeping, packed walker rows, step codes) there; passing that
    dict as ``carry_in`` to the next 'changed' call skips its full-grid
    edge_find, the full-edge iteration-1 walk, and the row precompute.
    The carry is single-use (its row buffer is donated onward).  Both are
    ignored for 'all' mode and on a multi-device mesh.

    ``quantized`` selects the walker row format (ops/neargrid.py
    "Quantised 8-byte rows": two int32 words, 19-bit fixed-point gradient
    components, quantisation ~1.9e-6/component): ``'qs'`` (the default,
    from PYBADER_TPU_QROWS=screened) walks the q-rows under the per-lane
    exactness screen and re-walks unproven lanes on exact rows —
    bit-identical to exact-row walking, safe for user-visible
    refinement; ``'q'`` walks them UNscreened (the
    approximation — the hybrid's internal iterations pass this, their
    changed voxels being re-walked by the chained exact user
    iterations, or PYBADER_TPU_QROWS=all everywhere); ``False``/
    PYBADER_TPU_QROWS=off keeps exact rows everywhere.  The screen
    gives exactness at half the row bytes.
    On the CPU backend unscreened 'q' additionally requires
    PYBADER_TPU_QROWS_CPU=1 (oracle-parity tests stay exact); a carry
    whose row format differs is rebuilt (exact rows crossing into a
    quantised call are kept for the screen's risky re-walks).

    returns (labels, total_changed).
    """
    if method not in REFINEMENT_METHODS:
        return labels, 0
    mode, iters = tuple(refine_mode)
    if iters == 0:
        return labels, 0
    max_iters = np.inf if iters < 0 else int(iters)

    reference = jnp.asarray(reference)
    labels = jnp.asarray(labels)
    if mesh is not None and len(mesh.devices.reshape(-1)) > 1:
        from jax.sharding import NamedSharding

        from pybader_tpu.parallel.chase import grid_spec_2d

        sharding = NamedSharding(mesh, grid_spec_2d(mesh, reference.shape))
        reference = jax.device_put(reference, sharding)
        labels = jax.device_put(labels, sharding)
    shape = reference.shape
    t_grad = jnp.asarray(t_grad)
    multi = mesh is not None and len(mesh.devices.reshape(-1)) > 1
    chained = str(mode).lower() == "changed" and not multi
    if not chained:
        carry_in = carry_out = None
    if carry_in is not None and carry_in.get("converged"):
        return labels, 0
    import os

    # Row-format policy (PYBADER_TPU_QROWS): 'screened' (default) walks
    # the 8-byte quantised rows under the per-lane exactness screen and
    # re-walks the rare unproven lanes on exact rows — bit-identical to
    # exact-row walking at about half the gather bytes, so it is safe
    # for user-visible refinement; 'internal'/'all' walk unscreened
    # quantised rows (internal hybrid only / everywhere — the
    # approximation); 'off' keeps exact rows everywhere.
    # On the CPU backend the unscreened modes additionally require
    # PYBADER_TPU_QROWS_CPU=1 (oracle-parity tests stay exact; the
    # screened mode IS exact so it needs no gate).
    qmode_env = os.environ.get("PYBADER_TPU_QROWS", "screened")
    if quantized is None:
        quantized = {"screened": "qs", "all": "q"}.get(qmode_env, False)
    if quantized is True:
        quantized = "q"
    if quantized == "q" and jax.default_backend() == "cpu" and \
            os.environ.get("PYBADER_TPU_QROWS_CPU") != "1":
        quantized = False
    if multi:
        quantized = False
    rows_kind = quantized or "exact"

    def _build_rows(bk_grid, parent_grid=None, exact=False):
        if rows_kind != "exact" and not exact:
            return neargrid_ops.precompute_qrows(
                reference, bk_grid, t_grad, strict_grad=True)
        if parent_grid is None:
            parent_grid = parent_from_step_codes(bk_grid)
        return neargrid_ops.precompute_rows(
            reference, parent_grid, t_grad, strict_grad=True)

    roots_flat = None  # computed lazily, only if a trajectory hits the cap
    if carry_in is not None and "known" in carry_in:
        # continuation of a prior 'changed' call on the same labels:
        # reuse its edge bookkeeping, step codes and packed walker rows
        parent = None
        bk = carry_in["bk"]
        is_max = carry_in["is_max"]
        walk_fields = carry_in["fields"]
        known = carry_in["known"]
        starts_small = carry_in.get("starts_small")
        exact_rows_in = carry_in.get("fields_exact")
        if walk_fields is not None and (
                neargrid_ops.is_qrows(walk_fields)
                != (rows_kind != "exact")):
            # row-format boundary (quantised internal hybrid -> exact
            # user refinement or vice versa): free the old rows, rebuild
            # in this call's format from the carried step codes
            if rows_kind == "exact" and neargrid_ops.is_qrows(walk_fields) \
                    and exact_rows_in is not None:
                walk_fields = exact_rows_in
                exact_rows_in = None
                carry_in["fields"] = carry_in["fields_exact"] = None
            else:
                if not neargrid_ops.is_qrows(walk_fields) \
                        and exact_rows_in is None:
                    # exact -> quantised boundary: keep the carried exact
                    # rows for the screened walk's risky re-walks instead
                    # of dropping them and forcing a redundant multi-GB
                    # rebuild if any lane flags risky
                    exact_rows_in = walk_fields
                carry_in["fields"] = walk_fields = None
        if walk_fields is None and not multi:
            walk_fields = _build_rows(bk)
    else:
        vac = labels == -1
        parent, bk = _parent_and_codes(reference, vac, weights)
        walk_fields = None  # packed walker operands, built on first walk
        if not multi:
            # build the rows early and DROP the parent grid: its bits live
            # in the rows, the cap-fire root fallback recomputes it (or
            # uses the scan flood straight from bk), and at 512^3 the
            # extra 0.5 GB matters next to the 4.3 GB rows buffer
            walk_fields = _build_rows(bk, parent)
            parent = None
        # local maximum <=> self ascent step: lets the edge stencils skip
        # 26 rolls of the f64 density grid (ops/edges._edge_and_max)
        is_max = (bk == jnp.uint8(13)) & ~vac

        known = edges_ops.edge_find(reference, labels, is_max)
        starts_small = None  # small candidate list, 'changed' fast path
        exact_rows_in = None
    # lazy exact-row builder for the screened walk's risky re-walks:
    # built at most once per call (carried across calls), stop bits
    # re-baked per iteration on demand
    _exact = {"rows": exact_rows_in, "iter": -1}
    _cur_iter = {"it": 0}

    def _exact_fields():
        if _exact["rows"] is None:
            _exact["rows"] = _build_rows(bk, exact=True)
        if _exact["iter"] != _cur_iter["it"]:
            _exact["rows"] = neargrid_ops.update_stop(
                _exact["rows"], (known == 2).reshape(-1))
            _exact["iter"] = _cur_iter["it"]
        return _exact["rows"]

    total_changed = 0
    converged = False
    detail = None
    if stats is not None:
        import time as _time

        stats["iterations"] = []
        _t_iter = _time.perf_counter()
        if stats.get("detail"):
            # opt-in per-stage split (adds one device sync per stage —
            # instrumentation runs only)
            detail = stats.setdefault("stages", [])

            def _mark(d, key, t0, x=None):
                if x is not None:
                    jax.block_until_ready(x)
                now = _time.perf_counter()
                d[key] = round(now - t0, 3)
                return now
    it = 0
    while it < max_iters:
        it += 1
        d_st = {} if detail is not None else None
        if d_st is not None:
            detail.append(d_st)
            _t_st = _time.perf_counter()
        if starts_small is None:
            edge_mask = (known == -2).reshape(-1)
            n_edges = int(jnp.sum(edge_mask))
        else:
            n_edges = int(starts_small[1])
        if d_st is not None:
            d_st["edges_count"] = n_edges
            _t_st = _mark(d_st, "count", _t_st)
        if n_edges == 0:
            if verbose and it == 1:
                print("  No edges found.")
            converged = True
            break
        if verbose:
            print(f"  Iteration {it}: refining {n_edges} edges")
        from pybader_tpu.ops.reductions import compact_indices

        # same bucket ladder as the drain loop's compaction (a pow2-only
        # initial bucket walked up to 14% padding through iteration 1's
        # first segments, and its sizes were distinct programs anyway)
        size = neargrid_ops._bucket_size(n_edges, 4096)
        if starts_small is not None:
            starts_dev_padded = _fit_starts(starts_small[0], size)
        else:
            # device-side compaction (sort-based: jnp.nonzero(size=) costs
            # seconds under x64) — avoids shipping the full known grid to
            # the host every iteration
            starts_dev_padded = compact_indices(edge_mask, size)
        starts_small = None
        if d_st is not None:
            _t_st = _mark(d_st, "compact", _t_st, starts_dev_padded)
        # cap trajectories: period>2 cycles escape the walker's revisit
        # detection and would otherwise spin to the global cap; stragglers
        # resolve through their ongrid root below.  Ridge trajectories
        # lengthen with resolution (192 steps capped 2.5k of 7M lanes at
        # 512^3 vs ~70 at 384^3), so the cap scales with the largest
        # grid extent; it is a TRACED bound in the walker, so this costs
        # no extra compiles.  A caller-supplied ``step_cap`` (the hybrid's
        # internal iterations) overrides the safety formula: truncated
        # lanes resolve through ongrid roots, the same documented
        # cap-and-resolve approximation (tests/test_step_cap.py).
        cap = step_cap
        if cap is None:
            cap = 192 if max(shape) <= 384 else 96 + max(shape) // 2
        if multi:
            from pybader_tpu.parallel.walk import walk_sharded

            n_risky = 0
            pos, done = walk_sharded(
                mesh, starts_dev_padded, reference, parent, known == 2,
                t_grad, strict_grad=True, max_steps=cap,
            )
        else:
            stop_upd = (neargrid_ops.update_stop_q
                        if neargrid_ops.is_qrows(walk_fields)
                        else neargrid_ops.update_stop)
            walk_fields = stop_upd(walk_fields, (known == 2).reshape(-1))
            if d_st is not None:
                _t_st = _mark(d_st, "update_stop", _t_st, walk_fields)
            wkw = {}
            if progress is not None:
                wkw["progress"] = lambda s, alive: progress(
                    f"iteration {it}: step {s}, {alive}/{n_edges} edges "
                    f"walking")
            _cur_iter["it"] = it
            wstat = {} if rows_kind == "qs" else None

            def _one_walk(sub_starts):
                if rows_kind == "qs":
                    return neargrid_ops.walk_drain_screened(
                        sub_starts, t_grad, shape, walk_fields,
                        _exact_fields, strict_grad=True, max_steps=cap,
                        stats=wstat, **wkw)
                return neargrid_ops.walk_drain(
                    sub_starts, None, None, None, t_grad, shape,
                    strict_grad=True, max_steps=cap,
                    fields=walk_fields, **wkw)

            # bound per-walk state next to the rows buffer (see
            # _WALK_CHUNK_CAP)
            chunk_cap = _WALK_CHUNK_CAP
            if size > chunk_cap:
                parts = []
                n_risky = 0
                for lo2 in range(0, size, chunk_cap):
                    parts.append(_one_walk(
                        starts_dev_padded[lo2:lo2 + chunk_cap]))
                    if wstat is not None:
                        n_risky += wstat.get("risky", 0)
                pos = jnp.concatenate([p for p, _ in parts])
                done = jnp.concatenate([d for _, d in parts])
            else:
                pos, done = _one_walk(starts_dev_padded)
                n_risky = 0 if wstat is None else wstat.get("risky", 0)
        if d_st is not None:
            _t_st = _mark(d_st, "walk", _t_st, pos)
        # padding lanes are born done, so the full-width sum equals the
        # valid-lane count (no dynamic slice: a [:n_edges] view compiled
        # a fresh program per edge count)
        n_capped = int(jnp.sum(~done)) if not bool(
            jnp.all(done)) else 0
        if n_capped:
            # step-cap stragglers resolve through their ongrid root — an
            # APPROXIMATION, acceptable only because legitimate walks
            # terminate far below the cap and period<=5 cycles are broken
            # reference-style inside the walker (tests/test_step_cap.py);
            # the count is surfaced so production runs can see it fire
            if verbose:
                print(f"  {n_capped} trajectories hit the step cap "
                      f"(resolved through ongrid roots)")
            if roots_flat is None:
                if multi:
                    from pybader_tpu.parallel.chase import sharded_chase

                    roots_flat = sharded_chase(
                        mesh, parent, bk).reshape(-1)
                else:
                    if parent is None:  # dropped after the row precompute
                        parent = parent_from_step_codes(bk)
                    roots_flat = resolve_roots_auto(parent, bk).reshape(-1)
            pos = jnp.where(done, pos,
                            jnp.take(roots_flat, pos, mode="clip"))
        labels_flat, known_flat, changed_mask, changed_dev = \
            _apply_walk_results(labels.reshape(-1), known.reshape(-1),
                                starts_dev_padded, pos)
        labels = labels_flat.reshape(shape)
        known = known_flat.reshape(shape)
        changed = int(changed_dev)
        if d_st is not None:
            _t_st = _mark(d_st, "apply", _t_st)
        total_changed += changed
        if stats is not None:
            # (edges walked, changed, step-cap fires, screened-walk risky
            # re-walk lanes, iteration seconds) — the int(changed_dev)
            # fetch above synced the device, so the wall split is
            # accurate without extra syncs
            _now = _time.perf_counter()
            stats["iterations"].append(
                (n_edges, changed, n_capped, n_risky,
                 round(_now - _t_iter, 3)))
            _t_iter = _now
        if verbose:
            print(f"  {changed} points changed.")
        if changed == 0:
            converged = True
            break
        if it >= max_iters and carry_out is None:
            break
        if str(mode).lower() == "all":
            known = edges_ops.edge_find(reference, labels, is_max)
        else:
            known = edges_ops.edge_check(known, reference, labels, is_max)
            n_grid = int(np.prod(shape))
            if not multi and changed * 27 <= min(_CAND_CAP, n_grid // 4):
                # the next edge set is a subset of the changed set's
                # 27-neighbourhoods: filter that small candidate list
                # instead of compaction-sorting the full grid.  The
                # changed starts are first compacted to a power-of-two
                # bucket (``changed`` is already a host int) so the 27x
                # expansion sorts ~27*changed keys, not 27*n_edges.  Two
                # caps: above _CAND_CAP entries the expansion's memory
                # competes with the rows buffer, and above ~n/4 entries
                # the 27x candidate list (gathered and sorted twice)
                # outgrows the full-grid compaction sort it replaces.
                big = jnp.int32(np.iinfo(np.int32).max)
                cpow = max(4096, 1 << (changed - 1).bit_length())
                ch_starts = jnp.sort(
                    jnp.where(changed_mask, starts_dev_padded, big))[:cpow]
                ch_starts = jnp.where(ch_starts == big, jnp.int32(-1),
                                      ch_starts)
                cand = edges_ops.neighbors27_flat(ch_starts, shape)
                starts_small = edges_ops.filter_edges_sorted(
                    cand, known.reshape(-1))
        if d_st is not None:
            _t_st = _mark(d_st, "edge_scan", _t_st, known)
        if it >= max_iters:
            break
    if carry_out is not None:
        if converged:
            carry_out["converged"] = True
        else:
            carry_out.update(
                known=known, starts_small=starts_small, bk=bk,
                is_max=is_max, fields=walk_fields,
                fields_exact=_exact["rows"],
            )
    return labels, total_changed


@jax.jit
def _apply_walk_results(labels_flat, known_flat, starts_padded, pos):
    """One-dispatch post-walk update: label pickup + write + known dance.

    Operates on the full padded walker bucket (invalid lanes carry
    starts == -1 and are dropped by out-of-bounds scatter), so the
    program compiles once per bucket size instead of per edge count, and
    the new/old label gathers, the label scatter, the reference known
    dance (refinement.py:288-302: changed stay -2, unchanged drop to -1)
    and the changed count all fuse into a single program.
    returns (labels_flat, known_flat, changed_mask, changed_count).
    """
    valid = starts_padded >= 0
    n = labels_flat.shape[0]
    idx = jnp.where(valid, starts_padded, jnp.int32(n))  # OOB -> dropped
    new_lab = jnp.take(labels_flat, jnp.clip(pos, 0), mode="clip")
    old_lab = jnp.take(labels_flat, jnp.clip(starts_padded, 0),
                       mode="clip")
    changed_mask = valid & (new_lab != old_lab)
    labels_flat = labels_flat.at[idx].set(new_lab, mode="drop")
    known_flat = known_flat.at[idx].set(
        jnp.where(changed_mask, jnp.int8(-2), jnp.int8(-1)), mode="drop")
    return labels_flat, known_flat, changed_mask, jnp.sum(changed_mask)


def _fit_starts(starts_sorted: jax.Array, size: int) -> jax.Array:
    """Resize an ascending -1-tailed index list to a walker bucket.

    filter_edges_sorted puts all valid entries (ascending) first with a -1
    tail, and the bucket size is chosen >= the valid count, so a plain
    slice/pad preserves every entry."""
    n = starts_sorted.shape[0]
    if n >= size:
        return starts_sorted[:size]
    return jnp.concatenate(
        [starts_sorted, jnp.full((size - n,), -1, jnp.int32)])
