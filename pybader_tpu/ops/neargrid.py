"""Vectorised neargrid trajectory walker.

The reference walks one neargrid trajectory at a time (methods.py:222-611
for initial partitioning, refinement.py:16-322 for edge re-walks): a
central-difference gradient is transformed to voxel-index steps, a
sub-voxel correction vector ``dr`` accumulates rounding error and is applied
once |dr_j| >= 0.5, and a path-revisit triggers an ongrid fallback step with
dr reset.

Data-parallel formulation: every trajectory advances in lockstep inside one
``lax.while_loop``; the ongrid fallback is a single gather into the
precomputed ascent-pointer array (:func:`pybader_tpu.ops.stencil
.ongrid_parent`), and path-revisit detection uses the recent positions
(period-1/2 cycles — the only revisits the neargrid step rule produces in
practice) plus a step cap with a provably-terminating ongrid fallback.

Lockstep walking makes every lane pay for the slowest trajectory (each step
gathers for the full batch, finished lanes included).  :func:`walk_drain`
fixes the tail latency: it walks in bounded segments and periodically
compacts the still-running lanes into a smaller batch (argsort + take on
the batch, both tiny next to a full-batch step), so the short majority
retires early and the long tail runs in a batch its own size.

Deliberate deviation (documented): the reference's *initial* neargrid pass
adopts labels from already-visited voxels (methods.py:509-511), making raw
assignments depend on voxel visit order; its refinement stage exists to fix
the resulting edge errors.  Here every trajectory is walked to termination
independently, which is order-free and matches the reference *after* its
refinement converges (the reference's own accuracy harness,
examples/compare_methods.py, defines that converged state as ground truth).
The deviation of the >16M-voxel hybrid at the UNconverged shipping config
(('changed', 2)) against the serial reference is recorded in PERF.md
("Hybrid accuracy"): exact at 48^3, 0.03% of voxels at a dense 128^3,
1.2% at 192^3 (max per-atom |dq| 0.17% of the total charge), pinned by
tests/test_hybrid_shipping.py.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _round_away(x):
    """Round half away from zero (trunc(x + sign(x)*0.5)), x==0 -> 0.

    Matches reference methods.py:346-357: ``int64(g + .5)`` for g > 0 else
    ``int64(g - .5)`` (C-style truncation towards zero).
    """
    return jnp.trunc(x + jnp.where(x > 0, 0.5, -0.5)).astype(jnp.int32)


_HIST = 3  # recent-position window (catches period <= 5 cycles with prev)

_ONGRID_BIT = jnp.int32(1 << 28)  # flat indices < 2^27 (512^3): bits free
_MAX_BIT = jnp.int32(1 << 29)
_STOP_BIT = jnp.int32(1 << 30)
_IDX_MASK = jnp.int32((1 << 28) - 1)


@partial(jax.jit, static_argnames=("strict_grad",))
def _gd_components(reference, t_grad, strict_grad: bool):
    """gd = grad @ T.T as three (N,) columns (bounded live set)."""
    gd = [jnp.zeros(reference.size, dtype=reference.dtype)
          for _ in range(3)]
    for j in range(3):
        up = jnp.roll(reference, -1, j)
        dn = jnp.roll(reference, 1, j)
        if strict_grad:
            axis_flat = (up < reference) & (dn < reference)
        else:
            axis_flat = (up <= reference) & (dn <= reference)
        grad_j = jnp.where(axis_flat, 0.0, (up - dn) * 0.5).reshape(-1)
        for i in range(3):
            gd[i] = gd[i] + t_grad[i, j] * grad_j
    return tuple(gd)


@jax.jit
def _denom_flags(gd0, gd1, gd2):
    mg = jnp.maximum(jnp.maximum(jnp.abs(gd0), jnp.abs(gd1)),
                     jnp.abs(gd2))
    return jnp.where(mg > 0, mg, 1.0), mg < 1e-14


@partial(jax.jit, donate_argnums=(0,))
def _div_inplace(x, denom):
    return x / denom


@partial(jax.jit, donate_argnums=(0,), static_argnames=("j",))
def _set_col(rows, col, j: int):
    return rows.at[:, j].set(col.astype(rows.dtype))


def _set_packed_col(rows, packed):
    """Store the int32 packed-parent word into lane 3 bit-exactly.

    f32 rows: bitcast (a value cast would round away the flag bits above
    2^24; gathers and slice-updates move bytes, so the patterns —
    including denormal-range ones — survive data movement); f64 rows:
    value cast (exact for < 2^52).  Plain function: callers jit it with
    their own donation.
    """
    if rows.dtype == jnp.float32:
        col = jax.lax.bitcast_convert_type(packed, jnp.float32)
    else:
        col = packed.astype(rows.dtype)
    return rows.at[:, 3].set(col)


_store_packed = jax.jit(_set_packed_col, donate_argnums=(0,))

# ---------------------------------------------------------------------------
# Quantised 8-byte rows (the bulk-walking fast path)
#
# Packing the walk operand into two int32 words halves the row bytes and,
# more importantly, lets the screened walk prove most lanes exact.  19-bit
# layout (the MAX flag is redundant with code == 13, freeing 3 extra bits
# per component over the original int16 packing):
#
#   word0 = q0[0:19) | q1_lo[19:32)
#   word1 = q1_hi[0:6) | q2[6:25) | code[25:30)   ongrid step code (OFFSETS
#           | ONGRID(30) STOP(31=sign)            order, 13 == self == max)
#
# with q_i = round(g_i * 262143) of the inf-normalised transformed gradient
# (|g_i| <= 1 by construction).  Quantisation error <= 1.91e-6 per
# component per step (the int16 packing's 1.53e-5 flagged ~10% of
# 384^3-class refinement lanes risky; 19 bits cuts that ~8x).  Two usage
# modes:
#
#   SCREENED (:func:`_walk_segment_qs` + :func:`walk_drain_screened`, the
#   pipeline default): every rounding decision is checked against a sound
#   running error bound; unproven lanes re-walk on exact rows, so results
#   are bit-identical to exact-row walking — safe for user-visible
#   refinement.
#
#   UNSCREENED (:func:`_walk_segment_q`): knife-edge-only deviations vs
#   the exact walk — acceptable for the hybrid's internal iterations
#   (approximation machinery whose changed voxels are re-walked by later
#   exact iterations), opt-in via PYBADER_TPU_QROWS=internal|all.
#
# The ongrid fallback target is a 5-bit neighbour code instead of a flat
# index, so the packed ROW no longer bounds the grid at 2^28 voxels.  The
# binding limit is the drain loop's retired-lane words (_pack_w: pos in
# bits [0:30), risky at 30, done at 31) and the screened compaction's
# identical packing: grids must stay under 2^30 voxels (< 1024^3;
# asserted in walk_drain).
# ---------------------------------------------------------------------------

_Q_SCALE = 262143.0  # 2^18 - 1
_Q_CODE_SHIFT = 25
_CODE_MASK = jnp.int32(31)
_Q_ONGRID_BIT = jnp.int32(1 << 30)
_Q_STOP_BIT = jnp.int32(-(1 << 31))  # sign bit


def _q_decode(w0, w1):
    """(g0, g1, g2) sign-extended 19-bit fields of the packed words."""
    q0 = (w0 << 13) >> 13  # arithmetic shift sign-extends
    q1 = ((((w0 >> 19) & 0x1FFF) | ((w1 & 0x3F) << 13)) << 13) >> 13
    q2 = (w1 << 7) >> 13
    return q0, q1, q2


def precompute_qrows(reference, bk, t_grad, strict_grad: bool):
    """(N,2) int32 quantised walk rows (no stop bits).

    ``bk`` is the uint8 ascent step-code grid (OFFSETS order, vacuum
    already forced to 13) — the ongrid fallback travels by code, not by
    flat parent index.  Built column-wise with donation like
    :func:`precompute_rows` (the f64 gd columns dominate the peak).
    """
    gd = list(_gd_components(reference, jnp.asarray(t_grad), strict_grad))
    denom, use_ongrid = _denom_flags(*gd)
    q = []
    for j in range(3):
        col = _div_inplace(gd[j], denom)
        gd[j] = None
        q.append(_quantize_col(col))
    del denom
    return _pack_qwords(q[0], q[1], q[2], bk.reshape(-1), use_ongrid)


@jax.jit
def _quantize_col(col):
    # no donation: the f64 column cannot alias the int32 output anyway
    return jnp.round(col * _Q_SCALE).astype(jnp.int32)


@jax.jit
def _pack_qwords(q0, q1, q2, bk_flat, use_ongrid):
    # no donation: (N,) columns cannot alias the stacked (N,2) output
    word0 = (q0 & 0x7FFFF) | ((q1 & 0x1FFF) << 19)
    word1 = ((q1 & 0x7FFFF) >> 13) | ((q2 & 0x7FFFF) << 6) \
        | (bk_flat.astype(jnp.int32) << _Q_CODE_SHIFT)
    word1 = word1 | jnp.where(use_ongrid, _Q_ONGRID_BIT, 0)
    return jnp.stack([word0, word1], axis=1)


@partial(jax.jit, donate_argnums=(0,))
def update_stop_q(qrows, stop_flat):
    """Re-bake the stop set into quantised rows, in place (donated)."""
    w1 = (qrows[:, 1] & jnp.int32(0x7FFFFFFF)) \
        | jnp.where(stop_flat, _Q_STOP_BIT, 0)
    return qrows.at[:, 1].set(w1)


@partial(jax.jit, static_argnames=("shape", "early_exit"))
def _walk_segment_q(state, qrows, shape: tuple, max_steps,
                    early_exit: bool = True):
    """Quantised-row twin of :func:`_walk_segment_packed`.

    Step-for-step the same control flow (ongrid fallback, revisit window,
    dr reset, done freezing); the only difference is the operand: the
    gradient is dequantised 19-bit fixed point (quantisation ~1.9e-6 per
    component) and the ongrid fallback target is decoded from the 5-bit
    neighbour code relative to the current position instead of gathered
    as a flat index.
    """
    nx, ny, nz = shape
    dims = jnp.asarray([nx, ny, nz], dtype=jnp.int32)

    def flat(xyz):
        return (xyz[..., 0] * ny + xyz[..., 1]) * nz + xyz[..., 2]

    def unflat(p):
        return jnp.stack([p // (ny * nz), (p // nz) % ny, p % nz], axis=-1)

    def fetch(pos, done):
        row = jnp.take(qrows, pos, axis=0, mode="clip")  # (K, 2)
        w0, w1 = row[:, 0], row[:, 1]
        code = (w1 >> _Q_CODE_SHIFT) & _CODE_MASK
        done = done | (w1 < 0) | (code == 13)  # STOP sign bit / maximum
        g = jnp.stack(_q_decode(w0, w1), axis=-1).astype(
            jnp.float32) * jnp.float32(1.0 / _Q_SCALE)
        return done, g, code, (w1 & _Q_ONGRID_BIT) != 0

    limit = jnp.asarray(max_steps, jnp.int32)

    def cond(carry):
        pos, prev, hist, dr, done, step = carry
        alive = ~jnp.all(done) if early_exit else jnp.bool_(True)
        return alive & (step < limit)

    def body(carry):
        pos, prev, hist, dr, done, step = carry
        done, g, code, use_ongrid = fetch(pos, done)

        xyz = unflat(pos)
        # OFFSETS order: code -> (code//9 - 1, (code//3)%3 - 1, code%3 - 1)
        og_off = jnp.stack(
            [code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1], axis=-1)
        ongrid_next = flat(jnp.remainder(xyz + og_off, dims))

        int_grad = _round_away(g)
        dr_new = dr + g - int_grad
        int_dr = _round_away(dr_new)
        dr_after = dr_new - int_dr
        nxt = flat(jnp.remainder(xyz + int_grad + int_dr, dims))

        nxt = jnp.where(use_ongrid, ongrid_next, nxt)
        revisit = (nxt == pos) | (nxt == prev)
        for h in range(hist.shape[-1]):
            revisit = revisit | (nxt == hist[:, h])
        nxt = jnp.where(revisit, ongrid_next, nxt)
        reset = use_ongrid | revisit
        dr_after = jnp.where(reset[:, None], 0.0, dr_after)

        pos_new = jnp.where(done, pos, nxt)
        prev_new = jnp.where(done, prev, pos)
        hist_new = jnp.where(
            done[:, None], hist,
            jnp.concatenate([prev[:, None], hist[:, :-1]], axis=1))
        dr_out = jnp.where(done[:, None], dr, dr_after)
        return pos_new, prev_new, hist_new, dr_out, done, step + 1

    pos, prev, hist, dr, done = state
    pos, prev, hist, dr, done, _ = jax.lax.while_loop(
        cond, body, (pos, prev, hist, dr, done, jnp.int32(0))
    )
    done, _, _, _ = fetch(pos, done)
    return pos, prev, hist, dr, done


@partial(jax.jit, static_argnames=("shape", "early_exit"))
def _walk_segment_counted_q(state, qrows, shape: tuple, max_steps,
                            early_exit: bool = True):
    state = _walk_segment_q(state, qrows, shape, max_steps, early_exit)
    return state, jnp.sum(~state[4])


# Per-decision error bound for the SCREENED quantised walk: quantisation
# round-off (0.5/262143 = 1.907e-6) + dequantise/accumulate f32 rounding
# (one multiply rounding on |g|<=1 at <=2^-24 ~ 6e-8, plus two f32 adds
# on |dr|<=1.5 per step at <=1.5*2^-23 ~ 1.8e-7 each, worst case
# ~4.2e-7).  The worst-case per-step sum is ~2.33e-6; 3e-6 leaves ~30%
# soundness margin over it (the razor-thin 2.2e-6 of round 4 was ~1%
# UNDER a pessimistic accounting).  Widening the bound only flags more
# lanes risky (re-walked exactly), never fewer: risky-lane counts moved
# <0.1% of walked lanes at 2.2e-6 -> 3e-6.
# Sound per component per step; dr's bound accumulates since the last
# reset (ongrid fallback / revisit zeroes dr exactly on both row
# formats).
_QS_EPS = jnp.float32(3e-6)


@partial(jax.jit, static_argnames=("shape", "early_exit"))
def _walk_segment_qs(state, qrows, shape: tuple, max_steps,
                     early_exit: bool = True):
    """Screened quantised walk segment: q-rows + per-lane exactness proof.

    Identical stepping to :func:`_walk_segment_q`, plus two extra state
    fields: ``err`` — a running upper bound on |dr_q - dr_exact| per
    component (grows by _QS_EPS per step, reset with dr) — and ``risky``
    — set once any integer rounding decision (round_away of g or of
    dr_new, the only discontinuities, at |x| = 0.5) comes within the
    current bound of its threshold.  A lane that finishes with
    ``risky == False`` provably took the same integer steps the
    exact-row walk would take (same positions, same termination); risky
    lanes are re-walked on exact rows by :func:`walk_drain_screened`.
    Ongrid-fallback steps make no gradient decisions, so they never
    flag.
    """
    nx, ny, nz = shape
    dims = jnp.asarray([nx, ny, nz], dtype=jnp.int32)

    def flat(xyz):
        return (xyz[..., 0] * ny + xyz[..., 1]) * nz + xyz[..., 2]

    def unflat(p):
        return jnp.stack([p // (ny * nz), (p // nz) % ny, p % nz], axis=-1)

    def fetch(pos, done):
        row = jnp.take(qrows, pos, axis=0, mode="clip")  # (K, 2)
        w0, w1 = row[:, 0], row[:, 1]
        code = (w1 >> _Q_CODE_SHIFT) & _CODE_MASK
        done = done | (w1 < 0) | (code == 13)  # STOP sign bit / maximum
        g = jnp.stack(_q_decode(w0, w1), axis=-1).astype(
            jnp.float32) * jnp.float32(1.0 / _Q_SCALE)
        return done, g, code, (w1 & _Q_ONGRID_BIT) != 0

    limit = jnp.asarray(max_steps, jnp.int32)

    def cond(carry):
        pos, prev, hist, dr, done, err, risky, step = carry
        alive = ~jnp.all(done) if early_exit else jnp.bool_(True)
        return alive & (step < limit)

    def body(carry):
        pos, prev, hist, dr, done, err, risky, step = carry
        done, g, code, use_ongrid = fetch(pos, done)

        xyz = unflat(pos)
        og_off = jnp.stack(
            [code // 9 - 1, (code // 3) % 3 - 1, code % 3 - 1], axis=-1)
        ongrid_next = flat(jnp.remainder(xyz + og_off, dims))

        int_grad = _round_away(g)
        dr_new = dr + g - int_grad
        int_dr = _round_away(dr_new)
        dr_after = dr_new - int_dr
        nxt = flat(jnp.remainder(xyz + int_grad + int_dr, dims))

        # exactness screen: round_away is discontinuous only at |x|=0.5
        d_g = jnp.min(jnp.abs(jnp.abs(g) - 0.5), axis=-1)
        d_dr = jnp.min(jnp.abs(jnp.abs(dr_new) - 0.5), axis=-1)
        risky_step = (d_g < _QS_EPS) | (d_dr < err + _QS_EPS)

        nxt = jnp.where(use_ongrid, ongrid_next, nxt)
        revisit = (nxt == pos) | (nxt == prev)
        for h in range(hist.shape[-1]):
            revisit = revisit | (nxt == hist[:, h])
        nxt = jnp.where(revisit, ongrid_next, nxt)
        reset = use_ongrid | revisit
        dr_after = jnp.where(reset[:, None], 0.0, dr_after)

        # ongrid-fallback lanes take no gradient decision this step
        risky = risky | (risky_step & ~use_ongrid & ~done)
        err_new = jnp.where(reset, 0.0, err + _QS_EPS)

        pos_new = jnp.where(done, pos, nxt)
        prev_new = jnp.where(done, prev, pos)
        hist_new = jnp.where(
            done[:, None], hist,
            jnp.concatenate([prev[:, None], hist[:, :-1]], axis=1))
        dr_out = jnp.where(done[:, None], dr, dr_after)
        err_out = jnp.where(done, err, err_new)
        return pos_new, prev_new, hist_new, dr_out, done, err_out, \
            risky, step + 1

    pos, prev, hist, dr, done, err, risky = state
    pos, prev, hist, dr, done, err, risky, _ = jax.lax.while_loop(
        cond, body, (pos, prev, hist, dr, done, err, risky, jnp.int32(0))
    )
    done, _, _, _ = fetch(pos, done)
    return pos, prev, hist, dr, done, err, risky


@partial(jax.jit, static_argnames=("shape", "early_exit"))
def _walk_segment_counted_qs(state, qrows, shape: tuple, max_steps,
                             early_exit: bool = True):
    state = _walk_segment_qs(state, qrows, shape, max_steps, early_exit)
    return state, jnp.sum(~state[4])


def is_qrows(fields) -> bool:
    return fields is not None and fields.dtype == jnp.int32


def _packed_of(rows_col):
    """Read the packed-parent word back from lane 3 (inverse of
    :func:`_set_packed_col`)."""
    if rows_col.dtype == jnp.float32:
        return jax.lax.bitcast_convert_type(rows_col, jnp.int32)
    return rows_col.astype(jnp.int32)


# Above this many voxels precompute_rows switches to the two-pass "lean"
# build: the single-pass form holds all three f64 gd columns (3 x 8 B/vox)
# NEXT TO the 32 B/vox rows buffer, which at 512^3 peaks ~15 GB alongside
# the screened walk's resident set (density, q-rows, labels, edge
# bookkeeping).  The lean build recomputes the gradient per column
# instead (2x the roll bandwidth; the build runs at most once per refine
# call):
# pass 1 derives denom/use_ongrid without retaining any column, pass 2
# builds one column at a time straight into the rows buffer.  Same ops in
# the same order as the single-pass form, so the rows are bit-identical
# (pinned by tests/test_qrows.py::test_lean_rows_build_bit_identical).
_LEAN_ROWS_MIN_N = 1 << 26


@partial(jax.jit, static_argnames=("strict_grad",))
def _denom_flags_fused(reference, t_grad, strict_grad: bool):
    """denom/use_ongrid in one jit, gd columns freed inside (lean pass 1)."""
    return _denom_flags(*_gd_components(reference, t_grad, strict_grad))


@partial(jax.jit, static_argnames=("strict_grad", "i"))
def _gd_one(reference, t_grad, strict_grad: bool, i: int):
    """One gd column (lean pass 2): same accumulation order as
    :func:`_gd_components` so the f64 result is bit-identical."""
    acc = jnp.zeros(reference.size, dtype=reference.dtype)
    for j in range(3):
        up = jnp.roll(reference, -1, j)
        dn = jnp.roll(reference, 1, j)
        if strict_grad:
            axis_flat = (up < reference) & (dn < reference)
        else:
            axis_flat = (up <= reference) & (dn <= reference)
        grad_j = jnp.where(axis_flat, 0.0, (up - dn) * 0.5).reshape(-1)
        acc = acc + t_grad[i, j] * grad_j
    return acc


def precompute_rows(reference, parent, t_grad, strict_grad: bool):
    """(N,4) f64 walk-operand rows (no stop bits), built in bounded stages.

    f64 rows make the walk bit-exact to the f64 oracle semantics; bulk
    walking happens on the 8-byte quantised rows under the exactness
    screen, so the exact rows carry only the rare risky re-walks.
    The build is memory-critical at 512^3 (the f64 rows are 4.3 GB next to
    three 1.07 GB gd columns and the density): every step either donates
    its operand in place (column normalisation, column writes into the
    rows buffer) or frees its inputs immediately, and above
    ``_LEAN_ROWS_MIN_N`` voxels the gd columns are recomputed one at a
    time instead of held together (see the constant's comment).
    """
    t_grad = jnp.asarray(t_grad)
    n = reference.size
    dtype = jnp.float64
    if n >= _LEAN_ROWS_MIN_N:
        denom, use_ongrid = _denom_flags_fused(
            reference, t_grad, strict_grad)
        rows = jnp.zeros((n, 4), dtype=dtype)
        for j in range(3):
            col = _div_inplace(_gd_one(reference, t_grad, strict_grad, j),
                               denom)
            rows = _set_col(rows, col, j)
            del col
    else:
        gd = list(_gd_components(reference, t_grad, strict_grad))
        denom, use_ongrid = _denom_flags(*gd)
        rows = jnp.zeros((n, 4), dtype=dtype)
        for j in range(3):
            col = _div_inplace(gd[j], denom)
            gd[j] = None
            rows = _set_col(rows, col, j)
            del col
    del denom
    packed = _pack_parent(parent.reshape(-1), use_ongrid)
    return _store_packed(rows, packed)


@jax.jit
def _pack_parent(parent_flat, use_ongrid):
    self_idx = jnp.arange(parent_flat.shape[0], dtype=jnp.int32)
    return parent_flat | jnp.where(use_ongrid, _ONGRID_BIT, 0) \
        | jnp.where(parent_flat == self_idx, _MAX_BIT, 0)


@partial(jax.jit, donate_argnums=(0,))
def update_stop(rows, stop_flat):
    """Re-bake the per-call stop set into the rows, in place (donated).

    The stop set (refinement's known==2 interior) changes every
    iteration; updating lane 3 in the donated buffer avoids holding two
    multi-GB row fields alive.
    """
    pk = _packed_of(rows[:, 3]) & ~_STOP_BIT
    pk = pk | jnp.where(stop_flat, _STOP_BIT, 0)
    return _set_packed_col(rows, pk)


def _init_state(starts, dtype, screened: bool = False):
    pos0 = jnp.clip(starts, 0).astype(jnp.int32)
    done0 = starts < 0
    prev0 = jnp.full_like(pos0, -1)
    hist0 = jnp.full(starts.shape + (_HIST,), -1, dtype=jnp.int32)
    dr0 = jnp.zeros(starts.shape + (3,), dtype=dtype)
    if screened:
        err0 = jnp.zeros(starts.shape, dtype=jnp.float32)
        risky0 = jnp.zeros(starts.shape, dtype=bool)
        return pos0, prev0, hist0, dr0, done0, err0, risky0
    return pos0, prev0, hist0, dr0, done0


@partial(jax.jit, static_argnames=("shape", "strict_grad", "max_steps"))
def _walk_segment(state, rho_flat, parent_flat, stop_flat, t_grad,
                  shape: tuple, strict_grad: bool, max_steps: int):
    """Advance all live trajectories by up to ``max_steps`` steps.

    ``state`` is (pos, prev, hist, dr, done); returns the updated state
    with ``done`` refreshed from the final positions.  Pure function of its
    inputs — callers segment/compact/resume freely.
    """
    nx, ny, nz = shape
    dims = jnp.asarray([nx, ny, nz], dtype=jnp.int32)

    def flat(xyz):
        return (xyz[..., 0] * ny + xyz[..., 1]) * nz + xyz[..., 2]

    def unflat(p):
        return jnp.stack([p // (ny * nz), (p // nz) % ny, p % nz], axis=-1)

    def cond(carry):
        pos, prev, hist, dr, done, step = carry
        return (~jnp.all(done)) & (step < max_steps)

    def body(carry):
        pos, prev, hist, dr, done, step = carry
        # -- termination checks on the current position
        at_stop = jnp.take(stop_flat, pos, mode="clip")
        at_max = jnp.take(parent_flat, pos, mode="clip") == pos
        done = done | at_stop | at_max

        # -- central-difference gradient (6 axis-neighbour gathers)
        xyz = unflat(pos)  # (K, 3)
        rho_p = jnp.take(rho_flat, pos, mode="clip")
        grads = []
        for j in range(3):
            up = xyz.at[:, j].set((xyz[:, j] + 1) % dims[j])
            dn = xyz.at[:, j].set((xyz[:, j] - 1) % dims[j])
            rho_up = jnp.take(rho_flat, flat(up), mode="clip")
            rho_dn = jnp.take(rho_flat, flat(dn), mode="clip")
            if strict_grad:
                axis_flat = (rho_up < rho_p) & (rho_dn < rho_p)
            else:
                axis_flat = (rho_up <= rho_p) & (rho_dn <= rho_p)
            grads.append(jnp.where(axis_flat, 0.0, (rho_up - rho_dn) * 0.5))
        grad = jnp.stack(grads, axis=-1)  # (K, 3)

        gd = grad @ t_grad.T  # grad_dir_i = sum_j T[i, j] grad[j]
        mg = jnp.max(jnp.abs(gd), axis=-1, keepdims=True)
        use_ongrid = mg[:, 0] < 1e-14
        g = gd / jnp.where(mg > 0, mg, 1.0)

        int_grad = _round_away(g)
        dr_new = dr + g - int_grad
        int_dr = _round_away(dr_new)
        dr_after = dr_new - int_dr
        nxt_xyz = jnp.remainder(xyz + int_grad + int_dr, dims)
        nxt = flat(nxt_xyz)

        ongrid_next = jnp.take(parent_flat, pos, mode="clip")
        # gradient ~ 0 => ongrid step (methods.py:340-343 + revisit branch)
        nxt = jnp.where(use_ongrid, ongrid_next, nxt)
        # path revisit => ongrid step, dr reset.  The reference detects
        # revisits against the FULL path (refinement.py:200); a bounded
        # recent-history window (period <= 5 cycles) catches every cycle
        # the neargrid step rule produces in practice, and the step cap +
        # root fallback remains the backstop for anything longer.
        revisit = (nxt == pos) | (nxt == prev)
        for h in range(hist.shape[-1]):
            revisit = revisit | (nxt == hist[:, h])
        nxt = jnp.where(revisit, ongrid_next, nxt)
        reset = use_ongrid | revisit
        dr_after = jnp.where(reset[:, None], 0.0, dr_after)

        pos_new = jnp.where(done, pos, nxt)
        prev_new = jnp.where(done, prev, pos)
        hist_new = jnp.where(
            done[:, None], hist,
            jnp.concatenate([prev[:, None], hist[:, :-1]], axis=1))
        dr_out = jnp.where(done[:, None], dr, dr_after)
        return pos_new, prev_new, hist_new, dr_out, done, step + 1

    pos, prev, hist, dr, done = state
    pos, prev, hist, dr, done, _ = jax.lax.while_loop(
        cond, body, (pos, prev, hist, dr, done, jnp.int32(0))
    )
    # final termination flags for trajectories that stopped on the last step
    at_stop = jnp.take(stop_flat, pos, mode="clip")
    at_max = jnp.take(parent_flat, pos, mode="clip") == pos
    done = done | at_stop | at_max
    return pos, prev, hist, dr, done


@partial(jax.jit, static_argnames=("shape", "early_exit"))
def _walk_segment_packed(state, rows, shape: tuple, max_steps,
                         early_exit: bool = True):
    """Advance live trajectories with ONE row gather per step.

    Trajectory-for-trajectory identical to :func:`_walk_segment` (the
    per-position quantities are bit-equal precomputes; only ``dr``
    evolves in the loop).  ``rows`` is the (N,4) field of
    :func:`pack_rows`.  ``max_steps`` is a TRACED scalar: each bucket
    size compiles exactly once, whatever segment schedule the drain
    loop picks (static step counts multiplied compile time by the
    number of distinct (size, steps) pairs).

    ``early_exit=False`` drops the per-step ``~jnp.all(done)``
    convergence test (a cross-lane reduction serialized against every
    step): mid-decay drain segments almost never finish early — the
    drain loop shrinks the bucket long before the last lane retires —
    so the test is pure overhead there; the tail's single long segment
    keeps it.  Finished lanes freeze their state inside the body either
    way, so running past all-done is a no-op, never a wrong answer.
    """
    nx, ny, nz = shape
    dims = jnp.asarray([nx, ny, nz], dtype=jnp.int32)

    def flat(xyz):
        return (xyz[..., 0] * ny + xyz[..., 1]) * nz + xyz[..., 2]

    def unflat(p):
        return jnp.stack([p // (ny * nz), (p // nz) % ny, p % nz], axis=-1)

    def fetch(pos, done):
        row = jnp.take(rows, pos, axis=0, mode="clip")  # (K, 4)
        pk = _packed_of(row[:, 3])
        done = done | ((pk & (_MAX_BIT | _STOP_BIT)) != 0)
        return done, pk, row[:, :3]

    limit = jnp.asarray(max_steps, jnp.int32)

    def cond(carry):
        pos, prev, hist, dr, done, step = carry
        alive = ~jnp.all(done) if early_exit else jnp.bool_(True)
        return alive & (step < limit)

    def body(carry):
        pos, prev, hist, dr, done, step = carry
        done, pk, g = fetch(pos, done)
        use_ongrid = (pk & _ONGRID_BIT) != 0
        ongrid_next = pk & _IDX_MASK

        xyz = unflat(pos)
        int_grad = _round_away(g)
        dr_new = dr + g - int_grad
        int_dr = _round_away(dr_new)
        dr_after = dr_new - int_dr
        nxt = flat(jnp.remainder(xyz + int_grad + int_dr, dims))

        nxt = jnp.where(use_ongrid, ongrid_next, nxt)
        revisit = (nxt == pos) | (nxt == prev)
        for h in range(hist.shape[-1]):
            revisit = revisit | (nxt == hist[:, h])
        nxt = jnp.where(revisit, ongrid_next, nxt)
        reset = use_ongrid | revisit
        dr_after = jnp.where(reset[:, None], 0.0, dr_after)

        pos_new = jnp.where(done, pos, nxt)
        prev_new = jnp.where(done, prev, pos)
        hist_new = jnp.where(
            done[:, None], hist,
            jnp.concatenate([prev[:, None], hist[:, :-1]], axis=1))
        dr_out = jnp.where(done[:, None], dr, dr_after)
        return pos_new, prev_new, hist_new, dr_out, done, step + 1

    pos, prev, hist, dr, done = state
    pos, prev, hist, dr, done, _ = jax.lax.while_loop(
        cond, body, (pos, prev, hist, dr, done, jnp.int32(0))
    )
    done, _, _ = fetch(pos, done)
    return pos, prev, hist, dr, done


@partial(jax.jit, static_argnames=("shape", "early_exit"))
def _walk_segment_counted(state, rows, shape: tuple, max_steps,
                          early_exit: bool = True):
    """:func:`_walk_segment_packed` + fused live-lane count.

    The drain loop needs the alive count after every segment to drive
    compaction; folding the reduction into the segment program saves a
    dispatch per boundary and lets the host fetch one scalar that is
    ready the moment the segment is.
    """
    state = _walk_segment_packed(state, rows, shape, max_steps, early_exit)
    return state, jnp.sum(~state[4])


_FINE_BUCKETS = __import__("os").environ.get(
    "PYBADER_TPU_FINE_BUCKETS", "1") == "1"
# quarter-power bucket ladder (2^k, 5*2^(k-3), 3*2^(k-2), 7*2^(k-3))
# above this size: worst-case padding 14% instead of 33%.  Only the big
# buckets get the fine ladder — each extra size is ~3 more compiled
# programs (segment/compact/scatter), and below ~4M lanes the padding is
# cheap while the first-pass program-load cost is not.
_FINE_BUCKET_FLOOR = 1 << 22


def _bucket_size(n: int, min_batch: int = 4096) -> int:
    """Smallest ladder size >= max(n, min_batch).

    Ladder: 2^k and 3*2^k everywhere (worst-case bucket occupancy 67% ->
    75%); additionally 5*2^k and 7*2^k above _FINE_BUCKET_FLOOR (87.5%
    worst case where the padding actually costs seconds).  With the
    traced step bound each size still compiles exactly once ever.
    """
    n = max(int(n), min_batch)
    p2 = 1 << (n - 1).bit_length()
    cands = [p2, 3 << max((n - 1).bit_length() - 2, 0)]
    if _FINE_BUCKETS and n >= _FINE_BUCKET_FLOOR:
        cands += [5 << max((n - 1).bit_length() - 3, 0),
                  7 << max((n - 1).bit_length() - 3, 0)]
    best = p2
    for c in cands:
        if min_batch <= n <= c < best:
            best = c
    return best


def _pack_w(pos, done, risky=None):
    """Pack a lane's walk result into one int32 word.

    pos in bits [0:30) (grids < 2^30 voxels — asserted in walk_drain),
    done in the sign bit, risky (screened walks) at bit 30.
    The drain loop records retired lanes in this packed form so each
    compaction scatters ONE small word array of the lanes it drops,
    instead of 2-3 full-bucket arrays of every lane at every shrink."""
    w = pos | jnp.where(done, jnp.int32(-(1 << 31)), jnp.int32(0))
    if risky is not None:
        w = w | jnp.where(risky, jnp.int32(1 << 30), jnp.int32(0))
    return w


@jax.jit
def _unpack_w(w):
    return (w & jnp.int32((1 << 30) - 1), w < 0,
            (w & jnp.int32(1 << 30)) != 0)


@partial(jax.jit, donate_argnums=(0,))
def _scatter_w(out_w, idx, w):
    return out_w.at[idx].set(w, mode="drop")


@partial(jax.jit, static_argnames=())
def _map_pair(orig, kept, dropped):
    """Compose per-compaction lane maps through the running orig map."""
    return jnp.take(orig, kept), jnp.take(orig, dropped)


@jax.jit
def _final_w(state_pos, state_done):
    return _pack_w(state_pos, state_done)


@jax.jit
def _final_w_s(state_pos, state_done, state_risky):
    return _pack_w(state_pos, state_done, state_risky)


@partial(jax.jit, static_argnames=("size", "sort_pos"))
def _compact_state(state, size: int, sort_pos: bool = False):
    """Pack still-running lanes first and slice the batch to ``size``.

    Returns (packed state, kept (size,) original lane indices,
    dropped_w (K-size,) packed result words of the dropped lanes,
    dropped (K-size,) their lane indices).  Dropped lanes are all done
    (the bucket never shrinks below the live count), and their packed
    word records the actual done bit either way.
    The argsort is stable, so lane order within alive/done groups is
    preserved (walk results are order-independent anyway).

    ``sort_pos=True`` additionally orders the live lanes by their
    CURRENT grid position ((done << 30) | pos fits int32: pos < 2^28),
    so the next segments' row gathers hit memory in ascending address
    order — worth it only if the gather rate rewards locality.

    With f32 ``dr`` (the quantised-row walks) the whole state is packed
    into one (K, 8) INT32 matrix — [pos|done<<31, prev, hist x3,
    bitcast(dr) x3] — and moved by a single row gather instead of nine
    separate element gathers.  The packing direction matters: the
    converse (ints bitcast INTO an f32 matrix) is not bit-safe, since a
    float pipeline may canonicalise NaN bit patterns (-1 -> 0x7FC00000)
    and flush denormal-range ints (values < 2^23) to zero; integer ops
    never touch the payload.  f64 dr (exact rows) keeps the plain
    per-array gathers.
    """
    pos, prev, hist, dr, done = state
    if sort_pos:
        key = (done.astype(jnp.int32) << 30) | pos
        order = jnp.argsort(key).astype(jnp.int32)  # alive first, by pos
    else:
        order = jnp.argsort(done, stable=True).astype(jnp.int32)  # alive 1st
    kept = order[:size]
    dropped = order[size:]
    dropped_w = jnp.take(_pack_w(pos, done), dropped)
    if dr.dtype == jnp.float32:
        posd = pos | jnp.where(done, jnp.int32(-(1 << 31)), jnp.int32(0))
        mat = jnp.concatenate(
            [posd[:, None], prev[:, None], hist,
             jax.lax.bitcast_convert_type(dr, jnp.int32)], axis=1)
        sub = jnp.take(mat, kept, axis=0)
        posd2 = sub[:, 0]
        done2 = posd2 < 0
        pos2 = posd2 & jnp.int32(0x7FFFFFFF)
        dr2 = jax.lax.bitcast_convert_type(sub[:, 5:8], jnp.float32)
        return ((pos2, sub[:, 1], sub[:, 2:5], dr2, done2),
                kept, dropped_w, dropped)
    take = lambda a: jnp.take(a, kept, axis=0)  # noqa: E731
    return ((take(pos), take(prev), take(hist), take(dr), take(done)),
            kept, dropped_w, dropped)


@partial(jax.jit, static_argnames=("size", "sort_pos"))
def _compact_state_s(state, size: int, sort_pos: bool = False):
    """:func:`_compact_state` for the screened 7-field state.

    Same single packed int32 row gather; the extra fields ride as
    column 8 (bitcast f32 ``err``) and the ``risky`` bit at posd bit 30
    (pos < 2^30 — any grid the int32 flat index addresses in practice —
    leaves bit 30 free under the done sign bit).
    """
    pos, prev, hist, dr, done, err, risky = state
    if sort_pos:
        key = (done.astype(jnp.int32) << 30) | pos
        order = jnp.argsort(key).astype(jnp.int32)
    else:
        order = jnp.argsort(done, stable=True).astype(jnp.int32)
    kept = order[:size]
    dropped = order[size:]
    posd = _pack_w(pos, done, risky)
    dropped_w = jnp.take(posd, dropped)
    mat = jnp.concatenate(
        [posd[:, None], prev[:, None], hist,
         jax.lax.bitcast_convert_type(dr, jnp.int32),
         jax.lax.bitcast_convert_type(err, jnp.int32)[:, None]], axis=1)
    sub = jnp.take(mat, kept, axis=0)
    posd2 = sub[:, 0]
    done2 = posd2 < 0
    risky2 = (posd2 & (1 << 30)) != 0
    pos2 = posd2 & jnp.int32((1 << 30) - 1)
    dr2 = jax.lax.bitcast_convert_type(sub[:, 5:8], jnp.float32)
    err2 = jax.lax.bitcast_convert_type(sub[:, 8], jnp.float32)
    return ((pos2, sub[:, 1], sub[:, 2:5], dr2, done2, err2, risky2),
            kept, dropped_w, dropped)


def walk(starts: jax.Array, rho_flat: jax.Array, parent_flat: jax.Array,
         stop_flat: jax.Array, t_grad: jax.Array, shape: tuple,
         strict_grad: bool = False, max_steps: int = 0):
    """Walk neargrid trajectories from ``starts`` until they terminate.

    args:
        starts: (K,) int32 flat start voxels, padded with -1 (padding slots
                are born done).
        rho_flat: (N,) reference density.
        parent_flat: (N,) ongrid ascent pointers (fallback steps and maxima
                test: parent[p] == p iff p is an ongrid maximum).
        stop_flat: (N,) bool; *arriving* at a True voxel terminates the walk
                (the refinement driver passes known==2 "interior" voxels,
                reference refinement.py:294-303; pass all-False to walk to
                maxima).
        t_grad: (3,3) gradient -> voxel-step transform.
        shape: static (nx, ny, nz).
        strict_grad: gradient-zero test flavour — False for the initial
                method (`rho+ <= rho_p >= rho-`, methods.py:324), True for
                refinement (`rho+ < rho_p > rho-`, refinement.py:111).
        max_steps: safety cap; 0 means 2*(nx+ny+nz)+64.  Trajectories still
                running at the cap report done=False and the caller should
                resolve them through the ongrid roots.
    returns:
        (final_pos (K,) int32, done (K,) bool)
    """
    nx, ny, nz = shape
    if max_steps == 0:
        max_steps = 2 * (nx + ny + nz) + 64
    state = _init_state(starts, rho_flat.dtype)
    pos, _, _, _, done = _walk_segment(
        state, rho_flat, parent_flat, stop_flat, t_grad, shape,
        strict_grad, max_steps)
    return pos, done


# Boundary cost model of the adaptive count-fetch pipeline (walk_drain):
# the rate at which a segment advances lanes (one dependent row gather
# per lane-step) and the host round trip of one live-count fetch.
# chip_smoke.py measures both with _walk_segment_counted_qs at 4M lanes;
# the defaults are its readings on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit (6.644e9 lane-steps/s, 360 us).  Env-overridable for other
# hosts.
_GATHER_RATE = float(__import__("os").environ.get(
    "PYBADER_TPU_GATHER_RATE", 6.6e9))
_COUNT_RTT = float(__import__("os").environ.get(
    "PYBADER_TPU_COUNT_RTT", 3.6e-4))
# order live lanes by grid position at compaction boundaries (gather
# locality); off by default, env-overridable for on-device A/B runs
_SORT_COMPACT = __import__("os").environ.get(
    "PYBADER_TPU_SORT_COMPACT", "0") == "1"
_TAIL_BUCKET = 1 << 16  # below this, walk the whole remaining cap at once


def walk_drain(starts: jax.Array, rho_flat: jax.Array,
               parent_flat: jax.Array, stop_flat: jax.Array,
               t_grad: jax.Array, shape: tuple,
               strict_grad: bool = False, max_steps: int = 0,
               segments=(8, 8, 8, 8, 16, 16, 32, 32, 64),
               min_batch: int = _TAIL_BUCKET,
               progress=None, fields=None, screened: bool = False):
    """:func:`walk` with packed operands and tail-latency drain.

    Same contract and trajectory-identical results.  Two changes against
    the naive lockstep walk:

    - operands are precomputed (N,4) rows (:func:`precompute_rows`:
      gradient, T_grad transform, inf-norm normalisation and the packed
      parent/flags word — all pure functions of the voxel): ONE row
      gather per step instead of ~9 — the walk is bound by the chain of
      dependent gathers, so one wide gather beats several narrow ones;
    - walking proceeds in bounded-step slices; after each slice the
      still-running lanes are compacted into the smallest 2^k / 3*2^k
      bucket that holds them, so a step costs the live batch, not the
      initial one.  The slice schedule keeps slices short through the
      mid-decay (repeated 8/16/32-step slices: on a 384^3 edge-walk
      decay the first shrink lands at step 8 and wider mid-decay slices
      paid ~30% bucket padding); once the live set fits _TAIL_BUCKET
      lanes the rest of the walk is one early-exiting slice.

    ``fields``: optional (N,4) rows from :func:`precompute_rows` (with
    any stop bits already baked via :func:`update_stop`) — pass it when
    walking repeatedly against the same density (refinement iterations);
    ``stop_flat`` must then be None.
    ``progress``: optional callback(steps_done, n_alive) per segment.
    ``screened``: quantised rows only — track the per-lane exactness
    proof (:func:`_walk_segment_qs`) and return (pos, done, risky); the
    caller re-walks risky lanes on exact rows (walk_drain_screened).
    """
    nx, ny, nz = shape
    if max_steps == 0:
        max_steps = 2 * (nx + ny + nz) + 64
    env_seg = __import__("os").environ.get("PYBADER_TPU_SEGMENTS")
    if env_seg:  # on-device schedule A/B without code edits
        segments = tuple(int(s) for s in env_seg.split(","))
    if fields is None:
        rows = precompute_rows(
            rho_flat.reshape(shape), parent_flat.reshape(shape),
            jnp.asarray(t_grad), strict_grad)
        if stop_flat is not None:
            rows = update_stop(rows, stop_flat)
    else:
        assert stop_flat is None, "bake stop bits via update_stop"
        rows = fields
    # retired-lane words and the screened/f32 compactions pack flat
    # positions into bits [0:30) (done sign bit, risky bit 30): the drain
    # path supports grids below 2^30 voxels only (< 1024^3)
    assert rows.shape[0] < (1 << 30), (
        f"walk_drain packs positions into 30 bits; grid has "
        f"{rows.shape[0]} voxels (>= 2^30)")
    qmode = is_qrows(rows)
    if screened:
        assert qmode, "screened walking needs quantised rows"
        seg_fn = _walk_segment_counted_qs
    else:
        seg_fn = _walk_segment_counted_q if qmode else _walk_segment_counted
    k0 = int(starts.shape[0])
    state = _init_state(starts, jnp.float32 if qmode else rows.dtype,
                        screened=screened)
    # retired-lane results, packed one int32 word per lane (_pack_w);
    # allocated lazily on the first compaction.  Each shrink scatters
    # ONLY the lanes it drops (all done), and the final bucket flushes
    # once at the end — retired-lane bookkeeping costs O(k0) total
    # random ops instead of O(sum of bucket sizes) full-bucket scatters.
    out_w = None
    orig = None  # lane -> original index map once compacted
    size = k0

    # ADAPTIVELY PIPELINED segment loop.  Each boundary pays one of two
    # costs: blocking on the fused live count (one host round trip,
    # _COUNT_RTT, with the device idle meanwhile) or deferring the fetch
    # behind the next dispatched segment, which makes the bucket shrink
    # land one segment late (extra padded lane-steps = size x decay x
    # seg / _GATHER_RATE — large during the fast early decay, pennies
    # once the decay flattens).  The rule below predicts the lag cost
    # from the last observed decay ratio and defers only when it
    # undercuts the round trip.  Safety either way: live counts only ever DECREASE, so a
    # compaction bucket sized by a one-segment-stale count can never
    # drop a live lane.  Short mid-decay segments drop the per-step
    # all(done) reduction; the tail's single long segment keeps
    # the early exit, so a post-zero speculative segment retires after
    # one device-side test rather than a full slice.  Once the live set
    # fits _TAIL_BUCKET lanes the rest of the walk is a single dispatch.
    # PYBADER_TPU_DRAIN_TRACE=1: sync after every phase and print a
    # per-phase wall split to stderr (instrumentation runs only — the
    # syncs serialize the pipeline and add a round trip each)
    trace = __import__("os").environ.get(
        "PYBADER_TPU_DRAIN_TRACE") == "1"
    if trace:
        import sys as _sys
        import time as _time

        _tsync = jax.block_until_ready

        _tt = _time.perf_counter()

        def _tmark(label):
            nonlocal _tt
            now = _time.perf_counter()
            print(f"    [drain] {label}: {now - _tt:7.3f}s",
                  file=_sys.stderr, flush=True)
            _tt = now
    steps = 0
    seg_i = 0
    pending = None  # deferred count of the previous segment
    last_n = float(size)
    ratio = 0.5  # assume fast decay until measured: sync the first ones
    while steps < max_steps:
        remaining = max_steps - steps
        if size <= _TAIL_BUCKET:
            seg = remaining
        else:
            want = segments[min(seg_i, len(segments) - 1)]
            seg = max(1, min(want, remaining))
        seg_i += 1
        state, cnt = seg_fn(
            state, rows, shape, seg, early_exit=size <= _TAIL_BUCKET)
        steps += seg
        if trace:
            _tsync(state[0])
            _tmark(f"seg  {size:>9d} lanes x {seg:>3d} steps "
                   f"({size * seg / 1e6:6.1f}M)")
        lag_cost = size * max(0.0, 1.0 - ratio) * seg / _GATHER_RATE
        if trace:
            lag_cost = float("inf")  # always-fresh counts while tracing
        if lag_cost > _COUNT_RTT or steps >= max_steps:
            n_alive = int(cnt)  # fresh count; drop any deferred one
            pending = None
            at_steps = steps
            if trace:
                _tmark(f"count fetch ({n_alive} alive)")
        elif pending is None:
            pending = cnt  # defer: dispatch the next segment first
            continue
        else:
            n_alive = int(pending)  # stale by one segment; device is
            pending = cnt           # already crunching the fresh one
            at_steps = steps - seg
        r = n_alive / max(last_n, 1.0)
        ratio = min(1.0, r if last_n else 1.0)
        last_n = float(max(n_alive, 1))
        if progress is not None:
            progress(at_steps, n_alive)
        if n_alive == 0:
            # any in-flight segment froze every lane: value-equal state
            break
        new_size = _bucket_size(n_alive, min_batch)
        if new_size < size and size > min_batch:
            compact = _compact_state_s if screened else _compact_state
            packed, kept, dropped_w, dropped = compact(
                state, new_size, sort_pos=_SORT_COMPACT)
            if orig is not None:
                kept, dropped = _map_pair(orig, kept, dropped)
            if out_w is None:
                out_w = jnp.zeros(k0, jnp.int32)
            out_w = _scatter_w(out_w, dropped, dropped_w)
            if trace:
                _tsync(packed[0])
                _tmark(f"compact {size:>9d} -> {new_size:>9d}")
            orig = kept
            state = packed
            size = new_size
    if orig is None:
        # never compacted: the state itself holds every lane's result
        if screened:
            return state[0], state[4], state[6]
        return state[0], state[4]
    if screened:
        w_final = _final_w_s(state[0], state[4], state[6])
    else:
        w_final = _final_w(state[0], state[4])
    out_w = _scatter_w(out_w, orig, w_final)
    out_pos, out_done, out_risky = _unpack_w(out_w)
    if screened:
        return out_pos, out_done, out_risky
    return out_pos, out_done


def walk_drain_screened(starts: jax.Array, t_grad: jax.Array, shape: tuple,
                        qfields, exact_fields_fn, strict_grad: bool = True,
                        max_steps: int = 0, progress=None, stats=None):
    """Exact-parity walk at quantised-row cost.

    Every lane walks the 8-byte quantised rows with the per-decision
    exactness screen (:func:`_walk_segment_qs`); the lanes the screen
    could not prove decision-identical to the exact-row walk (typically
    a small fraction — rounding decisions within ~3e-6/step of the
    0.5 thresholds) are re-walked from scratch on the exact rows, which
    ``exact_fields_fn()`` supplies lazily (same stop bits baked).  The
    combined result is bit-identical to walking every lane on the exact
    rows, at roughly half the gather bytes.

    ``stats``, if a dict, receives ``stats['risky']`` — the flagged-lane
    count, the observable cost of the screen.
    returns (pos, done) exactly like :func:`walk_drain`.
    """
    pos, done, risky = walk_drain(
        starts, None, None, None, t_grad, shape, strict_grad=strict_grad,
        max_steps=max_steps, fields=qfields, progress=progress,
        screened=True)
    # padding lanes are born done and never step: risky stays False there
    n_risky = int(jnp.sum(risky))
    if stats is not None:
        stats["risky"] = n_risky
    if n_risky == 0:
        return pos, done
    rows = exact_fields_fn()
    size = _bucket_size(n_risky, 4096)
    # risky lanes first (stable), then re-walk the first `size` lanes on
    # exact rows and overwrite.  Bucket padding re-walks some unflagged
    # lanes — harmless: the screen proved their exact-row walk identical.
    order = jnp.argsort(~risky, stable=True).astype(jnp.int32)
    sel = order[:size]
    rstarts = jnp.take(starts, sel)
    rpos, rdone = walk_drain(
        rstarts, None, None, None, t_grad, shape, strict_grad=strict_grad,
        max_steps=max_steps, fields=rows)
    pos = pos.at[sel].set(rpos)
    done = done.at[sel].set(rdone)
    return pos, done


def pad_starts(idx, min_size: int = 4096):
    """Pad a flat index list to the next power-of-two length with -1.

    Bucketing lengths limits jit recompilation of the walker across
    refinement iterations (one compile per bucket size; the step bound
    is traced).
    """
    n = max(int(len(idx)), 1)
    size = max(min_size, 1 << (n - 1).bit_length())
    out = np.full(size, -1, dtype=np.int32)
    out[: len(idx)] = idx
    return out
