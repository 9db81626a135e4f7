"""Tests: quantised 8-byte walker rows (ops/neargrid.py q-row fast path).

The q-walker must be trajectory-identical to the f32 packed walker ON THE
SAME (dequantised) gradient field — that isolates the walker logic (word
decode, offset-code ongrid fallback, revisit window, stop bits, drain
compaction) from the quantisation itself, whose accuracy-vs-speed story
is recorded separately (PERF.md, "Hybrid accuracy").
"""
import numpy as np
import jax.numpy as jnp

from tests.test_ongrid import LATTICE, SHAPE, make_density

from pybader_tpu import grid as g
from pybader_tpu import pipeline
from pybader_tpu.ops import neargrid as ng
from pybader_tpu.ops import edges as edges_ops
from pybader_tpu.ops.stencil import ongrid_step_codes, parent_from_step_codes


def _setup(seed=0):
    rho = make_density(seed)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)
    return rho, w, tg


def _dequantized_f32_rows(qrows, bk):
    """f32 (N,4) rows carrying EXACTLY the q-rows' dequantised gradient.

    Walking these through the f32 packed walker gives the ground truth the
    q-walker must reproduce bit-for-bit.
    """
    w0 = np.asarray(qrows[:, 0])
    w1 = np.asarray(qrows[:, 1])
    # 19-bit layout decode (mirrors ng._q_decode)
    q0 = (w0 << 13) >> 13
    q1 = ((((w0 >> 19) & 0x1FFF) | ((w1 & 0x3F) << 13)) << 13) >> 13
    q2 = (w1 << 7) >> 13
    q = np.stack([q0, q1, q2], axis=1)
    # match the in-kernel dequantisation op-for-op
    gcols = q.astype(np.float32) * np.float32(1.0 / ng._Q_SCALE)
    parent_flat = np.asarray(parent_from_step_codes(bk)).reshape(-1)
    use_ongrid = (w1 & np.int32(1 << 30)) != 0
    self_idx = np.arange(parent_flat.shape[0], dtype=np.int32)
    packed = parent_flat.astype(np.int32)
    packed = packed | np.where(use_ongrid, np.int32(1 << 28), 0)
    packed = packed | np.where(parent_flat == self_idx, np.int32(1 << 29), 0)
    rows = np.zeros((parent_flat.shape[0], 4), dtype=np.float32)
    rows[:, :3] = gcols
    rows[:, 3] = packed.view(np.float32)
    return jnp.asarray(rows)


def test_qwalker_matches_f32_on_dequantized_field():
    rho, w, tg = _setup(2)
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    qrows = ng.precompute_qrows(jnp.asarray(rho), bk, jnp.asarray(tg),
                                strict_grad=True)
    frows = _dequantized_f32_rows(qrows, bk)

    n = int(np.prod(SHAPE))
    rng = np.random.default_rng(7)
    starts = rng.choice(n, size=min(n - 1, 1500),
                        replace=False).astype(np.int32)
    padded = jnp.asarray(ng.pad_starts(starts))
    # a nontrivial stop set exercises the STOP bit on both row formats
    stop = np.zeros(n, dtype=bool)
    stop[rng.choice(n, size=n // 20, replace=False)] = True
    stop[starts] = False
    stop_dev = jnp.asarray(stop)

    kw = dict(shape=SHAPE, strict_grad=True, segments=(2, 2, 4),
              min_batch=64)
    q_baked = ng.update_stop_q(qrows, stop_dev)
    pos_q, done_q = ng.walk_drain(
        padded, None, None, None, jnp.asarray(tg), fields=q_baked, **kw)
    f_baked = ng.update_stop(frows, stop_dev)
    pos_f, done_f = ng.walk_drain(
        padded, None, None, None, jnp.asarray(tg), fields=f_baked, **kw)
    np.testing.assert_array_equal(np.asarray(pos_q), np.asarray(pos_f))
    np.testing.assert_array_equal(np.asarray(done_q), np.asarray(done_f))


def test_update_stop_q_rebake():
    """Stop bits re-bake cleanly: a second update fully replaces the
    first (walkers terminate only at the new set)."""
    rho, w, tg = _setup(3)
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    qrows = ng.precompute_qrows(jnp.asarray(rho), bk, jnp.asarray(tg),
                                strict_grad=True)
    n = int(np.prod(SHAPE))
    stop_a = jnp.asarray(np.arange(n) % 3 == 0)
    stop_b = jnp.asarray(np.arange(n) % 5 == 1)
    qa = ng.update_stop_q(qrows, stop_a)
    qb = ng.update_stop_q(qa, stop_b)
    w1 = np.asarray(qb[:, 1])
    got_stop = w1 < 0  # STOP rides the sign bit
    np.testing.assert_array_equal(got_stop, np.asarray(stop_b))
    # the quantised payload survives both rebakes
    fresh = ng.precompute_qrows(jnp.asarray(rho), bk, jnp.asarray(tg),
                                strict_grad=True)
    np.testing.assert_array_equal(np.asarray(qb[:, 0]),
                                  np.asarray(fresh[:, 0]))
    mask = np.int32(0x7FFFFFFF)
    np.testing.assert_array_equal(w1 & mask,
                                  np.asarray(fresh[:, 1]) & mask)


def test_screen_flags_near_threshold_decisions():
    """The exactness screen must FIRE when a rounding decision sits
    within the error bound of the 0.5 threshold (not pass vacuously)."""
    import jax

    shape = (8, 8, 8)
    n = 8 * 8 * 8
    # hand-built rows: voxel 0 steps with g dequantising to 0.4999981 —
    # within 2.2e-6 of the +0.5 threshold; every other voxel is a
    # maximum (code 13), so the walk ends on its next step.
    q_near = int(ng._Q_SCALE) // 2  # 131071 -> 0.49999809...
    w0 = np.zeros(n, np.int32)
    w1 = np.zeros(n, np.int32)
    w0[0] = q_near & 0x7FFFF  # g0 ~ 0.5 - 1.9e-6, g1 = g2 = 0
    w1[:] = np.int32(13 << ng._Q_CODE_SHIFT)  # code 13 == maximum...
    w1[0] = np.int32(12 << ng._Q_CODE_SHIFT)  # ...except the start
    qrows = jnp.asarray(np.stack([w0, w1], axis=1))
    starts = jnp.asarray(np.array([0] + [-1] * 63, np.int32))
    state = ng._init_state(starts, jnp.float32, screened=True)
    out = ng._walk_segment_qs(state, qrows, shape, 4)
    assert bool(out[6][0]), "near-threshold decision did not flag risky"

    # same construction with a comfortable margin must NOT flag
    w0b = w0.copy()
    w0b[0] = int(round(0.4 * ng._Q_SCALE)) & 0x7FFFF
    qrows_b = jnp.asarray(np.stack([w0b, w1], axis=1))
    out_b = ng._walk_segment_qs(state, qrows_b, shape, 4)
    assert not bool(out_b[6][0]), "far-margin decision flagged risky"
    del jax


def test_screened_rewalk_merge_path(monkeypatch):
    """With the error bound blown up, EVERY lane flags risky and the
    re-walk-on-exact-rows merge must reproduce the pure exact walk."""
    rho, w, tg = _setup(4)
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    qrows = ng.precompute_qrows(jnp.asarray(rho), bk, jnp.asarray(tg),
                                strict_grad=True)
    frows = _dequantized_f32_rows(qrows, bk)
    n = int(np.prod(SHAPE))
    rng = np.random.default_rng(9)
    starts = rng.choice(n, size=2000, replace=False).astype(np.int32)
    padded = jnp.asarray(ng.pad_starts(starts))
    stop = np.zeros(n, dtype=bool)
    stop[rng.choice(n, size=n // 30, replace=False)] = True
    stop[starts] = False
    stop_dev = jnp.asarray(stop)
    q_baked = ng.update_stop_q(qrows, stop_dev)
    f_baked = ng.update_stop(frows, stop_dev)

    monkeypatch.setattr(ng, "_QS_EPS", jnp.float32(10.0))
    # _QS_EPS is baked into traces: drop any cached compilations
    ng._walk_segment_qs.clear_cache()
    ng._walk_segment_counted_qs.clear_cache()
    stats = {}
    pos_s, done_s = ng.walk_drain_screened(
        padded, jnp.asarray(tg), SHAPE, q_baked,
        lambda: f_baked, strict_grad=True, stats=stats)
    assert stats["risky"] >= len(starts) - 1, stats
    pos_f, done_f = ng.walk_drain(
        padded, None, None, None, jnp.asarray(tg), SHAPE,
        strict_grad=True, fields=f_baked)
    np.testing.assert_array_equal(np.asarray(pos_s), np.asarray(pos_f))
    np.testing.assert_array_equal(np.asarray(done_s), np.asarray(done_f))
    # drop the blown-up-eps compilations so later tests retrace clean
    ng._walk_segment_qs.clear_cache()
    ng._walk_segment_counted_qs.clear_cache()


def test_refine_quantized_close_to_exact(monkeypatch):
    """Pipeline-level: quantised refinement deviates from exact f32/f64
    refinement only at knife-edge voxels (rare on a generic field)."""
    monkeypatch.setenv("PYBADER_TPU_QROWS_CPU", "1")
    rho, w, tg = _setup(5)
    labels0, _ = pipeline.partition_ongrid(rho, None, w)
    lab_e, ch_e = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, labels0, w, tg,
        verbose=False, quantized=False)
    lab_q, ch_q = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, labels0, w, tg,
        verbose=False, quantized=True)
    mism = np.mean(np.asarray(lab_e) != np.asarray(lab_q))
    assert mism < 0.01, f"quantised refinement flipped {mism:.2%} of voxels"


def test_hybrid_carry_rebuilds_rows_across_format(monkeypatch):
    """Quantised internal iterations + exact user iterations via the
    carry: the format boundary rebuilds the rows and the composition
    still converges to the same fixed point as the all-exact run."""
    from tests.test_io import ATOMS
    from tests.oracle import gaussian_density
    from pybader_tpu.ops import reductions
    import pybader_tpu.grid as grid_mod

    monkeypatch.setenv("PYBADER_TPU_QROWS_CPU", "1")
    centers = ATOMS @ np.linalg.inv(LATTICE)
    rho = gaussian_density(SHAPE, LATTICE, centers, [0.9, 0.8], [2.0, 1.5])
    rho = rho + 1e-8
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)
    labels0, maxima = pipeline.partition_ongrid(rho, None, w)

    carry = {}
    lab_q, _ = pipeline.refine_labels(
        "neargrid", ("changed", 1), rho, labels0, w, tg,
        verbose=False, carry_out=carry, quantized=True)
    assert ng.is_qrows(carry["fields"])
    lab_q, _ = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, lab_q, w, tg,
        verbose=False, carry_in=carry, quantized=False)

    lab_e, _ = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, labels0, w, tg,
        verbose=False, quantized=False)
    # converged-state charges agree (label maps can differ at degenerate
    # voxels when convergence is reached along different paths)
    vv = grid_mod.voxel_volume(LATTICE, SHAPE)
    c_q, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_q), vv, len(maxima))
    c_e, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_e), vv, len(maxima))
    np.testing.assert_allclose(np.asarray(c_q), np.asarray(c_e), rtol=1e-9)


def test_lean_rows_build_bit_identical(monkeypatch):
    """The two-pass lean precompute_rows (512^3 memory-bounded path) is bit-equal to
    the single-pass build: same gradient accumulation order, so the f64
    columns and the packed word must match exactly."""
    rho, w, tg = _setup(6)
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    parent = parent_from_step_codes(bk)
    rows_1pass = ng.precompute_rows(
        jnp.asarray(rho), parent, jnp.asarray(tg), strict_grad=True)
    monkeypatch.setattr(ng, "_LEAN_ROWS_MIN_N", 0)
    rows_lean = ng.precompute_rows(
        jnp.asarray(rho), parent, jnp.asarray(tg), strict_grad=True)
    np.testing.assert_array_equal(
        np.asarray(rows_1pass).view(np.int64),
        np.asarray(rows_lean).view(np.int64))
