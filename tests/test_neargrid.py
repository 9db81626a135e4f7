"""Tests: vectorised neargrid walker vs serial spec; refinement invariants."""
import numpy as np
import jax.numpy as jnp

from tests.oracle import (
    gaussian_density, neargrid_trajectory, ongrid_oracle, edge_scan,
)
from tests.test_ongrid import LATTICE, SHAPE, make_density

from pybader_tpu import grid as g
from pybader_tpu import pipeline
from pybader_tpu.ops import neargrid as ng
from pybader_tpu.ops import edges as edges_ops
from pybader_tpu.ops.stencil import ongrid_parent
from pybader_tpu.ops.pointer import resolve_roots


def _setup(seed=0):
    rho = make_density(seed)
    w = g.distance_weights(LATTICE, SHAPE)
    tg = g.t_grad(LATTICE, SHAPE)
    return rho, w, tg


def test_walker_matches_serial_spec():
    rho, w, tg = _setup(0)
    parent = ongrid_parent(jnp.asarray(rho), tuple(w), None)
    parent_flat = parent.reshape(-1)
    rho_flat = jnp.asarray(rho).reshape(-1)
    n = rho_flat.shape[0]
    stop = jnp.zeros((n,), dtype=bool)
    rng = np.random.default_rng(42)
    starts = rng.choice(n, size=64, replace=False).astype(np.int32)
    padded = jnp.asarray(ng.pad_starts(starts))
    pos, done = ng.walk(
        padded, rho_flat, parent_flat, stop, jnp.asarray(tg), SHAPE,
        strict_grad=False,
    )
    pos = np.asarray(pos)[: len(starts)]
    assert np.asarray(done)[: len(starts)].all()
    ny, nz = SHAPE[1], SHAPE[2]
    for s, p in zip(starts, pos):
        sv = (s // (ny * nz), (s // nz) % ny, s % nz)
        expect = neargrid_trajectory(rho, w, tg, sv, strict_grad=False)
        got = (p // (ny * nz), (p // nz) % ny, p % nz)
        assert got == expect, f"start {sv}: got {got}, want {expect}"


def test_walker_with_stop_mask():
    rho, w, tg = _setup(1)
    labels, _ = ongrid_oracle(rho, w)
    known = edge_scan(rho, labels)
    parent = ongrid_parent(jnp.asarray(rho), tuple(w), None)
    starts = np.flatnonzero(known.reshape(-1) == -2).astype(np.int32)[:64]
    stop = jnp.asarray((known == 2).reshape(-1))
    padded = jnp.asarray(ng.pad_starts(starts))
    pos, done = ng.walk(
        padded, jnp.asarray(rho).reshape(-1), parent.reshape(-1), stop,
        jnp.asarray(tg), SHAPE, strict_grad=True,
    )
    pos = np.asarray(pos)[: len(starts)]
    ny, nz = SHAPE[1], SHAPE[2]
    stop_h = np.asarray(stop)
    for s, p in zip(starts, pos):
        sv = (s // (ny * nz), (s // nz) % ny, s % nz)
        expect = neargrid_trajectory(
            rho, w, tg, sv, stop_mask=(known == 2), strict_grad=True
        )
        got = (p // (ny * nz), (p // nz) % ny, p % nz)
        assert got == expect, f"start {sv}: got {got}, want {expect}"


def test_edge_find_matches_oracle():
    rho, w, _ = _setup(2)
    labels, _ = ongrid_oracle(rho, w)
    known = np.asarray(edges_ops.edge_find(jnp.asarray(rho), jnp.asarray(labels)))
    ref = edge_scan(rho, labels)
    np.testing.assert_array_equal(known, ref)


def test_edge_find_with_vacuum():
    rho, w, _ = _setup(3)
    vac = rho <= np.quantile(rho, 0.3)
    labels, _ = ongrid_oracle(rho, w, vacuum=vac)
    known = np.asarray(edges_ops.edge_find(jnp.asarray(rho), jnp.asarray(labels)))
    ref = edge_scan(rho, labels)
    np.testing.assert_array_equal(known, ref)


def test_neargrid_partition_covers_grid():
    rho, w, tg = _setup(4)
    labels, maxima = pipeline.partition_neargrid(rho, None, tuple(w), tg)
    labels = np.asarray(labels)
    assert (labels >= 0).all()
    assert labels.max() == len(maxima) - 1
    # every maximum voxel is labelled with its own basin id
    for i, m in enumerate(maxima):
        assert labels[tuple(m)] == i


def test_refinement_converges_and_is_idempotent():
    rho, w, tg = _setup(5)
    labels, maxima = pipeline.partition_ongrid(rho, None, tuple(w))
    refined, changed1 = pipeline.refine_labels(
        "neargrid", ("all", -1), rho, labels, tuple(w), tg, verbose=False
    )
    # converged: running again changes nothing
    refined2, changed2 = pipeline.refine_labels(
        "neargrid", ("all", -1), rho, refined, tuple(w), tg, verbose=False
    )
    assert changed2 == 0
    np.testing.assert_array_equal(np.asarray(refined), np.asarray(refined2))
    # label set is preserved (no basin ids invented)
    assert set(np.unique(np.asarray(refined))) <= set(
        range(len(maxima))
    ) | {-1}


def test_refine_modes_agree_at_convergence():
    rho, w, tg = _setup(6)
    labels, _ = pipeline.partition_ongrid(rho, None, tuple(w))
    ref_all, _ = pipeline.refine_labels(
        "neargrid", ("all", -1), rho, labels, tuple(w), tg, verbose=False
    )
    ref_chg, _ = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, labels, tuple(w), tg, verbose=False
    )
    np.testing.assert_array_equal(np.asarray(ref_all), np.asarray(ref_chg))


def test_unknown_refine_method_is_noop():
    rho, w, tg = _setup(7)
    labels, _ = pipeline.partition_ongrid(rho, None, tuple(w))
    out, changed = pipeline.refine_labels(
        "ongrid", ("changed", 2), rho, labels, tuple(w), tg, verbose=False
    )
    assert changed == 0
    np.testing.assert_array_equal(np.asarray(out), np.asarray(labels))


def test_neargrid_hybrid_mode_converges_same():
    """Hybrid (ongrid + refine-to-convergence) vs full trajectories.

    Both approximate the refined fixed point; per-basin charges must agree
    tightly on a well-separated density.
    """
    from tests.test_io import ATOMS
    from tests.oracle import gaussian_density

    centers = ATOMS @ np.linalg.inv(LATTICE)
    rho = gaussian_density(SHAPE, LATTICE, centers, [0.9, 0.8], [2.0, 1.5])
    rho = rho + 1e-8
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)
    lab_full, max_full = pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=True
    )
    lab_hyb, max_hyb = pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=False
    )
    assert len(max_full) == len(max_hyb)
    from pybader_tpu.ops import reductions
    import pybader_tpu.grid as grid_mod

    vv = grid_mod.voxel_volume(LATTICE, SHAPE)
    c_full, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_full), vv, len(max_full)
    )
    c_hyb, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_hyb), vv, len(max_hyb)
    )
    np.testing.assert_allclose(
        np.sort(np.asarray(c_full)), np.sort(np.asarray(c_hyb)), rtol=1e-3
    )


def test_refine_carry_chain_matches_continuous():
    """Chained carry refinement == one continuous ('changed', k) call.

    The hybrid partition's internal ('changed', 3) refinement plus a
    carry-chained user ('changed', 2) call must be bit-identical to
    running ('changed', 5) in a single call on the ongrid init: the carry
    resumes the same loop (pipeline.refine_labels docstring).
    """
    rho, w, tg = _setup(3)
    w = tuple(w)
    labels0, _ = pipeline.partition_ongrid(rho, None, w)

    carry = {}
    lab_a, _ = pipeline.refine_labels(
        "neargrid", ("changed", 3), rho, labels0, w, tg,
        verbose=False, carry_out=carry)
    assert carry, "carry_out not populated"
    lab_a, _ = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, lab_a, w, tg,
        verbose=False, carry_in=carry)

    lab_b, _ = pipeline.refine_labels(
        "neargrid", ("changed", 5), rho, labels0, w, tg, verbose=False)
    np.testing.assert_array_equal(np.asarray(lab_a), np.asarray(lab_b))


def test_refine_carry_converged_short_circuits():
    """A converged carry makes the follow-up call a no-op."""
    rho, w, tg = _setup(4)
    w = tuple(w)
    labels0, _ = pipeline.partition_ongrid(rho, None, w)
    carry = {}
    lab, _ = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, labels0, w, tg,
        verbose=False, carry_out=carry)
    assert carry.get("converged"), carry.keys()
    lab2, changed = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, lab, w, tg,
        verbose=False, carry_in=carry)
    assert changed == 0
    np.testing.assert_array_equal(np.asarray(lab), np.asarray(lab2))


def test_partition_neargrid_hybrid_carry_out():
    """partition_neargrid(full_trajectories=False) fills carry_out and the
    chained user refinement reproduces the unchained composition at the
    converged fixed point (same charges)."""
    from tests.test_io import ATOMS
    from tests.oracle import gaussian_density
    from pybader_tpu.ops import reductions
    import pybader_tpu.grid as grid_mod

    centers = ATOMS @ np.linalg.inv(LATTICE)
    rho = gaussian_density(SHAPE, LATTICE, centers, [0.9, 0.8], [2.0, 1.5])
    rho = rho + 1e-8
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)

    carry = {}
    lab_c, max_c = pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=False, carry_out=carry)
    assert carry, "hybrid path should populate carry_out"
    lab_c, _ = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, lab_c, w, tg,
        verbose=False, carry_in=carry)

    lab_u, max_u = pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=False)
    lab_u, _ = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, lab_u, w, tg, verbose=False)

    assert len(max_c) == len(max_u)
    vv = grid_mod.voxel_volume(LATTICE, SHAPE)
    c_c, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_c), vv, len(max_c))
    c_u, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_u), vv, len(max_u))
    np.testing.assert_allclose(np.asarray(c_c), np.asarray(c_u), rtol=1e-9)


def test_full_trajectories_env_override(monkeypatch):
    """PYBADER_TPU_FULL_TRAJECTORIES flips the default path selection.

    =0 forces the hybrid even below the size threshold (detectable: the
    hybrid fills carry_out, the full-trajectory path leaves it empty),
    =1 forces full trajectories; an explicit full_trajectories argument
    is never overridden.
    """
    rho, w, tg = _setup(5)
    w = tuple(w)

    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "0")
    carry = {}
    lab_h, max_h = pipeline.partition_neargrid(
        rho, None, w, tg, carry_out=carry)
    assert carry, "=0 must select the hybrid (carry_out filled)"

    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "1")
    carry = {}
    lab_f, max_f = pipeline.partition_neargrid(
        rho, None, w, tg, carry_out=carry)
    assert not carry, "=1 must select full trajectories (carry_out empty)"

    # explicit argument wins over the env var
    carry = {}
    pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=False, carry_out=carry)
    assert carry, "explicit full_trajectories=False must beat the env var"


def test_refine_chunked_walk_matches_unchunked(monkeypatch):
    """The memory-bounding chunked walk (normally only at 512^3-class edge
    sets) must produce identical refinement to the single-bucket walk."""
    rho, w, tg = _setup(6)
    w = tuple(w)
    labels0, _ = pipeline.partition_ongrid(rho, None, w)
    ref_a, ch_a = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, labels0, w, tg, verbose=False)
    monkeypatch.setattr(pipeline, "_WALK_CHUNK_CAP", 2048)
    ref_b, ch_b = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, labels0, w, tg, verbose=False)
    assert ch_a == ch_b
    np.testing.assert_array_equal(np.asarray(ref_a), np.asarray(ref_b))


def test_walk_drain_sort_compact_invariant(monkeypatch):
    """Position-sorted compaction (_SORT_COMPACT, a gather-locality
    knob) must leave walk results untouched: walks are per-trajectory
    independent, so lane order is free."""
    rho, w, tg = _setup(3)
    parent = ongrid_parent(jnp.asarray(rho), tuple(w), None)
    rho_flat = jnp.asarray(rho).reshape(-1)
    n = rho_flat.shape[0]
    stop = jnp.zeros((n,), dtype=bool)
    rng = np.random.default_rng(11)
    starts = rng.choice(n, size=min(n - 1, 1500),
                        replace=False).astype(np.int32)
    padded = jnp.asarray(ng.pad_starts(starts))
    kw = dict(shape=SHAPE, strict_grad=False, segments=(2, 2, 4),
              min_batch=64)
    pos_a, done_a = ng.walk_drain(
        padded, rho_flat, parent.reshape(-1), stop, jnp.asarray(tg), **kw)
    monkeypatch.setattr(ng, "_SORT_COMPACT", True)
    pos_b, done_b = ng.walk_drain(
        padded, rho_flat, parent.reshape(-1), stop, jnp.asarray(tg), **kw)
    np.testing.assert_array_equal(np.asarray(pos_a), np.asarray(pos_b))
    np.testing.assert_array_equal(np.asarray(done_a), np.asarray(done_b))
