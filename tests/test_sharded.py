"""Mesh-shape parity: sharded partition must match single-device exactly.

The device-mesh analog of the reference's thread-count-invariance assumption
(results must not depend on the chunking).  Runs on 8 virtual CPU devices
(see conftest.py).
"""
import numpy as np
import jax

from tests.test_ongrid import LATTICE, SHAPE, make_density

from pybader_tpu import grid as g
from pybader_tpu import pipeline
from pybader_tpu.parallel import make_mesh, sharded_partition, sharded_step


def test_virtual_device_count():
    assert len(jax.devices()) == 8


def test_sharded_partition_matches_single_device():
    rho = make_density(0)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    labels_1, maxima_1 = pipeline.partition_ongrid(rho, None, w)
    for n in (2, 4, 8):
        mesh = make_mesh(n)
        labels_n, maxima_n = sharded_partition(mesh, rho, None, w)
        np.testing.assert_array_equal(
            np.asarray(labels_n), np.asarray(labels_1)
        )
        np.testing.assert_array_equal(maxima_n, maxima_1)


def test_sharded_partition_with_vacuum():
    rho = make_density(1)
    vac = rho <= np.quantile(rho, 0.3)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    labels_1, maxima_1 = pipeline.partition_ongrid(rho, vac, w)
    mesh = make_mesh(8)
    labels_n, maxima_n = sharded_partition(mesh, rho, vac, w)
    np.testing.assert_array_equal(np.asarray(labels_n), np.asarray(labels_1))
    np.testing.assert_array_equal(maxima_n, maxima_1)


def test_sharded_refinement_matches_single_device():
    rho = make_density(3)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)
    labels_1, _ = pipeline.partition_ongrid(rho, None, w)
    ref_1, ch_1 = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, labels_1, w, tg, verbose=False
    )
    for n in (2, 4, 8):
        mesh = make_mesh(n)
        labels_n, _ = pipeline.partition_ongrid(rho, None, w, mesh=mesh)
        ref_n, ch_n = pipeline.refine_labels(
            "neargrid", ("changed", 2), rho, labels_n, w, tg,
            verbose=False, mesh=mesh,
        )
        assert ch_n == ch_1
        np.testing.assert_array_equal(np.asarray(ref_n), np.asarray(ref_1))


def test_sharded_refinement_with_vacuum():
    rho = make_density(5)
    vac = rho <= np.quantile(rho, 0.25)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)
    labels_1, _ = pipeline.partition_ongrid(rho, vac, w)
    ref_1, ch_1 = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, labels_1, w, tg, verbose=False
    )
    mesh = make_mesh(8)
    labels_n, _ = pipeline.partition_ongrid(rho, vac, w, mesh=mesh)
    ref_n, ch_n = pipeline.refine_labels(
        "neargrid", ("changed", -1), rho, labels_n, w, tg,
        verbose=False, mesh=mesh,
    )
    assert ch_n == ch_1
    np.testing.assert_array_equal(np.asarray(ref_n), np.asarray(ref_1))


def test_sharded_full_pipeline_via_bader_mesh(tmp_path, monkeypatch):
    """End-to-end Bader() on 2/4/8-device meshes matches single-device."""
    from tests.test_interface import make_bader

    monkeypatch.chdir(tmp_path)
    b1 = make_bader(tmp_path)
    b1(output='dat')
    for n in (2, 4, 8):
        bn = make_bader(tmp_path)
        bn.mesh = make_mesh(n)
        bn(output='dat')
        np.testing.assert_array_equal(
            np.asarray(bn.bader_volumes), np.asarray(b1.bader_volumes)
        )
        np.testing.assert_array_equal(
            np.asarray(bn.atoms_volumes), np.asarray(b1.atoms_volumes)
        )
        np.testing.assert_allclose(
            bn.atoms_charge, b1.atoms_charge, atol=1e-12)
        np.testing.assert_allclose(
            bn.atoms_surface_distance, b1.atoms_surface_distance,
            atol=1e-12
        )


def test_sharded_step_runs_and_counts_maxima():
    rho = make_density(2)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    _, maxima = pipeline.partition_ongrid(rho, None, w)
    mesh = make_mesh(8)
    roots, n_max, charge = sharded_step(mesh, rho, w)
    assert int(n_max) == len(maxima)
    np.testing.assert_allclose(
        float(np.asarray(charge).sum()), rho.sum(), rtol=1e-12
    )


def test_sharded_analysis_stages_match_single_device():
    """Charge sums, surface distance and relabel on the mesh equal the
    single-device results (verdict item 4: the analysis stages must take
    the mesh instead of pulling full grids onto every device)."""
    import jax.numpy as jnp

    from pybader_tpu.ops import atoms as atoms_ops
    from pybader_tpu.ops import edges as edges_ops
    from pybader_tpu.ops import reductions
    from pybader_tpu.parallel.analysis import (
        sharded_charge_volume_sum, sharded_min_surface_distance,
        sharded_relabel,
    )

    rho = make_density(5)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    labels, maxima = pipeline.partition_ongrid(rho, None, w)
    n_max = len(maxima)
    rng = np.random.default_rng(9)
    atoms_cart = rng.random((max(n_max // 2, 2), 3)) @ LATTICE
    mx_cart = (np.asarray(maxima) / np.asarray(SHAPE)) @ LATTICE
    atom_of_max, _ = atoms_ops.assign_to_atoms(
        jnp.asarray(mx_cart), jnp.asarray(atoms_cart),
        jnp.asarray(LATTICE))
    n_atoms = len(atoms_cart)

    # single-device references
    atoms_vols_1 = reductions.relabel(
        jnp.asarray(labels, dtype=jnp.int32),
        jnp.asarray(atom_of_max, dtype=jnp.int32))
    c1, v1 = reductions.charge_volume_sum(
        jnp.asarray(rho), atoms_vols_1, 0.123, n_atoms)
    known = edges_ops.edge_find(jnp.asarray(rho), atoms_vols_1)
    edge_mask = (known == -2).reshape(-1)
    n_edges = int(jnp.sum(edge_mask))
    size = max(4096, 1 << (n_edges - 1).bit_length())
    edge_idx = reductions.compact_indices(edge_mask, size)[:n_edges]
    d1 = atoms_ops.surface_distance_from_edges(
        edge_idx, atoms_vols_1.reshape(-1), jnp.asarray(LATTICE),
        jnp.asarray(atoms_cart), SHAPE, n_atoms)

    for n in (4, 8):
        mesh = make_mesh(n)
        atoms_vols_n = sharded_relabel(mesh, labels, atom_of_max)
        np.testing.assert_array_equal(
            np.asarray(atoms_vols_n), np.asarray(atoms_vols_1))
        cn, vn = sharded_charge_volume_sum(
            mesh, rho, atoms_vols_1, 0.123, n_atoms)
        np.testing.assert_allclose(np.asarray(cn), np.asarray(c1),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(vn), np.asarray(v1),
                                   rtol=1e-12)
        dn = sharded_min_surface_distance(
            mesh, rho, atoms_vols_1, LATTICE, atoms_cart, n_atoms)
        np.testing.assert_allclose(np.asarray(dn), np.asarray(d1),
                                   rtol=1e-10, atol=1e-12)


def test_walk_sharded_matches_single_device_walker():
    """The mesh walker (sharded f64/parent operands, masked-gather+psum)
    reproduces ops.neargrid.walk exactly, and its grid operands are NOT
    replicated (the round-2 memory-scaling gap)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from pybader_tpu.ops import edges as edges_ops
    from pybader_tpu.ops import neargrid as ng
    from pybader_tpu.ops.reductions import compact_indices
    from pybader_tpu.ops.stencil import ongrid_step_codes, \
        parent_from_step_codes
    from pybader_tpu.parallel.chase import grid_spec_2d
    from pybader_tpu.parallel.walk import walk_sharded

    rho = make_density(7)
    w = tuple(g.distance_weights(LATTICE, SHAPE))
    tg = g.t_grad(LATTICE, SHAPE)
    labels, _ = pipeline.partition_ongrid(rho, None, w)
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    parent = parent_from_step_codes(bk)
    is_max = bk == jnp.uint8(13)
    known = edges_ops.edge_find(jnp.asarray(rho), labels, is_max)
    edge_mask = (known == -2).reshape(-1)
    n_edges = int(jnp.sum(edge_mask))
    assert n_edges > 0
    starts = compact_indices(edge_mask, 4096)
    pos_1, done_1 = ng.walk(
        starts, jnp.asarray(rho).reshape(-1), parent.reshape(-1),
        (known == 2).reshape(-1), jnp.asarray(tg), SHAPE,
        strict_grad=True, max_steps=192)

    for n in (4, 8):
        mesh = make_mesh(n)
        spec = grid_spec_2d(mesh, SHAPE)
        sharding = NamedSharding(mesh, spec)
        rho_sh = jax.device_put(jnp.asarray(rho), sharding)
        assert not rho_sh.sharding.is_fully_replicated
        pos_n, done_n = walk_sharded(
            mesh, starts, rho_sh, parent, known == 2, tg,
            strict_grad=True, max_steps=192)
        np.testing.assert_array_equal(np.asarray(pos_n), np.asarray(pos_1))
        np.testing.assert_array_equal(np.asarray(done_n),
                                      np.asarray(done_1))


def test_dryrun_multichip_on_four_devices(capsys):
    """The four-card check (sharded partition, refinement, relabel,
    charges, surface distance vs one device) on 4 of the virtual devices."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    assert "match single-device" in capsys.readouterr().out


def test_check_sharded_needs_enough_devices():
    import pytest

    import __graft_entry__

    rho = make_density(0)
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        __graft_entry__.check_sharded(16, rho, LATTICE, None)
