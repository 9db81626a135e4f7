"""The accelerator route of the partition, run on the CPU.

On a GPU the partition labels basins by directional-scan flooding plus
discovery-order renumbering, and root resolution floods too; the CPU
takes pointer doubling plus compaction.  Monkeypatching the backend
probe runs the GPU route here: its labels and maxima must equal the CPU
route's, on non-cubic grids, with and without vacuum.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.oracle import gaussian_density

from pybader_tpu import grid as g
from pybader_tpu import pipeline
from pybader_tpu.ops import scanflood
from pybader_tpu.ops.pointer import resolve_roots
from pybader_tpu.ops.stencil import ongrid_step_codes, parent_from_step_codes

LATTICE = np.array([[7.0, 0.0, 0.2], [0.1, 6.0, 0.0], [0.0, 0.3, 8.0]])


def _field(shape, seed, n_blobs=6):
    rng = np.random.default_rng(seed)
    rho = gaussian_density(shape, LATTICE, rng.uniform(size=(n_blobs, 3)),
                           rng.uniform(0.5, 1.1, n_blobs),
                           rng.uniform(1.0, 2.5, n_blobs)) + 1e-6
    return (rho, tuple(g.distance_weights(LATTICE, shape)),
            g.t_grad(LATTICE, shape))


def _both_routes(monkeypatch, fn):
    cpu = fn()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pipeline._use_scanflood()
    gpu = fn()
    return cpu, gpu


def _assert_same(cpu, gpu):
    np.testing.assert_array_equal(np.asarray(gpu[0]), np.asarray(cpu[0]))
    np.testing.assert_array_equal(np.asarray(gpu[1]), np.asarray(cpu[1]))


@pytest.mark.parametrize("shape,seed,vac_q", [
    ((16, 12, 20), 0, None),
    ((18, 15, 14), 1, None),
    ((16, 12, 20), 2, 0.3),
])
def test_ongrid_gpu_route_matches_cpu(monkeypatch, shape, seed, vac_q):
    rho, w, _ = _field(shape, seed)
    vac = None if vac_q is None else rho <= np.quantile(rho, vac_q)
    cpu, gpu = _both_routes(
        monkeypatch, lambda: pipeline.partition_ongrid(rho, vac, w))
    _assert_same(cpu, gpu)


@pytest.mark.parametrize("full", [True, False])
def test_neargrid_gpu_route_matches_cpu(monkeypatch, full):
    """Exact full-trajectory neargrid (roots of step-cap stragglers) and
    the hybrid (ongrid init + internal refinement) with ('changed', 2)."""
    rho, w, tg = _field((16, 14, 12), 3)

    def run():
        carry = {}
        labels, maxima = pipeline.partition_neargrid(
            rho, None, w, tg, full_trajectories=full, carry_out=carry)
        labels, _ = pipeline.refine_labels(
            "neargrid", ("changed", 2), rho, labels, w, tg, verbose=False,
            carry_in=carry or None)
        return labels, maxima

    cpu, gpu = _both_routes(monkeypatch, run)
    _assert_same(cpu, gpu)


@pytest.mark.parametrize("shape,vac_q", [((12, 16, 10), None),
                                         ((15, 9, 13), None),
                                         ((14, 12, 16), 0.4)])
def test_flood_roots_match_pointer_doubling(monkeypatch, shape, vac_q):
    """XLA flood rounds (grouped-plane scans as on a GPU) reach the same
    roots as pointer doubling."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rho, w, _ = _field(shape, sum(shape))
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    if vac_q is not None:
        bk = jnp.where(jnp.asarray(rho <= np.quantile(rho, vac_q)),
                       jnp.uint8(13), bk)
    want = resolve_roots(parent_from_step_codes(bk))
    got = scanflood.resolve_roots_scan(bk)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        np.asarray(scanflood.step_code_from_parent(
            parent_from_step_codes(bk))), np.asarray(bk))
