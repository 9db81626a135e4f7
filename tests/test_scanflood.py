"""CPU tests for the directional-scan flood labeller.

The scan flood is the accelerator partition's label backend
(pipeline._labels_from_codes); CPU pipelines take the pointer path, so
this file pins its semantics host-side: parity with the pointer-chase
labels, and bit-equality of the ppstep>1 (grouped-plane) scan variant
with the plain per-plane scan.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pybader_tpu import grid, pipeline
from pybader_tpu.ops import scanflood as sf
from pybader_tpu.ops.stencil import ongrid_step_codes

from tests.oracle import gaussian_density


@pytest.fixture(scope="module")
def small_field():
    shape = (16, 24, 20)
    lattice = np.diag([8.0, 12.0, 10.0])
    rng = np.random.default_rng(3)
    centers = rng.uniform(size=(8, 3))
    widths = rng.uniform(0.5, 1.2, size=8)
    amps = rng.uniform(1.0, 3.0, size=8)
    rho = gaussian_density(shape, lattice, centers, widths, amps) + 1e-9
    w = tuple(grid.distance_weights(lattice, shape))
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    return rho, w, bk


def test_labels_match_pointer_path(small_field):
    rho, w, bk = small_field
    labels_ref, maxima_ref = pipeline.partition_ongrid(rho, None, w)
    labels_mo, n_max = sf.labels_scanflood(bk)
    is_max = bk == jnp.uint8(13)
    iota = jnp.arange(rho.size, dtype=jnp.int32).reshape(rho.shape)
    labels, maxima = pipeline.renumber_discovery(
        labels_mo, is_max, None, n_max, iota)
    np.testing.assert_array_equal(np.asarray(labels),
                                  np.asarray(labels_ref))
    np.testing.assert_array_equal(maxima, maxima_ref)


@pytest.mark.parametrize("ppstep", [2, 4, 8])
def test_ppstep_bit_identical(small_field, ppstep):
    """Grouped-plane scans are a pure latency knob: same labels as the
    per-plane scan after every directional pass of every round."""
    rho, w, bk = small_field
    seed, _, _ = sf._flood_seed(bk, bk, False)
    codes = [sf._axis_codes(bk, axis) for axis in range(3)]
    lab1 = jnp.array(seed, copy=True)
    labp = jnp.array(seed, copy=True)
    for _round in range(3):
        for axis in range(3):
            if rho.shape[axis] % ppstep:
                continue
            comp, inplane = codes[axis]
            for reverse in (False, True):
                lab1 = sf.scan_flood_dir(lab1, comp, inplane, axis,
                                         reverse, 1)
                labp = sf.scan_flood_dir(labp, comp, inplane, axis,
                                         reverse, ppstep)
                np.testing.assert_array_equal(np.asarray(lab1),
                                              np.asarray(labp))


def test_ppstep_for_divisibility(monkeypatch):
    # CPU backend always picks 1 (compile-time protection) — force the
    # accelerator decision logic by monkeypatching the backend probe
    monkeypatch.setattr(sf.jax, "default_backend", lambda: "gpu")
    assert sf._ppstep_for(384) == 8
    assert sf._ppstep_for(250) == 2
    assert sf._ppstep_for(244) == 4
    assert sf._ppstep_for(245) == 1
    monkeypatch.setattr(sf.jax, "default_backend", lambda: "cpu")
    assert sf._ppstep_for(384) == 1
