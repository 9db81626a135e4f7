#!/usr/bin/env python
"""Smoke test of the Bader pipeline at real size on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card: phases 1-6
    python chip_smoke.py --four-cards  # only the sharded path, on 4 cards

One process drives the card.  The density is the benchmark's synthetic
field (`bench.synthetic_density_device`: 60 blobs, 20 A cubic cell,
seed 1), built on the device.  Phases:

 1. card and settings: `nvidia-smi` name and power limit (read by a child
    process that stays off JAX), jax version, device kind, compile cache;
 2. the `bader` CLI on tests/fixtures/CHGCAR_fixture with the default
    profile, against CHGCAR_fixture_golden.json (1e-6 e, exact maxima);
 3. ongrid partition at 384^3 (`pipeline.partition_ongrid` +
    `reductions.charge_volume_sum`): labels identical to
    native/serial_baseline.cpp, basin charges equal to np.bincount of the
    same labels to rtol 1e-10;
 4. default config at 256^3 (exact full-trajectory neargrid,
    ('changed', 2), atoms, surface distance) against
    native/serial_neargrid.cpp refined to its fixed point (at most 1e-5
    of the voxels and 1e-6 e per atom off; the difference to its
    ('changed', 2) state is printed too), surface distances against a
    numpy brute force over the edge voxels (rtol 1e-12);
 5. default config at 384^3 through `Bader.__call__` (the hybrid path):
    charge conserved to 1e-10, maxima count equal to phase 3's;
 6. readings: per-layer device times at 384^3 against the HBM roofline,
    the flood beside pointer doubling, and the walker's row-gather rate
    and count-fetch round trip at 4M lanes.

Phases 3-5 print a first pass (compiles included) and a second, steady
pass, each ending in `block_until_ready`, and the device's
`peak_bytes_in_use` so far.  Any failed check raises; the script then
exits non-zero and does not print its last line, which is otherwise
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
It refuses to run when JAX's default device is not a GPU.
"""
import argparse
import ctypes
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "CHGCAR_fixture")
GOLDEN = os.path.join(HERE, "tests", "fixtures", "CHGCAR_fixture_golden.json")
CELL = 20.0  # Angstrom, cubic — the benchmark field's cell

# Peak HBM bandwidth by device kind, bytes/s (NVIDIA data sheets).
HBM_PEAK = {"H100 80GB HBM3": 3.35e12, "H100 SXM": 3.35e12,
            "H100 PCIe": 2.0e12, "H100 NVL": 3.9e12}


def hbm_peak(device_kind: str):
    """Published HBM bandwidth for ``device_kind``, None if not listed."""
    for key, peak in HBM_PEAK.items():
        if key in device_kind:
            return peak
    return None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _sync(out):
    import jax

    jax.block_until_ready([x for x in jax.tree_util.tree_leaves(out)
                           if isinstance(x, jax.Array)])
    return out


def first_and_steady(fn):
    """(result, first-pass seconds, steady-pass seconds) of ``fn()``."""
    t0 = time.perf_counter()
    out = _sync(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _sync(fn())
    return out, first, time.perf_counter() - t0


def steady_time(fn, reps: int = 3):
    """Median seconds of ``fn()`` after one warm-up call."""
    _sync(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def field(size: int, **density_kw):
    """(rho on device, rho on host, lattice, atom positions) at size^3;
    ``density_kw`` goes to `bench.synthetic_density_device`."""
    import jax

    from bench import synthetic_density_device

    rho_dev, centers = synthetic_density_device((size,) * 3, **density_kw)
    lattice = np.diag([CELL] * 3)
    assert rho_dev.dtype == np.float64, rho_dev.dtype
    rho_h = np.ascontiguousarray(np.asarray(jax.device_get(rho_dev)))
    return rho_dev, rho_h, lattice, centers @ lattice


def _report(name, first, steady):
    print(f"  {name}: first pass {first:.3f} s, steady {steady:.3f} s, "
          f"peak_bytes_in_use {peak_bytes()}", flush=True)


def phase_card():
    """Phase 1: the card and the settings the run uses."""
    import jax

    from pybader_tpu.precompile import enable_persistent_cache

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip(), flush=True)
    dev = jax.devices()[0]
    print(f"  jax {jax.__version__}, {len(jax.devices())} x "
          f"{dev.device_kind} ({dev.platform}), compile cache "
          f"{enable_persistent_cache()}", flush=True)


def phase_cli(workdir):
    """Phase 2: the `bader` CLI on the committed fixture vs its goldens."""
    from pybader_tpu.entry_points import bader

    with open(GOLDEN) as f:
        golden = json.load(f)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        bader([FIXTURE])
        with open("bader.p", "rb") as f:  # written by the run just made
            b = pickle.load(f)
    finally:
        os.chdir(cwd)
    shape = np.array(b.density.shape)
    vox = np.rint(b.bader_maxima_fractional * shape
                  - b.voxel_offset_fractional).astype(int) % shape
    got = {tuple(m): (q, v) for m, q, v in
           zip(vox.tolist(), b.bader_charge, b.bader_volume)}
    assert set(got) == {tuple(m) for m in golden["maxima"]}, "maxima differ"
    assert len(vox) == golden["n_maxima"]
    np.testing.assert_allclose(b.atoms_charge, golden["atoms_charge"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.atoms_volume, golden["atoms_volume"],
                               atol=1e-6, rtol=0)
    for m, q, v in zip(golden["maxima"], golden["bader_charge"],
                       golden["bader_volume"]):
        gq, gv = got[tuple(m)]
        assert abs(gq - q) < 1e-6 and abs(gv - v) < 1e-6, (m, gq, q)
    dq = np.max(np.abs(b.atoms_charge - np.asarray(golden["atoms_charge"])))
    print(f"  CLI fixture: {len(vox)} maxima match, max per-atom |dq| "
          f"{dq:.3e} e", flush=True)


def phase_ongrid(rho_dev, rho_h, lattice):
    """Phase 3: ongrid partition + charge sums vs the serial native code.

    returns the number of maxima."""
    from bench import load_native
    from pybader_tpu import grid, pipeline
    from pybader_tpu.ops import reductions

    shape = rho_h.shape
    w = tuple(grid.distance_weights(lattice, shape))
    vv = grid.voxel_volume(lattice, shape)

    def run():
        labels, maxima = pipeline.partition_ongrid(rho_dev, None, w)
        charge, volume = reductions.charge_volume_sum(
            rho_dev, labels, vv, len(maxima))
        return labels, maxima, charge, volume

    (labels, maxima, charge, volume), first, steady = first_and_steady(run)
    _report(f"ongrid partition {shape}", first, steady)

    lib = load_native("serial_baseline.cpp")
    lib.so_partition.restype = ctypes.c_long
    lib.so_partition.argtypes = ([ctypes.POINTER(ctypes.c_double)]
                                 + [ctypes.c_long] * 3
                                 + [ctypes.POINTER(ctypes.c_double),
                                    ctypes.POINTER(ctypes.c_int)])
    serial = np.empty(shape, dtype=np.int32)
    w_h = np.ascontiguousarray(w, dtype=np.float64)
    t0 = time.perf_counter()
    nm = lib.so_partition(_dp(rho_h), *shape, _dp(w_h), _ip(serial))
    t_serial = time.perf_counter() - t0
    labels_h = np.asarray(labels)
    mism = int(np.count_nonzero(labels_h != serial))
    print(f"  serial_baseline.cpp: {nm} maxima in {t_serial:.3f} s (host, "
          f"one core); {len(maxima)} maxima on the device, {mism} voxels "
          f"differ", flush=True)
    assert nm == len(maxima) and mism == 0, (nm, len(maxima), mism)
    flat = labels_h.reshape(-1)
    want_q = np.bincount(flat, weights=rho_h.reshape(-1),
                         minlength=nm) * vv
    want_v = np.bincount(flat, minlength=nm) * vv
    np.testing.assert_allclose(np.asarray(charge), want_q, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(volume), want_v, rtol=1e-10)
    return len(maxima)


def surface_brute_force(atoms_volumes, edge_mask, lattice, atoms_cart):
    """Host numpy min distance from each atom to its volume's edge voxels
    (27 periodic images; 0.0 for atoms without edge voxels)."""
    shape = atoms_volumes.shape
    idx = np.flatnonzero(edge_mask.reshape(-1))
    lab = atoms_volumes.reshape(-1)[idx]
    keep = lab >= 0
    idx, lab = idx[keep], lab[keep]
    shifts = np.array([(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
                       for z in (-1, 0, 1)], dtype=np.float64) @ lattice
    best = np.full(len(atoms_cart), np.inf)
    for lo in range(0, len(idx), 1 << 20):
        i, a = idx[lo:lo + (1 << 20)], lab[lo:lo + (1 << 20)]
        xyz = np.stack(np.unravel_index(i, shape), axis=1)
        pc = (xyz / np.asarray(shape)) @ lattice
        delta = pc[:, None, :] - (atoms_cart[a][:, None, :] + shifts[None])
        d2 = np.min(np.sum(delta * delta, axis=-1), axis=-1)
        np.minimum.at(best, a, d2)
    return np.where(np.isfinite(best), np.sqrt(best), 0.0)


def phase_default_exact(rho_dev, rho_h, lattice, atoms_cart):
    """Phase 4: default config on the exact full-trajectory path vs
    native/serial_neargrid.cpp, surface distance vs brute force."""
    import jax.numpy as jnp

    from bench import load_native
    from pybader_tpu import grid, pipeline
    from pybader_tpu.ops import atoms as atoms_ops
    from pybader_tpu.ops import edges as edges_ops
    from pybader_tpu.ops import reductions

    shape = rho_h.shape
    assert rho_h.size <= pipeline._NEARGRID_HYBRID_THRESHOLD, shape
    w = tuple(grid.distance_weights(lattice, shape))
    tg = grid.t_grad(lattice, shape)
    vv = grid.voxel_volume(lattice, shape)
    n_atoms = len(atoms_cart)

    def run():
        labels, maxima = pipeline.partition_neargrid(rho_dev, None, w, tg)
        labels, _ = pipeline.refine_labels(
            "neargrid", ("changed", 2), rho_dev, labels, w, tg,
            verbose=False)
        mx_cart = (np.asarray(maxima) / np.asarray(shape)) @ lattice
        atom_of_max, _ = atoms_ops.assign_to_atoms(
            jnp.asarray(mx_cart), jnp.asarray(atoms_cart),
            jnp.asarray(lattice))
        atoms_volumes = reductions.relabel(labels, atom_of_max)
        edge_mask = edges_ops.edge_find(rho_dev, atoms_volumes) == -2
        dists = atoms_ops.surface_distance_masked(
            atoms_volumes, edge_mask, lattice, atoms_cart, n_atoms)
        charge, _ = reductions.charge_volume_sum(
            rho_dev, atoms_volumes, vv, n_atoms)
        return labels, atom_of_max, atoms_volumes, edge_mask, dists, charge

    out, first, steady = first_and_steady(run)
    labels, atom_of_max, atoms_volumes, edge_mask, dists, charge = out
    _report(f"default config, exact neargrid {shape}", first, steady)

    lib = load_native("serial_neargrid.cpp")
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    lib.sn_neargrid.restype = ctypes.c_long
    lib.sn_neargrid.argtypes = [dp] + [ctypes.c_long] * 3 + [dp, dp, ip]
    lib.sn_refine.restype = ctypes.c_long
    lib.sn_refine.argtypes = ([dp] + [ctypes.c_long] * 3
                              + [dp, dp, ip, ctypes.c_long])
    w_h = np.ascontiguousarray(w, dtype=np.float64)
    tg_h = np.ascontiguousarray(tg, dtype=np.float64)
    serial = np.empty(shape, dtype=np.int32)
    t0 = time.perf_counter()
    nm = lib.sn_neargrid(_dp(rho_h), *shape, _dp(w_h), _dp(tg_h),
                         _ip(serial))
    lib.sn_refine(_dp(rho_h), *shape, _dp(w_h), _dp(tg_h), _ip(serial),
                  ctypes.c_long(2))
    t_serial = time.perf_counter() - t0
    table = np.asarray(atom_of_max)
    assert nm == len(table), (nm, len(table))
    labels_h = np.asarray(labels)
    q_device = np.asarray(charge)

    def diff(ref):
        q_ref = np.bincount(table[ref.reshape(-1)],
                            weights=rho_h.reshape(-1), minlength=n_atoms)
        return (int(np.count_nonzero(labels_h != ref)),
                float(np.max(np.abs(q_device - q_ref * vv))))

    mism2, dq2 = diff(serial)
    # The serial reference's initial pass adopts labels in scan order and
    # leaves a wider mislabelled band than the order-free walk, which two
    # 'changed' iterations do not always close.  Its own accuracy harness
    # (examples/compare_methods.py) takes the converged refinement as
    # ground truth, so the bounds apply against that fixed point.
    more = lib.sn_refine(_dp(rho_h), *shape, _dp(w_h), _dp(tg_h),
                         _ip(serial), ctypes.c_long(-1))
    mism, dq = diff(serial)
    print(f"  serial_neargrid.cpp: {nm} maxima in {t_serial:.3f} s (host, "
          f"one core); at ('changed', 2) {mism2} voxels differ "
          f"({mism2 / rho_h.size:.3e}), max per-atom |dq| {dq2:.3e} e; "
          f"the serial side then changes {more} more voxels to converge, "
          f"after which {mism} voxels differ ({mism / rho_h.size:.3e}), "
          f"max per-atom |dq| {dq:.3e} e", flush=True)
    assert mism <= 1e-5 * rho_h.size and dq <= 1e-6, (mism, dq)

    brute = surface_brute_force(np.asarray(atoms_volumes),
                                np.asarray(edge_mask), lattice, atoms_cart)
    np.testing.assert_allclose(np.asarray(dists), brute, rtol=1e-12)
    print(f"  surface distance: {n_atoms} atoms match the brute force "
          f"over {int(np.count_nonzero(np.asarray(edge_mask)))} edge "
          f"voxels", flush=True)


def phase_bader(rho_h, lattice, atoms_cart, n_maxima, workdir):
    """Phase 5: the shipping default through `Bader.__call__`."""
    from pybader_tpu import grid
    from pybader_tpu.interface import Bader

    shape = rho_h.shape
    info = {"filename": "synthetic", "prefix": "",
            "voxel_offset": np.zeros(3), "write_function": None}

    def run():
        b = Bader({"charge": rho_h}, lattice, atoms_cart, dict(info),
                  output="dat")
        b()
        return b

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        b, first, steady = first_and_steady(run)
    finally:
        os.chdir(cwd)
    _report(f"Bader.__call__ default config {shape}", first, steady)
    total = rho_h.sum() * grid.voxel_volume(lattice, shape)
    got = np.sum(b.atoms_charge) + b.vacuum_charge
    rel = abs(got - total) / abs(total)
    print(f"  charge conservation: |sum - total| / total = {rel:.3e}; "
          f"{len(b.bader_maxima)} maxima", flush=True)
    assert rel <= 1e-10, rel
    assert len(b.bader_maxima) == n_maxima, (len(b.bader_maxima), n_maxima)


def phase_layers(rho_dev, lattice, atoms_cart, lanes: int = 1 << 22):
    """Phase 6: per-layer device times against the HBM roofline, the
    flood beside pointer doubling, and the walker's cost-model readings.

    returns {layer: seconds} plus 'gather_rate' and 'count_rtt'."""
    import jax
    import jax.numpy as jnp

    from pybader_tpu import grid, pipeline
    from pybader_tpu.ops import atoms as atoms_ops
    from pybader_tpu.ops import edges as edges_ops
    from pybader_tpu.ops import neargrid as ng
    from pybader_tpu.ops import reductions, scanflood
    from pybader_tpu.ops.pointer import resolve_roots
    from pybader_tpu.ops.stencil import (ongrid_step_codes,
                                         parent_from_step_codes)

    shape = rho_dev.shape
    n = int(np.prod(shape))
    w = tuple(grid.distance_weights(lattice, shape))
    tg = jnp.asarray(grid.t_grad(lattice, shape))
    vv = grid.voxel_volume(lattice, shape)
    n_atoms = len(atoms_cart)

    bk = ongrid_step_codes(rho_dev, w)
    rounds = []
    labels_mo, n_max = scanflood.labels_scanflood(
        bk, progress=lambda r, left: rounds.append(r + 1))
    is_max = bk == jnp.uint8(13)
    iota = jnp.arange(n, dtype=jnp.int32).reshape(shape)
    labels, maxima = pipeline.renumber_discovery(
        labels_mo, is_max, None, n_max, iota)
    parent = parent_from_step_codes(bk)
    mx_cart = (np.asarray(maxima) / np.asarray(shape)) @ lattice
    atom_of_max, _ = atoms_ops.assign_to_atoms(
        jnp.asarray(mx_cart), jnp.asarray(atoms_cart), jnp.asarray(lattice))
    atoms_volumes = reductions.relabel(labels, atom_of_max)
    edge_mask = edges_ops.edge_find(rho_dev, atoms_volumes) == -2
    groups = -(-n_max // 8)  # label sweeps: 8 labels per grid pass
    n_rounds = max(rounds)
    layers = [  # name, callable, bytes the layer must move
        ("stencil", lambda: ongrid_step_codes(rho_dev, w), 9 * n),
        ("flood", lambda: scanflood.labels_scanflood(bk)[0],
         n_rounds * 6 * 10 * n),
        ("pointer doubling", lambda: resolve_roots(parent), None),
        ("renumber", lambda: pipeline.renumber_discovery(
            labels_mo, is_max, None, n_max, iota)[0],
         groups * 9 * n + 8 * n),
        ("edge find", lambda: edges_ops.edge_find(rho_dev, labels, is_max),
         6 * n),
        ("charge sums", lambda: reductions.charge_volume_sum(
            rho_dev, labels, vv, n_max), groups * 12 * n),
        ("surface distance", lambda: atoms_ops.surface_distance_masked(
            atoms_volumes, edge_mask, lattice, atoms_cart, n_atoms), 5 * n),
    ]
    kind = jax.devices()[0].device_kind
    peak = hbm_peak(kind)
    out = {}
    print(f"  layers at {shape} ({n_max} basins, {n_rounds} flood rounds), "
          f"HBM peak {peak} B/s for {kind}:", flush=True)
    for name, fn, nbytes in layers:
        t = steady_time(fn)
        out[name] = t
        line = f"    {name:<17s} {t * 1e3:9.3f} ms"
        if nbytes is not None:
            line += f"  {nbytes / 1e9:7.3f} GB  {nbytes / t / 1e9:8.1f} GB/s"
            if peak is not None:
                line += f"  {nbytes / t / peak:6.1%} of peak"
        print(line, flush=True)

    # walker cost model: one screened q-row segment over `lanes` lanes
    qrows = ng.precompute_qrows(rho_dev, bk, tg, strict_grad=True)
    starts = jnp.asarray(np.linspace(0, n - 1, lanes).astype(np.int32))
    state = ng._init_state(starts, jnp.float32, screened=True)
    steps = 16
    t = steady_time(lambda: ng._walk_segment_counted_qs(
        state, qrows, shape, steps, early_exit=False))
    out["gather_rate"] = lanes * steps / t
    one = jax.jit(lambda x: jnp.sum(x))
    x = jnp.ones((8,), jnp.int32)
    int(one(x))
    rtts = []
    for _ in range(50):
        t0 = time.perf_counter()
        int(one(x))
        rtts.append(time.perf_counter() - t0)
    out["count_rtt"] = float(np.median(rtts))
    print(f"  walker: {lanes} lanes x {steps} steps in {t * 1e3:.3f} ms = "
          f"{out['gather_rate']:.4g} lane-steps/s (row-gather rate); "
          f"count-fetch round trip {out['count_rtt'] * 1e6:.1f} us "
          f"(constants in use: {ng._GATHER_RATE:.4g}, {ng._COUNT_RTT:.4g} s)",
          flush=True)
    return out


def four_cards(size: int = 384):
    """The sharded path on a 4-card mesh at size^3 vs one card."""
    from __graft_entry__ import check_sharded

    rho_dev, rho_h, lattice, _ = field(size)
    del rho_dev
    t0 = time.perf_counter()
    print(check_sharded(4, rho_h, lattice, rho_h <= np.quantile(rho_h, 0.2)),
          flush=True)
    print(f"  four-card check: {time.perf_counter() - t0:.3f} s",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path, on a 4-card mesh")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's default device is {dev.platform} "
              f"({dev.device_kind}), not a GPU", file=sys.stderr)
        raise SystemExit(2)
    phase_card()
    if args.four_cards:
        four_cards()
    else:
        with tempfile.TemporaryDirectory() as workdir:
            phase_cli(workdir)
            rho_dev, rho_h, lattice, atoms_cart = field(384)
            n_maxima = phase_ongrid(rho_dev, rho_h, lattice)
            phase_default_exact(*field(256))
            phase_bader(rho_h, lattice, atoms_cart, n_maxima, workdir)
            phase_layers(rho_dev, lattice, atoms_cart)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
