#!/usr/bin/env python
"""Benchmark: Bader partition throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline workload: the ongrid partition path at 384^3 —
`pipeline.partition_ongrid` end to end (ascent stencil, directional-scan
label flooding, discovery-order renumbering) plus per-basin charge/volume
sums.  stderr detail adds 512^3 and the default config pipeline
(method=neargrid via the documented hybrid, refine_mode=('changed', 2),
maxima->atom assignment, surface distance) with refinement iteration
statistics (edges walked / changed / step-cap fires).

Each (size, workload) runs in its own child process, one after another,
so exactly one process holds the card and every workload starts from a
clean allocator; the parent never touches a device.  A child that finds
no GPU exits non-zero, and so does the parent.  Times end in
``block_until_ready``; the first pass (compiles included) and the steady
pass are reported apart.

vs_baseline: ratio to the reference CPU implementation's ongrid phase,
anchored by a measured number: native/serial_baseline.cpp (clean-room
serial implementation of the reference's ongrid kernel semantics,
methods.py:15-219) is timed on this host at ANCHOR_SIZE^3 on the same
dense field and scaled by an assumed linear 8-thread speedup (the
reference's default thread count; generous to the reference).
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REFERENCE_THREADS = 8
ANCHOR_SIZE = 192  # serial anchor grid
HEADLINE_SIZE = 384
SCHEDULE = [(384, "partition"), (512, "partition"),
            (384, "default"), (512, "default")]
CHILD_TIMEOUT = 1200  # seconds per (size, workload), compiles included

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def load_native(src_name: str) -> ctypes.CDLL:
    """Build native/<src_name> into the temp dir (keyed on its content
    hash) on first use and load it."""
    src = os.path.join(_NATIVE, src_name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(
        tempfile.gettempdir(),
        f"pybader-{os.path.splitext(src_name)[0]}-{digest}.so")
    if not os.path.isfile(lib_path):
        tmp = lib_path + f".tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, lib_path)
    return ctypes.CDLL(lib_path)


def _blob_filter(shape, blur, bg_amp, bg_blur):
    k2 = sum(
        np.fft.fftfreq(s).reshape([-1 if i == d else 1 for i in range(3)]) ** 2
        for d, s in enumerate(shape)
    )
    f = np.exp(-k2 * blur)
    if bg_amp:
        f = f + bg_amp * np.exp(-k2 * bg_blur)
    return f


def synthetic_density(shape, n_blobs=60, seed=1, blur=400.0,
                      bg_amp=10.0, bg_blur=40000.0, return_centers=False):
    """Dense periodic blob field, a stand-in for a bulk-solid CHGCAR.

    Sharp gaussian blobs (atomic peaks) ride on a broad smooth background
    (interstitial density) built from the same impulses.  The background
    matters: without it the field is numerically ~zero between blobs and
    the f64 FFT noise there spawns hundreds of thousands of meaningless
    one-voxel basins.  Here every voxel does real ascent work, the basin
    count stays at ~n_blobs, and no vacuum mask is needed — matching the
    reference's default config (vacuum_tol=None).
    """
    rng = np.random.default_rng(seed)
    rho = np.zeros(shape)
    idx = tuple(rng.integers(0, s, size=n_blobs) for s in shape)
    rho[idx] = rng.uniform(1.0, 3.0, size=n_blobs)
    filt = _blob_filter(shape, blur, bg_amp, bg_blur)
    rho = np.real(np.fft.ifftn(np.fft.fftn(rho) * filt))
    rho = np.ascontiguousarray(rho - rho.min() + 1e-9)
    if return_centers:
        centers = np.stack(idx, axis=1) / np.asarray(shape)  # fractional
        return rho, centers
    return rho


def _circulant_gauss(n, blur):
    """(n, n) circulant periodic-gaussian blur matrix (host f64)."""
    k = np.fft.fftfreq(n)
    g = np.real(np.fft.ifft(np.exp(-k * k * blur)))  # kernel row
    i = np.arange(n)
    return g[(i[:, None] - i[None, :]) % n]


def synthetic_density_device(shape, n_blobs=60, seed=1, blur=400.0,
                             bg_amp=10.0, bg_blur=40000.0):
    """Device-side f64 blob field (same construction as synthetic_density).

    The periodic gaussian blur is separable: three f32 circulant matrix
    products per blur scale, built on the device, so no grid-sized array
    crosses the host link.  f32 arithmetic noise is ~5 orders of magnitude
    below the interstitial background level at bg_amp=10, so the field
    keeps the same basin structure as the host version.
    returns (rho device f64 array, centers fractional (n_blobs, 3)).
    """
    import jax.numpy as jnp

    import pybader_tpu  # noqa: F401  (enables float64 before the cast)

    rng = np.random.default_rng(seed)
    idx = tuple(rng.integers(0, s, size=n_blobs) for s in shape)
    vals = rng.uniform(1.0, 3.0, size=n_blobs)
    centers = np.stack(idx, axis=1) / np.asarray(shape)

    flat_idx = np.ravel_multi_index(idx, shape)
    imp = jnp.zeros(int(np.prod(shape)), jnp.float32).at[
        jnp.asarray(flat_idx)].add(
        jnp.asarray(vals, jnp.float32)).reshape(shape)

    def blur_sep(a, b):
        cs = [jnp.asarray(_circulant_gauss(s, b), jnp.float32)
              for s in shape]
        # precision='highest': reduced-precision matrix inputs (bf16,
        # TF32) drown the interstitial background in noise and spawn
        # hundreds of spurious maxima
        a = jnp.einsum("ai,iyz->ayz", cs[0], a, precision="highest",
                       preferred_element_type=jnp.float32)
        a = jnp.einsum("bj,ajz->abz", cs[1], a, precision="highest",
                       preferred_element_type=jnp.float32)
        return jnp.einsum("ck,abk->abc", cs[2], a, precision="highest",
                          preferred_element_type=jnp.float32)

    rho32 = blur_sep(imp, blur) + jnp.float32(bg_amp) * blur_sep(imp, bg_blur)
    rho32 = rho32 - jnp.min(rho32) + 1e-9
    return rho32.astype(jnp.float64), centers


def measured_baseline():
    """Serial reference-semantics ongrid throughput on THIS host (vox/s).

    Builds native/serial_baseline.cpp on first use and times an
    ANCHOR_SIZE^3 partition of the SAME dense synthetic field the bench
    partitions on the device.
    """
    from pybader_tpu import grid

    lib = load_native("serial_baseline.cpp")
    dp = ctypes.POINTER(ctypes.c_double)
    lib.so_partition.restype = ctypes.c_long
    lib.so_partition.argtypes = (
        [dp] + [ctypes.c_long] * 3 + [dp, ctypes.POINTER(ctypes.c_int)])
    shape = (ANCHOR_SIZE,) * 3
    rho = synthetic_density(shape)
    w = np.asarray(grid.distance_weights(np.diag([20.0] * 3), shape))
    labels = np.empty(shape, dtype=np.int32)
    t0 = time.perf_counter()
    nm = lib.so_partition(
        rho.ctypes.data_as(dp), *shape, w.ctypes.data_as(dp),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    dt = time.perf_counter() - t0
    if nm <= 0:
        raise RuntimeError(f"so_partition returned {nm}")
    rate = int(np.prod(shape)) / dt
    print(f"  serial baseline (this host, {nm} maxima): "
          f"{rate/1e6:.2f} Mvox/s x {REFERENCE_THREADS} threads assumed",
          file=sys.stderr)
    return rate


def require_gpu():
    """Fail unless JAX's default device is a GPU; returns the device."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform} "
                         f"({dev.device_kind}); this benchmark measures "
                         f"the GPU only")
    return dev


def run_workload(size: int, which: str):
    """Child mode: time one workload at one size; prints one JSON line."""
    import jax
    import jax.numpy as jnp

    dev = require_gpu()
    from pybader_tpu.precompile import enable_persistent_cache

    enable_persistent_cache()
    from pybader_tpu import grid, pipeline
    from pybader_tpu.ops import atoms as atoms_ops
    from pybader_tpu.ops import edges as edges_ops
    from pybader_tpu.ops import reductions

    shape = (size, size, size)
    lattice = np.diag([20.0, 20.0, 20.0])
    rho_dev, centers = synthetic_density_device(shape)
    jax.block_until_ready(rho_dev)
    atoms_cart = centers @ lattice
    w = tuple(grid.distance_weights(lattice, shape))
    tg = grid.t_grad(lattice, shape)

    def partition_e2e(stats=None, istats=None):
        labels, maxima = pipeline.partition_ongrid(rho_dev, None, w)
        charge, counts = reductions.charge_volume_sum(
            rho_dev, labels, 1.0, max(len(maxima), 1))
        jax.block_until_ready((charge, counts))
        return {"n_max": len(maxima)}

    def default_e2e(stats=None, istats=None):
        carry = {}
        labels, maxima = pipeline.partition_neargrid(
            rho_dev, None, w, tg, carry_out=carry, stats=istats)
        labels, changed = pipeline.refine_labels(
            "neargrid", ("changed", 2), rho_dev, labels, w, tg,
            verbose=False, stats=stats, carry_in=carry or None)
        # maxima -> atoms, voxel map relabel (ref thread_handlers:78-125)
        mx_cart = (np.asarray(maxima) / np.asarray(shape)) @ lattice
        atom_of_max, _ = atoms_ops.assign_to_atoms(
            jnp.asarray(mx_cart), jnp.asarray(atoms_cart),
            jnp.asarray(lattice))
        atoms_volumes = reductions.relabel(labels, atom_of_max)
        # surface distance (ref thread_handlers:239-297)
        known = edges_ops.edge_find(rho_dev, atoms_volumes)
        dists = atoms_ops.surface_distance_masked(
            atoms_volumes, known == -2, jnp.asarray(lattice),
            jnp.asarray(atoms_cart), len(atoms_cart))
        charge, counts = reductions.charge_volume_sum(
            rho_dev, atoms_volumes, 1.0, len(atoms_cart))
        jax.block_until_ready((dists, charge, counts))
        return {"n_max": len(maxima), "changed": int(changed)}

    run = partition_e2e if which == "partition" else default_e2e
    stats, istats = {}, {}
    t0 = time.perf_counter()
    out = run(stats, istats)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    run()
    steady = time.perf_counter() - t0
    out.update(size=size, workload=which, first=first, steady=steady,
               device=dev.device_kind,
               refine_stats=stats.get("iterations", []),
               refine_stats_internal=istats.get("iterations", []))
    print(json.dumps(out), flush=True)


def _run_child(size, which):
    """One workload in a child process; returns its JSON result."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), f"--size={size}", which],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    sys.stderr.write(proc.stderr[-3000:])
    if proc.returncode != 0:
        raise SystemExit(f"{which} {size}^3 failed (rc {proc.returncode})")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    extra = ""
    for key, name in (("refine_stats", "refine edges/changed/capped"),
                      ("refine_stats_internal", "internal iters")):
        if r.get(key):
            extra += f", {name}: " + "; ".join(
                "/".join(map(str, t)) for t in r[key])
    print(f"  {which} {size}^3 on {r['device']}: steady {r['steady']:.3f}s "
          f"({size ** 3 / r['steady'] / 1e6:.1f} Mvox/s), first pass "
          f"{r['first']:.3f}s, {r['n_max']} basins{extra}", file=sys.stderr)
    return r


def main():
    if len(sys.argv) > 1 and sys.argv[1].startswith("--size="):
        run_workload(int(sys.argv[1].split("=")[1]), sys.argv[2])
        return
    baseline_8t = measured_baseline() * REFERENCE_THREADS
    headline = None
    for size, which in SCHEDULE:
        r = _run_child(size, which)
        if size == HEADLINE_SIZE and which == "partition":
            headline = size ** 3 / r["steady"]
    print(json.dumps({
        "metric": f"ongrid_partition_voxels_per_sec_{HEADLINE_SIZE}cube",
        "value": round(headline, 1), "unit": "voxel/s",
        "vs_baseline": round(headline / baseline_8t, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
