"""Compilation-cache warm-up — the JAX analog of the reference's JIT cache.

The reference precompiles every numba kernel for every dtype at install time
(pybader's jits.py, entry_points.JIT_caching) so first runs are fast.  The
equivalent here is (a) enabling JAX's persistent compilation cache so XLA
binaries survive across processes, and (b) optionally tracing the hot
programs once on tiny grids so a fresh cache gets seeded.
"""
from __future__ import annotations

import os

import numpy as np

# fixed path inside the checkout: the cache directory is part of the
# cache's key, so it must not move between runs (listed in .gitignore)
_CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def warm(shapes=((32, 32, 32),), default_pipeline: bool = False) -> None:
    """Compile the hot pipeline stages for the given grid shapes.

    With ``default_pipeline=True`` the warm runs the DEFAULT acceptance
    pipeline (hybrid neargrid partition + chained ('changed', 2)
    refinement via the carry) instead of the ongrid + single-iteration
    set, seeding the walker-bucket program ladder a real run of that
    shape dispatches.  XLA program shapes depend only on the grid shape
    and the bucket ladder, not on the density values, so a synthetic
    field covers the user's real file.
    """
    import jax.numpy as jnp

    from pybader_tpu import grid, pipeline
    from pybader_tpu.ops import reductions

    for shape in shapes:
        lattice = np.diag(np.asarray(shape, dtype=np.float64) / 8.0)
        rng = np.random.default_rng(0)
        rho = rng.random(shape) + 0.1
        w = tuple(grid.distance_weights(lattice, shape))
        tg = grid.t_grad(lattice, shape)
        if default_pipeline:
            carry = {}
            labels, maxima = pipeline.partition_neargrid(
                rho, None, w, tg, carry_out=carry)
            labels, _ = pipeline.refine_labels(
                "neargrid", ("changed", 2), rho, labels, w, tg,
                verbose=False, carry_in=carry or None)
        else:
            labels, maxima = pipeline.partition_ongrid(rho, None, w)
            pipeline.refine_labels(
                "neargrid", ("changed", 1), rho, labels, w, tg,
                verbose=False)
        reductions.charge_volume_sum(
            jnp.asarray(rho), labels, grid.voxel_volume(lattice, shape),
            max(len(maxima), 1),
        )


def cache_jit(argv=None) -> None:
    """Console-script equivalent of the reference's install-time JIT warm
    (reference entry_points.py:358-379), extended to user shapes.

    ``bader-cache-jit [--shape N | NX,NY,NZ]... [--default]`` seeds the
    persistent compilation cache; ``--shape`` warms the pipeline at the
    user's real grid shape (repeatable) so a later first CLI run on a
    file of that shape pays per-process program loads only, never
    compiles; ``--default`` warms the default acceptance pipeline
    (hybrid neargrid + refinement) instead of the ongrid set.
    """
    import argparse

    ap = argparse.ArgumentParser(
        description="Seed the persistent XLA compilation cache")
    ap.add_argument("--shape", action="append", default=[],
                    help="grid shape to warm: N or NX,NY,NZ (repeatable)")
    ap.add_argument("--default", action="store_true", dest="default_pipe",
                    help="warm the default (neargrid+refine) pipeline")
    args = ap.parse_args(argv)
    shapes = []
    for s in args.shape:
        parts = [int(p) for p in s.split(",")]
        shapes.append(tuple(parts * 3) if len(parts) == 1 else tuple(parts))
    shapes = shapes or [(32, 32, 32)]
    path = enable_persistent_cache()
    print(f"  Warming JAX compilation cache at '{path}' for "
          f"{', '.join('x'.join(map(str, s)) for s in shapes)}: ",
          end="", flush=True)
    warm(tuple(shapes), default_pipeline=args.default_pipe)
    print("Done.")
