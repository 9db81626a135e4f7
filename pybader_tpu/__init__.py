"""pybader_tpu — data-parallel grid-based Bader charge analysis in JAX.

A from-scratch JAX/XLA re-design of grid-based Bader charge
partitioning (Tang, Sanville & Henkelman, J. Phys.: Condens. Matter 21,
084204 (2009)) that runs on a GPU, or on the CPU for tests.  Feature
surface mirrors the reference CPU package (`pybader`): VASP CHGCAR / Gaussian cube / GPAW /
pymatgen densities in; Bader volumes, maxima, per-volume and per-atom
charge/spin/volume, minimum surface distances, and masked density exports
out.

Precision note: all partitioning decisions and charge reductions run in
float64 so that labels and charges match a CPU float64 reference
bit-for-bit where the algorithm is order-independent.
"""
import jax as _jax

# Bader analysis needs f64: per-atom charges must be accurate to 1e-6 e over
# 1e8-voxel sums, and steepest-ascent tie-breaks must match a f64 reference.
_jax.config.update("jax_enable_x64", True)

from pybader_tpu.dunders import (  # noqa: E402
    __author__, __config__, __desc__, __long_desc__, __version__,
)

__doc__ = (__doc__ or "") + "\n" + __desc__ + "\n\n" + __long_desc__
