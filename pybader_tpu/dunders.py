"""Package metadata and platform-dependent config path.

Mirrors the metadata surface of the reference implementation
(pybader's dunders.py:11-26) but for the JAX rebuild.
"""
import os
from sys import platform

__pkgname__ = "pybader_tpu"
__version__ = "0.1.0"
__author__ = "pybader-tpu developers"
__url__ = "https://github.com/pybader-tpu/pybader-tpu"
__desc__ = "Data-parallel (JAX/XLA) grid-based Bader charge analysis."
__long_desc__ = """Grid-based Bader charge analysis based on methods presented
in W. Tang, E. Sanville, and G. Henkelman, 'A grid-based Bader analysis
algorithm without lattice bias', J. Phys.: Condens. Matter 21, 084204 (2009).
Re-designed for data-parallel hardware: steepest-ascent path following is expressed as a
massively-parallel 26-neighbour stencil producing per-voxel ascent pointers,
converged by parallel pointer doubling; refinement is a masked fixed-point
sweep; reductions are on-device segment sums; multi-chip scaling shards the
grid over a JAX device mesh.
"""

if platform == "win32":  # pragma: no cover - platform specific
    __config__ = os.path.join(
        os.getenv("LOCALAPPDATA", os.path.expanduser("~")),
        "pybader_tpu", "config.ini",
    )
else:
    __config__ = os.path.expanduser(
        os.path.join("~", ".config", "bader-tpu", "config.ini")
    )
