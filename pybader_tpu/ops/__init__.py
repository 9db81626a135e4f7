"""Device compute kernels (plain JAX/XLA) for Bader partitioning.

Each module here is the data-parallel equivalent of one or more of the
reference's 19 numba ``@njit`` kernels (see SURVEY.md §2.4):

 - :mod:`stencil`    — ongrid ascent-pointer stencil (ref methods.py:15-219)
 - :mod:`pointer`    — parallel pointer doubling + canonical basin labels
                       (replaces serial path-following, path buffers,
                       volume_extend / volume_merge / volume_offset /
                       edge_assign chunk-merge machinery)
 - :mod:`scanflood`  — directional plane-scan label flooding (the
                       accelerator route of the ongrid partition)
 - :mod:`neargrid`   — vectorised neargrid trajectory walker
                       (ref methods.py:222-611, refinement.py:16-322)
 - :mod:`edges`      — edge_find / edge_check stencils
                       (ref refinement.py:325-508); the refinement
                       fixed-point driver lives in pybader_tpu.pipeline
 - :mod:`reductions` — vacuum masking, segment charge/volume sums, label
                       remaps, masked density export
                       (ref utils.py: charge_sum, vacuum_assign,
                        volume_assign, volume_mask)
 - :mod:`atoms`      — maxima->atom assignment and min surface distance
                       (ref utils.py: atom_assign, surface_dist)
"""
