"""User interface: the Bader class and config handling.

API parity with the reference interface (pybader's interface.py): same
configurable attribute surface, result attributes, derived-geometry
properties, pipeline entry point (``__call__``), text results and pickle
persistence — orchestrating the device pipelines of
:mod:`pybader_tpu.pipeline` instead of a thread pool.

Reference bugs deliberately fixed (not copied):
 - ``spin`` is settable (examples/cube_spin_density.py assigns it; the
   reference defines a getter-only property, interface.py:209-213)
 - ``from_dict`` returns the instance (reference forgets the return,
   interface.py:175-183)
"""
from __future__ import annotations

import os
from ast import literal_eval
from configparser import ConfigParser
from contextlib import contextmanager
from inspect import getmembers, ismodule
from pickle import dump
from time import perf_counter

import numpy as np

from pybader_tpu import io
from pybader_tpu.dunders import __config__
from pybader_tpu import grid as _grid
from pybader_tpu import pipeline
from pybader_tpu.ops import atoms as atoms_ops
from pybader_tpu.ops import edges as edges_ops
from pybader_tpu.ops import reductions
from pybader_tpu.utils import dtype_calc

import jax.numpy as jnp


@contextmanager
def _stage(name, multiline=False):
    """Stage header + wall-clock print + live tick line.

    Yields a ``tick(msg)`` callable: the host-driven device loops (flood
    rounds, walker segments, refinement iterations) call it with short
    status strings that overwrite a single console line — the device-side
    analog of the reference's counter-polling tqdm thread (utils.py:107-142,
    thread_handlers.py:53-58); here the host loop IS the poller.
    """
    if multiline:
        print(f"  {name}:")
    else:
        print(f"  {name}: ", end="", flush=True)
    t0 = perf_counter()
    state = {"ticked": False}

    def tick(msg):
        state["ticked"] = True
        print(f"\r  {name}: {msg}" + " " * 12, end="", flush=True)

    yield tick
    dt = perf_counter() - t0
    if state["ticked"]:
        print(f"\r  {name}: done in {dt:.3f}s" + " " * 40)
    elif multiline:
        print(f"  {name} done in {dt:.3f}s")
    else:
        print(f"done in {dt:.3f}s")


def _format_table(index, cols):
    """Fixed-width text rows: a header of centred column names, then one
    row per index label with values to six decimals, right-aligned."""
    labels = [str(i) for i in index]
    wi = max((len(s) for s in labels), default=0)
    body = {k: [f"{x:.6f}" for x in v] for k, v in cols.items()}
    widths = {k: max([len(k)] + [len(s) for s in body[k]]) for k in cols}
    lines = [' ' * wi + ''.join(f"  {k:^{widths[k]}}" for k in cols)]
    for r, label in enumerate(labels):
        lines.append(f"{label:>{wi}}" + ''.join(
            f"  {body[k][r]:>{widths[k]}}" for k in cols))
    return lines


# Configurable attributes and their allowed types (config.ini type-checking)
config_attributes = {
    'method': str,
    'refine_method': str,
    'vacuum_tol': (type(None), float),
    'refine_mode': (str, int),
    'bader_volume_tol': (type(None), float),
    'export_mode': (type(None), str, int),
    'prefix': str,
    'output': str,
    'threads': int,
    'fortran_format': int,
    'speed_flag': bool,
    'spin_flag': bool,
}

DEFAULT_CONFIG = {
    'method': 'neargrid',
    'refine_method': 'neargrid',
    'vacuum_tol': None,
    'refine_mode': ('changed', 2),
    'bader_volume_tol': 1e-3,
    'export_mode': None,
    'prefix': '',
    'output': 'pickle',
    'threads': 1,
    'fortran_format': 0,
    'speed_flag': False,
    'spin_flag': False,
}

SPEED_CONFIG = {
    **DEFAULT_CONFIG,
    'method': 'ongrid',
    'refine_method': 'neargrid',
    'refine_mode': ('changed', 3),
    'speed_flag': True,
}


def python_config(config_file=__config__, key='DEFAULT'):
    """Load a typed config profile from the ini file.

    Falls back to the built-in DEFAULT / speed profiles when no config file
    exists yet.
    """
    if not os.path.isfile(config_file):
        if key.lower() == 'speed':
            return dict(SPEED_CONFIG)
        return dict(DEFAULT_CONFIG)
    config = ConfigParser()
    with open(config_file, 'r') as f:
        config.read_file(f)
    if key not in config:
        print(f"  No config for {key} found")
    out = {}
    for k in config[key]:
        if k not in config_attributes:
            raise AttributeError(f"  Unknown keyword in config.ini: {k}")
        try:
            out[k] = literal_eval(config[key].get(k))
        except (ValueError, SyntaxError):
            if config_attributes[k] is str:
                out[k] = config[key].get(k)
            else:
                raise
        if not isinstance(out[k], config_attributes[k]):
            err = f"  {k} has wrong type: {type(out[k])} != {config_attributes[k]}"
            if hasattr(out[k], '__iter__') and not isinstance(out[k], str):
                for t in out[k]:
                    if not isinstance(t, config_attributes[k]):
                        raise TypeError(err)
            else:
                raise TypeError(err)
    return out


class Bader:
    """Grid-based Bader charge analysis on a JAX device (GPU or CPU).

    args:
        density_dict: dict with 'charge' and/or 'spin' float64 grids
        lattice: 3x3 lattice (rows are lattice vectors, cartesian)
        atoms: cartesian atom positions (N, 3)
        file_info: provenance dict (filename, prefix, file_type,
                   voxel_offset, write_function, ...)
        **kwargs: any configurable attribute (see config_attributes), plus
                  ``mesh`` — an optional jax.sharding.Mesh; when set, the
                  partition and refinement stages shard the grid over it
                  (multi-chip path, parallel/).  Not a config.ini key (a
                  Mesh holds live device handles) and not pickled.
    """

    mesh = None  # class default; set per instance for multi-device runs

    def __init__(self, density_dict, lattice, atoms, file_info, **kwargs):
        self._density = density_dict
        self._lattice = np.asarray(lattice, dtype=np.float64)
        self._atoms = np.asarray(atoms, dtype=np.float64)
        self._file_info = file_info
        self._dataframe = None
        self.density = self.charge if self.charge is not None else self.spin
        self.reference = self.density
        self.load_config()
        self.apply_config(kwargs)

    # ------------------------------------------------------------------ io
    @classmethod
    def from_file(cls, filename, file_type=None, **kwargs):
        """Initialise from a density file, dispatching on extension."""
        if file_type is not None:
            file_type = file_type.lower()
            io_ = None
            for f_type, f_method in getmembers(io, ismodule):
                if f_type == file_type:
                    io_ = f_method
            if io_ is None or not hasattr(io_, 'read'):
                known = [n for n, m in getmembers(io, ismodule)
                         if hasattr(m, 'read')]
                raise ValueError(
                    f"unknown file_type {file_type!r}; available: {known}"
                )
            file_conf = {k: v for k, v in kwargs.items() if k in io_.__args__}
            return cls(*io_.read(filename, **file_conf), **kwargs)
        for name, package in getmembers(io, ismodule):
            if getattr(package, '__extensions__', None) is None:
                continue
            for ext in package.__extensions__:
                if ext in filename.lower():
                    file_conf = {
                        k: v for k, v in kwargs.items()
                        if k in package.__args__
                    }
                    return cls(*package.read(filename, **file_conf), **kwargs)
        print("  No clear file type found; file will be read as chgcar.")
        file_conf = {k: v for k, v in kwargs.items() if k in io.vasp.__args__}
        return cls(*io.vasp.read(filename, **file_conf), **kwargs)

    @classmethod
    def from_dict(cls, d):
        """Recreate an instance from :attr:`as_dict` output."""
        d = dict(d)
        atoms = d.pop('_atoms')
        lattice = d.pop('_lattice')
        density = d.pop('_density')
        file_info = d.pop('_file_info')
        self = cls(density, lattice, atoms, file_info)
        for k, v in d.items():
            try:
                setattr(self, k, v)
            except AttributeError:
                pass
        return self

    @property
    def as_dict(self):
        d = {}
        keys = [
            '_density', '_lattice', '_atoms', '_file_info', '_bader_maxima',
            '_vacuum_charge', '_vacuum_volume', *config_attributes.keys(),
            'density', 'reference', 'bader_charge', 'bader_volume',
            'bader_spin', 'bader_volumes', 'bader_atoms', 'bader_distance',
            'atoms_charge', 'atoms_volume', 'atoms_spin', 'atoms_volumes',
            'atoms_surface_distance',
        ]
        for key in keys:
            try:
                d[key] = getattr(self, key)
            except AttributeError:
                pass
        return d

    # ------------------------------------------------------------ properties
    @property
    def info(self):
        return self._file_info

    @property
    def charge(self):
        return self._density.get('charge', None)

    @property
    def spin(self):
        return self._density.get('spin', None)

    @spin.setter
    def spin(self, array):
        self._density['spin'] = np.asarray(array, dtype=np.float64)

    @property
    def spin_bool(self):
        return self.spin_flag if self.spin is not None else False

    @spin_bool.setter
    def spin_bool(self, flag):
        self.spin_flag = flag

    @property
    def lattice(self):
        return self._lattice

    @property
    def lattice_volume(self):
        return _grid.lattice_volume(self.lattice)

    @property
    def distance_matrix(self):
        return _grid.distance_matrix(self.lattice, self.density.shape)

    @property
    def distance_weights(self):
        return _grid.distance_weights(self.lattice, self.density.shape)

    @property
    def voxel_lattice(self):
        return _grid.voxel_lattice(self.lattice, self.density.shape)

    @property
    def voxel_volume(self):
        return _grid.voxel_volume(self.lattice, self.density.shape)

    @property
    def voxel_offset(self):
        return np.dot(self.voxel_offset_fractional, self.voxel_lattice)

    @property
    def voxel_offset_fractional(self):
        return self.info['voxel_offset']

    @property
    def T_grad(self):
        return _grid.t_grad(self.lattice, self.density.shape)

    @property
    def atoms(self):
        return self._atoms

    @atoms.setter
    def atoms(self, array):
        array = np.asarray(array).reshape(-1)
        self._atoms = np.ascontiguousarray(
            array.reshape(array.shape[0] // 3, 3)
        )

    @property
    def atoms_fractional(self):
        return np.dot(self.atoms, np.linalg.inv(self.lattice))

    @property
    def bader_maxima(self):
        """Bader maxima in cartesian coordinates."""
        return np.dot(self.bader_maxima_fractional, self.lattice)

    @bader_maxima.setter
    def bader_maxima(self, maxima):
        """Set from voxel indices -> stored fractional."""
        maxima = np.add(maxima, self.voxel_offset_fractional)
        maxima = np.divide(maxima, self.density.shape)
        self._bader_maxima = np.ascontiguousarray(maxima)

    @property
    def bader_maxima_fractional(self):
        try:
            return self._bader_maxima
        except AttributeError:
            print("  ERROR: bader_maxima not yet set.")
            return None

    @property
    def vacuum_charge(self):
        return getattr(self, '_vacuum_charge', 0.)

    @vacuum_charge.setter
    def vacuum_charge(self, value):
        self._vacuum_charge = value

    @property
    def vacuum_volume(self):
        return getattr(self, '_vacuum_volume', 0.)

    @vacuum_volume.setter
    def vacuum_volume(self, value):
        self._vacuum_volume = value

    def _columns(self, volumes=False):
        """Result table columns: per atom, or per Bader volume."""
        if volumes:
            frac = self.bader_maxima_fractional
            cols = {'a': frac[:, 0], 'b': frac[:, 1], 'c': frac[:, 2],
                    'Charge': self.bader_charge}
            if self.spin_bool:
                cols['Spin'] = self.bader_spin
            cols['Volume'] = self.bader_volume
            cols['Distance'] = self.bader_distance
        else:
            frac = self.atoms_fractional
            cols = {'a': frac[:, 0], 'b': frac[:, 1], 'c': frac[:, 2],
                    'Charge': self.atoms_charge}
            if self.spin_bool:
                cols['Spin'] = self.atoms_spin
            cols['Volume'] = self.atoms_volume
            cols['Distance'] = self.atoms_surface_distance
        return {k: np.asarray(v, dtype=np.float64) for k, v in cols.items()}

    @property
    def dataframe(self):
        """Per-atom rows, then (without speed_flag) per-volume rows, as a
        pandas DataFrame.  pandas is optional: it is imported only here."""
        if self._dataframe is None:
            import pandas as pd

            frames = [pd.DataFrame(self._columns())]
            if not self.speed_flag:
                frames.append(pd.DataFrame(self._columns(volumes=True)))
            self._dataframe = pd.concat(frames)
        return self._dataframe

    @dataframe.setter
    def dataframe(self, df):
        self._dataframe = df

    # ---------------------------------------------------------- calculation
    def __call__(self, **kwargs):
        """Run the full Bader pipeline (reference interface.py:399-447)."""
        self.apply_config(kwargs)
        self._dataframe = None
        self.volumes_init()
        self.bader_calc()
        if not self.speed_flag:
            self.refine_volumes(self.bader_volumes)
            self.sum_volumes(bader=True)
        self.bader_to_atom_distance()
        if self.speed_flag:
            self.refine_volumes(self.atoms_volumes)
            try:
                del self.bader_volumes
            except AttributeError:
                pass
        self.min_surface_distance()
        self.sum_volumes()
        if self.export_mode is not None:
            print(f"\n  Writing Bader {self.export_mode[0]} to file:")
            count = (
                self.bader_maxima.shape[0]
                if self.export_mode[0] == 'volumes' else self.atoms.shape[0]
            )
            sel = self.export_mode[1]
            if sel[0] == -2:
                for vol_num in range(count):
                    self.write_volume(vol_num)
                if self.vacuum_tol is not None:
                    self.write_volume(-1)
            else:
                for vol_num in sel:
                    self.write_volume(vol_num)
        print('\n  Writing output file: ', end='')
        if self.output == 'pickle':
            self.to_file()
        elif self.output == 'dat':
            fn = self.prefix + self.info['filename']
            with open(fn + '-atoms.dat', 'w') as f:
                f.write(self.results())
            if not self.speed_flag:
                with open(fn + '-volumes.dat', 'w') as f:
                    f.write(self.results(volume_flag=True))
        print('Done.')

    def volumes_init(self, volumes=None):
        """Initialise (or re-mask) the volumes array using vacuum_tol."""
        if volumes is None:
            dtype = dtype_calc(-int(np.prod(self.density.shape)))
            volumes = np.zeros(self.density.shape, dtype=dtype)
        else:
            volumes = np.asarray(volumes)
        if self.vacuum_tol is not None:
            try:
                vac_tol = np.float64(self.vacuum_tol)
                mask, vc, vv = reductions.vacuum_mask(
                    jnp.asarray(self.reference), vac_tol,
                    jnp.asarray(self.density), self.voxel_volume,
                )
                volumes = np.where(
                    np.asarray(mask), np.array(-1, dtype=volumes.dtype),
                    volumes,
                )
                self.vacuum_charge = float(vc)
                self.vacuum_volume = float(vv)
            except (ValueError, TypeError) as e:
                print(f"  VACUUM_TOL ERROR: {self.vacuum_tol} is not float")
                print(f"  {e}")
        self.bader_volumes = volumes

    def bader_calc(self):
        """Partition the grid into Bader volumes (device pipeline)."""
        weights = tuple(self.distance_weights)
        vacuum = None
        vols = np.asarray(self.bader_volumes)
        if (vols == -1).any():
            vacuum = vols == -1
        with _stage("Calculating Bader volumes") as tick:
            if self.method == 'ongrid':
                labels, maxima = pipeline.partition_ongrid(
                    self.reference, vacuum, weights, mesh=self.mesh,
                    progress=tick
                )
            elif self.method == 'neargrid':
                # the hybrid's internal refinement hands its continuation
                # state to refine_volumes so a follow-up 'changed' refine
                # chains on instead of re-walking the full edge set
                carry = {}
                labels, maxima = pipeline.partition_neargrid(
                    self.reference, vacuum, weights, self.T_grad,
                    mesh=self.mesh, progress=tick, carry_out=carry
                )
                self._refine_carry = carry if carry else None
            else:
                raise ValueError(f"Unknown method: {self.method}")
            dtype = dtype_calc(-max(int(maxima.shape[0]), 1))
            self.bader_volumes = np.asarray(labels).astype(dtype)
        self.bader_maxima = maxima

    def bader_to_atom_distance(self):
        """Assign each Bader maximum to its nearest atom (27 pbc images)."""
        maxima_cart = self.bader_maxima
        with _stage("Assigning maxima to atoms"):
            atom_idx, dist = atoms_ops.assign_to_atoms(
                jnp.asarray(maxima_cart), jnp.asarray(self.atoms),
                jnp.asarray(self.lattice),
            )
            self.bader_atoms = np.asarray(atom_idx)
            self.bader_distance = np.asarray(dist)
            swap = jnp.asarray(self.bader_atoms, dtype=jnp.int32)
            if self._multi_mesh():
                from pybader_tpu.parallel.analysis import sharded_relabel

                atoms_vols = sharded_relabel(
                    self.mesh, self.bader_volumes, swap)
            else:
                atoms_vols = reductions.relabel(
                    jnp.asarray(self.bader_volumes, dtype=jnp.int32), swap
                )
            dtype = dtype_calc(-max(int(self.atoms.shape[0]), 1))
            self.atoms_volumes = np.asarray(atoms_vols).astype(dtype)

    def refine_volumes(self, volumes):
        """Refine edges of the given label map in place."""
        # continuation state from the hybrid neargrid partition applies
        # only to the label map it was computed against (bader_volumes);
        # the speed path refines the atom-relabelled map, whose edge
        # structure differs, and must start fresh.  Single-use either way.
        carry = getattr(self, '_refine_carry', None)
        self._refine_carry = None
        if volumes is not getattr(self, 'bader_volumes', None):
            carry = None
        labels = jnp.asarray(np.asarray(volumes), dtype=jnp.int32)
        with _stage("Refining volume edges", multiline=True) as tick:
            refined, _ = pipeline.refine_labels(
                self.refine_method, self.refine_mode, self.reference, labels,
                tuple(self.distance_weights), self.T_grad, mesh=self.mesh,
                progress=tick, carry_in=carry,
            )
            np.copyto(volumes, np.asarray(refined).astype(volumes.dtype))

    def sum_volumes(self, bader=False):
        """Integrate charge/spin/volume per Bader volume or per atom."""
        if bader:
            n = self._bader_maxima.shape[0]
            labels = self.bader_volumes
            prefix = 'bader'
        else:
            n = self.atoms.shape[0]
            labels = self.atoms_volumes
            prefix = 'atoms'
        with _stage(f"Integrating {prefix} charges"):
            if self._multi_mesh():
                from pybader_tpu.parallel.analysis import (
                    sharded_charge_volume_sum,
                )

                def sums(density):
                    return sharded_charge_volume_sum(
                        self.mesh, density, labels, self.voxel_volume, n)
            else:
                labels_dev = jnp.asarray(np.asarray(labels),
                                         dtype=jnp.int32)

                def sums(density):
                    return reductions.charge_volume_sum(
                        jnp.asarray(density), labels_dev,
                        self.voxel_volume, n)

            charge, volume = sums(self.density)
            setattr(self, f'{prefix}_charge', np.asarray(charge))
            setattr(self, f'{prefix}_volume', np.asarray(volume))
            if self.spin_bool:
                spin, _ = sums(self.spin)
                setattr(self, f'{prefix}_spin', np.asarray(spin))

    def _multi_mesh(self):
        return (self.mesh is not None
                and len(self.mesh.devices.reshape(-1)) > 1)

    def min_surface_distance(self):
        """Minimum distance from each atom to its Bader-volume surface."""
        atoms = self.atoms - self.voxel_offset
        if self._multi_mesh():
            from pybader_tpu.parallel.analysis import (
                sharded_min_surface_distance,
            )

            with _stage("Calculating min. surface distance"):
                dist = sharded_min_surface_distance(
                    self.mesh, self.reference, self.atoms_volumes,
                    self.lattice, atoms, int(self.atoms.shape[0]))
                self.atoms_surface_distance = np.asarray(dist)
            return
        labels = jnp.asarray(np.asarray(self.atoms_volumes), dtype=jnp.int32)
        with _stage("Calculating min. surface distance"):
            known = edges_ops.edge_find(jnp.asarray(self.reference), labels)
            dist = atoms_ops.surface_distance_masked(
                labels, known == -2, self.lattice, atoms,
                int(self.atoms.shape[0]),
            )
            self.atoms_surface_distance = np.asarray(dist)

    # -------------------------------------------------------------- results
    def results(self, volume_flag=False):
        """Format results as fixed-width text (reference interface.py:536)."""
        cols = self._columns(volumes=volume_flag)
        index = np.arange(cols['Charge'].shape[0])
        if volume_flag and self.bader_volume_tol is not None:
            keep = cols['Charge'] > self.bader_volume_tol
            cols = {k: v[keep] for k, v in cols.items()}
            index = index[keep]
        df_text = [' ' + line + '\n' for line in _format_table(index, cols)]
        df_text.insert(1, '-' * len(df_text[0]) + '\n')
        df_text.append('-' * len(df_text[0]) + '\n')
        df_text = ''.join(df_text)
        footer = ''
        tot_charge = cols['Charge'].sum()
        footer_width = int(np.log10(np.abs(tot_charge)) + 8) if tot_charge else 8
        if self.vacuum_tol is not None:
            vac_items = [self.vacuum_charge, self.vacuum_volume]
            with np.errstate(divide='ignore'):
                logs = np.log10(np.abs([v for v in vac_items if v != 0] or [1]))
            vac_width = int(np.max(logs)) + 8
            footer_width = max(footer_width, vac_width)
            footer = " Vacuum Charge:"
            footer += f"{self.vacuum_charge:>{footer_width + 6}.4f}\n"
            footer += " Vacuum Volume:"
            footer += f"{self.vacuum_volume:>{footer_width + 6}.4f}\n"
        footer += " Number of Electrons:"
        footer += f"{tot_charge:>{footer_width}.4f}"
        return df_text + footer

    # --------------------------------------------------------------- config
    def apply_config(self, d):
        for k, value in d.items():
            setattr(self, k, value)

    def load_config(self, key='DEFAULT'):
        self.apply_config(python_config(key=key))

    def __getstate__(self):
        # a Mesh holds live device handles — never pickle it; the refine
        # carry is transient device state (multi-GB walker rows)
        state = dict(self.__dict__)
        state.pop('mesh', None)
        state.pop('_refine_carry', None)
        return state

    # --------------------------------------------------------------- output
    def to_file(self):
        """Pickle self to prefix + 'bader.p' (or info['out_dest'])."""
        filename = self.info.get('out_dest', self.prefix + 'bader.p')
        with open(filename, '+wb') as f:
            dump(self, f)

    def write_volume(self, vol_num):
        """Export the density masked to one Bader volume or atom."""
        density = {}
        if self.export_mode[0] == 'volumes':
            volumes = self.bader_volumes
        else:
            volumes = self.atoms_volumes
        if self.charge is not None:
            density['charge'] = np.where(
                volumes == vol_num, self.charge, 0.0
            )
        if self.spin is not None:
            density['spin'] = np.where(volumes == vol_num, self.spin, 0.0)
        num = vol_num if vol_num != -1 else 'vacuum'
        self._file_info['comment'] = f"Bader {self.export_mode[0]}: {num}\n"
        self._file_info['fortran_format'] = self.fortran_format
        # INTENTIONAL QUIRK: exported volumes use the prefix captured in
        # file_info at read time, NOT the live self.prefix config value —
        # faithful to the reference (interface.py:620-621 there), which
        # also ignores a prefix set after from_file for these exports.
        self.info['write_function'](
            f"Bader-{self.export_mode[0]}-{num}", self.atoms, self.lattice,
            density, self.info, prefix=self.info['prefix'],
        )

    def write_density(self):
        """Write the full density as stored in the density dict."""
        self._file_info['comment'] = "Full charge density output\n"
        self._file_info['fortran_format'] = self.fortran_format
        self.info['write_function'](
            f"{self.info['filename']}", self.atoms, self.lattice,
            self._density, self.info, suffix='',
        )
