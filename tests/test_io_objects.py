"""Object-based readers (gpaw / pymatgen) with mock objects, config system."""
import os

import numpy as np
import pytest

from tests.test_ongrid import LATTICE, SHAPE, make_density


class FakeASEAtoms:
    def __init__(self, lattice, frac):
        self.cell = lattice
        self._frac = frac
        self.positions = frac @ lattice

    def get_scaled_positions(self):
        return self._frac

    def get_atomic_numbers(self):
        return np.array([14, 8])


class FakeGPAWCalc:
    def __init__(self, rho, spin=None):
        self._rho = rho
        self._spin = spin
        lattice = LATTICE
        frac = np.array([[0.25, 0.5, 0.5], [0.75, 0.5, 0.5]])
        self._atoms = FakeASEAtoms(lattice, frac)

    def get_atoms(self):
        return self._atoms

    def get_spin_polarized(self):
        return self._spin is not None

    def get_all_electron_density(self, spin=None, gridrefinement=4):
        assert gridrefinement == 4
        if spin is None:
            return self._rho
        up = 0.5 * (self._rho + self._spin)
        dn = 0.5 * (self._rho - self._spin)
        return up if spin == 0 else dn


def test_gpaw_read_obj_charge_only():
    from pybader_tpu.io import gpaw

    rho = make_density(0)
    density, lattice, atoms, info = gpaw.read_obj(FakeGPAWCalc(rho))
    np.testing.assert_array_equal(density["charge"], rho)
    assert "spin" not in density
    np.testing.assert_allclose(lattice, LATTICE)
    assert atoms.shape == (2, 3)
    assert info["file_type"] == "gpaw"
    np.testing.assert_array_equal(info["voxel_offset"], np.zeros(3))


def test_gpaw_read_obj_spin():
    from pybader_tpu.io import gpaw

    rho = make_density(1)
    spin = make_density(2) * 0.1
    density, *_ = gpaw.read_obj(FakeGPAWCalc(rho, spin), spin_flag=True)
    np.testing.assert_allclose(density["charge"], rho)
    np.testing.assert_allclose(density["spin"], spin)


class FakeLattice:
    def __init__(self, matrix):
        self.matrix = matrix
        self.volume = abs(np.linalg.det(matrix))


class FakeSite:
    def __init__(self, symbol):
        class S:
            pass

        self.specie = S()
        self.specie.symbol = symbol


class FakeStructure:
    def __init__(self, lattice, frac, symbols):
        self.lattice = FakeLattice(lattice)
        self.frac_coords = frac
        self.sites = [FakeSite(s) for s in symbols]
        self._sites = self.sites


class FakeVolumetricData:
    def __init__(self, rho, spin=None):
        self.data = {"total": rho}
        if spin is not None:
            self.data["diff"] = spin
        frac = np.array([[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]])
        self.structure = FakeStructure(LATTICE, frac, ["Si", "Si"])


def test_pymatgen_read_obj():
    from pybader_tpu.io import pymatgen

    rho = make_density(3)
    density, lattice, atoms, info = pymatgen.read_obj(FakeVolumetricData(rho))
    vol = abs(np.linalg.det(LATTICE))
    # reference bug fixed here: density IS volume-normalised
    np.testing.assert_allclose(density["charge"], rho / vol)
    np.testing.assert_allclose(lattice, LATTICE)
    assert list(info["elements"]) == ["Si"]
    np.testing.assert_array_equal(info["element_nums"], [2])


def test_pymatgen_read_obj_spin():
    from pybader_tpu.io import pymatgen

    rho = make_density(4)
    spin = make_density(5) * 0.2
    density, *_ = pymatgen.read_obj(
        FakeVolumetricData(rho, spin), spin_flag=True
    )
    vol = abs(np.linalg.det(LATTICE))
    np.testing.assert_allclose(density["spin"], spin / vol)


def test_config_writer_roundtrip(tmp_path, monkeypatch):
    import pybader_tpu.dunders as dunders
    import pybader_tpu.entry_points as ep
    import pybader_tpu.interface as iface

    cfg = str(tmp_path / "config.ini")
    monkeypatch.setattr(dunders, "__config__", cfg)
    monkeypatch.setattr(ep, "__config__", cfg)
    monkeypatch.setattr(iface, "__config__", cfg)
    ep.config_writer(quiet=True)
    assert os.path.isfile(cfg)
    conf = iface.python_config(cfg, "DEFAULT")
    assert conf["method"] == "neargrid"
    assert conf["refine_mode"] == ("changed", 2)
    speed = iface.python_config(cfg, "speed")
    assert speed["method"] == "ongrid"
    assert speed["speed_flag"] is True
    # user edits survive an upgrade
    with open(cfg, "a") as f:
        f.write("\n[custom]\nmethod = 'ongrid'\nthreads = 4\n")
    ep.config_writer(quiet=True)
    custom = iface.python_config(cfg, "custom")
    assert custom["method"] == "ongrid"
    assert custom["threads"] == 4


def test_python_config_missing_file_defaults(tmp_path):
    from pybader_tpu.interface import python_config, DEFAULT_CONFIG

    conf = python_config(str(tmp_path / "nope.ini"), "DEFAULT")
    assert conf == DEFAULT_CONFIG


def test_precompile_warm_runs():
    from pybader_tpu import precompile

    precompile.warm(shapes=((12, 10, 8),))


def test_cache_dir_honours_env(tmp_path, monkeypatch):
    from pybader_tpu import precompile

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert precompile.cache_dir() == str(tmp_path / "jc")


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch):
    """Without the env var the cache sits at one path derived from the
    package location (never a temp name, pid or time), gitignored."""
    import os

    from pybader_tpu import precompile

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        precompile.__file__)))
    assert precompile.cache_dir() == os.path.join(root, ".jax_cache")
    assert precompile.cache_dir() == precompile.cache_dir()
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_persistent_cache_points_jax_at_it(tmp_path, monkeypatch):
    import jax

    from pybader_tpu import precompile

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert precompile.enable_persistent_cache() == str(tmp_path / "jc")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")
        assert (tmp_path / "jc").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_no_pallas_kernels_in_the_program():
    """No module of the program imports a Pallas kernel: every layer is
    plain XLA, so nothing needs a particular accelerator."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sources = [os.path.join(root, f) for f in
               ("bench.py", "chip_smoke.py", "__graft_entry__.py")]
    for d, _, files in os.walk(os.path.join(root, "pybader_tpu")):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            text = f.read()
        for bad in ("experimental.pallas", "_src.pallas", "MosaicError"):
            assert bad not in text, (path, bad)
    modules = sorted(
        os.path.relpath(p, root)[:-3].replace(os.sep, ".")
        .replace(".__init__", "") for p in sources if "pybader_tpu" in p)
    code = (f"import importlib, sys\n"
            f"for m in {modules!r}:\n"
            f"    importlib.import_module(m)\n"
            f"print(sorted(k for k in sys.modules if 'pallas' in k))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
