"""End-to-end tests of the Bader class and CLI."""
import pickle

import numpy as np
import pytest

from tests.test_io import ATOMS, _write_chgcar
from tests.test_ongrid import LATTICE, SHAPE, make_density

from pybader_tpu.interface import Bader, DEFAULT_CONFIG


@pytest.fixture(scope="module")
def _cli_cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_cache"))


@pytest.fixture(autouse=True)
def _cache_outside_checkout(_cli_cache, monkeypatch):
    """The CLI enables the persistent compile cache: keep it in a temp
    directory (shared by this module's tests, so the first-run warm-up
    happens once) and leave the checkout clean."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", _cli_cache)


def atomic_density(seed=0):
    """Two blobs centred on ATOMS so maxima->atom mapping is clean."""
    from tests.oracle import gaussian_density

    centers = ATOMS @ np.linalg.inv(LATTICE)
    rho = gaussian_density(SHAPE, LATTICE, centers, [0.9, 0.8], [2.0, 1.5])
    return rho + 1e-8


def make_bader(tmp_path, **kwargs):
    rho = atomic_density()
    fn = tmp_path / "CHGCAR"
    _write_chgcar(fn, rho)
    return Bader.from_file(str(fn), **kwargs)


def test_from_file_and_defaults(tmp_path):
    bader = make_bader(tmp_path)
    assert bader.method == DEFAULT_CONFIG["method"]
    assert bader.density.shape == SHAPE
    assert bader.reference is bader.density
    np.testing.assert_allclose(bader.lattice, LATTICE, atol=2e-6)
    assert bader.atoms.shape == (2, 3)
    assert bader.charge is not None and bader.spin is None
    assert bader.spin_bool is False


def test_full_call_speed_profile(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    bader.load_config("speed")
    assert bader.method == "ongrid" and bader.speed_flag
    bader()
    assert bader.atoms_charge.shape == (2,)
    # charge conservation
    total = bader.atoms_charge.sum() + bader.vacuum_charge
    np.testing.assert_allclose(
        total, bader.density.sum() * bader.voxel_volume, rtol=1e-10
    )
    assert not hasattr(bader, "bader_volumes")  # deleted on speed path
    assert (tmp_path / "bader.p").exists()
    # pickle round-trip (the checkpoint/resume subsystem)
    with open(tmp_path / "bader.p", "rb") as f:
        loaded = pickle.load(f)
    np.testing.assert_array_equal(loaded.atoms_volumes, bader.atoms_volumes)
    np.testing.assert_allclose(loaded.atoms_charge, bader.atoms_charge)


def test_full_call_default_neargrid(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    bader(refine_mode=("changed", 2))
    assert bader.bader_maxima.shape[0] >= 2
    assert bader.bader_charge.shape[0] == bader.bader_maxima.shape[0]
    assert bader.atoms_charge.shape == (2,)
    np.testing.assert_allclose(
        bader.atoms_charge.sum(),
        bader.density.sum() * bader.voxel_volume, rtol=1e-10,
    )
    # both atoms get roughly the charge of their blob
    assert (bader.atoms_charge > 1).all()
    assert (bader.atoms_surface_distance > 0).all()
    # maxima land on the atoms
    assert set(np.asarray(bader.bader_atoms)) == {0, 1}


def test_vacuum_tol_and_results_text(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    rho = bader.density
    tol = float(np.quantile(rho, 0.2))
    bader(vacuum_tol=tol, speed_flag=True, method="ongrid")
    assert bader.vacuum_charge > 0
    assert bader.vacuum_volume > 0
    text = bader.results()
    assert "Vacuum Charge:" in text
    assert "Number of Electrons:" in text
    total = bader.atoms_charge.sum() + bader.vacuum_charge
    np.testing.assert_allclose(
        total, bader.density.sum() * bader.voxel_volume, rtol=1e-10
    )


def test_results_volume_table(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    bader(method="ongrid", refine_mode=("changed", 1))
    text = bader.results(volume_flag=True)
    assert "Charge" in text


def test_export_mode(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    bader(method="ongrid", export_mode=("atoms", [0]), speed_flag=True)
    exported = list(tmp_path.glob("Bader-atoms-0*"))
    assert exported, "expected exported masked density file"
    # exported density is the charge masked to atom 0's volume
    from pybader_tpu.io import vasp

    density, _, _, _ = vasp.read(str(exported[0]))
    mask = np.asarray(bader.atoms_volumes) == 0
    np.testing.assert_allclose(
        density["charge"][mask], bader.charge[mask], rtol=2e-10
    )
    assert (density["charge"][~mask] == 0).all()


def test_spin_flag_pipeline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rho = atomic_density()
    spin = rho * 0.1
    fn = tmp_path / "CHGCAR"
    _write_chgcar(fn, rho, spin=spin)
    bader = Bader.from_file(str(fn), spin_flag=True)
    assert bader.spin is not None
    bader(method="ongrid", speed_flag=True)
    assert bader.atoms_spin.shape == (2,)
    np.testing.assert_allclose(
        bader.atoms_spin.sum(), spin.sum() * bader.voxel_volume, rtol=1e-8
    )
    assert "Spin" in bader.results()


def test_spin_setter(tmp_path):
    """The reference's getter-only spin property is fixed here."""
    bader = make_bader(tmp_path)
    spin = np.ones(SHAPE)
    bader.spin = spin
    np.testing.assert_array_equal(bader.spin, spin)


def test_as_dict_from_dict(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    bader(method="ongrid", speed_flag=True)
    clone = Bader.from_dict(bader.as_dict)
    assert clone is not None  # reference forgets the return
    np.testing.assert_allclose(clone.atoms_charge, bader.atoms_charge)


def test_cli_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rho = atomic_density()
    _write_chgcar(tmp_path / "CHGCAR", rho)
    from pybader_tpu.entry_points import bader as bader_cli
    from pybader_tpu.entry_points import bader_read

    bader_cli(["CHGCAR", "-m", "ongrid", "-r", "1", "-x"])
    out = capsys.readouterr().out
    assert "Bader Charge Analysis" in out
    assert (tmp_path / "bader.p").exists()
    bader_read(["bader.p", "-a"])
    out = capsys.readouterr().out
    assert "Number of Electrons:" in out


def test_cli_dat_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rho = atomic_density()
    _write_chgcar(tmp_path / "CHGCAR", rho)
    from pybader_tpu.entry_points import bader as bader_cli

    bader_cli(["CHGCAR", "-m", "ongrid", "-r", "1", "-o", "dat"])
    assert (tmp_path / "CHGCAR-atoms.dat").exists()
    assert (tmp_path / "CHGCAR-volumes.dat").exists()


def test_bader_read_vacuum_rethreshold(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rho = atomic_density()
    _write_chgcar(tmp_path / "CHGCAR", rho)
    from pybader_tpu.entry_points import bader as bader_cli
    from pybader_tpu.entry_points import bader_read

    bader_cli(["CHGCAR", "-m", "ongrid", "-r", "1"])
    capsys.readouterr()
    bader_read(["bader.p", "-vac", "auto", "-a"])
    out = capsys.readouterr().out
    assert "Vacuum Charge:" in out
    # conservation after re-threshold
    import pickle

    with open("bader.p", "rb") as f:
        bader = pickle.load(f)
    # re-run the rethreshold path on the object directly
    bader.vacuum_tol = 1e-3
    bader.volumes_init(volumes=bader.atoms_volumes)
    bader.atoms_volumes = bader.bader_volumes
    bader.sum_volumes()
    total = bader.atoms_charge.sum() + bader.vacuum_charge
    np.testing.assert_allclose(
        total, bader.density.sum() * bader.voxel_volume, rtol=1e-10
    )


def test_cli_reference_density_sum(tmp_path, monkeypatch):
    """-ref: reference densities are read and summed (doc'd behaviour;
    the reference implementation overwrote instead of summing)."""
    monkeypatch.chdir(tmp_path)
    rho = atomic_density()
    _write_chgcar(tmp_path / "CHGCAR", rho)
    _write_chgcar(tmp_path / "REF1.vasp", rho * 0.5)
    _write_chgcar(tmp_path / "REF2.vasp", rho * 0.5)
    from pybader_tpu.entry_points import bader as bader_cli

    bader_cli(["CHGCAR", "-m", "ongrid", "-r", "0",
               "-ref", "REF1.vasp", "REF2.vasp"])
    import pickle

    with open("bader.p", "rb") as f:
        bader = pickle.load(f)
    # partitioning used the summed reference (== rho) — charges sane
    np.testing.assert_allclose(
        bader.atoms_charge.sum(),
        bader.density.sum() * bader.voxel_volume, rtol=1e-10,
    )


def test_cli_export_all_atoms(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rho = atomic_density()
    _write_chgcar(tmp_path / "CHGCAR", rho)
    from pybader_tpu.entry_points import bader as bader_cli

    bader_cli(["CHGCAR", "-m", "ongrid", "-r", "1", "-x",
               "-e", "all_atoms"])
    assert (tmp_path / "Bader-atoms-0-CHGCAR").exists()
    assert (tmp_path / "Bader-atoms-1-CHGCAR").exists()


def test_interface_hybrid_carry_wiring(tmp_path, monkeypatch):
    """With the hybrid forced on (threshold 0), bader_calc stashes the
    refinement carry and refine_volumes chains on it — the labels must be
    bit-identical to the explicit pipeline-level carry composition."""
    import jax.numpy as jnp

    from pybader_tpu import grid as g
    from pybader_tpu import pipeline

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pipeline, "_NEARGRID_HYBRID_THRESHOLD", 0)
    bader = make_bader(tmp_path)
    bader.method = "neargrid"
    bader.refine_mode = ("changed", 2)
    bader.volumes_init()
    bader.bader_calc()
    assert bader._refine_carry, "hybrid bader_calc should stash the carry"
    bader.refine_volumes(bader.bader_volumes)
    assert bader._refine_carry is None, "carry must be single-use"

    rho = bader.reference
    w = tuple(g.distance_weights(bader.lattice, rho.shape))
    tg = g.t_grad(bader.lattice, rho.shape)
    carry = {}
    lab, _ = pipeline.partition_neargrid(
        rho, None, w, tg, full_trajectories=False, carry_out=carry)
    lab, _ = pipeline.refine_labels(
        "neargrid", ("changed", 2), rho, jnp.asarray(lab), w, tg,
        verbose=False, carry_in=carry)
    np.testing.assert_array_equal(
        np.asarray(bader.bader_volumes), np.asarray(lab))


def test_import_and_cli_parser_without_pandas():
    """The main path imports no pandas: importing the interface and the
    CLI works with pandas blocked."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'pandas':\n"
        "            raise ImportError('pandas blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pybader_tpu.interface, pybader_tpu.entry_points\n"
        "print('pandas' in sys.modules)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"


def test_results_tables_without_pandas(tmp_path, monkeypatch):
    """results() builds its tables without pandas; the optional dataframe
    property is the only pandas user."""
    import sys

    monkeypatch.chdir(tmp_path)
    bader = make_bader(tmp_path)
    bader(method="ongrid", refine_mode=("changed", 1))
    monkeypatch.setitem(sys.modules, "pandas", None)
    atoms = bader.results()
    volumes = bader.results(volume_flag=True)
    lines = atoms.splitlines()
    assert lines[0].split() == ["a", "b", "c", "Charge", "Volume",
                                "Distance"]
    assert set(lines[1]) == {"-"}
    rows = [ln.split() for ln in lines[2:2 + len(bader.atoms)]]
    np.testing.assert_allclose([float(r[4]) for r in rows],
                               bader.atoms_charge, atol=5e-7)
    assert [int(r[0]) for r in rows] == list(range(len(bader.atoms)))
    assert "Number of Electrons:" in volumes
    with pytest.raises(ImportError):
        bader.dataframe
