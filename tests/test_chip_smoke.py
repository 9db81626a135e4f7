"""chip_smoke.py's phases at a tiny size on the CPU, and its refusal to
run without a GPU.  (Timings here are CPU timings and are not checked;
only the card's run of the script measures anything.)"""
import numpy as np
import pytest

import chip_smoke as cs

# a small field with several basins (the benchmark's blob widths are for
# 256^3 and up; at 24^3 they would merge into one or two basins)
SMALL = dict(n_blobs=8, blur=6.0, bg_blur=600.0)


@pytest.fixture(scope="module")
def small():
    return cs.field(24, **SMALL)


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code != 0


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("cpu", None)])
def test_hbm_peak_lookup(kind, peak):
    assert cs.hbm_peak(kind) == peak


def test_phase_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    cs.phase_cli(str(tmp_path))
    assert (tmp_path / "bader.p").exists()


def test_phase_ongrid(small):
    rho_dev, rho_h, lattice, _ = small
    assert cs.phase_ongrid(rho_dev, rho_h, lattice) >= 3


def test_phase_default_exact(small):
    cs.phase_default_exact(*small)


def test_phase_bader(small, tmp_path):
    rho_dev, rho_h, lattice, atoms = small
    n_max = cs.phase_ongrid(rho_dev, rho_h, lattice)
    cs.phase_bader(rho_h, lattice, atoms, n_max, str(tmp_path))
    assert (tmp_path / "synthetic-atoms.dat").exists()


def test_phase_layers(small):
    rho_dev, _, lattice, atoms = small
    out = cs.phase_layers(rho_dev, lattice, atoms, lanes=2048)
    assert {"stencil", "flood", "pointer doubling", "renumber", "edge find",
            "charge sums", "surface distance", "gather_rate",
            "count_rtt"} <= set(out)
    assert all(np.isfinite(v) and v > 0 for v in out.values())


def test_surface_brute_force_atom_without_edges():
    labels = np.zeros((6, 6, 6), dtype=np.int32)
    labels[:3] = 1
    mask = np.zeros(labels.shape, bool)
    mask[2] = mask[5] = True
    d = cs.surface_brute_force(labels, mask, np.eye(3) * 6.0,
                               np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                         [3.0, 3.0, 3.0]]))
    assert d[2] == 0.0
    np.testing.assert_allclose(d[:2], [1.0, 1.0])


def test_four_cards_rehearsal(capsys):
    """The --four-cards path on 4 of the virtual CPU devices."""
    cs.four_cards(size=32)
    assert "match single-device" in capsys.readouterr().out
