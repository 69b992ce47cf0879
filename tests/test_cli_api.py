"""CLI and library-API tests (the reference's L11 surface)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_dry_run(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--params",
         os.path.join(REPO, "benchmarks", "stromgren.param"), "--dry"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr


def test_cli_mini_ionization_run(tmp_path):
    param_text = """
SimulationBox:
  anchor: [-5. pc, -5. pc, -5. pc]
  sides: [10. pc, 10. pc, 10. pc]
DensityGrid:
  number of cells: [12, 12, 12]
DensityFunction:
  density: 100. cm^-3
  temperature: 8000. K
PhotonSourceDistribution:
  luminosity: 4.26e49 s^-1
IonizationSimulation:
  number of photons: 5000
  number of iterations: 3
CrossSections:
  hydrogen_0: 6.3e-18 cm^2
RecombinationRates:
  hydrogen_1: 4.e-13 cm^3 s^-1
DensityGridWriter:
  prefix: mini_
"""
    param_file = tmp_path / "mini.param"
    param_file.write_text(param_text)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--params", str(param_file)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    assert " x cpu (" in result.stderr  # the platform is logged
    snap = tmp_path / "mini_000.hdf5"
    assert snap.exists()
    used = tmp_path / "mini.param.used-values"
    assert used.exists()

    from cmacionize_tpu.io.gadget import read_gadget_snapshot

    _, coords, fields = read_gadget_snapshot(str(snap))
    assert coords.shape == (12**3, 3)
    xh = fields["NeutralFractionH"]
    assert xh.min() < 1e-3  # ionized interior
    assert xh.max() > 0.9  # neutral corners


def test_library_api_stromgren():
    # particles uniformly filling the box -> same physics as the homogeneous
    # stromgren setup; check per-particle neutral fractions by radius
    pc = 3.086e16
    rng = np.random.default_rng(1)
    n_part = 20000
    positions = rng.uniform(-5 * pc, 5 * pc, (n_part, 3))
    box_volume = (10 * pc) ** 3
    target_nd = 1e8
    m_p = 1.672621898e-27
    masses = np.full(n_part, target_nd * box_volume * m_p / n_part)

    from cmacionize_tpu.api import compute_neutral_fraction

    xh = compute_neutral_fraction(
        positions, masses,
        (-5 * pc,) * 3, (10 * pc,) * 3, (16, 16, 16),
        n_photons=20000, n_iterations=5, seed=2,
    )
    assert xh.shape == (n_part,)
    r = np.sqrt((positions**2).sum(1))
    inner = xh[r < 2 * pc]
    outer = xh[r > 4.8 * pc]
    assert np.median(inner) < 1e-3
    assert np.median(outer) > 0.5


def test_cli_dust_mode(tmp_path):
    """--dusty-radiative-transfer writes a BinaryArray CCD image
    (mode dispatch parity with /root/reference/src/CMacIonize.cpp:274-376)."""
    param_text = """
SimulationBox:
  anchor: [-12. kpc, -12. kpc, -12. kpc]
  sides: [24. kpc, 24. kpc, 24. kpc]
DensityGrid:
  number of cells: [16, 16, 16]
DensityFunction:
  central density: 1. cm^-3
  scale length ISM: 6. kpc
  scale height ISM: 0.22 kpc
ContinuousPhotonSource:
  scale length stars: 5. kpc
  scale height stars: 0.6 kpc
dust:
  band: V
DustSimulation:
  number of photons: 2000
CCDImage:
  image width: 32
  image height: 32
  view theta: 89.7 degrees
  view phi: 0 degrees
  anchor x: -12.1 kpc
  anchor y: -12.1 kpc
  sides x: 24.2 kpc
  sides y: 24.2 kpc
  filename: galaxy_image
"""
    param_file = tmp_path / "dust.param"
    param_file.write_text(param_text)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--dusty-radiative-transfer",
         "--params", str(param_file)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    image_file = tmp_path / "galaxy_image.dat"
    assert image_file.exists()
    image = np.fromfile(image_file, dtype=np.float64).reshape(32, 32)
    assert np.all(np.isfinite(image))
    assert image.sum() > 0.0


def test_cli_emission_mode(tmp_path):
    """--emission appends Emissivity* datasets to an existing snapshot
    (cf. /root/reference/src/EmissivityCalculationSimulation.cpp:59-270)."""
    h5py = pytest.importorskip("h5py")
    snap = tmp_path / "snap.hdf5"
    n = 27
    with h5py.File(snap, "w") as handle:
        parts = handle.create_group("PartType0")
        parts.create_dataset("NumberDensity", data=np.full(n, 1.0e8))
        parts.create_dataset("Temperature", data=np.full(n, 8000.0))
        parts.create_dataset("NeutralFractionH", data=np.full(n, 0.1))
        parts.create_dataset("NeutralFractionHe", data=np.full(n, 0.2))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--emission",
         "--file", str(snap), "--params", ""],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr
    with h5py.File(snap, "r") as handle:
        names = [k for k in handle["PartType0"] if k.startswith("Emissivity")]
        assert len(names) >= 40  # all 42 reference EMISSIONLINE_* labels
        hbeta = np.asarray(handle["PartType0"]["EmissivityHBeta"])
        assert np.all(hbeta > 0)


def test_cli_amr_grid_dispatch(tmp_path, monkeypatch):
    """DensityGrid:type: AMR runs the AMR driver end-to-end
    (DensityGridFactory.hpp:73)."""
    monkeypatch.chdir(tmp_path)
    param_file = tmp_path / "amr.param"
    param_file.write_text(
        "SimulationBox:\n"
        "  anchor: [0. m, 0. m, 0. m]\n"
        "  sides: [1.e17 m, 1.e17 m, 1.e17 m]\n"
        "DensityGrid:\n"
        "  type: AMR\n"
        "  number of cells: [8, 8, 8]\n"
        "  AMRRefinementScheme:\n"
        "    type: Opacity\n"
        "    target opacity: 1.e-18 m^-1\n"
        "    maximum refinement level: 1\n"
        "DensityFunction:\n"
        "  density: 100. cm^-3\n"
        "PhotonSourceDistribution:\n"
        "  position: [5.e16 m, 5.e16 m, 5.e16 m]\n"
        "  luminosity: 1.e48 s^-1\n"
        "IonizationSimulation:\n"
        "  number of photons: 2000\n"
        "  number of iterations: 2\n"
    )
    from cmacionize_tpu import cli

    assert cli.main(["--params", str(param_file)]) == 0
    import numpy as np

    out = np.load(tmp_path / "snapshot_cells.npz")
    xh = out["neutral_fraction"]
    assert xh.ndim == 1 and (xh > 0).all() and (xh <= 1).all()


def test_cli_voronoi_grid_dispatch(tmp_path, monkeypatch):
    """DensityGrid:type: Voronoi runs the Voronoi driver end-to-end."""
    monkeypatch.chdir(tmp_path)
    param_file = tmp_path / "vor.param"
    param_file.write_text(
        "SimulationBox:\n"
        "  anchor: [0. m, 0. m, 0. m]\n"
        "  sides: [1.e17 m, 1.e17 m, 1.e17 m]\n"
        "DensityGrid:\n"
        "  type: Voronoi\n"
        "  number of Lloyd iterations: 1\n"
        "  VoronoiGeneratorDistribution:\n"
        "    type: UniformRandom\n"
        "    number of positions: 300\n"
        "DensityFunction:\n"
        "  density: 100. cm^-3\n"
        "PhotonSourceDistribution:\n"
        "  position: [5.e16 m, 5.e16 m, 5.e16 m]\n"
        "  luminosity: 1.e48 s^-1\n"
        "IonizationSimulation:\n"
        "  number of photons: 2000\n"
        "  number of iterations: 2\n"
    )
    from cmacionize_tpu import cli

    assert cli.main(["--params", str(param_file)]) == 0
    import numpy as np

    out = np.load(tmp_path / "snapshot_cells.npz")
    assert out["neutral_fraction"].shape == (300,)


def test_cli_amr_multi_element_dispatch(tmp_path, monkeypatch):
    """A non-monochromatic spectrum (or T-calculation) on an AMR grid routes
    to the multi-element driver (full ionization machinery on every grid
    family, cf. AMRDensityGrid plugging into IonizationSimulation)."""
    monkeypatch.chdir(tmp_path)
    param_file = tmp_path / "amr_mf.param"
    param_file.write_text(
        "SimulationBox:\n"
        "  anchor: [-5. pc, -5. pc, -5. pc]\n"
        "  sides: [10. pc, 10. pc, 10. pc]\n"
        "DensityGrid:\n"
        "  type: AMR\n"
        "  number of cells: [8, 8, 8]\n"
        "  AMRRefinementScheme:\n"
        "    type: Opacity\n"
        "    target opacity: 1.e-18 m^-1\n"
        "    maximum refinement level: 1\n"
        "DensityFunction:\n"
        "  density: 100. cm^-3\n"
        "PhotonSourceDistribution:\n"
        "  position: [0. m, 0. m, 0. m]\n"
        "  luminosity: 4.26e49 s^-1\n"
        "PhotonSourceSpectrum:\n"
        "  type: Planck\n"
        "  temperature: 40000. K\n"
        "TemperatureCalculator:\n"
        "  do temperature calculation: true\n"
        "IonizationSimulation:\n"
        "  number of photons: 5000\n"
        "  number of iterations: 5\n"
    )
    from cmacionize_tpu import cli

    assert cli.main(["--params", str(param_file)]) == 0
    import numpy as np

    out = np.load(tmp_path / "snapshot_cells.npz")
    assert "temperature" in out and "neutral_fraction_He" in out
    assert (out["temperature"] > 0).all()
    assert out["neutral_fraction"].min() < 0.1  # ionized core exists


def test_cli_tracker_manager_wiring(tmp_path):
    """The reference's TrackerManager parameter block + tracker YAML runs
    unchanged through the CLI:
    trackers placed, the photon budget raised to `minimum number of photon
    packets`, reference-layout outputs written."""
    (tmp_path / "trackers.yml").write_text(
        "number of trackers: 2\n"
        "tracker[0]:\n"
        "  position: [1. pc, 0. pc, 0. pc]\n"
        "  type: Spectrum\n"
        "tracker[1]:\n"
        "  position: [1. pc, 0. pc, 0. pc]\n"
        "  type: Absorption\n"
        "  output name: absorption.txt\n"
    )
    param_text = """
SimulationBox:
  anchor: [-5. pc, -5. pc, -5. pc]
  sides: [10. pc, 10. pc, 10. pc]
DensityGrid:
  number of cells: [8, 8, 8]
DensityFunction:
  density: 100. cm^-3
  temperature: 8000. K
PhotonSourceDistribution:
  luminosity: 4.26e49 s^-1
PhotonSourceSpectrum:
  type: Planck
  temperature: 40000. K
IonizationSimulation:
  number of photons: 1000
  number of iterations: 2
TrackerManager:
  filename: trackers.yml
  minimum number of photon packets: 4096
DensityGridWriter:
  prefix: trk_
"""
    param_file = tmp_path / "trk.param"
    param_file.write_text(param_text)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--params", str(param_file)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600,
    )
    assert result.returncode == 0, result.stderr
    assert "placed 2 tracker(s)" in result.stdout + result.stderr
    spectrum = tmp_path / "Tracker0.txt"
    absorption = tmp_path / "absorption.txt"
    assert spectrum.exists() and absorption.exists()
    import numpy as np

    data = np.loadtxt(spectrum)
    assert data.shape[1] == 4  # frequency + 3 PHOTONTYPE columns
    assert data[:, 1].sum() > 0  # primary crossings recorded
    text = absorption.read_text()
    assert text.startswith("# Ion") and "H_n" in text


def _voronoi_rhd_param(total_myr):
    return (
        "CrossSections:\n"
        "  type: FixedValue\n"
        "  hydrogen_0: 6.3e-18 cm^2\n"
        "RecombinationRates:\n"
        "  type: FixedValue\n"
        "  hydrogen_1: 2.7e-13 cm^3 s^-1\n"
        "DensityFunction:\n"
        "  density: 3113. cm^-3\n"
        "  temperature: 100. K\n"
        "DensityGrid:\n"
        "  type: Voronoi\n"
        "  VoronoiGeneratorDistribution:\n"
        "    type: UniformRandom\n"
        "    number of positions: 500\n"
        "HydroIntegrator:\n"
        "  polytropic index: 1.0001\n"
        "PhotonSourceDistribution:\n"
        "  luminosity: 1.e+49 Hz\n"
        "  position: [0. pc, 0. pc, 0. pc]\n"
        "RadiationHydrodynamicsSimulation:\n"
        "  number of iterations: 2\n"
        "  number of photons: 4000\n"
        f"  total time: {total_myr} Myr\n"
        "  minimum timestep: 0.000705 Myr\n"
        "  maximum timestep: 0.000705 Myr\n"
        "RestartManager:\n"
        "  output interval: 0. s\n"
        "SimulationBox:\n"
        "  anchor: [-1.256 pc, -1.256 pc, -1.256 pc]\n"
        "  sides: [2.512 pc, 2.512 pc, 2.512 pc]\n"
    )


def test_cli_rhd_voronoi_restart_resume(tmp_path, monkeypatch):
    """--restart resumes a Voronoi RHD run bit-for-bit: a 2-step run's
    checkpoint continued for 2 more steps matches an uninterrupted 4-step
    run (the kill-and-resume guarantee of the reference's RestartManager,
    /root/reference/src/RestartManager.hpp:108-122)."""
    import numpy as np

    from cmacionize_tpu import cli
    from cmacionize_tpu.io.gadget import read_gadget_snapshot

    full = tmp_path / "full"
    half = tmp_path / "half"
    full.mkdir()
    half.mkdir()

    monkeypatch.chdir(full)
    (full / "p.param").write_text(_voronoi_rhd_param(0.00282))
    assert cli.main(["--rhd", "-p", "p.param"]) == 0

    monkeypatch.chdir(half)
    (half / "p1.param").write_text(_voronoi_rhd_param(0.00141))
    assert cli.main(["--rhd", "-p", "p1.param"]) == 0
    # continue the checkpointed state to the full time
    (half / "p2.param").write_text(_voronoi_rhd_param(0.00282))
    assert cli.main(["--rhd", "-p", "p2.param", "--restart", "."]) == 0

    _b, _c, f_full = read_gadget_snapshot(str(full / "snapshot_004.hdf5"))
    _b, _c, f_res = read_gadget_snapshot(str(half / "snapshot_004.hdf5"))
    np.testing.assert_array_equal(
        f_full["NeutralFractionH"], f_res["NeutralFractionH"])
    np.testing.assert_array_equal(f_full["Density"], f_res["Density"])


@pytest.mark.parametrize("env_dir", [None, "explicit"])
def test_compilation_cache_placement(tmp_path, env_dir):
    """Unset JAX_COMPILATION_CACHE_DIR → <checkout>/.jax_cache; set → JAX
    keeps the variable's directory and the package overrides nothing."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    expected = os.path.join(REPO, ".jax_cache")
    if env_dir:
        expected = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = expected
    result = subprocess.run(
        [sys.executable, "-c",
         "import cmacionize_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == expected


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """chip_smoke.py exits non-zero, prints its reason and no result line,
    on a CPU-only JAX and in a directory without the rest of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        import shutil

        shutil.copy(script, tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, script], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120)
    assert result.returncode != 0
    assert "needs a GPU" in result.stderr
    assert '"ok"' not in result.stdout


@pytest.mark.parametrize("argv, grid, writes", [
    ([], "Cartesian", True),
    (["--rhd"], "Cartesian", True),
    (["--rhd"], "Voronoi", True),
    (["--emission"], "Cartesian", True),
    ([], "AMR", False),
    ([], "Voronoi", False),
    (["--dusty-radiative-transfer"], "Cartesian", False),
])
def test_modes_that_need_h5py(argv, grid, writes):
    from cmacionize_tpu import cli
    from cmacionize_tpu.utils.params import ParameterFile

    args = _mode_args(argv)
    params = ParameterFile({"DensityGrid": {"type": grid}})
    assert cli._writes_gadget_snapshots(args, params) is writes


def _mode_args(argv):
    import argparse

    return argparse.Namespace(
        rhd="--rhd" in argv, task_based_rhd=False,
        emission="--emission" in argv,
        dusty_radiative_transfer="--dusty-radiative-transfer" in argv)


def test_cli_refuses_snapshot_run_without_h5py(tmp_path, monkeypatch):
    """Without h5py a snapshot-writing run stops at start-up, naming h5py,
    before any simulation work."""
    import importlib.util

    from cmacionize_tpu import cli

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "h5py" else find_spec(name, *a))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="h5py"):
        cli.main(["--params", os.path.join(REPO, "benchmarks",
                                           "stromgren.param")])
    assert not list(tmp_path.glob("*.hdf5"))
