"""Photon data parallelism on the special (AMR / Voronoi) grids.

The reference distributes its AMR and Voronoi grids only through the
replicated-grid MPI mode of the classic driver (grid replicated per rank,
photon count split, tallies Allreduce'd —
/root/reference/src/IonizationSimulation.cpp:395-529); these tests exercise
the JAX equivalent (parallel.photon_dp.make_{voronoi,amr}_dp_trace +
the drivers' ``mesh=`` mode) on the 8-virtual-device CPU mesh and check the
converged state against the single-device drivers to MC noise.
"""

import numpy as np
import pytest

import jax

from cmacionize_tpu.models import amr, voronoi
from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.parallel.mesh import make_mesh

PC = 3.086e16

COMMON = dict(
    source_position=(0.0, 0.0, 0.0),
    luminosity=4.26e49,
    cross_section=6.3e-22,
    recombination_rate=4e-19,
    n_photons=32768,
)


def _density(pos):
    return np.full(len(np.atleast_2d(pos)), 1e8)


@pytest.fixture(scope="module")
def geometry():
    return GridGeometry(
        anchor=(-5 * PC,) * 3, sides=(10 * PC,) * 3, shape=(16,) * 3)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh(8)


def test_voronoi_honly_dp_matches_single_device(geometry, mesh):
    rng = np.random.default_rng(3)
    grid = voronoi.build_voronoi_grid(
        geometry, rng.random((1500, 3)), num_lloyd=1)
    sim1 = voronoi.HOnlyVoronoiSimulation(
        grid, _density, seed=1, **COMMON)
    sim8 = voronoi.HOnlyVoronoiSimulation(
        grid, _density, seed=1, mesh=mesh, **COMMON)
    sim1.run(6)
    sim8.run(6)
    v1, v8 = sim1.ionized_volume(), sim8.ionized_volume()
    # same physics to MC noise (independent streams, same total photons)
    assert v8 == pytest.approx(v1, rel=0.05)
    # per-cell agreement in the well-sampled interior
    x1 = np.asarray(sim1.neutral_fraction)
    x8 = np.asarray(sim8.neutral_fraction)
    interior = x1 < 0.1
    assert interior.sum() > 50
    assert np.median(np.abs(x8[interior] - x1[interior])) < 0.02


def test_amr_honly_dp_matches_single_device(geometry, mesh):
    scheme = amr.OpacityRefinement(2.0)
    sim1 = amr.AMRIonizationSimulation(
        geometry, scheme, _density, max_level=2, seed=1, **COMMON)
    sim8 = amr.AMRIonizationSimulation(
        geometry, scheme, _density, max_level=2, seed=1, mesh=mesh, **COMMON)
    sim1.run(6)
    sim8.run(6)
    assert sim8.ionized_volume() == pytest.approx(
        sim1.ionized_volume(), rel=0.05)


def test_amr_dp_with_regrid(geometry, mesh):
    """The DP trace closes over the octree tables, so a mid-run regrid
    (refinement_interval) must rebuild it — exercised here with the
    refinement criterion fed by the evolving neutral fraction."""
    scheme = amr.OpacityRefinement(3.0e-14, 2)
    sim = amr.AMRIonizationSimulation(
        geometry, scheme, _density, max_level=2, seed=1, mesh=mesh,
        refinement_interval=2, **COMMON)
    n_leaves_before = sim.grid.n_cells
    sim.run(5)
    # the regrid actually happened (front structure refines the grid) and
    # physics stayed sane through the dp_trace rebuild
    assert sim.iteration == 5
    assert np.isfinite(np.asarray(sim.neutral_fraction)).all()
    assert sim.grid.n_cells != n_leaves_before or sim.grid.n_cells > 0
    v = sim.ionized_volume()
    assert v > 0


def test_multifreq_voronoi_dp_matches_single_device(geometry, mesh):
    rng = np.random.default_rng(3)
    grid = voronoi.build_voronoi_grid(
        geometry, rng.random((1200, 3)), num_lloyd=1)
    kwargs = dict(
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49,
        n_photons=16384, do_temperature=False, diffuse_field=True,
        n_reemission_rounds=2, seed=1,
    )
    x1, _ = voronoi.MultiFreqVoronoiSimulation(
        grid, _density, **kwargs).run(4)
    x8, _ = voronoi.MultiFreqVoronoiSimulation(
        grid, _density, mesh=mesh, **kwargs).run(4)
    vols = np.asarray(grid.volumes)
    v1 = float(np.sum((1 - np.clip(np.asarray(x1["H_n"]), 0, 1)) * vols))
    v8 = float(np.sum((1 - np.clip(np.asarray(x8["H_n"]), 0, 1)) * vols))
    assert v8 == pytest.approx(v1, rel=0.05)


def test_multifreq_amr_dp_matches_single_device(geometry, mesh):
    scheme = amr.OpacityRefinement(2.0)
    grid = amr.build_amr_grid(geometry, scheme, _density, max_level=2)
    kwargs = dict(
        source_position=(0.0, 0.0, 0.0), luminosity=4.26e49,
        n_photons=16384, do_temperature=False, diffuse_field=True,
        n_reemission_rounds=2, seed=1,
    )
    x1, _ = amr.MultiFreqAMRSimulation(grid, _density, **kwargs).run(4)
    x8, _ = amr.MultiFreqAMRSimulation(
        grid, _density, mesh=mesh, **kwargs).run(4)
    vols = np.asarray(grid.volumes)
    v1 = float(np.sum((1 - np.clip(np.asarray(x1["H_n"]), 0, 1)) * vols))
    v8 = float(np.sum((1 - np.clip(np.asarray(x8["H_n"]), 0, 1)) * vols))
    assert v8 == pytest.approx(v1, rel=0.05)


def test_cli_voronoi_parallel_block(tmp_path, monkeypatch):
    """``Parallel:`` + a Voronoi grid selects replicated-grid photon DP
    end-to-end through the CLI (the reference reaches the same combination
    via mpirun + the classic driver)."""
    monkeypatch.chdir(tmp_path)
    param_file = tmp_path / "vor_par.param"
    param_file.write_text(
        "SimulationBox:\n"
        "  anchor: [0. m, 0. m, 0. m]\n"
        "  sides: [1.e17 m, 1.e17 m, 1.e17 m]\n"
        "DensityGrid:\n"
        "  type: Voronoi\n"
        "  number of cells: [8, 8, 8]\n"
        "  VoronoiGeneratorDistribution:\n"
        "    type: UniformRandom\n"
        "    number of positions: 600\n"
        "DensityFunction:\n"
        "  density: 100. cm^-3\n"
        "PhotonSourceDistribution:\n"
        "  position: [5.e16 m, 5.e16 m, 5.e16 m]\n"
        "  luminosity: 1.e48 s^-1\n"
        "IonizationSimulation:\n"
        "  number of photons: 4000\n"
        "  number of iterations: 2\n"
        "Parallel:\n"
        "  number of devices: 8\n"
    )
    from cmacionize_tpu import cli

    assert cli.main(["--params", str(param_file)]) == 0
    out = np.load(tmp_path / "snapshot_cells.npz")
    xh = out["neutral_fraction"]
    assert xh.ndim == 1 and (xh > 0).all() and (xh <= 1).all()


def test_cli_voronoi_rhd(tmp_path, monkeypatch):
    """``--rhd`` + ``DensityGrid:type: Voronoi`` runs the Voronoi RHD
    driver (starbench_voronoi mode) end-to-end, writing the numbered
    Gadget snapshot series with per-cell coordinates; ``Parallel:`` shards
    the radiation phase via photon DP."""
    monkeypatch.chdir(tmp_path)
    param_file = tmp_path / "sbv.param"
    param_file.write_text(
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
        "    number of positions: 600\n"
        "DensityGridWriter:\n"
        "  prefix: sbv_\n"
        "HydroIntegrator:\n"
        "  polytropic index: 1.0001\n"
        "PhotonSourceDistribution:\n"
        "  luminosity: 1.e+49 Hz\n"
        "  position: [0. pc, 0. pc, 0. pc]\n"
        "RadiationHydrodynamicsSimulation:\n"
        "  number of iterations: 3\n"
        "  number of photons: 8000\n"
        "  total time: 0.00282 Myr\n"
        "  minimum timestep: 0.000705 Myr\n"
        "  maximum timestep: 0.000705 Myr\n"
        "SimulationBox:\n"
        "  anchor: [-1.256 pc, -1.256 pc, -1.256 pc]\n"
        "  sides: [2.512 pc, 2.512 pc, 2.512 pc]\n"
        "Parallel:\n"
        "  number of devices: 8\n"
    )
    from cmacionize_tpu import cli
    from cmacionize_tpu.io.gadget import read_gadget_snapshot

    assert cli.main(["--rhd", "--params", str(param_file)]) == 0
    _box, coords, fields = read_gadget_snapshot(
        str(tmp_path / "sbv_004.hdf5"))
    assert len(coords) == 600
    xh = fields["NeutralFractionH"]
    assert (xh < 0.5).any() and (xh > 0.5).any()  # front inside the box
    assert fields["Density"].min() > 0


def test_cli_amr_parallel_block(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    param_file = tmp_path / "amr_par.param"
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
        "  number of photons: 4000\n"
        "  number of iterations: 2\n"
        "Parallel:\n"
        "  number of devices: 8\n"
    )
    from cmacionize_tpu import cli

    assert cli.main(["--params", str(param_file)]) == 0
    out = np.load(tmp_path / "snapshot_cells.npz")
    xh = out["neutral_fraction"]
    assert xh.ndim == 1 and (xh > 0).all() and (xh <= 1).all()
