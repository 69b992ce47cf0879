"""Multi-element ionization/temperature machinery on the AMR and Voronoi
grid families — the reference runs its full pipeline on
every grid type through the DensityGrid abstraction
(/root/reference/src/AMRDensityGrid.hpp:44-808, VoronoiDensityGrid.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmacionize_tpu.models.grid import GridGeometry

PC = 3.086e16
ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
         "Ne": 5e-5, "S": 9e-6}


def _geometry():
    return GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (16, 16, 16))


def _density_fn(pos):
    return np.full(len(np.atleast_2d(pos)), 1e8)  # 100 cm^-3


def _check_structure(r, xH, xHe, label):
    """Shared structure assertions: ionized core, neutral exterior, He front
    inside (or at) the H front for a 40 kK blackbody."""
    inner = r < 2.0 * PC
    outer = r > 4.6 * PC
    assert np.median(xH[inner]) < 0.05, f"{label}: core not ionized"
    assert np.median(xH[outer]) > 0.5, f"{label}: exterior not neutral"
    # helium Stromgren volume <= hydrogen's (40 kK blackbody)
    vol_h = (xH < 0.5).sum()
    vol_he = (xHe < 0.5).sum()
    assert 0 < vol_he <= vol_h * 1.1, (
        f"{label}: He front ({vol_he}) outside H front ({vol_h})")


class TestMultiFreqAMR:
    def test_multi_element_structure(self):
        from cmacionize_tpu.models import amr

        geometry = _geometry()
        scheme = amr.SpatialRefinement(
            zone_anchor=(-1.5 * PC,) * 3, zone_sides=(3.0 * PC,) * 3,
            max_level=1)
        grid = amr.build_amr_grid(
            geometry, scheme, _density_fn, max_level=1)
        assert grid.n_cells > 16**3  # actually refined

        sim = amr.MultiFreqAMRSimulation(
            grid, _density_fn,
            source_position=(0.0, 0.0, 0.0),
            luminosity=4.26e49,
            n_photons=30000,
            abundances=ABUND,
            do_temperature=True,
            diffuse_field=False,
            n_bins=32,
            seed=8,
        )
        xion, T = sim.run(6)
        r = np.sqrt((grid.centers**2).sum(-1))
        xH = np.clip(np.asarray(xion["H_n"]), 0, 1)
        xHe = np.clip(np.asarray(xion["He_n"]), 0, 1)
        _check_structure(r, xH, xHe, "AMR")
        # temperature solve ran: photoionized interior is heated
        T = np.asarray(T)
        assert 4000.0 < np.median(T[r < 2.0 * PC]) < 25000.0
        # metals came through the coupled solve
        assert np.median(np.asarray(xion["O_n"])[r < 2.0 * PC]) < 0.5

    def test_diffuse_field_grows_ionized_volume(self):
        from cmacionize_tpu.models import amr

        geometry = _geometry()
        grid = amr.build_amr_grid(geometry, None, _density_fn, max_level=1)
        kwargs = dict(
            source_position=(0.0, 0.0, 0.0), luminosity=4.26e49,
            n_photons=20000, abundances=ABUND, do_temperature=False,
            n_bins=32, n_reemission_rounds=3, seed=9)
        sim_d = amr.MultiFreqAMRSimulation(
            grid, _density_fn, diffuse_field=True, **kwargs)
        xion_d, _ = sim_d.run(4)
        sim_n = amr.MultiFreqAMRSimulation(
            grid, _density_fn, diffuse_field=False, **kwargs)
        xion_n, _ = sim_n.run(4)
        v_d = float(((np.asarray(xion_d["H_n"]) < 0.5) * grid.volumes).sum())
        v_n = float(((np.asarray(xion_n["H_n"]) < 0.5) * grid.volumes).sum())
        assert v_d >= v_n


class TestMultiFreqVoronoi:
    def test_multi_element_structure(self):
        from cmacionize_tpu.models import voronoi

        geometry = _geometry()
        rng = np.random.default_rng(10)
        generators = rng.random((1200, 3))
        grid = voronoi.build_voronoi_grid(geometry, generators, num_lloyd=2)

        sim = voronoi.MultiFreqVoronoiSimulation(
            grid, _density_fn,
            source_position=(0.0, 0.0, 0.0),
            luminosity=4.26e49,
            n_photons=30000,
            abundances=ABUND,
            do_temperature=True,
            diffuse_field=False,
            n_bins=32,
            seed=11,
        )
        xion, T = sim.run(6)
        gen_si = (grid.generators * grid.scale
                  + np.asarray(geometry.anchor))
        r = np.sqrt((gen_si**2).sum(-1))
        xH = np.clip(np.asarray(xion["H_n"]), 0, 1)
        xHe = np.clip(np.asarray(xion["He_n"]), 0, 1)
        _check_structure(r, xH, xHe, "Voronoi")
        T = np.asarray(T)
        assert 4000.0 < np.median(T[r < 2.0 * PC]) < 25000.0

    def test_diffuse_field_runs_and_conserves_structure(self):
        from cmacionize_tpu.models import voronoi

        geometry = _geometry()
        rng = np.random.default_rng(12)
        grid = voronoi.build_voronoi_grid(
            geometry, rng.random((800, 3)), num_lloyd=1)
        sim = voronoi.MultiFreqVoronoiSimulation(
            grid, _density_fn,
            source_position=(0.0, 0.0, 0.0), luminosity=4.26e49,
            n_photons=20000, abundances=ABUND, do_temperature=False,
            diffuse_field=True, n_bins=32, n_reemission_rounds=3, seed=13)
        xion, _ = sim.run(4)
        xH = np.asarray(xion["H_n"])
        assert np.isfinite(xH).all()
        gen_si = (grid.generators * grid.scale + np.asarray(geometry.anchor))
        r = np.sqrt((gen_si**2).sum(-1))
        assert np.median(np.clip(xH, 0, 1)[r < 2.0 * PC]) < 0.05
