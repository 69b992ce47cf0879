"""Parameter-file-driven RHD physics wiring: external
potentials, self-gravity, cooling, turbulence, masks, Bondi boundaries and
time-dependent sources all selected from the parameter file, mirroring
/root/reference/src/RadiationHydrodynamicsSimulation.cpp:250-392."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cmacionize_tpu.models.rhd_simulation import RHDSimulation
from cmacionize_tpu.utils.params import ParameterFile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AU = 1.496e11


def test_bondi_from_params_holds_profile():
    """CLI-equivalent bondi run (small grid): the analytic profile must be
    held by mask + point-mass gravity + Bondi inflow boundaries."""
    params = ParameterFile(os.path.join(REPO, "benchmarks", "bondi.param"))
    params._tree["DensityGrid"]["number of cells"] = [24, 24, 24]
    params._tree["RadiationHydrodynamicsSimulation"]["total time"] = "5. yr"
    prev = os.getcwd()
    os.chdir(os.path.join(REPO, "benchmarks"))
    try:
        sim = RHDSimulation.from_params(params)
    finally:
        os.chdir(prev)
    assert sim.isothermal_sound_speed == pytest.approx(2031.0)
    assert sim.gravity is not None
    assert sim.mask is not None
    assert sim.inflow_states is not None and len(sim.inflow_states) == 6

    from cmacionize_tpu.models.bondi import BondiProfile
    from cmacionize_tpu.ops import hydro

    u, _ = sim.run(log_every=1000)
    profile = BondiProfile(
        central_mass=18.0 * 1.98855e30, bondi_density=1e-16,
        sound_speed=2031.0)
    centers = sim.geometry.cell_centers()
    rho0, _, _, _ = profile.evaluate(centers)
    r = np.sqrt((centers**2).sum(-1))
    w = hydro.primitives_from_conserved(u, sim.config.gamma)
    sel = (r > 15 * AU) & (r < 45 * AU)
    rel = np.abs(np.asarray(w.rho)[sel] / rho0[sel] - 1)
    assert np.median(rel) < 0.05
    # regression (round 4): per-block CFL once let the gravity kick run
    # 16 steps at the v=0 timestep and the state went NaN — gravity runs
    # must stay finite under the per-step CFL + acceleration bound
    assert np.isfinite(np.asarray(w.vx)).all()
    assert np.isfinite(np.asarray(w.p)).all()


def _base_params(extra):
    tree = {
        "SimulationBox": {
            "anchor": ["-2. pc", "-2. pc", "-2. pc"],
            "sides": ["4. pc", "4. pc", "4. pc"],
        },
        "DensityGrid": {"number of cells": [12, 12, 12]},
        "DensityFunction": {"density": "100. cm^-3",
                            "temperature": "100. K"},
        "RadiationHydrodynamicsSimulation": {
            "total time": "0.02 Myr",
            "minimum timestep": "0.01 Myr",
            "number of iterations": 0,
        },
        "HydroIntegrator": {"polytropic index": 1.666667},
    }
    for key, val in extra.items():
        tree.setdefault(key, {}).update(val)
    return ParameterFile(tree)


def test_self_gravity_collapses_overdensity():
    params = _base_params({
        "RadiationHydrodynamicsSimulation": {"use self gravity": True},
        "DensityFunction": {"density": "1.e5 cm^-3"},
    })
    sim = RHDSimulation.from_params(params)
    assert sim.self_gravity
    u0_mom = float(jnp.abs(sim.state.mom_x).max())
    sim.run(log_every=1000)
    # uniform density → zero net self-gravity force (Jeans swindle):
    # momenta stay finite and small
    assert np.isfinite(float(jnp.abs(sim.state.mom_x).max()))
    assert u0_mom == 0.0


def test_external_potential_accelerates_gas():
    params = _base_params({
        "RadiationHydrodynamicsSimulation": {"use potential": True},
        "ExternalPotential": {
            "type": "PointMass", "mass": "100. Msol",
            "position": ["0. m", "0. m", "0. m"],
        },
    })
    sim = RHDSimulation.from_params(params)
    assert sim.gravity is not None
    sim.run(log_every=1000)
    # gas falls toward the center: radial momentum negative
    centers = sim.geometry.cell_centers()
    r = np.maximum(np.sqrt((centers**2).sum(-1)), 1.0)
    mr = (
        np.asarray(sim.state.mom_x) * centers[..., 0]
        + np.asarray(sim.state.mom_y) * centers[..., 1]
        + np.asarray(sim.state.mom_z) * centers[..., 2]
    ) / r
    assert np.median(mr) < 0.0


def test_cooling_reduces_energy():
    params = _base_params({
        "RadiationHydrodynamicsSimulation": {"use cooling": True},
        "DensityFunction": {"density": "100. cm^-3",
                            "temperature": "1.e6 K"},
    })
    sim = RHDSimulation.from_params(params)
    assert sim.cooling
    e0 = float(jnp.sum(sim.state.energy))
    sim.run(log_every=1000)
    assert float(jnp.sum(sim.state.energy)) < e0


def test_turbulence_forcing_injects_kinetic_energy():
    params = _base_params({
        "RadiationHydrodynamicsSimulation": {"use turbulent forcing": True},
        "TurbulenceForcing": {"forcing power": "1.e-1 m^2 s^-3"},
        "HydroIntegrator": {
            "polytropic index": 1.666667,
            "boundary x low": "periodic", "boundary x high": "periodic",
            "boundary y low": "periodic", "boundary y high": "periodic",
            "boundary z low": "periodic", "boundary z high": "periodic",
        },
    })
    sim = RHDSimulation.from_params(params)
    assert sim.forcing is not None
    sim.run(log_every=1000)
    ke = float(jnp.sum(
        sim.state.mom_x**2 + sim.state.mom_y**2 + sim.state.mom_z**2))
    assert ke > 0.0


def test_single_supernova_feedback_injects_energy():
    params = _base_params({
        "RadiationHydrodynamicsSimulation": {
            "use stellar feedback": True,
            "number of iterations": 0,
            "total time": "0.016 Myr",
            "minimum timestep": "0.002 Myr",
        },
        "PhotonSourceDistribution": {
            "type": "SingleSupernova",
            "position": ["0. m", "0. m", "0. m"],
            "lifetime": "0.01 Myr",
            # luminosity 0: the star only explodes (pure feedback test)
            "luminosity": "0. s^-1",
            "energy": "1.e37 J",
        },
    })
    sim = RHDSimulation.from_params(params)
    assert sim.source_distribution is not None
    e0 = float(jnp.sum(sim.state.energy)) * sim.geometry.cell_volume
    sim.run(log_every=1000)
    e1 = float(jnp.sum(sim.state.energy)) * sim.geometry.cell_volume
    # the SN dumped 1e37 J into the box (~40x one cell's thermal energy;
    # kept modest so the blast stays within the fixed-dt CFL bound)
    assert e1 - e0 > 0.5e37


def test_radiation_time_gating():
    """`radiation time` > 0: the MC update runs only when due; hydro-only
    steps use the gated step variant (RadiationHydrodynamicsSimulation.cpp
    :540-571 hydro_lastrad logic)."""
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.rhd_simulation import RHDConfig, RHDSimulation

    PC = 3.086e16
    total = 1.0e12
    config = RHDConfig(
        geometry=GridGeometry((-PC,) * 3, (2 * PC,) * 3, (8, 8, 8)),
        gamma=1.0001,
        timestep=total / 8.0,
        total_time=total,
        luminosity=1e49,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=512,
        nloop=1,
        background_density=3.113e9,
        background_temperature=100.0,
        minimum_timestep=total / 8.0,
        maximum_timestep=total / 8.0,
        radiation_time=total / 2.0,  # only 2 radiation events in 8 steps
    )
    sim = RHDSimulation(config, seed=3)
    calls = {"rad": 0, "hydro_only": 0}
    orig_advance = sim.advance
    orig_hydro = sim._hydro_only_step

    def counting_advance(*a, **k):
        calls["rad"] += 1
        return orig_advance(*a, **k)

    def counting_hydro(dt):
        calls["hydro_only"] += 1
        return orig_hydro(dt)

    sim.advance = counting_advance
    sim._hydro_only_step = counting_hydro
    sim.run(log_every=10**9)
    assert sim.time == pytest.approx(total, rel=1e-9)
    # radiation due at t=0 and t=total/2; the other 6 steps are gated
    assert calls["rad"] == 2, calls
    assert calls["hydro_only"] == 6, calls
    # the bubble still ionized around the source
    assert float(jnp.min(sim.neutral_fraction)) < 0.5
