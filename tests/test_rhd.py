"""RHD integration test: reduced starbench D-type expansion on CPU.

Mirrors the reference's benchmark-as-acceptance-test strategy
(/root/reference/benchmarks/starbench.py): the ionization front radius after
a period of driven expansion must track the analytic Spitzer /
Hosokawa-Inutsuka solutions.
"""

import numpy as np

from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.models.rhd_simulation import (
    DensityBlock,
    RHDConfig,
    RHDSimulation,
    hosokawa_inutsuka_radius,
    spitzer_radius,
)

PC = 3.086e16


def test_starbench_early_expansion():
    n_cells = 24
    geometry = GridGeometry(
        anchor=(-1.256 * PC,) * 3,
        sides=(2.512 * PC,) * 3,
        shape=(n_cells,) * 3,
    )
    dt = 8.9e9  # s
    n_steps = 100
    config = RHDConfig(
        geometry=geometry,
        gamma=1.0001,
        timestep=dt,
        total_time=dt * n_steps,
        luminosity=1e49,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=4000,
        nloop=2,
        blocks=[],
        background_density=3.113e9,
        background_temperature=100.0,
    )
    sim = RHDSimulation(config, seed=5)
    state, xH = sim.advance(n_steps, log_every=10**9)

    r_st = (3 * 1e49 / (4 * np.pi * (3.113e9) ** 2 * 2.7e-19)) ** (1 / 3)
    r_front = sim.ionization_front_radius()
    r_sp = spitzer_radius(sim.time, r_st)
    r_hi = hosokawa_inutsuka_radius(sim.time, r_st)
    # coarse grid + few photons: generous envelope around the analytic laws
    assert 0.7 * r_sp < r_front < 1.35 * r_hi, (
        r_front / PC,
        r_sp / PC,
        r_hi / PC,
    )
    # the interior is ionized and hot, the exterior neutral and cold
    xH = np.asarray(xH)
    c = n_cells // 2
    assert xH[c, c, c] < 1e-3
    assert xH[0, 0, 0] > 0.99
    # mass conservation (reflective box)
    from cmacionize_tpu import constants
    from cmacionize_tpu.ops import hydro

    total_mass = float(np.asarray(state.rho).sum()) * sim.geometry.cell_volume
    expected = 3.113e9 * constants.PROTON_MASS * sim.geometry.cell_volume * n_cells**3
    assert abs(total_mass / expected - 1) < 1e-4
    # no negative pressures
    w = hydro.primitives_from_conserved(state, config.gamma)
    assert float(np.asarray(w.p).min()) > 0


def test_rhd_restart_round_trip(tmp_path):
    """Checkpoint mid-run, resume in a fresh driver, bitwise-identical state
    evolution (the reference's restart contract,
    /root/reference/src/RestartManager.hpp)."""
    import jax.numpy as jnp

    from cmacionize_tpu.io.restart import RestartManager

    config = RHDConfig(
        geometry=GridGeometry(
            anchor=(-1.256 * PC,) * 3, sides=(2.512 * PC,) * 3, shape=(12, 12, 12)
        ),
        gamma=1.0001,
        timestep=8.9e9,
        total_time=8.9e11,
        luminosity=1e49,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=2000,
        nloop=1,
        background_density=3.113e9,
    )
    sim = RHDSimulation(config, seed=9)
    sim.advance(5, log_every=10**9)
    manager = RestartManager(str(tmp_path), interval_seconds=1e9)
    checkpoint = sim.write_restart(manager)

    # continue the original
    sim.advance(3, log_every=10**9)

    # resume a fresh driver from the checkpoint and take the same 3 steps
    sim2 = RHDSimulation(config, seed=1234)
    sim2.load_restart(checkpoint)
    sim2.advance(3, log_every=10**9)

    assert sim2.time == sim.time
    # the restored key has the fresh key's type, so the resumed driver
    # reuses the same compiled step instead of compiling another
    assert sim2.key.dtype == sim.key.dtype and sim2.key.shape == sim.key.shape
    np.testing.assert_array_equal(
        np.asarray(sim.state.rho), np.asarray(sim2.state.rho)
    )
    np.testing.assert_array_equal(
        np.asarray(sim.neutral_fraction), np.asarray(sim2.neutral_fraction)
    )


def test_stellar_feedback_fires_on_gated_hydro_steps():
    """Round-4 advisor regression: with `radiation time` > 0 the hydro-only
    steps went through a path that skipped source updates entirely, so SN
    energy injection was delayed to the next radiation-due step.  The
    reference calls add_stellar_feedback EVERY step
    (RadiationHydrodynamicsSimulation.cpp:531) — a supernova exploding
    during the gated window must deposit its energy promptly."""
    import jax.numpy as jnp

    from cmacionize_tpu.models.source_distributions import (
        SingleSupernovaSourceDistribution,
    )

    n = 8
    geometry = GridGeometry(
        anchor=(-0.5 * PC,) * 3, sides=(PC,) * 3, shape=(n,) * 3)
    dt = 1.0e9
    n_steps = 12
    config = RHDConfig(
        geometry=geometry,
        gamma=5.0 / 3.0,
        timestep=dt,
        total_time=dt * n_steps,
        luminosity=0.0,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=64,
        nloop=0,
        background_density=1.0e8,
        background_temperature=100.0,
        minimum_timestep=dt,
        maximum_timestep=dt,
        # radiation due only once, at t=0: every later step is hydro-only
        radiation_time=1.0e30,
    )
    # scaled-down SN energy: keeps the fixed-dt test CFL-stable while
    # still dwarfing the thermal energy (~6e36 J) by 16x
    e_sn = 1.0e38
    dist = SingleSupernovaSourceDistribution(
        position=(0.0, 0.0, 0.0), lifetime=5.5 * dt, luminosity=0.0,
        energy=e_sn)
    sim = RHDSimulation(
        config, seed=3, source_distribution=dist, stellar_feedback=True)
    cell_volume = geometry.cell_volume
    e0 = float(jnp.sum(sim.state.energy)) * cell_volume
    sim.run(log_every=10**9)
    assert dist._has_exploded
    assert dist.pop_supernovae() == []  # consumed by the run, not pending
    e1 = float(jnp.sum(sim.state.energy)) * cell_volume
    # the SN energy landed (reflective box conserves the rest)
    assert abs((e1 - e0) - e_sn) < 0.1 * e_sn, (e0, e1)


def test_timeline_resume_snaps_float_rounding():
    """Re-entering a timeline at a time that float rounding moved off a
    step boundary (0.1 + 0.2 on a 0.15-step grid) lands on the boundary
    and finishes in whole steps, with no sliver step."""
    from cmacionize_tpu.utils.timeline import TimeLine

    timeline = TimeLine(0.0, 0.6, 0.15, 0.15)
    timeline.restore(0.1 + 0.2)
    assert timeline._current % timeline._min_ticks == 0
    steps = 0
    while not timeline.finished:
        timeline.set_timestep(0.15)
        timeline.advance()
        steps += 1
    assert steps == 2
