"""Tests for auxiliary subsystems: timeline, signals, statistics, potentials."""

import numpy as np
import pytest

from cmacionize_tpu.utils.timeline import TimeLine
from cmacionize_tpu.utils import signals


def test_timeline_hits_end_exactly():
    tl = TimeLine(0.0, 1.0, 1e-4, 0.1)
    total = 0.0
    steps = 0
    while True:
        total += tl.current_timestep
        steps += 1
        if not tl.advance():
            break
        assert steps < 100000
    assert total == pytest.approx(1.0, rel=1e-9)


def test_timeline_power_of_two_adjustment():
    tl = TimeLine(0.0, 1.0, 1e-6, 0.25)
    dt0 = tl.current_timestep
    dt1 = tl.set_timestep(dt0 / 3.0)  # must halve (twice)
    assert dt1 == pytest.approx(dt0 / 4.0)
    # can only double back at aligned times
    dt2 = tl.set_timestep(dt0)
    assert dt2 == pytest.approx(dt0)


def test_signals_flag():
    import os
    import signal as _signal

    signals.reset()
    signals.install()
    assert not signals.stop_requested()
    os.kill(os.getpid(), _signal.SIGINT)
    assert signals.stop_requested()
    signals.reset()


def test_point_mass_and_disc_patch():
    from cmacionize_tpu.ops.potentials import (
        CoredDMPotential,
        DiscPatchPotential,
        PointMassPotential,
    )

    pos = np.asarray([[1e12, 0.0, 0.0], [0.0, 0.0, 2e12]])
    g = PointMassPotential(mass=2e30).acceleration(pos)
    # magnitude GM/r^2, pointing inward
    assert g[0, 0] == pytest.approx(-6.67408e-11 * 2e30 / 1e24, rel=1e-6)
    assert g[1, 2] == pytest.approx(-6.67408e-11 * 2e30 / 4e24, rel=1e-6)

    g = DiscPatchPotential(surface_density=1.0, scale_height=1e10).acceleration(pos)
    assert g[1, 2] < 0 and g[0, 2] == pytest.approx(0.0)

    g = CoredDMPotential(central_density=1e-20, core_radius=1e12).acceleration(pos)
    assert g[0, 0] < 0


def test_fft_self_gravity_point_mass_limit():
    import jax.numpy as jnp

    from cmacionize_tpu.ops.potentials import fft_self_gravity

    # a compact central mass in a periodic box: near-field acceleration
    # should approach GM/r^2 at radii well inside the box
    n = 64
    box = 1.0e16
    dx = box / n
    rho = np.zeros((n, n, n))
    rho[n // 2, n // 2, n // 2] = 1.0
    mass = 1.0 * dx**3
    gx, gy, gz = fft_self_gravity(jnp.asarray(rho), (dx, dx, dx))
    gx = np.asarray(gx)
    # along the x axis at r = 8 dx
    r = 8 * dx
    g_measured = -gx[n // 2 + 8, n // 2, n // 2]
    g_expected = 6.67408e-11 * mass / r**2
    assert g_measured == pytest.approx(g_expected, rel=0.05)


def test_statistics_logger(tmp_path):
    import jax.numpy as jnp

    from cmacionize_tpu.ops import hydro
    from cmacionize_tpu.utils.statistics import StatisticsLogger

    w = hydro.Primitives(
        rho=jnp.full((4, 4, 4), 2.0),
        vx=jnp.full((4, 4, 4), 1.0),
        vy=jnp.zeros((4, 4, 4)),
        vz=jnp.zeros((4, 4, 4)),
        p=jnp.full((4, 4, 4), 1.0),
    )
    u = hydro.conserved_from_primitives(w, 5.0 / 3.0)
    logger = StatisticsLogger(str(tmp_path / "stats.txt"))
    row = logger.log(0.5, u, cell_volume=2.0)
    assert row["mass"] == pytest.approx(2.0 * 64 * 2.0)
    assert row["mom_x"] == pytest.approx(2.0 * 64 * 2.0)
    assert (tmp_path / "stats.txt").read_text().count("\n") == 2


def test_turbulence_forcing_properties():
    import jax
    import jax.numpy as jnp

    from cmacionize_tpu.ops.turbulence import TurbulenceForcing, apply_forcing
    from cmacionize_tpu.ops import hydro

    L = 1.0
    forcing = TurbulenceForcing.build(
        box_sides=L, k_min=1.0, k_max=3.0, k_forcing=2.0,
        concentration_factor=0.2, power_forcing=1e-2, driving_timestep=0.1,
    )
    assert forcing.n_modes > 10
    # solenoidal basis: e1, e2 orthogonal to k and to each other
    khat = forcing.k_table / np.linalg.norm(forcing.k_table, axis=1, keepdims=True)
    np.testing.assert_allclose((khat * forcing.e1).sum(1), 0.0, atol=1e-12)
    np.testing.assert_allclose((khat * forcing.e2).sum(1), 0.0, atol=1e-12)
    np.testing.assert_allclose((forcing.e1 * forcing.e2).sum(1), 0.0, atol=1e-12)

    # force field: zero mean, finite, varies in space
    n = 16
    x = (np.arange(n) + 0.5) / n * L
    centers = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1)
    f = np.asarray(forcing.force_field(jax.random.PRNGKey(0), centers))
    assert f.shape == (n, n, n, 3)
    assert np.all(np.isfinite(f))
    assert abs(f.mean()) < 0.1 * np.abs(f).std()

    # kick conserves mass, changes kinetic energy consistently
    w = hydro.Primitives(
        rho=jnp.full((n, n, n), 1.0),
        vx=jnp.zeros((n, n, n)), vy=jnp.zeros((n, n, n)),
        vz=jnp.zeros((n, n, n)), p=jnp.full((n, n, n), 1.0),
    )
    u = hydro.conserved_from_primitives(w, 5.0 / 3.0)
    u2 = apply_forcing(u, jnp.asarray(f), 0.1)
    w2 = hydro.primitives_from_conserved(u2, 5.0 / 3.0)
    # pressure (internal energy) unchanged by a pure kick
    np.testing.assert_allclose(np.asarray(w2.p), 1.0, rtol=1e-6)
    assert float(jnp.abs(w2.vx).max()) > 0


def test_tracker_manager(tmp_path):
    import jax.numpy as jnp

    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.trackers import (
        TrackerManager,
        field_pdf,
        surface_density,
    )

    PC = 3.086e16
    geometry = GridGeometry((-PC,) * 3, (2 * PC,) * 3, (8, 8, 8))
    edges = np.linspace(3.288e15, 4 * 3.288e15, 5)
    yaml_file = tmp_path / "trackers.yml"
    yaml_file.write_text(
        "positions:\n  - ['0. pc', '0. pc', '0. pc']\n"
        "  - ['0.5 pc', '0. pc', '0. pc']\n"
    )
    manager = TrackerManager.from_yaml(geometry, str(yaml_file), edges)
    assert len(manager.cell_indices) == 2

    # synthetic spectral tally: bin b deposits value (b+1) in every cell
    n_cell = geometry.n_cells
    tally = np.repeat(np.arange(1, 5, dtype=np.float64), n_cell)
    manager.accumulate(jnp.asarray(tally))
    manager.accumulate(jnp.asarray(tally))
    spectra = manager.spectra()
    np.testing.assert_allclose(spectra[0], 2 * np.arange(1, 5))
    out = tmp_path / "spectra.txt"
    manager.write(str(out))
    assert out.read_text().count("\n") == 5

    # live outputs
    field = jnp.ones((8, 8, 8))
    sd = surface_density(field, axis=2, cell_size=2.0)
    np.testing.assert_allclose(np.asarray(sd), 16.0)
    edges2, counts = field_pdf(field, bins=8, log=False)
    assert counts.sum() == 512


def test_cell_tracker_geometry():
    """segment_aabb_overlap + cube_projected_area analytics."""
    import jax.numpy as jnp

    from cmacionize_tpu.models import trackers

    # unit direction along +x through the box [2,3]x[0,1]x[0,1]
    origin = jnp.asarray([[0.5, 0.5, 0.5]])
    direction = jnp.asarray([[1.0, 0.0, 0.0]])
    lo = jnp.asarray([[2.0, 0.0, 0.0]])
    hi = jnp.asarray([[3.0, 1.0, 1.0]])
    ov = trackers.segment_aabb_overlap(
        origin, direction, jnp.asarray([10.0]), lo, hi)
    np.testing.assert_allclose(np.asarray(ov), [[1.0]], atol=1e-6)
    # segment terminates before the box -> no crossing
    ov = trackers.segment_aabb_overlap(
        origin, direction, jnp.asarray([1.0]), lo, hi)
    np.testing.assert_allclose(np.asarray(ov), [[0.0]], atol=1e-6)
    # segment terminates inside the box -> partial overlap
    ov = trackers.segment_aabb_overlap(
        origin, direction, jnp.asarray([2.0]), lo, hi)
    np.testing.assert_allclose(np.asarray(ov), [[0.5]], atol=1e-6)
    # missing the box on y
    origin2 = jnp.asarray([[0.5, 5.0, 0.5]])
    ov = trackers.segment_aabb_overlap(
        origin2, direction, jnp.asarray([10.0]), lo, hi)
    np.testing.assert_allclose(np.asarray(ov), [[0.0]], atol=1e-6)

    # projected unit-cube areas: axis view 1, body diagonal sqrt(3)
    assert float(trackers.cube_projected_area(1.0, 0.0, 0.0)) == 1.0
    d = 1.0 / np.sqrt(3.0)
    assert float(trackers.cube_projected_area(d, d, d)) == pytest.approx(
        np.sqrt(3.0))


def test_cell_trackers_reference_yaml_multifreq(tmp_path):
    """Typed trackers placed from a reference-format tracker file, driven
    through a small multifreq run with diffuse re-emission: all three
    PHOTONTYPE slots populate, absorption volumes are consistent with the
    recorded path lengths."""
    from cmacionize_tpu.models import ions
    from cmacionize_tpu.models.multifreq_simulation import (
        MultiFreqConfig,
        MultiFreqIonizationSimulation,
    )
    from cmacionize_tpu.models.trackers import CellTrackers
    from cmacionize_tpu.models.grid import GridGeometry

    PC = 3.086e16
    geometry = GridGeometry((-5 * PC,) * 3, (10 * PC,) * 3, (8, 8, 8))
    tracker_file = tmp_path / "trackers.yml"
    # the reference TrackerManager format (TrackerManager.hpp:110-140)
    tracker_file.write_text(
        "number of trackers: 3\n"
        "tracker[0]:\n"
        "  position: [1.9 pc, 0. pc, 0. pc]\n"
        "  type: Spectrum\n"
        "tracker[1]:\n"
        "  position: [1.9 pc, 0. pc, 0. pc]\n"
        "  type: WeightedSpectrum\n"
        "  output name: weighted.txt\n"
        "tracker[2]:\n"
        "  position: [0. pc, 1.9 pc, 0. pc]\n"
        "  type: Absorption\n"
    )
    config = MultiFreqConfig(
        geometry=geometry,
        number_density=1e8,
        initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        spectrum_type="planck",
        spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15,
        n_photons=4096,
        n_iterations=2,
        abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                    "Ne": 5e-5, "S": 9e-6},
        do_temperature=False,
        diffuse_field=True,
        n_bins=8,
        n_reemission_rounds=2,
    )
    sim = MultiFreqIonizationSimulation(config, seed=4)
    trackers = CellTrackers.from_reference_yaml(
        geometry, str(tracker_file), sim.bin_edges)
    assert trackers.n_track == 3
    sim.attach_cell_trackers(trackers)
    sim.run(2)

    # the tracked cells sit inside the ionized region: primary crossings
    # recorded in every tracker
    assert trackers.counts[:, 0, :].sum() > 0
    # diffuse re-emission populates the H and/or He slots
    assert trackers.counts[:, 1:, :].sum() > 0
    # weighted spectrum: same crossings, projected-area weights within
    # [1, sqrt(3)] of the raw counts per bin
    w = trackers.weighted[1].sum()
    c = trackers.counts[1].sum()
    assert c / np.sqrt(3.0) <= w <= c * 1.0001
    # absorption volumes positive where lengths were recorded
    absorption = trackers.absorption(sim.sigma_table)
    assert absorption.shape == (3, 3, len(ions.ION_NAMES))
    assert absorption[2, 0, ions.ION_H_n] > 0
    # output files in the reference layouts
    written = trackers.write_outputs(
        str(tmp_path), sigma_table=sim.sigma_table,
        ion_names=ions.ION_NAMES)
    assert len(written) == 3
    assert (tmp_path / "weighted.txt").exists()
    text = (tmp_path / "Tracker2.txt").read_text()
    assert text.startswith("# Ion")
    assert "H_n" in text or "ion0" in text

    # restart round trip: tracker accumulators are stateful across
    # iterations like every reference object with a restart hook
    from cmacionize_tpu.io.restart import RestartManager

    manager = RestartManager(str(tmp_path), interval_seconds=1e9)
    checkpoint = sim.write_restart(manager)
    sim2 = MultiFreqIonizationSimulation(config, seed=4)
    trackers2 = CellTrackers.from_reference_yaml(
        geometry, str(tracker_file), sim2.bin_edges)
    sim2.attach_cell_trackers(trackers2)
    sim2.load_restart(checkpoint)
    np.testing.assert_array_equal(trackers2.counts, trackers.counts)
    np.testing.assert_array_equal(trackers2.lengths, trackers.lengths)


def test_live_output_manager_rhd_cadence(tmp_path):
    """LiveOutputManager writes numbered surface-density/PDF files on its
    time cadence inside the RHD production loop."""
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.rhd_simulation import RHDConfig, RHDSimulation
    from cmacionize_tpu.models.trackers import LiveOutputManager

    PC = 3.086e16
    total = 1.0e12
    config = RHDConfig(
        geometry=GridGeometry((-PC,) * 3, (2 * PC,) * 3, (8, 8, 8)),
        gamma=5.0 / 3.0,
        timestep=total / 8.0,
        total_time=total,
        luminosity=0.0,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=128,
        nloop=0,
        background_density=1e8,
        background_temperature=100.0,
        minimum_timestep=total / 8.0,
        maximum_timestep=total / 8.0,
    )
    sim = RHDSimulation(config, seed=2)
    live = LiveOutputManager(
        config.geometry, output_interval=total / 4.0, folder=str(tmp_path),
        surface_density=True, ionized_surface_density=True,
        density_pdf=True, minimum_density=1e-22, maximum_density=1e-16,
        velocity_pdf=True, maximum_velocity=1e4,
    )
    sim.run(log_every=10**9, live_output=live)
    surface = sorted(tmp_path.glob("surface_density_*.txt"))
    assert len(surface) >= 4
    sd = np.loadtxt(surface[0])
    assert sd.shape == (8, 8)
    # uniform 100 cm^-3 box: column density = n mp L
    expected = 1e8 * 1.672621898e-27 * 2 * PC
    np.testing.assert_allclose(sd, expected, rtol=1e-5)
    assert sorted(tmp_path.glob("density_PDF_*.txt"))
    assert sorted(tmp_path.glob("velocity_PDF_*.txt"))
    pdf = np.loadtxt(sorted(tmp_path.glob("density_PDF_*.txt"))[0])
    assert pdf[:, 1].sum() == 512  # every cell binned


def test_spectra_family():
    import jax

    from cmacionize_tpu.models import sources

    # uniform: mean frequency = midpoint
    nu0 = 3.288e15
    spec = sources.uniform_spectrum()
    s = np.asarray(spec.sample(jax.random.PRNGKey(0), 50000))
    assert s.mean() == pytest.approx(2.5 * nu0, rel=0.01)

    # Faucher-Giguere UVB: softer than flat (mean below midpoint), in range
    fg = sources.faucher_giguere_spectrum(redshift=0.5)
    s = np.asarray(fg.sample(jax.random.PRNGKey(1), 50000))
    assert nu0 <= s.min() and s.max() <= 4 * nu0
    assert s.mean() < 2.0 * nu0
    with pytest.raises(ValueError):
        sources.faucher_giguere_spectrum(redshift=99.0)

    # masked planck: high-pass ramp removes the soft photons
    planck = sources.planck_spectrum(40000.0)
    ramp = sources.linear_mask(2.0 * nu0, 2.5 * nu0)
    masked = sources.masked_spectrum(planck, ramp)
    s_masked = np.asarray(masked.sample(jax.random.PRNGKey(2), 20000))
    s_plain = np.asarray(planck.sample(jax.random.PRNGKey(2), 20000))
    assert s_masked.mean() > s_plain.mean()
    assert s_masked.min() > 1.9 * nu0


def test_derijcke_cooling():
    from cmacionize_tpu.ops import derijcke, hydro
    import jax.numpy as jnp

    # Lambda rises steeply between 1e4 and 1e5 K (the HI/metal line peak)
    l4 = float(derijcke.cooling_rate(1e4))
    l5 = float(derijcke.cooling_rate(1e5))
    assert l4 > 0 and l5 > l4
    # out-of-range temperatures clamp
    assert float(derijcke.cooling_rate(1.0)) == pytest.approx(
        float(derijcke.cooling_rate(10.0))
    )
    # cooling substep lowers energy but never below the floor
    w = hydro.Primitives(
        rho=jnp.full((4, 4, 4), 1e8 * 1.672621898e-27),
        vx=jnp.zeros((4, 4, 4)), vy=jnp.zeros((4, 4, 4)),
        vz=jnp.zeros((4, 4, 4)),
        p=jnp.full((4, 4, 4), 1e8 * 1.38064852e-23 * 1e6),  # hot: 1e6 K
    )
    u = hydro.conserved_from_primitives(w, 5.0 / 3.0)
    u2 = derijcke.cooling_substep(u, dt=1e10, gamma=5.0 / 3.0)
    assert float(u2.energy.mean()) < float(u.energy.mean())
    assert float(u2.energy.min()) > 0


def test_block_syntax_density(tmp_path):
    from cmacionize_tpu.models.density_functions import (
        Block,
        block_syntax,
        blocks_from_yaml,
        homogeneous,
        spiral_galaxy,
    )
    from cmacionize_tpu.models.grid import GridGeometry

    PC = 3.086e16
    geometry = GridGeometry((-PC,) * 3, (2 * PC,) * 3, (16, 16, 16))

    yaml_file = tmp_path / "blocks.yml"
    yaml_file.write_text(
        "number of blocks: 2\n"
        "block[0]:\n"
        "  origin: ['0. pc', '0. pc', '0. pc']\n"
        "  sides: ['2. pc', '2. pc', '2. pc']\n"
        "  type: cube\n"
        "  number density: '100. cm^-3'\n"
        "  initial temperature: '100. K'\n"
        "block[1]:\n"
        "  origin: ['0. pc', '0. pc', '0. pc']\n"
        "  sides: ['0.5 pc', '0.5 pc', '0.5 pc']\n"
        "  type: sphere\n"
        "  number density: '1000. cm^-3'\n"
        "  initial temperature: '50. K'\n"
    )
    blocks = blocks_from_yaml(str(yaml_file))
    assert len(blocks) == 2 and blocks[1].kind == "sphere"
    fields = block_syntax(geometry, blocks)
    c = 8
    assert fields.number_density[c, c, c] == pytest.approx(1e9)  # sphere
    assert fields.number_density[2, 2, 2] == pytest.approx(1e8)  # cube
    assert fields.temperature[c, c, c] == pytest.approx(50.0)

    h = homogeneous(geometry, 1e8, 8000.0)
    assert h.number_density.mean() == pytest.approx(1e8)
    sg = spiral_galaxy(geometry, 1e9, PC, 0.2 * PC)
    assert sg.number_density[c, c, c] > sg.number_density[0, 0, c]


def test_discrete_source_set(tmp_path):
    import jax

    from cmacionize_tpu.models import sources
    from cmacionize_tpu.models.grid import GridGeometry

    PC = 3.086e16
    geometry = GridGeometry((-PC,) * 3, (2 * PC,) * 3, (16, 16, 16))
    ascii_file = tmp_path / "sources.txt"
    ascii_file.write_text(
        "# x y z L\n"
        f"{-0.5 * PC} 0 0 3e49\n"
        f"{0.5 * PC} 0 0 1e49\n"
    )
    src_set = sources.DiscreteSourceSet.from_ascii(str(ascii_file))
    assert src_set.total_luminosity == pytest.approx(4e49)

    n = 40000
    px, py, pz, dx, dy, dz, tau, _, w = sources.emit_source_set(
        jax.random.PRNGKey(0), n, src_set, geometry
    )
    px = np.asarray(px)
    # 3:1 luminosity split -> 3:1 packet split between x=4 and x=12 (grid)
    left = (px < 8).sum()
    assert left / n == pytest.approx(0.75, abs=0.01)

    rand_set = sources.DiscreteSourceSet.uniform_random(
        1, 10, (-PC,) * 3, (2 * PC,) * 3, 1e48
    )
    assert rand_set.positions.shape == (10, 3)
    assert np.all(np.abs(rand_set.positions) <= PC)


def test_isotropic_external_source():
    import jax
    import jax.numpy as jnp

    from cmacionize_tpu.models import sources
    from cmacionize_tpu.ops import traversal

    shape = (16, 16, 16)
    n = 8192
    px, py, pz, dx, dy, dz, tau, _, w = sources.emit_isotropic_external(
        jax.random.PRNGKey(0), n, shape
    )
    px, py, pz = np.asarray(px), np.asarray(py), np.asarray(pz)
    # every packet starts on (within a nudge of) a wall
    on_wall = (
        (px < 1e-3) | (px > 16 - 1e-3) | (py < 1e-3) | (py > 16 - 1e-3)
        | (pz < 1e-3) | (pz > 16 - 1e-3)
    )
    assert on_wall.all()
    # all directions point inward: tracing through a transparent box, every
    # packet travels a nonzero path and escapes
    packets = traversal.make_packets(
        jnp.stack([jnp.asarray(px), jnp.asarray(py), jnp.asarray(pz)], 1),
        jnp.stack([dx, dy, dz], 1),
        jnp.full((n,), 1e10, jnp.float32), w, shape,
    )
    tally = jnp.zeros(16**3, jnp.float32)
    tally, pk = traversal.trace_packets(
        jnp.full((16**3,), 1e-20, jnp.float32), packets, tally, shape=shape
    )
    assert not bool(jnp.any(pk.active))
    assert float(tally.sum()) / n > 1.0  # mean chord length > 1 cell


def test_honly_restart_bitwise(tmp_path):
    """Kill-and-resume reproduces the uninterrupted H-only run bit for bit
    (iteration counter + RNG key + fields in the checkpoint — cf.
    /root/reference/src/RestartManager.hpp:108-250)."""
    import jax.numpy as jnp

    from cmacionize_tpu.io.restart import RestartManager
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.ionization_simulation import (
        HOnlyConfig, HOnlyIonizationSimulation,
    )

    pc = 3.086e16
    config = HOnlyConfig(
        geometry=GridGeometry((-5 * pc,) * 3, (10 * pc,) * 3, (12, 12, 12)),
        number_density=1e8,
        temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        cross_section=6.3e-22,
        recombination_rate=4e-19,
        n_photons=2000,
        n_iterations=6,
    )
    sim_a = HOnlyIonizationSimulation(config, seed=7)
    sim_a.run(6)

    sim_b = HOnlyIonizationSimulation(config, seed=7)
    sim_b.run(3)
    manager = RestartManager(path=str(tmp_path), interval_seconds=1e9)
    ckpt = sim_b.write_restart(manager)

    sim_c = HOnlyIonizationSimulation(config, seed=99)  # wrong seed on purpose
    sim_c.load_restart(ckpt)
    assert sim_c.iteration == 3
    sim_c.run(6)

    assert jnp.array_equal(sim_c.neutral_fraction, sim_a.neutral_fraction)
    assert jnp.array_equal(sim_c.jH, sim_a.jH)


def test_multifreq_restart_bitwise(tmp_path):
    """Kill-and-resume for the multifreq driver (xion dict + T + RNG key)."""
    import jax.numpy as jnp

    from cmacionize_tpu.io.restart import RestartManager
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.multifreq_simulation import (
        MultiFreqConfig, MultiFreqIonizationSimulation,
    )

    pc = 3.086e16
    config = MultiFreqConfig(
        geometry=GridGeometry((-5 * pc,) * 3, (10 * pc,) * 3, (8, 8, 8)),
        number_density=1e8,
        initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        spectrum_type="planck",
        spectrum_temperature=4e4,
        spectrum_frequency=3.29e15,
        abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                    "Ne": 5e-5, "S": 9e-6},
        n_photons=1000,
        n_iterations=4,
        n_bins=8,
        do_temperature=True,
        minimum_iteration_number=1,
    )
    sim_a = MultiFreqIonizationSimulation(config, seed=3)
    sim_a.run(4)

    sim_b = MultiFreqIonizationSimulation(config, seed=3)
    sim_b.run(2)
    manager = RestartManager(path=str(tmp_path), interval_seconds=1e9)
    ckpt = sim_b.write_restart(manager)

    sim_c = MultiFreqIonizationSimulation(config, seed=42)
    sim_c.load_restart(ckpt)
    sim_c.run(4)

    for name in sim_a.xion:
        assert jnp.array_equal(sim_c.xion[name], sim_a.xion[name]), name
    assert jnp.array_equal(sim_c.temperature, sim_a.temperature)


def test_restart_manager_walltime_stop(tmp_path):
    """max_walltime triggers want_stop and the resubmit hook runs once."""
    import time as _time

    from cmacionize_tpu.io.restart import RestartManager

    marker = tmp_path / "resubmitted"
    manager = RestartManager(
        path=str(tmp_path), interval_seconds=1e9, max_walltime=0.05,
        resubmit_command=f"touch {marker}",
    )
    assert not manager.want_stop()
    _time.sleep(0.06)
    assert manager.want_stop()
    manager.on_stop()
    manager.on_stop()  # idempotent
    assert marker.exists()


class TestDiagnostics:
    """Per-iteration diagnostics dumps (diagnostics_XX.txt equivalent,
    cf. TaskBasedIonizationSimulation.cpp:969-1035)."""

    def test_counters_phases_and_dump(self, tmp_path):
        import time

        from cmacionize_tpu.utils.diagnostics import IterationDiagnostics

        diag = IterationDiagnostics(folder=str(tmp_path))
        diag.count("photons emitted", 1000)
        diag.count("photons emitted", 500)
        with diag.phase("trace"):
            time.sleep(0.01)
        diag.record_superstep(10, 20)
        rec = diag.end_iteration()
        assert rec["counters"]["photons emitted"] == 1500
        assert rec["counters"]["packets exchanged"] == 30
        assert rec["phase_s"]["trace"] >= 0.01
        text = (tmp_path / "diagnostics_00.txt").read_text()
        assert "photons emitted: 1500" in text
        assert "trace:" in text
        # next iteration starts clean
        diag.count("photons emitted", 1)
        rec2 = diag.end_iteration()
        assert rec2["counters"]["photons emitted"] == 1
        assert (tmp_path / "diagnostics_01.txt").exists()

    def test_driver_integration(self, tmp_path):
        import numpy as np

        from cmacionize_tpu.models.grid import GridGeometry
        from cmacionize_tpu.models.ionization_simulation import (
            HOnlyConfig,
            HOnlyIonizationSimulation,
        )
        from cmacionize_tpu.utils.diagnostics import IterationDiagnostics

        box = 1.0e17
        config = HOnlyConfig(
            geometry=GridGeometry((0, 0, 0), (box,) * 3, (8, 8, 8)),
            number_density=1e8, temperature=8000.0,
            source_position=(box / 2,) * 3, luminosity=1e48,
            cross_section=6.3e-22, recombination_rate=2.7e-19,
            n_photons=1000, n_iterations=2,
        )
        diag = IterationDiagnostics(folder=str(tmp_path))
        HOnlyIonizationSimulation(config, seed=1).run(diagnostics=diag)
        assert len(diag.history) == 2
        c = diag.history[0]["counters"]
        assert c["photons emitted"] == 1000
        assert (c["photons absorbed"] + c["photons escaped"]) == 1000
        assert (tmp_path / "diagnostics_01.txt").exists()


class TestParameterChecksum:
    def test_md5_matches_hashlib(self, tmp_path):
        import hashlib

        from cmacionize_tpu.utils.params import ParameterFile

        yml = tmp_path / "p.yml"
        yml.write_text("SimulationBox:\n  periodicity: [false, false, false]\n")
        params = ParameterFile(str(yml))
        expect = hashlib.md5(yml.read_bytes()).hexdigest()
        assert params.checksum == expect

    def test_no_file_no_checksum(self):
        from cmacionize_tpu.utils.params import ParameterFile

        assert ParameterFile(None).checksum is None
        assert ParameterFile({"a": 1}).checksum is None


def test_format_enforcement():
    """Source-format enforcement (reference format_script.sh equivalent;
    SURVEY §2.11)."""
    import os
    import subprocess
    import sys as _sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    result = subprocess.run(
        [_sys.executable, os.path.join(repo, "tools", "format_check.py")],
        capture_output=True, text=True)
    assert result.returncode == 0, result.stdout
