"""Voronoi grid family tests.

Construction (volume partition, neighbor symmetry, Lloyd regularization),
generator distributions + factory, transport (chord conservation on a
transparent grid, agreement with the Cartesian kernel on a regular-lattice
tessellation), and a stromgren physics run — covering the role of
OldVoronoiGrid/NewVoronoiGrid/VoronoiDensityGrid
(/root/reference/src/VoronoiDensityGrid.cpp).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cmacionize_tpu.models import voronoi
from cmacionize_tpu.models.grid import GridGeometry


BOX = 1.0e17


def _geom(periodic=(False, False, False), sides=(BOX, BOX, BOX)):
    return GridGeometry((0.0, 0.0, 0.0), sides, (8, 8, 8), periodic)


class TestConstruction:
    def test_volumes_partition_box(self):
        rng = np.random.default_rng(0)
        gens = voronoi.uniform_random_generators(200, rng)
        g = voronoi.build_voronoi_grid(_geom(), gens)
        np.testing.assert_allclose(g.volumes.sum(), BOX ** 3, rtol=1e-10)

    def test_anisotropic_box(self):
        rng = np.random.default_rng(1)
        gens = voronoi.uniform_random_generators(100, rng)
        geom = _geom(sides=(BOX, BOX / 2, BOX / 4))
        g = voronoi.build_voronoi_grid(geom, gens)
        np.testing.assert_allclose(
            g.volumes.sum(), BOX ** 3 / 8.0, rtol=1e-10)

    def test_periodic_volumes_and_wrap_neighbors(self):
        rng = np.random.default_rng(2)
        gens = voronoi.uniform_random_generators(64, rng)
        g = voronoi.build_voronoi_grid(
            _geom(periodic=(True, True, True)), gens)
        np.testing.assert_allclose(g.volumes.sum(), BOX ** 3, rtol=1e-10)
        assert not (g.neighbors == -1).any()  # no walls in a periodic box
        assert (np.linalg.norm(g.shifts, axis=-1) > 0).any()

    def test_neighbor_symmetry(self):
        rng = np.random.default_rng(3)
        gens = voronoi.uniform_random_generators(100, rng)
        g = voronoi.build_voronoi_grid(_geom(), gens)
        pairs = set()
        for i in range(g.n_cells):
            for j in g.neighbors[i]:
                if j >= 0:
                    pairs.add((i, int(j)))
        for i, j in pairs:
            assert (j, i) in pairs

    def test_regular_lattice_recovers_cartesian_cells(self):
        gens = voronoi.uniform_regular_generators((4, 4, 4))
        g = voronoi.build_voronoi_grid(_geom(), gens)
        np.testing.assert_allclose(
            g.volumes, (BOX / 4) ** 3, rtol=1e-8)

    def test_lloyd_regularizes_volumes(self):
        rng = np.random.default_rng(4)
        gens = voronoi.uniform_random_generators(128, rng)
        g0 = voronoi.build_voronoi_grid(_geom(), gens, num_lloyd=0)
        g4 = voronoi.build_voronoi_grid(_geom(), gens, num_lloyd=4)
        assert np.std(g4.volumes) < 0.5 * np.std(g0.volumes)
        np.testing.assert_allclose(g4.volumes.sum(), BOX ** 3, rtol=1e-10)

    def test_locate_is_nearest_generator(self):
        rng = np.random.default_rng(5)
        gens = voronoi.uniform_random_generators(50, rng)
        g = voronoi.build_voronoi_grid(_geom(), gens)
        query = rng.random((20, 3))
        cells = g.locate(query)
        d = np.linalg.norm(query[:, None] - g.generators[None], axis=-1)
        np.testing.assert_array_equal(cells, d.argmin(axis=1))


class TestGenerators:
    def test_factory_type_strings(self, tmp_path):
        from cmacionize_tpu.utils.params import ParameterFile

        rng = np.random.default_rng(0)
        for gtype, extra, expected_n in [
            ("UniformRandom", "number of positions: 123", 123),
            ("UniformRegular", "number of cells: [3, 3, 3]", 27),
            ("PerturbedCartesian", "number of cells: [3, 3, 3]", 27),
        ]:
            yml = tmp_path / f"{gtype}.yml"
            yml.write_text(
                "DensityGrid:\n  VoronoiGeneratorDistribution:\n"
                f"    type: {gtype}\n    {extra}\n")
            gens = voronoi.generators_from_params(
                ParameterFile(str(yml)), rng)
            assert gens.shape == (expected_n, 3)
            assert ((gens >= 0) & (gens <= 1)).all()

    def test_perturbed_cartesian_stays_near_lattice(self):
        rng = np.random.default_rng(1)
        gens = voronoi.perturbed_cartesian_generators((4, 4, 4), 0.1, rng)
        ref = voronoi.uniform_regular_generators((4, 4, 4))
        assert np.abs(gens - ref).max() <= 0.1 / 4 + 1e-12


class TestTransport:
    def test_transparent_grid_conserves_chords(self):
        """Σ per-cell tallies == analytic chord length to the wall."""
        rng = np.random.default_rng(6)
        gens = voronoi.uniform_random_generators(150, rng)
        g = voronoi.build_voronoi_grid(_geom(), gens)
        chi = jnp.full(g.n_cells, 1e-30, jnp.float32)

        P = 128
        d = rng.normal(size=(P, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p0 = np.full((P, 3), 0.5)
        packets = voronoi.make_voronoi_packets(
            g, p0, d, np.full(P, 1e30), np.ones(P))
        tally, pk = voronoi.trace_packets_voronoi(g, chi, packets)
        assert not np.asarray(pk.active).any()
        assert not np.asarray(pk.absorbed).any()

        t = np.full(P, np.inf)
        for ax in range(3):
            with np.errstate(divide="ignore"):
                t_ax = np.where(
                    d[:, ax] > 0, (1.0 - p0[:, ax]) / d[:, ax],
                    np.where(d[:, ax] < 0, -p0[:, ax] / d[:, ax], np.inf))
            t = np.minimum(t, t_ax)
        np.testing.assert_allclose(
            float(jnp.sum(tally)), t.sum() * BOX, rtol=5e-4)

    def test_matches_cartesian_kernel_on_lattice(self):
        """Regular-lattice Voronoi == Cartesian grid: same tallies."""
        from cmacionize_tpu.ops import traversal

        nside = 4
        gens = voronoi.uniform_regular_generators((nside,) * 3)
        g = voronoi.build_voronoi_grid(_geom(), gens)
        rng = np.random.default_rng(7)
        P = 64
        d = rng.normal(size=(P, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p0 = np.full((P, 3), 0.5) + (rng.random((P, 3)) - 0.5) * 0.1
        tau = rng.random(P).astype(np.float32) * 3.0

        chi_si = np.full(g.n_cells, 2.0 * nside / BOX, np.float32)
        packets = voronoi.make_voronoi_packets(g, p0, d, tau, np.ones(P))
        tally_v, pk_v = voronoi.trace_packets_voronoi(g, chi_si, packets)

        # Cartesian: positions in cell units of the n^3 lattice
        shape = (nside,) * 3
        pc = traversal.make_packets(
            jnp.asarray(p0 * nside, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(tau), jnp.ones(P, jnp.float32), shape)
        dx = BOX / nside
        chi_cell = jnp.asarray(chi_si * dx)
        tally_c = jnp.zeros(nside ** 3, jnp.float32)
        tally_c, pk_c = traversal.trace_packets(
            chi_cell, pc, tally_c, shape=shape,
            periodic=(False, False, False))

        # Voronoi cells are ordered as the C-order lattice here
        np.testing.assert_allclose(
            np.asarray(tally_v), np.asarray(tally_c) * dx,
            rtol=2e-3, atol=1e-4 * BOX / nside)
        np.testing.assert_array_equal(
            np.asarray(pk_v.absorbed), np.asarray(pk_c.absorbed))

    def test_periodic_wrap_traversal(self):
        """A packet in a periodic box keeps travelling past the wall."""
        gens = voronoi.uniform_regular_generators((4, 4, 4))
        g = voronoi.build_voronoi_grid(
            _geom(periodic=(True, True, True)), gens)
        chi = jnp.full(g.n_cells, 1e-30, jnp.float32)
        d = np.array([[1.0, 0.0, 0.0]])
        packets = voronoi.make_voronoi_packets(
            g, np.array([[0.51, 0.51, 0.51]]), d,
            np.array([1e30]), np.ones(1))
        tally, pk = voronoi.trace_packets_voronoi(
            g, chi, packets, max_steps=37)
        # still active after 37 wrap crossings, path length ~= 37 quarter-boxes
        assert bool(np.asarray(pk.active)[0])
        np.testing.assert_allclose(
            float(jnp.sum(tally)), 37 * 0.25 * BOX, rtol=1e-2)


class TestPhysics:
    def test_stromgren_on_voronoi(self):
        nH = 1.0e8
        sigma = 6.3e-22
        alpha = 2.7e-19
        L = 1.0e48
        r_s = (3.0 * L / (4.0 * np.pi * alpha * nH * nH)) ** (1.0 / 3.0)
        box = 6.0 * r_s
        geom = GridGeometry((0.0, 0.0, 0.0), (box, box, box), (8, 8, 8))
        rng = np.random.default_rng(8)
        gens = voronoi.uniform_random_generators(6000, rng)
        grid = voronoi.build_voronoi_grid(geom, gens, num_lloyd=2)
        sim = voronoi.HOnlyVoronoiSimulation(
            grid, lambda p: np.full(len(p), nH),
            source_position=(box / 2, box / 2, box / 2),
            luminosity=L, cross_section=sigma, recombination_rate=alpha,
            n_photons=1 << 15, seed=9)
        sim.run(12)
        v_exact = 4.0 / 3.0 * np.pi * r_s ** 3
        err = abs(sim.ionized_volume() - v_exact) / v_exact
        # measured: +0.32 at 2000 cells, +0.20 at 6000 — the same
        # resolution-limited overshoot the 8^3 Cartesian grid shows (+0.50);
        # transport exactness is pinned by the lattice-match test above
        assert err < 0.3


class TestVoronoiRestart:
    """Kill-and-resume for the Voronoi drivers:
    generator positions are the complete grid record; Qhull re-tessellates
    them deterministically, and the RNG chain continues bit-for-bit."""

    def _grid(self, seed=3, n=400):
        rng = np.random.default_rng(seed)
        geometry = GridGeometry(
            (0.0, 0.0, 0.0), (1.0e17, 1.0e17, 1.0e17), (8, 8, 8))
        return voronoi.build_voronoi_grid(geometry, rng.random((n, 3)))

    def test_honly_resume_bit_for_bit(self, tmp_path):
        from cmacionize_tpu.io.restart import RestartManager

        dens = lambda pos: np.full(len(pos), 1.0e8)  # noqa: E731

        def make(grid):
            return voronoi.HOnlyVoronoiSimulation(
                grid, dens,
                source_position=(0.5e17, 0.5e17, 0.5e17),
                luminosity=4.26e49, cross_section=6.3e-22,
                recombination_rate=4e-19, n_photons=8192, seed=7)

        sim = make(self._grid())
        manager = RestartManager(str(tmp_path), interval_seconds=1e9)
        sim.run(3)
        path = sim.write_restart(manager)
        xn_full = np.asarray(sim.run(3))

        # a DIFFERENT tessellation pre-resume: load must restore the
        # checkpointed generators, not keep the constructor's
        sim2 = make(self._grid(seed=99, n=350))
        sim2.load_restart(path)
        assert sim2.iteration == 3
        assert sim2.grid.n_cells == sim.grid.n_cells
        np.testing.assert_array_equal(
            sim2.grid.generators, sim.grid.generators)
        np.testing.assert_array_equal(
            sim2.grid.neighbors, sim.grid.neighbors)
        xn_resumed = np.asarray(sim2.run(3))
        np.testing.assert_array_equal(xn_resumed, xn_full)

    def test_multifreq_resume_bit_for_bit(self, tmp_path):
        from cmacionize_tpu.io.restart import RestartManager

        dens = lambda pos: np.full(len(pos), 1.0e8)  # noqa: E731

        def make(grid):
            return voronoi.MultiFreqVoronoiSimulation(
                grid, dens,
                source_position=(0.5e17, 0.5e17, 0.5e17),
                luminosity=4.26e49, n_photons=8192,
                abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                            "Ne": 5e-5, "S": 9e-6},
                do_temperature=False, diffuse_field=False,
                n_bins=16, seed=11)

        sim = make(self._grid())
        manager = RestartManager(str(tmp_path), interval_seconds=1e9)
        sim.run(2)
        path = sim.write_restart(manager)
        xion_full, _ = sim.run(2)

        sim2 = make(self._grid(seed=42, n=300))
        sim2.load_restart(path)
        assert sim2.iteration == 2
        xion_resumed, _ = sim2.run(2)
        np.testing.assert_array_equal(
            np.asarray(xion_resumed["H_n"]), np.asarray(xion_full["H_n"]))

    def test_moving_mesh_rhd_resume_bit_for_bit(self, tmp_path):
        from cmacionize_tpu.io.restart import RestartManager
        from cmacionize_tpu.models import voronoi_hydro

        def make(grid):
            return voronoi_hydro.VoronoiRHDSimulation(
                grid, gamma=1.0001, timestep=2.4e10, luminosity=1e49,
                source_position=(0.5e17, 0.5e17, 0.5e17),
                cross_section=6.3e-22, recombination_rate=2.7e-19,
                n_photons=4096, nloop=1, number_density=3.113e9,
                temperature=100.0, mesh_motion=True, seed=13)

        sim = make(self._grid(n=300))
        manager = RestartManager(str(tmp_path), interval_seconds=1e9)
        sim.run(3)
        path = sim.write_restart(manager)
        sim.run(3)
        rho_full = np.asarray(sim.state.rho)

        sim2 = make(self._grid(seed=77, n=250))
        sim2.load_restart(path)
        assert sim2.time == pytest.approx(3 * 2.4e10)
        sim2.run(3)
        np.testing.assert_array_equal(
            np.asarray(sim2.state.rho), rho_full)
        np.testing.assert_array_equal(
            np.asarray(sim2.neutral_fraction),
            np.asarray(sim.neutral_fraction))


class TestVoronoiCascade:
    def test_cascade_matches_plain_trace(self):
        """trace_packets_voronoi_cascade is estimator-identical to the
        plain march: same deposits (fp-level accumulation order only),
        same absorbed count, on a mixed absorb/escape workload."""
        import jax

        PC = 3.086e16
        geometry = GridGeometry(
            anchor=(-PC,) * 3, sides=(2 * PC,) * 3, shape=(16,) * 3)
        rng = np.random.default_rng(5)
        g = voronoi.build_voronoi_grid(geometry, rng.random((900, 3)))
        # ionized bubble + neutral wall: packets cross many cells, then
        # terminate over a narrow range (the production survival curve)
        gen_si = g.generators * g.scale + np.asarray(geometry.anchor)
        r = np.sqrt((gen_si**2).sum(1))
        xh = np.where(r < 0.55 * PC, 1e-6, 1.0)
        chi = jnp.asarray(3e5 * xh * 6.3e-22, jnp.float32)

        P = 20000
        key = jax.random.PRNGKey(1)
        k1, k2 = jax.random.split(key)
        d = jax.random.normal(k1, (P, 3))
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        tau = -jnp.log(1 - jax.random.uniform(k2, (P,)))
        src_u = (np.zeros(3) - np.asarray(geometry.anchor)) / g.scale
        src_cell = int(g.locate(src_u)[0])
        pk = voronoi.VoronoiPacketBatch(
            jnp.tile(jnp.asarray(src_u, jnp.float32), (P, 1)),
            d.astype(jnp.float32),
            jnp.full(P, src_cell, jnp.int32), tau.astype(jnp.float32),
            jnp.ones(P, jnp.float32), jnp.ones(P, bool),
            jnp.zeros(P, bool))

        tally_p, pk_out = voronoi.trace_packets_voronoi(g, chi, pk)
        tally_c, n_abs, n_esc = voronoi.trace_packets_voronoi_cascade(
            g, chi, pk, shrink=2, n_stages=3)
        np.testing.assert_allclose(
            np.asarray(tally_c), np.asarray(tally_p), rtol=1e-4,
            atol=1e-6 * float(np.asarray(tally_p).max()))
        assert int(n_abs) == int(np.asarray(pk_out.absorbed).sum())
        assert int(n_abs) + int(n_esc) == P
        assert int(n_esc) > 0  # workload genuinely mixes both outcomes
