"""AMR grid family tests.

Covers construction (per-scheme refinement flags, volume conservation,
owner-map consistency), transport exactness against the uniform-grid
kernel, regrid resampling, the params factory, and the accuracy gain of
refinement over the unrefined coarse grid on a stromgren setup (the point
of AMR — cf. /root/reference/src/AMRDensityGrid.hpp:44-808).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cmacionize_tpu.models import amr
from cmacionize_tpu.models.grid import GridGeometry


BOX = 1.0e17  # m


def _geom(n=8, periodic=(False, False, False)):
    return GridGeometry((0.0, 0.0, 0.0), (BOX, BOX, BOX), (n, n, n), periodic)


def _uniform_density(value):
    return lambda pos: np.full(len(pos), value)


class TestConstruction:
    def test_no_refinement_is_coarse_grid(self):
        g = amr.build_amr_grid(_geom(4), None, _uniform_density(1.0e8),
                               max_level=2)
        assert g.n_cells == 4 ** 3
        assert (g.levels == 0).all()
        np.testing.assert_allclose(g.volumes.sum(), BOX ** 3, rtol=1e-12)

    def test_spatial_scheme_refines_zone_only(self):
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0),
            zone_sides=(BOX / 2, BOX / 2, BOX / 2),
            max_level=1,
        )
        g = amr.build_amr_grid(_geom(4), scheme, _uniform_density(1.0e8),
                               max_level=1)
        # 2x2x2 coarse octant refined into 8 children each
        assert g.n_cells == (4 ** 3 - 2 ** 3) + 2 ** 3 * 8
        in_zone = np.all(g.centers < BOX / 2, axis=1)
        assert (g.levels[in_zone] == 1).all()
        assert (g.levels[~in_zone] == 0).all()
        np.testing.assert_allclose(g.volumes.sum(), BOX ** 3, rtol=1e-12)

    def test_mass_scheme_recursive_two_levels(self):
        # density high enough that level-0 AND level-1 cells exceed the
        # target, level-2 cells do not -> everything ends at level 2
        geom = _geom(2)
        v0 = (BOX / 2) ** 3
        nd = 1.0  # particles/m^3
        scheme = amr.MassRefinement(target_npart=nd * v0 / 100.0, max_level=2)
        g = amr.build_amr_grid(geom, scheme, _uniform_density(nd), max_level=2)
        assert (g.levels == 2).all()
        assert g.n_cells == 2 ** 3 * 64
        np.testing.assert_allclose(g.volumes.sum(), BOX ** 3, rtol=1e-12)

    def test_owner_map_partitions_fine_lattice(self):
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0),
            zone_sides=(BOX / 4, BOX, BOX), max_level=2)
        g = amr.build_amr_grid(_geom(4), scheme, _uniform_density(1.0),
                               max_level=2)
        counts = np.bincount(g.owner.ravel(), minlength=g.n_cells)
        rf = 2 ** g.max_level
        expected = (rf // 2 ** g.levels.astype(int)) ** 3
        np.testing.assert_array_equal(counts, expected)

    def test_opacity_scheme_uses_neutral_fraction(self):
        scheme = amr.OpacityRefinement(target_opacity=1e-18, max_level=1)
        nd = 1.0e10  # chi = nd*1*6.3e-22 = 6.3e-12 >> target when neutral
        g = amr.build_amr_grid(
            _geom(2), scheme, _uniform_density(nd), max_level=1,
            fractions_fn=lambda pos: {"H_n": np.zeros(len(pos))},
        )
        assert (g.levels == 0).all()  # ionized -> transparent -> no refine
        g2 = amr.build_amr_grid(_geom(2), scheme, _uniform_density(nd),
                                max_level=1)
        assert (g2.levels == 1).all()

    def test_oi_scheme_flags_transition_zone(self):
        scheme = amr.OIRefinement(target_n_oi=1.0, max_level=1)
        nd = 1.0e8

        def fracs(pos):
            # front at x = BOX/2: O_n*O_p1 peaks there
            on = (pos[:, 0] > BOX / 2).astype(float) * 0.5 + 0.25
            return {"O_n": on, "O_p1": 1.0 - on}

        g = amr.build_amr_grid(_geom(4), scheme, _uniform_density(nd),
                               max_level=1, fractions_fn=fracs)
        assert (g.levels == 1).all()  # product large everywhere here

    def test_cmacionize_scheme_negative_density(self):
        def nd_fn(pos):
            return np.where(pos[:, 0] < BOX / 2, -1.0, 1.0e8)

        scheme = amr.CMacIonizeRefinement(max_level=1)
        g = amr.build_amr_grid(_geom(2), scheme, nd_fn, max_level=1)
        left = g.centers[:, 0] < BOX / 2
        assert (g.levels[left] == 1).all()
        assert (g.levels[~left] == 0).all()


class TestTransport:
    def test_unrefined_amr_matches_uniform_trace(self):
        """max_level=0 AMR transport == the plain uniform kernel."""
        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import traversal
        import jax

        geom = _geom(8)
        g = amr.build_amr_grid(geom, None, _uniform_density(1.0e8),
                               max_level=0)
        sigma = 6.3e-22
        chi_si = jnp.full(g.n_cells, 1.0e8 * sigma, jnp.float32)

        key = jax.random.PRNGKey(0)
        px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
            key, 512, (4.0, 4.0, 4.0))
        packets = traversal.make_packets(
            jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
            tau, w, g.fine_shape)
        leaf_tally, _ = amr.trace_amr(g, chi_si, packets)

        dx_m = float(geom.cell_size[0])
        chi_cell = chi_si * dx_m
        tally = jnp.zeros(g.n_cells, jnp.float32)
        tally, _ = traversal.trace_packets(
            chi_cell, packets, tally, shape=geom.shape,
            periodic=geom.periodic)
        np.testing.assert_allclose(
            np.asarray(leaf_tally), np.asarray(tally) * dx_m, rtol=2e-5)

    def test_refined_transport_conserves_path_length(self):
        """Σ leaf tallies == Σ per-packet path lengths (zero opacity)."""
        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import traversal
        import jax

        geom = _geom(4)
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0), zone_sides=(BOX, BOX, BOX / 2),
            max_level=2)
        g = amr.build_amr_grid(geom, scheme, _uniform_density(1.0),
                               max_level=2)
        chi_si = jnp.full(g.n_cells, 1e-30, jnp.float32)  # transparent

        key = jax.random.PRNGKey(1)
        rf = 2 ** g.max_level
        px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
            key, 256, (2.0 * rf, 2.0 * rf, 2.0 * rf))
        tau = jnp.full_like(tau, 1.0e30)  # never absorbed: full chord
        packets = traversal.make_packets(
            jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
            tau, w, g.fine_shape)
        leaf_tally, n_escaped = amr.trace_amr(g, chi_si, packets)
        assert int(n_escaped) == 256
        # every packet starts at the center -> chord from center to wall
        total = float(jnp.sum(leaf_tally))
        # analytic mean chord: average over isotropic directions of distance
        # from box center to wall; just check against numeric per-packet sum
        d = np.stack([np.asarray(v) for v in (dx, dy, dz)], 1)
        p0 = np.array([0.5, 0.5, 0.5]) * BOX
        t = np.full(len(d), np.inf)
        for ax in range(3):
            with np.errstate(divide="ignore"):
                t_hi = (BOX - p0[ax]) / d[:, ax]
                t_lo = (0.0 - p0[ax]) / d[:, ax]
            t_ax = np.where(d[:, ax] > 0, t_hi,
                            np.where(d[:, ax] < 0, t_lo, np.inf))
            t = np.minimum(t, t_ax)
        np.testing.assert_allclose(total, t.sum(), rtol=1e-4)


class TestRegrid:
    def test_resample_roundtrip_preserves_uniform_field(self):
        geom = _geom(4)
        s1 = amr.SpatialRefinement((0, 0, 0), (BOX / 2, BOX, BOX), 1)
        s2 = amr.SpatialRefinement((BOX / 2, 0, 0), (BOX / 2, BOX, BOX), 1)
        g1 = amr.build_amr_grid(geom, s1, _uniform_density(1.0), max_level=1)
        g2 = amr.build_amr_grid(geom, s2, _uniform_density(1.0), max_level=1)
        vals = jnp.full(g1.n_cells, 0.37, jnp.float32)
        out = amr.resample_leaf_values(g1, g2, vals)
        np.testing.assert_allclose(np.asarray(out), 0.37, rtol=1e-6)

    def test_resample_conserves_mass(self):
        geom = _geom(4)
        s1 = amr.SpatialRefinement((0, 0, 0), (BOX / 2, BOX, BOX), 2)
        g1 = amr.build_amr_grid(geom, s1, _uniform_density(1.0), max_level=2)
        g0 = amr.build_amr_grid(geom, None, _uniform_density(1.0), max_level=0)
        rng = np.random.default_rng(3)
        dens = jnp.asarray(rng.random(g1.n_cells), jnp.float32)
        # volume products in host float64 (SI volumes overflow f32)
        mass1 = float(np.sum(np.asarray(dens, np.float64) * g1.volumes))
        out = np.asarray(amr.resample_leaf_values(g1, g0, dens), np.float64)
        mass0 = float(np.sum(out * g0.volumes))
        np.testing.assert_allclose(mass0, mass1, rtol=1e-5)


class TestFactory:
    @pytest.mark.parametrize("stype,cls", [
        ("Mass", amr.MassRefinement),
        ("Opacity", amr.OpacityRefinement),
        ("Spatial", amr.SpatialRefinement),
        ("OI", amr.OIRefinement),
        ("CMacIonize", amr.CMacIonizeRefinement),
    ])
    def test_all_reference_type_strings(self, stype, cls, tmp_path):
        from cmacionize_tpu.utils.params import ParameterFile

        yml = tmp_path / "p.yml"
        yml.write_text(
            "DensityGrid:\n"
            "  AMRRefinementScheme:\n"
            f"    type: {stype}\n"
            "    zone anchor: [0. m, 0. m, 0. m]\n"
            "    zone sides: [1. m, 1. m, 1. m]\n"
        )
        params = ParameterFile(str(yml))
        scheme = amr.refinement_scheme_from_params(params)
        assert isinstance(scheme, cls)

    def test_none_returns_none(self, tmp_path):
        from cmacionize_tpu.utils.params import ParameterFile

        yml = tmp_path / "p.yml"
        yml.write_text("DensityGrid:\n  AMRRefinementScheme:\n    type: None\n")
        assert amr.refinement_scheme_from_params(
            ParameterFile(str(yml))) is None


class TestAccuracy:
    def test_refinement_beats_coarse_on_stromgren(self):
        """The point of AMR: an opacity-refined 8^3 grid resolves the
        Stromgren radius better than the unrefined 8^3 grid, measured
        against the analytic ionized volume."""
        nH = 1.0e8  # m^-3
        sigma = 6.3e-22
        alpha = 2.7e-19
        L = 1.0e48
        r_s = (3.0 * L / (4.0 * np.pi * alpha * nH * nH)) ** (1.0 / 3.0)
        box = 6.0 * r_s
        geom = GridGeometry((0.0, 0.0, 0.0), (box, box, box), (8, 8, 8))
        center = (box / 2, box / 2, box / 2)
        v_exact = 4.0 / 3.0 * np.pi * r_s ** 3

        def run(scheme, max_level):
            sim = amr.AMRIonizationSimulation(
                geom, scheme, _uniform_density(nH),
                source_position=center, luminosity=L,
                cross_section=sigma, recombination_rate=alpha,
                n_photons=1 << 15, max_level=max_level, seed=7,
            )
            sim.run(12)
            return sim.ionized_volume()

        v_coarse = run(None, 0)
        scheme = amr.OpacityRefinement(
            target_opacity=0.1 / float(geom.cell_size[0]), max_level=2)
        v_amr = run(scheme, 2)
        err_coarse = abs(v_coarse - v_exact) / v_exact
        err_amr = abs(v_amr - v_exact) / v_exact
        # measured: err_coarse ~= 0.50 (r_s spans ~1.3 coarse cells),
        # err_amr ~= 0.094 with level-2 refinement at the front
        assert err_amr < err_coarse / 2.0
        assert err_amr < 0.15


class TestOctree:
    """Depth-independent octree traversal."""

    def _refined_grid(self, n=8, max_level=2):
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0),
            zone_sides=(BOX / 2, BOX / 2, BOX / 2), max_level=max_level)
        return amr.build_amr_grid(
            _geom(n), scheme, _uniform_density(1.0e8), max_level=max_level)

    def test_octree_tables_consistent(self):
        g = self._refined_grid()
        root, children = g.octree()
        # every leaf id appears exactly once across root + children
        enc = np.concatenate([root, children[:, :].ravel()])
        leaves = -(enc[enc < 0]) - 1
        assert sorted(leaves.tolist()) == list(range(g.n_cells))
        # internal ids are a permutation of the children rows actually used
        internal = enc[enc >= 0]
        n_internal = sum(len(c) for c in g.refined_coords)
        assert sorted(internal.tolist()) == list(range(n_internal))

    def test_octree_matches_dense_path(self):
        """Per-leaf tallies from the octree march equal the dense-expand
        march (same estimator; the leaf path is split into fine segments
        there, marched whole here)."""
        import jax

        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import amr_traversal, traversal

        g = self._refined_grid()
        rng = np.random.default_rng(5)
        chi_si = jnp.asarray(
            10.0 ** rng.uniform(-17.5, -16.5, g.n_cells), jnp.float32)

        n = 20000
        key = jax.random.PRNGKey(9)
        gpos_fine = tuple(
            (np.full(3, 0.6 * BOX) - np.asarray(g.geometry.anchor))
            / g.fine_cell_size)
        px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
            key, n, gpos_fine)
        packets = traversal.make_packets(
            jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
            tau, w, g.fine_shape)

        dense_tally, dense_esc = amr.trace_amr(g, chi_si, packets)

        root, children = g.octree()
        dxc = float(g.geometry.cell_size[0])
        scale = 2.0 ** (-g.max_level)
        pk = packets._replace(
            px=packets.px * scale, py=packets.py * scale,
            pz=packets.pz * scale)
        tally = jnp.zeros((g.n_cells,), jnp.float32)
        tally, pk_out = amr_traversal.trace_packets_octree(
            jnp.asarray(root), jnp.asarray(children),
            chi_si * dxc, pk, tally,
            coarse_shape=tuple(g.geometry.shape), max_level=g.max_level)
        oct_tally = np.asarray(tally) * dxc

        np.testing.assert_allclose(
            oct_tally, np.asarray(dense_tally), rtol=2e-3,
            atol=1e-4 * float(np.asarray(dense_tally).max()))
        assert int(jnp.sum(~pk_out.absorbed)) == pytest.approx(
            int(dense_esc), abs=max(2, int(0.002 * n)))

    def test_deep_level5_without_dense_lattice(self):
        """A level-5 hierarchy on a 16^3 coarse grid (finest lattice would
        be 512^3 = 134M cells — above the dense budget): builds sparse,
        owner is None, and an H-only iteration runs through the octree."""
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0),
            zone_sides=(BOX / 16, BOX / 16, BOX / 16), max_level=5)
        geom = _geom(16)
        sim = amr.AMRIonizationSimulation(
            geom, scheme, _uniform_density(1.0e8),
            source_position=(0.05 * BOX,) * 3,
            luminosity=4.26e49,
            cross_section=6.3e-22,
            recombination_rate=4e-19,
            n_photons=20000,
            max_level=5,
            seed=3,
        )
        g = sim.grid
        assert g.max_level == 5
        assert g.owner is None  # no dense lattice was materialized
        assert int(g.levels.max()) == 5
        # leaves stay compact: ~37k vs the 134M dense fine count
        assert g.n_cells < 60000
        np.testing.assert_allclose(g.volumes.sum(), BOX ** 3, rtol=1e-9)
        xn = np.asarray(sim.run(2))
        # the source region ionizes
        assert xn.min() < 1e-2
        assert sim.ionized_volume() > 0


class TestOctreeSpectral:
    """Multi-frequency transport on deep AMR: the
    spectral octree march is wired into trace_amr_spectral for owner=None
    grids and matches the dense-expand path."""

    def _refined_grid(self, n=8, max_level=2):
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0),
            zone_sides=(BOX / 2, BOX / 2, BOX / 2), max_level=max_level)
        return amr.build_amr_grid(
            _geom(n), scheme, _uniform_density(1.0e8), max_level=max_level)

    def _spectral_packets(self, g, n=20000, seed=9):
        import jax

        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import traversal

        key = jax.random.PRNGKey(seed)
        kb, ke = jax.random.split(key)
        gpos_fine = tuple(
            (np.full(3, 0.6 * BOX) - np.asarray(g.geometry.anchor))
            / g.fine_cell_size)
        px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
            ke, n, gpos_fine)
        n_bins = 6
        fbin = jax.random.randint(kb, (n,), 0, n_bins)
        sig_h = 6.3e-22 * (1.0 + 0.2 * fbin.astype(jnp.float32))
        sig_he = 7.0e-22 * (1.0 - 0.1 * fbin.astype(jnp.float32))
        return traversal.make_spectral_packets(
            jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
            tau, w, sig_h, sig_he, fbin, g.fine_shape), n_bins

    def test_octree_spectral_matches_dense_path(self):
        import dataclasses as dc

        g = self._refined_grid()
        rng = np.random.default_rng(7)
        chi_h = jnp.asarray(
            10.0 ** rng.uniform(4.5, 5.5, g.n_cells), jnp.float32)
        chi_he = jnp.asarray(
            10.0 ** rng.uniform(3.5, 4.5, g.n_cells), jnp.float32)
        packets, n_bins = self._spectral_packets(g)

        dense_tally, dense_pk = amr.trace_amr_spectral(
            g, chi_h, chi_he, packets, n_bins=n_bins)
        g_deep = dc.replace(g, owner=None)  # force the octree API path
        oct_tally, oct_pk = amr.trace_amr_spectral(
            g_deep, chi_h, chi_he, packets, n_bins=n_bins)

        np.testing.assert_allclose(
            np.asarray(oct_tally), np.asarray(dense_tally), rtol=2e-3,
            atol=1e-4 * float(np.asarray(dense_tally).max()))
        assert int(jnp.sum(oct_pk.absorbed)) == pytest.approx(
            int(jnp.sum(dense_pk.absorbed)), abs=max(2, packets.size // 500))
        # exit positions agree at the API boundary (finest-lattice units)
        np.testing.assert_allclose(
            float(jnp.sum(jnp.where(oct_pk.absorbed, oct_pk.px, 0.0))),
            float(jnp.sum(jnp.where(dense_pk.absorbed, dense_pk.px, 0.0))),
            rtol=5e-3)

    def test_deep_multifreq_smoke(self):
        """Multi-element + diffuse reemission on a level-5 hierarchy whose
        dense finest lattice (512^3) is above the dense budget — the
        pipeline the round-4 PARITY claim advertised but could not run
        (grid.expand raised).  Reference: full physics at any depth,
        /root/reference/src/AMRDensityGrid.hpp:44-808."""
        scheme = amr.SpatialRefinement(
            zone_anchor=(0.0, 0.0, 0.0),
            zone_sides=(BOX / 16, BOX / 16, BOX / 16), max_level=5)
        geom = _geom(16)
        grid = amr.build_amr_grid(
            geom, scheme, _uniform_density(1.0e8), max_level=5)
        assert grid.owner is None  # genuinely deep
        sim = amr.MultiFreqAMRSimulation(
            grid, _uniform_density(1.0e8),
            source_position=(0.05 * BOX,) * 3,
            luminosity=4.26e49,
            n_photons=16384,
            abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                        "Ne": 5e-5, "S": 9e-6},
            do_temperature=False,
            diffuse_field=True,
            n_bins=16,
            n_reemission_rounds=2,
            seed=4,
        )
        xion, _ = sim.run(3)
        xH = np.asarray(xion["H_n"])
        assert np.all(np.isfinite(xH))
        assert xH.min() < 1e-2  # source region ionizes
        assert xH.max() > 0.9   # far region stays neutral
        xHe = np.asarray(xion["He_n"])
        assert np.all(np.isfinite(xHe)) and xHe.min() < 0.5

    def test_deep_level10_walls_do_not_stall(self):
        """Round-4 advisor regression: at max_level >= ~8 the old wall
        nudge fell below the f32 coordinate ulp, so wall packets stalled
        with l_exit = 0 until the (huge) step cap.  With the ulp-floored
        nudge, every packet must terminate in a modest step budget."""
        import jax

        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import amr_traversal
        from cmacionize_tpu.ops import traversal

        max_level = 10

        class FarCornerChain:
            """Refine only the single cell touching the FAR box corner at
            each level — a depth-10 chain with O(levels) leaves.  The far
            corner matters: the stall needs coordinates large enough that
            the old nudge fell under their f32 ulp (near the origin the
            ulp is tiny and even the broken nudge worked)."""

            def refine(self, level, centers, volume, nd, fractions):
                if level >= max_level:
                    return np.zeros(len(centers), bool)
                size = BOX / 16 / (2 ** level)
                return np.all(centers > BOX - size, axis=1)

        g = amr.build_amr_grid(
            _geom(16), FarCornerChain(), _uniform_density(1.0),
            max_level=max_level)
        assert int(g.levels.max()) == max_level
        root, children = g.octree()

        n = 2048
        px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
            jax.random.PRNGKey(1), n, (15.95, 15.95, 15.95))  # inside the
        # deep-refined FAR corner, coarse units (large coords, big ulp)
        pk = traversal.PacketBatch(
            px, py, pz,
            jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
            jnp.zeros(n, jnp.int32), dx, dy, dz, tau, w,
            jnp.ones(n, bool), jnp.zeros(n, bool))
        chi = jnp.full((g.n_cells,), 0.05, jnp.float32)  # per coarse unit
        tally = jnp.zeros((g.n_cells,), jnp.float32)
        # generous but FAR below the stall budget 4*48*1024 = 196k
        tally, pk_out = amr_traversal.trace_packets_octree(
            jnp.asarray(root), jnp.asarray(children), chi, pk, tally,
            coarse_shape=(16, 16, 16), max_level=max_level, max_steps=4000)
        assert int(jnp.sum(pk_out.active)) == 0  # nobody stalled
        assert int(jnp.sum(pk_out.absorbed)) + int(
            jnp.sum(~pk_out.absorbed)) == n


class TestAMRRestart:
    """Kill-and-resume for the AMR drivers: the
    hierarchy is recorded as refined-coordinate lists, rebuilt exactly, and
    the RNG chain continues — resumed runs are bit-for-bit identical."""

    def test_honly_resume_bit_for_bit(self, tmp_path):
        from cmacionize_tpu.io.restart import RestartManager

        def make():
            scheme = amr.OpacityRefinement(target_opacity=5e-14, max_level=2)
            return amr.AMRIonizationSimulation(
                _geom(8), scheme, _uniform_density(1.0e8),
                source_position=(0.5 * BOX,) * 3,
                luminosity=4.26e49, cross_section=6.3e-22,
                recombination_rate=4e-19, n_photons=8192,
                max_level=2, refinement_interval=2, seed=5)

        sim = make()
        manager = RestartManager(str(tmp_path), interval_seconds=1e9)
        sim.run(3)
        path = sim.write_restart(manager)
        ckpt_cells = sim.grid.n_cells
        ckpt_levels = sim.grid.levels.copy()
        xn_full = np.asarray(sim.run(3))  # regrids again at it=4

        sim2 = make()
        # different pre-resume state on purpose
        sim2.key = __import__("jax").random.PRNGKey(999)
        sim2.load_restart(path)
        assert sim2.iteration == 3
        assert sim2.grid.n_cells == ckpt_cells
        np.testing.assert_array_equal(sim2.grid.levels, ckpt_levels)
        xn_resumed = np.asarray(sim2.run(3))
        np.testing.assert_array_equal(xn_resumed, xn_full)

    def test_multifreq_resume_bit_for_bit(self, tmp_path):
        from cmacionize_tpu.io.restart import RestartManager

        def make():
            scheme = amr.SpatialRefinement(
                zone_anchor=(0.0, 0.0, 0.0),
                zone_sides=(BOX / 2,) * 3, max_level=1)
            grid = amr.build_amr_grid(
                _geom(8), scheme, _uniform_density(1.0e8), max_level=1)
            return amr.MultiFreqAMRSimulation(
                grid, _uniform_density(1.0e8),
                source_position=(0.5 * BOX,) * 3,
                luminosity=4.26e49, n_photons=8192,
                abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                            "Ne": 5e-5, "S": 9e-6},
                do_temperature=False, diffuse_field=False,
                n_bins=16, seed=6)

        sim = make()
        manager = RestartManager(str(tmp_path), interval_seconds=1e9)
        sim.run(2)
        path = sim.write_restart(manager)
        xion_full, _ = sim.run(2)

        sim2 = make()
        sim2.load_restart(path)
        assert sim2.iteration == 2
        xion_resumed, _ = sim2.run(2)
        np.testing.assert_array_equal(
            np.asarray(xion_resumed["H_n"]), np.asarray(xion_full["H_n"]))
        np.testing.assert_array_equal(
            np.asarray(xion_resumed["O_n"]), np.asarray(xion_full["O_n"]))
