"""Driver/CLI-level domain decomposition tests: the
sharded mode must be reachable from parameter files and drivers, not just
the parallel library, and must match the single-device run to MC noise."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _honly_config(shape=(16, 16, 16), n_photons=16384, n_iterations=5):
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.ionization_simulation import HOnlyConfig

    pc = 3.086e16
    geometry = GridGeometry((-5 * pc,) * 3, (10 * pc,) * 3, shape)
    return HOnlyConfig(
        geometry=geometry,
        number_density=1e8,
        temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        cross_section=6.3e-22,
        recombination_rate=4e-19,
        n_photons=n_photons,
        n_iterations=n_iterations,
    )


class TestShardedHOnlyDriver:
    def test_matches_single_device_to_mc_noise(self):
        from cmacionize_tpu.models.ionization_simulation import (
            HOnlyIonizationSimulation,
            ShardedHOnlyIonizationSimulation,
        )

        config = _honly_config()
        sharded = ShardedHOnlyIonizationSimulation(
            config, tiling=(2, 2, 2), seed=3)
        xh_dd = np.asarray(sharded.run(5))
        assert sharded.last_diagnostics["buffer_overflow"] == 0
        assert sharded.last_diagnostics["truncated_live"] == 0
        traced = sharded.last_diagnostics["packets_traced"]
        assert traced.shape == (2, 2, 2)
        assert traced.sum() >= config.n_photons  # copy phase + local traces

        single = HOnlyIonizationSimulation(config, seed=3)
        xh_sd = np.asarray(single.run(5))
        v_dd = (xh_dd < 0.5).sum()
        v_sd = (xh_sd < 0.5).sum()
        assert v_dd == pytest.approx(v_sd, rel=0.15)

    def test_restart_roundtrip(self, tmp_path):
        from cmacionize_tpu.io.restart import RestartManager
        from cmacionize_tpu.models.ionization_simulation import (
            ShardedHOnlyIonizationSimulation,
        )

        config = _honly_config(n_photons=4096)
        sim = ShardedHOnlyIonizationSimulation(config, tiling=(8, 1, 1), seed=4)
        manager = RestartManager(str(tmp_path), interval_seconds=1e9)
        sim.run(2)
        path = sim.write_restart(manager)

        sim2 = ShardedHOnlyIonizationSimulation(config, tiling=(8, 1, 1), seed=99)
        sim2.load_restart(path)
        assert sim2.iteration == 2
        xh_a = np.asarray(sim.run(4))
        xh_b = np.asarray(sim2.run(4))
        np.testing.assert_array_equal(xh_a, xh_b)


class TestShardedMultifreq:
    def _config(self, diffuse=False):
        from cmacionize_tpu.models.multifreq_simulation import MultiFreqConfig
        from cmacionize_tpu.models.grid import GridGeometry

        pc = 3.086e16
        geometry = GridGeometry((-5 * pc,) * 3, (10 * pc,) * 3, (16, 16, 16))
        return MultiFreqConfig(
            geometry=geometry,
            number_density=1e8,
            initial_temperature=8000.0,
            source_position=(0.0, 0.0, 0.0),
            luminosity=4.26e49,
            spectrum_type="planck",
            spectrum_temperature=40000.0,
            spectrum_frequency=3.3e15,
            n_photons=16384,
            n_iterations=4,
            abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                        "Ne": 5e-5, "S": 9e-6},
            do_temperature=False,
            diffuse_field=diffuse,
            n_bins=32,
            n_reemission_rounds=4,
        )

    def test_matches_single_device_to_mc_noise(self):
        from cmacionize_tpu.models.multifreq_simulation import (
            MultiFreqIonizationSimulation,
        )
        from cmacionize_tpu.parallel.mesh import make_mesh

        config = self._config(diffuse=False)
        mesh = make_mesh(8, axis_names=("x",))
        sim_dd = MultiFreqIonizationSimulation(config, seed=5, mesh=mesh)
        xion_dd, _ = sim_dd.run(4)
        assert sim_dd._last_trace_diag["buffer_overflow"] == 0
        assert sim_dd._last_trace_diag["truncated_live"] == 0

        sim_sd = MultiFreqIonizationSimulation(config, seed=5)
        xion_sd, _ = sim_sd.run(4)

        xh_dd = np.asarray(xion_dd["H_n"])
        xh_sd = np.asarray(xion_sd["H_n"])
        v_dd = (xh_dd < 0.5).sum()
        v_sd = (xh_sd < 0.5).sum()
        assert v_dd == pytest.approx(v_sd, rel=0.15)
        # helium structure agrees too
        vhe_dd = (np.asarray(xion_dd["He_n"]) < 0.5).sum()
        vhe_sd = (np.asarray(xion_sd["He_n"]) < 0.5).sum()
        assert vhe_dd == pytest.approx(vhe_sd, rel=0.2)

    def test_diffuse_reemission_across_slabs(self):
        """In-loop re-emission: the sharded diffuse run must grow the
        ionized region relative to no-diffuse (reemitted photons push the
        front) and stay conservative (no overflow/truncation)."""
        from cmacionize_tpu.models.multifreq_simulation import (
            MultiFreqIonizationSimulation,
        )
        from cmacionize_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(8, axis_names=("x",))
        cfg_d = self._config(diffuse=True)
        sim_d = MultiFreqIonizationSimulation(cfg_d, seed=6, mesh=mesh)
        xion_d, _ = sim_d.run(4)
        assert sim_d._last_trace_diag["buffer_overflow"] == 0
        assert sim_d._last_trace_diag["truncated_live"] == 0

        cfg_n = self._config(diffuse=False)
        sim_n = MultiFreqIonizationSimulation(cfg_n, seed=6, mesh=mesh)
        xion_n, _ = sim_n.run(4)

        v_d = (np.asarray(xion_d["H_n"]) < 0.5).sum()
        v_n = (np.asarray(xion_n["H_n"]) < 0.5).sum()
        assert v_d >= v_n  # diffuse field only adds ionizing photons

        # single-device diffuse comparison (statistical)
        sim_sd = MultiFreqIonizationSimulation(cfg_d, seed=6)
        xion_sd, _ = sim_sd.run(4)
        v_sd = (np.asarray(xion_sd["H_n"]) < 0.5).sum()
        assert v_d == pytest.approx(v_sd, rel=0.15)


def _rhd_config(shape=(16, 16, 16), n_photons=8192, nloop=2):
    """Small starbench-like RHD workload."""
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.rhd_simulation import RHDConfig

    pc = 3.086e16
    myr = 3.15576e13
    total = 0.05 * myr
    geometry = GridGeometry(
        (-1.256 * pc,) * 3, (2.512 * pc,) * 3, shape)
    return RHDConfig(
        geometry=geometry,
        gamma=1.0001,
        timestep=total / 64.0,
        total_time=total,
        luminosity=1e49,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=n_photons,
        nloop=nloop,
        background_density=3.113e9,
        background_temperature=100.0,
    )


class TestShardedRHD:
    """The FULL coupled sharded step: radiation
    superstep exchange + two-temperature coupling + halo-exchange hydro in
    one shard_map program."""

    def test_matches_single_device_to_mc_noise(self):
        from cmacionize_tpu.models.rhd_simulation import (
            RHDSimulation,
            ShardedRHDSimulation,
        )

        config = _rhd_config()
        n_steps = 24
        sharded = ShardedRHDSimulation(config, tiling=(4, 1, 1), seed=5)
        sharded.advance(n_steps, log_every=10**9)
        assert sharded.last_diagnostics is None or (
            sharded.last_diagnostics["buffer_overflow"] == 0)

        single = RHDSimulation(config, seed=5)
        single.advance(n_steps, log_every=10**9)

        r_dd = sharded.ionization_front_radius()
        r_sd = single.ionization_front_radius()
        assert r_dd == pytest.approx(r_sd, rel=0.1)
        # mass conservation across the slab exchange (reflective box)
        m_dd = float(jnp.sum(sharded.state.rho))
        m_sd = float(jnp.sum(single.state.rho))
        assert m_dd == pytest.approx(m_sd, rel=1e-4)
        # the D-type shell shows the same expansion: compare mean radial
        # density profiles
        rho_dd = np.asarray(sharded.state.rho)
        rho_sd = np.asarray(single.state.rho)
        assert np.corrcoef(rho_dd.ravel(), rho_sd.ravel())[0, 1] > 0.97

    def test_production_run_cfl_timeline_snapshots(self):
        """run() end-to-end on the sharded driver: CFL + TimeLine +
        snapshot cadence."""
        from cmacionize_tpu.models.rhd_simulation import (
            RHDConfig,
            ShardedRHDSimulation,
        )

        base = _rhd_config(shape=(8, 8, 8), n_photons=2048, nloop=1)
        config = RHDConfig(**{
            **dataclasses.asdict(base),
            "geometry": base.geometry,
            "minimum_timestep": base.timestep,
            "maximum_timestep": base.total_time / 8.0,
            "snapshot_time": base.total_time / 4.0,
        })
        sim = ShardedRHDSimulation(config, tiling=(2, 1, 1), seed=7)
        snaps = []
        sim.run(snapshot_callback=lambda s, i: snaps.append((i, s.time)),
                log_every=10**9)
        assert sim.time == pytest.approx(config.total_time, rel=1e-6)
        indices = [i for i, _ in snaps]
        assert indices == sorted(indices)
        assert len(snaps) >= 3  # interior cadence + final
        assert snaps[-1][1] == pytest.approx(config.total_time, rel=1e-6)


def test_cli_sharded_rhd_starbench(tmp_path):
    """`cmacionize-tpu --rhd -p starbench-like.param` with a Parallel block:
    sharded production run writing a numbered snapshot series."""
    param_text = """
SimulationBox:
  anchor: [-1.256 pc, -1.256 pc, -1.256 pc]
  sides: [2.512 pc, 2.512 pc, 2.512 pc]
DensityGrid:
  number of cells: [16, 16, 16]
DensityFunction:
  density: 3113. cm^-3
  temperature: 100. K
PhotonSourceDistribution:
  type: SingleStar
  luminosity: 1.e49 s^-1
  position: [0. pc, 0. pc, 0. pc]
CrossSections:
  hydrogen_0: 6.3e-18 cm^2
RecombinationRates:
  hydrogen_1: 2.7e-13 cm^3 s^-1
HydroIntegrator:
  polytropic index: 1.0001
RadiationHydrodynamicsSimulation:
  total time: 0.02 Myr
  minimum timestep: 0.000625 Myr
  maximum timestep: 0.000625 Myr
  snapshot time: 0.01 Myr
  number of photons: 4096
  number of iterations: 1
Parallel:
  tiling: [4, 1, 1]
DensityGridWriter:
  prefix: sbench_
"""
    param_file = tmp_path / "sbench.param"
    param_file.write_text(param_text)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--rhd",
         "--params", str(param_file)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=900,
    )
    assert result.returncode == 0, result.stderr
    # numbered series: initial + cadence + final
    snaps = sorted(tmp_path.glob("sbench_*.hdf5"))
    assert len(snaps) >= 3, [s.name for s in snaps]
    assert (tmp_path / "sbench_000.hdf5").exists()
    assert (tmp_path / "StatisticsLogger.txt").exists()

    from cmacionize_tpu.io.gadget import read_gadget_snapshot

    _, _, fields = read_gadget_snapshot(str(snaps[-1]))
    xh = fields["NeutralFractionH"]
    assert xh.min() < 1e-3  # ionized bubble formed
    assert xh.max() > 0.9


def test_cli_sharded_stromgren(tmp_path):
    """`cmacionize-tpu -p stromgren.param --devices 8` end-to-end."""
    param_text = """
SimulationBox:
  anchor: [-5. pc, -5. pc, -5. pc]
  sides: [10. pc, 10. pc, 10. pc]
DensityGrid:
  number of cells: [16, 16, 16]
DensityFunction:
  density: 100. cm^-3
  temperature: 8000. K
PhotonSourceDistribution:
  luminosity: 4.26e49 s^-1
IonizationSimulation:
  number of photons: 8192
  number of iterations: 4
CrossSections:
  hydrogen_0: 6.3e-18 cm^2
RecombinationRates:
  hydrogen_1: 4.e-13 cm^3 s^-1
Parallel:
  tiling: [2, 2, 2]
DensityGridWriter:
  prefix: shard_
"""
    param_file = tmp_path / "shard.param"
    param_file.write_text(param_text)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    result = subprocess.run(
        [sys.executable, "-m", "cmacionize_tpu", "--params", str(param_file)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr
    snap = tmp_path / "shard_000.hdf5"
    assert snap.exists()

    from cmacionize_tpu.io.gadget import read_gadget_snapshot

    _, coords, fields = read_gadget_snapshot(str(snap))
    xh = fields["NeutralFractionH"]
    assert xh.min() < 1e-3
    assert xh.max() > 0.9


class TestShardedRHDRound5:
    """Round-5 envelope: gravity + mask + Bondi inflow
    run sharded; structured ICs survive from_params; slab width may bind
    against the halo; radiation load is balanced by source replication."""

    def _bondi_pair(self, shape=(16, 16, 16), tiling=(4, 1, 1)):
        from cmacionize_tpu.models.rhd_simulation import (
            RHDSimulation,
            ShardedRHDSimulation,
        )
        from cmacionize_tpu.utils.params import ParameterFile

        params = ParameterFile(os.path.join(REPO, "benchmarks/bondi.param"))
        params._tree["DensityGrid"]["number of cells"] = list(shape)
        prev = os.getcwd()
        os.chdir(os.path.join(REPO, "benchmarks"))
        try:
            base = RHDSimulation.from_params(params, seed=9)
            sharded = ShardedRHDSimulation.from_params(
                params, tiling=tiling, seed=9)
        finally:
            os.chdir(prev)
        return base, sharded

    def test_sharded_bondi_matches_single_device(self):
        """bondi = PointMass gravity + BlockSyntax mask + Bondi inflow on
        all six faces + isothermal EOS + BondiProfile ICs, distributed.
        nloop = 0 → fully deterministic: the sharded step must reproduce
        the single-device step to f32 round-off."""
        base, sharded = self._bondi_pair()

        # ADVICE r4 high regression: structured ICs survive the sharding
        np.testing.assert_allclose(
            np.asarray(sharded.state.rho), np.asarray(base.state.rho),
            rtol=1e-6)
        assert sharded.gravity is not None
        assert sharded.mask is not None
        assert "inflow_yz" in sharded._extras

        n_steps = 8
        base.advance(n_steps, log_every=10**9)
        sharded.advance(n_steps, log_every=10**9)
        rho_s = np.asarray(sharded.state.rho)
        rho_b = np.asarray(base.state.rho)
        assert np.all(np.isfinite(rho_s))
        np.testing.assert_allclose(rho_s, rho_b, rtol=2e-3)
        mom_scale = np.abs(np.asarray(base.state.mom_x)).max()
        np.testing.assert_allclose(
            np.asarray(sharded.state.mom_x), np.asarray(base.state.mom_x),
            atol=2e-3 * mom_scale)

    def test_min_slab_width_binds_halo(self):
        """nx_loc == 2 == hydro halo width: the
        exchange sends whole slabs; physics must still match."""
        from cmacionize_tpu.models.rhd_simulation import (
            RHDSimulation,
            ShardedRHDSimulation,
        )

        from cmacionize_tpu.models.grid import GridGeometry

        pc = 3.086e16
        base = _rhd_config(n_photons=4096, nloop=1)
        geometry = GridGeometry(
            (-1.256 * pc, -0.628 * pc, -0.628 * pc),
            (2.512 * pc, 1.256 * pc, 1.256 * pc), (16, 8, 8))
        config = dataclasses.replace(base, geometry=geometry)
        sharded = ShardedRHDSimulation(config, tiling=(8, 1, 1), seed=11)
        single = RHDSimulation(config, seed=11)
        n_steps = 12
        sharded.advance(n_steps, log_every=10**9)
        single.advance(n_steps, log_every=10**9)
        assert np.all(np.isfinite(np.asarray(sharded.state.rho)))
        m_dd = float(jnp.sum(sharded.state.rho))
        m_sd = float(jnp.sum(single.state.rho))
        assert m_dd == pytest.approx(m_sd, rel=1e-4)
        r_dd = sharded.ionization_front_radius()
        r_sd = single.ionization_front_radius()
        assert r_dd == pytest.approx(r_sd, rel=0.15)

    def test_radiation_skew_balanced(self):
        """Source replication keeps per-device traced counts balanced in
        the mostly-neutral (starbench early-phase) regime — the regime
        where the v1 emission scheme serialized on the source slab."""
        from cmacionize_tpu.models.rhd_simulation import ShardedRHDSimulation

        config = _rhd_config(shape=(16, 16, 16), n_photons=16384, nloop=1)
        sim = ShardedRHDSimulation(config, tiling=(8, 1, 1), seed=13)
        sim.advance(4, log_every=1)
        traced = sim.last_diagnostics["packets_traced"]
        assert traced.shape == (8,)
        assert traced.sum() >= config.n_photons
        skew = traced.max() / max(traced.mean(), 1.0)
        assert skew < 1.5, f"radiation skew {skew:.2f} (traced={traced})"

    def test_chunked_advance_matches_per_step_physics(self):
        """The 16-step scan-fused chunk advances the
        same physics as per-step dispatch (different RNG chain → compare
        to MC noise)."""
        from cmacionize_tpu.models.rhd_simulation import ShardedRHDSimulation

        config = _rhd_config(shape=(16, 16, 16), n_photons=8192, nloop=1)
        chunked = ShardedRHDSimulation(config, tiling=(4, 1, 1), seed=17)
        chunked.advance(32, log_every=10**9)  # 2 full fused chunks
        assert chunked._rhd_chunk is not None
        assert chunked.last_diagnostics["buffer_overflow"] == 0

        stepped = ShardedRHDSimulation(config, tiling=(4, 1, 1), seed=18)
        stepped._chunk_len = 10**9  # force the per-step remainder path
        stepped.advance(32, log_every=10**9)
        r_c = chunked.ionization_front_radius()
        r_s = stepped.ionization_front_radius()
        assert r_c == pytest.approx(r_s, rel=0.1)
        m_c = float(jnp.sum(chunked.state.rho))
        m_s = float(jnp.sum(stepped.state.rho))
        assert m_c == pytest.approx(m_s, rel=1e-4)
