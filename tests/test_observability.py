"""Observability residue: MemoryLogger named snapshots
+ timeline, RHD per-step diagnostics, checkify debug invariants in the
traversal kernels."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_memory_logger_snapshots_and_timeline(tmp_path):
    from cmacionize_tpu.utils.memory import MemoryLogger

    logger = MemoryLogger()
    logger.snapshot("startup")
    _ = np.zeros((1024, 1024))
    logger.snapshot("after allocation")
    mem = tmp_path / "memory.txt"
    timeline = tmp_path / "memory_timeline.txt"
    logger.write(str(mem), str(timeline))
    text = mem.read_text()
    assert "startup:" in text and "after allocation:" in text
    assert "rss:" in text and "peak rss:" in text
    rows = [l for l in timeline.read_text().splitlines()
            if not l.startswith("#")]
    assert len(rows) == 2
    assert rows[0].split("\t")[-1] == "startup"


def test_rhd_diagnostics_per_step(tmp_path):
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.rhd_simulation import RHDConfig, RHDSimulation
    from cmacionize_tpu.utils.diagnostics import IterationDiagnostics

    pc = 3.086e16
    config = RHDConfig(
        geometry=GridGeometry((-pc,) * 3, (2 * pc,) * 3, (8, 8, 8)),
        gamma=1.0001,
        timestep=1e10,
        total_time=4e10,
        luminosity=1e48,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=2000,
        nloop=2,
        background_density=1e8,
        background_temperature=100.0,
    )
    sim = RHDSimulation(config)
    diag = IterationDiagnostics(folder=str(tmp_path))
    sim.run(4, diagnostics=diag)
    assert len(diag.history) == 4
    rec = diag.history[0]
    assert rec["counters"]["photons emitted"] == 2000 * 2
    assert "step" in rec["phase_s"]
    assert (tmp_path / "diagnostics_00.txt").exists()
    assert (tmp_path / "diagnostics_03.txt").exists()


class TestTraversalDebugChecks:
    def _trace(self, opacity_value, shape=(6, 6, 6)):
        from cmacionize_tpu.ops import traversal

        n = 64
        key = jax.random.PRNGKey(0)
        d = jax.random.normal(key, (n, 3))
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        pos = jnp.full((n, 3), 3.0)
        tau = jnp.full((n,), 1.0)
        w = jnp.ones((n,))
        pk = traversal.make_packets(pos, d, tau, w, shape)
        chi = jnp.full((shape[0] * shape[1] * shape[2],), opacity_value)
        tally = jnp.zeros_like(chi)

        def fn(chi, pk, tally):
            return traversal.trace_packets(
                chi, pk, tally, shape=shape)

        return traversal.run_checked(fn, chi, pk, tally)

    def test_checks_pass_on_valid_input(self, monkeypatch):
        from cmacionize_tpu.ops import traversal

        monkeypatch.setattr(traversal, "_DEBUG_CHECKS", True)
        tally, pk = self._trace(0.5)
        assert bool(jnp.all(jnp.isfinite(tally)))

    def test_checks_catch_corrupted_opacity(self, monkeypatch):
        from cmacionize_tpu.ops import traversal

        monkeypatch.setattr(traversal, "_DEBUG_CHECKS", True)
        # NaN opacity → non-finite deposits; the kernel invariant must fire
        with pytest.raises(Exception):
            self._trace(float("nan"), shape=(7, 7, 7))

    def test_checks_free_when_disabled(self, monkeypatch):
        from cmacionize_tpu.ops import traversal

        monkeypatch.setattr(traversal, "_DEBUG_CHECKS", False)
        tally, pk = self._trace(0.5, shape=(5, 5, 5))
        assert bool(jnp.all(jnp.isfinite(tally)))
