"""Monte Carlo photoionization simulation driver (single-chip fast path).

JAX equivalent of the reference's IonizationSimulation /
TaskBasedIonizationSimulation run loop
(/root/reference/src/IonizationSimulation.cpp:334-679,
/root/reference/src/TaskBasedIonizationSimulation.cpp:643-1061): per
iteration, reset tallies → emit and trace all photon packets (one lockstep
batched traversal instead of a task scheduler) → normalize tallies →
per-cell ionization balance.  The whole iteration is one jitted function; the
Python loop over iterations only orchestrates logging and snapshots.

This module implements the hydrogen-only monochromatic fast path (the
stromgren benchmark family).  The multi-element path plugs in the multifreq
traversal + coupled H/He/metal solvers from cmacionize_tpu.ops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu.models import sources
from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.ops import ionization, traversal
from cmacionize_tpu.utils.logging import Log, NullLog


@dataclasses.dataclass(frozen=True)
class HOnlyConfig:
    """Static configuration of a hydrogen-only monochromatic simulation."""

    geometry: GridGeometry
    number_density: float  # m^-3 (homogeneous; fields also supported via run())
    temperature: float  # K
    source_position: Tuple[float, float, float]  # SI
    luminosity: float  # photons / s
    cross_section: float  # m^2 (at the source frequency)
    recombination_rate: float  # m^3 s^-1
    n_photons: int
    n_iterations: int
    initial_neutral_fraction: float = 1.0e-6

    @classmethod
    def from_params(cls, params) -> "HOnlyConfig":
        geometry = GridGeometry.from_params(params)
        return cls(
            geometry=geometry,
            number_density=params.get_physical_value(
                "DensityFunction:density", "number density", "100. cm^-3"
            ),
            temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "8000. K"
            ),
            source_position=tuple(
                params.get_physical_vector(
                    "PhotonSourceDistribution:position",
                    "length",
                    ["0. m", "0. m", "0. m"],
                )
            ),
            luminosity=params.get_physical_value(
                "PhotonSourceDistribution:luminosity", "frequency", "4.26e49 s^-1"
            ),
            cross_section=params.get_physical_value(
                "CrossSections:hydrogen_0", "surface area", "6.3e-18 cm^2"
            ),
            recombination_rate=params.get_physical_value(
                "RecombinationRates:hydrogen_1", "reaction rate", "4.e-13 cm^3 s^-1"
            ),
            n_photons=params.get_int("IonizationSimulation:number of photons", 1000000),
            n_iterations=params.get_int(
                "IonizationSimulation:number of iterations", 20
            ),
        )


def _h_only_iteration_body(
    key,
    neutral_fraction,
    number_density,
    *,
    shape,
    periodic,
    n_photons,
    sigma_dx,
    source_gpos,
    jfac_scale,
    alpha,
    max_steps=0,
):
    """Unjitted MC-iteration body shared by the per-call jit and the fused
    multi-iteration scan."""
    chi = (number_density * neutral_fraction * sigma_dx).reshape(-1)
    px, py, pz, dx, dy, dz, tau, _, weight = sources.emit_point_source(
        key, n_photons, source_gpos
    )
    position = jnp.stack([px, py, pz], axis=1)
    direction = jnp.stack([dx, dy, dz], axis=1)
    packets = traversal.make_packets(position, direction, tau, weight, shape)
    tally = jnp.zeros(chi.shape, chi.dtype)
    block = traversal.default_block(shape)
    if block is not None:
        tally, n_absorbed, n_escaped = traversal.trace_packets_blocked_cascade(
            chi, packets, tally,
            shape=shape, block=block, periodic=periodic, max_steps=max_steps,
        )
    else:
        tally, packets = traversal.trace_packets(
            chi, packets, tally,
            shape=shape, periodic=periodic, max_steps=max_steps,
        )
        n_escaped = jnp.sum(~packets.absorbed)
    jH = tally.reshape(shape) * jfac_scale
    new_x = ionization.hydrogen_neutral_fraction(jH, number_density, alpha)
    return new_x, jH, n_escaped


@functools.partial(
    jax.jit,
    static_argnames=(
        "shape", "periodic", "n_photons", "sigma_dx", "max_steps",
        "n_iterations",
    ),
    donate_argnames=("neutral_fraction",),
)
def h_only_run_fused(
    key,
    neutral_fraction,
    number_density,
    *,
    shape,
    periodic,
    n_photons,
    sigma_dx,
    source_gpos,
    jfac_scale,
    alpha,
    n_iterations,
    max_steps=0,
):
    """``n_iterations`` MC iterations fused into ONE dispatch via lax.scan.

    RNG-sequence-identical to calling :func:`h_only_iteration` in a Python
    loop with ``key, sub = jax.random.split(key)`` per iteration — the same
    split chain runs inside the scan carry — so fused and unfused drivers
    produce the same fields: bit-identical on the CPU; on a GPU the tally
    scatter-adds are atomic, so f32 sums may differ in the last bits from
    run to run.  Eliminates per-iteration host dispatch
    and readback latency.

    Returns (key, new_x, jH_last, n_escaped_per_iteration [n_iterations]).
    """

    def step(carry, _):
        key, x = carry
        key, sub = jax.random.split(key)
        new_x, jH, n_esc = _h_only_iteration_body(
            sub, x, number_density,
            shape=shape, periodic=periodic, n_photons=n_photons,
            sigma_dx=sigma_dx, source_gpos=source_gpos,
            jfac_scale=jfac_scale, alpha=alpha, max_steps=max_steps,
        )
        return (key, new_x), (jH, n_esc)

    (key, x), (jHs, n_escs) = jax.lax.scan(
        step, (key, neutral_fraction), None, length=n_iterations
    )
    return key, x, jHs[-1], n_escs


@functools.partial(
    jax.jit,
    static_argnames=("shape", "periodic", "n_photons", "sigma_dx", "max_steps"),
    donate_argnames=("neutral_fraction",),
)
def h_only_iteration(
    key,
    neutral_fraction,
    number_density,
    *,
    shape,
    periodic,
    n_photons,
    sigma_dx,  # sigma * cell_size (static python float — folded into chi)
    source_gpos,
    jfac_scale,  # L * sigma * dx / (W_tot * V_cell): tally → jH
    alpha,
    max_steps=0,
):
    """One Monte Carlo iteration: emit → trace → normalize → H balance.

    Returns (new_neutral_fraction [shape], jH [shape], n_escaped scalar).
    """
    return _h_only_iteration_body(
        key, neutral_fraction, number_density,
        shape=shape, periodic=periodic, n_photons=n_photons,
        sigma_dx=sigma_dx, source_gpos=source_gpos, jfac_scale=jfac_scale,
        alpha=alpha, max_steps=max_steps,
    )


class HOnlyIonizationSimulation:
    """Driver: owns config + grid arrays, runs the iteration loop."""

    def __init__(self, config: HOnlyConfig, log: Optional[Log] = None, seed: int = 42):
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError(
                "traversal currently requires cubic cells; got cell size "
                f"{cell}"
            )
        self.config = config
        self.log = log or NullLog()
        self.key = jax.random.PRNGKey(seed)
        self.geometry = geom
        self.dx = float(cell[0])
        self.number_density = jnp.full(
            geom.shape, config.number_density, jnp.float32
        )
        self.neutral_fraction = jnp.full(
            geom.shape, config.initial_neutral_fraction, jnp.float32
        )
        self.jH = jnp.zeros(geom.shape, jnp.float32)
        self.iteration = 0  # completed iterations (persisted by restart)
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )

    def advance(self, n_iterations: int, **kwargs):
        """Run ``n_iterations`` MORE iterations (the explicit stepping API;
        ``run(n)`` counts TOTAL iterations — see its docstring)."""
        return self.run(self.iteration + n_iterations, **kwargs)

    def run(self, n_iterations: Optional[int] = None, adaptive: bool = False,
            restart_manager=None, diagnostics=None):
        """Run MC iterations.

        adaptive=True uses the width-compacting traversal (one host sync +
        argsort per iteration); the default is the fully fused path.

        ``restart_manager``: optional io.restart.RestartManager — checkpoints
        on its cadence, on SIGINT, and on max-walltime (graceful stop +
        resubmit hook, cf. /root/reference/src/RestartManager.hpp:206-250).
        ``n_iterations`` counts TOTAL iterations including any restored by
        load_restart, so a killed-and-resumed run reproduces the
        uninterrupted one (bit for bit on the CPU; to f32 summation order on
        a GPU, whose scatter-adds are atomic).
        """
        from cmacionize_tpu.utils import signals

        cfg = self.config
        n_iterations = n_iterations or cfg.n_iterations
        if restart_manager is not None:
            signals.install()
        sigma_dx = cfg.cross_section * self.dx
        jfac_scale = (
            cfg.luminosity
            * cfg.cross_section
            * self.dx
            / (cfg.n_photons * self.geometry.cell_volume)
        )
        # Fused fast path: with no per-iteration side effects (restart
        # cadence, diagnostics, adaptive compaction) the whole remaining
        # iteration loop runs as ONE dispatch (lax.scan) — RNG- and
        # result-identical to the per-iteration path.
        if (
            not adaptive
            and restart_manager is None
            and diagnostics is None
            and self.iteration < n_iterations
        ):
            n_todo = n_iterations - self.iteration
            self.key, self.neutral_fraction, self.jH, n_escs = (
                h_only_run_fused(
                    self.key,
                    self.neutral_fraction,
                    self.number_density,
                    shape=self.geometry.shape,
                    periodic=self.geometry.periodic,
                    n_photons=cfg.n_photons,
                    sigma_dx=sigma_dx,
                    source_gpos=self._source_gpos,
                    jfac_scale=jfac_scale,
                    alpha=cfg.recombination_rate,
                    n_iterations=n_todo,
                )
            )
            if not isinstance(self.log, NullLog):
                n_escs = [int(v) for v in n_escs]
                for i, n_esc in enumerate(n_escs):
                    self.log.info(
                        f"iteration {self.iteration + i + 1}/{n_iterations}: "
                        f"{n_esc} / {cfg.n_photons} photons escaped"
                    )
            self.iteration = n_iterations
            return self.neutral_fraction

        while self.iteration < n_iterations:
            iteration = self.iteration
            self.key, subkey = jax.random.split(self.key)
            if adaptive:
                self.neutral_fraction, self.jH, n_escaped = (
                    self._iteration_adaptive(subkey, sigma_dx, jfac_scale)
                )
            else:
                self.neutral_fraction, self.jH, n_escaped = h_only_iteration(
                    subkey,
                    self.neutral_fraction,
                    self.number_density,
                    shape=self.geometry.shape,
                    periodic=self.geometry.periodic,
                    n_photons=cfg.n_photons,
                    sigma_dx=sigma_dx,
                    source_gpos=self._source_gpos,
                    jfac_scale=jfac_scale,
                    alpha=cfg.recombination_rate,
                )
            self.iteration += 1
            self.log.info(
                f"iteration {iteration + 1}/{n_iterations}: "
                f"{int(n_escaped)} / {cfg.n_photons} photons escaped"
            )
            if diagnostics is not None:
                # per-iteration perf counters, the diagnostics_XX.txt
                # equivalent (TaskBasedIonizationSimulation.cpp:969-1035)
                diagnostics.count("photons emitted", cfg.n_photons)
                diagnostics.count("photons escaped", int(n_escaped))
                diagnostics.count(
                    "photons absorbed", cfg.n_photons - int(n_escaped))
                diagnostics.end_iteration()
            if restart_manager is not None:
                stopping = (
                    signals.stop_requested() or restart_manager.want_stop()
                )
                if restart_manager.due() or stopping:
                    self.write_restart(restart_manager)
                if stopping:
                    self.log.warning(
                        "graceful stop requested; exiting iteration loop"
                    )
                    restart_manager.on_stop()
                    break
        return self.neutral_fraction

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        arrays = {
            "neutral_fraction": self.neutral_fraction,
            "jH": self.jH,
            "rng_key": jax.random.key_data(self.key),
        }
        return manager.write(arrays, {"iteration": self.iteration})

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager

        arrays, scalars = RestartManager.load(filename)
        self.neutral_fraction = jnp.asarray(arrays["neutral_fraction"])
        self.jH = jnp.asarray(arrays["jH"])
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.iteration = int(scalars["iteration"])

    def _iteration_adaptive(self, key, sigma_dx, jfac_scale):
        from cmacionize_tpu.models import sources as sources_mod

        cfg = self.config
        shape = self.geometry.shape

        @functools.partial(jax.jit, donate_argnames=())
        def emit(key, neutral_fraction, number_density):
            chi = (number_density * neutral_fraction * sigma_dx).reshape(-1)
            px, py, pz, dx, dy, dz, tau, _, w = sources_mod.emit_point_source(
                key, cfg.n_photons, self._source_gpos
            )
            packets = traversal.make_packets(
                jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
                tau, w, shape,
            )
            return chi, packets

        @jax.jit
        def solve(tally, number_density):
            jH = tally.reshape(shape) * jfac_scale
            return ionization.hydrogen_neutral_fraction(
                jH, number_density, cfg.recombination_rate
            ), jH

        chi, packets = emit(key, self.neutral_fraction, self.number_density)
        tally = jnp.zeros(chi.shape, chi.dtype)
        tally, n_absorbed, n_escaped = traversal.trace_packets_adaptive(
            chi, packets, tally,
            shape=shape, periodic=self.geometry.periodic,
        )
        new_x, jH = solve(tally, self.number_density)
        return new_x, jH, n_escaped

    def stromgren_radius_analytic(self) -> float:
        """Analytic Strömgren radius for the homogeneous H-only setup (m),
        cf. /root/reference/benchmarks/stromgren.py:45-55."""
        cfg = self.config
        return float(
            (
                0.75
                * cfg.luminosity
                / (np.pi * cfg.number_density**2 * cfg.recombination_rate)
            )
            ** (1.0 / 3.0)
        )


class ShardedHOnlyIonizationSimulation:
    """Domain-decomposed H-only driver: grid tiled (sx, sy, sz) over a device
    mesh, photon packets exchanged over the interconnect.

    Production wrapper over parallel.domain3d.make_domain_mc_iteration_3d —
    the run-loop ownership the reference keeps in
    TaskBasedIonizationSimulation::run
    (/root/reference/src/TaskBasedIonizationSimulation.cpp:643-1061).
    Mirrors the HOnlyIonizationSimulation interface (run / neutral_fraction /
    restart).
    """

    def __init__(self, config: HOnlyConfig, tiling=None, log: Optional[Log] = None,
                 seed: int = 42):
        from cmacionize_tpu.parallel import domain3d

        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError("cubic cells required")
        if tiling is None:
            tiling = (len(jax.devices()), 1, 1)
        self.tiling = tuple(int(t) for t in tiling)
        self.n_devices = self.tiling[0] * self.tiling[1] * self.tiling[2]
        self.mesh = domain3d.make_mesh_3d(self.tiling)
        self.config = config
        self.log = log or NullLog()
        self.key = jax.random.PRNGKey(seed)
        self.geometry = geom
        self.dx = float(cell[0])
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )
        sigma_dx = config.cross_section * self.dx
        jfac_scale = (
            config.luminosity * config.cross_section * self.dx
            / (config.n_photons * geom.cell_volume)
        )
        self._step, self._shardings = domain3d.make_domain_mc_iteration_3d(
            self.mesh,
            global_shape=geom.shape,
            n_photons=config.n_photons,
            sigma_dx=sigma_dx,
            source_gpos=self._source_gpos,
            jfac_scale=jfac_scale,
            alpha=config.recombination_rate,
        )
        self.number_density = jax.device_put(
            jnp.full(geom.shape, config.number_density, jnp.float32),
            self._shardings["field"],
        )
        self.neutral_fraction = jax.device_put(
            jnp.full(geom.shape, config.initial_neutral_fraction, jnp.float32),
            self._shardings["field"],
        )
        self.jH = None
        self.iteration = 0
        self.last_diagnostics = None

    def run(self, n_iterations: Optional[int] = None, restart_manager=None,
            diagnostics=None):
        from cmacionize_tpu.utils import signals

        cfg = self.config
        n_iterations = n_iterations or cfg.n_iterations
        if restart_manager is not None:
            signals.install()
        while self.iteration < n_iterations:
            self.key, subkey = jax.random.split(self.key)
            keys = jax.device_put(
                jax.random.split(subkey, self.n_devices),
                self._shardings["keys"],
            )
            self.neutral_fraction, self.jH, diag = self._step(
                keys, self.neutral_fraction, self.number_density
            )
            self.iteration += 1
            self.last_diagnostics = {
                "n_escaped": int(diag["n_escaped"]),
                "buffer_overflow": int(diag["buffer_overflow"]),
                "truncated_live": int(diag["truncated_live"]),
                "packets_traced": np.asarray(diag["packets_traced"]),
            }
            if self.last_diagnostics["buffer_overflow"]:
                self.log.warning(
                    "exchange buffer overflow: "
                    f"{self.last_diagnostics['buffer_overflow']} packets"
                )
            traced = self.last_diagnostics["packets_traced"]
            self.log.info(
                f"iteration {self.iteration}/{n_iterations}: "
                f"{self.last_diagnostics['n_escaped']} escaped; "
                f"per-device traced skew max/mean = "
                f"{traced.max() / max(traced.mean(), 1):.2f}"
            )
            if diagnostics is not None:
                diagnostics.count("photons emitted", cfg.n_photons)
                diagnostics.count(
                    "photons escaped", self.last_diagnostics["n_escaped"])
                for d, n in enumerate(traced.reshape(-1)):
                    diagnostics.count(f"packets traced[device {d}]", int(n))
                diagnostics.end_iteration()
            if restart_manager is not None:
                stopping = (
                    signals.stop_requested() or restart_manager.want_stop()
                )
                if restart_manager.due() or stopping:
                    self.write_restart(restart_manager)
                if stopping:
                    self.log.warning("graceful stop requested")
                    restart_manager.on_stop()
                    break
        return self.neutral_fraction

    def write_restart(self, manager) -> str:
        arrays = {
            "neutral_fraction": self.neutral_fraction,
            "rng_key": jax.random.key_data(self.key),
        }
        return manager.write(arrays, {"iteration": self.iteration})

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager

        arrays, scalars = RestartManager.load(filename)
        self.neutral_fraction = jax.device_put(
            jnp.asarray(arrays["neutral_fraction"]), self._shardings["field"]
        )
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.iteration = int(scalars["iteration"])

    def stromgren_radius_analytic(self) -> float:
        """Analytic Strömgren radius for the homogeneous H-only setup (m),
        cf. /root/reference/benchmarks/stromgren.py:45-55."""
        cfg = self.config
        return float(
            (
                0.75
                * cfg.luminosity
                / (np.pi * cfg.number_density**2 * cfg.recombination_rate)
            )
            ** (1.0 / 3.0)
        )
