"""Radiation hydrodynamics: coupled MC photoionization + finite-volume hydro.

Equivalent of the reference's RadiationHydrodynamicsSimulation
(/root/reference/src/RadiationHydrodynamicsSimulation.cpp:155-803) for the
starbench-class problems: a fixed-Δt time loop where every step runs
`nloop` Monte Carlo ionization iterations on the *current* density field,
couples the ionization state to the gas energy through the two-temperature
scheme (HydroIntegrator.hpp:1288-1339 — ionized gas driven to T_ion, neutral
to T_neutral, shock-heated gas left alone), then advances the MUSCL-Hancock
hydro step.

The entire step (radiation loops + coupling + hydro) is one jitted function;
the Python loop only handles snapshots/logging.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu import constants
from cmacionize_tpu.models import sources
from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.ops import hydro, ionization, traversal
from cmacionize_tpu.utils.logging import Log, NullLog


@dataclasses.dataclass(frozen=True)
class DensityBlock:
    """A BlockSyntax cube: constant density/temperature inside a box,
    cf. /root/reference/src/BlockSyntaxDensityFunction.hpp."""

    origin: Tuple[float, float, float]  # SI (center of the block)
    sides: Tuple[float, float, float]
    number_density: float  # m^-3
    temperature: float  # K


@dataclasses.dataclass(frozen=True)
class RHDConfig:
    geometry: GridGeometry
    gamma: float
    timestep: float  # s (fixed-dt fallback; also the TimeLine minimum)
    total_time: float  # s
    luminosity: float
    source_position: Tuple[float, float, float]
    cross_section: float
    recombination_rate: float
    n_photons: int
    nloop: int  # ionization iterations per radiation update
    background_density: float = 0.0  # m^-3
    background_temperature: float = 100.0
    blocks: Sequence[DensityBlock] = ()
    boundaries: Tuple = (
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
        (hydro.BC_REFLECTIVE, hydro.BC_REFLECTIVE),
    )
    neutral_temperature: float = 100.0
    ionised_temperature: float = 1.0e4
    shock_temperature: float = 3.0e4
    radiative_heating: bool = True
    radiative_cooling: bool = False
    initial_neutral_fraction: float = 1.0
    # "HLLC" or "Exact" — parameter-file selectable flux solver, mirroring
    # /root/reference/src/RiemannSolverFactory.hpp:54-57
    riemann_solver: str = "HLLC"
    # production time-loop controls (cf. RadiationHydrodynamicsSimulation.cpp
    # :218-243 defaults: min dt 1e-10·T, max dt 0.1·T, snapshot 0.1·T,
    # radiation every step).  0.0 → "unset": min/max collapse to ``timestep``
    # (fixed-dt legacy behavior) and snapshots default to 0.1·total_time.
    minimum_timestep: float = 0.0
    maximum_timestep: float = 0.0
    snapshot_time: float = 0.0
    radiation_time: float = -1.0  # <0 → radiation every hydro step
    cfl: float = 0.2


class RHDSimulation:
    """Driver for the coupled RHD time loop.

    Optional physics (all selectable from the parameter file via
    :meth:`from_params`, mirroring
    /root/reference/src/RadiationHydrodynamicsSimulation.cpp:250-392,631-654):

    - ``gravity``: static (gx, gy, gz) acceleration fields (external
      potentials, precomputed on cell centers)
    - ``self_gravity``: FFT Poisson self-gravity recomputed from the live
      density each step (design delta vs the reference's Barnes-Hut tree,
      documented in ops/potentials.py)
    - ``cooling``: De Rijcke optically-thin radiative cooling substeps
    - ``forcing``: Alvelius spectral turbulence forcing (new random phases
      per step, cf. TaskBasedRadiationHydrodynamicsSimulation.cpp:2030-2062)
    - ``mask``/``mask_state``: HydroMask — masked cells reset to the held
      state after every step (BlockSyntaxHydroMask equivalent)
    - ``inflow_states``: per-face ghost primitives for BC_INFLOW (the Bondi
      boundary, cf. BondiHydroBoundary.hpp)
    - ``isothermal_sound_speed``: isothermal EOS (reference
      ``polytropic index: 1.``)
    - ``source_distribution``: time-dependent source population with
      ``update(t)`` + SN stellar feedback
      (cf. RadiationHydrodynamicsSimulation.cpp:529-535)
    - ``initial``: DensityFields override for structured ICs (any
      DensityFunction type incl. BondiProfile)
    """

    def __init__(self, config: RHDConfig, log: Optional[Log] = None, seed: int = 42,
                 *, initial=None, gravity=None, self_gravity: bool = False,
                 cooling: bool = False, forcing=None, mask=None,
                 mask_state=None, inflow_states=None,
                 isothermal_sound_speed: Optional[float] = None,
                 source_distribution=None, stellar_feedback: bool = False):
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError("cubic cells required")
        self.config = config
        self.log = log or NullLog()
        self.key = jax.random.PRNGKey(seed)
        self.geometry = geom
        self.dx = float(cell[0])
        self.gravity = gravity
        self.self_gravity = bool(self_gravity)
        self.cooling = bool(cooling)
        self.forcing = forcing
        self.mask = mask
        self.mask_state = mask_state
        self.inflow_states = inflow_states
        self.isothermal_sound_speed = isothermal_sound_speed
        self.source_distribution = source_distribution
        self.stellar_feedback = bool(stellar_feedback)

        # initial conditions: DensityFields override, else background + blocks
        centers = geom.cell_centers()
        velocity = None
        if initial is not None:
            nd = np.asarray(initial.number_density, dtype=float)
            T = np.asarray(initial.temperature, dtype=float)
            if getattr(initial, "velocity", None) is not None:
                velocity = np.asarray(initial.velocity, dtype=float)
        else:
            nd = np.full(geom.shape, config.background_density)
            T = np.full(geom.shape, config.background_temperature)
            for block in config.blocks:
                origin = np.asarray(block.origin)
                half = 0.5 * np.asarray(block.sides)
                inside = np.all(np.abs(centers - origin) <= half, axis=-1)
                nd = np.where(inside, block.number_density, nd)
                T = np.where(inside, block.temperature, T)

        rho = nd * constants.PROTON_MASS
        pressure = nd * constants.BOLTZMANN * T
        if isothermal_sound_speed is not None:
            pressure = rho * isothermal_sound_speed**2
        w = hydro.Primitives(
            rho=jnp.asarray(rho, jnp.float32),
            vx=jnp.asarray(velocity[..., 0], jnp.float32)
            if velocity is not None else jnp.zeros(geom.shape, jnp.float32),
            vy=jnp.asarray(velocity[..., 1], jnp.float32)
            if velocity is not None else jnp.zeros(geom.shape, jnp.float32),
            vz=jnp.asarray(velocity[..., 2], jnp.float32)
            if velocity is not None else jnp.zeros(geom.shape, jnp.float32),
            p=jnp.asarray(pressure, jnp.float32),
        )
        self.state = hydro.conserved_from_primitives(w, config.gamma)
        if self.mask is not None and self.mask_state is None:
            self.mask_state = self.state  # hold the initial state
        self.neutral_fraction = jnp.full(
            geom.shape, config.initial_neutral_fraction, jnp.float32
        )
        self.time = 0.0
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )
        self._source_set_gpos = None  # evolving source positions (device)
        # dt is a TRACED argument everywhere so CFL/TimeLine-driven timestep
        # changes never trigger a recompile
        self._step_jit = jax.jit(self._step, static_argnames=("do_radiation",))
        self._chunk_jit = None  # lazily-built fused multi-step scan
        #: fixed fused-scan length — ONE compile covers every chunked call;
        #: remainders run through the per-step jit
        self._chunk_len = 16
        # timeline bookkeeping (production run(); persisted by restart)
        self._lastsnap = 1
        self._lastrad = 0
        self._timeline = None
        self._restored_timeline = None

    # ----------------------------------------------------------- from_params

    @classmethod
    def from_params(cls, params, log=None, seed: int = 42) -> "RHDSimulation":
        """Build the full driver from a parameter file — potentials,
        self-gravity, cooling, turbulence, masks, Bondi boundaries, and
        time-dependent sources included, mirroring
        /root/reference/src/RadiationHydrodynamicsSimulation.cpp:250-392."""
        import os

        from cmacionize_tpu.models.grid import GridGeometry
        from cmacionize_tpu.utils.params import ParameterFile

        geom = GridGeometry.from_params(params)
        total_time = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:total time", "time", "0.141 Myr"
        )
        # reference defaults (RadiationHydrodynamicsSimulation.cpp:218-243):
        # min dt 0.01·T, max dt 0.1·T, snapshot 0.1·T, radiation every step
        dt_min = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:minimum timestep", "time",
            "-1. s",
        )
        if dt_min < 0.0:
            dt_min = 1.0e-10 * total_time
        dt_max = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:maximum timestep", "time",
            "-1. s",
        )
        if dt_max < 0.0:
            dt_max = 0.1 * total_time
        snapshot_time = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:snapshot time", "time", "-1. s"
        )
        radiation_time = params.get_physical_value(
            "RadiationHydrodynamicsSimulation:radiation time", "time", "-1. s"
        )
        cfl = params.get_number("HydroIntegrator:CFL constant", 0.2)
        # legacy fixed-dt fallback for advance(): the explicit minimum when
        # one is given (starbench pins min == max), else total/2048
        dt = dt_min if params.has_value(
            "RadiationHydrodynamicsSimulation:minimum timestep"
        ) else total_time / 2048.0
        gamma = params.get_number(
            "HydroIntegrator:polytropic index", 5.0 / 3.0)

        # ---- initial conditions (any DensityFunction type)
        initial = None
        blocks = []
        dftype = params.get_string("DensityFunction:type", "Homogeneous")
        if dftype == "Homogeneous":
            block_file = params.get_string("DensityFunction:filename", "")
            if block_file and os.path.exists(block_file):
                block_params = ParameterFile(block_file)
                for i in range(block_params.get_int("number of blocks", 0)):
                    prefix = f"block[{i}]"
                    blocks.append(DensityBlock(
                        origin=tuple(block_params.get_physical_vector(
                            f"{prefix}:origin", "length")),
                        sides=tuple(block_params.get_physical_vector(
                            f"{prefix}:sides", "length")),
                        number_density=block_params.get_physical_value(
                            f"{prefix}:number density", "number density"),
                        temperature=block_params.get_physical_value(
                            f"{prefix}:initial temperature", "temperature",
                            "100. K"),
                    ))
        else:
            from cmacionize_tpu.models.density_functions import (
                density_function_from_params,
            )

            initial = density_function_from_params(params, geom)

        # ---- boundaries (periodic/reflective/inflow/outflow/bondi)
        bondi_profile = None

        def bc(name):
            value = params.get_string(
                f"HydroIntegrator:boundary {name}", "reflective")
            return {
                "periodic": hydro.BC_PERIODIC,
                "reflective": hydro.BC_REFLECTIVE,
                "inflow": hydro.BC_INFLOW,
                "outflow": hydro.BC_OUTFLOW,
                "bondi": hydro.BC_INFLOW,
            }[value], value == "bondi"

        bcs, bondi_flags = [], []
        for name in ("x low", "x high", "y low", "y high", "z low", "z high"):
            b, is_bondi = bc(name)
            bcs.append(b)
            bondi_flags.append(is_bondi)
        boundaries = tuple(
            (bcs[2 * a], bcs[2 * a + 1]) for a in range(3))

        inflow_states = None
        isothermal_sound_speed = None
        if any(bondi_flags) or params.has_value("BondiProfile:central mass"):
            from cmacionize_tpu.models.bondi import BondiProfile

            bondi_profile = BondiProfile(
                central_mass=params.get_physical_value(
                    "BondiProfile:central mass", "mass", "18. Msol"),
                bondi_density=params.get_physical_value(
                    "BondiProfile:Bondi density", "density", "1.e-19 g cm^-3"),
                sound_speed=params.get_physical_value(
                    "BondiProfile:sound speed", "velocity", "2.031 km s^-1"),
                center=tuple(params.get_physical_vector(
                    "BondiProfile:center", "length", ["0. m"] * 3)),
                ionisation_radius=params.get_physical_value(
                    "BondiProfile:ionisation radius", "length", "0. m"),
                pressure_contrast=params.get_number(
                    "BondiProfile:pressure contrast", 0.0),
            )
        if any(bondi_flags):
            # spatially-varying ghost primitives from the analytic profile
            # (BondiHydroBoundary.hpp) — evaluated once on the padded lattice
            n = geom.shape
            dxc = float(geom.cell_size[0])
            axes_1d = [
                geom.anchor[a] + (np.arange(-2, n[a] + 2) + 0.5) * dxc
                for a in range(3)
            ]
            padded_centers = np.stack(
                np.meshgrid(*axes_1d, indexing="ij"), axis=-1)
            p_rho, p_v, p_p, _ = bondi_profile.evaluate(padded_centers)
            padded_fields = (p_rho, p_v[..., 0], p_v[..., 1], p_v[..., 2], p_p)

            def ghost_slab(axis, side):
                sl = [slice(None)] * 3
                for a in range(axis + 1, 3):
                    sl[a] = slice(2, -2)
                sl[axis] = (slice(0, 2) if side == "lo"
                            else slice(n[axis] + 2, n[axis] + 4))
                return tuple(
                    jnp.asarray(f[tuple(sl)], jnp.float32)
                    for f in padded_fields
                )

            inflow_states = {
                (axis, side): ghost_slab(axis, side)
                for axis in range(3) for side in ("lo", "hi")
                if bondi_flags[2 * axis + (side == "hi")]
            }
        if gamma <= 1.0:
            # reference `polytropic index: 1.` (exactly) → isothermal EOS
            # (HydroIntegrator.hpp:283-292); γ merely *close* to 1 — e.g.
            # starbench's 1.0001 — is an ordinary ideal gas whose pressure
            # must keep the radiative heating
            cs = (bondi_profile.sound_speed if bondi_profile is not None
                  else float(np.sqrt(
                      constants.BOLTZMANN * params.get_physical_value(
                          "DensityFunction:temperature", "temperature",
                          "100. K") / constants.PROTON_MASS)))
            isothermal_sound_speed = cs
            gamma = 1.0 + 1e-6

        # ---- external potential + self-gravity
        gravity = None
        if params.get_bool(
                "RadiationHydrodynamicsSimulation:use potential", False):
            from cmacionize_tpu.ops import potentials

            ptype = params.get_string("ExternalPotential:type", "PointMass")
            if ptype == "PointMass":
                pot = potentials.PointMassPotential(
                    mass=params.get_physical_value(
                        "ExternalPotential:mass", "mass", "18. Msol"),
                    position=tuple(params.get_physical_vector(
                        "ExternalPotential:position", "length", ["0. m"] * 3)),
                    softening=float(geom.cell_size[0]),
                )
            elif ptype == "DiscPatch":
                pot = potentials.DiscPatchPotential(
                    surface_density=params.get_physical_value(
                        "ExternalPotential:surface density",
                        "surface density", "30. Msol pc^-2"),
                    disc_z=params.get_physical_value(
                        "ExternalPotential:disc z", "length", "0. m"),
                    scale_height=params.get_physical_value(
                        "ExternalPotential:scale height", "length", "100. pc"),
                )
            elif ptype == "CoredDMProfile":
                pot = potentials.CoredDMPotential(
                    central_density=params.get_physical_value(
                        "ExternalPotential:density at zero radius", "density",
                        "9.48e-19 g cm^-3"),
                    core_radius=params.get_physical_value(
                        "ExternalPotential:core radius", "length", "300. pc"),
                )
            else:
                raise ValueError(f"unknown ExternalPotential type {ptype!r}")
            acc = pot.acceleration(geom.cell_centers())
            gravity = tuple(
                jnp.asarray(acc[..., a], jnp.float32) for a in range(3))
        self_gravity = params.get_bool(
            "RadiationHydrodynamicsSimulation:use self gravity", False)
        cooling = params.get_bool(
            "RadiationHydrodynamicsSimulation:use cooling", False)

        # ---- hydro mask (BlockSyntax: freeze cells inside the blocks at
        # their initial state, cf. BlockSyntaxHydroMask.hpp)
        mask = None
        if params.get_bool(
                "RadiationHydrodynamicsSimulation:use mask", False):
            mtype = params.get_string("HydroMask:type", "BlockSyntax")
            if mtype != "BlockSyntax":
                raise NotImplementedError(
                    f"HydroMask type {mtype!r} not supported (BlockSyntax is)")
            from cmacionize_tpu.models.density_functions import (
                blocks_from_yaml,
            )

            mblocks = blocks_from_yaml(
                params.get_string("HydroMask:filename"))
            centers = geom.cell_centers()
            inside = np.zeros(geom.shape, bool)
            for blk in mblocks:
                inside |= np.asarray(blk.contains(centers))
            mask = jnp.asarray(inside)

        # ---- turbulence forcing (Alvelius)
        forcing = None
        if params.has_value("TurbulenceForcing:forcing power") or \
                params.get_bool(
                    "RadiationHydrodynamicsSimulation:use turbulent forcing",
                    False):
            from cmacionize_tpu.ops import turbulence

            forcing = turbulence.TurbulenceForcing.build(
                box_sides=float(geom.sides[0]),
                k_min=params.get_number(
                    "TurbulenceForcing:minimum wave number", 1.0),
                k_max=params.get_number(
                    "TurbulenceForcing:maximum wave number", 3.0),
                k_forcing=params.get_number(
                    "TurbulenceForcing:peak forcing wave number", 2.5),
                concentration_factor=params.get_number(
                    "TurbulenceForcing:concentration factor", 0.2),
                power_forcing=params.get_physical_value(
                    "TurbulenceForcing:forcing power", None, "2.717e-4 m^2 s^-3"),
                driving_timestep=dt,
            )

        # ---- time-dependent sources + stellar feedback
        source_distribution = None
        stellar_feedback = params.get_bool(
            "RadiationHydrodynamicsSimulation:use stellar feedback", False)
        sdtype = params.get_string("PhotonSourceDistribution:type", "SingleStar")
        if sdtype != "SingleStar" or stellar_feedback:
            from cmacionize_tpu.models.source_distributions import (
                source_distribution_from_params,
            )

            source_distribution = source_distribution_from_params(params)

        config = RHDConfig(
            geometry=geom,
            gamma=gamma,
            timestep=dt,
            total_time=total_time,
            luminosity=params.get_physical_value(
                "PhotonSourceDistribution:luminosity", "frequency",
                "1.e49 s^-1"),
            source_position=tuple(params.get_physical_vector(
                "PhotonSourceDistribution:position", "length", ["0. m"] * 3)),
            cross_section=params.get_physical_value(
                "CrossSections:hydrogen_0", "surface area", "6.3e-18 cm^2"),
            recombination_rate=params.get_physical_value(
                "RecombinationRates:hydrogen_1", "reaction rate",
                "2.7e-13 cm^3 s^-1"),
            n_photons=params.get_int(
                "RadiationHydrodynamicsSimulation:number of photons", 1000000),
            nloop=params.get_int(
                "RadiationHydrodynamicsSimulation:number of iterations", 10),
            background_density=params.get_physical_value(
                "DensityFunction:density", "number density", "0. m^-3"),
            background_temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "100. K"),
            blocks=blocks,
            boundaries=boundaries,
            radiative_heating=params.get_bool(
                "HydroIntegrator:radiative heating", True),
            radiative_cooling=params.get_bool(
                "HydroIntegrator:radiative cooling", False),
            riemann_solver=params.get_string(
                "HydroIntegrator:riemann solver type", "HLLC"),
            minimum_timestep=dt_min,
            maximum_timestep=dt_max,
            snapshot_time=snapshot_time,
            radiation_time=radiation_time,
            cfl=cfl,
        )
        return cls(
            config, log=log, seed=seed, initial=initial, gravity=gravity,
            self_gravity=self_gravity, cooling=cooling, forcing=forcing,
            mask=mask, inflow_states=inflow_states,
            isothermal_sound_speed=isothermal_sound_speed,
            source_distribution=source_distribution,
            stellar_feedback=stellar_feedback,
        )

    # ------------------------------------------------------------------ core

    def _radiation_update(self, key, number_density, neutral_fraction):
        """nloop MC ionization iterations on the current density field."""
        cfg = self.config
        shape = self.geometry.shape
        sigma_dx = cfg.cross_section * self.dx
        luminosity = cfg.luminosity
        if self.source_distribution is not None:
            sset = self.source_distribution.source_set()
            if len(sset.luminosities) == 0:
                return neutral_fraction  # no active sources → no radiation
            luminosity = sset.total_luminosity
        jfac_scale = (
            luminosity * cfg.cross_section * self.dx
            / (cfg.n_photons * self.geometry.cell_volume)
        )
        for loop in range(cfg.nloop):
            key, subkey = jax.random.split(key)
            chi = (number_density * neutral_fraction * sigma_dx).reshape(-1)
            if self.source_distribution is not None:
                px, py, pz, dx, dy, dz, tau, _, weight = (
                    sources.emit_source_set(
                        subkey, cfg.n_photons, sset, self.geometry
                    )
                )
            else:
                px, py, pz, dx, dy, dz, tau, _, weight = (
                    sources.emit_point_source(
                        subkey, cfg.n_photons, self._source_gpos
                    )
                )
            packets = traversal.make_packets(
                jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
                tau, weight, shape,
            )
            tally = jnp.zeros(chi.shape, chi.dtype)
            # width-compacting cascade, shaped by the RHD survival curves:
            # the mostly-neutral early-phase medium kills 70%+ of packets by
            # block-phase 2 and ~95% by phase 3 (counted on the 64³
            # starbench), so shrinking the batch width 3× per stage cuts
            # the full-width phases the lockstep march would otherwise pay
            block = traversal.default_block(shape)
            if block is None:
                tally, _ = traversal.trace_packets(
                    chi, packets, tally,
                    shape=shape, periodic=self.geometry.periodic,
                )
            else:
                tally, _, _ = traversal.trace_packets_blocked_cascade(
                    chi, packets, tally,
                    shape=shape, block=block,
                    periodic=self.geometry.periodic,
                    inner_steps=traversal.default_inner_steps(block),
                    shrink=3, n_stages=4,
                )
            jH = tally.reshape(shape) * jfac_scale
            neutral_fraction = ionization.hydrogen_neutral_fraction(
                jH, number_density, cfg.recombination_rate
            )
        return neutral_fraction

    def _two_temperature_coupling(self, u, neutral_fraction):
        """Ionization → gas energy coupling (HydroIntegrator.hpp:1288-1339);
        delegates to the pure op shared with the sharded driver."""
        cfg = self.config
        return hydro.two_temperature_coupling(
            u, neutral_fraction,
            gamma=cfg.gamma,
            ionised_temperature=cfg.ionised_temperature,
            neutral_temperature=cfg.neutral_temperature,
            shock_temperature=cfg.shock_temperature,
            radiative_heating=cfg.radiative_heating,
            radiative_cooling=cfg.radiative_cooling,
        )

    def _gravity_fields(self, u):
        """Total acceleration: static external + live FFT self-gravity."""
        g = self.gravity
        if self.self_gravity:
            from cmacionize_tpu.ops import potentials

            gs = potentials.fft_self_gravity(u.rho, (self.dx,) * 3)
            if g is None:
                g = gs
            else:
                g = tuple(a + b for a, b in zip(g, gs))
        return g

    def _step(self, key, u, neutral_fraction, dt, do_radiation: bool = True):
        cfg = self.config
        key_rad, key_force = jax.random.split(key)
        if do_radiation and cfg.nloop > 0 and (
            self.source_distribution is None
            or len(self.source_distribution.source_set().luminosities) > 0
        ):
            number_density = (
                hydro.primitives_from_conserved(u, cfg.gamma).rho
                / constants.PROTON_MASS
            )
            neutral_fraction = self._radiation_update(
                key_rad, number_density, neutral_fraction)
            u = self._two_temperature_coupling(u, neutral_fraction)
        gravity = self._gravity_fields(u)
        if self.cooling:
            from cmacionize_tpu.ops import derijcke

            u = derijcke.cooling_substep(u, dt, cfg.gamma)
        if self.isothermal_sound_speed is not None:
            u = hydro.isothermal_hydro_step(
                u,
                dt,
                sound_speed=self.isothermal_sound_speed,
                boundaries=cfg.boundaries,
                cell_size=(self.dx,) * 3,
                gravity=gravity,
                inflow_states=self.inflow_states,
            )
        else:
            u = hydro.hydro_step(
                u,
                dt,
                boundaries=cfg.boundaries,
                cell_size=(self.dx,) * 3,
                gamma=cfg.gamma,
                riemann_solver=cfg.riemann_solver,
                gravity=gravity,
                inflow_states=self.inflow_states,
            )
        if self.forcing is not None:
            from cmacionize_tpu.ops import turbulence

            force = self.forcing.force_field(
                key_force, self._forcing_centers())
            u = turbulence.apply_forcing(u, force, dt)
        if self.mask is not None:
            u = hydro.apply_hydro_mask(u, self.mask, self.mask_state)
        return u, neutral_fraction

    def _forcing_centers(self):
        if not hasattr(self, "_centers_cache"):
            self._centers_cache = jnp.asarray(
                self.geometry.cell_centers(), jnp.float32)
        return self._centers_cache

    # ------------------------------------------------------------------- run

    def _log_state(self, tag):
        w = hydro.primitives_from_conserved(self.state, self.config.gamma)
        self.log.info(
            f"{tag} t={self.time / 3.156e13:.4f} Myr "
            f"max|v|={float(jnp.max(jnp.abs(w.vx))):.3g} m/s "
            f"<xH>={float(jnp.mean(self.neutral_fraction)):.3f}"
        )

    def _run_fused_chunks(self, n_steps, dt, log_every):
        """Advance ``n_steps`` at fixed ``dt`` with full fused chunks of the
        FIXED length ``self._chunk_len`` (one XLA compile total) plus a
        per-step remainder; RNG split chain identical to the per-step loop."""
        from cmacionize_tpu.utils import signals

        if self._chunk_jit is None:
            @functools.partial(jax.jit, static_argnames=("length",))
            def run_chunk(key, u, xh, dt, length):
                def body(carry, _):
                    key, u, xh = carry
                    key, sub = jax.random.split(key)
                    u, xh = self._step(sub, u, xh, dt)
                    return (key, u, xh), None

                (key, u, xh), _ = jax.lax.scan(
                    body, (key, u, xh), None, length=length)
                return key, u, xh

            self._chunk_jit = run_chunk
        chunk = self._chunk_len
        done = 0
        next_log = log_every
        while done < n_steps and not signals.stop_requested():
            todo = n_steps - done
            if todo >= chunk:
                self.key, self.state, self.neutral_fraction = self._chunk_jit(
                    self.key, self.state, self.neutral_fraction,
                    jnp.float32(dt), chunk)
                step_count = chunk
            else:
                for _ in range(todo):
                    self.key, subkey = jax.random.split(self.key)
                    self.state, self.neutral_fraction = self._step_jit(
                        subkey, self.state, self.neutral_fraction,
                        jnp.float32(dt))
                step_count = todo
            done += step_count
            self.time += step_count * dt
            if done >= next_log or done == n_steps:
                next_log = done + log_every
                self._log_state(f"step +{done}/{n_steps}")
        if signals.stop_requested():
            self.log.warning("graceful stop requested; exiting time loop")
        return done

    def advance(
        self,
        n_steps: int,
        log_every: int = 50,
        restart_manager=None,
        statistics=None,
        diagnostics=None,
        dt: Optional[float] = None,
    ):
        """Advance ``n_steps`` MORE steps at fixed ``dt`` (default
        ``config.timestep``).

        This is the explicit stepping API (tests/benchmarks); the production
        entry point with CFL-adaptive timesteps, TimeLine stepping, and
        snapshot cadence is :meth:`run`.

        ``restart_manager``: optional io.restart.RestartManager — checkpoints
        are written on its wall-clock cadence and on SIGINT (graceful stop,
        cf. the reference's RestartManager + Signals integration).
        ``statistics``: optional utils.statistics.StatisticsLogger.
        ``diagnostics``: optional utils.diagnostics.IterationDiagnostics —
        per-step counter/phase dumps (forces the per-step path so phases
        are measurable; cf. TaskBasedRadiationHydrodynamicsSimulation's
        per-step diagnostics output).
        """
        from cmacionize_tpu.utils import signals

        signals.install()
        cfg = self.config
        if dt is None:
            dt = cfg.timestep

        # Fused fast path: with no per-step side effects, advance in
        # fixed-size lax.scan chunks — ONE dispatch per chunk instead of one
        # per step, and ONE compile total thanks to the fixed chunk length.
        if (
            self.source_distribution is None
            and restart_manager is None
            and statistics is None
            and diagnostics is None
        ):
            self._run_fused_chunks(n_steps, dt, log_every)
            return self.state, self.neutral_fraction

        for step in range(n_steps):
            self._update_sources()
            self.key, subkey = jax.random.split(self.key)
            if diagnostics is not None:
                with diagnostics.phase("step"):
                    self.state, self.neutral_fraction = self._step_jit(
                        subkey, self.state, self.neutral_fraction,
                        jnp.float32(dt)
                    )
                    jax.block_until_ready(self.state.rho)
                diagnostics.count("steps", 1)
                diagnostics.count(
                    "photons emitted", cfg.n_photons * cfg.nloop)
                diagnostics.end_iteration()
            else:
                self.state, self.neutral_fraction = self._step_jit(
                    subkey, self.state, self.neutral_fraction, jnp.float32(dt)
                )
            self.time += dt
            if (step + 1) % log_every == 0 or step == n_steps - 1:
                w = hydro.primitives_from_conserved(self.state, cfg.gamma)
                self.log.info(
                    f"step {step + 1}/{n_steps} t={self.time / 3.156e13:.4f} Myr "
                    f"max|v|={float(jnp.max(jnp.abs(w.vx))):.3g} m/s "
                    f"<xH>={float(jnp.mean(self.neutral_fraction)):.3f}"
                )
            if statistics is not None:
                statistics.log(self.time, self.state, self.geometry.cell_volume)
            stopping = signals.stop_requested() or (
                restart_manager is not None and restart_manager.want_stop()
            )
            if restart_manager is not None and (restart_manager.due() or stopping):
                self.write_restart(restart_manager)
            if stopping:
                self.log.warning("graceful stop requested; exiting time loop")
                if restart_manager is not None:
                    restart_manager.on_stop()
                break
        return self.state, self.neutral_fraction

    def run(
        self,
        log_every: int = 50,
        restart_manager=None,
        statistics=None,
        diagnostics=None,
        snapshot_callback=None,
        live_output=None,
    ):
        """Run the configured workload to ``total_time``.

        The production time loop, mirroring
        /root/reference/src/RadiationHydrodynamicsSimulation.cpp:489-728:

        - **CFL-driven adaptive timestepping**: ``cfl_timestep`` is
          re-evaluated every fused block (≤ ``_chunk_len`` steps — the
          reference re-evaluates per step; the block granularity is the
          price of scan fusion and is bounded by the 0.2 CFL safety factor)
          and fed through a power-of-two :class:`TimeLine`
          (cf. HydroIntegrator.hpp:1136, TimeLine.hpp:43-230).
        - **Snapshot cadence**: ``snapshot_callback(sim, index)`` fires every
          ``snapshot time`` (default total/10) and once at the end — the
          numbered-snapshot series starbench-class analyses read.
        - **Radiation gating**: with ``radiation_time`` > 0 the MC update
          runs only when due; hydro-only steps use the same jitted step with
          ``do_radiation=False`` (cf. :541 ``hydro_lastrad`` logic).

        For explicit fixed-dt stepping (tests/benchmarks) use
        :meth:`advance`.
        """
        from cmacionize_tpu.utils import signals
        from cmacionize_tpu.utils.timeline import TimeLine

        signals.install()
        cfg = self.config
        total = cfg.total_time
        dt_min = cfg.minimum_timestep or cfg.timestep
        dt_max = cfg.maximum_timestep or cfg.timestep
        snaptime = cfg.snapshot_time if cfg.snapshot_time > 0 else 0.1 * total
        radtime = cfg.radiation_time
        if radtime > 0:
            dt_max = min(dt_max, radtime)
        dt_max = max(dt_max, dt_min)  # an explicit minimum wins over defaults
        timeline = TimeLine(0.0, total, dt_min, dt_max)
        restored = self._restored_timeline
        if restored is not None and restored[2] in (None, total):
            # exact integer tick state (power-of-two alignment preserved)
            timeline._current, timeline._step_ticks = restored[:2]
        elif self.time > 0.0:
            # resumed without timeline state, or with another total time
            # (ticks are fractions of the total): re-enter by time
            timeline.restore(self.time)
        self._timeline = timeline
        if statistics is not None:
            statistics.log(self.time, self.state, self.geometry.cell_volume)

        # statistics stay compatible with fusion: conservation sums are
        # logged once per fused block (≤ _chunk_len steps) instead of the
        # reference's per-step cadence — documented delta, the per-step
        # path (diagnostics/source updates) keeps exact per-step output
        fused_ok = (
            self.source_distribution is None
            and diagnostics is None
            and radtime < 0.0
        )
        # with gravity/forcing the velocity field can change by g·dt within
        # a single step, so the CFL must be re-evaluated EVERY step (the
        # reference does; a 16-step block at the initial v=0 CFL turned the
        # bondi run to NaN): clamp the fused block to one step, and bound
        # dt by the acceleration criterion sqrt(2·CFL·dx/|g|max) so the
        # first kick cannot overshoot either
        has_accel = (
            self.gravity is not None or self.self_gravity
            or self.forcing is not None
        )
        max_block = 1 if has_accel else self._chunk_len
        dt_accel = np.inf
        if self.gravity is not None:
            g_max = max(float(jnp.max(jnp.abs(g))) for g in self.gravity)
            if g_max > 0.0:
                dt_accel = float(np.sqrt(2.0 * cfg.cfl * self.dx / g_max))
        step_num = 0
        while not timeline.finished:
            requested = float(hydro.cfl_timestep(
                self.state, (self.dx,) * 3, cfl=cfg.cfl, gamma=cfg.gamma))
            requested = min(requested, dt_accel)
            dt = timeline.set_timestep(min(requested, dt_max))
            if dt > requested * 1.01:
                self.log.warning(
                    f"CFL violation: minimum timestep {dt:.3e} s exceeds "
                    f"CFL-limited {requested:.3e} s")
            # steps until the next snapshot threshold / the end, at this dt
            remaining = max(total - self.time, 0.0)
            n_to_end = max(int(np.ceil(remaining / dt - 1e-9)), 1)
            t_snap = self._lastsnap * snaptime
            n_to_snap = (
                max(int(np.ceil((t_snap - self.time) / dt - 1e-9)), 1)
                if snapshot_callback is not None else n_to_end
            )
            if live_output is not None:
                # clamp blocks to the live-output cadence as well
                t_live = live_output.output_interval * live_output.next_output
                n_to_snap = min(n_to_snap, max(
                    int(np.ceil((t_live - self.time) / dt - 1e-9)), 1))
            if fused_ok:
                n_block = min(max_block, n_to_snap, n_to_end)
                self._run_fused_chunks(n_block, dt, log_every=10**9)
                if statistics is not None:  # self.time already advanced
                    statistics.log(
                        self.time, self.state, self.geometry.cell_volume)
            else:
                rad_due = radtime < 0.0 or self.time >= self._lastrad * radtime
                if rad_due and radtime > 0.0:
                    self._lastrad += 1
                n_block = 1
                if rad_due:
                    # restart handling stays in this loop (not advance's)
                    self.advance(
                        1, log_every=10**9, statistics=statistics,
                        diagnostics=diagnostics, dt=dt,
                    )
                else:
                    self._hydro_only_step(dt)
                    if statistics is not None:
                        statistics.log(
                            self.time, self.state, self.geometry.cell_volume)
            for _ in range(n_block):
                timeline.advance()
            # keep host time in exact agreement with the tick timeline
            # (float accumulation would drift over thousands of steps)
            self.time = timeline.current_time
            step_num += n_block
            if step_num % log_every < n_block:
                self._log_state(f"step {step_num}")
            if (
                snapshot_callback is not None
                and self._lastsnap * snaptime <= self.time
                and not timeline.finished
            ):
                snapshot_callback(self, self._lastsnap)
                self._lastsnap += 1
            if live_output is not None:
                # in-flight reduced outputs (LiveOutputManager cadence,
                # cf. TaskBasedRadiationHydrodynamicsSimulation.cpp:2124-2148)
                live_output.maybe_output(
                    self.state, self.neutral_fraction, self.time, cfg.gamma)
            stopping = signals.stop_requested() or (
                restart_manager is not None and restart_manager.want_stop())
            if restart_manager is not None and (
                    restart_manager.due() or stopping):
                self.write_restart(restart_manager)
                if stopping:
                    restart_manager.on_stop()
            if stopping:
                self.log.warning("graceful stop requested; exiting time loop")
                break
        if snapshot_callback is not None and timeline.finished:
            snapshot_callback(self, self._lastsnap)
            self._lastsnap += 1
        return self.state, self.neutral_fraction

    def _update_sources(self):
        """Time-dependent source population update + SN stellar feedback
        (RadiationHydrodynamicsSimulation.cpp:529-535).  Called EVERY step
        — the reference's add_stellar_feedback is independent of the
        radiation gate, so hydro-only (radiation_time-gated) steps deposit
        SN energy too (round-4 advisor finding)."""
        if self.source_distribution is None:
            return
        changed = self.source_distribution.update(self.time)
        if changed:
            # source set rebaked
            self._step_jit = jax.jit(
                self._step, static_argnames=("do_radiation",))
        if self.stellar_feedback:
            from cmacionize_tpu.models.source_distributions import (
                deposit_supernova_energy,
            )

            sne = self.source_distribution.pop_supernovae()
            if sne:
                # accumulate in f64 (1e44 J overflows f32) and add as
                # an energy density
                e_sn = getattr(self.source_distribution, "energy", None)
                kwargs = {} if e_sn is None else {
                    "energy_per_sn": float(e_sn)}
                injected = deposit_supernova_energy(
                    np.zeros(self.geometry.shape, np.float64),
                    sne, self.geometry, **kwargs,
                )
                self.state = self.state._replace(
                    energy=self.state.energy + jnp.asarray(
                        injected / self.geometry.cell_volume,
                        self.state.energy.dtype,
                    )
                )
                self.log.info(
                    f"injected {len(sne)} supernova(e) at "
                    f"t={self.time:.3e} s")

    def _hydro_only_step(self, dt):
        """One step with the radiation update gated off (radiation_time
        cadence, RadiationHydrodynamicsSimulation.cpp:540-571).  Source
        updates and stellar feedback still run (the reference applies them
        every step, independent of the gate)."""
        self._update_sources()
        self.key, subkey = jax.random.split(self.key)
        self.state, self.neutral_fraction = self._step_jit(
            subkey, self.state, self.neutral_fraction, jnp.float32(dt),
            do_radiation=False)
        self.time += dt

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        arrays = {
            "rho": self.state.rho,
            "mom_x": self.state.mom_x,
            "mom_y": self.state.mom_y,
            "mom_z": self.state.mom_z,
            "energy": self.state.energy,
            "neutral_fraction": self.neutral_fraction,
            "rng_key": jax.random.key_data(self.key),
        }
        scalars = {
            "time": self.time,
            "lastsnap": self._lastsnap,
            "lastrad": self._lastrad,
        }
        if self._timeline is not None:
            scalars["timeline_ticks"] = self._timeline._current
            scalars["timeline_step_ticks"] = self._timeline._step_ticks
            scalars["timeline_end"] = self._timeline._t_end
        return manager.write(arrays, scalars)

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager
        from cmacionize_tpu.ops.hydro import HydroState

        arrays, scalars = RestartManager.load(filename)
        self.state = HydroState(
            rho=jnp.asarray(arrays["rho"]),
            mom_x=jnp.asarray(arrays["mom_x"]),
            mom_y=jnp.asarray(arrays["mom_y"]),
            mom_z=jnp.asarray(arrays["mom_z"]),
            energy=jnp.asarray(arrays["energy"]),
        )
        self.neutral_fraction = jnp.asarray(arrays["neutral_fraction"])
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.time = float(scalars["time"])
        self._lastsnap = int(scalars.get("lastsnap", 1))
        self._lastrad = int(scalars.get("lastrad", 0))
        if "timeline_ticks" in scalars:
            self._restored_timeline = (
                int(scalars["timeline_ticks"]),
                int(scalars["timeline_step_ticks"]),
                scalars.get("timeline_end"),
            )

    # ------------------------------------------------------------- analysis

    def ionization_front_radius(self) -> float:
        """Radius of the ionized region around the source (m)."""
        xH = np.asarray(self.neutral_fraction)
        v_ion = float((xH < 0.5).sum()) * self.geometry.cell_volume
        # source at a box corner with reflective boundaries → the box models
        # one octant of the full sphere
        corner = all(
            abs(g) < 1e-6 or abs(g - s) < 1e-6
            for g, s in zip(self._source_gpos, self.geometry.shape)
        )
        if corner:
            v_ion *= 8.0
        return (3.0 * v_ion / (4.0 * np.pi)) ** (1.0 / 3.0)


class ShardedRHDSimulation(RHDSimulation):
    """Domain-decomposed RHD driver: x-slab grid sharding over a device
    mesh, the FULL coupled step (radiation superstep exchange +
    two-temperature coupling + halo-exchange hydro) fused into one sharded
    XLA program per step (parallel.domain.make_domain_rhd_step).

    The distributed radiation-hydro integration the reference designed as
    one task graph (/root/reference/src/
    TaskBasedRadiationHydrodynamicsSimulation.cpp:1546-2122) but only ever
    ran shared-memory.  Mirrors the RHDSimulation interface (advance / run /
    restart); results match the single-device driver to Monte Carlo noise
    (the per-device RNG key split chain necessarily differs).

    Round-5 envelope: structured ICs (any
    DensityFunction type), external-potential gravity, BlockSyntax hydro
    masks, and spatially-varying inflow boundaries (Bondi) run sharded —
    the bondi benchmark distributes.  Emission is source-replicated across
    slabs (copy trace + psum reduction onto the owner) and every radiation
    trace uses the width-compacting cascade; ``advance`` runs 16-step
    scan-fused chunks like the single-device parent.  Still single-device
    only: spectral turbulence forcing, FFT self-gravity, time-dependent
    source populations (NotImplementedError).
    """

    def __init__(self, config: RHDConfig, tiling=None,
                 log: Optional[Log] = None, seed: int = 42, **kwargs):
        unsupported = [
            name for name in ("forcing", "source_distribution")
            if kwargs.get(name) is not None
        ]
        unsupported += [
            name for name in ("self_gravity", "stellar_feedback")
            if kwargs.get(name)
        ]
        if unsupported:
            raise NotImplementedError(
                "ShardedRHDSimulation does not support: "
                + ", ".join(unsupported)
                + " (run single-device, or extend the sharded step)")
        super().__init__(config, log=log, seed=seed, **{
            k: v for k, v in kwargs.items() if k in (
                "cooling", "isothermal_sound_speed", "initial", "gravity",
                "mask", "mask_state", "inflow_states")
        })
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from cmacionize_tpu.parallel import domain
        from cmacionize_tpu.parallel.mesh import make_mesh

        if tiling is None:
            tiling = (len(_jax.devices()), 1, 1)
        tiling = tuple(int(t) for t in tiling)
        if tiling[1] != 1 or tiling[2] != 1:
            raise NotImplementedError(
                "the sharded RHD driver shards x-slabs; use tiling [N, 1, 1]")
        self.tiling = tiling
        self.n_devices = tiling[0]
        self.mesh = make_mesh(self.n_devices, axis_names=("x",))
        cfg = config
        nx, ny, nz = self.geometry.shape
        if nx % self.n_devices:
            raise ValueError(
                f"grid x = {nx} must divide over {self.n_devices} devices")
        nx_loc = nx // self.n_devices
        sigma_dx = cfg.cross_section * self.dx
        jfac_scale = (
            cfg.luminosity * cfg.cross_section * self.dx
            / (cfg.n_photons * self.geometry.cell_volume)
        )
        coupling = dict(
            ionised_temperature=cfg.ionised_temperature,
            neutral_temperature=cfg.neutral_temperature,
            shock_temperature=cfg.shock_temperature,
            radiative_heating=cfg.radiative_heating,
            radiative_cooling=cfg.radiative_cooling,
        )

        # ---- optional-physics inputs: sharded extras pytree + x-edge
        # inflow closure (see make_domain_rhd_step's envelope docs)
        field_sharding = NamedSharding(self.mesh, P("x"))
        extras = {}
        extras_specs = {}
        if self.gravity is not None:
            extras["gravity"] = tuple(
                jax.device_put(g, field_sharding) for g in self.gravity)
            extras_specs["gravity"] = (P("x"),) * 3
        if self.mask is not None:
            extras["mask"] = jax.device_put(self.mask, field_sharding)
            extras["mask_state"] = hydro.HydroState(*(
                jax.device_put(f, field_sharding) for f in self.mask_state))
            extras_specs["mask"] = P("x")
            extras_specs["mask_state"] = hydro.HydroState(*([P("x")] * 5))
        inflow_x = None
        if self.inflow_states:
            def _full(value, shape):
                arr = jnp.asarray(value, jnp.float32)
                return jnp.broadcast_to(arr, shape) if arr.ndim == 0 else arr

            ghost_shapes = {
                (0, "lo"): (2, ny, nz), (0, "hi"): (2, ny, nz),
                (1, "lo"): (nx + 4, 2, nz), (1, "hi"): (nx + 4, 2, nz),
                (2, "lo"): (nx + 4, ny + 4, 2), (2, "hi"): (nx + 4, ny + 4, 2),
            }
            inflow_x = {}
            inflow_yz = {}
            for (ax, side), fields in self.inflow_states.items():
                full = tuple(
                    _full(f, ghost_shapes[(ax, side)]) for f in fields)
                if ax == 0:
                    # identical on all devices (edge devices apply it)
                    inflow_x[side] = full
                else:
                    # per-device x-slices of the padded-lattice profile,
                    # matching the post-halo-exchange field shape
                    stacked = tuple(
                        jax.device_put(jnp.stack([
                            f[d * nx_loc:d * nx_loc + nx_loc + 4]
                            for d in range(self.n_devices)
                        ]), field_sharding)
                        for f in full
                    )
                    inflow_yz[(ax, side)] = stacked
            if not inflow_x:
                inflow_x = None
            if inflow_yz:
                extras["inflow_yz"] = inflow_yz
                extras_specs["inflow_yz"] = {
                    k: (P("x"),) * 5 for k in inflow_yz
                }
        self._extras = extras

        self._factory_kwargs = dict(
            global_shape=self.geometry.shape,
            boundaries=cfg.boundaries,
            cell_size=(self.dx,) * 3,
            gamma=cfg.gamma,
            n_photons=cfg.n_photons,
            sigma_dx=sigma_dx,
            source_gpos=self._source_gpos,
            jfac_scale=jfac_scale,
            alpha=cfg.recombination_rate,
            coupling=coupling,
            riemann_solver=cfg.riemann_solver,
            isothermal_sound_speed=self.isothermal_sound_speed,
            cooling=self.cooling,
            extras_specs=extras_specs,
            inflow_x=inflow_x,
        )
        self._rhd_step, self._shardings = domain.make_domain_rhd_step(
            self.mesh, nloop=cfg.nloop, **self._factory_kwargs)
        # radiation-gated variant (radiation_time cadence, and the CLI's
        # hydro-only problems): same program with nloop = 0
        self._rhd_step_norad, _ = domain.make_domain_rhd_step(
            self.mesh, nloop=0, **self._factory_kwargs)
        # scan-fused multi-step chunk (built lazily on first long advance)
        self._rhd_chunk = None
        self._cfl_fn = domain.domain_cfl_timestep(
            self.mesh, cell_size=(self.dx,) * 3, gamma=cfg.gamma,
            cfl=cfg.cfl)
        self._reshard()
        self.last_diagnostics = None

    def _reshard(self):
        put = functools.partial(
            jax.device_put, device=self._shardings["field"])
        self.state = hydro.HydroState(*(put(f) for f in self.state))
        self.neutral_fraction = put(self.neutral_fraction)

    def _split_keys(self):
        self.key, subkey = jax.random.split(self.key)
        return jax.device_put(
            jax.random.split(subkey, self.n_devices),
            self._shardings["keys"],
        )

    def _sharded_step(self, dt, do_radiation=True):
        keys = self._split_keys()
        step = self._rhd_step if do_radiation else self._rhd_step_norad
        self.state, self.neutral_fraction, diag = step(
            keys, self.state, self.neutral_fraction, self._extras,
            jnp.float32(dt))
        return diag

    def _check_diag(self, diag):
        self.last_diagnostics = {
            k: int(diag[k])
            for k in ("n_escaped", "buffer_overflow", "truncated_live")
        }
        self.last_diagnostics["packets_traced"] = np.asarray(
            diag["packets_traced"])
        if self.last_diagnostics["buffer_overflow"]:
            self.log.warning(
                "exchange buffer overflow: "
                f"{self.last_diagnostics['buffer_overflow']} packets")
        if self.last_diagnostics["truncated_live"]:
            self.log.warning(
                "superstep cap hit with "
                f"{self.last_diagnostics['truncated_live']} packets live")

    def _run_fused_chunks(self, n_steps, dt, log_every):
        """Advance in scan-fused sharded chunks (ONE dispatch per
        ``_chunk_len`` steps, mirroring the single-device parent) plus a
        per-step remainder."""
        from cmacionize_tpu.parallel import domain
        from cmacionize_tpu.utils import signals

        chunk = self._chunk_len
        if self._rhd_chunk is None and n_steps >= chunk:
            self._rhd_chunk, _ = domain.make_domain_rhd_step(
                self.mesh, nloop=self.config.nloop, chunk_len=chunk,
                **self._factory_kwargs)
        next_log = log_every
        done = 0
        while done < n_steps and not signals.stop_requested():
            todo = n_steps - done
            if todo >= chunk and self._rhd_chunk is not None:
                keys = self._split_keys()
                self.state, self.neutral_fraction, diag = self._rhd_chunk(
                    keys, self.state, self.neutral_fraction, self._extras,
                    jnp.float32(dt))
                step_count = chunk
            else:
                diag = self._sharded_step(dt)
                step_count = 1
            done += step_count
            self.time += step_count * dt
            if done >= next_log or done == n_steps:
                next_log = done + log_every
                self._check_diag(diag)
                self._log_state(f"step +{done}/{n_steps}")
        if signals.stop_requested():
            self.log.warning("graceful stop requested; exiting time loop")
        return done

    def advance(self, n_steps, log_every=50, restart_manager=None,
                statistics=None, diagnostics=None, dt=None):
        from cmacionize_tpu.utils import signals

        signals.install()
        cfg = self.config
        if dt is None:
            dt = cfg.timestep
        if restart_manager is None and statistics is None \
                and diagnostics is None:
            self._run_fused_chunks(n_steps, dt, log_every)
            return self.state, self.neutral_fraction
        for step in range(n_steps):
            if diagnostics is not None:
                with diagnostics.phase("step"):
                    diag = self._sharded_step(dt)
                    jax.block_until_ready(self.state.rho)
                diagnostics.count("steps", 1)
                diagnostics.end_iteration()
            else:
                diag = self._sharded_step(dt)
            self._check_diag(diag)
            self.time += dt
            if (step + 1) % log_every == 0 or step == n_steps - 1:
                self._log_state(f"step {step + 1}/{n_steps}")
            if statistics is not None:
                statistics.log(
                    self.time, self.state, self.geometry.cell_volume)
            stopping = signals.stop_requested() or (
                restart_manager is not None and restart_manager.want_stop())
            if restart_manager is not None and (
                    restart_manager.due() or stopping):
                self.write_restart(restart_manager)
            if stopping:
                self.log.warning("graceful stop requested; exiting time loop")
                if restart_manager is not None:
                    restart_manager.on_stop()
                break
        return self.state, self.neutral_fraction

    def _hydro_only_step(self, dt):
        self._sharded_step(dt, do_radiation=False)
        self.time += dt

    @classmethod
    def from_params(cls, params, tiling=None, log=None, seed: int = 42):
        """Parameter-file constructor: build the single-device driver via
        RHDSimulation.from_params' parsing, then shard it — including its
        fully-constructed initial state, so ANY DensityFunction type
        (BlockSyntax, BondiProfile, snapshots, …) survives the sharding
        (round-4 advisor finding: ``initial=None`` silently replaced
        structured ICs with the background density)."""
        base = RHDSimulation.from_params(params, log=log, seed=seed)
        sim = cls(
            base.config, tiling=tiling, log=log, seed=seed,
            cooling=base.cooling,
            isothermal_sound_speed=base.isothermal_sound_speed,
            gravity=base.gravity,
            self_gravity=base.self_gravity,
            forcing=base.forcing,
            mask=base.mask,
            mask_state=base.mask_state,
            inflow_states=base.inflow_states,
            source_distribution=base.source_distribution,
            stellar_feedback=base.stellar_feedback,
        )
        sim.state = base.state
        sim.neutral_fraction = base.neutral_fraction
        sim._reshard()
        return sim

    def load_restart(self, filename: str) -> None:
        super().load_restart(filename)
        self._reshard()


def spitzer_radius(t, stromgren_radius, sound_speed_ionized=12.85e3):
    """Spitzer D-type expansion law R(t) = R_St (1 + 7 c_i t / (4 R_St))^{4/7}
    (Bisbas et al. 2015 starbench, eq. 4)."""
    return stromgren_radius * (
        1.0 + 7.0 * sound_speed_ionized * t / (4.0 * stromgren_radius)
    ) ** (4.0 / 7.0)


def hosokawa_inutsuka_radius(t, stromgren_radius, sound_speed_ionized=12.85e3):
    """Hosokawa-Inutsuka expansion law (Bisbas et al. 2015, eq. 5)."""
    return stromgren_radius * (
        1.0
        + 7.0 * sound_speed_ionized * t / (4.0 * stromgren_radius) * np.sqrt(4.0 / 3.0)
    ) ** (4.0 / 7.0)
