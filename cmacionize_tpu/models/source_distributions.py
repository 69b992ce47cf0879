"""Time-dependent photon source distributions.

JAX equivalents of the reference's evolving PhotonSourceDistribution
family (/root/reference/src/PhotonSourceDistributionFactory.hpp:106-128):

- SILCCSourceDistribution   (SILCCPhotonSourceDistribution.hpp) — static
  population, uniform in a rectangular xy-disc, Gaussian in z.
- DiscPatchSourceDistribution (DiscPatchPhotonSourceDistribution.hpp) —
  birth/death population in the same geometry with an `update(t)` hook.
- DwarfGalaxySourceDistribution (DwarfGalaxyPhotonSourceDistribution.hpp) —
  birth/death population with a 3D-Gaussian spatial profile.
- SingleSupernovaSourceDistribution (SingleSupernovaPhotonSourceDistribution
  .hpp) — one source that explodes at the end of its life, injecting SN
  energy through the stellar-feedback hook.
- CaproniSourceDistribution (CaproniPhotonSourceDistribution.hpp) — the full
  dwarf-galaxy model: stellar number function and SN galactocentric radii
  from polynomial fits to Caproni et al. (2017), stellar lifetimes from Tang
  et al. (2014), UV luminosities from Sternberg et al. (2003), IMF power-law
  mass sampling; sources above the SN mass limit explode when their
  lifetime runs out.
- AsciiFileTableSourceDistribution (AsciiFileTablePhotonSourceDistribution
  .hpp) — a table of (time, source-list-file) rows; the active list switches
  as simulation time passes each entry.

Design note: population bookkeeping is a host-side (numpy) process — the
populations are tiny (tens of sources) and change only between radiation
supersteps, exactly like the reference updates them between steps of the
TimeLine. The hot path (packet emission) consumes the current population as
a DiscreteSourceSet → emit_source_set, which is fully vectorized JAX.

Stellar feedback mirrors the reference: each SN deposits
`boost_factor * 1e44 J` (CaproniPhotonSourceDistribution.hpp:669-679) into
the energy-rate accumulator of the cell containing the explosion.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from cmacionize_tpu.models.sources import DiscreteSourceSet

#: canonical SN energy injected per explosion (J) — 1e51 erg, the value
#: hard-coded at CaproniPhotonSourceDistribution.hpp:678.
SN_ENERGY = 1.0e44


class SourceDistribution:
    """Base: a (possibly evolving) population of discrete UV sources."""

    def update(self, simulation_time: float) -> bool:
        """Advance the population to `simulation_time` (s).

        Returns True if the source list changed (the caller should re-emit
        its source set). Mirrors PhotonSourceDistribution::update.
        """
        return False

    def pop_supernovae(self) -> List[np.ndarray]:
        """Positions (SI) of SNe that exploded since the last call.

        The stellar-feedback half of the reference's
        `add_stellar_feedback(grid, time)` hook; pair with
        `deposit_supernova_energy`.
        """
        return []

    def source_set(self) -> DiscreteSourceSet:
        raise NotImplementedError

    @property
    def total_luminosity(self) -> float:
        return self.source_set().total_luminosity


def _gaussian(rng: np.random.Generator, n: int = 1) -> np.ndarray:
    """Standard normals via Box-Muller, matching the reference's sampling
    (SILCCPhotonSourceDistribution.hpp:get_position)."""
    u1 = rng.uniform(size=n)
    u2 = rng.uniform(size=n)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@dataclasses.dataclass
class SILCCSourceDistribution(SourceDistribution):
    """Static population: uniform in a rectangular xy patch, Gaussian in z
    (SILCCPhotonSourceDistribution.hpp:44-240; defaults :128-162)."""

    num_sources: int = 24
    anchor_x: float = -3.086e19  # -1 kpc
    sides_x: float = 6.172e19
    anchor_y: float = -3.086e19
    sides_y: float = 6.172e19
    origin_z: float = 0.0
    scaleheight_z: float = 1.9444e18  # 63 pc
    luminosity: float = 3.125e49
    seed: int = 42

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        x = self.anchor_x + rng.uniform(size=self.num_sources) * self.sides_x
        y = self.anchor_y + rng.uniform(size=self.num_sources) * self.sides_y
        z = self.origin_z + self.scaleheight_z * _gaussian(rng, self.num_sources)
        self._positions = np.stack([x, y, z], axis=1)

    def source_set(self) -> DiscreteSourceSet:
        return DiscreteSourceSet(
            self._positions, np.full(self.num_sources, self.luminosity)
        )


class _BirthDeathDistribution(SourceDistribution):
    """Shared machinery of DiscPatch/DwarfGalaxy: a population where each of
    `average_number` slots spawns a source with probability
    update_interval/lifetime per update, and sources die after `lifetime`
    (DiscPatchPhotonSourceDistribution.hpp:347-405)."""

    def __init__(self, lifetime, luminosity, average_number, seed,
                 update_interval, starting_time):
        self.lifetime = float(lifetime)
        self.luminosity = float(luminosity)
        self.average_number = int(average_number)
        self.update_interval = float(update_interval)
        self.probability = self.update_interval / self.lifetime
        self._rng = np.random.default_rng(seed)
        self._positions: List[np.ndarray] = []
        self._lifetimes: List[float] = []
        self._number_of_updates = 1
        # initial population: average_number sources with uniformly-sampled
        # remaining lifetimes (DiscPatchPhotonSourceDistribution.hpp:156-162)
        for _ in range(self.average_number):
            self._positions.append(self._sample_position())
            self._lifetimes.append(self._rng.uniform() * self.lifetime)
        self.update(starting_time)

    def _sample_position(self) -> np.ndarray:
        raise NotImplementedError

    def update(self, simulation_time: float) -> bool:
        changed = False
        while self._number_of_updates * self.update_interval <= simulation_time:
            keep_p, keep_l = [], []
            for pos, life in zip(self._positions, self._lifetimes):
                life -= self.update_interval
                if life <= 0.0:
                    changed = True
                else:
                    keep_p.append(pos)
                    keep_l.append(life)
            self._positions, self._lifetimes = keep_p, keep_l
            for _ in range(self.average_number):
                if self._rng.uniform() <= self.probability:
                    # born at a random time within the elapsed interval
                    offset = self._rng.uniform() * self.update_interval
                    self._positions.append(self._sample_position())
                    self._lifetimes.append(self.lifetime - offset)
                    changed = True
            self._number_of_updates += 1
        return changed

    def source_set(self) -> DiscreteSourceSet:
        n = len(self._positions)
        if n == 0:
            return DiscreteSourceSet(np.zeros((0, 3)), np.zeros(0))
        return DiscreteSourceSet(
            np.stack(self._positions), np.full(n, self.luminosity)
        )


class DiscPatchSourceDistribution(_BirthDeathDistribution):
    """Evolving disc-patch population
    (DiscPatchPhotonSourceDistribution.hpp:43-519). Defaults follow the
    parameter-file defaults (:252-286)."""

    def __init__(self, lifetime=6.31152e14, luminosity=1e49, average_number=24,
                 anchor_x=-3.086e19, sides_x=6.172e19, anchor_y=-3.086e19,
                 sides_y=6.172e19, origin_z=0.0, scaleheight_z=1.9444e18,
                 seed=42, update_interval=3.1536e12, starting_time=0.0):
        self.anchor_x, self.sides_x = anchor_x, sides_x
        self.anchor_y, self.sides_y = anchor_y, sides_y
        self.origin_z, self.scaleheight_z = origin_z, scaleheight_z
        super().__init__(lifetime, luminosity, average_number, seed,
                         update_interval, starting_time)

    def _sample_position(self) -> np.ndarray:
        x = self.anchor_x + self._rng.uniform() * self.sides_x
        y = self.anchor_y + self._rng.uniform() * self.sides_y
        z = self.origin_z + self.scaleheight_z * _gaussian(self._rng, 1)[0]
        return np.array([x, y, z])


class DwarfGalaxySourceDistribution(_BirthDeathDistribution):
    """Evolving population with an isotropic 3D-Gaussian profile
    (DwarfGalaxyPhotonSourceDistribution.hpp:42-386)."""

    def __init__(self, lifetime=6.31152e14, luminosity=1e49, average_number=24,
                 center=(0.0, 0.0, 0.0), scale_radius=9.258e18, seed=42,
                 update_interval=3.1536e12, starting_time=0.0):
        self.center = np.asarray(center, dtype=float)
        self.scale_radius = float(scale_radius)
        super().__init__(lifetime, luminosity, average_number, seed,
                         update_interval, starting_time)

    def _sample_position(self) -> np.ndarray:
        return self.center + self.scale_radius * _gaussian(self._rng, 3)


@dataclasses.dataclass
class SingleSupernovaSourceDistribution(SourceDistribution):
    """A single source that shines until `lifetime`, then explodes once
    (SingleSupernovaPhotonSourceDistribution.hpp:40-200)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    lifetime: float = 3.1536e14  # 10 Myr
    luminosity: float = 1e49
    energy: float = 1e44  # J (1e51 erg)

    def __post_init__(self):
        self._has_exploded = False
        self._pending_sn: List[np.ndarray] = []

    def update(self, simulation_time: float) -> bool:
        if not self._has_exploded and simulation_time >= self.lifetime:
            self._has_exploded = True
            self._pending_sn.append(np.asarray(self.position, dtype=float))
            return True
        return False

    def pop_supernovae(self) -> List[np.ndarray]:
        out, self._pending_sn = self._pending_sn, []
        return out

    def source_set(self) -> DiscreteSourceSet:
        if self._has_exploded or self.luminosity <= 0.0:
            return DiscreteSourceSet(np.zeros((0, 3)), np.zeros(0))
        return DiscreteSourceSet.single(self.position, self.luminosity)


class CaproniSourceDistribution(SourceDistribution):
    """Dwarf-galaxy stellar population after Caproni et al. (2017)
    (CaproniPhotonSourceDistribution.hpp:61-700).

    Massive stars (M > SN mass limit) are spawned so the population tracks a
    polynomial fit N(t) to the Caproni simulation; masses follow a power-law
    IMF; each star lives for its Tang et al. (2014) lifetime, shines with
    its Sternberg et al. (2003) UV luminosity if above the OB mass limit,
    and its position is drawn at a galactocentric radius following a
    polynomial fit to the Caproni SN locations. Expired stars explode as SNe.
    """

    # polynomial for the expected number of massive stars vs time (s)
    # (CaproniPhotonSourceDistribution.hpp:get_number_of_stars)
    _NSTAR_COEFFS = (
        -4.0728750557e-145, 1.56644058448e-127, -2.49066778113e-110,
        2.1349428803e-93, -1.07057674726e-76, 3.15595029622e-60,
        -5.09080808197e-44, 3.44307404864e-28, 2.21557198304e-13,
        431.31515864,
    )
    # polynomial for the average galactocentric SN radius vs time (s → m)
    _RADIUS_COEFFS = (
        -2.6765175763e-128, 7.3980382167e-111, -8.44806044068e-94,
        5.14530890285e-77, -1.79963859431e-60, 3.62542751726e-44,
        -4.00468400669e-28, 2.14263386338e-12, -2968.65760812,
        5.693802974e18,
    )
    # double power-law stellar lifetime fit, M in Msol → s (Tang et al. 2014)
    _LIFETIME_COEFFS = (7.55609422e13, 1.03371798e16, -1.31168267,
                        1.11162246e18, -3.81030835)
    # cubic UV luminosity fit, M in Msol → s^-1 (Sternberg et al. 2003)
    _UV_COEFFS = (-8.85154170718e43, 2.21555601476e46, -4.25455875963e47,
                  8.55819263554e47)

    def __init__(self, number_function_norm=1.0, uv_luminosity_norm=1.0,
                 sn_mass_limit_msol=8.0, ob_mass_limit_msol=20.0,
                 stellar_mass_limit_msol=100.0, imf_slope=-2.3, seed=42,
                 update_interval=3.1536e13, starting_time=0.0,
                 boost_factor=1.0):
        self.number_function_norm = float(number_function_norm)
        self.uv_luminosity_norm = float(uv_luminosity_norm)
        self.ob_mass_limit_msol = float(ob_mass_limit_msol)
        self.boost_factor = float(boost_factor)
        # the reference caps the interval at 9.9e13 s to keep the population
        # update resolution below the shortest stellar lifetime (:454)
        self.update_interval = min(float(update_interval), 9.9e13)
        # IMF inverse-CDF constants (get_random_stellar_mass)
        a1 = imf_slope + 1.0
        self._imf_A = sn_mass_limit_msol**a1
        self._imf_B = stellar_mass_limit_msol**a1 - self._imf_A
        self._imf_C = 1.0 / a1
        self._rng = np.random.default_rng(seed)
        self._positions: List[np.ndarray] = []
        self._lifetimes: List[float] = []
        self._luminosities: List[float] = []
        self._pending_sn: List[np.ndarray] = []
        self._number_of_updates = 1
        # spin up the initial population at t=0 with randomized ages
        # (the reference evolves from t=0 to starting_time; :497-520)
        n0 = int(self.number_function_norm * self._n_stars(0.0))
        for _ in range(n0):
            self._spawn(age_randomized=True)
        self.update(starting_time)

    def _horner(self, coeffs, t):
        result = coeffs[0]
        for c in coeffs[1:]:
            result = result * t + c
        return result

    def _n_stars(self, t: float) -> int:
        return max(0, int(self._horner(self._NSTAR_COEFFS, t)))

    def stellar_lifetime(self, m_msol: float) -> float:
        la = self._LIFETIME_COEFFS
        return la[0] + la[1] * m_msol ** la[2] + la[3] * m_msol ** la[4]

    def stellar_uv_luminosity(self, m_msol: float) -> float:
        if m_msol < self.ob_mass_limit_msol:
            return 0.0
        return self._horner(self._UV_COEFFS, m_msol)

    def random_stellar_mass(self) -> float:
        return (self._imf_A + self._imf_B * self._rng.uniform()) ** self._imf_C

    def _sample_position(self, t: float) -> np.ndarray:
        r = self._horner(self._RADIUS_COEFFS, t) + 3.086e18 * _gaussian(
            self._rng, 1)[0]
        cost = 2.0 * self._rng.uniform() - 1.0
        sint = np.sqrt(max(1.0 - cost * cost, 0.0))
        phi = 2.0 * np.pi * self._rng.uniform()
        return r * np.array([sint * np.cos(phi), sint * np.sin(phi), cost])

    def _spawn(self, age_randomized: bool = False) -> None:
        m = self.random_stellar_mass()
        lifetime = self.stellar_lifetime(m)
        if age_randomized:
            lifetime *= self._rng.uniform()
        else:
            lifetime -= self._rng.uniform() * self.update_interval
        self._positions.append(self._sample_position(0.0))
        self._lifetimes.append(lifetime)
        self._luminosities.append(
            self.uv_luminosity_norm * self.stellar_uv_luminosity(m))

    def update(self, simulation_time: float) -> bool:
        changed = False
        while self._number_of_updates * self.update_interval <= simulation_time:
            total_time = self._number_of_updates * self.update_interval
            keep_p, keep_l, keep_lum = [], [], []
            for pos, life, lum in zip(self._positions, self._lifetimes,
                                      self._luminosities):
                life -= self.update_interval
                if life <= 0.0:
                    self._pending_sn.append(pos)
                    changed = True
                else:
                    keep_p.append(pos)
                    keep_l.append(life)
                    keep_lum.append(lum)
            self._positions, self._lifetimes, self._luminosities = (
                keep_p, keep_l, keep_lum)
            target = int(self.number_function_norm * self._n_stars(total_time))
            while len(self._positions) < target:
                self._spawn()
                changed = True
            self._number_of_updates += 1
        return changed

    def pop_supernovae(self) -> List[np.ndarray]:
        out, self._pending_sn = self._pending_sn, []
        return out

    def source_set(self) -> DiscreteSourceSet:
        lum = np.asarray(self._luminosities, dtype=float)
        active = lum > 0.0
        if not np.any(active):
            return DiscreteSourceSet(np.zeros((0, 3)), np.zeros(0))
        return DiscreteSourceSet(
            np.stack(self._positions)[active], lum[active])


class AsciiFileTableSourceDistribution(SourceDistribution):
    """Source lists switched over time from a table file
    (AsciiFileTablePhotonSourceDistribution.hpp/.cpp).

    The table file lists `time  source_list_filename` rows ('#' comments);
    each source-list file has `x y z luminosity` rows (SI). The list whose
    time is the latest one ≤ simulation time is active.
    """

    def __init__(self, table_filename: str, starting_time: float = 0.0):
        times, files = [], []
        with open(table_filename) as handle:
            for line in handle:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, fname = line.split(None, 1)
                times.append(float(t))
                files.append(fname.strip())
        if not times:
            raise ValueError(f"no entries in source table {table_filename}")
        order = np.argsort(times)
        self._times = np.asarray(times)[order]
        self._files = [files[i] for i in order]
        self._active_index = -1
        self.update(starting_time)

    def update(self, simulation_time: float) -> bool:
        idx = int(np.searchsorted(self._times, simulation_time, "right") - 1)
        idx = max(idx, 0)
        if idx != self._active_index:
            self._active_index = idx
            self._active_set = DiscreteSourceSet.from_ascii(self._files[idx])
            return True
        return False

    def source_set(self) -> DiscreteSourceSet:
        return self._active_set


def deposit_supernova_energy(energy_rate, sn_positions, geometry,
                             energy_per_sn: float = SN_ENERGY,
                             boost_factor: float = 1.0):
    """Add SN energy to the cells containing the explosions.

    `energy_rate` is the per-cell energy accumulator field [nx,ny,nz] the RHD
    step applies as a source term; mirrors
    CaproniPhotonSourceDistribution.hpp:669-679 / the SingleSupernova hook.
    Returns the updated field (numpy or JAX array in → same out).

    NOTE: raw SN energies (1e44 J) overflow float32 — accumulate in a
    float64 numpy field and convert to an energy *density* before adding to
    an f32 hydro state.
    """
    if isinstance(energy_rate, np.ndarray):
        out = energy_rate.copy()
        shape = out.shape
        for pos in sn_positions:
            g = geometry.position_to_grid_coords(np.asarray(pos, dtype=float))
            ijk = tuple(
                int(np.clip(np.floor(g[d]), 0, shape[d] - 1))
                for d in range(3)
            )
            out[ijk] += boost_factor * energy_per_sn
        return out
    import jax.numpy as jnp

    out = jnp.asarray(energy_rate)
    shape = out.shape
    for pos in sn_positions:
        g = geometry.position_to_grid_coords(np.asarray(pos, dtype=float))
        ijk = tuple(
            int(np.clip(np.floor(g[d]), 0, shape[d] - 1)) for d in range(3)
        )
        out = out.at[ijk].add(boost_factor * energy_per_sn)
    return out


class StaticSourceDistribution(SourceDistribution):
    """A fixed source set (SingleStar / AsciiFile / UniformRandom)."""

    def __init__(self, source_set: DiscreteSourceSet):
        self._set = source_set

    def source_set(self) -> DiscreteSourceSet:
        return self._set


def source_distribution_from_params(params) -> SourceDistribution:
    """Factory over ``PhotonSourceDistribution:type``, mirroring
    /root/reference/src/PhotonSourceDistributionFactory.hpp:106-128."""
    p = "PhotonSourceDistribution"
    dtype = params.get_string(f"{p}:type", "SingleStar")
    seed = params.get_int(f"{p}:random seed", 42)

    def phys(key, quantity, default):
        return params.get_physical_value(f"{p}:{key}", quantity, default)

    if dtype == "GadgetSnapshot":
        return StaticSourceDistribution(load_gadget_star_sources(
            params.get_string(f"{p}:filename"),
            uv_luminosity_function_from_params(params),
            formation_time_name=params.get_string(
                f"{p}:formation time name", "FormationTime"),
            cutoff_age=phys("cutoff age", "time", "5. Myr"),
            use_gas=params.get_bool(f"{p}:use gas", False),
        ))
    if dtype in ("None", ""):
        return StaticSourceDistribution(
            DiscreteSourceSet(np.zeros((0, 3)), np.zeros(0)))
    if dtype == "SingleStar":
        return StaticSourceDistribution(DiscreteSourceSet.single(
            tuple(params.get_physical_vector(
                f"{p}:position", "length", ["0. m"] * 3)),
            phys("luminosity", "frequency", "4.26e49 s^-1")))
    if dtype == "AsciiFile":
        return StaticSourceDistribution(
            DiscreteSourceSet.from_ascii(params.get_string(f"{p}:filename")))
    if dtype == "AsciiFileTable":
        return AsciiFileTableSourceDistribution(
            params.get_string(f"{p}:filename"),
            starting_time=phys("starting time", "time", "0. s"))
    if dtype == "UniformRandom":
        rng = np.random.default_rng(seed)
        n = params.get_int(f"{p}:number of sources", 24)
        anchor = params.get_physical_vector(
            "SimulationBox:anchor", "length")
        sides = params.get_physical_vector("SimulationBox:sides", "length")
        pos = np.asarray(anchor) + rng.uniform(size=(n, 3)) * np.asarray(sides)
        lum = np.full(n, phys("luminosity", "frequency", "1.e49 s^-1"))
        return StaticSourceDistribution(DiscreteSourceSet(pos, lum))
    if dtype == "SILCC":
        return SILCCSourceDistribution(
            num_sources=params.get_int(f"{p}:number of sources", 24),
            anchor_x=phys("anchor x", "length", "-1. kpc"),
            sides_x=phys("sides x", "length", "2. kpc"),
            anchor_y=phys("anchor y", "length", "-1. kpc"),
            sides_y=phys("sides y", "length", "2. kpc"),
            origin_z=phys("origin z", "length", "0. pc"),
            scaleheight_z=phys("scaleheight z", "length", "63. pc"),
            luminosity=phys("luminosity", "frequency", "3.125e49 s^-1"),
            seed=seed)
    if dtype == "DiscPatch":
        return DiscPatchSourceDistribution(
            lifetime=phys("average lifetime", "time", "20. Myr"),
            luminosity=phys("luminosity", "frequency", "1.e49 s^-1"),
            average_number=params.get_number(
                f"{p}:average number of sources", 24),
            anchor_x=phys("anchor x", "length", "-1. kpc"),
            sides_x=phys("sides x", "length", "2. kpc"),
            anchor_y=phys("anchor y", "length", "-1. kpc"),
            sides_y=phys("sides y", "length", "2. kpc"),
            origin_z=phys("origin z", "length", "0. pc"),
            scaleheight_z=phys("scaleheight z", "length", "63. pc"),
            seed=seed,
            update_interval=phys("update interval", "time", "0.1 Myr"))
    if dtype == "DwarfGalaxy":
        return DwarfGalaxySourceDistribution(
            lifetime=phys("average lifetime", "time", "20. Myr"),
            luminosity=phys("luminosity", "frequency", "1.e49 s^-1"),
            average_number=params.get_number(
                f"{p}:average number of sources", 24),
            center=tuple(params.get_physical_vector(
                f"{p}:center", "length", ["0. m"] * 3)),
            scale_radius=phys("scale radius", "length", "0.3 kpc"),
            seed=seed,
            update_interval=phys("update interval", "time", "0.1 Myr"))
    if dtype == "SingleSupernova":
        return SingleSupernovaSourceDistribution(
            position=tuple(params.get_physical_vector(
                f"{p}:position", "length", ["0. m"] * 3)),
            lifetime=phys("lifetime", "time", "10. Myr"),
            luminosity=phys("luminosity", "frequency", "1.e49 s^-1"),
            energy=phys("energy", "energy", "1.e44 J"))
    if dtype == "Caproni":
        return CaproniSourceDistribution(
            number_function_norm=params.get_number(
                f"{p}:number function norm", 1.0),
            uv_luminosity_norm=params.get_number(
                f"{p}:UV luminosity norm", 1.0),
            seed=seed,
            update_interval=phys("update interval", "time", "1. Myr"))
    raise ValueError(f"unknown PhotonSourceDistribution type {dtype!r}")


# ---------------------------------------------------------------------------
# UV luminosity functions (for snapshot-derived star-particle sources;
# /root/reference/src/UVLuminosityFunctionFactory.hpp:71-78)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RateBasedUVLuminosityFunction:
    """L_UV = rate × mass while younger than the cutoff age
    (RateBasedUVLuminosityFunction.hpp:37-93)."""

    uv_rate_per_mass_unit: float = 1e46 / 1.98855e30  # 1e46 s^-1 Msol^-1
    cutoff_age: float = 1.5768e14  # 5 Myr

    def __call__(self, age, mass):
        age = np.asarray(age, dtype=float)
        mass = np.asarray(mass, dtype=float)
        return np.where(age <= self.cutoff_age,
                        mass * self.uv_rate_per_mass_unit, 0.0)


class IMFBasedUVLuminosityFunction:
    """Population UV luminosity from a power-law IMF upper tail
    (IMFBasedUVLuminosityFunction.hpp:50-290).

    The most massive surviving star at a given age follows the Tang et al.
    (2014) inverse-lifetime fit; the UV output integrates the Sternberg et
    al. (2003) cubic luminosity fit against the IMF between the OB limit and
    that upper mass.
    """

    _UV_COEFFS = CaproniSourceDistribution._UV_COEFFS
    # inverse lifetime fit: age (Myr) → most massive surviving star (Msol)
    _MMAX_COEFFS = (4.47959896, 1.52686581e2, -1.04819293,
                    5.51939499e3, -4.11097721)

    def __init__(self, slope=2.3, lower_mass_limit_msol=20.0,
                 upper_mass_limit_msol=100.0, boost_factor=1.0,
                 imf_lower_limit_msol=0.1):
        if slope < 0.0 or slope in (1.0, 2.0, 3.0, 4.0):
            raise ValueError(f"unsupported IMF slope {slope}")
        self.slope = float(slope)
        self.lower = float(lower_mass_limit_msol)
        self.upper = float(upper_mass_limit_msol)
        self.boost_factor = float(boost_factor)
        # normalisation: 1 / ∫ m ξ(m) dm over the full population mass range,
        # so `mass` below is the total population mass (ctor :213-226)
        self._imf_norm = 1.0 / (
            self._mass_integral(imf_lower_limit_msol, self.upper) * 1.98855e30
        )

    def _mass_integral(self, m_lo, m_hi):
        e = 2.0 - self.slope
        return (m_hi**e - m_lo**e) / e

    def _uv_integral(self, m_lo, m_hi):
        A, B, C, D = self._UV_COEFFS
        s = self.slope
        p = [
            (m_hi ** (k - s) - m_lo ** (k - s)) / (k - s)
            for k in (1.0, 2.0, 3.0, 4.0)
        ]
        return A * p[3] + B * p[2] + C * p[1] + D * p[0]

    def upper_mass_limit(self, age) -> np.ndarray:
        age_myr = np.asarray(age, dtype=float) / 3.1536e13
        la = self._MMAX_COEFFS
        return la[0] + la[1] * age_myr ** la[2] + la[3] * age_myr ** la[4]

    def __call__(self, age, mass):
        m_up = np.minimum(self.upper_mass_limit(age), self.upper)
        out = np.where(
            m_up > self.lower,
            self._uv_integral(self.lower, np.maximum(m_up, self.lower + 1e-10))
            * self.boost_factor * np.asarray(mass, dtype=float)
            * self._imf_norm,
            0.0,
        )
        return out


def load_gadget_star_sources(
    filename: str,
    luminosity_function,
    *,
    formation_time_name: str = "FormationTime",
    cutoff_age: float = 1.5768e14,  # 5 Myr
    use_gas: bool = False,
) -> DiscreteSourceSet:
    """Star-particle sources from a Gadget HDF5 snapshot
    (GadgetSnapshotPhotonSourceDistribution.cpp:64-220):

    - star particles (``/PartType4``): position + UV luminosity
      L(age, mass) from the given UV luminosity function, with
      age = snapshot time − formation time; populations older than
      ``cutoff_age`` emit nothing (the luminosity function enforces it);
    - ``use_gas``: gas particles (``/PartType0``) whose
      ``StarFormationRate`` > 0 host embedded populations of mass
      SFR · cutoff_age at age 0 (:141-170).

    Units are taken from the snapshot's /Units group when present
    (io.gadget reader conventions), else SI is assumed.
    """
    import h5py

    positions, luminosities = [], []
    with h5py.File(filename, "r") as fh:
        unit_l = unit_m = unit_t = 1.0
        if "Units" in fh:
            u = fh["Units"].attrs
            unit_l = float(u.get("Unit length in cgs (U_L)", 100.0)) / 100.0
            unit_m = float(u.get("Unit mass in cgs (U_M)", 1000.0)) / 1000.0
            unit_t = float(u.get("Unit time in cgs (U_t)", 1.0))
        time = 0.0
        if "Header" in fh:
            time = float(fh["Header"].attrs.get("Time", 0.0)) * unit_t
        if use_gas and "PartType0" in fh:
            gas = fh["PartType0"]
            coords = np.asarray(gas["Coordinates"], dtype=float) * unit_l
            sfr = np.asarray(gas["StarFormationRate"], dtype=float) * (
                unit_m / max(unit_t, 1e-300))
            sel = sfr > 0.0
            mass = sfr[sel] * cutoff_age
            lum = np.asarray(luminosity_function(
                np.zeros(mass.shape), mass), dtype=float)
            positions.append(coords[sel])
            luminosities.append(lum)
        if not use_gas and "PartType4" in fh:
            stars = fh["PartType4"]
            coords = np.asarray(stars["Coordinates"], dtype=float) * unit_l
            masses = np.asarray(stars["Masses"], dtype=float) * unit_m
            if formation_time_name in stars:
                tform = np.asarray(
                    stars[formation_time_name], dtype=float) * unit_t
            else:
                tform = np.zeros(masses.shape)
            age = np.maximum(time - tform, 0.0)
            lum = np.asarray(luminosity_function(age, masses), dtype=float)
            positions.append(coords)
            luminosities.append(lum)
    if not positions:
        return DiscreteSourceSet(np.zeros((0, 3)), np.zeros(0))
    pos = np.concatenate(positions)
    lum = np.concatenate(luminosities)
    keep = lum > 0.0
    return DiscreteSourceSet(pos[keep], lum[keep])


def uv_luminosity_function_from_params(params):
    """Factory over ``UVLuminosityFunction:type``
    (/root/reference/src/UVLuminosityFunctionFactory.hpp:71-78)."""
    p = "UVLuminosityFunction"
    ftype = params.get_string(f"{p}:type", "RateBased")
    if ftype == "RateBased":
        return RateBasedUVLuminosityFunction(
            uv_rate_per_mass_unit=params.get_number(
                f"{p}:UV rate", 1e46) / 1.98855e30,
            cutoff_age=params.get_physical_value(
                f"{p}:cutoff age", "time", "5. Myr"),
        )
    if ftype == "IMFBased":
        return IMFBasedUVLuminosityFunction(
            slope=params.get_number(f"{p}:slope", 2.3),
            lower_mass_limit_msol=params.get_number(
                f"{p}:lower mass limit", 20.0),
            upper_mass_limit_msol=params.get_number(
                f"{p}:upper mass limit", 100.0),
            boost_factor=params.get_number(f"{p}:boost factor", 1.0),
        )
    raise ValueError(f"unknown UVLuminosityFunction type {ftype!r}")


# ---------------------------------------------------------------------------
# Frequency bins (for trackers; /root/reference/src/FrequencyBinsFactory.hpp)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinearFrequencyBins:
    """Uniform bins over [min, max) with clamping
    (LinearFrequencyBins.hpp:37-155)."""

    number_of_bins: int = 100
    minimum_frequency: float = 3.289e15
    maximum_frequency: float = 4.0 * 3.289e15

    def get_bin_number(self, frequency) -> np.ndarray:
        width = (self.maximum_frequency - self.minimum_frequency)
        idx = np.floor(
            (np.asarray(frequency, dtype=float) - self.minimum_frequency)
            * self.number_of_bins / width
        ).astype(int)
        return np.clip(idx, 0, self.number_of_bins - 1)

    def get_frequency(self, bin_number) -> np.ndarray:
        width = (self.maximum_frequency - self.minimum_frequency) / (
            self.number_of_bins)
        return self.minimum_frequency + (0.5 + np.asarray(bin_number)) * width

    @property
    def edges(self) -> np.ndarray:
        return np.linspace(self.minimum_frequency, self.maximum_frequency,
                           self.number_of_bins + 1)


#: ionization threshold energies (eV) for the tracked ion set — physical
#: constants used by LevelFrequencyBins.hpp to place its bin edges.
ION_THRESHOLD_EV = {
    "H_n": 13.5984, "He_n": 24.5874, "C_p1": 24.3833, "C_p2": 47.8878,
    "N_n": 14.5341, "N_p1": 29.6013, "N_p2": 47.4453, "O_n": 13.6181,
    "O_p1": 35.1211, "Ne_n": 21.5645, "Ne_p1": 40.9630, "S_p1": 23.3379,
    "S_p2": 34.79, "S_p3": 47.222,
}


class LevelFrequencyBins:
    """One bin per ion ionization threshold, sorted by frequency
    (LevelFrequencyBins.hpp:40-120). A photon falls in the bin of the
    highest threshold it exceeds."""

    def __init__(self):
        ev_to_hz = 1.602176634e-19 / 6.62607015e-34
        names = list(ION_THRESHOLD_EV)
        freqs = np.asarray([ION_THRESHOLD_EV[n] for n in names]) * ev_to_hz
        order = np.argsort(freqs)
        self.names = [names[i] for i in order]
        self.frequencies = freqs[order]

    def get_bin_number(self, frequency) -> np.ndarray:
        idx = np.searchsorted(
            self.frequencies, np.asarray(frequency, dtype=float), "right") - 1
        return np.clip(idx, 0, len(self.frequencies) - 1)

    def get_frequency(self, bin_number) -> np.ndarray:
        return self.frequencies[np.asarray(bin_number, dtype=int)]

    @property
    def edges(self) -> np.ndarray:
        return np.concatenate([self.frequencies, [4.0 * 3.289e15]])
