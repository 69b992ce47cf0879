"""Multi-element Monte Carlo photoionization with temperature balance.

Equivalent of the reference's full IonizationSimulation pipeline for
multi-frequency spectra (the lexington benchmark family,
/root/reference/src/IonizationSimulation.cpp:334-679 +
TemperatureCalculator::calculate_temperature): per iteration,

    emit packets (spectrum inverse-CDF → frequency bin, per-packet σ_H/σ_He)
    → spectral traversal (binned ℓ·w tallies, H+He opacity)
    → diffuse re-emission generations (absorbed packets re-enter the batch)
    → one matmul converts binned tallies to per-ion mean-intensity and
      heating integrals
    → per-cell coupled H/He/metal ionization solve, with the log-secant
      temperature iteration after the initial iterations.

The ionization/temperature solves run in float64 (required — enable jax
x64) on the transport's device; traversal runs in f32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu import constants
from cmacionize_tpu.models import ions, reemission, sources
from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.ops import (
    cross_sections as xsec_mod,
    ionization,
    recombination,
    temperature as temp_mod,
    traversal,
)
from cmacionize_tpu.utils.logging import Log, NullLog

_METAL_NAMES = tuple(ions.ION_NAMES[2:])


def _solve_temperature_jit(T_prev, j, h, nd, abundances, pahfac, crfac):
    # width-compacting staged solve (host-coordinated; its stage kernels
    # are jitted and cached by shape): the unconverged-cell tail no longer
    # pays full-grid width — see ops.temperature.solve_temperature_compacted
    return temp_mod.solve_temperature_compacted(
        T_prev, j, h, nd, abundances, pahfac=pahfac, crfac=crfac)


def solve_cell_state(j, h, nd, T_prev, abundances, do_temp,
                     pahfac=0.0, crfac=0.0, fixed_alpha=None,
                     backend="f64-host"):
    """Per-cell coupled ionization(+temperature) solve — geometry-agnostic.

    The multi-element state machinery shared by the Cartesian, AMR and
    Voronoi drivers (cf. TemperatureCalculator::calculate_temperature +
    IonizationStateCalculator, /root/reference/src/TemperatureCalculator.cpp
    :944,980 — the reference runs the same per-cell loop on every grid type
    through the DensityGrid iterator abstraction; here the abstraction is
    simply flat arrays).

    j: dict ion→array of photoionization integrals (s^-1); h: (hH, hHe)
    heating integrals; nd: number density; T_prev: previous temperature.
    All arrays share one (arbitrary) shape, float64, on one device (or one
    sharding); the solve runs where they live.
    Returns (T, xion dict).
    """
    if do_temp:
        if backend == "f32-device" and fixed_alpha is None:
            # scale-lifted f32 secant (ops.temperature.DEVICE_SOLVE_SCALE),
            # validated against the f64 solve to 2e-3 in T
            from cmacionize_tpu.ops import temperature as temp_mod

            f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
            T32, h032, he032, m32 = temp_mod.solve_temperature_device_chunked(
                f32(T_prev), {k: f32(v) for k, v in j.items()},
                (f32(h[0]), f32(h[1])), f32(nd), abundances,
                float(pahfac), float(crfac))
            f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
            T, h0, he0 = f64(T32), f64(h032), f64(he032)
            metals = {k: f64(v) for k, v in m32.items()}
        else:
            # jit the solve: eager execution re-dispatches hundreds of f64
            # ops per secant step; the stage kernels are cached by shape
            T, h0, he0, metals = _solve_temperature_jit(
                T_prev, j, h, nd, abundances, float(pahfac), float(crfac),
            )
    else:
        T = T_prev
        AHe = abundances["He"]
        if fixed_alpha is not None:
            fa = dict(fixed_alpha)
            alphaH = jnp.full_like(T, fa.get("H_n", 0.0))
            # zero alphaHe is degenerate in the coupled solve; with inert He
            # (AHe == 0) the value is irrelevant, keep it finite
            alphaHe = jnp.full_like(T, max(fa.get("He_n", 0.0), 1e-30))
            alphas = {
                # floor avoids 0/0 for ions with sigma = alpha = 0
                name: jnp.full_like(T, max(fa.get(name, 0.0), 1e-300))
                for name in _METAL_NAMES
            }
        else:
            alphaH = recombination.recombination_rate("H_n", T)
            alphaHe = recombination.recombination_rate("He_n", T)
            alphas = {
                name: recombination.recombination_rate(name, T)
                for name in _METAL_NAMES
            }
        h0, he0 = ionization.hydrogen_helium_neutral_fractions(
            j["H_n"], j["He_n"], nd, AHe, T, alphaH, alphaHe
        )
        ne = nd * (1.0 - h0 + AHe * (1.0 - he0))
        metals = ionization.metal_ion_fractions(
            {name: j[name] for name in _METAL_NAMES},
            ne, T, nd * h0, nd * he0 * AHe, nd * (1.0 - h0), alphas,
        )
        # neutral/vacuum fixups (IonizationStateCalculator.cpp:188-260)
        no_j = j["H_n"] <= 0.0
        h0 = jnp.where(no_j, 1.0, h0)
        he0 = jnp.where(no_j, 1.0, he0)
        neutral_one = {"N_n": 1.0, "O_n": 1.0, "Ne_n": 1.0}
        for name in _METAL_NAMES:
            metals[name] = jnp.where(
                no_j, neutral_one.get(name, 0.0), metals[name]
            )

    xion = {"H_n": h0, "He_n": he0}
    xion.update(metals)
    # zero-density (cavity) cells carry no physical state; pin them to
    # neutral so NaNs cannot poison the opacity fields
    vacuum = nd <= 0.0
    if bool(jnp.any(vacuum)):
        for name in xion:
            fill = 1.0 if name in ("H_n", "He_n", "N_n", "O_n", "Ne_n") else 0.0
            xion[name] = jnp.where(vacuum, fill, xion[name])
        T = jnp.where(vacuum, 500.0, T)
    return T, xion


@dataclasses.dataclass(frozen=True)
class MultiFreqConfig:
    geometry: GridGeometry
    number_density: float
    initial_temperature: float
    source_position: Tuple[float, float, float]
    luminosity: float
    spectrum_type: str  # "planck" | "monochromatic" | tabulated family
    spectrum_temperature: float  # for planck
    spectrum_frequency: float  # for monochromatic
    n_photons: int
    n_iterations: int
    abundances: Dict[str, float]
    do_temperature: bool = True
    minimum_iteration_number: int = 3  # T-solve only after this many loops
    #: "f64-host" (the reference-faithful float64 solve; it runs on the
    #: transport's device, the name is kept for parameter-file
    #: compatibility) or "f32-device" (scale-lifted f32 secant, validated
    #: to 2e-3 in T; parameter file: ``TemperatureCalculator: backend``)
    temperature_backend: str = "f64-host"
    diffuse_field: bool = True
    n_bins: int = 128
    n_reemission_rounds: int = 8
    pahfac: float = 0.0
    crfac: float = 0.0
    initial_neutral_fraction: float = 1.0e-6
    # (frequencies, cdf) arrays for the tabulated atmosphere families
    # (WMBasic/CastelliKurucz/Pegase3/PopStar, cf.
    # /root/reference/src/PhotonSourceSpectrumFactory.hpp:99-112) — built by
    # from_params via cmacionize_tpu.models.atmosphere_spectra
    spectrum_table: Optional[Tuple] = None
    # FixedValue microphysics (CrossSectionsFactory /
    # RecombinationRatesFactory "FixedValue", the stromgren benchmark
    # family): frequency-independent per-ion cross sections and
    # temperature-independent recombination rates, keyed by ion name
    fixed_sigma: Optional[Tuple] = None  # ((name, value_m2), ...)
    fixed_alpha: Optional[Tuple] = None  # ((name, value_m3_s), ...)
    # BiModal cross sections (BimodalCrossSections.hpp): per-ion (low, high)
    # values switching at a frequency limit
    bimodal_sigma: Optional[Tuple] = None  # (nu_limit, ((name, lo, hi), ...))

    @classmethod
    def from_params(cls, params) -> "MultiFreqConfig":
        geometry = GridGeometry.from_params(params)
        spectrum_type = params.get_string(
            "PhotonSourceSpectrum:type", "Planck"
        ).lower()
        spectrum_table = None
        if spectrum_type in (
            "wmbasic", "castellikurucz", "pegase3", "popstar"
        ):
            from cmacionize_tpu.models.atmosphere_spectra import (
                atmosphere_spectrum_from_params,
            )

            tab = atmosphere_spectrum_from_params(params)
            spectrum_table = (tab.frequencies, tab.cdf)
        abund = dict(ions.DEFAULT_ABUNDANCES)
        for element in abund:
            for key in (f"Abundances:{element}", f"AbundanceModel:{element}"):
                if params.has_value(key):
                    abund[element] = params.get_number(key)

        # FixedValue microphysics (reference param naming: hydrogen_0,
        # helium_0, carbon_1, ... cf. FixedValueCrossSections.hpp /
        # FixedValueRecombinationRates.hpp)
        _ION_PARAM_NAMES = {
            "H_n": "hydrogen_0", "He_n": "helium_0",
            "C_p1": "carbon_1", "C_p2": "carbon_2",
            "N_n": "nitrogen_0", "N_p1": "nitrogen_1", "N_p2": "nitrogen_2",
            "O_n": "oxygen_0", "O_p1": "oxygen_1",
            "Ne_n": "neon_0", "Ne_p1": "neon_1",
            "S_p1": "sulphur_1", "S_p2": "sulphur_2", "S_p3": "sulphur_3",
        }
        fixed_sigma = None
        bimodal_sigma = None
        xsec_type = params.get_string("CrossSections:type", "Verner")
        if xsec_type == "FixedValue":
            fixed_sigma = tuple(
                (name, params.get_physical_value(
                    f"CrossSections:{pname}", "surface area", "0. m^2"))
                for name, pname in _ION_PARAM_NAMES.items())
        elif xsec_type == "Bimodal":
            # BimodalCrossSections.hpp:175-230: *_low / *_high per ion with
            # a global frequency limit
            bimodal_sigma = (
                params.get_physical_value(
                    "CrossSections:frequency limit", "frequency", "15. eV"),
                tuple(
                    (name,
                     params.get_physical_value(
                         f"CrossSections:{pname}_low", "surface area",
                         "0. m^2"),
                     params.get_physical_value(
                         f"CrossSections:{pname}_high", "surface area",
                         "0. m^2"))
                    for name, pname in _ION_PARAM_NAMES.items()),
            )
        fixed_alpha = None
        _ALPHA_PARAM_NAMES = {
            "H_n": "hydrogen_1", "He_n": "helium_1",
            "C_p1": "carbon_2", "C_p2": "carbon_3",
            "N_n": "nitrogen_1", "N_p1": "nitrogen_2", "N_p2": "nitrogen_3",
            "O_n": "oxygen_1", "O_p1": "oxygen_2",
            "Ne_n": "neon_1", "Ne_p1": "neon_2",
            "S_p1": "sulphur_2", "S_p2": "sulphur_3", "S_p3": "sulphur_4",
        }
        if params.get_string(
                "RecombinationRates:type", "Verner") == "FixedValue":
            fixed_alpha = tuple(
                (name, params.get_physical_value(
                    f"RecombinationRates:{pname}", "reaction rate",
                    "0. m^3 s^-1"))
                for name, pname in _ALPHA_PARAM_NAMES.items())
        if fixed_sigma is not None and dict(fixed_sigma).get("He_n", 0.0) == 0.0:
            # inert helium (the stromgren family): remove it from the
            # opacity/balance entirely
            abund = dict(abund)
            abund["He"] = 0.0
        return cls(
            geometry=geometry,
            number_density=params.get_physical_value(
                "DensityFunction:density", "number density", "100. cm^-3"
            ),
            initial_temperature=params.get_physical_value(
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
            spectrum_type=spectrum_type,
            spectrum_temperature=params.get_physical_value(
                "PhotonSourceSpectrum:temperature", "temperature", "40000. K"
            ),
            spectrum_frequency=params.get_physical_value(
                "PhotonSourceSpectrum:frequency", "frequency", "13.6 eV"
            ),
            n_photons=params.get_int("IonizationSimulation:number of photons", 1000000),
            n_iterations=params.get_int(
                "IonizationSimulation:number of iterations", 20
            ),
            abundances=abund,
            do_temperature=params.get_bool(
                "TemperatureCalculator:do temperature calculation", False
            ),
            temperature_backend=params.get_string(
                "TemperatureCalculator:backend", "f64-host"
            ),
            diffuse_field=params.get_bool(
                "IonizationSimulation:diffuse field", False
            ),
            pahfac=params.get_number("TemperatureCalculator:PAH heating factor", 0.0),
            crfac=params.get_number(
                "TemperatureCalculator:cosmic ray heating factor", 0.0
            ),
            spectrum_table=spectrum_table,
            fixed_sigma=fixed_sigma,
            fixed_alpha=fixed_alpha,
            bimodal_sigma=bimodal_sigma,
        )


class MultiFreqIonizationSimulation:
    """Driver for the multi-element photoionization loop."""

    def __init__(
        self, config: MultiFreqConfig, log: Optional[Log] = None,
        seed: int = 42, density=None, initial_temperature=None,
        mesh=None,
    ):
        """``mesh``: optional 1-axis jax Mesh ("x") — when given, the MC
        transport runs domain-decomposed: the grid is sharded into x-slabs
        over the mesh devices and packets are exchanged over the interconnect
        (parallel.domain.make_domain_spectral_trace), with diffuse
        re-emission handled in-loop on the owning slab.  The solves run in
        float64 where the integrals live."""
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        geom = config.geometry
        cell = geom.cell_size
        if not np.allclose(cell, cell[0], rtol=1e-6):
            raise NotImplementedError("cubic cells required")
        self.config = config
        self.log = log or NullLog()
        self.key = jax.random.PRNGKey(seed)
        self.iteration = 0  # completed iterations (persisted by restart)
        self.geometry = geom
        self.dx = float(cell[0])

        # frequency grid: uniform bins over the ionizing range
        nu_min = reemission.NU_MIN
        nu_max = 4.0 * nu_min
        self.bin_edges = np.linspace(nu_min, nu_max, config.n_bins + 1)
        self.bin_centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        # per-ion cross sections at bin centers [n_ion, n_bins]
        if config.fixed_sigma is not None:
            fixed = dict(config.fixed_sigma)
            self.sigma_table = np.stack([
                np.full(config.n_bins, fixed.get(name, 0.0))
                for name in ions.ION_NAMES])
        elif config.bimodal_sigma is not None:
            nu_limit, rows = config.bimodal_sigma
            table = {name: (lo, hi) for name, lo, hi in rows}
            self.sigma_table = np.stack([
                np.where(self.bin_centers < nu_limit,
                         table.get(name, (0.0, 0.0))[0],
                         table.get(name, (0.0, 0.0))[1])
                for name in ions.ION_NAMES])
        else:
            self.sigma_table = xsec_mod.tabulate_cross_sections(
                self.bin_centers)
        heating = np.stack(
            [
                self.sigma_table[ions.ION_H_n] * (self.bin_centers - constants.NU_ION_H),
                self.sigma_table[ions.ION_He_n]
                * (self.bin_centers - constants.NU_ION_HE),
            ]
        )
        self.heating_weights = heating

        # source spectrum sampled as a distribution over bins
        if config.spectrum_table is not None:
            # tabulated atmosphere spectrum: per-bin weight = CDF increment
            # across the bin (exact for the tabulated distribution)
            t_nu, t_cdf = config.spectrum_table
            edge_cdf = np.interp(self.bin_edges, t_nu, t_cdf)
            pdf = np.maximum(np.diff(edge_cdf), 0.0)
        elif config.spectrum_type.startswith("mono"):
            pdf = np.zeros(config.n_bins)
            idx = np.clip(
                np.searchsorted(self.bin_edges, config.spectrum_frequency) - 1,
                0,
                config.n_bins - 1,
            )
            pdf[idx] = 1.0
        else:
            x = (
                constants.PLANCK
                * self.bin_centers
                / (constants.BOLTZMANN * config.spectrum_temperature)
            )
            pdf = self.bin_centers**2 / np.expm1(x)
        cdf = np.cumsum(pdf)
        self.spectrum_cdf = np.concatenate([[0.0], cdf / cdf[-1]])

        self.spectra = reemission.ReemissionSpectra.build()

        # grid state (f32 for traversal; solves upcast internally);
        # ``density``/``initial_temperature`` array overrides support
        # structured ICs (BlockSyntax cavities etc.) from the
        # DensityFunction factory
        shape = geom.shape
        if density is not None:
            self.number_density = jnp.asarray(density, jnp.float32).reshape(shape)
        else:
            self.number_density = jnp.full(
                shape, config.number_density, jnp.float32
            )
        if initial_temperature is not None:
            self.temperature = jnp.asarray(
                initial_temperature, jnp.float64
            ).reshape(shape)
        else:
            self.temperature = jnp.full(
                shape, config.initial_temperature, jnp.float64
            )
        self.xion = {
            name: jnp.full(shape, config.initial_neutral_fraction, jnp.float64)
            for name in ions.ION_NAMES
        }
        self._source_gpos = tuple(
            float(g) for g in geom.position_to_grid_coords(config.source_position)
        )
        self._iteration_jit = None
        self.j_fields = None
        # optional TrackerManager (models.trackers): accumulates per-cell
        # spectra from the binned tallies each iteration
        self.tracker_manager = None
        # optional typed CellTrackers (Absorption/Spectrum/WeightedSpectrum)
        # — per-generation segment-crossing estimators, attached via
        # attach_cell_trackers()
        self._cell_trackers = None

        self.mesh = mesh
        _nb = -(-config.n_photons // self.PHOTON_BATCH)
        self._n_emitted = (config.n_photons // _nb) * _nb  # batched emission
        self._sharded_trace = None
        self._sharded_shardings = None
        if mesh is not None:
            from cmacionize_tpu.parallel import domain as domain_mod

            n_dev = mesh.shape["x"]
            self._n_loc = -(-config.n_photons // n_dev)  # ceil
            self._n_emitted = self._n_loc * n_dev
            reemission_cfg = None
            if config.diffuse_field:
                reemission_cfg = {
                    "spectra": self.spectra,
                    "sig_h_tab": self.sigma_table[ions.ION_H_n],
                    "sig_he_tab": self.sigma_table[ions.ION_He_n],
                    "bin_edges": self.bin_edges,
                    "AHe": config.abundances["He"],
                }
            # the carry is sized on the GLOBAL photon count: a point source
            # funnels every packet through its owning slab, which must be
            # able to hold them all (cf. parallel.domain3d's n_carry note)
            self._sharded_trace, self._sharded_shardings = (
                domain_mod.make_domain_spectral_trace(
                    mesh,
                    global_shape=shape,
                    n_bins=config.n_bins,
                    n_photons=self._n_emitted,
                    axis="x",
                    reemission=reemission_cfg,
                )
            )

    # ---------------------------------------------------------------- MC core

    def attach_cell_trackers(self, trackers) -> None:
        """Attach a models.trackers.CellTrackers instance.

        Must be called before the first iteration (the batch program bakes
        the tracker geometry in; attaching later invalidates the cached
        jit).  Not supported with a device mesh or periodic boxes (the
        segment estimator needs straight unwrapped paths).
        """
        if self.mesh is not None:
            raise NotImplementedError(
                "cell trackers are single-device only (run without Parallel:)")
        if any(self.geometry.periodic):
            raise NotImplementedError(
                "cell trackers require a non-periodic box")
        self._cell_trackers = trackers
        self._one_batch_jit = None  # rebake

    def _emit_bins(self, key, n):
        """Sample n frequency bins from the source spectrum CDF."""
        xi = jax.random.uniform(key, (n,), jnp.float32)
        edges = jnp.asarray(self.spectrum_cdf, jnp.float32)
        return jnp.clip(
            jnp.searchsorted(edges, xi) - 1, 0, self.config.n_bins - 1
        ).astype(jnp.int32)

    #: max packets traced per batch: the blocked spectral kernel carries
    #: [P, W] intermediates (~0.13 GB at 2^19, W=64), so very large photon
    #: budgets are dispatched in 2^19-packet batches (compiled once)
    PHOTON_BATCH = 1 << 19

    def _mc_shoot(self, key, xH, xHe, T):
        """Emit + trace + re-emission rounds → [n_ion+2, ncell] integrals
        (raw Σ ℓσw scale: cell-unit lengths × m² × weight).

        Budgets above :data:`PHOTON_BATCH` are processed as a Python loop of
        separately-dispatched batches (one compilation, donated tally —
        identical estimator)."""
        cfg = self.config
        shape = self.geometry.shape
        ncell = self.geometry.n_cells
        nd = self.number_density
        AHe = cfg.abundances["He"]

        chi_h = (nd * xH.astype(jnp.float32) * self.dx).reshape(-1)
        chi_he = (nd * AHe * xHe.astype(jnp.float32) * self.dx).reshape(-1)

        sig_h_tab = jnp.asarray(self.sigma_table[ions.ION_H_n], jnp.float32)
        sig_he_tab = jnp.asarray(self.sigma_table[ions.ION_He_n], jnp.float32)
        xH32 = xH.astype(jnp.float32).reshape(-1)
        xHe32 = xHe.astype(jnp.float32).reshape(-1)
        T32 = T.astype(jnp.float32).reshape(-1)
        bin_edges = jnp.asarray(self.bin_edges, jnp.float32)

        n_batches = -(-cfg.n_photons // self.PHOTON_BATCH)
        n_per = cfg.n_photons // n_batches

        trackers = self._cell_trackers

        def track(sums, packets_before, packets_after, valid, slot):
            if trackers is None:
                return sums
            origin = jnp.stack(
                [packets_before.px, packets_before.py, packets_before.pz], 1)
            direction = jnp.stack(
                [packets_before.dx, packets_before.dy, packets_before.dz], 1)
            final = jnp.stack(
                [packets_after.px, packets_after.py, packets_after.pz], 1)
            contrib = trackers.contributions(
                origin, direction, final, packets_before.fbin,
                packets_before.weight, valid, slot,
            )
            if sums is None:
                return contrib
            return tuple(a + b for a, b in zip(sums, contrib))

        def one_batch(tally2d, key, chi_h=chi_h, chi_he=chi_he,
                      xH32=xH32, xHe32=xHe32, T32=T32):
            key_bin, key_emit, key_loop = jax.random.split(key, 3)
            fbin = self._emit_bins(key_bin, n_per)
            px, py, pz, dx, dy, dz, tau, _, weight = (
                sources.emit_point_source(key_emit, n_per, self._source_gpos)
            )
            packets = traversal.make_spectral_packets(
                jnp.stack([px, py, pz], 1),
                jnp.stack([dx, dy, dz], 1),
                tau, weight,
                sig_h_tab[fbin], sig_he_tab[fbin], fbin, shape,
            )
            packets_emitted = packets
            tally2d, packets = traversal.trace_packets_spectral_auto(
                chi_h, chi_he, packets, tally2d,
                shape=shape, n_bins=cfg.n_bins,
                periodic=self.geometry.periodic,
            )
            tracker_sums = track(
                None, packets_emitted, packets,
                jnp.ones((n_per,), bool), jnp.zeros((n_per,), jnp.int32),
            )

            overflow = jnp.zeros((), jnp.int32)
            if cfg.diffuse_field:
                from cmacionize_tpu.parallel.domain import _compact

                width = packets.size
                for gen in range(cfg.n_reemission_rounds):
                    key_loop, key_re, key_dir, key_tau = jax.random.split(
                        key_loop, 4)
                    flat = (
                        packets.cx * shape[1] + packets.cy
                    ) * shape[2] + packets.cz
                    flat = jnp.clip(flat, 0, ncell - 1)
                    remask, new_freq, reemit_h_channel = reemission.reemit_batch(
                        key_re, self.spectra, packets.absorbed,
                        packets.sig_h, packets.sig_he,
                        xH32[flat], xHe32[flat], T32[flat], AHe,
                    )
                    ndx, ndy, ndz = sources.isotropic_directions(
                        key_dir, packets.size)
                    ntau = sources.sample_tau_targets(key_tau, packets.size)
                    nbin = jnp.clip(
                        jnp.searchsorted(bin_edges, new_freq) - 1,
                        0, cfg.n_bins - 1,
                    ).astype(jnp.int32)
                    # each generation re-emits ≲40% of the previous one —
                    # compact into a halving batch width instead of paying
                    # full width per generation; any overflow is counted,
                    # never silent
                    width = min(max(width // 2, 8192), packets.size)
                    fields = (
                        packets.px, packets.py, packets.pz, ndx, ndy, ndz,
                        ntau, packets.weight, sig_h_tab[nbin],
                        sig_he_tab[nbin],
                    )
                    ifields = (
                        packets.cx, packets.cy, packets.cz, nbin,
                        reemit_h_channel.astype(jnp.int32),
                    )
                    cf, cmask, ov = _compact(fields, remask, width)
                    cif, _, _ = _compact(ifields, remask, width)
                    overflow = overflow + ov
                    packets = traversal.SpectralPacketBatch(
                        cf[0], cf[1], cf[2],
                        cif[0], cif[1], cif[2],
                        cf[3], cf[4], cf[5],
                        cf[6], cf[7],
                        cf[8], cf[9], cif[3],
                        cmask, jnp.zeros_like(cmask),
                    )
                    packets_emitted = packets
                    # PHOTONTYPE slot: 1 = diffuse H, 2 = diffuse He
                    gen_slot = jnp.where(cif[4] > 0, 1, 2).astype(jnp.int32)
                    tally2d, packets = traversal.trace_packets_spectral_auto(
                        chi_h, chi_he, packets, tally2d,
                        shape=shape, n_bins=cfg.n_bins,
                        periodic=self.geometry.periodic,
                    )
                    tracker_sums = track(
                        tracker_sums, packets_emitted, packets, cmask,
                        gen_slot,
                    )
            if trackers is None:
                tracker_sums = 0
            return tally2d, overflow, tracker_sums

        # dispatch batches as separate jits (see docstring) with the donated
        # tally threaded through; n_batches == 1 is just a single dispatch
        tally2d = jnp.zeros(cfg.n_bins * ncell, jnp.float32)
        overflow = jnp.zeros((), jnp.int32)
        if getattr(self, "_one_batch_jit", None) is None:
            self._one_batch_jit = jax.jit(one_batch, donate_argnums=(0,))
        keys = jax.random.split(key, n_batches)
        for i in range(n_batches):
            tally2d, ov, tsums = self._one_batch_jit(
                tally2d, keys[i], chi_h, chi_he, xH32, xHe32, T32)
            overflow = overflow + ov
            if self._cell_trackers is not None:
                self._cell_trackers.accumulate(*tsums)
        self._reemission_overflow = int(overflow)
        if self._reemission_overflow:
            self.log.warning(
                f"re-emission compaction overflow: "
                f"{self._reemission_overflow} packets (widen the schedule)")

        integrals = traversal.spectral_tallies_to_ion_integrals(
            tally2d,
            jnp.asarray(self.sigma_table, jnp.float32),
            jnp.asarray(self.heating_weights, jnp.float32),
            ncell,
        )
        return integrals, tally2d  # [n_ion + 2, ncell], [n_bins * ncell]

    def _mc_shoot_sharded(self, key, xH, xHe, T):
        """Domain-decomposed emit + trace (+ in-loop re-emission).

        Same estimator as :meth:`_mc_shoot`; the grid lives sharded in
        x-slabs, each device emits its 1/n_dev share of the photons (global
        positions at the source; out-of-slab emissions hop to their owner
        through the superstep exchange).
        """
        cfg = self.config
        shape = self.geometry.shape
        ncell = self.geometry.n_cells
        nd = self.number_density
        AHe = cfg.abundances["He"]
        n_dev = self.mesh.shape["x"]
        n_loc = self._n_loc
        n_tot = self._n_emitted

        sig_h_tab = jnp.asarray(self.sigma_table[ions.ION_H_n], jnp.float32)
        sig_he_tab = jnp.asarray(self.sigma_table[ions.ION_He_n], jnp.float32)

        key_bin, key_emit, key_loop = jax.random.split(key, 3)
        fbin_e = self._emit_bins(key_bin, n_tot)
        px, py, pz, dx, dy, dz, tau_e, _, w_e = sources.emit_point_source(
            key_emit, n_tot, self._source_gpos
        )
        # a point source belongs to one slab: emit the whole batch on its
        # owning device (other devices' lanes are masked off); the per-slab
        # packets-traced counters expose the resulting first-trace skew
        nx_loc = shape[0] // n_dev
        src_dev = min(int(self._source_gpos[0]) // nx_loc, n_dev - 1)
        fsh = self._sharded_shardings["packets"]

        def _stack(arr, dtype=np.float32):
            out = np.zeros((n_dev,) + np.asarray(arr).shape, dtype)
            out[src_dev] = np.asarray(arr)
            return jax.device_put(jnp.asarray(out), fsh)

        position = _stack(jnp.stack([px, py, pz], 1))
        direction = _stack(jnp.stack([dx, dy, dz], 1))
        tau = _stack(tau_e)
        weight = _stack(w_e)
        sig_h = _stack(sig_h_tab[fbin_e])
        sig_he = _stack(sig_he_tab[fbin_e])
        fbin = _stack(fbin_e, np.int32)
        emit_np = np.zeros((n_dev, n_tot), bool)
        emit_np[src_dev] = True
        emit_mask = jax.device_put(jnp.asarray(emit_np), fsh)

        field_sh = self._sharded_shardings["field"]
        chi_h = jax.device_put(
            (nd * xH.astype(jnp.float32) * self.dx), field_sh)
        chi_he = jax.device_put(
            (nd * AHe * xHe.astype(jnp.float32) * self.dx), field_sh)

        args = [chi_h, chi_he, position, direction, tau, weight, sig_h,
                sig_he, fbin, emit_mask]
        if cfg.diffuse_field:
            keys = jax.device_put(
                jax.random.split(key_loop, n_dev), fsh)
            args += [
                jax.device_put(xH.astype(jnp.float32), field_sh),
                jax.device_put(xHe.astype(jnp.float32), field_sh),
                jax.device_put(T.astype(jnp.float32), field_sh),
                keys,
            ]
        tally4d, absorbed_field, diag = self._sharded_trace(*args)
        self._last_trace_diag = {k: int(v) for k, v in diag.items()}
        if self._last_trace_diag.get("buffer_overflow", 0):
            self.log.warning(
                "sharded trace buffer overflow: "
                f"{self._last_trace_diag['buffer_overflow']} packets — "
                "increase the exchange capacity")

        tally2d = tally4d.reshape(cfg.n_bins * ncell)
        integrals = traversal.spectral_tallies_to_ion_integrals(
            tally2d,
            jnp.asarray(self.sigma_table, jnp.float32),
            jnp.asarray(self.heating_weights, jnp.float32),
            ncell,
        )
        return integrals, tally2d

    # ------------------------------------------------------------ iterations

    def _solve_state(self, integrals, do_temp: bool):
        """Normalize tallies and run the per-cell state solve in float64 on
        the device that holds the integrals (no host round trip)."""
        cfg = self.config
        shape = self.geometry.shape
        nd = self.number_density.astype(jnp.float64)
        jfac = cfg.luminosity * self.dx / (
            self._n_emitted * self.geometry.cell_volume
        )
        hfac = jfac * constants.PLANCK
        integrals = integrals.astype(jnp.float64)
        j = {
            name: (integrals[i] * jfac).reshape(shape)
            for i, name in enumerate(ions.ION_NAMES)
        }
        h = (
            (integrals[ions.NUMBER_OF_IONS] * hfac).reshape(shape),
            (integrals[ions.NUMBER_OF_IONS + 1] * hfac).reshape(shape),
        )

        T, xion = solve_cell_state(
            j, h, nd, self.temperature,
            cfg.abundances, do_temp, pahfac=cfg.pahfac, crfac=cfg.crfac,
            fixed_alpha=cfg.fixed_alpha, backend=cfg.temperature_backend,
        )
        return T, xion, j

    def run(self, n_iterations: Optional[int] = None, restart_manager=None,
            diagnostics=None):
        """``restart_manager``: optional io.restart.RestartManager —
        checkpoint on cadence / SIGINT / max-walltime; ``n_iterations``
        counts total iterations including restored ones, so kill-and-resume
        reproduces the uninterrupted run (bit for bit on the CPU; to f32
        summation order on a GPU, whose scatter-adds are atomic).

        ``diagnostics``: optional utils.diagnostics.IterationDiagnostics —
        per-iteration counter/phase-timing dumps (diagnostics_XX.txt)."""
        import contextlib

        def _phase(name):
            return (diagnostics.phase(name) if diagnostics is not None
                    else contextlib.nullcontext())
        from cmacionize_tpu.utils import signals

        cfg = self.config
        n_iterations = n_iterations or cfg.n_iterations
        if restart_manager is not None:
            signals.install()
        if self.mesh is not None:
            shoot = self._mc_shoot_sharded  # inner trace already jitted
        else:
            shoot = self._mc_shoot  # per-batch jits dispatched inside
        while self.iteration < n_iterations:
            loop = self.iteration
            self.key, subkey = jax.random.split(self.key)
            # opacity fractions are physical: clamp the stored (possibly >1)
            # raw iterates when building χ
            xH = jnp.clip(self.xion["H_n"], 0.0, 1.0)
            xHe = jnp.clip(self.xion["He_n"], 0.0, 1.0)
            with _phase("trace"):
                integrals, tally2d = shoot(subkey, xH, xHe, self.temperature)
            if self.tracker_manager is not None:
                self.tracker_manager.accumulate(tally2d)
            if self._cell_trackers is not None:
                self._cell_trackers.end_iteration()
            do_temp = cfg.do_temperature and loop >= cfg.minimum_iteration_number
            with _phase("solve"):
                self.temperature, self.xion, self.j_fields = self._solve_state(
                    integrals, do_temp
                )
            if diagnostics is not None:
                diagnostics.count("photons emitted", cfg.n_photons)
                diagnostics.count(
                    "reemission rounds", cfg.n_reemission_rounds)
                diagnostics.end_iteration()
            self.iteration += 1
            self.log.info(
                f"iteration {loop + 1}/{n_iterations}: "
                f"<T> = {float(jnp.mean(self.temperature)):.1f} K, "
                f"<xH> = {float(jnp.mean(self.xion['H_n'])):.4f}"
            )
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
        return self.xion, self.temperature

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        arrays = {f"xion_{name}": arr for name, arr in self.xion.items()}
        arrays["temperature"] = self.temperature
        arrays["rng_key"] = jax.random.key_data(self.key)
        if self._cell_trackers is not None:
            # trackers are stateful across iterations like every reference
            # object with a write_restart_file hook (RestartWriter.hpp)
            arrays["tracker_counts"] = self._cell_trackers.counts
            arrays["tracker_weighted"] = self._cell_trackers.weighted
            arrays["tracker_lengths"] = self._cell_trackers.lengths
        return manager.write(arrays, {"iteration": self.iteration})

    def load_restart(self, filename: str) -> None:
        import numpy as _np

        from cmacionize_tpu.io.restart import RestartManager

        arrays, scalars = RestartManager.load(filename)
        self.xion = {
            k[len("xion_"):]: jnp.asarray(v)
            for k, v in arrays.items() if k.startswith("xion_")
        }
        self.temperature = jnp.asarray(arrays["temperature"])
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.iteration = int(scalars["iteration"])
        if "tracker_counts" in arrays and self._cell_trackers is not None:
            self._cell_trackers.counts = _np.asarray(
                arrays["tracker_counts"], _np.float64)
            self._cell_trackers.weighted = _np.asarray(
                arrays["tracker_weighted"], _np.float64)
            self._cell_trackers.lengths = _np.asarray(
                arrays["tracker_lengths"], _np.float64)
