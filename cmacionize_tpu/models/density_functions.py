"""Density functions: initial-condition generators for the grids.

Equivalents of the reference's DensityFunction family (factory at
/root/reference/src/DensityFunctionFactory.hpp:138-174).  A density function
maps cell centers to (number density, temperature, neutral fraction) fields;
implemented host-side in numpy since it runs once at setup.

Implemented: Homogeneous, BlockSyntax (nested cube/sphere primitives from a
YAML file, cf. BlockSyntaxDensityFunction.hpp), DiscPatch, Bondi (from
models.bondi), SpiralGalaxy.  Snapshot-based functions live in
cmacionize_tpu.io.gadget (grid_from_snapshot).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.utils.units import parse_quantity


@dataclasses.dataclass(frozen=True)
class DensityFields:
    number_density: np.ndarray
    temperature: np.ndarray
    neutral_fraction: np.ndarray
    # optional [*, 3] bulk velocity (hydro ICs: DiscIC, BondiProfile)
    velocity: Optional[np.ndarray] = None


def homogeneous(geometry: GridGeometry, number_density, temperature,
                neutral_fraction=1e-6) -> DensityFields:
    shape = geometry.shape
    return DensityFields(
        np.full(shape, number_density),
        np.full(shape, temperature),
        np.full(shape, neutral_fraction),
    )


@dataclasses.dataclass(frozen=True)
class Block:
    """One BlockSyntax primitive: a cube or sphere with constant values."""

    origin: Tuple[float, float, float]
    sides: Tuple[float, float, float]  # sphere: sides[0] = diameter
    kind: str  # "cube" | "sphere"
    number_density: float
    temperature: float
    neutral_fraction: float = 1e-6

    def contains(self, centers: np.ndarray) -> np.ndarray:
        rel = centers - np.asarray(self.origin)
        if self.kind == "sphere":
            return (rel**2).sum(-1) <= (0.5 * self.sides[0]) ** 2
        return np.all(np.abs(rel) <= 0.5 * np.asarray(self.sides), axis=-1)


def block_syntax(
    geometry: GridGeometry,
    blocks: Sequence[Block],
    background_density: float = 0.0,
    background_temperature: float = 100.0,
    background_neutral_fraction: float = 1.0,
) -> DensityFields:
    """Apply nested blocks in order (later blocks override earlier ones),
    cf. BlockSyntaxDensityFunction."""
    centers = geometry.cell_centers()
    nd = np.full(geometry.shape, background_density)
    T = np.full(geometry.shape, background_temperature)
    xh = np.full(geometry.shape, background_neutral_fraction)
    for block in blocks:
        inside = block.contains(centers)
        nd = np.where(inside, block.number_density, nd)
        T = np.where(inside, block.temperature, T)
        xh = np.where(inside, block.neutral_fraction, xh)
    return DensityFields(nd, T, xh)


def blocks_from_yaml(filename: str) -> List[Block]:
    """Parse a BlockSyntax YAML file (cf. benchmarks/starbench.yml)."""
    from cmacionize_tpu.utils.params import yaml_load

    with open(filename) as handle:
        doc = yaml_load(handle.read())
    blocks = []
    for i in range(int(doc["number of blocks"])):
        entry = doc[f"block[{i}]"]
        blocks.append(
            Block(
                origin=tuple(
                    parse_quantity(c, "length") for c in entry["origin"]
                ),
                sides=tuple(
                    parse_quantity(c, "length") for c in entry["sides"]
                ),
                kind=str(entry.get("type", "cube")),
                number_density=parse_quantity(
                    entry["number density"], "number density"
                ),
                temperature=parse_quantity(
                    entry.get("initial temperature", "100. K"), "temperature"
                ),
                neutral_fraction=float(entry.get("neutral fraction H", 1e-6)),
            )
        )
    return blocks


def disc_patch(
    geometry: GridGeometry,
    surface_density: float,
    scale_height: float,
    disc_z: float,
    temperature: float,
    gas_fraction: float = 0.1,
    neutral_fraction: float = 1.0,
) -> DensityFields:
    """Vertical cosh-power gas disc in hydrostatic equilibrium with the
    DiscPatch potential.

    Reference math (/root/reference/src/DiscPatchDensityFunction.hpp:100-254):
    n_H(z) = norm · cosh((z - z_d)/b_M)^d with d = -2 b_M / b_g, gas scale
    height b_g = k T / (μ m_p π G Σ_M), and norm = ½ f_g Σ_M F(d) / (b_M m_p)
    where F(d) is the fitted mass-fraction factor of the ∫cosh^d integral
    (:166-173).
    """
    from cmacionize_tpu import constants

    mu_mp = 0.5 * constants.PROTON_MASS * (1.0 + neutral_fraction)
    b_g = (
        constants.BOLTZMANN * temperature
        / (mu_mp * np.pi * constants.NEWTON_CONSTANT * surface_density)
    )
    exponent = -2.0 * scale_height / b_g
    x = np.log10(-0.5 * exponent)
    mff = 10.0 ** (
        0.01499337 * x**3 - 0.08454788 * x**2 + 0.63503798 * x - 0.01018254
    )
    norm = (
        0.5 * gas_fraction * surface_density * mff
        / (scale_height * constants.PROTON_MASS)
    )
    centers = geometry.cell_centers()
    z = centers[..., 2] - disc_z
    nd = norm * np.cosh(z / scale_height) ** exponent
    return DensityFields(
        nd,
        np.full(geometry.shape, temperature),
        np.full(geometry.shape, neutral_fraction),
    )


def disc_ic(
    geometry: GridGeometry,
    mass: float,
    temperature: float,
    bondi_density: float,
    density_power: float = 1.5,
    bondi_velocity: float = 0.0,
    velocity_power: float = 0.5,
    neutral_fraction: float = 1e-6,
) -> DensityFields:
    """Power-law accretion-disc initial condition
    (/root/reference/src/DiscICDensityFunction.hpp:40-233):
    n = n_B (R_B/r)^γρ with a tangential velocity v = v_B (R_B/r)^γv e_θ,
    where R_B = G M m_m m_p / (2 k T) and the mean molecular mass m_m is 1
    below 10⁴ K and 0.5 above (:104-113)."""
    from cmacionize_tpu import constants

    m_m = 1.0 if temperature < 1e4 else 0.5
    R_B = (
        constants.NEWTON_CONSTANT * mass * m_m * constants.PROTON_MASS
        / (2.0 * constants.BOLTZMANN * temperature)
    )
    n_B = bondi_density / (m_m * constants.PROTON_MASS)
    centers = geometry.cell_centers()
    r = np.maximum(np.sqrt((centers**2).sum(-1)), 1e-30)
    Rcyl = np.maximum(
        np.sqrt(centers[..., 0] ** 2 + centers[..., 1] ** 2), 1e-30
    )
    rinv = R_B / r
    nd = n_B * rinv**density_power
    vnorm = bondi_velocity * rinv**velocity_power / Rcyl
    velocity = np.stack(
        [-centers[..., 1] * vnorm, centers[..., 0] * vnorm,
         np.zeros(geometry.shape)],
        axis=-1,
    )
    return DensityFields(
        nd,
        np.full(geometry.shape, temperature),
        np.full(geometry.shape, neutral_fraction),
        velocity=velocity,
    )


def cored_dm_profile(
    geometry: GridGeometry,
    core_radius: float,
    max_circular_velocity: float,
    central_density: float,
    temperature: float,
    neutral_fraction: float = 1.0,
    polytropic_index: float = 1.0,
) -> DensityFields:
    """Hydrostatic gas profile in a cored dark-matter potential
    (/root/reference/src/CoredDMProfileDensityFunction.hpp:105-171):
    n(r) = n0 exp(-vr (½ ln(1+ξ²) + atan(ξ)/ξ - 1)), ξ = r/r0,
    vr = γ v∞² / cs², cs² = k T / (½ m_p (1+x_H)); output T is T/γ."""
    from cmacionize_tpu import constants

    mu_mp = 0.5 * constants.PROTON_MASS * (1.0 + neutral_fraction)
    cs2 = constants.BOLTZMANN * temperature / mu_mp
    vratio = polytropic_index * max_circular_velocity**2 / cs2
    n0 = central_density / mu_mp
    centers = geometry.cell_centers()
    r = np.maximum(np.sqrt((centers**2).sum(-1)), 1e-30)
    ksi = r / core_radius
    nd = n0 * np.exp(
        -vratio * (0.5 * np.log1p(ksi**2) + np.arctan(ksi) / ksi - 1.0)
    )
    return DensityFields(
        nd,
        np.full(geometry.shape, temperature / polytropic_index),
        np.full(geometry.shape, neutral_fraction),
    )


def bondi_profile_density(
    geometry: GridGeometry,
    central_mass: float,
    bondi_density: float,
    sound_speed: float,
    center=(0.0, 0.0, 0.0),
    ionisation_radius: float = 0.0,
    pressure_contrast: float = 0.0,
    vprof_radius: float = 0.0,
    vprof_velocity: float = 0.0,
) -> DensityFields:
    """Analytic Bondi accretion IC
    (/root/reference/src/BondiProfileDensityFunction.hpp:45-110, profile math
    in BondiProfile.hpp — see models.bondi)."""
    from cmacionize_tpu import constants
    from cmacionize_tpu.models.bondi import BondiProfile

    profile = BondiProfile(
        central_mass=central_mass,
        bondi_density=bondi_density,
        sound_speed=sound_speed,
        center=tuple(center),
        ionisation_radius=ionisation_radius,
        pressure_contrast=pressure_contrast,
        vprof_radius=vprof_radius,
        vprof_velocity=vprof_velocity,
    )
    rho, velocity, pressure, xh = profile.evaluate(geometry.cell_centers())
    nd = rho / constants.PROTON_MASS
    # T from the ideal-gas law at the profile pressure (n k T = P)
    T = pressure / np.maximum(nd * constants.BOLTZMANN, 1e-300)
    return DensityFields(nd, T, xh, velocity=velocity)


def interpolated(geometry: GridGeometry, filename: str,
                 fallback_temperature: float = 8000.0) -> DensityFields:
    """Regular-grid interpolated density from a YAML-headed text file
    (/root/reference/src/InterpolatedDensityFunction.cpp:60-360): the header
    between two ``---`` lines declares num_x/y/z, axis bounds and the column
    layout; the body lists sample points; cell values are trilinear
    interpolations, with collapsed axes (num == 0) constant."""
    from cmacionize_tpu.utils.params import yaml_load

    with open(filename) as handle:
        text = handle.read()
    parts = text.split("---")
    if len(parts) < 3:
        raise ValueError(f"no YAML header block in {filename!r}")
    header = yaml_load(parts[1])
    body = parts[2]

    nums = {a: int(header[f"num_{a}"]) for a in "xyz"}
    bounds = {
        a: (
            parse_quantity(str(header[f"{a}min"]), "length"),
            parse_quantity(str(header[f"{a}max"]), "length"),
        )
        for a in "xyz"
    }
    num_column = int(header["num_column"])
    columns = {}
    units = {}
    for j in range(num_column):
        columns[str(header[f"column_{j}_variable"])] = j
        units[j] = str(header[f"column_{j}_unit"])

    rows = np.array(
        [
            [float(v) for v in line.split()]
            for line in body.strip().splitlines()
            if line.strip()
        ]
    )
    if "number density" not in columns:
        raise ValueError("no 'number density' column")

    def col_si(name, quantity):
        j = columns[name]
        return np.array(
            [parse_quantity(f"{v} {units[j]}", quantity) for v in rows[:, j]]
        )

    coords = {}
    for a in "xyz":
        if nums[a] > 1:
            coords[a] = np.unique(col_si(a, "length"))
            if coords[a].size != nums[a]:
                raise ValueError(
                    f"expected {nums[a]} distinct {a} values, got "
                    f"{coords[a].size}"
                )
        else:
            coords[a] = np.asarray(bounds[a])

    nd_col = col_si("number density", "number density")
    # sort rows lexicographically on the active axes, reshape (x, y, z)
    keys = []
    for a in "zyx":  # last key dominates in lexsort
        if nums[a] > 1:
            keys.append(col_si(a, "length"))
    order = np.lexsort(keys[::-1]) if keys else np.arange(nd_col.size)
    active_shape = tuple(nums[a] if nums[a] > 1 else 1 for a in "xyz")
    values = nd_col[order].reshape(active_shape)
    # replicate collapsed axes to both bound slots
    for d, a in enumerate("xyz"):
        if nums[a] <= 1:
            values = np.repeat(values, 2, axis=d)

    from scipy.interpolate import RegularGridInterpolator

    interp = RegularGridInterpolator(
        (coords["x"], coords["y"], coords["z"]), values,
        bounds_error=False, fill_value=None,
    )
    centers = geometry.cell_centers()
    nd = interp(centers.reshape(-1, 3)).reshape(geometry.shape)
    return DensityFields(
        nd,
        np.full(geometry.shape, fallback_temperature),
        np.full(geometry.shape, 1e-6),
    )


def spiral_galaxy(
    geometry: GridGeometry,
    central_density: float,
    scale_radius: float,
    scale_height: float,
    temperature: float = 0.0,
    cutoff: Optional[float] = None,
) -> DensityFields:
    """Double-exponential galactic ISM disc
    (cf. SpiralGalaxyDensityFunction.hpp — n = n0 e^{-R/rI} e^{-|z|/hI},
    truncated at 15 kpc)."""
    centers = geometry.cell_centers()
    R = np.sqrt(centers[..., 0] ** 2 + centers[..., 1] ** 2)
    z = np.abs(centers[..., 2])
    cutoff = cutoff if cutoff is not None else 15.0 * 3.086e19
    nd = np.where(
        (R < cutoff) & (z < cutoff),
        central_density * np.exp(-R / scale_radius - z / scale_height),
        0.0,
    )
    return DensityFields(
        nd, np.full(geometry.shape, temperature), np.ones(geometry.shape)
    )


def fractal_distribution(resolution, num_particles: int = 1000000,
                         num_levels: int = 4, fractal_dimension: float = 2.6,
                         seed: int = 42) -> np.ndarray:
    """Point-count field of a hierarchical fractal point distribution.

    Vectorized equivalent of FractalDensityMask::make_fractal_grid
    (/root/reference/src/FractalDensityMask.hpp:87-152): an N-ary tree of
    `num_levels` levels where every node jitters its parent position by a
    uniform offset of amplitude 2/L^level, with
    L = 10^(log10 N / D) and N = ceil(num_particles^(1/num_levels)).
    Leaf positions are mapped periodically into [0,1)³ and histogrammed on
    `resolution` cells. Returns an integer array [rx, ry, rz].
    """
    rng = np.random.default_rng(seed)
    N = int(np.ceil(num_particles ** (1.0 / num_levels)))
    L = 10.0 ** (np.log10(N) / fractal_dimension)

    positions = np.zeros((1, 3))
    for level in range(1, num_levels + 1):
        # each current node spawns N children (level-1 keeps 1:N fan-out from
        # the virtual root, matching the reference's N top-level seeds)
        n_nodes = positions.shape[0] * N
        offsets = (2.0 * (rng.uniform(size=(n_nodes, 3)) - 0.5)
                   / L**level)
        positions = np.repeat(positions, N, axis=0) + offsets

    # map [-1/L, 1/L]-ish coordinates to [0, 1) with periodic wrap
    positions = positions * 0.5 * L + 0.5
    positions -= np.floor(positions)

    idx = (positions * np.asarray(resolution)).astype(np.int64)
    idx = np.clip(idx, 0, np.asarray(resolution) - 1)
    flat = np.ravel_multi_index((idx[:, 0], idx[:, 1], idx[:, 2]), resolution)
    counts = np.bincount(flat, minlength=int(np.prod(resolution)))
    return counts.reshape(resolution)


def apply_fractal_mask(number_density, geometry: GridGeometry,
                       box_anchor=None, box_sides=None,
                       num_particles: int = 1000000, num_levels: int = 4,
                       fractal_dimension: float = 2.6,
                       fractal_fraction: float = 1.0,
                       resolution=None, seed: int = 42):
    """Overlay fractal substructure on a density field, conserving mass.

    Equivalent of FractalDensityMask::apply
    (/root/reference/src/FractalDensityMask.hpp:425-478): inside the mask
    box the density becomes (1-f)·n + f·norm·n·counts with `norm` chosen so
    the total mass in the box is unchanged.
    """
    n = np.asarray(number_density, dtype=np.float64)
    shape = n.shape
    anchor = np.asarray(box_anchor if box_anchor is not None
                        else geometry.anchor, dtype=float)
    sides = np.asarray(box_sides if box_sides is not None
                       else geometry.sides, dtype=float)
    if resolution is None:
        # default: one mask cell per grid cell inside the box
        frac = sides / np.asarray(geometry.sides)
        resolution = tuple(
            max(1, int(round(shape[i] * frac[i]))) for i in range(3))

    counts = fractal_distribution(resolution, num_particles, num_levels,
                                  fractal_dimension, seed)

    centers = np.stack(np.meshgrid(*[
        geometry.anchor[i] + (np.arange(shape[i]) + 0.5)
        * geometry.cell_size[i] for i in range(3)], indexing="ij"), axis=-1)
    inside = np.all((centers >= anchor) & (centers < anchor + sides), axis=-1)
    rel = (centers - anchor) / sides
    idx = np.clip((rel * np.asarray(resolution)).astype(np.int64), 0,
                  np.asarray(resolution) - 1)
    cell_counts = counts[idx[..., 0], idx[..., 1], idx[..., 2]]

    smooth_fraction = 1.0 - fractal_fraction
    n_in = np.where(inside, n, 0.0)
    n_total = n_in.sum()
    n_smooth = smooth_fraction * n_total
    n_fractal = (fractal_fraction * n_in * cell_counts).sum()
    if n_fractal <= 0.0:
        raise ValueError("fractal mask produced no points inside the box")
    norm = (n_total - n_smooth) / n_fractal

    masked = smooth_fraction * n + fractal_fraction * norm * n * cell_counts
    return np.where(inside, masked, n)


def density_function_from_params(params, geometry: GridGeometry
                                 ) -> DensityFields:
    """Factory: build the initial density/temperature fields from a
    parameter file, by `DensityFunction:type` string.

    Equivalent of DensityFunctionFactory::generate
    (/root/reference/src/DensityFunctionFactory.hpp:138-174). All 16
    reference type strings are supported: Homogeneous, BlockSyntax,
    AsciiFile, Interpolated, DiscIC, DiscPatch, BondiProfile,
    CoredDMProfile, SpiralGalaxy, FLASHSnapshot, AmunSnapshot,
    PhantomSnapshot, SPHNGSnapshot, GadgetSnapshot, CMacIonizeSnapshot,
    BufferedCMacIonizeSnapshot (the buffered reader is a C++ I/O
    optimization; here it reads identically to CMacIonizeSnapshot).
    A `DensityMask:type: Fractal` section overlays fractal substructure
    afterwards (DensityMaskFactory.hpp:64).
    """
    import numpy as np

    dftype = params.get_string("DensityFunction:type", "Homogeneous")
    temperature = params.get_physical_value(
        "DensityFunction:temperature", "temperature", "8000. K")

    velocity = None
    if dftype == "Homogeneous":
        nd = np.full(geometry.shape, params.get_physical_value(
            "DensityFunction:density", "number density", "100. cm^-3"))
        T = np.full(geometry.shape, temperature)
    elif dftype == "BlockSyntax":
        blocks = blocks_from_yaml(
            params.get_string("DensityFunction:filename"))
        fields = block_syntax(geometry, blocks)
        nd, T = np.asarray(fields.number_density), np.asarray(
            fields.temperature)
    elif dftype == "AsciiFile":
        from cmacionize_tpu.io.snapshots import read_ascii_snapshot

        snap = read_ascii_snapshot(
            params.get_string("DensityFunction:filename"), geometry.shape,
            geometry.anchor, geometry.sides)
        nd = snap.number_density
        T = snap.temperature if snap.temperature is not None else np.full(
            geometry.shape, temperature)
    elif dftype == "FLASHSnapshot":
        from cmacionize_tpu.io.snapshots import read_flash_snapshot

        snap = read_flash_snapshot(
            params.get_string("DensityFunction:filename"),
            fallback_temperature=temperature)
        nd = _resample_uniform(snap.number_density, geometry.shape)
        T = _resample_uniform(snap.temperature, geometry.shape)
    elif dftype == "AmunSnapshot":
        from cmacionize_tpu.io.snapshots import read_amun_snapshot

        snap = read_amun_snapshot(
            params.get_string("DensityFunction:folder", "."),
            params.get_string("DensityFunction:prefix"),
            params.get_int("DensityFunction:padding", 5),
            params.get_int("DensityFunction:number of files", 1),
            geometry.anchor, geometry.sides,
            average_number_density=params.get_physical_value(
                "DensityFunction:average number density", "number density",
                "100. cm^-3"),
            sound_speed=params.get_number(
                "DensityFunction:AMUN soundspeed", 0.1),
            average_temperature=params.get_physical_value(
                "DensityFunction:average temperature", "temperature",
                "100. K"))
        nd = _resample_uniform(snap.number_density, geometry.shape)
        T = _resample_uniform(snap.temperature, geometry.shape)
    elif dftype in ("PhantomSnapshot", "SPHNGSnapshot"):
        from cmacionize_tpu.api import _deposit_m_over_v
        from cmacionize_tpu.io.snapshots import (
            read_phantom_snapshot,
            read_sphng_snapshot,
        )

        reader = (read_phantom_snapshot if dftype == "PhantomSnapshot"
                  else read_sphng_snapshot)
        parts = reader(params.get_string("DensityFunction:filename"))
        nd = np.asarray(_deposit_m_over_v(
            geometry, parts.positions, parts.masses)) / 1.6737236e-27
        T = np.full(geometry.shape, temperature)
    elif dftype in ("GadgetSnapshot", "CMacIonizeSnapshot",
                    "BufferedCMacIonizeSnapshot"):
        from cmacionize_tpu.io.gadget import grid_from_snapshot

        filename = params.get_string("DensityFunction:filename")
        nd = grid_from_snapshot(filename, geometry, "NumberDensity")
        try:
            T = grid_from_snapshot(filename, geometry, "Temperature",
                                   fallback=None)
        except KeyError:
            T = np.full(geometry.shape, temperature)
    elif dftype == "Interpolated":
        fields = interpolated(
            geometry, params.get_string("DensityFunction:filename"),
            fallback_temperature=temperature)
        nd, T = fields.number_density, fields.temperature
    elif dftype == "DiscIC":
        fields = disc_ic(
            geometry,
            mass=params.get_physical_value(
                "DensityFunction:mass", "mass", "18. Msol"),
            temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "500. K"),
            bondi_density=params.get_physical_value(
                "DensityFunction:bondi density", "density", "1.e-16 g cm^-3"),
            density_power=params.get_number(
                "DensityFunction:density power", 1.5),
            bondi_velocity=params.get_physical_value(
                "DensityFunction:bondi velocity", "velocity", "0. m s^-1"),
            velocity_power=params.get_number(
                "DensityFunction:velocity power", 0.5),
            neutral_fraction=params.get_number(
                "DensityFunction:neutral fraction", 1.e-6),
        )
        nd, T, velocity = (fields.number_density, fields.temperature,
                           fields.velocity)
    elif dftype == "DiscPatch":
        fields = disc_patch(
            geometry,
            surface_density=params.get_physical_value(
                "DensityFunction:surface density", "surface density",
                "30. Msol pc^-2"),
            scale_height=params.get_physical_value(
                "DensityFunction:scale height", "length", "200. pc"),
            disc_z=params.get_physical_value(
                "DensityFunction:disc position", "length", "0. pc"),
            temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "1.e3 K"),
            gas_fraction=params.get_number(
                "DensityFunction:gas fraction", 0.1),
            neutral_fraction=params.get_number(
                "DensityFunction:neutral fraction", 1.0),
        )
        nd, T = fields.number_density, fields.temperature
    elif dftype == "BondiProfile":
        fields = bondi_profile_density(
            geometry,
            central_mass=params.get_physical_value(
                "DensityFunction:central mass", "mass", "18. Msol"),
            bondi_density=params.get_physical_value(
                "DensityFunction:Bondi density", "density", "1.e-19 g cm^-3"),
            sound_speed=params.get_physical_value(
                "DensityFunction:sound speed", "velocity", "2.031 km s^-1"),
            ionisation_radius=params.get_physical_value(
                "DensityFunction:ionisation radius", "length", "0. m"),
            pressure_contrast=params.get_number(
                "DensityFunction:pressure contrast", 32.0),
            center=params.get_physical_vector(
                "DensityFunction:center", "length", ["0. m"] * 3),
            vprof_radius=params.get_physical_value(
                "DensityFunction:vprof radius", "length", "0. m"),
            vprof_velocity=params.get_physical_value(
                "DensityFunction:vprof velocity", "velocity", "0. m s^-1"),
        )
        nd, T, velocity = (fields.number_density, fields.temperature,
                           fields.velocity)
        xh_field = fields.neutral_fraction
    elif dftype == "CoredDMProfile":
        fields = cored_dm_profile(
            geometry,
            core_radius=params.get_physical_value(
                "DensityFunction:core radius", "length", "300. pc"),
            max_circular_velocity=params.get_physical_value(
                "DensityFunction:maximum circular velocity", "velocity",
                "21.1 km s^-1"),
            central_density=params.get_physical_value(
                "DensityFunction:central density", "density",
                "9.48e-21 g cm^-3"),
            temperature=params.get_physical_value(
                "DensityFunction:temperature", "temperature", "500. K"),
            neutral_fraction=params.get_number(
                "DensityFunction:neutral fraction", 1.0),
            polytropic_index=params.get_number(
                "DensityFunction:polytropic index", 1.0),
        )
        nd, T = fields.number_density, fields.temperature
    elif dftype == "SpiralGalaxy":
        fields = spiral_galaxy(
            geometry,
            central_density=params.get_physical_value(
                "DensityFunction:central density", "number density",
                "1. cm^-3"),
            scale_radius=params.get_physical_value(
                "DensityFunction:scale length ISM", "length", "6. kpc"),
            scale_height=params.get_physical_value(
                "DensityFunction:scale height ISM", "length", "0.22 kpc"),
            temperature=temperature,
        )
        nd, T = fields.number_density, fields.temperature
    else:
        raise ValueError(f"unknown DensityFunction type '{dftype}'")

    mask_type = params.get_string("DensityMask:type", "None")
    if mask_type == "Fractal":
        nd = apply_fractal_mask(
            nd, geometry,
            num_particles=params.get_int(
                "DensityMask:number of particles", 1000000),
            num_levels=params.get_int("DensityMask:number of levels", 4),
            fractal_dimension=params.get_number(
                "DensityMask:fractal dimension", 2.6),
            fractal_fraction=params.get_number(
                "DensityMask:fractal fraction", 1.0),
            seed=params.get_int("DensityMask:random seed", 42))
    elif mask_type != "None":
        raise ValueError(f"unknown DensityMask type '{mask_type}'")

    xh0 = params.get_number("DensityFunction:initial neutral fraction", 1e-6)
    xh = (np.asarray(locals().get("xh_field"))
          if "xh_field" in locals() else np.full(geometry.shape, xh0))
    return DensityFields(number_density=np.asarray(nd),
                         temperature=np.asarray(T),
                         neutral_fraction=xh,
                         velocity=velocity)


def _resample_uniform(field, shape):
    """Nearest-neighbour resample of a uniform grid onto `shape`."""
    import numpy as np

    field = np.asarray(field)
    idx = [np.minimum((np.arange(shape[d]) + 0.5) / shape[d]
                      * field.shape[d], field.shape[d] - 1).astype(int)
           for d in range(3)]
    return field[np.ix_(*idx)]
