"""Photon sources: spatial distributions and spectra.

Replaces the reference's PhotonSourceDistribution / PhotonSourceSpectrum
factories (/root/reference/src/PhotonSourceDistributionFactory.hpp:106-128,
PhotonSourceSpectrumFactory.hpp:93-114).  Emission is *sampling*: a source
model turns a PRNG key into fixed-shape arrays of packet positions,
directions, target optical depths and frequencies, which feed straight into
the traversal kernel — the reference's per-photon `get_random_photon`
(/root/reference/src/PhotonSource.cpp:189-256) becomes one vectorized draw.

Spectra sample frequencies by tabulated inverse-CDF lookup, the same scheme
as the reference's 1000-bin spectrum tables
(/root/reference/src/PlanckPhotonSourceSpectrum.cpp:58-110).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu import constants


def isotropic_directions(key, n: int, dtype=jnp.float32):
    """Sample n isotropic unit vectors → ([n] dx, [n] dy, [n] dz)."""
    key_cos, key_phi = jax.random.split(key)
    cos_theta = jax.random.uniform(key_cos, (n,), dtype, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = jax.random.uniform(key_phi, (n,), dtype, 0.0, 2.0 * np.pi)
    return sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta


def sample_tau_targets(key, n: int, dtype=jnp.float32):
    """Target optical depths τ = -ln ξ (cf. IonizationPhotonShootJob)."""
    xi = jax.random.uniform(key, (n,), dtype, 0.0, 1.0)
    # 1-ξ avoids log(0); ξ ∈ [0, 1)
    return -jnp.log1p(-xi)


@dataclasses.dataclass(frozen=True)
class PointSource:
    """A discrete point source (SingleStar distribution,
    /root/reference/src/SingleStarPhotonSourceDistribution.hpp)."""

    position: Tuple[float, float, float]  # SI
    luminosity: float  # ionizing photons / s


@dataclasses.dataclass(frozen=True)
class MonochromaticSpectrum:
    """All photons at one frequency
    (/root/reference/src/MonochromaticPhotonSourceSpectrum.hpp)."""

    frequency: float  # Hz

    def sample(self, key, n: int, dtype=jnp.float32):
        return jnp.full((n,), self.frequency, dtype)


@dataclasses.dataclass(frozen=True)
class TabulatedSpectrum:
    """Inverse-CDF sampling of a tabulated spectrum in photon-number space.

    ``frequencies``/``cdf`` are 1D tables with cdf[0] = 0, cdf[-1] = 1.
    """

    frequencies: np.ndarray
    cdf: np.ndarray

    def sample(self, key, n: int, dtype=jnp.float32):
        xi = jax.random.uniform(key, (n,), dtype, 0.0, 1.0)
        freqs = jnp.asarray(self.frequencies, dtype)
        cdf = jnp.asarray(self.cdf, dtype)
        return jnp.interp(xi, cdf, freqs)


def planck_spectrum(
    temperature: float,
    nu_min: float = 3.288e15,
    nu_max: float = 4.0 * 3.288e15,
    n_bins: int = 1000,
) -> TabulatedSpectrum:
    """Ionizing-range blackbody photon-number spectrum B_ν/(hν) ∝ ν²/(e^{hν/kT}-1).

    Tabulated inverse CDF over [ν_ion_H, 4 ν_ion_H] with 1000 bins, matching
    /root/reference/src/PlanckPhotonSourceSpectrum.cpp:58-110.
    """
    nu = np.linspace(nu_min, nu_max, n_bins)
    x = constants.PLANCK * nu / (constants.BOLTZMANN * temperature)
    # photon number density ∝ ν² / (exp(x) - 1); use expm1 for stability
    pdf = nu**2 / np.expm1(x)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(nu))])
    cdf /= cdf[-1]
    return TabulatedSpectrum(frequencies=nu, cdf=cdf)


def emit_point_source(
    key,
    n: int,
    grid_position,
    spectrum=None,
    dtype=jnp.float32,
    nudge: float = 1e-4,
):
    """Emit n packets from a point source at `grid_position` (cell units).

    Returns SoA arrays (px, py, pz, dx, dy, dz, tau, freq_or_None, weight).
    Positions are nudged a tiny fraction of a cell along the direction so
    packets born exactly on a cell corner don't need degenerate zero-length
    steps.
    """
    key_dir, key_tau, key_freq = jax.random.split(key, 3)
    dx, dy, dz = isotropic_directions(key_dir, n, dtype)
    tau = sample_tau_targets(key_tau, n, dtype)
    gx, gy, gz = (jnp.asarray(g, dtype) for g in grid_position)
    px = gx + nudge * dx
    py = gy + nudge * dy
    pz = gz + nudge * dz
    freq = None if spectrum is None else spectrum.sample(key_freq, n, dtype)
    weight = jnp.ones((n,), dtype)
    return px, py, pz, dx, dy, dz, tau, freq, weight


def uniform_spectrum(
    nu_min: float = 3.288e15, nu_max: float = 4.0 * 3.288e15
) -> TabulatedSpectrum:
    """Flat photon-number spectrum over the ionizing range
    (/root/reference/src/UniformPhotonSourceSpectrum.hpp)."""
    nu = np.linspace(nu_min, nu_max, 2)
    return TabulatedSpectrum(frequencies=nu, cdf=np.asarray([0.0, 1.0]))


def faucher_giguere_spectrum(redshift: float = 0.0) -> TabulatedSpectrum:
    """Faucher-Giguère et al. UV-background spectrum at a given redshift.

    Equivalent of /root/reference/src/FaucherGiguerePhotonSourceSpectrum.cpp:
    the published December-2011 UVB tables (repackaged in
    cmacionize_tpu/data/fg_uvb_dec11.npz; J_ν in 1e-21 erg s⁻¹ cm⁻² Hz⁻¹
    sr⁻¹, ν in Rydberg) are linearly interpolated in redshift and converted
    to a photon-number inverse-CDF over the ionizing range [ν_H, 4 ν_H].
    """
    from cmacionize_tpu.data import _load

    data = _load("fg_uvb_dec11.npz")
    redshifts = data["redshifts"]
    if not (redshifts[0] <= redshift <= redshifts[-1]):
        raise ValueError(f"redshift {redshift} outside table range")
    iz = int(np.searchsorted(redshifts, redshift))
    iz = max(1, min(iz, len(redshifts) - 1))
    zlo, zhi = redshifts[iz - 1], redshifts[iz]
    frac = 0.0 if zhi == zlo else (redshift - zlo) / (zhi - zlo)
    J = (1.0 - frac) * data["J_nu"][iz - 1] + frac * data["J_nu"][iz]

    freqs = data["frequencies_ryd"] * 3.289e15  # Ryd -> Hz
    mask = (freqs >= 3.288e15) & (freqs <= 4.0 * 3.288e15)
    nu = freqs[mask]
    # photon-number spectrum: J_nu / (h nu); constants cancel in the CDF
    pdf = J[mask] / nu
    cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(nu))]
    )
    cdf /= cdf[-1]
    return TabulatedSpectrum(frequencies=nu, cdf=cdf)


def masked_spectrum(
    spectrum: TabulatedSpectrum, mask_fn, n_bins: int = 1000
) -> TabulatedSpectrum:
    """Apply a transmission mask (ν → [0, 1]) to a spectrum.

    Equivalent of MaskedPhotonSourceSpectrum + the
    LinearPhotonSourceSpectrumMask family
    (/root/reference/src/PhotonSourceSpectrumMaskFactory.hpp:63): the
    masked PDF is re-tabulated and renormalized.
    """
    nu = np.linspace(spectrum.frequencies[0], spectrum.frequencies[-1], n_bins)
    cdf_at = np.interp(nu, spectrum.frequencies, spectrum.cdf)
    pdf = np.gradient(cdf_at, nu)
    pdf = pdf * np.asarray([mask_fn(v) for v in nu])
    cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(nu))]
    )
    if cdf[-1] <= 0:
        raise ValueError("mask removed the entire spectrum")
    return TabulatedSpectrum(frequencies=nu, cdf=cdf / cdf[-1])


def linear_mask(nu_zero: float, nu_one: float):
    """Linear transmission ramp between two frequencies
    (LinearPhotonSourceSpectrumMask)."""

    def mask(nu):
        t = (nu - nu_zero) / (nu_one - nu_zero)
        return float(np.clip(t, 0.0, 1.0))

    return mask


@dataclasses.dataclass(frozen=True)
class DiscreteSourceSet:
    """Multiple discrete point sources with individual luminosities.

    Covers the reference's list-style PhotonSourceDistributions
    (AsciiFile/UniformRandom/..., factory at
    /root/reference/src/PhotonSourceDistributionFactory.hpp:106-128): the
    emitting source of each packet is sampled proportionally to luminosity,
    the JAX equivalent of the reference's per-source photon-count
    split (PhotonSource.cpp:120-180).
    """

    positions: np.ndarray  # [n_src, 3] SI
    luminosities: np.ndarray  # [n_src] photons/s

    @property
    def total_luminosity(self) -> float:
        return float(np.sum(self.luminosities))

    @classmethod
    def single(cls, position, luminosity) -> "DiscreteSourceSet":
        return cls(np.asarray([position], dtype=float), np.asarray([luminosity]))

    @classmethod
    def from_ascii(cls, filename: str) -> "DiscreteSourceSet":
        """Plain-text source list: x y z luminosity per row (SI), '#' comments
        (AsciiFilePhotonSourceDistribution equivalent)."""
        data = np.atleast_2d(np.loadtxt(filename))
        return cls(data[:, :3], data[:, 3])

    @classmethod
    def uniform_random(
        cls, key_or_seed, n_sources, anchor, sides, luminosity_per_source
    ) -> "DiscreteSourceSet":
        """n random sources in the box (UniformRandomPhotonSourceDistribution)."""
        rng = np.random.default_rng(key_or_seed)
        positions = rng.uniform(0.0, 1.0, (n_sources, 3)) * np.asarray(
            sides
        ) + np.asarray(anchor)
        return cls(positions, np.full(n_sources, luminosity_per_source))


def emit_source_set(
    key,
    n: int,
    source_set: DiscreteSourceSet,
    geometry,
    spectrum=None,
    dtype=jnp.float32,
    nudge: float = 1e-4,
):
    """Emit n packets from a weighted set of point sources (grid units).

    Returns the same SoA tuple as emit_point_source.
    """
    key_src, key_dir, key_tau, key_freq = jax.random.split(key, 4)
    lum = np.asarray(source_set.luminosities, dtype=float)
    probs = lum / lum.sum()
    gpos = np.stack(
        [geometry.position_to_grid_coords(p) for p in source_set.positions]
    )
    src = jax.random.choice(
        key_src, len(lum), (n,), p=jnp.asarray(probs, jnp.float32)
    )
    gpos_j = jnp.asarray(gpos, dtype)
    dx, dy, dz = isotropic_directions(key_dir, n, dtype)
    tau = sample_tau_targets(key_tau, n, dtype)
    px = gpos_j[src, 0] + nudge * dx
    py = gpos_j[src, 1] + nudge * dy
    pz = gpos_j[src, 2] + nudge * dz
    freq = None if spectrum is None else spectrum.sample(key_freq, n, dtype)
    weight = jnp.ones((n,), dtype)
    return px, py, pz, dx, dy, dz, tau, freq, weight


def emit_isotropic_external(key, n, shape, spectrum=None, dtype=jnp.float32):
    """Emit n packets entering the box through its walls from an isotropic
    external radiation field.

    Equivalent of IsotropicContinuousPhotonSource
    (/root/reference/src/IsotropicContinuousPhotonSource.hpp, factory at
    ContinuousPhotonSourceFactory.hpp:78-91): entry points are uniform over
    the surface (area-weighted face choice) and entry directions follow the
    cosine law (flux-weighted isotropy).

    Returns the same SoA tuple as emit_point_source (positions in cell units).
    """
    keys = jax.random.split(key, 6)
    nx, ny, nz = shape
    areas = np.array([ny * nz, ny * nz, nx * nz, nx * nz, nx * ny, nx * ny], float)
    face = jax.random.choice(
        keys[0], 6, (n,), p=jnp.asarray(areas / areas.sum(), jnp.float32)
    )
    u1 = jax.random.uniform(keys[1], (n,), dtype)
    u2 = jax.random.uniform(keys[2], (n,), dtype)
    # cosine-law polar angle about the inward normal + uniform azimuth
    cos_t = jnp.sqrt(jax.random.uniform(keys[3], (n,), dtype, 1e-6, 1.0))
    sin_t = jnp.sqrt(1.0 - cos_t**2)
    phi = jax.random.uniform(keys[4], (n,), dtype, 0.0, 2.0 * np.pi)
    ca, sa = jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t

    # position on the chosen face (nudged just inside the wall)
    px = jnp.where(face == 0, 1e-4, jnp.where(face == 1, nx - 1e-4, u1 * nx))
    py = jnp.where(face == 2, 1e-4, jnp.where(face == 3, ny - 1e-4,
                   jnp.where(face < 2, u1 * ny, u2 * ny)))
    pz = jnp.where(face == 4, 1e-4, jnp.where(face == 5, nz - 1e-4, u2 * nz))
    # direction: cos_t along the inward normal, sin_t in the face plane.
    # per-face orthonormal frame (inward normal, t1, t2), selected by gather
    normals = jnp.asarray(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype,
    )
    tangent1 = jnp.asarray(
        [[0, 1, 0], [0, 1, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0], [1, 0, 0]],
        dtype,
    )
    tangent2 = jnp.asarray(
        [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0], [0, 1, 0]],
        dtype,
    )
    nvec = normals[face]
    t1 = tangent1[face]
    t2 = tangent2[face]
    dvec = (
        cos_t[:, None] * nvec + ca[:, None] * t1 + sa[:, None] * t2
    )
    dx, dy, dz = dvec[:, 0], dvec[:, 1], dvec[:, 2]

    tau = sample_tau_targets(keys[5], n, dtype)
    freq = None if spectrum is None else spectrum.sample(keys[5], n, dtype)
    weight = jnp.ones((n,), dtype)
    return px, py, pz, dx, dy, dz, tau, freq, weight


def emit_planar(key, n, shape, axis: int = 2, plane_coord: float = 0.5,
                anchors=(0.0, 0.0), sides=(1.0, 1.0), spectrum=None,
                dtype=jnp.float32):
    """Emit n packets from a rectangular plane inside the box, isotropically.

    Equivalent of PlanarContinuousPhotonSource
    (/root/reference/src/PlanarContinuousPhotonSource.hpp:39-230): positions
    uniform over the rectangle at grid coordinate `plane_coord` along `axis`
    (all in cell units), directions isotropic.
    """
    keys = jax.random.split(key, 4)
    u1 = jax.random.uniform(keys[0], (n,), dtype)
    u2 = jax.random.uniform(keys[1], (n,), dtype)
    coords = [None, None, None]
    plane_axes = [i for i in range(3) if i != axis]
    coords[axis] = jnp.full((n,), plane_coord, dtype)
    coords[plane_axes[0]] = anchors[0] + u1 * sides[0]
    coords[plane_axes[1]] = anchors[1] + u2 * sides[1]
    dx, dy, dz = isotropic_directions(keys[2], n, dtype)
    tau = sample_tau_targets(keys[3], n, dtype)
    freq = None if spectrum is None else spectrum.sample(keys[3], n, dtype)
    weight = jnp.ones((n,), dtype)
    return coords[0], coords[1], coords[2], dx, dy, dz, tau, freq, weight


def emit_extended_disc(key, n, shape, axis: int = 2, origin: float = 0.5,
                       scale_height: float = 0.1, spectrum=None,
                       dtype=jnp.float32):
    """Emit n packets from a Gaussian disc layer filling the box in-plane.

    Equivalent of ExtendedDiscContinuousPhotonSource
    (/root/reference/src/ExtendedDiscContinuousPhotonSource.hpp:183-228):
    positions uniform in the disc plane, Gaussian along `axis` with the
    given origin/scale height (cell units), re-drawn until inside the box
    (here: 8 masked redraw rounds, then clamped — the tail fraction beyond
    8 redraws is < 1e-6 for any scale height that fits the box), directions
    isotropic.
    """
    keys = jax.random.split(key, 5)
    nx, ny, nz = shape
    dims = jnp.asarray(shape, dtype)
    u1 = jax.random.uniform(keys[0], (n,), dtype)
    u2 = jax.random.uniform(keys[1], (n,), dtype)
    extent = dims[axis]

    def gauss(k):
        a, b = jax.random.split(k)
        r = jnp.sqrt(-2.0 * jnp.log(jax.random.uniform(a, (n,), dtype,
                                                       1e-12, 1.0)))
        return origin + scale_height * r * jnp.cos(
            2.0 * jnp.pi * jax.random.uniform(b, (n,), dtype))

    z = gauss(keys[2])
    redraw_keys = jax.random.split(keys[3], 8)
    for rk in redraw_keys:
        bad = (z < 0.0) | (z >= extent)
        z = jnp.where(bad, gauss(rk), z)
    z = jnp.clip(z, 1e-4, extent - 1e-4)

    coords = [None, None, None]
    plane_axes = [i for i in range(3) if i != axis]
    coords[axis] = z
    coords[plane_axes[0]] = u1 * dims[plane_axes[0]]
    coords[plane_axes[1]] = u2 * dims[plane_axes[1]]
    dkey, tkey = jax.random.split(keys[4])
    dx, dy, dz = isotropic_directions(dkey, n, dtype)
    tau = sample_tau_targets(tkey, n, dtype)
    freq = None if spectrum is None else spectrum.sample(tkey, n, dtype)
    weight = jnp.ones((n,), dtype)
    return coords[0], coords[1], coords[2], dx, dy, dz, tau, freq, weight


def emit_distant_star(key, n, shape, star_position, spectrum=None,
                      dtype=jnp.float32):
    """Emit n packets entering the box from a far-away point source.

    Equivalent of DistantStarContinuousPhotonSource
    (/root/reference/src/DistantStarContinuousPhotonSource.hpp:203-226):
    the reference draws isotropic rays from the star and rejects until one
    enters the box; conditioned on hitting, that is uniform solid-angle
    sampling within the cone subtending the box. We sample that cone
    directly (uniform in solid angle over the box's bounding cone) and
    resolve the residual cone-vs-box misses with 16 masked redraw rounds —
    the same conditional distribution with bounded work.

    Returns the usual SoA tuple; weights are 0 for the (rare) lanes that
    never hit the box.
    """
    keys = jax.random.split(key, 3)
    dims = jnp.asarray(shape, dtype)
    star = jnp.asarray(star_position, dtype)

    # bounding cone of the box as seen from the star
    center = 0.5 * dims
    to_box = center - star
    dist = jnp.sqrt(jnp.sum(to_box**2))
    axis_v = to_box / jnp.maximum(dist, 1e-12)
    radius = 0.5 * jnp.sqrt(jnp.sum(dims**2))  # half-diagonal
    sin_max = jnp.clip(radius / jnp.maximum(dist, 1e-12), 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_max**2))
    # orthonormal frame (axis_v, e1, e2)
    helper = jnp.where(jnp.abs(axis_v[0]) < 0.9,
                       jnp.asarray([1.0, 0.0, 0.0], dtype),
                       jnp.asarray([0.0, 1.0, 0.0], dtype))
    e1 = jnp.cross(axis_v, helper)
    e1 = e1 / jnp.sqrt(jnp.sum(e1**2))
    e2 = jnp.cross(axis_v, e1)

    def draw(k):
        ka, kb = jax.random.split(k)
        # uniform in solid angle within the cone: cosθ ~ U[cos_max, 1]
        cos_t = jax.random.uniform(kb, (n,), dtype, cos_max, 1.0)
        sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t**2))
        phi = jax.random.uniform(ka, (n,), dtype, 0.0, 2.0 * jnp.pi)
        return (cos_t[:, None] * axis_v[None, :]
                + (sin_t * jnp.cos(phi))[:, None] * e1[None, :]
                + (sin_t * jnp.sin(phi))[:, None] * e2[None, :])

    def entry(d):
        # slab test from the star position
        safe = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
        t0 = (0.0 - star[None, :]) / safe
        t1 = (dims[None, :] - star[None, :]) / safe
        tmin = jnp.max(jnp.minimum(t0, t1), axis=1)
        tmax = jnp.min(jnp.maximum(t0, t1), axis=1)
        hits = (tmax > tmin) & (tmin > 0.0)
        pos = star[None, :] + (tmin[:, None] + 1e-4) * d
        return hits, pos

    d = draw(keys[0])
    hits, pos = entry(d)
    for rk in jax.random.split(keys[1], 16):
        nd = draw(rk)
        nhits, npos = entry(nd)
        take = (~hits) & nhits
        d = jnp.where(take[:, None], nd, d)
        pos = jnp.where(take[:, None], npos, pos)
        hits = hits | nhits

    tkey, fkey = jax.random.split(keys[2])
    tau = sample_tau_targets(tkey, n, dtype)
    freq = None if spectrum is None else spectrum.sample(fkey, n, dtype)
    weight = hits.astype(dtype)
    return (pos[:, 0], pos[:, 1], pos[:, 2], d[:, 0], d[:, 1], d[:, 2],
            tau, freq, weight)
