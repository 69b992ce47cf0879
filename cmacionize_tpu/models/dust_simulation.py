"""Dust-scattering radiative transfer with CCD imaging.

Equivalent of the reference's DustSimulation mode
(/root/reference/src/DustSimulation.cpp, DustScattering.cpp,
CCDImage.hpp, SpiralGalaxyDensityFunction.hpp,
SpiralGalaxyContinuousPhotonSource.hpp): photons from a spiral-galaxy
stellar distribution scatter off a double-exponential dust disc; a virtual
CCD accumulates the surface-brightness image via the peel-off technique
(every emission/scattering event contributes weight × phase(θ_obs) ×
exp(-τ_to_observer) to its projected pixel).

Design: emission, Henyey-Greenstein scattering, and the peel-off
optical-depth integration all run as whole-batch array passes — the peel-off
τ integration reuses the traversal kernel in "propagate" mode (zero-weight
packets accumulate optical depth without tallies,
cf. `DensitySubGrid::propagate`, /root/reference/src/DensitySubGrid.hpp:1284).

`run()` transports intensity only; `run_polarized()` carries the full
Stokes vector through every scattering (White 1979 matrix, see
ops/polarization.py) like the reference's DustScattering.cpp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu.models.grid import GridGeometry
from cmacionize_tpu.ops import traversal
from cmacionize_tpu.utils.logging import Log, NullLog

KPC = 3.086e19

# V-band dust properties, cf. DustScattering.hpp get_*_for_band ("V")
HGG_V = 0.44  # Henyey-Greenstein asymmetry
ALBEDO_V = 0.67
KAPPA_V = 0.4 * 2.941e-2  # opacity placeholder; configured per run


@dataclasses.dataclass(frozen=True)
class DustConfig:
    geometry: GridGeometry
    # double-exponential dust disc (SpiralGalaxyDensityFunction)
    dust_central_density: float  # central opacity density  kappa*rho (m^-1)
    dust_scale_radius: float
    dust_scale_height: float
    # stellar emission disc + bulge (SpiralGalaxyContinuousPhotonSource)
    stellar_scale_radius: float
    stellar_scale_height: float
    n_photons: int
    albedo: float = ALBEDO_V
    hgg: float = HGG_V
    #: maximum scattering orders.  The reference loops until the photon
    #: leaves the grid (DustPhotonShootJob.hpp:133-160); order k carries
    #: weight albedo^k, so truncation error is bounded by albedo^(n+1)
    #: (~1% of the scattered flux at 12 orders for the V band's 0.67) —
    #: the round-4 image comparison measured a 45%-dim scattered halo at
    #: the old cap of 3
    n_scatterings: int = 12
    #: fraction of the luminosity from the spherical bulge (reference
    #: B_over_T with its fixed rC = 0.2 kpc / rB = 2 kpc / rJ = 0.4 kpc
    #: cutoff/Jaffe radii, SpiralGalaxyContinuousPhotonSource.hpp:58-66;
    #: its absence left our galaxy centers 2x dim in the round-4 image
    #: comparison)
    bulge_over_total: float = 0.2
    ccd_pixels: Tuple[int, int] = (128, 128)
    # observer along +z by default (face-on image)
    observer_direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    # reference CCD parameterization (CCDImage.hpp:128-133): when view angles
    # are given they override observer_direction, and the image plane axes are
    # e1 = (-sinφ, cosφ, 0), e2 = (-cosθ cosφ, -cosθ sinφ, sinθ)
    # (CCDImage::add_photon, CCDImage.hpp:245-252)
    view_theta: Optional[float] = None  # radians
    view_phi: Optional[float] = None
    # image-plane window in SI (CCDImage anchor x/y, sides x/y); None → box
    ccd_anchor: Optional[Tuple[float, float]] = None
    ccd_sides: Optional[Tuple[float, float]] = None
    # polarized transport (full Stokes; DustScattering.cpp White-1979 matrix)
    polarization: bool = False
    pl: float = 0.43  # peak linear polarization (V band)
    pc: float = 0.0
    sc: float = 0.0


def henyey_greenstein_cos(key, g, n):
    """Sample cosθ from the HG phase function (Witt 1977 eq. 19)."""
    xi = jax.random.uniform(key, (n,), jnp.float32)
    g = jnp.asarray(g, jnp.float32)
    term = (1.0 - g * g) / (1.0 - g + 2.0 * g * xi)
    return jnp.clip(
        (1.0 + g * g - term * term) / (2.0 * g + 1e-12), -1.0, 1.0
    )


def henyey_greenstein_phase(cos_theta, g):
    """HG phase function normalized over solid angle."""
    return (
        (1.0 - g * g)
        / (4.0 * np.pi * (1.0 + g * g - 2.0 * g * cos_theta) ** 1.5)
    )


def _rotate_to_new_direction(key, dx, dy, dz, cos_scat):
    """New direction at angle arccos(cos_scat) from (dx,dy,dz), random
    azimuth."""
    n = dx.shape[0]
    phi = jax.random.uniform(key, (n,), jnp.float32, 0.0, 2.0 * np.pi)
    sin_scat = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_scat**2))
    # build an orthonormal basis (u, v, d): pick the helper axis a least
    # aligned with d — a = x̂ when d is nearly ±ẑ, else ẑ; u = (a × d)/|a × d|
    near_z = jnp.abs(dz) > 0.99
    ax = jnp.where(near_z, 1.0, 0.0)
    az = jnp.where(near_z, 0.0, 1.0)
    cx = -az * dy
    cy = az * dx - ax * dz
    cz = ax * dy
    norm = jnp.sqrt(cx * cx + cy * cy + cz * cz) + 1e-20
    ux, uy, uz = cx / norm, cy / norm, cz / norm
    # v = d × u
    vx = dy * uz - dz * uy
    vy = dz * ux - dx * uz
    vz = dx * uy - dy * ux
    ndx = cos_scat * dx + sin_scat * (jnp.cos(phi) * ux + jnp.sin(phi) * vx)
    ndy = cos_scat * dy + sin_scat * (jnp.cos(phi) * uy + jnp.sin(phi) * vy)
    ndz = cos_scat * dz + sin_scat * (jnp.cos(phi) * uz + jnp.sin(phi) * vz)
    norm = jnp.sqrt(ndx**2 + ndy**2 + ndz**2) + 1e-20
    return ndx / norm, ndy / norm, ndz / norm


class DustSimulation:
    """Monte Carlo dust scattering producing a CCD surface-brightness map."""

    def __init__(self, config: DustConfig, log: Optional[Log] = None, seed: int = 42):
        if config.view_theta is not None:
            th = float(config.view_theta)
            ph = float(config.view_phi or 0.0)
            config = dataclasses.replace(
                config,
                observer_direction=(
                    np.sin(th) * np.cos(ph),
                    np.sin(th) * np.sin(ph),
                    np.cos(th),
                ),
            )
        self.config = config
        self.log = log or NullLog()
        self.key = jax.random.PRNGKey(seed)
        geom = config.geometry
        self.dx = float(geom.cell_size[0])

        # image-plane basis (CCDImage.hpp:245-252); for the default face-on
        # observer this reduces to e1=x̂, e2=ŷ up to sign
        obs = np.asarray(self.config.observer_direction, np.float64)
        obs = obs / np.linalg.norm(obs)
        cos_t = np.clip(obs[2], -1.0, 1.0)
        sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
        if sin_t > 1e-12:
            cos_p, sin_p = obs[0] / sin_t, obs[1] / sin_t
        else:
            cos_p, sin_p = 1.0, 0.0
        self._e1 = np.array([-sin_p, cos_p, 0.0], np.float64)
        self._e2 = np.array(
            [-cos_t * cos_p, -cos_t * sin_p, sin_t], np.float64
        )
        half = 0.5 * np.asarray(geom.sides, np.float64)
        corner_reach = np.abs(half[0]) + np.abs(half[1]) + np.abs(half[2])
        r1 = np.abs(self._e1 * half).sum()
        r2 = np.abs(self._e2 * half).sum()
        del corner_reach
        anchor = config.ccd_anchor or (-r1, -r2)
        sides = config.ccd_sides or (2.0 * r1, 2.0 * r2)
        self._ccd_anchor = np.asarray(anchor, np.float64)
        self._ccd_sides = np.asarray(sides, np.float64)

        centers = geom.cell_centers()
        w = np.sqrt(centers[..., 0] ** 2 + centers[..., 1] ** 2)
        z = np.abs(centers[..., 2])
        chi = (
            config.dust_central_density
            * np.exp(-w / config.dust_scale_radius - z / config.dust_scale_height)
        )
        # opacity per cell-unit length
        self.chi = jnp.asarray((chi * self.dx).reshape(-1), jnp.float32)

    def _emit(self, key, n):
        """Sample emission positions from the stellar double-exponential disc
        plus the spherical bulge (grid units) and isotropic directions.

        Mirrors SpiralGalaxyContinuousPhotonSource
        (/root/reference/src/SpiralGalaxyContinuousPhotonSource.hpp:104-150):
        with probability B/T·(1 − A_C/A_B) the photon comes from the bulge,
        whose radius inverts A = u·A_B + (1−u)·A_C with A_X = r_X/(r_X+r_J);
        out-of-box draws carry zero weight (same effective distribution as
        the reference's resampling loop)."""
        cfg = self.config
        geom = cfg.geometry
        keys = jax.random.split(key, 9)
        # radius: gamma(2) distribution for an exponential disc surface
        u1 = jax.random.uniform(keys[0], (n,), jnp.float32, 1e-7, 1.0)
        u2 = jax.random.uniform(keys[1], (n,), jnp.float32, 1e-7, 1.0)
        radius = -cfg.stellar_scale_radius * jnp.log(u1 * u2)
        phi = jax.random.uniform(keys[2], (n,), jnp.float32, 0, 2 * np.pi)
        u3 = jax.random.uniform(keys[3], (n,), jnp.float32, 1e-7, 1.0)
        sign = jnp.sign(jax.random.uniform(keys[4], (n,), jnp.float32) - 0.5)
        height = -cfg.stellar_scale_height * jnp.log(u3) * sign
        x = radius * jnp.cos(phi)
        y = radius * jnp.sin(phi)
        pos_si = jnp.stack([x, y, height], 1)

        if cfg.bulge_over_total > 0.0:
            r_C, r_B, r_J = 0.2 * KPC, 2.0 * KPC, 0.4 * KPC
            A_B = r_B / (r_B + r_J)
            A_C = r_C / (r_C + r_J)
            p_bulge = cfg.bulge_over_total * (1.0 - A_C / A_B)
            u = jax.random.uniform(keys[5], (n,), jnp.float32)
            A = u * A_B + (1.0 - u) * A_C
            r_bulge = r_J / (1.0 / A - 1.0)
            phi_b = jax.random.uniform(
                keys[6], (n,), jnp.float32, 0, 2 * np.pi)
            cost = jax.random.uniform(keys[7], (n,), jnp.float32, -1.0, 1.0)
            sint = jnp.sqrt(jnp.maximum(1.0 - cost**2, 0.0))
            bulge_pos = jnp.stack([
                r_bulge * sint * jnp.cos(phi_b),
                r_bulge * sint * jnp.sin(phi_b),
                r_bulge * cost,
            ], 1)
            is_bulge = jax.random.uniform(
                keys[8], (n,), jnp.float32) <= p_bulge
            pos_si = jnp.where(is_bulge[:, None], bulge_pos, pos_si)
        anchor = jnp.asarray(geom.anchor, jnp.float32)
        cell = jnp.asarray(geom.cell_size, jnp.float32)
        gpos = (pos_si - anchor) / cell
        shape_arr = jnp.asarray(geom.shape, jnp.float32)
        # photons sampled outside the box carry zero weight (the reference's
        # continuous sources only emit inside the box)
        valid = jnp.all((gpos >= 0.0) & (gpos < shape_arr), axis=1)
        return jnp.clip(gpos, 0.0, shape_arr - 1e-3), valid

    def _peel_off_tau(self, gpos):
        """Optical depth from each event position to the box edge along the
        observer direction (zero-weight propagate pass)."""
        cfg = self.config
        shape = cfg.geometry.shape
        n = gpos.shape[0]
        obs = jnp.asarray(cfg.observer_direction, jnp.float32)
        obs = obs / jnp.linalg.norm(obs)
        direction = jnp.broadcast_to(obs, (n, 3))
        # "never absorbed" target: must stay WELL within f32 resolution —
        # 1e30 here silently rounded the recovered tau to zero
        # (1e30 - tau == 1e30 in f32), wiping all extinction from the CCD
        # images; 1e4 leaves tau resolution ~1e-3 and no physical path in
        # these problems reaches tau ~ 1e4
        big = jnp.full((n,), 1.0e4, jnp.float32)
        packets = traversal.make_packets(
            gpos, direction, big, jnp.zeros((n,), jnp.float32), shape
        )
        tally = jnp.zeros(int(np.prod(shape)), jnp.float32)
        _, pk = traversal.trace_packets(
            self.chi, packets, tally, shape=shape,
            periodic=cfg.geometry.periodic,
        )
        return big - pk.tau_left  # accumulated optical depth

    def _ccd_pixel(self, gpos):
        """Project positions onto the CCD plane (perpendicular to observer).

        Same projection as the reference (CCDImage::add_photon,
        /root/reference/src/CCDImage.hpp:245-267): image coordinates are the
        components of the SI position along the (e1, e2) basis, mapped onto
        the [anchor, anchor+sides] window.  Events outside the window land in
        a clipped edge pixel (the reference discards them; the edge rows are
        a negligible-weight sink at default window = full box projection).
        """
        cfg = self.config
        geom = cfg.geometry
        npx, npy = cfg.ccd_pixels
        anchor = jnp.asarray(geom.anchor, jnp.float32)
        cell = jnp.asarray(geom.cell_size, jnp.float32)
        pos_si = anchor + gpos * cell
        e1 = jnp.asarray(self._e1, jnp.float32)
        e2 = jnp.asarray(self._e2, jnp.float32)
        u = jnp.dot(pos_si, e1, precision=jax.lax.Precision.HIGHEST)
        v = jnp.dot(pos_si, e2, precision=jax.lax.Precision.HIGHEST)
        a = self._ccd_anchor
        s = self._ccd_sides
        px = jnp.clip(
            ((u - a[0]) / s[0] * npx).astype(jnp.int32), 0, npx - 1
        )
        py = jnp.clip(
            ((v - a[1]) / s[1] * npy).astype(jnp.int32), 0, npy - 1
        )
        return px * npy + py

    def _mc_image(self, key, n, weight_norm):
        """One MC image batch of ``n`` photons, each of weight
        1/``weight_norm`` — the pure core of :meth:`run`: a FIXED
        ``n_scatterings`` generation loop with no host readbacks or
        logging, so it runs unchanged inside ``shard_map`` (photon DP)."""
        cfg = self.config
        shape = cfg.geometry.shape
        ccd = jnp.zeros(cfg.ccd_pixels[0] * cfg.ccd_pixels[1], jnp.float32)
        obs = np.asarray(cfg.observer_direction, dtype=np.float32)
        obs = obs / np.linalg.norm(obs)

        from cmacionize_tpu.models import sources as src_mod

        key, key_emit, key_dir, key_tau = jax.random.split(key, 4)
        gpos, valid = self._emit(key_emit, n)
        dx_, dy_, dz_ = src_mod.isotropic_directions(key_dir, n)
        weight = jnp.where(valid, 1.0 / weight_norm, 0.0).astype(jnp.float32)
        tau_obs = self._peel_off_tau(gpos)
        pix = self._ccd_pixel(gpos)
        ccd = ccd.at[pix].add(weight / (4.0 * np.pi) * jnp.exp(-tau_obs))

        tau = src_mod.sample_tau_targets(key_tau, n)
        packets = traversal.make_packets(
            gpos, jnp.stack([dx_, dy_, dz_], 1), tau, weight, shape
        )
        packets = packets._replace(active=valid)
        for gen in range(cfg.n_scatterings):
            tally = jnp.zeros(int(np.prod(shape)), jnp.float32)
            _, pk = traversal.trace_packets(
                self.chi, packets, tally, shape=shape,
                periodic=cfg.geometry.periodic,
            )
            key, k2, k3, k4 = jax.random.split(key, 4)
            scattered = pk.absorbed
            cos_scat = henyey_greenstein_cos(k2, cfg.hgg, n)
            ndx, ndy, ndz = _rotate_to_new_direction(
                k3, pk.dx, pk.dy, pk.dz, cos_scat
            )
            event_pos = jnp.stack([pk.px, pk.py, pk.pz], 1)
            cos_obs = pk.dx * obs[0] + pk.dy * obs[1] + pk.dz * obs[2]
            phase = henyey_greenstein_phase(cos_obs, cfg.hgg)
            tau_obs = self._peel_off_tau(event_pos)
            pix = self._ccd_pixel(event_pos)
            contribution = jnp.where(
                scattered,
                pk.weight * cfg.albedo * phase * jnp.exp(-tau_obs), 0.0
            )
            ccd = ccd.at[pix].add(contribution)
            new_tau = src_mod.sample_tau_targets(k4, n)
            packets = traversal.make_packets(
                event_pos, jnp.stack([ndx, ndy, ndz], 1),
                new_tau, pk.weight * cfg.albedo, shape,
            )
            packets = packets._replace(active=scattered)
        return ccd

    def _run_dp(self, mesh):
        """Photon-DP dust RT: replicated density/CCD geometry, per-device
        photon shares, CCD images psum'd — the mesh counterpart of the
        reference's photon-chunk job market for this mode
        (/root/reference/src/DustPhotonShootJob.hpp)."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        cfg = self.config
        n_dev = int(mesh.devices.size)
        per_dev = -(-cfg.n_photons // n_dev)

        def device_image(keys):
            return jax.lax.psum(
                self._mc_image(keys[0], per_dev, per_dev * n_dev), "ph")

        fn = jax.jit(shard_map(
            device_image, mesh=mesh, in_specs=P("ph"), out_specs=P(),
            check_vma=False))
        keys = jax.random.split(self.key, n_dev + 1)
        self.key = keys[0]
        ccd = fn(keys[1:])
        self.log.info(
            f"dust DP: {n_dev} devices x {per_dev} photons")
        return np.asarray(ccd).reshape(cfg.ccd_pixels)

    def run(self, mesh=None):
        if mesh is not None:
            return self._run_dp(mesh)
        cfg = self.config
        shape = cfg.geometry.shape
        n = cfg.n_photons
        ccd = jnp.zeros(cfg.ccd_pixels[0] * cfg.ccd_pixels[1], jnp.float32)
        obs = np.asarray(cfg.observer_direction, dtype=np.float32)
        obs = obs / np.linalg.norm(obs)

        from cmacionize_tpu.models import sources as src_mod

        self.key, key_emit, key_dir, key_tau = jax.random.split(self.key, 4)
        gpos, valid = self._emit(key_emit, n)
        dx_, dy_, dz_ = src_mod.isotropic_directions(key_dir, n)
        weight = jnp.where(valid, 1.0 / n, 0.0).astype(jnp.float32)

        # peel-off at emission: isotropic phase 1/4pi
        tau_obs = self._peel_off_tau(gpos)
        pix = self._ccd_pixel(gpos)
        ccd = ccd.at[pix].add(weight / (4.0 * np.pi) * jnp.exp(-tau_obs))

        tau = src_mod.sample_tau_targets(key_tau, n)
        packets = traversal.make_packets(
            gpos, jnp.stack([dx_, dy_, dz_], 1), tau, weight, shape
        )
        packets = packets._replace(active=valid)

        for gen in range(cfg.n_scatterings):
            tally = jnp.zeros(int(np.prod(shape)), jnp.float32)
            _, pk = traversal.trace_packets(
                self.chi, packets, tally, shape=shape,
                periodic=cfg.geometry.periodic,
            )
            self.key, k2, k3 = jax.random.split(self.key, 3)
            # every interaction is a forced scattering; absorption is handled
            # deterministically by the accumulated albedo^k weight factor,
            # matching the reference (DustPhotonShootJob.hpp:133-160
            # `albedo *= band_albedo` once per scattering order)
            scattered = pk.absorbed
            n_scat = int(jnp.sum(scattered))
            self.log.info(f"scattering generation {gen + 1}: {n_scat} events")
            if n_scat == 0:
                break
            cos_scat = henyey_greenstein_cos(k2, cfg.hgg, n)
            ndx, ndy, ndz = _rotate_to_new_direction(
                k3, pk.dx, pk.dy, pk.dz, cos_scat
            )
            event_pos = jnp.stack([pk.px, pk.py, pk.pz], 1)

            # peel-off: phase function toward the observer
            cos_obs = pk.dx * obs[0] + pk.dy * obs[1] + pk.dz * obs[2]
            phase = henyey_greenstein_phase(cos_obs, cfg.hgg)
            tau_obs = self._peel_off_tau(event_pos)
            pix = self._ccd_pixel(event_pos)
            contribution = jnp.where(
                scattered, pk.weight * cfg.albedo * phase * jnp.exp(-tau_obs), 0.0
            )
            ccd = ccd.at[pix].add(contribution)

            self.key, k4 = jax.random.split(self.key)
            new_tau = src_mod.sample_tau_targets(k4, n)
            packets = traversal.make_packets(
                event_pos, jnp.stack([ndx, ndy, ndz], 1),
                new_tau, pk.weight * cfg.albedo, shape,
            )
            packets = packets._replace(active=scattered)

        return np.asarray(ccd).reshape(cfg.ccd_pixels)

    def run_polarized(self):
        """Full-Stokes dust RT: returns dict of CCD planes I, Q, U, V.

        Equivalent of the reference's polarized dust mode
        (DustScattering::scatter/scatter_towards + CCDImage Stokes layers);
        see ops/polarization.py for the frame conventions.
        """
        from cmacionize_tpu.models import sources as src_mod
        from cmacionize_tpu.ops import polarization as pol

        cfg = self.config
        shape = cfg.geometry.shape
        n = cfg.n_photons
        band = pol.ScatteringBand(hgg=cfg.hgg, pl=cfg.pl, albedo=cfg.albedo,
                                  kappa=0.0, sc=cfg.sc, pc=cfg.pc)
        npix = cfg.ccd_pixels[0] * cfg.ccd_pixels[1]
        ccd = {k: jnp.zeros(npix, jnp.float32) for k in "IQUV"}
        obs = np.asarray(cfg.observer_direction, dtype=np.float32)
        obs = obs / np.linalg.norm(obs)
        # CCD x-axis = image-plane e1 (also the polarization reference axis)
        ccd_x = np.asarray(self._e1, np.float32)

        self.key, key_emit, key_dir, key_tau = jax.random.split(self.key, 4)
        gpos, valid = self._emit(key_emit, n)
        dx_, dy_, dz_ = src_mod.isotropic_directions(key_dir, n)
        weight = jnp.where(valid, 1.0 / n, 0.0).astype(jnp.float32)

        # unpolarized direct emission peel-off
        tau_obs = self._peel_off_tau(gpos)
        pix = self._ccd_pixel(gpos)
        ccd["I"] = ccd["I"].at[pix].add(
            weight / (4.0 * np.pi) * jnp.exp(-tau_obs))

        # Stokes state: unpolarized at birth
        I = weight
        Q = jnp.zeros(n, jnp.float32)
        U = jnp.zeros(n, jnp.float32)
        V = jnp.zeros(n, jnp.float32)
        nrx, nry, nrz = pol.initial_reference_normal(dx_, dy_, dz_)
        nref = jnp.stack([nrx, nry, nrz], 1)

        tau = src_mod.sample_tau_targets(key_tau, n)
        packets = traversal.make_packets(
            gpos, jnp.stack([dx_, dy_, dz_], 1), tau, weight, shape)
        packets = packets._replace(active=valid)

        for gen in range(cfg.n_scatterings):
            tally = jnp.zeros(int(np.prod(shape)), jnp.float32)
            _, pk = traversal.trace_packets(
                self.chi, packets, tally, shape=shape,
                periodic=cfg.geometry.periodic)
            self.key, k2, k3 = jax.random.split(self.key, 3)
            # forced scattering + accumulated albedo^k weights, as in run()
            scattered = pk.absorbed
            if int(jnp.sum(scattered)) == 0:
                break
            d = jnp.stack([pk.dx, pk.dy, pk.dz], 1)
            event_pos = jnp.stack([pk.px, pk.py, pk.pz], 1)

            # peel-off with the full scattering matrix toward the observer
            I_o, Q_o, U_o, V_o = pol.peel_off_polarized(
                d, nref, I, Q, U, V, obs, ccd_x, band)
            tau_obs = self._peel_off_tau(event_pos)
            pix = self._ccd_pixel(event_pos)
            att = jnp.where(scattered, cfg.albedo * jnp.exp(-tau_obs), 0.0)
            ccd["I"] = ccd["I"].at[pix].add(I_o * att)
            ccd["Q"] = ccd["Q"].at[pix].add(Q_o * att)
            ccd["U"] = ccd["U"].at[pix].add(U_o * att)
            ccd["V"] = ccd["V"].at[pix].add(V_o * att)

            # scatter the packet itself
            cos_scat = henyey_greenstein_cos(k2, cfg.hgg, n)
            d_new, nref_new, I, Q, U, V = pol.scatter_polarized(
                k3, d, nref, I, Q, U, V, cos_scat, band)
            nref = jnp.where(scattered[:, None], nref_new, nref)
            self.key, k4 = jax.random.split(self.key)
            new_tau = src_mod.sample_tau_targets(k4, n)
            I = I * cfg.albedo
            Q = Q * cfg.albedo
            U = U * cfg.albedo
            V = V * cfg.albedo
            # packet weight tracks I (the P1 importance correction in
            # scatter_polarized changes the intensity of polarized packets)
            packets = traversal.make_packets(
                event_pos, d_new, new_tau, I, shape)
            packets = packets._replace(active=scattered)

        return {k: np.asarray(v).reshape(cfg.ccd_pixels)
                for k, v in ccd.items()}
