"""Polarized dust scattering: Stokes-vector transport.

JAX equivalent of the reference's polarization treatment in
DustScattering::scatter / scatter_towards
(/root/reference/src/DustScattering.cpp:41-320), which implements the
White (1979) scattering matrix with the Yusef-Zadeh, Morris & White (1984)
meridian-frame rotations.

Design delta (documented): instead of re-deriving the meridian-frame
rotation angles from spherical trigonometry at every event (branchy,
singular at the poles), every packet carries an explicit polarization
reference normal n ⊥ d (the axis against which Q is measured). A
scattering event is then three pure rotations:

1. rotate the reference about d by a uniform azimuth ψ (Mueller rotation
   of (Q,U) by 2ψ) — the rotated reference u is the scattering-plane
   normal;
2. deflect d by the Henyey-Greenstein angle Θ inside that plane;
3. apply the White (1979) matrix (P1..P4) in the scattering-plane frame;
   the outgoing reference is u itself (u ⊥ d′ by construction).

This is algebraically the same transport (the meridian frames are just a
particular running choice of reference normal) with no pole branches and
fully vectorizable. Band parameters (hgg, pl, pc, sc, albedo, kappa) match
DustScattering.hpp:96-160.

Conventions: Stokes vectors are carried as absolute quantities
(I = packet weight); the direction is sampled from the *unpolarized* HG
phase function (∝ P1), so the matrix is divided by P1 as the importance
correction — the packet intensity changes when it is polarized, exactly
like the reference (DustScattering.cpp:148 "the common factor P1 is
divided out", :286-295).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

#: band parameters (DustScattering.hpp:96-160): hgg, pl, albedo, kappa
BAND_PARAMETERS = {
    "V": dict(hgg=0.44, pl=0.43, albedo=0.54, kappa=21.9),
    "K": dict(hgg=0.02, pl=0.93, albedo=0.21, kappa=2.0),
}


@dataclasses.dataclass(frozen=True)
class ScatteringBand:
    hgg: float
    pl: float  # peak linear polarization
    albedo: float
    kappa: float
    sc: float = 0.0  # circular polarization skew
    pc: float = 0.0  # peak linear→circular conversion

    @classmethod
    def named(cls, band: str) -> "ScatteringBand":
        return cls(**BAND_PARAMETERS[band])


def scattering_matrix(cos_theta, band: ScatteringBand):
    """White (1979) eqs. 3-6 matrix elements (P1, P2, P3, P4).

    Mirrors DustScattering.cpp:120-148; Θ is the scattering angle.
    """
    g = band.hgg
    cos2 = cos_theta * cos_theta
    P1 = (1.0 - g * g) * (1.0 + g * g - 2.0 * g * cos_theta) ** -1.5
    inv1c2 = 1.0 / (1.0 + cos2)
    P2 = -band.pl * P1 * (1.0 - cos2) * inv1c2
    P3 = 2.0 * P1 * cos_theta * inv1c2
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    cos_skew = jnp.cos(
        theta + band.sc * 3.13 * theta * jnp.exp(-7.0 * theta / np.pi))
    cos2_skew = cos_skew * cos_skew
    P4 = -band.pc * P1 * (1.0 - cos2_skew) / (1.0 + cos2_skew)
    return P1, P2, P3, P4


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def rotate_stokes(Q, U, cos_psi, sin_psi):
    """Mueller frame rotation by ψ about the propagation direction."""
    cos2 = cos_psi * cos_psi - sin_psi * sin_psi
    sin2 = 2.0 * sin_psi * cos_psi
    return Q * cos2 + U * sin2, -Q * sin2 + U * cos2


def initial_reference_normal(dx, dy, dz):
    """An arbitrary unit normal ⊥ d for freshly emitted (unpolarized)
    packets."""
    near_z = jnp.abs(dz) > 0.99
    ax = jnp.where(near_z, 1.0, 0.0)
    az = jnp.where(near_z, 0.0, 1.0)
    cx, cy, cz = _cross(ax, jnp.zeros_like(ax), az, dx, dy, dz)
    norm = jnp.sqrt(cx * cx + cy * cy + cz * cz) + 1e-20
    return cx / norm, cy / norm, cz / norm


def scatter_polarized(key, d, nref, I, Q, U, V, cos_theta,
                      band: ScatteringBand):
    """One polarized scattering event for a batch of packets.

    d, nref: [n,3] unit direction and reference normal; (I,Q,U,V): [n]
    Stokes; cos_theta: [n] HG-sampled scattering-angle cosines.
    Returns (d', nref', I', Q', U', V'). The direction was sampled from the
    *unpolarized* HG phase function (∝ P1), so dividing the matrix by P1 is
    the importance correction: I' = (P1·I + P2·Qr)/P1 — the packet weight
    changes for polarized packets, exactly like the reference
    (DustScattering.cpp:148,286-295).
    """
    n = d.shape[0]
    psi = jax.random.uniform(key, (n,), I.dtype, 0.0, 2.0 * np.pi)
    cos_psi, sin_psi = jnp.cos(psi), jnp.sin(psi)

    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    nx, ny, nz = nref[:, 0], nref[:, 1], nref[:, 2]
    tx, ty, tz = _cross(dx, dy, dz, nx, ny, nz)  # t = d × n

    # in-plane reference after the azimuth rotation: the White matrix
    # applies with the Q axis lying IN the scattering plane
    lx = cos_psi * nx + sin_psi * tx
    ly = cos_psi * ny + sin_psi * ty
    lz = cos_psi * nz + sin_psi * tz
    Qr, Ur = rotate_stokes(Q, U, cos_psi, sin_psi)

    # deflect d by Θ inside the (d, l) plane; the frame {d, l} rotates to
    # {d', l'} so the outgoing Q axis stays in the scattering plane
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    ndx = cos_theta * dx + sin_theta * lx
    ndy = cos_theta * dy + sin_theta * ly
    ndz = cos_theta * dz + sin_theta * lz
    olx = cos_theta * lx - sin_theta * dx
    oly = cos_theta * ly - sin_theta * dy
    olz = cos_theta * lz - sin_theta * dz
    norm = jnp.sqrt(ndx * ndx + ndy * ndy + ndz * ndz) + 1e-20

    P1, P2, P3, P4 = scattering_matrix(cos_theta, band)
    a_inv = 1.0 / jnp.maximum(P1, 1e-30)
    I_new = (P1 * I + P2 * Qr) * a_inv
    Q_new = (P2 * I + P1 * Qr) * a_inv
    U_new = (P3 * Ur + P4 * V) * a_inv
    V_new = (-P4 * Ur + P3 * V) * a_inv

    d_out = jnp.stack([ndx / norm, ndy / norm, ndz / norm], axis=1)
    n_out = jnp.stack([olx, oly, olz], axis=1)
    n_out = n_out / (jnp.linalg.norm(n_out, axis=1, keepdims=True) + 1e-20)
    return (d_out, n_out, I_new, Q_new, U_new, V_new)


def peel_off_polarized(d, nref, I, Q, U, V, observer, ccd_x,
                       band: ScatteringBand):
    """Polarized peel-off: observed (I,Q,U,V) per unit solid angle toward
    `observer`, with Q/U in the fixed CCD frame (`ccd_x` ⊥ observer).

    Equivalent of DustScattering::scatter_towards + the CCD frame rotation
    in CCDImage (reference dust mode). The returned intensities include
    the 1/4π phase normalization but NOT albedo or exp(-τ) factors.
    """
    obs = jnp.asarray(observer)
    ex = jnp.asarray(ccd_x)

    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    nx, ny, nz = nref[:, 0], nref[:, 1], nref[:, 2]
    cos_theta = dx * obs[0] + dy * obs[1] + dz * obs[2]
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    degenerate = sin_theta < 1e-6
    safe_sin = jnp.maximum(sin_theta, 1e-20)

    # incoming in-plane Q axis: l_in ∝ o − cosΘ d (⊥ d, in the plane)
    lx = (obs[0] - cos_theta * dx) / safe_sin
    ly = (obs[1] - cos_theta * dy) / safe_sin
    lz = (obs[2] - cos_theta * dz) / safe_sin
    # fall back to the carried reference when d ∥ o
    lx = jnp.where(degenerate, nx, lx)
    ly = jnp.where(degenerate, ny, ly)
    lz = jnp.where(degenerate, nz, lz)

    # rotation from nref to l_in about d
    cos_psi = nx * lx + ny * ly + nz * lz
    tx, ty, tz = _cross(dx, dy, dz, nx, ny, nz)
    sin_psi = tx * lx + ty * ly + tz * lz
    Qr, Ur = rotate_stokes(Q, U, cos_psi, sin_psi)

    P1, P2, P3, P4 = scattering_matrix(cos_theta, band)
    inv4pi = 1.0 / (4.0 * np.pi)
    I_obs = (P1 * I + P2 * Qr) * inv4pi
    Q_obs = (P2 * I + P1 * Qr) * inv4pi
    U_obs = (P3 * Ur + P4 * V) * inv4pi
    V_obs = (-P4 * Ur + P3 * V) * inv4pi

    # outgoing in-plane Q axis: l_out = cosΘ l_in − sinΘ d (⊥ o); rotate
    # the observed Q/U from l_out into the fixed CCD frame about `observer`
    ox = cos_theta * lx - sin_theta * dx
    oy = cos_theta * ly - sin_theta * dy
    oz = cos_theta * lz - sin_theta * dz
    ox = jnp.where(degenerate, nx, ox)
    oy = jnp.where(degenerate, ny, oy)
    oz = jnp.where(degenerate, nz, oz)
    cos_chi = ox * ex[0] + oy * ex[1] + oz * ex[2]
    cx, cy, cz = _cross(obs[0] * jnp.ones_like(ox), obs[1] * jnp.ones_like(ox),
                        obs[2] * jnp.ones_like(ox), ox, oy, oz)
    sin_chi = cx * ex[0] + cy * ex[1] + cz * ex[2]
    Q_ccd, U_ccd = rotate_stokes(Q_obs, U_obs, cos_chi, sin_chi)
    return I_obs, Q_ccd, U_ccd, V_obs
