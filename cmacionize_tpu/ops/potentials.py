"""External gravitational potentials + FFT self-gravity.

Equivalents of the reference's ExternalPotential implementations
(/root/reference/src/ExternalPotentialFactory.hpp:67-72 — PointMass,
DiscPatch, CoredDMProfile) and of TreeSelfGravity
(/root/reference/src/TreeSelfGravity.hpp).

Design delta (documented): the reference computes self-gravity with a
Barnes-Hut octree — a pointer-chasing structure that maps poorly onto
vectorized hardware.  Here periodic self-gravity is solved spectrally: one FFT Poisson solve
(∇²Φ = 4πGρ → Φ_k = -4πG ρ_k / k²) runs entirely on the device and is both
faster and exact to the grid resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from cmacionize_tpu import constants


@dataclasses.dataclass(frozen=True)
class PointMassPotential:
    """g = -G M r̂ / r² (cf. PointMassExternalPotential)."""

    mass: float
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    softening: float = 0.0

    def acceleration(self, positions):
        rel = positions - np.asarray(self.position)
        r2 = (rel**2).sum(-1) + self.softening**2
        r = np.sqrt(np.maximum(r2, 1e-300))
        g = -constants.NEWTON_CONSTANT * self.mass / r2
        return g[..., None] * rel / r[..., None]


@dataclasses.dataclass(frozen=True)
class DiscPatchPotential:
    """Infinite-disc patch: g_z = -2πG Σ tanh((z-z0)/b)
    (cf. DiscPatchExternalPotential)."""

    surface_density: float
    disc_z: float = 0.0
    scale_height: float = 1.0

    def acceleration(self, positions):
        z = positions[..., 2] - self.disc_z
        gz = (
            -2.0
            * np.pi
            * constants.NEWTON_CONSTANT
            * self.surface_density
            * np.tanh(z / self.scale_height)
        )
        g = np.zeros_like(positions)
        g[..., 2] = gz
        return g


@dataclasses.dataclass(frozen=True)
class CoredDMPotential:
    """Cored isothermal dark-matter profile: ρ = ρ0 / (1 + (r/rc)²)
    → g(r) = -4πG ρ0 rc³ (r/rc - arctan(r/rc)) / r²
    (cf. CoredDMProfileExternalPotential)."""

    central_density: float
    core_radius: float
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def acceleration(self, positions):
        rel = positions - np.asarray(self.position)
        r = np.sqrt(np.maximum((rel**2).sum(-1), 1e-300))
        x = r / self.core_radius
        m_enc = (
            4.0 * np.pi * self.central_density * self.core_radius**3
            * (x - np.arctan(x))
        )
        g = -constants.NEWTON_CONSTANT * m_enc / r**2
        return g[..., None] * rel / r[..., None]


def fft_self_gravity(density, cell_size, mean_subtract: bool = True):
    """Periodic self-gravity accelerations from an FFT Poisson solve.

    density: [nx, ny, nz] mass density (kg/m³).
    Returns (gx, gy, gz) acceleration fields.

    Replaces TreeSelfGravity (documented deviation — see module docstring).
    """
    shape = density.shape
    rho = density
    if mean_subtract:
        # periodic Poisson only has a solution for zero-mean source (the
        # Jeans swindle)
        rho = rho - jnp.mean(rho)
    rho_k = jnp.fft.rfftn(rho)
    ks = [
        2.0 * np.pi * np.fft.fftfreq(shape[0], cell_size[0]),
        2.0 * np.pi * np.fft.fftfreq(shape[1], cell_size[1]),
        2.0 * np.pi * np.fft.rfftfreq(shape[2], cell_size[2]),
    ]
    kx, ky, kz = jnp.meshgrid(*[jnp.asarray(k) for k in ks], indexing="ij")
    # discrete-Laplacian eigenvalues (particle-mesh practice): consistent
    # with the centered-difference gradient below, and free of the spectral
    # ringing a continuum 1/k² kernel produces on compact sources
    def k2_discrete(k, d):
        return (2.0 / d**2) * (1.0 - jnp.cos(k * d))

    k2 = (
        k2_discrete(kx, cell_size[0])
        + k2_discrete(ky, cell_size[1])
        + k2_discrete(kz, cell_size[2])
    )
    inv_k2 = jnp.where(k2 > 0.0, 1.0 / jnp.maximum(k2, 1e-300), 0.0)
    phi_k = -4.0 * np.pi * constants.NEWTON_CONSTANT * rho_k * inv_k2
    phi = jnp.fft.irfftn(phi_k, s=shape)
    # g = -∇Φ via centered differences (periodic)
    gx = -(jnp.roll(phi, -1, 0) - jnp.roll(phi, 1, 0)) / (2.0 * cell_size[0])
    gy = -(jnp.roll(phi, -1, 1) - jnp.roll(phi, 1, 1)) / (2.0 * cell_size[1])
    gz = -(jnp.roll(phi, -1, 2) - jnp.roll(phi, 1, 2)) / (2.0 * cell_size[2])
    return gx, gy, gz
