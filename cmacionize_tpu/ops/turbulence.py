"""Alvelius (1999) spectral-space stochastic turbulence forcing.

Equivalent of /root/reference/src/AlveliusTurbulenceForcing.hpp: a Gaussian
force spectrum F(k) ∝ exp(-(|k|-k_f)²/c²)/k² over integer modes
k_min ≤ |k| ≤ k_max, with two solenoidal unit vectors e1 ⊥ e2 ⊥ k per mode
and fresh random complex amplitudes every driving step (white in time), so
that the mean injected power equals the configured value.

Design: the per-cell per-mode triple loop of the reference
(add_turbulent_forcing) becomes one einsum of the [n_modes, 3] amplitude
table against precomputed [n_modes, n_cells] phase waves.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class TurbulenceForcing:
    k_table: np.ndarray  # [n_modes, 3] wave vectors (1/m)
    e1: np.ndarray  # [n_modes, 3]
    e2: np.ndarray  # [n_modes, 3]
    k_force: np.ndarray  # [n_modes] force amplitudes (m s^-2)
    driving_timestep: float

    @classmethod
    def build(
        cls,
        box_sides: float,
        k_min: float = 1.0,
        k_max: float = 3.0,
        k_forcing: float = 2.0,
        concentration_factor: float = 0.2,
        power_forcing: float = 1e-4,
        driving_timestep: float = 1.0,
    ) -> "TurbulenceForcing":
        """Build the mode table (cf. AlveliusTurbulenceForcing ctor :100-165).

        k_* are in integer units of 2π/L; the half-space enumeration
        (k1 ≥ 0, with boundary rules) avoids double-counting conjugates.
        """
        modes, e1s, e2s, spectra = [], [], [], []
        kmax_i = int(np.ceil(k_max))
        for k1 in range(0, kmax_i + 1):
            for k2 in range(0 if k1 == 0 else -kmax_i, kmax_i + 1):
                for k3 in range(
                    0 if (k1 == 0 and k2 == 0) else -kmax_i, kmax_i + 1
                ):
                    kk = k1 * k1 + k2 * k2 + k3 * k3
                    k = np.sqrt(kk)
                    if not (k_min <= k <= k_max):
                        continue
                    sqrtk12 = np.sqrt(k1 * k1 + k2 * k2)
                    if sqrtk12 > 0:
                        e1 = np.array([k2 / sqrtk12, -k1 / sqrtk12, 0.0])
                        e2 = np.array(
                            [
                                k1 * k3 / (sqrtk12 * k),
                                k2 * k3 / (sqrtk12 * k),
                                -sqrtk12 / k,
                            ]
                        )
                    else:
                        sqrtk13 = np.sqrt(k1 * k1 + k3 * k3)
                        e1 = np.array([-k3 / sqrtk13, 0.0, k1 / sqrtk13])
                        e2 = np.array(
                            [
                                k1 * k2 / (sqrtk13 * k),
                                -sqrtk13 / k,
                                k2 * k3 / (sqrtk13 * k),
                            ]
                        )
                    modes.append(np.array([k1, k2, k3]) / box_sides)
                    e1s.append(e1)
                    e2s.append(e2)
                    kdiff = k - k_forcing
                    spectra.append(
                        np.exp(-kdiff * kdiff / concentration_factor**2) / kk
                    )
        spectra = np.asarray(spectra)
        norm = power_forcing / (spectra.sum() * driving_timestep)
        return cls(
            k_table=np.asarray(modes),
            e1=np.asarray(e1s),
            e2=np.asarray(e2s),
            k_force=np.sqrt(spectra * norm),
            driving_timestep=driving_timestep,
        )

    @property
    def n_modes(self) -> int:
        return len(self.k_force)

    def sample_amplitudes(self, key):
        """Random complex amplitudes for one driving step
        (cf. get_random_factors: a random phase split between e1/e2)."""
        k1, k2, k3 = jax.random.split(key, 3)
        n = self.n_modes
        phi = jax.random.uniform(k1, (n,), jnp.float32, 0, 2 * np.pi)
        theta1 = jax.random.uniform(k2, (n,), jnp.float32, 0, 2 * np.pi)
        theta2 = jax.random.uniform(k3, (n,), jnp.float32, 0, 2 * np.pi)
        ga = jnp.sin(phi)
        gb = jnp.cos(phi)
        kf = jnp.asarray(self.k_force, jnp.float32)[:, None]
        e1 = jnp.asarray(self.e1, jnp.float32)
        e2 = jnp.asarray(self.e2, jnp.float32)
        a_real = kf * (
            e1 * (jnp.cos(theta1) * ga)[:, None]
            + e2 * (jnp.cos(theta2) * gb)[:, None]
        )
        a_imag = kf * (
            e1 * (jnp.sin(theta1) * ga)[:, None]
            + e2 * (jnp.sin(theta2) * gb)[:, None]
        )
        return a_real, a_imag  # [n_modes, 3] each

    def force_field(self, key, cell_centers):
        """[*grid, 3] real force field for one driving step.

        f(x) = Σ_k [a_r(k) cos(2π k·x) - a_i(k) sin(2π k·x)]
        """
        a_real, a_imag = self.sample_amplitudes(key)
        x = jnp.asarray(cell_centers, jnp.float32)  # [*grid, 3]
        k = jnp.asarray(self.k_table, jnp.float32)  # [n_modes, 3]
        hi = jax.lax.Precision.HIGHEST  # full f32, never TF32
        phase = 2.0 * np.pi * jnp.einsum("...d,md->...m", x, k, precision=hi)
        force = jnp.einsum(
            "...m,md->...d", jnp.cos(phase), a_real, precision=hi
        ) - jnp.einsum("...m,md->...d", jnp.sin(phase), a_imag, precision=hi)
        return force


def apply_forcing(u, force, dt):
    """Kick the momentum (and consistent kinetic energy) with a force field.

    u: HydroState (per-volume conserved); force: [*grid, 3] (m s^-2).
    """
    fx, fy, fz = force[..., 0], force[..., 1], force[..., 2]
    energy = u.energy + dt * (
        u.mom_x * fx + u.mom_y * fy + u.mom_z * fz
    ) + 0.5 * dt * dt * u.rho * (fx * fx + fy * fy + fz * fz)
    return u._replace(
        mom_x=u.mom_x + dt * u.rho * fx,
        mom_y=u.mom_y + dt * u.rho * fy,
        mom_z=u.mom_z + dt * u.rho * fz,
        energy=energy,
    )
