"""Grid geometry and cell state.

Array-based replacement for the reference's DensityGrid / DensitySubGrid cell
storage (/root/reference/src/DensityGrid.hpp:63,
/root/reference/src/IonizationVariables.hpp:84-118): instead of an
array-of-structs of per-cell `IonizationVariables`, the cell state is a
struct-of-arrays pytree of `[nx, ny, nz]` fields (with a leading ion axis for
per-ion quantities).  The whole grid advances in lockstep; sharding over a
device mesh happens by splitting the x axis (see cmacionize_tpu.parallel).

Geometry is static Python data (shapes must be known at trace time).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from cmacionize_tpu.models import ions


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static description of a Cartesian box grid (SI units)."""

    anchor: Tuple[float, float, float]
    sides: Tuple[float, float, float]
    shape: Tuple[int, int, int]
    periodic: Tuple[bool, bool, bool] = (False, False, False)

    @property
    def cell_size(self) -> np.ndarray:
        return np.asarray(self.sides) / np.asarray(self.shape)

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.cell_size))

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.shape))

    def cell_centers(self) -> np.ndarray:
        """[nx, ny, nz, 3] SI cell-center coordinates (host-side numpy)."""
        axes = [
            self.anchor[i] + (np.arange(self.shape[i]) + 0.5) * self.cell_size[i]
            for i in range(3)
        ]
        grid = np.meshgrid(*axes, indexing="ij")
        return np.stack(grid, axis=-1)

    def position_to_grid_coords(self, position) -> np.ndarray:
        """SI position → continuous grid coordinates in [0, shape)."""
        return (np.asarray(position) - np.asarray(self.anchor)) / self.cell_size

    @classmethod
    def from_params(cls, params) -> "GridGeometry":
        anchor = params.get_physical_vector("SimulationBox:anchor", "length")
        sides = params.get_physical_vector("SimulationBox:sides", "length")
        periodic = params.get_bool_vector(
            "SimulationBox:periodicity", [False, False, False]
        )
        shape = params.get_int_vector("DensityGrid:number of cells", [64, 64, 64])
        return cls(tuple(anchor), tuple(sides), tuple(shape), tuple(periodic))


class GridState(NamedTuple):
    """Per-cell ionization state and Monte Carlo tallies (a jax pytree).

    Equivalent of one `IonizationVariables` per cell
    (/root/reference/src/IonizationVariables.hpp:84-118), vectorized.

    mean_intensity holds the *raw* path-length tallies Σ ℓ·σ_ion·w (units m³)
    accumulated during photon shooting; normalization to a photoionization
    rate happens in the ionization-state solve (jfac = L / (W_tot V_cell),
    cf. /root/reference/src/IonizationSimulation.cpp:519).
    """

    number_density: jnp.ndarray  # [nx, ny, nz] hydrogen number density (m^-3)
    temperature: jnp.ndarray  # [nx, ny, nz] (K)
    ionic_fractions: jnp.ndarray  # [n_ion, nx, ny, nz]
    mean_intensity: jnp.ndarray  # [n_ion, nx, ny, nz] raw tallies (m^3)
    heating: jnp.ndarray  # [2, nx, ny, nz] raw heating tallies (m^3 Hz)

    @property
    def shape(self):
        return self.number_density.shape

    @property
    def n_ions(self):
        return self.ionic_fractions.shape[0]

    def reset_tallies(self) -> "GridState":
        return self._replace(
            mean_intensity=jnp.zeros_like(self.mean_intensity),
            heating=jnp.zeros_like(self.heating),
        )


def make_grid_state(
    geometry: GridGeometry,
    number_density,
    temperature,
    n_ions: int = ions.NUMBER_OF_IONS,
    neutral_fraction: float = 1.0e-6,
    dtype=jnp.float32,
) -> GridState:
    """Build an initial GridState from density/temperature fields or scalars.

    Initial ionic fractions default to 1e-6 (nearly fully ionized), matching
    the reference's homogeneous initial condition
    (/root/reference/src/HomogeneousDensityFunction.hpp:103-105).
    """
    shape = geometry.shape
    nd = jnp.broadcast_to(jnp.asarray(number_density, dtype), shape)
    temp = jnp.broadcast_to(jnp.asarray(temperature, dtype), shape)
    xion = jnp.full((n_ions,) + shape, neutral_fraction, dtype)
    tallies = jnp.zeros((n_ions,) + shape, dtype)
    heating = jnp.zeros((ions.NUMBER_OF_HEATING_TERMS,) + shape, dtype)
    return GridState(nd, temp, xion, tallies, heating)
