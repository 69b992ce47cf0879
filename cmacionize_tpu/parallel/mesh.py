"""Device mesh construction.

Replaces the reference's MPI communicator setup
(/root/reference/src/MPICommunicator.hpp:94-183): ranks become positions on a
`jax.sharding.Mesh`; collectives replace MPI reduce/gather.

Axis conventions:
    "ph"  — photon-data parallelism (grid replicated, packets split; the
            JAX equivalent of the reference's replicated-grid MPI mode,
            /root/reference/src/IonizationSimulation.cpp:458-529)
    "x"   — spatial domain decomposition along the grid x axis (the
            equivalent of distributed subgrids, SURVEY §2.7 P4)
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("ph",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a mesh over the first n_devices devices.

    With one axis name the mesh is 1D over all requested devices; an explicit
    ``shape`` builds a multi-axis mesh (e.g. ("x", "ph") for combined domain
    decomposition + photon parallelism).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    return Mesh(devices.reshape(shape), axis_names)
