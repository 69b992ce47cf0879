"""cmacionize_tpu: Monte Carlo photoionization + radiation hydrodynamics.

A from-scratch JAX/XLA re-design of the capabilities of CMacIonize
(bwvdnbro/CMacIonize): Monte Carlo radiative transfer of ionizing photons
through density grids, photoionization/thermal balance, and finite-volume
radiation hydrodynamics, compiled by XLA for the accelerator JAX finds:

- photon packets live in fixed-shape batched arrays and are advanced in
  lockstep supersteps (replacing the reference's task-based scheduler,
  cf. the reference's src/TaskBasedIonizationSimulation.cpp);
- cell state is a struct-of-arrays pytree sharded over a `jax.sharding.Mesh`
  (replacing DensitySubGrid tiling + MPI, cf.
  the reference's src/DensitySubGridCreator.hpp);
- tallies are scatter-adds; collectives (psum/ppermute) replace MPI
  reductions and the designed-but-unfinished distributed subgrid exchange.

Package layout:
    utils/     config (YAML + physical units), logging, timers, restart
    ops/       compute kernels: photon traversal, ionization & temperature
               solvers, line cooling, Riemann solvers, hydro stencils
    models/    grid state, density functions, sources & spectra, simulation
               drivers (ionization, RHD, dust, emissivity)
    parallel/  device mesh, photon-parallel and domain-decomposed drivers
    io/        Gadget-layout HDF5 snapshots, snapshot readers, restart files

Persistent compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX uses it and nothing here overrides it; otherwise compiled programs are
cached in ``.jax_cache`` at the root of the checkout (a fixed path, so a
later process finds them again).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))

from cmacionize_tpu import constants  # noqa: E402,F401
