"""Photon data parallelism: replicated grid, packets sharded over devices.

JAX equivalent of the reference's production MPI mode (grid replicated
on every rank, photon count distributed, per-ion tallies Allreduce'd —
/root/reference/src/IonizationSimulation.cpp:395-529,
/root/reference/src/MPICommunicator.hpp:207-360): each device emits and
traces its share of the packets through its replica of the opacity field,
tallies are `psum`'d over the mesh axis, and the (cheap, elementwise)
ionization balance runs redundantly on every device — exactly the
replicated-solve + gather the reference does, minus the gather (the result
is already identical everywhere).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from cmacionize_tpu.models import sources
from cmacionize_tpu.ops import ionization, traversal


def make_dp_iteration(
    mesh,
    *,
    shape: Tuple[int, int, int],
    periodic: Tuple[bool, bool, bool],
    n_photons_per_device: int,
    sigma_dx: float,
    source_gpos,
    jfac_scale: float,
    alpha: float,
    axis: str = "ph",
):
    """Build a jitted photon-DP Monte Carlo iteration over ``mesh``.

    Returns a function (keys, neutral_fraction, number_density) →
    (new_neutral_fraction, jH, n_escaped) where ``keys`` is a [n_devices]
    PRNG key array (one independent stream per device) and the field
    arguments/outputs are replicated.

    jfac_scale must already account for the *total* photon weight
    (n_photons_per_device × n_devices).
    """

    def device_iteration(keys, neutral_fraction, number_density):
        key = keys[0]
        chi = (number_density * neutral_fraction * sigma_dx).reshape(-1)
        px, py, pz, dx, dy, dz, tau, _, weight = sources.emit_point_source(
            key, n_photons_per_device, source_gpos
        )
        position = jnp.stack([px, py, pz], axis=1)
        direction = jnp.stack([dx, dy, dz], axis=1)
        packets = traversal.make_packets(position, direction, tau, weight, shape)
        tally = jnp.zeros(chi.shape, chi.dtype)
        tally, packets = traversal.trace_packets_auto(
            chi, packets, tally, shape=shape, periodic=periodic
        )
        # MPI_Allreduce of the per-ion tallies → psum over the mesh axis
        tally = jax.lax.psum(tally, axis)
        n_escaped = jax.lax.psum(jnp.sum(~packets.absorbed), axis)
        jH = tally.reshape(shape) * jfac_scale
        new_x = ionization.hydrogen_neutral_fraction(jH, number_density, alpha)
        return new_x, jH, n_escaped

    sharded = shard_map(
        device_iteration,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_voronoi_dp_trace(
    mesh,
    grid,
    *,
    n_photons_per_device: int,
    src_u,
    src_cell: int,
    axis: str = "ph",
):
    """Photon-DP emit+trace on a replicated Voronoi tessellation.

    The reference runs its unstructured grids distributed only in the
    replicated-grid MPI mode (VoronoiDensityGrid plugs into the classic
    IonizationSimulation whose MPI layer replicates the grid and splits the
    photon count, /root/reference/src/IonizationSimulation.cpp:395-529);
    this is that mode on the device mesh: the cell-graph tables are
    replicated constants on every device, each device emits and traces its
    1/N share from an independent RNG stream, and the path-length tallies
    are ``psum``'d.

    Returns a jitted ``(keys[n_dev], chi_si[C]) -> (tally_m[C], n_escaped)``
    with replicated outputs (tallies in meters, as trace_packets_voronoi).
    """
    import numpy as np

    from cmacionize_tpu.models.voronoi import (
        VoronoiPacketBatch,
        _trace_voronoi_jit,
    )

    C = grid.n_cells
    max_steps = 16 * int(np.ceil(C ** (1.0 / 3.0))) + 64
    eps = jnp.float32(1e-5 / max(C ** (1.0 / 3.0), 1.0))
    neighbors = jnp.asarray(grid.neighbors)
    normals = jnp.asarray(grid.normals)
    offsets = jnp.asarray(grid.offsets)
    shifts = jnp.asarray(grid.shifts)
    src_pos = jnp.asarray(src_u, jnp.float32)
    scale = jnp.float32(grid.scale)
    n = n_photons_per_device

    def device_trace(keys, chi_si):
        key = keys[0]
        kd, kt = jax.random.split(key)
        ndx, ndy, ndz = sources.isotropic_directions(kd, n)
        tau = sources.sample_tau_targets(kt, n)
        pk = VoronoiPacketBatch(
            jnp.tile(src_pos, (n, 1)),
            jnp.stack([ndx, ndy, ndz], 1),
            jnp.full(n, src_cell, jnp.int32),
            tau,
            jnp.ones(n, jnp.float32),
            jnp.ones(n, bool),
            jnp.zeros(n, bool),
        )
        chi_u = chi_si.astype(jnp.float32) * scale
        tally = jnp.zeros(C, jnp.float32)
        tally, pk = _trace_voronoi_jit(
            neighbors, normals, offsets, shifts, chi_u, pk, tally, eps,
            max_steps,
        )
        tally = jax.lax.psum(tally * scale, axis)
        n_escaped = jax.lax.psum(jnp.sum(~pk.absorbed), axis)
        return tally, n_escaped

    return jax.jit(shard_map(
        device_trace,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    ))


def make_amr_dp_trace(
    mesh,
    grid,
    *,
    n_photons_per_device: int,
    gpos,
    axis: str = "ph",
):
    """Photon-DP emit+trace on a replicated AMR hierarchy.

    Same replicated-grid strategy as :func:`make_voronoi_dp_trace` (the
    reference's AMRDensityGrid distributes only through the replicated-grid
    MPI layer of the classic driver,
    /root/reference/src/IonizationSimulation.cpp:395-529): the octree /
    owner tables are replicated, packets split per device, per-leaf tallies
    ``psum``'d.  Dispatches through models.amr.trace_amr, so both the dense
    finest-lattice path and the deep pointer-octree march work unchanged.

    Returns a jitted ``(keys[n_dev], chi_si[C]) -> (leaf_tally_m[C],
    n_escaped)`` with replicated outputs.  ``gpos`` is the source position
    in finest-lattice cell units.
    """
    from cmacionize_tpu.models.amr import trace_amr

    n = n_photons_per_device
    fine_shape = grid.fine_shape

    def device_trace(keys, chi_si):
        key = keys[0]
        px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
            key, n, gpos
        )
        packets = traversal.make_packets(
            jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
            tau, w, fine_shape,
        )
        leaf_tally, n_escaped = trace_amr(grid, chi_si, packets)
        return (
            jax.lax.psum(leaf_tally, axis),
            jax.lax.psum(n_escaped, axis),
        )

    return jax.jit(shard_map(
        device_trace,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    ))
