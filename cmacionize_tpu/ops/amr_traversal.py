"""Depth-independent photon traversal through a flattened AMR octree.

Array-based replacement for the reference's pointer-tree AMR traversal
(`AMRDensityGrid::interact` descending AMRGridCell pointers,
/root/reference/src/AMRDensityGrid.hpp:44-808, AMRGridCell.hpp): the
hierarchy lives as two int32 tables (root lattice + children rows, built by
models.amr.AMRGrid.octree) and every lockstep step re-descends from the
root with ``max_level`` batched gathers to find the leaf containing each
packet, marches to that leaf's wall, and deposits the path-length tally
per LEAF (scatter into the compact [C] array — no dense finest lattice
anywhere, so memory is O(leaves) at any depth; the dense-expand fast path
in models.amr keeps serving shallow grids).

Positions are in COARSE cell units; ``chi_leaf`` is the optical depth per
coarse-unit length in each leaf.  Estimator and termination semantics match
ops.traversal.trace_packets.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from cmacionize_tpu.ops.traversal import PacketBatch, _EPS_DIR


def _wall_eps(coarse_shape, max_level: int) -> float:
    """Wall-identification nudge: below the finest leaf size, ABOVE the f32
    ulp of packet coordinates.

    The naive 1e-3·2^-max_level falls under the coordinate ulp
    (~max(shape)·2^-23) for max_level ≳ 8, at which point ``px + eps·dx ==
    px`` and the descent re-identifies the wall cell the packet just left —
    packets stall on walls with l_exit = 0 until the step cap (round-4
    advisor finding).  Floor the nudge at 8 coordinate ulps so the nudged
    point always lands strictly inside the next leaf."""
    ulp = max(coarse_shape) * 2.0 ** (-23)
    return max(1e-3 * 2.0 ** (-max_level), 8.0 * ulp)


@functools.partial(
    jax.jit,
    static_argnames=("coarse_shape", "max_level", "max_steps"),
)
def trace_packets_octree(
    root: jnp.ndarray,
    children: jnp.ndarray,
    chi_leaf: jnp.ndarray,
    packets: PacketBatch,
    tally: jnp.ndarray,
    *,
    coarse_shape: Tuple[int, int, int],
    max_level: int,
    max_steps: int = 0,
):
    """March all packets to termination through the octree.

    Args:
        root: [nx·ny·nz] int32 — leaf: -(id+1), internal: node id.
        children: [n_internal, 8] int32, octant index ox·4 + oy·2 + oz.
        chi_leaf: [C] optical depth per coarse-unit length per leaf.
        packets: batch with positions in coarse cell units (the cx/cy/cz
            fields are ignored — the octree descent locates cells).
        tally: [C] per-leaf accumulator for Σ ℓ(coarse units)·w.

    Returns (tally, packets) like ops.traversal.trace_packets; the final
    packet positions/flags are valid for re-emission handling.
    """
    nx, ny, nz = coarse_shape
    if max_steps == 0:
        # a leaf crossing advances ≥ one finest-lattice cell along an axis
        max_steps = 4 * (nx + ny + nz) * (1 << max_level)
    tiny = jnp.asarray(1e-30, chi_leaf.dtype)
    eps = jnp.asarray(_wall_eps(coarse_shape, max_level), jnp.float32)

    def descend(px, py, pz):
        """Leaf id + cell box for the point (px, py, pz)."""
        ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, nx - 1)
        iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, ny - 1)
        iz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, nz - 1)
        node = root[(ix * ny + iy) * nz + iz]
        lo_x = ix.astype(px.dtype)
        lo_y = iy.astype(px.dtype)
        lo_z = iz.astype(px.dtype)
        size = jnp.ones_like(px)
        for _ in range(max_level):
            internal = node >= 0
            half = 0.5 * size
            ox = px >= lo_x + half
            oy = py >= lo_y + half
            oz = pz >= lo_z + half
            octant = (
                ox.astype(jnp.int32) * 4
                + oy.astype(jnp.int32) * 2
                + oz.astype(jnp.int32)
            )
            child = children[jnp.maximum(node, 0), octant]
            node = jnp.where(internal, child, node)
            lo_x = jnp.where(internal & ox, lo_x + half, lo_x)
            lo_y = jnp.where(internal & oy, lo_y + half, lo_y)
            lo_z = jnp.where(internal & oz, lo_z + half, lo_z)
            size = jnp.where(internal, half, size)
        leaf = -node - 1  # node < 0 after a full descent
        return leaf, lo_x, lo_y, lo_z, size

    def wall_distance(pos, lo, size, dirn):
        positive = dirn > 0.0
        wall = jnp.where(positive, lo + size, lo)
        safe = jnp.where(jnp.abs(dirn) > _EPS_DIR, dirn, _EPS_DIR)
        t = (wall - pos) / safe
        return jnp.where(
            jnp.abs(dirn) > _EPS_DIR, jnp.maximum(t, 0.0), jnp.inf)

    def cond(carry):
        step, _, pk = carry
        return jnp.logical_and(step < max_steps, jnp.any(pk.active))

    def body(carry):
        step, tly, pk = carry
        # identify the leaf at a nudged point (robust on cell walls)
        leaf, lo_x, lo_y, lo_z, size = descend(
            pk.px + eps * pk.dx, pk.py + eps * pk.dy, pk.pz + eps * pk.dz
        )
        tx = wall_distance(pk.px, lo_x, size, pk.dx)
        ty = wall_distance(pk.py, lo_y, size, pk.dy)
        tz = wall_distance(pk.pz, lo_z, size, pk.dz)
        l_exit = jnp.minimum(tx, jnp.minimum(ty, tz))

        chi = jnp.maximum(chi_leaf[leaf], tiny)
        tau_cell = chi * l_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = jnp.where(absorbed_now, pk.tau_left / chi, l_exit)

        deposit = jnp.where(pk.active, l_travel * pk.weight, 0.0)
        tly = tly.at[leaf].add(deposit.astype(tly.dtype), mode="drop")

        px = pk.px + pk.dx * l_travel
        py = pk.py + pk.dy * l_travel
        pz = pk.pz + pk.dz * l_travel
        cross_x = pk.active & ~absorbed_now & (l_exit == tx)
        cross_y = pk.active & ~absorbed_now & ~cross_x & (l_exit == ty)
        cross_z = pk.active & ~absorbed_now & ~cross_x & ~cross_y
        # snap the crossed coordinate exactly onto the wall
        px = jnp.where(
            cross_x, jnp.where(pk.dx > 0, lo_x + size, lo_x), px)
        py = jnp.where(
            cross_y, jnp.where(pk.dy > 0, lo_y + size, lo_y), py)
        pz = jnp.where(
            cross_z, jnp.where(pk.dz > 0, lo_z + size, lo_z), pz)

        inside = (
            (px + eps * pk.dx >= 0.0) & (px + eps * pk.dx < nx)
            & (py + eps * pk.dy >= 0.0) & (py + eps * pk.dy < ny)
            & (pz + eps * pk.dz >= 0.0) & (pz + eps * pk.dz < nz)
        )
        tau_left = jnp.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & inside
        absorbed = pk.absorbed | absorbed_now

        upd = pk.active
        px = jnp.where(upd, px, pk.px)
        py = jnp.where(upd, py, pk.py)
        pz = jnp.where(upd, pz, pk.pz)
        tau_left = jnp.where(upd, tau_left, pk.tau_left)

        pk = PacketBatch(
            px, py, pz, pk.cx, pk.cy, pk.cz, pk.dx, pk.dy, pk.dz,
            tau_left, pk.weight, active, absorbed,
        )
        return step + 1, tly, pk

    _, tally, packets = jax.lax.while_loop(cond, body, (0, tally, packets))
    return tally, packets


@functools.partial(
    jax.jit, static_argnames=("coarse_shape", "max_level")
)
def leaf_of_positions(
    root: jnp.ndarray,
    children: jnp.ndarray,
    px: jnp.ndarray,
    py: jnp.ndarray,
    pz: jnp.ndarray,
    *,
    coarse_shape: Tuple[int, int, int],
    max_level: int,
):
    """Batched octree descent: leaf id for each point (coarse cell units).

    Used by the deep-AMR diffuse-reemission path to look up per-leaf state
    at packet absorption sites without a dense finest lattice (the
    reference walks AMRGridCell pointers for the same lookup,
    /root/reference/src/AMRGridCell.hpp)."""
    nx, ny, nz = coarse_shape
    ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, nx - 1)
    iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, ny - 1)
    iz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, nz - 1)
    node = root[(ix * ny + iy) * nz + iz]
    lo_x = ix.astype(px.dtype)
    lo_y = iy.astype(px.dtype)
    lo_z = iz.astype(px.dtype)
    size = jnp.ones_like(px)
    for _ in range(max_level):
        internal = node >= 0
        half = 0.5 * size
        ox = px >= lo_x + half
        oy = py >= lo_y + half
        oz = pz >= lo_z + half
        octant = (
            ox.astype(jnp.int32) * 4
            + oy.astype(jnp.int32) * 2
            + oz.astype(jnp.int32)
        )
        child = children[jnp.maximum(node, 0), octant]
        node = jnp.where(internal, child, node)
        lo_x = jnp.where(internal & ox, lo_x + half, lo_x)
        lo_y = jnp.where(internal & oy, lo_y + half, lo_y)
        lo_z = jnp.where(internal & oz, lo_z + half, lo_z)
        size = jnp.where(internal, half, size)
    return -node - 1


@functools.partial(
    jax.jit,
    static_argnames=("coarse_shape", "max_level", "n_bins", "max_steps"),
)
def trace_packets_octree_spectral(
    root: jnp.ndarray,
    children: jnp.ndarray,
    chi_h_leaf: jnp.ndarray,
    chi_he_leaf: jnp.ndarray,
    packets,
    tally2d: jnp.ndarray,
    *,
    coarse_shape: Tuple[int, int, int],
    max_level: int,
    n_bins: int,
    max_steps: int = 0,
):
    """Spectral (multi-frequency) octree march: per-packet H/He cross
    sections over per-leaf χ_H/χ_He fields, frequency-binned per-leaf
    tallies (deposit row = fbin·C + leaf).

    The deep-AMR counterpart of ops.traversal.trace_packets_spectral;
    ``packets`` is a SpectralPacketBatch with positions in coarse cell
    units.  Returns (tally2d [n_bins·C], packets).
    """
    from cmacionize_tpu.ops.traversal import SpectralPacketBatch

    nx, ny, nz = coarse_shape
    n_leaf = chi_h_leaf.shape[0]
    if max_steps == 0:
        max_steps = 4 * (nx + ny + nz) * (1 << max_level)
    tiny = jnp.asarray(1e-30, chi_h_leaf.dtype)
    eps = jnp.asarray(_wall_eps(coarse_shape, max_level), jnp.float32)

    def descend(px, py, pz):
        ix = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, nx - 1)
        iy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, ny - 1)
        iz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, nz - 1)
        node = root[(ix * ny + iy) * nz + iz]
        lo_x = ix.astype(px.dtype)
        lo_y = iy.astype(px.dtype)
        lo_z = iz.astype(px.dtype)
        size = jnp.ones_like(px)
        for _ in range(max_level):
            internal = node >= 0
            half = 0.5 * size
            ox = px >= lo_x + half
            oy = py >= lo_y + half
            oz = pz >= lo_z + half
            octant = (
                ox.astype(jnp.int32) * 4
                + oy.astype(jnp.int32) * 2
                + oz.astype(jnp.int32)
            )
            child = children[jnp.maximum(node, 0), octant]
            node = jnp.where(internal, child, node)
            lo_x = jnp.where(internal & ox, lo_x + half, lo_x)
            lo_y = jnp.where(internal & oy, lo_y + half, lo_y)
            lo_z = jnp.where(internal & oz, lo_z + half, lo_z)
            size = jnp.where(internal, half, size)
        return -node - 1, lo_x, lo_y, lo_z, size

    def wall_distance(pos, lo, size, dirn):
        positive = dirn > 0.0
        wall = jnp.where(positive, lo + size, lo)
        safe = jnp.where(jnp.abs(dirn) > _EPS_DIR, dirn, _EPS_DIR)
        t = (wall - pos) / safe
        return jnp.where(
            jnp.abs(dirn) > _EPS_DIR, jnp.maximum(t, 0.0), jnp.inf)

    def cond(carry):
        step, _, pk = carry
        return jnp.logical_and(step < max_steps, jnp.any(pk.active))

    def body(carry):
        step, tly, pk = carry
        leaf, lo_x, lo_y, lo_z, size = descend(
            pk.px + eps * pk.dx, pk.py + eps * pk.dy, pk.pz + eps * pk.dz
        )
        tx = wall_distance(pk.px, lo_x, size, pk.dx)
        ty = wall_distance(pk.py, lo_y, size, pk.dy)
        tz = wall_distance(pk.pz, lo_z, size, pk.dz)
        l_exit = jnp.minimum(tx, jnp.minimum(ty, tz))

        chi = jnp.maximum(
            chi_h_leaf[leaf] * pk.sig_h + chi_he_leaf[leaf] * pk.sig_he,
            tiny,
        )
        tau_cell = chi * l_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = jnp.where(absorbed_now, pk.tau_left / chi, l_exit)

        deposit = jnp.where(pk.active, l_travel * pk.weight, 0.0)
        tly = tly.at[pk.fbin * n_leaf + leaf].add(
            deposit.astype(tly.dtype), mode="drop")

        px = pk.px + pk.dx * l_travel
        py = pk.py + pk.dy * l_travel
        pz = pk.pz + pk.dz * l_travel
        cross_x = pk.active & ~absorbed_now & (l_exit == tx)
        cross_y = pk.active & ~absorbed_now & ~cross_x & (l_exit == ty)
        cross_z = pk.active & ~absorbed_now & ~cross_x & ~cross_y
        px = jnp.where(
            cross_x, jnp.where(pk.dx > 0, lo_x + size, lo_x), px)
        py = jnp.where(
            cross_y, jnp.where(pk.dy > 0, lo_y + size, lo_y), py)
        pz = jnp.where(
            cross_z, jnp.where(pk.dz > 0, lo_z + size, lo_z), pz)

        inside = (
            (px + eps * pk.dx >= 0.0) & (px + eps * pk.dx < nx)
            & (py + eps * pk.dy >= 0.0) & (py + eps * pk.dy < ny)
            & (pz + eps * pk.dz >= 0.0) & (pz + eps * pk.dz < nz)
        )
        tau_left = jnp.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & inside
        absorbed = pk.absorbed | absorbed_now

        upd = pk.active
        px = jnp.where(upd, px, pk.px)
        py = jnp.where(upd, py, pk.py)
        pz = jnp.where(upd, pz, pk.pz)
        tau_left = jnp.where(upd, tau_left, pk.tau_left)

        pk = SpectralPacketBatch(
            px, py, pz, pk.cx, pk.cy, pk.cz, pk.dx, pk.dy, pk.dz,
            tau_left, pk.weight, pk.sig_h, pk.sig_he, pk.fbin,
            active, absorbed,
        )
        return step + 1, tly, pk

    _, tally2d, packets = jax.lax.while_loop(
        cond, body, (0, tally2d, packets))
    return tally2d, packets
