"""Batched photon-packet traversal through a Cartesian grid.

Array-based replacement for the reference's per-photon DDA ray march
(`DensitySubGrid::interact`, /root/reference/src/DensitySubGrid.hpp:1137-1274
and `CartesianDensityGrid::interact`,
/root/reference/src/CartesianDensityGrid.cpp:375-460):

* the reference traces one photon at a time to completion inside an
  OpenMP task; here **all packets advance one cell-crossing per lockstep
  iteration** of a `lax.while_loop`, as structure-of-arrays `[P]` vectors
  (positions in *cell units* so f32 has ample precision);
* per-cell path-length tallies (Σ ℓ·σ·w, the mean-intensity estimator) become
  scatter-adds into a flat tally array instead of cell-locks
  (reference src/IonizationVariables.hpp:306); on a GPU XLA lowers
  them to atomic adds, so the f32 summation order can vary between runs;
* a packet terminates by reaching its target optical depth τ = -ln ξ
  (absorption) or by leaving the box (escape).

The fast path used by the Strömgren-type benchmarks is single-channel: one
effective opacity field χ[cell] (optical depth per cell-unit length) and one
tally channel; the caller applies the σ·Δx scale factors.  The multi-ion
frequency-dependent path (per-packet cross sections) lives in
:func:`trace_packets_multifreq`.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_EPS_DIR = 1e-12

#: Debug invariant checks in the hot kernels — the cmac_assert equivalents
#: the reference compiles into its traversal loop in debug builds
#: (/root/reference/src/DensitySubGrid.hpp:1140-1222).  Enable with
#: CMI_DEBUG_CHECKS=1 (or set the flag before first trace) and run the
#: kernel through :func:`run_checked` to surface violations.
_DEBUG_CHECKS = os.environ.get("CMI_DEBUG_CHECKS", "") == "1"


def _debug_check(pred, msg):
    if _DEBUG_CHECKS:
        from jax.experimental import checkify

        checkify.check(pred, msg)


def run_checked(fn, *args, **kwargs):
    """Run a (possibly jitted) traversal entry point with checkify error
    collection; raises on any violated debug invariant."""
    from jax.experimental import checkify

    err, out = checkify.checkify(fn)(*args, **kwargs)
    err.throw()
    return out


class PacketBatch(NamedTuple):
    """Structure-of-arrays photon packet batch (positions in cell units).

    Equivalent of a batched `PhotonPacket` array
    (/root/reference/src/PhotonPacket.hpp:45-71) without the per-ion cross
    sections (those live in the multifreq variant's extra arrays).
    """

    px: jnp.ndarray  # [P] position, cell units
    py: jnp.ndarray
    pz: jnp.ndarray
    cx: jnp.ndarray  # [P] int32 current cell index
    cy: jnp.ndarray
    cz: jnp.ndarray
    dx: jnp.ndarray  # [P] normalized direction
    dy: jnp.ndarray
    dz: jnp.ndarray
    tau_left: jnp.ndarray  # [P] remaining target optical depth
    weight: jnp.ndarray  # [P] statistical weight
    active: jnp.ndarray  # [P] bool — still travelling
    absorbed: jnp.ndarray  # [P] bool — reached target tau inside the box

    @property
    def size(self):
        return self.px.shape[0]


def make_packets(position, direction, tau_target, weight, shape) -> PacketBatch:
    """Build a batch from [P,3] position (cell units) / direction arrays."""
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    cx = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, shape[0] - 1)
    cy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, shape[1] - 1)
    cz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, shape[2] - 1)
    active = jnp.ones_like(weight, dtype=bool)
    absorbed = jnp.zeros_like(weight, dtype=bool)
    return PacketBatch(
        px, py, pz, cx, cy, cz, dx, dy, dz, tau_target, weight, active, absorbed
    )


def _wall_distance(pos, cell, dirn):
    """Distance (in cell units) along dirn to the next wall on this axis."""
    positive = dirn > 0.0
    wall = (cell + positive.astype(jnp.int32)).astype(pos.dtype)
    safe = jnp.where(jnp.abs(dirn) > _EPS_DIR, dirn, _EPS_DIR)
    t = (wall - pos) / safe
    # a degenerate direction component never crosses its wall
    return jnp.where(jnp.abs(dirn) > _EPS_DIR, jnp.maximum(t, 0.0), jnp.inf)


@functools.partial(
    jax.jit, static_argnames=("shape", "periodic", "max_steps")
)
def trace_packets(
    opacity: jnp.ndarray,
    packets: PacketBatch,
    tally: jnp.ndarray,
    *,
    shape: Tuple[int, int, int],
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
):
    """March all packets to termination, accumulating path-length tallies.

    Args:
        opacity: [ncell] flat χ — optical depth per unit cell-length, i.e.
            n_H·x_n·σ·Δx evaluated per cell (≥ 0).
        packets: the batch (positions in cell units).
        tally: [ncell] flat accumulator to add Σ ℓ(cell units)·w into.
        shape: grid shape (static).
        periodic: per-axis periodic wrap (static).
        max_steps: safety bound on lockstep iterations (0 → 4·(nx+ny+nz)).

    Returns:
        (tally, packets): updated tally and terminated batch (absorbed flags
        and final positions are valid for re-emission handling).
    """
    nx, ny, nz = shape
    if max_steps == 0:
        max_steps = 4 * (nx + ny + nz)
    tiny = jnp.asarray(1e-30, opacity.dtype)

    def cond(carry):
        step, _, pk = carry
        return jnp.logical_and(step < max_steps, jnp.any(pk.active))

    def body(carry):
        step, tly, pk = carry
        tx = _wall_distance(pk.px, pk.cx, pk.dx)
        ty = _wall_distance(pk.py, pk.cy, pk.dy)
        tz = _wall_distance(pk.pz, pk.cz, pk.dz)
        l_exit = jnp.minimum(tx, jnp.minimum(ty, tz))

        flat = (pk.cx * ny + pk.cy) * nz + pk.cz
        chi = jnp.maximum(opacity[flat], tiny)
        tau_cell = chi * l_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = jnp.where(absorbed_now, pk.tau_left / chi, l_exit)

        deposit = jnp.where(pk.active, l_travel * pk.weight, 0.0)
        # debug invariants (DensitySubGrid.hpp:1140-1222 cmac_asserts)
        _debug_check(
            jnp.all(jnp.where(pk.active, l_travel, 0.0) >= 0.0),
            "traversal: negative path length",
        )
        _debug_check(
            jnp.all(jnp.where(pk.active, pk.tau_left, 0.0) >= 0.0),
            "traversal: negative remaining optical depth",
        )
        _debug_check(
            jnp.all(jnp.isfinite(deposit)), "traversal: non-finite deposit"
        )
        # pin the tally dtype at the scatter boundary (a f64->f32
        # scatter is a FutureWarning today and an error in future JAX)
        tly = tly.at[flat].add(deposit.astype(tly.dtype), mode="drop")

        # advance: land exactly on the crossed wall (axis of minimal t) or at
        # the absorption point inside the cell
        px = pk.px + pk.dx * l_travel
        py = pk.py + pk.dy * l_travel
        pz = pk.pz + pk.dz * l_travel
        cross_x = pk.active & ~absorbed_now & (l_exit == tx)
        cross_y = pk.active & ~absorbed_now & ~cross_x & (l_exit == ty)
        cross_z = pk.active & ~absorbed_now & ~cross_x & ~cross_y

        step_x = jnp.where(pk.dx > 0, 1, -1).astype(jnp.int32)
        step_y = jnp.where(pk.dy > 0, 1, -1).astype(jnp.int32)
        step_z = jnp.where(pk.dz > 0, 1, -1).astype(jnp.int32)
        cx = pk.cx + jnp.where(cross_x, step_x, 0)
        cy = pk.cy + jnp.where(cross_y, step_y, 0)
        cz = pk.cz + jnp.where(cross_z, step_z, 0)

        # snap the crossed coordinate onto the wall to avoid drift
        px = jnp.where(cross_x, jnp.where(pk.dx > 0, pk.cx + 1, pk.cx).astype(px.dtype), px)
        py = jnp.where(cross_y, jnp.where(pk.dy > 0, pk.cy + 1, pk.cy).astype(py.dtype), py)
        pz = jnp.where(cross_z, jnp.where(pk.dz > 0, pk.cz + 1, pk.cz).astype(pz.dtype), pz)

        # periodic wrap or escape
        if periodic[0]:
            px = jnp.where(cx < 0, px + nx, jnp.where(cx >= nx, px - nx, px))
            cx = jnp.mod(cx, nx)
        if periodic[1]:
            py = jnp.where(cy < 0, py + ny, jnp.where(cy >= ny, py - ny, py))
            cy = jnp.mod(cy, ny)
        if periodic[2]:
            pz = jnp.where(cz < 0, pz + nz, jnp.where(cz >= nz, pz - nz, pz))
            cz = jnp.mod(cz, nz)
        inside = (
            (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
        )

        tau_left = jnp.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & inside
        absorbed = pk.absorbed | absorbed_now

        # freeze terminated packets: their final state (position, remaining
        # tau) is consumed by re-emission and domain-exchange handoff
        upd = pk.active
        px = jnp.where(upd, px, pk.px)
        py = jnp.where(upd, py, pk.py)
        pz = jnp.where(upd, pz, pk.pz)
        cx = jnp.where(upd, cx, pk.cx)
        cy = jnp.where(upd, cy, pk.cy)
        cz = jnp.where(upd, cz, pk.cz)
        tau_left = jnp.where(upd, tau_left, pk.tau_left)

        pk = PacketBatch(
            px, py, pz, cx, cy, cz, pk.dx, pk.dy, pk.dz,
            tau_left, pk.weight, active, absorbed,
        )
        return step + 1, tly, pk

    _, tally, packets = jax.lax.while_loop(cond, body, (0, tally, packets))
    return tally, packets


# ---------------------------------------------------------------------------
# Block-marched traversal (the fast path)
# ---------------------------------------------------------------------------
#
# The blocked variant amortizes ONE row gather + ONE row scatter over K DDA
# steps inside a (bsx, bsy, bsz) cell block, with one-hot lane selects over
# the fetched [P, W] block in between — the same amortization the reference
# gets from marching whole PhotonBuffers through one DensitySubGrid per task
# (reference src/DensitySubGrid.hpp:1137-1274).  It pays where a
# gather or scatter costs per index regardless of locality.  Whether it
# beats the per-step march on a given device is a benchmark question.
# Estimator and termination semantics are identical to trace_packets; only
# the accumulation structure differs.


def _block_layout(field, shape, block):
    """[ncell] flat field → ([n_block, W] blocked rows, grid-of-blocks dims)."""
    nx, ny, nz = shape
    bsx, bsy, bsz = block
    nbx, nby, nbz = nx // bsx, ny // bsy, nz // bsz
    rows = (
        field.reshape(nbx, bsx, nby, bsy, nbz, bsz)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(nbx * nby * nbz, bsx * bsy * bsz)
    )
    return rows, (nbx, nby, nbz)


def _block_unlayout(rows, shape, block):
    """Inverse of _block_layout."""
    nx, ny, nz = shape
    bsx, bsy, bsz = block
    nbx, nby, nbz = nx // bsx, ny // bsy, nz // bsz
    return (
        rows.reshape(nbx, nby, nbz, bsx, bsy, bsz)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(nx * ny * nz)
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "shape", "block", "periodic", "max_steps", "inner_steps",
        "live_threshold",
    ),
)
def trace_packets_blocked(
    opacity: jnp.ndarray,
    packets: PacketBatch,
    tally: jnp.ndarray,
    *,
    shape: Tuple[int, int, int],
    block: Tuple[int, int, int] = (4, 4, 4),
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
    inner_steps: int = 4,
    live_threshold: int = 0,
):
    """Drop-in replacement for :func:`trace_packets` (same estimator).

    Marches packets phase by phase: each phase gathers the packet's current
    cell block as one row, runs ``inner_steps`` statically-unrolled DDA steps
    inside it (one-hot lane lookups, masked), then commits the accumulated
    per-packet block deposits with a single row scatter-add.

    ``live_threshold`` > 0 exits the phase loop early once the live-packet
    count drops to or below it (survivors keep ``active=True`` and can be
    compacted and re-marched at a narrower batch width — see
    :func:`trace_packets_blocked_cascade`).

    Requires shape divisible by block.
    """
    nx, ny, nz = shape
    bsx, bsy, bsz = block
    if nx % bsx or ny % bsy or nz % bsz:
        raise ValueError(f"shape {shape} not divisible by block {block}")
    W = bsx * bsy * bsz
    if max_steps == 0:
        max_steps = 4 * (nx + ny + nz)
    max_phases = max_steps  # a phase advances every marching packet >= 1 step
    tiny = jnp.asarray(1e-30, opacity.dtype)

    chi_rows, (nbx, nby, nbz) = _block_layout(opacity, shape, block)
    tly_rows = jnp.zeros_like(chi_rows)
    n_p = packets.size

    def cond(carry):
        phase, _, pk = carry
        live = jnp.sum(pk.active, dtype=jnp.int32)
        return jnp.logical_and(phase < max_phases, live > live_threshold)

    def body(carry):
        phase, tlyB, pk = carry
        ccx = jnp.clip(pk.cx, 0, nx - 1)
        ccy = jnp.clip(pk.cy, 0, ny - 1)
        ccz = jnp.clip(pk.cz, 0, nz - 1)
        bx, by, bz = ccx // bsx, ccy // bsy, ccz // bsz
        bflat = (bx * nby + by) * nbz + bz
        blk = chi_rows[bflat]  # [P, W] row gather — once per phase
        lanes = jax.lax.broadcasted_iota(jnp.int32, (n_p, W), 1)

        px, py, pz = pk.px, pk.py, pk.pz
        cx, cy, cz = pk.cx, pk.cy, pk.cz
        tau_left = pk.tau_left
        active = pk.active
        absorbed = pk.absorbed
        march = pk.active
        D = jnp.zeros((n_p, W), blk.dtype)

        for _ in range(inner_steps):
            lx = jnp.clip(cx - bx * bsx, 0, bsx - 1)
            ly = jnp.clip(cy - by * bsy, 0, bsy - 1)
            lz = jnp.clip(cz - bz * bsz, 0, bsz - 1)
            lidx = (lx * bsy + ly) * bsz + lz
            onehot = lanes == lidx[:, None]
            chi = jnp.maximum(
                jnp.sum(jnp.where(onehot, blk, 0.0), axis=1), tiny
            )

            tx = _wall_distance(px, cx, pk.dx)
            ty = _wall_distance(py, cy, pk.dy)
            tz = _wall_distance(pz, cz, pk.dz)
            l_exit = jnp.minimum(tx, jnp.minimum(ty, tz))
            tau_cell = chi * l_exit
            absorbed_now = march & (tau_cell >= tau_left)
            l_travel = jnp.where(absorbed_now, tau_left / chi, l_exit)

            deposit = jnp.where(march, l_travel * pk.weight, 0.0)
            _debug_check(
                jnp.all(deposit >= 0.0) & jnp.all(jnp.isfinite(deposit)),
                "blocked traversal: bad deposit",
            )
            D = D + jnp.where(onehot, deposit[:, None], 0.0)

            npx = px + pk.dx * l_travel
            npy = py + pk.dy * l_travel
            npz = pz + pk.dz * l_travel
            cross_x = march & ~absorbed_now & (l_exit == tx)
            cross_y = march & ~absorbed_now & ~cross_x & (l_exit == ty)
            cross_z = march & ~absorbed_now & ~cross_x & ~cross_y

            step_x = jnp.where(pk.dx > 0, 1, -1).astype(jnp.int32)
            step_y = jnp.where(pk.dy > 0, 1, -1).astype(jnp.int32)
            step_z = jnp.where(pk.dz > 0, 1, -1).astype(jnp.int32)
            ncx = cx + jnp.where(cross_x, step_x, 0)
            ncy = cy + jnp.where(cross_y, step_y, 0)
            ncz = cz + jnp.where(cross_z, step_z, 0)

            npx = jnp.where(cross_x, jnp.where(pk.dx > 0, cx + 1, cx).astype(npx.dtype), npx)
            npy = jnp.where(cross_y, jnp.where(pk.dy > 0, cy + 1, cy).astype(npy.dtype), npy)
            npz = jnp.where(cross_z, jnp.where(pk.dz > 0, cz + 1, cz).astype(npz.dtype), npz)

            if periodic[0]:
                npx = jnp.where(ncx < 0, npx + nx, jnp.where(ncx >= nx, npx - nx, npx))
                ncx = jnp.mod(ncx, nx)
            if periodic[1]:
                npy = jnp.where(ncy < 0, npy + ny, jnp.where(ncy >= ny, npy - ny, npy))
                ncy = jnp.mod(ncy, ny)
            if periodic[2]:
                npz = jnp.where(ncz < 0, npz + nz, jnp.where(ncz >= nz, npz - nz, npz))
                ncz = jnp.mod(ncz, nz)
            inside = (
                (ncx >= 0) & (ncx < nx) & (ncy >= 0) & (ncy < ny)
                & (ncz >= 0) & (ncz < nz)
            )

            ntau = jnp.where(absorbed_now, 0.0, tau_left - tau_cell)
            _debug_check(
                jnp.all(jnp.where(march, ntau, 0.0) >= 0.0),
                "blocked traversal: negative remaining optical depth",
            )

            # freeze non-marching packets
            px = jnp.where(march, npx, px)
            py = jnp.where(march, npy, py)
            pz = jnp.where(march, npz, pz)
            cx = jnp.where(march, ncx, cx)
            cy = jnp.where(march, ncy, cy)
            cz = jnp.where(march, ncz, cz)
            tau_left = jnp.where(march, ntau, tau_left)
            absorbed = absorbed | absorbed_now
            active = active & ~(march & (absorbed_now | ~inside))

            same_block = (
                (cx // bsx == bx) & (cy // bsy == by) & (cz // bsz == bz)
            )
            march = march & ~absorbed_now & inside & same_block

        tlyB = tlyB.at[bflat].add(D.astype(tlyB.dtype), mode="drop")
        pk = PacketBatch(
            px, py, pz, cx, cy, cz, pk.dx, pk.dy, pk.dz,
            tau_left, pk.weight, active, absorbed,
        )
        return phase + 1, tlyB, pk

    _, tly_rows, packets = jax.lax.while_loop(
        cond, body, (0, tly_rows, packets)
    )
    tally = tally + _block_unlayout(tly_rows, shape, block).astype(
        tally.dtype)
    return tally, packets


# ---------------------------------------------------------------------------
# Spectral (multi-frequency) traversal
# ---------------------------------------------------------------------------


class SpectralPacketBatch(NamedTuple):
    """Packet batch with per-packet H/He cross sections and a frequency bin.

    The multi-ion path-length tallies of the reference
    (`update_intensity_counters`, /root/reference/src/DensitySubGrid.hpp:585-620
    — one add per ion per cell crossing) are replaced by a *frequency-binned*
    tally: each crossing deposits ℓ·w once into (bin, cell); the per-ion
    mean-intensity and heating integrals are recovered afterwards by one
    [n_ion+2, n_bins] × [n_bins, n_cell] matmul (see
    `spectral_tallies_to_ion_integrals`).  Opacity only involves H and He
    (cf. `get_optical_depth`, DensitySubGrid.hpp:557-583), carried per packet.
    """

    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    cz: jnp.ndarray
    dx: jnp.ndarray
    dy: jnp.ndarray
    dz: jnp.ndarray
    tau_left: jnp.ndarray
    weight: jnp.ndarray
    sig_h: jnp.ndarray  # [P] sigma_H(nu) (m^2)
    sig_he: jnp.ndarray  # [P] sigma_He(nu) (m^2)
    fbin: jnp.ndarray  # [P] int32 frequency bin
    active: jnp.ndarray
    absorbed: jnp.ndarray

    @property
    def size(self):
        return self.px.shape[0]


def make_spectral_packets(
    position, direction, tau_target, weight, sig_h, sig_he, fbin, shape
) -> SpectralPacketBatch:
    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    cx = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, shape[0] - 1)
    cy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, shape[1] - 1)
    cz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, shape[2] - 1)
    active = jnp.ones_like(weight, dtype=bool)
    absorbed = jnp.zeros_like(weight, dtype=bool)
    return SpectralPacketBatch(
        px, py, pz, cx, cy, cz, dx, dy, dz,
        tau_target, weight, sig_h, sig_he, fbin, active, absorbed,
    )


@functools.partial(
    jax.jit, static_argnames=("shape", "periodic", "max_steps", "n_bins")
)
def trace_packets_spectral(
    chi_h: jnp.ndarray,
    chi_he: jnp.ndarray,
    packets: SpectralPacketBatch,
    tally2d: jnp.ndarray,
    *,
    shape: Tuple[int, int, int],
    n_bins: int,
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
):
    """March a spectral batch; deposits ℓ·w into a [n_bins * n_cell] tally.

    chi_h / chi_he: flat [n_cell] fields n_H·x_H·Δx and n_H·A_He·x_He·Δx
    (optical depth per σ per cell-unit length) so that the per-packet opacity
    is χ = χ_H·σ_H(ν) + χ_He·σ_He(ν).
    """
    nx, ny, nz = shape
    ncell = nx * ny * nz
    if max_steps == 0:
        max_steps = 4 * (nx + ny + nz)
    tiny = jnp.asarray(1e-30, chi_h.dtype)

    def cond(carry):
        step, _, pk = carry
        return jnp.logical_and(step < max_steps, jnp.any(pk.active))

    def body(carry):
        step, tly, pk = carry
        tx = _wall_distance(pk.px, pk.cx, pk.dx)
        ty = _wall_distance(pk.py, pk.cy, pk.dy)
        tz = _wall_distance(pk.pz, pk.cz, pk.dz)
        l_exit = jnp.minimum(tx, jnp.minimum(ty, tz))

        flat = (pk.cx * ny + pk.cy) * nz + pk.cz
        chi = jnp.maximum(
            chi_h[flat] * pk.sig_h + chi_he[flat] * pk.sig_he, tiny
        )
        tau_cell = chi * l_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = jnp.where(absorbed_now, pk.tau_left / chi, l_exit)

        deposit = jnp.where(pk.active, l_travel * pk.weight, 0.0)
        tly = tly.at[pk.fbin * ncell + flat].add(
            deposit.astype(tly.dtype), mode="drop")

        px = pk.px + pk.dx * l_travel
        py = pk.py + pk.dy * l_travel
        pz = pk.pz + pk.dz * l_travel
        cross_x = pk.active & ~absorbed_now & (l_exit == tx)
        cross_y = pk.active & ~absorbed_now & ~cross_x & (l_exit == ty)
        cross_z = pk.active & ~absorbed_now & ~cross_x & ~cross_y

        step_x = jnp.where(pk.dx > 0, 1, -1).astype(jnp.int32)
        step_y = jnp.where(pk.dy > 0, 1, -1).astype(jnp.int32)
        step_z = jnp.where(pk.dz > 0, 1, -1).astype(jnp.int32)
        cx = pk.cx + jnp.where(cross_x, step_x, 0)
        cy = pk.cy + jnp.where(cross_y, step_y, 0)
        cz = pk.cz + jnp.where(cross_z, step_z, 0)

        px = jnp.where(cross_x, jnp.where(pk.dx > 0, pk.cx + 1, pk.cx).astype(px.dtype), px)
        py = jnp.where(cross_y, jnp.where(pk.dy > 0, pk.cy + 1, pk.cy).astype(py.dtype), py)
        pz = jnp.where(cross_z, jnp.where(pk.dz > 0, pk.cz + 1, pk.cz).astype(pz.dtype), pz)

        if periodic[0]:
            px = jnp.where(cx < 0, px + nx, jnp.where(cx >= nx, px - nx, px))
            cx = jnp.mod(cx, nx)
        if periodic[1]:
            py = jnp.where(cy < 0, py + ny, jnp.where(cy >= ny, py - ny, py))
            cy = jnp.mod(cy, ny)
        if periodic[2]:
            pz = jnp.where(cz < 0, pz + nz, jnp.where(cz >= nz, pz - nz, pz))
            cz = jnp.mod(cz, nz)
        inside = (
            (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
        )

        tau_left = jnp.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & inside
        absorbed = pk.absorbed | absorbed_now

        # freeze terminated packets (see trace_packets)
        upd = pk.active
        px = jnp.where(upd, px, pk.px)
        py = jnp.where(upd, py, pk.py)
        pz = jnp.where(upd, pz, pk.pz)
        cx = jnp.where(upd, cx, pk.cx)
        cy = jnp.where(upd, cy, pk.cy)
        cz = jnp.where(upd, cz, pk.cz)
        tau_left = jnp.where(upd, tau_left, pk.tau_left)

        pk = SpectralPacketBatch(
            px, py, pz, cx, cy, cz, pk.dx, pk.dy, pk.dz,
            tau_left, pk.weight, pk.sig_h, pk.sig_he, pk.fbin, active, absorbed,
        )
        return step + 1, tly, pk

    _, tally2d, packets = jax.lax.while_loop(cond, body, (0, tally2d, packets))
    return tally2d, packets


@functools.partial(
    jax.jit,
    static_argnames=(
        "shape", "n_bins", "block", "periodic", "max_steps", "inner_steps"
    ),
)
def trace_packets_spectral_blocked(
    chi_h: jnp.ndarray,
    chi_he: jnp.ndarray,
    packets: SpectralPacketBatch,
    tally2d: jnp.ndarray,
    *,
    shape: Tuple[int, int, int],
    n_bins: int,
    block: Tuple[int, int, int] = (4, 4, 4),
    periodic: Tuple[bool, bool, bool] = (False, False, False),
    max_steps: int = 0,
    inner_steps: int = 4,
):
    """Block-marched drop-in for :func:`trace_packets_spectral`.

    Both opacity channels are fused into one [n_block, 2W] row table so a
    single row gather per phase fetches H and He opacity for the whole block;
    frequency-binned deposits go to row ``fbin * n_block + bflat`` of a
    [n_bins * n_block, W] blocked tally (one row scatter per phase).
    """
    nx, ny, nz = shape
    bsx, bsy, bsz = block
    if nx % bsx or ny % bsy or nz % bsz:
        raise ValueError(f"shape {shape} not divisible by block {block}")
    W = bsx * bsy * bsz
    ncell = nx * ny * nz
    if max_steps == 0:
        max_steps = 4 * (nx + ny + nz)
    max_phases = max_steps
    tiny = jnp.asarray(1e-30, chi_h.dtype)

    h_rows, (nbx, nby, nbz) = _block_layout(chi_h, shape, block)
    he_rows, _ = _block_layout(chi_he, shape, block)
    fused_rows = jnp.concatenate([h_rows, he_rows], axis=1)  # [nb, 2W]
    n_block = nbx * nby * nbz
    tly_rows = jnp.zeros((n_bins * n_block, W), chi_h.dtype)
    n_p = packets.size

    def cond(carry):
        phase, _, pk = carry
        return jnp.logical_and(phase < max_phases, jnp.any(pk.active))

    def body(carry):
        phase, tlyB, pk = carry
        ccx = jnp.clip(pk.cx, 0, nx - 1)
        ccy = jnp.clip(pk.cy, 0, ny - 1)
        ccz = jnp.clip(pk.cz, 0, nz - 1)
        bx, by, bz = ccx // bsx, ccy // bsy, ccz // bsz
        bflat = (bx * nby + by) * nbz + bz
        blk2 = fused_rows[bflat]  # [P, 2W]
        blk_h = blk2[:, :W]
        blk_he = blk2[:, W:]
        lanes = jax.lax.broadcasted_iota(jnp.int32, (n_p, W), 1)

        px, py, pz = pk.px, pk.py, pk.pz
        cx, cy, cz = pk.cx, pk.cy, pk.cz
        tau_left = pk.tau_left
        active = pk.active
        absorbed = pk.absorbed
        march = pk.active
        D = jnp.zeros((n_p, W), chi_h.dtype)

        for _ in range(inner_steps):
            lx = jnp.clip(cx - bx * bsx, 0, bsx - 1)
            ly = jnp.clip(cy - by * bsy, 0, bsy - 1)
            lz = jnp.clip(cz - bz * bsz, 0, bsz - 1)
            lidx = (lx * bsy + ly) * bsz + lz
            onehot = lanes == lidx[:, None]
            ch = jnp.sum(jnp.where(onehot, blk_h, 0.0), axis=1)
            che = jnp.sum(jnp.where(onehot, blk_he, 0.0), axis=1)
            chi = jnp.maximum(ch * pk.sig_h + che * pk.sig_he, tiny)

            tx = _wall_distance(px, cx, pk.dx)
            ty = _wall_distance(py, cy, pk.dy)
            tz = _wall_distance(pz, cz, pk.dz)
            l_exit = jnp.minimum(tx, jnp.minimum(ty, tz))
            tau_cell = chi * l_exit
            absorbed_now = march & (tau_cell >= tau_left)
            l_travel = jnp.where(absorbed_now, tau_left / chi, l_exit)

            deposit = jnp.where(march, l_travel * pk.weight, 0.0)
            D = D + jnp.where(onehot, deposit[:, None], 0.0)

            npx = px + pk.dx * l_travel
            npy = py + pk.dy * l_travel
            npz = pz + pk.dz * l_travel
            cross_x = march & ~absorbed_now & (l_exit == tx)
            cross_y = march & ~absorbed_now & ~cross_x & (l_exit == ty)
            cross_z = march & ~absorbed_now & ~cross_x & ~cross_y

            step_x = jnp.where(pk.dx > 0, 1, -1).astype(jnp.int32)
            step_y = jnp.where(pk.dy > 0, 1, -1).astype(jnp.int32)
            step_z = jnp.where(pk.dz > 0, 1, -1).astype(jnp.int32)
            ncx = cx + jnp.where(cross_x, step_x, 0)
            ncy = cy + jnp.where(cross_y, step_y, 0)
            ncz = cz + jnp.where(cross_z, step_z, 0)

            npx = jnp.where(cross_x, jnp.where(pk.dx > 0, cx + 1, cx).astype(npx.dtype), npx)
            npy = jnp.where(cross_y, jnp.where(pk.dy > 0, cy + 1, cy).astype(npy.dtype), npy)
            npz = jnp.where(cross_z, jnp.where(pk.dz > 0, cz + 1, cz).astype(npz.dtype), npz)

            if periodic[0]:
                npx = jnp.where(ncx < 0, npx + nx, jnp.where(ncx >= nx, npx - nx, npx))
                ncx = jnp.mod(ncx, nx)
            if periodic[1]:
                npy = jnp.where(ncy < 0, npy + ny, jnp.where(ncy >= ny, npy - ny, npy))
                ncy = jnp.mod(ncy, ny)
            if periodic[2]:
                npz = jnp.where(ncz < 0, npz + nz, jnp.where(ncz >= nz, npz - nz, npz))
                ncz = jnp.mod(ncz, nz)
            inside = (
                (ncx >= 0) & (ncx < nx) & (ncy >= 0) & (ncy < ny)
                & (ncz >= 0) & (ncz < nz)
            )

            ntau = jnp.where(absorbed_now, 0.0, tau_left - tau_cell)

            px = jnp.where(march, npx, px)
            py = jnp.where(march, npy, py)
            pz = jnp.where(march, npz, pz)
            cx = jnp.where(march, ncx, cx)
            cy = jnp.where(march, ncy, cy)
            cz = jnp.where(march, ncz, cz)
            tau_left = jnp.where(march, ntau, tau_left)
            absorbed = absorbed | absorbed_now
            active = active & ~(march & (absorbed_now | ~inside))

            same_block = (
                (cx // bsx == bx) & (cy // bsy == by) & (cz // bsz == bz)
            )
            march = march & ~absorbed_now & inside & same_block

        tlyB = tlyB.at[pk.fbin * n_block + bflat].add(
            D.astype(tlyB.dtype), mode="drop")
        pk = SpectralPacketBatch(
            px, py, pz, cx, cy, cz, pk.dx, pk.dy, pk.dz,
            tau_left, pk.weight, pk.sig_h, pk.sig_he, pk.fbin, active, absorbed,
        )
        return phase + 1, tlyB, pk

    _, tly_rows, packets = jax.lax.while_loop(
        cond, body, (0, tly_rows, packets)
    )
    per_bin = jax.vmap(
        lambda rows: _block_unlayout(rows, shape, block)
    )(tly_rows.reshape(n_bins, n_block, W))
    tally2d = tally2d + per_bin.reshape(n_bins * ncell).astype(
        tally2d.dtype)
    return tally2d, packets


def trace_packets_spectral_auto(
    chi_h,
    chi_he,
    packets: SpectralPacketBatch,
    tally2d,
    *,
    shape,
    n_bins: int,
    periodic=(False, False, False),
    max_steps: int = 0,
):
    """Dispatch to the blocked spectral fast path when the shape allows it.

    The spectral kernel keeps the (4,4,4) block: its fused H+He opacity row
    is [P, 2W], so the (8,4,4) single-channel block would double the
    per-phase working set (1 GB at P=2^20).
    """
    block = (4, 4, 4) if all(int(s) % 4 == 0 for s in shape) else None
    if block is None:
        return trace_packets_spectral(
            chi_h, chi_he, packets, tally2d,
            shape=shape, n_bins=n_bins, periodic=periodic, max_steps=max_steps,
        )
    return trace_packets_spectral_blocked(
        chi_h, chi_he, packets, tally2d,
        shape=shape, n_bins=n_bins, block=block, periodic=periodic,
        max_steps=max_steps, inner_steps=default_inner_steps(block),
    )


def spectral_tallies_to_ion_integrals(
    tally2d, sigma_table, heating_weights, n_cell: int
):
    """[n_bins * n_cell] binned tallies → per-ion and heating integrals.

    sigma_table: [n_ion, n_bins] σ_i at the bin frequencies (m²).
    heating_weights: [2, n_bins] σ_{H,He}(ν)·(ν - ν_ion) for the photo-heating
    integrals (cf. DensitySubGrid.hpp:600-610).

    One matmul replaces the reference's per-ion scatter adds.
    """
    t2 = tally2d.reshape(-1, n_cell)  # [n_bins, n_cell]
    weights = jnp.concatenate([sigma_table, heating_weights], axis=0)
    return jnp.dot(
        weights.astype(t2.dtype), t2, preferred_element_type=t2.dtype,
        precision=jax.lax.Precision.HIGHEST,  # full f32, never TF32
    )  # [n_ion + 2, n_cell]


def default_block(shape) -> "Tuple[int, int, int] | None":
    """Pick the block for a grid shape (None → use per-step).

    (8, 4, 4) with 6 unrolled inner steps (one wider row gather amortizes
    more DDA steps); (4, 4, 4)/K=4 is the fallback for grids not divisible
    by 8 in x.  Any block requires the grid to be divisible by it.
    """
    if int(shape[0]) % 8 == 0 and all(int(s) % 4 == 0 for s in shape):
        return (8, 4, 4)
    if all(int(s) % 4 == 0 for s in shape):
        return (4, 4, 4)
    return None


def default_inner_steps(block) -> int:
    """Unrolled march depth for a block (see default_block)."""
    return 6 if block is not None and block[0] == 8 else 4


def trace_packets_auto(
    opacity,
    packets: PacketBatch,
    tally,
    *,
    shape,
    periodic=(False, False, False),
    max_steps: int = 0,
):
    """Dispatch to the blocked fast path when the grid shape allows it."""
    block = default_block(shape)
    if block is None:
        return trace_packets(
            opacity, packets, tally,
            shape=shape, periodic=periodic, max_steps=max_steps,
        )
    return trace_packets_blocked(
        opacity, packets, tally,
        shape=shape, block=block, periodic=periodic, max_steps=max_steps,
        inner_steps=default_inner_steps(block),
    )


def trace_packets_blocked_adaptive(
    opacity,
    packets: PacketBatch,
    tally,
    *,
    shape,
    block=(4, 4, 4),
    periodic=(False, False, False),
    inner_steps: int = 4,
    phase1_phases: int = 9,
):
    """Blocked march with one survivor compaction.

    Runs ``phase1_phases`` block phases at full width, then compacts the
    survivors into the smallest sufficient power-of-two width (one host
    sync + one argsort) and finishes the march.  The row gather/scatter that
    dominates the blocked phase cost is linear in batch width, and the
    survival curve collapses after ~8 phases, so the compaction pays for
    itself on the converged benchmark states.

    Returns (tally, n_absorbed, n_escaped); per-packet final state is not
    preserved (use trace_packets_blocked when re-emission needs it).
    """
    n = packets.size
    tally, pk = trace_packets_blocked(
        opacity, packets, tally, shape=shape, block=block, periodic=periodic,
        max_steps=phase1_phases, inner_steps=inner_steps,
    )
    n_live = int(jnp.sum(pk.active))  # host sync (one round trip)
    n_absorbed = jnp.sum(pk.absorbed, dtype=jnp.int32)
    if n_live > 0:
        width = next((w for w in _POW2_WIDTHS if w >= n_live and w < n), n)
        order = jnp.argsort(~pk.active)[:width]
        sub = PacketBatch(*(f[order] for f in pk))
        tally, sub = trace_packets_blocked(
            opacity, sub, tally, shape=shape, block=block, periodic=periodic,
            inner_steps=inner_steps,
        )
        n_absorbed = n_absorbed + jnp.sum(sub.absorbed, dtype=jnp.int32)
    n_escaped = n - n_absorbed
    return tally, n_absorbed, n_escaped


def trace_packets_cascade_exits(
    opacity,
    packets: PacketBatch,
    tally,
    *,
    shape,
    periodic=(False, False, False),
    max_steps: int = 0,
    shrink: int = 3,
    n_stages: int = 4,
):
    """Cascade march that PRESERVES terminated-packet exit state.

    The sharded slab exchange (parallel.domain) needs each terminated
    packet's exit position/direction to route face-crossers to the neighbor
    device — state :func:`trace_packets_blocked_cascade` discards.  This
    variant marches in the same geometrically shrinking stages but returns
    the concatenation of every stage's lane arrays plus a ``valid`` mask
    marking lanes that TERMINATED in that stage: a packet terminating in
    stage i appears exactly once as a valid lane (exit fields intact);
    lanes still live at a stage boundary are carried (via the on-device
    packed-sort compaction) into the next stage and their stale earlier
    copies stay ``valid=False``.  Input-inactive lanes are never valid.

    Falls back to the per-step march (state-preserving by construction)
    when the shape has no divisible block.

    Returns (tally, exits, valid, n_stuck): ``exits`` a PacketBatch of
    width Σ stage widths (≈ 1.5·n at the default shrink), ``valid`` bool of
    the same width, ``n_stuck`` packets still live when the step budget ran
    out (callers surface it as truncation — the loud version of the
    reference's implicit buffer caps, MemorySpace.hpp:96-120).
    """
    n = packets.size
    if max_steps == 0:
        nx, ny, nz = shape
        max_steps = 4 * (nx + ny + nz)
    block = default_block(shape)
    if block is None:
        tally, pk = trace_packets(
            opacity, packets, tally, shape=shape, periodic=periodic,
            max_steps=max_steps,
        )
        valid = packets.active & ~pk.active
        n_stuck = jnp.sum(packets.active & pk.active, dtype=jnp.int32)
        return tally, pk, valid, n_stuck
    inner_steps = default_inner_steps(block)
    widths = [n]
    for _ in range(n_stages - 1):
        w = widths[-1] // shrink
        if w < 8192:
            break
        widths.append(w)
    pk = packets
    valid_in = pk.active
    stage_pks, stage_valid = [], []
    n_stuck = jnp.zeros((), jnp.int32)
    for si, width in enumerate(widths):
        next_width = widths[si + 1] if si + 1 < len(widths) else 0
        tally, pk = trace_packets_blocked(
            opacity, pk, tally, shape=shape, block=block, periodic=periodic,
            max_steps=max_steps, inner_steps=inner_steps,
            live_threshold=next_width,
        )
        stage_pks.append(pk)
        stage_valid.append(valid_in & ~pk.active)
        if next_width:
            pk = _compact_live(pk, next_width)
            valid_in = pk.active
        else:
            n_stuck = jnp.sum(valid_in & pk.active, dtype=jnp.int32)
    if len(stage_pks) == 1:
        return tally, stage_pks[0], stage_valid[0], n_stuck
    exits = PacketBatch(*(
        jnp.concatenate([getattr(p, f) for p in stage_pks])
        for f in PacketBatch._fields
    ))
    valid = jnp.concatenate(stage_valid)
    return tally, exits, valid, n_stuck


def _compact_live(pk: PacketBatch, width: int):
    """Sort live packets to the front and keep the first ``width`` rows.

    Fully on-device: one packed uint32 single-array sort (cheaper than the
    general argsort XLA would emit) plus one row gather of the field
    matrix.  Caller must guarantee the live count is
    <= width (use trace_packets_blocked's live_threshold), otherwise live
    packets would be dropped.
    """
    n = pk.size
    iota = jax.lax.iota(jnp.uint32, n)
    dead = (~pk.active).astype(jnp.uint32)
    sorted_keys = jax.lax.sort((dead << 31) | iota)
    perm = (sorted_keys & jnp.uint32(0x7FFFFFFF))[:width].astype(jnp.int32)
    matf = jnp.stack(
        [pk.px, pk.py, pk.pz, pk.dx, pk.dy, pk.dz, pk.tau_left, pk.weight],
        axis=1,
    )
    mati = jnp.stack(
        [pk.cx, pk.cy, pk.cz, pk.active.astype(jnp.int32)], axis=1
    )
    subf = matf[perm]  # two row gathers (float dtype + int32)
    subi = mati[perm]
    active = subi[:, 3] > 0
    return PacketBatch(
        px=subf[:, 0], py=subf[:, 1], pz=subf[:, 2],
        cx=subi[:, 0], cy=subi[:, 1], cz=subi[:, 2],
        dx=subf[:, 3], dy=subf[:, 4], dz=subf[:, 5],
        tau_left=subf[:, 6], weight=subf[:, 7],
        active=active,
        absorbed=jnp.zeros_like(active),
    )


def trace_packets_blocked_cascade(
    opacity,
    packets: PacketBatch,
    tally,
    *,
    shape,
    block=(4, 4, 4),
    periodic=(False, False, False),
    inner_steps: int = 0,
    max_steps: int = 0,
    shrink: int = 3,
    n_stages: int = 4,
):
    """Blocked march with fully on-device width compaction (no host syncs).

    The lockstep phase loop pays full batch width per phase even as packets
    terminate.  This variant runs the march as ``n_stages`` stages of
    geometrically shrinking width (P, P/shrink, P/shrink^2, ...): each stage
    marches until the live count drops to the next stage's width (device-side
    predicate — no readback), then sorts live packets to the front with a
    packed uint32 key sort and slices statically.  It pays whenever the
    survival curve decays (every benchmark's does) by more than the sort and
    row-gather permute cost.  Defaults: shrink 3, 4 stages.

    Estimator-identical to :func:`trace_packets` (same deposits, same
    termination); only the batch bookkeeping differs.

    Returns (tally, n_absorbed, n_escaped); per-packet final state is not
    preserved (use trace_packets_blocked when re-emission needs it).
    """
    n = packets.size
    if inner_steps == 0:
        inner_steps = default_inner_steps(block)
    if max_steps == 0:
        nx, ny, nz = shape
        max_steps = 4 * (nx + ny + nz)
    widths = [n]
    for _ in range(n_stages - 1):
        w = widths[-1] // shrink
        if w < 8192:
            break
        widths.append(w)
    n_absorbed = jnp.zeros((), jnp.int32)
    pk = packets
    for si, width in enumerate(widths):
        next_width = widths[si + 1] if si + 1 < len(widths) else 0
        tally, pk = trace_packets_blocked(
            opacity, pk, tally, shape=shape, block=block, periodic=periodic,
            max_steps=max_steps, inner_steps=inner_steps,
            live_threshold=next_width,
        )
        # absorbed flags are reset by _compact_live, so each stage's sum
        # counts only that stage's absorptions
        n_absorbed = n_absorbed + jnp.sum(pk.absorbed, dtype=jnp.int32)
        if next_width:
            pk = _compact_live(pk, next_width)
    n_escaped = n - n_absorbed
    return tally, n_absorbed, n_escaped


# ---------------------------------------------------------------------------
# Adaptive (width-compacting) traversal for the single-channel hot path
# ---------------------------------------------------------------------------

_POW2_WIDTHS = (1 << 13, 1 << 15, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22)


def trace_packets_adaptive(
    opacity,
    packets: PacketBatch,
    tally,
    *,
    shape,
    periodic=(False, False, False),
    phase1_steps: int = 32,
):
    """Two-phase traversal: full-width march, then compact survivors.

    The lockstep loop pays full batch width every step even as packets
    terminate (the survival curve of a converged Strömgren state drops from
    100% to ~15% between steps ~25 and ~40).  After ``phase1_steps`` the live
    count is read back once and the survivors are compacted into the
    smallest sufficient power-of-two width before finishing the march —
    trading one host sync + one argsort for ~40% of the scatter/gather
    volume.

    Returns (tally, n_absorbed, n_escaped) — per-packet final state is NOT
    preserved across the compaction; use plain trace_packets when re-emission
    needs it.
    """
    n = packets.size
    tally, pk = trace_packets(
        opacity, packets, tally, shape=shape, periodic=periodic,
        max_steps=phase1_steps,
    )
    n_live = int(jnp.sum(pk.active))  # host sync (one round trip)
    n_absorbed = jnp.sum(pk.absorbed, dtype=jnp.int32)
    if n_live > 0:
        width = next(
            (w for w in _POW2_WIDTHS if w >= n_live and w < n), n
        )
        order = jnp.argsort(~pk.active)[:width]
        sub = PacketBatch(*(f[order] for f in pk))
        tally, sub = trace_packets(
            opacity, sub, tally, shape=shape, periodic=periodic
        )
        n_absorbed = n_absorbed + jnp.sum(sub.absorbed, dtype=jnp.int32)
    n_escaped = n - n_absorbed
    return tally, n_absorbed, n_escaped
