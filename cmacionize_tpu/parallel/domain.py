"""Domain-decomposed Monte Carlo: grid slabs sharded over devices,
photon packets exchanged over the interconnect.

This is the JAX realization of the reference's *designed but never
finished* distributed subgrid mode (SURVEY §2.7 P4: `DensitySubGrid::pack/
unpack` MPI buffers, reserved TASKTYPE_SEND/RECV,
/root/reference/src/DensitySubGrid.hpp:965-1057, Task.hpp:50-52):

* the box is split into x-slabs, one per device on the mesh axis "x";
  the cell arrays (density, neutral fraction, tallies) live sharded —
  nothing is replicated;
* photon packets are traced through their local slab in lockstep; packets
  crossing a slab face are compacted into fixed-size send buffers and moved
  to the neighbor device with `ppermute` over ICI (the 27-direction buffer
  exchange of the reference collapses to ±x face exchanges for slabs);
* the superstep loop (trace → exchange → merge) runs until a `psum` of the
  live-packet count reaches zero — the bulk-synchronous equivalent of the
  reference's global termination test
  (/root/reference/src/TaskBasedIonizationSimulation.cpp:884-886).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cmacionize_tpu.models import sources
from cmacionize_tpu.ops import hydro as hydro_mod
from cmacionize_tpu.ops import ionization, traversal


def _compact(fields, mask, capacity):
    """Gather masked packets to the front; truncate/pad to ``capacity``.

    fields: tuple of [N] arrays; mask [N] bool.  Returns (fields [capacity],
    active [capacity], overflow) where ``overflow`` counts packets that did
    not fit in the buffer (the caller surfaces it — packets must never be
    dropped silently).  Uses a packed single-array sort (actives first,
    stable) instead of a general argsort.
    """
    n = mask.shape[0]
    iota = jax.lax.iota(jnp.uint32, n)
    key = ((~mask).astype(jnp.uint32) << 31) | iota
    k = min(capacity, n)
    idx = (jax.lax.sort(key) & jnp.uint32(0x7FFFFFFF))[:k].astype(
        jnp.int32
    )
    count = jnp.sum(mask, dtype=jnp.int32)
    in_range = jnp.arange(capacity) < count
    out = tuple(f[idx] for f in fields)
    if capacity > n:  # widen (e.g. copy-phase survivors into the carry)
        out = tuple(
            jnp.concatenate([f, jnp.zeros((capacity - n,), f.dtype)])
            for f in out
        )
    overflow = jnp.maximum(count - capacity, 0)
    return out, in_range, overflow


def _device_slab_mc_loop(
    key,
    chi,
    *,
    my,
    axis,
    n_dev,
    nx_loc,
    ny,
    nz,
    n_photons,
    source_gpos,
    capacity,
    max_supersteps,
):
    """Device-level MC trace on an x-slab: source-replicated emission, then
    superstep (cascade trace → compact crossers → ppermute exchange → merge)
    until the global live count reaches zero.

    The exchange machinery of SURVEY §2.7 P4 shared by the ionization and
    RHD drivers.  Runs inside shard_map; ``my`` is the caller's axis index.

    Two upgrades over a plain exchange loop:

    * **source-slab replication** — every device emits and traces its own
      1/n_dev share of the emission through a psum-broadcast copy of the
      source slab's opacity; the copy tallies are psum-reduced onto the
      owner.  This is the slab form of the reference's subgrid-copy
      machinery (create_copies / update_original_counters,
      /root/reference/src/DensitySubGridCreator.hpp:437-556) and of
      parallel.domain3d's copy phase: in the mostly-neutral RHD regime the
      first leg absorbs ~all packets inside the source slab, which
      previously serialized the whole radiation phase on one device.
      Survivors re-enter the exchange with multi-hop pending routing (a
      packet several slabs from its target keeps hopping, re-classified
      after every merge).
    * **width-compacting cascade march** — each superstep traces through
      :func:`~cmacionize_tpu.ops.traversal.trace_packets_cascade_exits`
      (exit-state-preserving cascade) instead of the full-width lockstep
      march, so the survival-curve decay pays off inside the sharded loop
      exactly as it does in the single-device RHD driver.

    Returns (tally [n_cell_local], n_escaped, n_overflow, n_truncated,
    n_traced) — the last a per-device traced-packet counter for load-skew
    measurement (cf. the per-subgrid cost counters,
    /root/reference/src/DensitySubGrid.hpp:1616-1634).
    """
    local_shape = (nx_loc, ny, nz)
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    tally = jnp.zeros(chi.shape, chi.dtype)
    W = n_photons  # fixed carry width (worst case: all packets on one slab)
    ncell_loc = nx_loc * ny * nz

    # ---- copy phase: every device traces its emission share through a
    # replicated WINDOW of slabs around the source (psum broadcast of their
    # opacity).  The window spans the source slab ± 1 neighbor (clamped) —
    # the slab analog of the reference's copy rule "copies for the source
    # subgrid AND its neighbors at level-1"
    # (/root/reference/src/TaskBasedIonizationSimulation.cpp:514-556): a
    # source sitting on a slab wall emits half its packets straight into
    # the neighbor, which a single-slab copy would serialize right back
    # onto one device.
    src_dev = min(int(source_gpos[0]) // nx_loc, n_dev - 1)
    win = min(3, n_dev)
    w0 = min(max(src_dev - 1, 0), n_dev - win)
    win_shape = (win * nx_loc, ny, nz)
    src_win = (
        source_gpos[0] - w0 * nx_loc, source_gpos[1], source_gpos[2]
    )
    n_loc = max(n_photons // n_dev, 1)
    # exact weight normalization when n_dev does not divide n_photons
    wscale = n_photons / float(n_loc * n_dev)
    slot = my - w0
    in_win = (slot >= 0) & (slot < win)
    contrib = jnp.zeros((win, ncell_loc), chi.dtype)
    contrib = jnp.where(
        in_win,
        jax.lax.dynamic_update_index_in_dim(
            contrib, chi, jnp.clip(slot, 0, win - 1), axis=0),
        contrib,
    )
    chi_win = jax.lax.psum(contrib, axis).reshape(-1)
    px, py, pz, dx, dy, dz, tau, _, weight = sources.emit_point_source(
        key, n_loc, src_win
    )
    weight = weight * jnp.asarray(wscale, weight.dtype)
    pk0 = traversal.make_packets(
        jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
        tau, weight, win_shape,
    )
    copy_tally = jnp.zeros_like(chi_win)
    copy_tally, ex0, valid0, stuck0 = traversal.trace_packets_cascade_exits(
        chi_win, pk0, copy_tally, shape=win_shape
    )
    # window owners absorb their slice of the psum of all copy tallies
    # (update_original_counters, DensitySubGridCreator.hpp:556)
    tally_win = jax.lax.psum(copy_tally, axis).reshape(win, ncell_loc)
    tally = tally + jnp.where(
        in_win,
        jax.lax.dynamic_index_in_dim(
            tally_win, jnp.clip(slot, 0, win - 1), axis=0, keepdims=False),
        jnp.zeros_like(tally),
    )
    n_traced = jnp.asarray(n_loc, jnp.int32)

    def classify(px, dxv):
        # direction-aware slab membership: a packet exactly on a slab wall
        # belongs to the cell it is about to enter
        cell_eff = jnp.where(
            dxv >= 0, jnp.floor(px), jnp.ceil(px) - 1.0
        ).astype(jnp.int32)
        return cell_eff, cell_eff >= 0, cell_eff < nx_loc

    # classify copy-phase exits in the WINDOW frame, then shift into MY
    # local frame for the pending machinery
    yz_in0 = (
        (ex0.cy >= 0) & (ex0.cy < ny) & (ex0.cz >= 0) & (ex0.cz < nz)
    )
    gx_cell0 = ex0.cx + w0 * nx_loc
    fwd0 = (
        valid0 & ~ex0.absorbed & yz_in0
        & ((ex0.cx < 0) | (ex0.cx >= win * nx_loc))
        & (gx_cell0 >= 0) & (gx_cell0 < n_dev * nx_loc)
    )
    esc0 = valid0 & ~ex0.absorbed & ~fwd0
    n_esc = jnp.sum(esc0, dtype=jnp.int32)
    px0 = ex0.px + (jnp.int32(w0) - my).astype(ex0.px.dtype) * nx_loc
    fields0 = (
        px0, ex0.py, ex0.pz, ex0.dx, ex0.dy, ex0.dz, ex0.tau_left, ex0.weight
    )
    fields0, mask0, ov0 = _compact(fields0, fwd0, W)
    _, ge_lo0, lt_hi0 = classify(fields0[0], fields0[3])
    active0 = mask0 & ge_lo0 & lt_hi0
    pend_l0 = mask0 & ~ge_lo0
    pend_r0 = mask0 & ~lt_hi0

    def superstep(carry):
        (step, tally, px, py, pz, dxv, dyv, dzv, tau, w, active,
         pend_l, pend_r, n_esc, n_over, n_stuck, n_traced) = carry
        cx = jnp.floor(px).astype(jnp.int32)
        cy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, ny - 1)
        cz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, nz - 1)
        cx_in = jnp.clip(cx, 0, nx_loc - 1)
        pk_in = traversal.PacketBatch(
            px, py, pz, cx_in, cy, cz, dxv, dyv, dzv, tau, w,
            active, jnp.zeros_like(active),
        )
        tally, ex, valid, stuck = traversal.trace_packets_cascade_exits(
            chi, pk_in, tally, shape=local_shape
        )
        n_stuck = n_stuck + stuck
        n_traced = n_traced + jnp.sum(active, dtype=jnp.int32)

        at_lo = my == 0
        at_hi = my == n_dev - 1
        yz_in = (ex.cy >= 0) & (ex.cy < ny) & (ex.cz >= 0) & (ex.cz < nz)
        cross_l = valid & ~ex.absorbed & yz_in & (ex.cx < 0)
        cross_r = valid & ~ex.absorbed & yz_in & (ex.cx >= nx_loc)
        go_l_t = cross_l & ~at_lo
        go_r_t = cross_r & ~at_hi
        esc_t = valid & ~ex.absorbed & ~go_l_t & ~go_r_t
        # pending lanes pass through untraced; a pending lane pointing off
        # the domain edge has escaped (its target cell is outside the box)
        go_l_p = pend_l & ~at_lo
        go_r_p = pend_r & ~at_hi
        esc_p = (pend_l & at_lo) | (pend_r & at_hi)
        n_esc = n_esc + jnp.sum(esc_t, dtype=jnp.int32) + jnp.sum(
            esc_p, dtype=jnp.int32)

        exch = tuple(
            jnp.concatenate([a, b]) for a, b in zip(
                (ex.px, ex.py, ex.pz, ex.dx, ex.dy, ex.dz, ex.tau_left,
                 ex.weight),
                (px, py, pz, dxv, dyv, dzv, tau, w),
            )
        )
        go_l = jnp.concatenate([go_l_t, go_l_p])
        go_r = jnp.concatenate([go_r_t, go_r_p])
        send_l, mask_l, ov_l = _compact(exch, go_l, capacity)
        send_r, mask_r, ov_r = _compact(exch, go_r, capacity)
        n_over = n_over + ov_l + ov_r
        # shift local x coordinate into the receiver's frame
        send_l = (send_l[0] + nx_loc,) + send_l[1:]
        send_r = (send_r[0] - nx_loc,) + send_r[1:]

        recv_r = jax.lax.ppermute((*send_r, mask_r), axis, right_perm)
        recv_l = jax.lax.ppermute((*send_l, mask_l), axis, left_perm)
        # the wrap-around lanes of the circular permute carry only
        # inactive padding (go_left/right exclude domain boundaries)

        merged = tuple(
            jnp.concatenate([a, b]) for a, b in zip(recv_r[:-1], recv_l[:-1])
        )
        merged_mask = jnp.concatenate([recv_r[-1], recv_l[-1]])
        # restore the fixed carry width (only the exchange buffers are
        # narrow — they are what rides the interconnect)
        pad = W - merged[0].shape[0]
        if pad > 0:
            merged = tuple(
                jnp.concatenate([f, jnp.zeros((pad,), f.dtype)])
                for f in merged
            )
            merged_mask = jnp.concatenate(
                [merged_mask, jnp.zeros((pad,), bool)]
            )
        else:
            merged, merged_mask, ov_m = _compact(merged, merged_mask, W)
            n_over = n_over + ov_m
        (px, py, pz, dxv, dyv, dzv, tau, w) = merged
        # multi-hop routing: a packet emitted several slabs away keeps
        # hopping — re-classify everything received against this slab
        _, ge_lo, lt_hi = classify(px, dxv)
        active = merged_mask & ge_lo & lt_hi
        pend_l = merged_mask & ~ge_lo
        pend_r = merged_mask & ~lt_hi
        return (
            step + 1, tally, px, py, pz, dxv, dyv, dzv, tau, w, active,
            pend_l, pend_r, n_esc, n_over, n_stuck, n_traced,
        )

    def cond(carry):
        step = carry[0]
        active, pend_l, pend_r = carry[10], carry[11], carry[12]
        n_live = jax.lax.psum(
            jnp.sum(active | pend_l | pend_r, dtype=jnp.int32), axis
        )
        return jnp.logical_and(step < max_supersteps, n_live > 0)

    carry = (
        0, tally, *fields0, active0, pend_l0, pend_r0,
        n_esc, ov0, stuck0, n_traced,
    )
    carry = jax.lax.while_loop(cond, superstep, carry)
    tally, n_esc, n_over, n_stuck, n_traced = (
        carry[1], carry[13], carry[14], carry[15], carry[16]
    )
    truncated = n_stuck + jnp.sum(
        carry[10] | carry[11] | carry[12], dtype=jnp.int32
    )
    return tally, n_esc, n_over, truncated, n_traced


def make_domain_mc_iteration(
    mesh,
    *,
    global_shape: Tuple[int, int, int],
    n_photons: int,
    sigma_dx: float,
    source_gpos: Tuple[float, float, float],
    jfac_scale: float,
    alpha: float,
    axis: str = "x",
    max_supersteps: int = 256,
    capacity: int = 0,
):
    """Build a jitted domain-decomposed H-only MC iteration.

    Returns (step_fn, shardings) where step_fn(keys, neutral_fraction,
    number_density) → (new_neutral_fraction, jH, diagnostics); the field
    arguments and outputs are sharded along grid-x (PartitionSpec(axis)),
    keys is a [n_devices] key array.  ``diagnostics`` is a dict of global
    scalars: n_escaped, buffer_overflow (packets that did not fit in an
    exchange buffer — nonzero means the run must be repeated with a larger
    ``capacity``), truncated_live (packets still in flight when
    max_supersteps hit — nonzero means silent truncation; both are the loud
    version of the reference's implicit buffer-capacity limits,
    /root/reference/src/MemorySpace.hpp:96-120).

    ``capacity`` sizes the per-direction exchange buffers; 0 picks
    n_photons // 2 plus statistical headroom — a point source on a slab
    face exports half its emission (a binomial draw, hence the margin)
    through one face in the first superstep, and later supersteps cross
    strictly less; round 1's full-width buffers wasted ~2x the exchange
    bandwidth.  Any overflow is counted, never silent.
    """
    n_dev = mesh.shape[axis]
    nx, ny, nz = global_shape
    assert nx % n_dev == 0, "grid x must divide over devices"
    nx_loc = nx // n_dev
    local_shape = (nx_loc, ny, nz)
    if capacity <= 0:
        capacity = max(4096, n_photons // 2 + n_photons // 32)
    capacity = min(capacity, n_photons)

    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def device_iteration(keys, neutral_fraction, number_density):
        my = jax.lax.axis_index(axis)
        key = keys[0]
        chi = (number_density * neutral_fraction * sigma_dx).reshape(-1)
        tally, n_esc, n_over, truncated, n_traced = _device_slab_mc_loop(
            key, chi, my=my, axis=axis, n_dev=n_dev, nx_loc=nx_loc,
            ny=ny, nz=nz, n_photons=n_photons, source_gpos=source_gpos,
            capacity=capacity, max_supersteps=max_supersteps,
        )
        jH = tally.reshape(local_shape) * jfac_scale
        new_x = ionization.hydrogen_neutral_fraction(jH, number_density, alpha)
        diagnostics = {
            "n_escaped": jax.lax.psum(n_esc, axis),
            "buffer_overflow": jax.lax.psum(n_over, axis),
            "truncated_live": jax.lax.psum(truncated, axis),
            "packets_traced": n_traced.reshape(1),
        }
        return new_x, jH, diagnostics

    sharded = shard_map(
        device_iteration,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(
            P(axis), P(axis),
            {
                "n_escaped": P(), "buffer_overflow": P(),
                "truncated_live": P(), "packets_traced": P(axis),
            },
        ),
        check_vma=False,
    )
    shardings = {
        "field": NamedSharding(mesh, P(axis)),
        "keys": NamedSharding(mesh, P(axis)),
    }
    return jax.jit(sharded), shardings


# ---------------------------------------------------------------------------
# Sharded spectral (multi-frequency) transport
# ---------------------------------------------------------------------------


def make_domain_spectral_trace(
    mesh,
    *,
    global_shape: Tuple[int, int, int],
    n_bins: int,
    n_photons: int,
    axis: str = "x",
    max_supersteps: int = 256,
    capacity: int = 0,
    reemission=None,
):
    """Build a jitted domain-decomposed spectral traversal.

    The slab exchange of :func:`make_domain_mc_iteration` generalized to
    :class:`~cmacionize_tpu.ops.traversal.SpectralPacketBatch`: the ppermute
    buffers additionally carry the per-packet H/He cross sections and the
    frequency-bin index (the reference's photon pack/unpack moves exactly
    these extra fields, PhotonPacket.hpp:45-71 / DensitySubGrid.hpp:965-1057),
    and the tally is the frequency-binned [n_bins * n_cell_local] array that
    `spectral_tallies_to_ion_integrals` post-processes into per-ion
    mean-intensity and heating integrals.

    Returns (trace_fn, shardings):
        trace_fn(chi_h, chi_he, position, direction, tau, weight,
                 sig_h, sig_he, fbin, emit_mask)
            -> (tally2d [n_bins, nx, ny, nz] sharded on x,
                absorbed_state dict (per-device final packets, for
                reemission),
                diagnostics dict of global scalars)

    chi_h/chi_he are the [nx, ny, nz] opacity-coefficient fields (sharded on
    x); the packet arrays are stacked per-device locals [n_dev, n_photons,
    ...] (sharded on the device dim) — each device emits its own share with
    positions in GLOBAL grid units; emit_mask marks which lanes are real.
    ``absorbed_field`` is the [n_bins, nx, ny, nz] absorbed-weight field
    (sharded on x).

    ``reemission``: optional dict enabling in-loop diffuse re-emission — the
    domain-decomposed equivalent of the reference's PhotonReemitTaskContext
    generations, estimator-identical to the single-device per-packet path
    (reemit_batch applied at the absorption cell, locally on the owning
    device; no exchange needed at re-emission time since the packet stays in
    its cell).  Keys: ``spectra`` (ReemissionSpectra), ``sig_h_tab`` /
    ``sig_he_tab`` ([n_bins] cross sections at bin centers), ``bin_edges``
    ([n_bins+1]), ``AHe``.  When set, trace_fn takes four extra arguments
    after ``emit_mask``: xH, xHe ([nx,ny,nz] f32, sharded on x),
    T ([nx,ny,nz] f32, sharded), and keys ([n_dev] PRNG keys, sharded);
    ``absorbed_field`` then holds only TRULY absorbed weight (after all
    generations died).
    """
    n_dev = mesh.shape[axis]
    nx, ny, nz = global_shape
    assert nx % n_dev == 0
    nx_loc = nx // n_dev
    local_shape = (nx_loc, ny, nz)
    if capacity <= 0:
        capacity = max(4096, n_photons // 2 + n_photons // 32)
    capacity = min(capacity, n_photons)

    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    if reemission is not None:
        _re_spectra = reemission["spectra"]
        _re_sig_h = jnp.asarray(reemission["sig_h_tab"], jnp.float32)
        _re_sig_he = jnp.asarray(reemission["sig_he_tab"], jnp.float32)
        _re_edges = jnp.asarray(reemission["bin_edges"], jnp.float32)
        _re_AHe = float(reemission["AHe"])

    def device_trace(
        chi_h, chi_he, position, direction, tau, weight, sig_h, sig_he,
        fbin, emit_mask, xH=None, xHe=None, T=None, keys=None,
    ):
        my = jax.lax.axis_index(axis)
        x_offset = (my * nx_loc).astype(position.dtype)
        chi_h_flat = chi_h.reshape(-1)
        chi_he_flat = chi_he.reshape(-1)
        ncell_loc = nx_loc * ny * nz
        tally2d = jnp.zeros(n_bins * ncell_loc, chi_h_flat.dtype)

        px = position[0][:, 0] - x_offset
        py = position[0][:, 1]
        pz = position[0][:, 2]
        dx, dy, dz = (direction[0][:, i] for i in range(3))
        tau0 = tau[0]
        weight0 = weight[0]
        sig_h0, sig_he0 = sig_h[0], sig_he[0]
        fbin0 = fbin[0].astype(jnp.int32)
        if reemission is not None:
            xH_flat = xH.astype(jnp.float32).reshape(-1)
            xHe_flat = xHe.astype(jnp.float32).reshape(-1)
            T_flat = T.astype(jnp.float32).reshape(-1)
            key0 = keys[0]
        else:
            key0 = jax.random.PRNGKey(0)
        def classify(px, dx):
            # direction-aware slab membership: a packet exactly on a slab
            # wall belongs to the cell it is about to enter (px == nx_loc
            # moving left is local cell nx_loc-1, not the right neighbor)
            cell_eff = jnp.where(
                dx >= 0, jnp.floor(px), jnp.ceil(px) - 1
            ).astype(jnp.int32)
            return cell_eff >= 0, cell_eff < nx_loc

        # packets emitted into another device's slab are handed off through
        # the superstep exchange: mark them inactive here, active there
        ge_lo, lt_hi = classify(px, dx)
        active0 = emit_mask[0] & ge_lo & lt_hi
        # out-of-slab emissions enter the exchange immediately
        pending_l0 = emit_mask[0] & ~ge_lo
        pending_r0 = emit_mask[0] & ~lt_hi

        def trace_once(tally2d, fields, active):
            px, py, pz, dx, dy, dz, tau, w, sh, she, fb = fields
            cx = jnp.floor(px).astype(jnp.int32)
            cy = jnp.clip(jnp.floor(py).astype(jnp.int32), 0, ny - 1)
            cz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, nz - 1)
            cx_in = jnp.clip(cx, 0, nx_loc - 1)
            packets = traversal.SpectralPacketBatch(
                px, py, pz, cx_in, cy, cz, dx, dy, dz, tau, w, sh, she,
                fb, active, jnp.zeros_like(active),
            )
            return traversal.trace_packets_spectral_auto(
                chi_h_flat, chi_he_flat, packets, tally2d,
                shape=local_shape, n_bins=n_bins,
            )

        def superstep(carry):
            (step, tally2d, px, py, pz, dx, dy, dz, tau, w, sh, she, fb,
             active, pend_l, pend_r, n_esc, n_over, abs_acc, key,
             n_sent) = carry
            fields = (px, py, pz, dx, dy, dz, tau, w, sh, she, fb)
            tally2d, pk = trace_once(tally2d, fields, active)

            if reemission is not None:
                # in-place diffuse re-emission at the absorption cell
                # (PhotonReemitTaskContext equivalent — per-packet, local)
                key, k_re, k_dir, k_tau = jax.random.split(key, 4)
                n_lanes = pk.px.shape[0]
                flat_re = (
                    jnp.clip(pk.cx, 0, nx_loc - 1) * ny + pk.cy
                ) * nz + pk.cz
                from cmacionize_tpu.models import reemission as reemission_mod

                remask, new_freq, _hch = reemission_mod.reemit_batch(
                    k_re, _re_spectra, pk.absorbed, pk.sig_h, pk.sig_he,
                    xH_flat[flat_re], xHe_flat[flat_re], T_flat[flat_re],
                    _re_AHe,
                )
                ndx, ndy, ndz = sources.isotropic_directions(k_dir, n_lanes)
                ntau = sources.sample_tau_targets(k_tau, n_lanes)
                nbin = jnp.clip(
                    jnp.searchsorted(_re_edges, new_freq) - 1, 0, n_bins - 1
                ).astype(jnp.int32)
                pk = pk._replace(
                    dx=jnp.where(remask, ndx, pk.dx),
                    dy=jnp.where(remask, ndy, pk.dy),
                    dz=jnp.where(remask, ndz, pk.dz),
                    tau_left=jnp.where(remask, ntau, pk.tau_left),
                    sig_h=jnp.where(remask, _re_sig_h[nbin], pk.sig_h),
                    sig_he=jnp.where(remask, _re_sig_he[nbin], pk.sig_he),
                    fbin=jnp.where(remask, nbin, pk.fbin),
                    active=pk.active | remask,
                    absorbed=pk.absorbed & ~remask,
                )

            out_left = (active & ~pk.absorbed & ~pk.active & (pk.cx < 0)) | pend_l
            out_right = (
                active & ~pk.absorbed & ~pk.active & (pk.cx >= nx_loc)
            ) | pend_r
            at_lo = my == 0
            at_hi = my == n_dev - 1
            go_left = out_left & ~at_lo
            go_right = out_right & ~at_hi
            escaped = (
                (active | pend_l | pend_r)
                & ~pk.absorbed & ~pk.active & ~go_left & ~go_right
            )
            n_esc = n_esc + jnp.sum(escaped, dtype=jnp.int32)

            # absorbed packets deposit their weight into the local
            # (bin, cell) absorption field — the caller's reemission source
            flat = (
                jnp.clip(pk.cx, 0, nx_loc - 1) * ny + pk.cy
            ) * nz + pk.cz
            abs_acc = abs_acc.at[
                jnp.where(pk.absorbed, pk.fbin * ncell_loc + flat, n_bins * ncell_loc)
            ].add(jnp.where(pk.absorbed, pk.weight, 0.0), mode="drop")

            fexch = (pk.px, pk.py, pk.pz, pk.dx, pk.dy, pk.dz, pk.tau_left,
                     pk.weight, pk.sig_h, pk.sig_he)
            send_l_f, mask_l, ov_l = _compact(fexch, go_left, capacity)
            send_r_f, mask_r, ov_r = _compact(fexch, go_right, capacity)
            (send_l_b,), _, _ = _compact((pk.fbin,), go_left, capacity)
            (send_r_b,), _, _ = _compact((pk.fbin,), go_right, capacity)
            n_over = n_over + ov_l + ov_r
            # exchange-volume counter: real packets on the wire this
            # superstep (RESULTS.md uses it to justify the slab topology)
            n_sent = n_sent + jnp.sum(mask_l, dtype=jnp.int32) + jnp.sum(
                mask_r, dtype=jnp.int32)
            send_l_f = (send_l_f[0] + nx_loc,) + send_l_f[1:]
            send_r_f = (send_r_f[0] - nx_loc,) + send_r_f[1:]

            recv_r = jax.lax.ppermute(
                (*send_r_f, send_r_b, mask_r), axis, right_perm
            )
            recv_l = jax.lax.ppermute(
                (*send_l_f, send_l_b, mask_l), axis, left_perm
            )
            if reemission is not None:
                # re-emitted lanes stay active locally and must survive the
                # merge alongside the received packets
                loc = (pk.px, pk.py, pk.pz, pk.dx, pk.dy, pk.dz, pk.tau_left,
                       pk.weight, pk.sig_h, pk.sig_he, pk.fbin)
                merged = tuple(
                    jnp.concatenate([l, a, b])
                    for l, a, b in zip(loc, recv_r[:-1], recv_l[:-1])
                )
                merged_mask = jnp.concatenate(
                    [pk.active, recv_r[-1], recv_l[-1]]
                )
                merged, active, ov_m = _compact(merged, merged_mask, n_photons)
                n_over = n_over + ov_m
            else:
                merged = tuple(
                    jnp.concatenate([a, b])
                    for a, b in zip(recv_r[:-1], recv_l[:-1])
                )
                merged_mask = jnp.concatenate([recv_r[-1], recv_l[-1]])
                pad = n_photons - merged[0].shape[0]
                if pad > 0:
                    merged = tuple(
                        jnp.concatenate([f, jnp.zeros((pad,), f.dtype)])
                        for f in merged
                    )
                    merged_mask = jnp.concatenate(
                        [merged_mask, jnp.zeros((pad,), bool)]
                    )
                    active = merged_mask
                else:
                    merged, active, ov_m = _compact(
                        merged, merged_mask, n_photons
                    )
                    n_over = n_over + ov_m
            (px, py, pz, dx, dy, dz, tau, w, sh, she, fb) = merged
            fb = fb.astype(jnp.int32)
            # a packet emitted (or re-injected) several slabs away keeps
            # hopping: re-classify received packets against this slab
            ge_lo, lt_hi = classify(px, dx)
            pend_l = active & ~ge_lo
            pend_r = active & ~lt_hi
            active = active & ge_lo & lt_hi
            return (
                step + 1, tally2d, px, py, pz, dx, dy, dz, tau, w, sh, she,
                fb, active, pend_l, pend_r, n_esc, n_over, abs_acc, key,
                n_sent,
            )

        def cond(carry):
            step = carry[0]
            active, pend_l, pend_r = carry[13], carry[14], carry[15]
            n_live = jax.lax.psum(
                jnp.sum(active | pend_l | pend_r, dtype=jnp.int32), axis
            )
            return jnp.logical_and(step < max_supersteps, n_live > 0)

        abs_acc0 = jnp.zeros((n_bins * ncell_loc,), jnp.float32)
        carry = (
            0, tally2d, px, py, pz, dx, dy, dz, tau0, weight0, sig_h0,
            sig_he0, fbin0, active0, pending_l0, pending_r0,
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), abs_acc0,
            key0, jnp.asarray(0, jnp.int32),
        )
        carry = jax.lax.while_loop(cond, superstep, carry)
        tally2d, n_esc, n_over, abs_acc = (
            carry[1], carry[16], carry[17], carry[18]
        )
        truncated = jnp.sum(
            carry[13] | carry[14] | carry[15], dtype=jnp.int32
        )
        diagnostics = {
            "n_escaped": jax.lax.psum(n_esc, axis),
            "buffer_overflow": jax.lax.psum(n_over, axis),
            "truncated_live": jax.lax.psum(truncated, axis),
            "supersteps": carry[0],
            "packets_exchanged": jax.lax.psum(carry[20], axis),
        }
        absorbed_field = abs_acc.reshape(n_bins, nx_loc, ny, nz)
        tally4d = tally2d.reshape(n_bins, nx_loc, ny, nz)
        return tally4d, absorbed_field, diagnostics

    in_specs = [
        P(axis), P(axis),  # chi_h, chi_he (sharded fields)
        P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
        P(axis),  # per-device packet arrays (stacked [n_dev, ...])
    ]
    if reemission is not None:
        in_specs += [P(axis), P(axis), P(axis), P(axis)]  # xH, xHe, T, keys
    sharded = shard_map(
        device_trace,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(None, axis), P(None, axis), P()),
        check_vma=False,
    )
    shardings = {
        "field": NamedSharding(mesh, P(axis)),
        "packets": NamedSharding(mesh, P(axis)),
    }
    return jax.jit(sharded), shardings


# ---------------------------------------------------------------------------
# Sharded hydrodynamics: halo-exchange MUSCL-Hancock step
# ---------------------------------------------------------------------------


def _halo_pad_axis0(field, axis_name, my, n_dev, bc_lo, bc_hi, *,
                    n=2, flip_sign=False, inflow_lo=None, inflow_hi=None):
    """Pad the sharded x-axis with neighbor halos via ppermute; physical
    boundary conditions are applied on the edge devices only.

    This is the reference's pairwise outer sweep
    (HydroDensitySubGrid::outer_gradient_sweep / outer_flux_sweep,
    /root/reference/src/HydroDensitySubGrid.hpp:626,351) expressed as an ICI
    halo exchange.
    """
    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    send_hi = field[-n:]
    send_lo = field[:n]
    recv_lo = jax.lax.ppermute(send_hi, axis_name, right_perm)
    recv_hi = jax.lax.ppermute(send_lo, axis_name, left_perm)
    if bc_lo == hydro_mod.BC_PERIODIC:
        ghost_lo = recv_lo  # circular permute already wraps the domain
    else:
        bc_ghost = hydro_mod.ghost_one_side(
            field, 0, "lo", bc_lo, n, flip_sign, inflow_lo
        )
        ghost_lo = jnp.where(my == 0, bc_ghost, recv_lo)
    if bc_hi == hydro_mod.BC_PERIODIC:
        ghost_hi = recv_hi
    else:
        bc_ghost = hydro_mod.ghost_one_side(
            field, 0, "hi", bc_hi, n, flip_sign, inflow_hi
        )
        ghost_hi = jnp.where(my == n_dev - 1, bc_ghost, recv_hi)
    return jnp.concatenate([ghost_lo, field, ghost_hi], axis=0)


def _device_hydro_body(
    u,
    dt,
    *,
    my,
    axis,
    n_dev,
    boundaries,
    cell_size,
    gamma,
    riemann_solver: str = "HLLC",
    gravity=None,
    isothermal_sound_speed=None,
    inflow_x=None,
    inflow_yz=None,
):
    """Device-level MUSCL-Hancock step on an x-slab: 2-cell primitive halo
    exchange over ICI + the whole-array padded update.  Shared by
    make_domain_hydro_step and the fused RHD step.

    ``isothermal_sound_speed``: γ == 1 mode — pressure re-pinned to c_s²ρ
    before and after the step (cf. ops.hydro.isothermal_hydro_step).
    ``inflow_x``: {"lo"/"hi": 5-tuple of [2, ny, nz] ghost slabs} for
    BC_INFLOW x edges (applied on the edge devices only — the Bondi
    boundary, cf. BondiHydroBoundary.hpp).  ``inflow_yz``: {(1|2,
    "lo"/"hi"): 5-tuple of LOCAL ghost slabs matching the x-halo-padded
    field shape} — this device's x-slice of the global padded-lattice
    ghost profile.
    """
    normal = {0: 1, 1: 2, 2: 3}
    if isothermal_sound_speed is not None:
        w0 = hydro_mod.primitives_from_conserved(u, gamma)
        w0 = w0._replace(p=isothermal_sound_speed**2 * w0.rho)
        u = hydro_mod.conserved_from_primitives(w0, gamma)
    w = hydro_mod.primitives_from_conserved(u, gamma)
    fields = list(w)
    # sharded x-axis: halo exchange + edge BCs
    bc_x_lo, bc_x_hi = boundaries[0]
    x_lo = inflow_x.get("lo") if inflow_x else None
    x_hi = inflow_x.get("hi") if inflow_x else None
    for i, f in enumerate(fields):
        fields[i] = _halo_pad_axis0(
            f, axis, my, n_dev, bc_x_lo, bc_x_hi,
            flip_sign=(i == normal[0]),
            inflow_lo=None if x_lo is None else x_lo[i],
            inflow_hi=None if x_hi is None else x_hi[i],
        )
    # local y/z axes: ordinary BC padding
    for ax in (1, 2):
        bc_lo, bc_hi = boundaries[ax]
        lo_t = inflow_yz.get((ax, "lo")) if inflow_yz else None
        hi_t = inflow_yz.get((ax, "hi")) if inflow_yz else None
        for i, f in enumerate(fields):
            fields[i] = hydro_mod._pad_axis(
                f, ax, bc_lo, bc_hi, n=2,
                flip_sign=(i == normal[ax]),
                inflow_lo=None if lo_t is None else lo_t[i],
                inflow_hi=None if hi_t is None else hi_t[i],
            )
    wp = hydro_mod.Primitives(*fields)
    u = hydro_mod.hydro_step_padded(
        u, wp, dt, cell_size=cell_size, gamma=gamma,
        riemann_solver=riemann_solver, gravity=gravity,
    )
    if isothermal_sound_speed is not None:
        w1 = hydro_mod.primitives_from_conserved(u, gamma)
        w1 = w1._replace(p=isothermal_sound_speed**2 * w1.rho)
        u = hydro_mod.conserved_from_primitives(w1, gamma)
    return u


def make_domain_hydro_step(
    mesh,
    *,
    boundaries,
    cell_size,
    gamma: float = 5.0 / 3.0,
    axis: str = "x",
):
    """Build a jitted domain-decomposed MUSCL-Hancock hydro step.

    The conserved-state arrays live sharded over grid-x; each step exchanges
    a 2-cell primitive halo with the slab neighbors over ICI (one ppermute
    pair per field) and then runs the identical whole-array update
    (:func:`cmacionize_tpu.ops.hydro.hydro_step_padded`) — gradients,
    half-step prediction, HLLC fluxes, conserved update.  Physics-identical
    to the single-device step (unit-tested to f32 round-off).

    Returns (step_fn, sharding): step_fn(u: HydroState, dt) -> HydroState.
    """
    n_dev = mesh.shape[axis]

    def device_step(u, dt):
        my = jax.lax.axis_index(axis)
        return _device_hydro_body(
            u, dt, my=my, axis=axis, n_dev=n_dev, boundaries=boundaries,
            cell_size=cell_size, gamma=gamma,
        )

    sharded = shard_map(
        device_step,
        mesh=mesh,
        in_specs=(
            hydro_mod.HydroState(*([P(axis)] * 5)),
            P(),
        ),
        out_specs=hydro_mod.HydroState(*([P(axis)] * 5)),
        check_vma=False,
    )
    return jax.jit(sharded), NamedSharding(mesh, P(axis))


def domain_cfl_timestep(mesh, *, cell_size, gamma=5.0 / 3.0, cfl=0.2,
                        axis: str = "x"):
    """Sharded CFL timestep: local minimum + pmin over the mesh axis."""

    def device_cfl(u):
        local = hydro_mod.cfl_timestep(u, cell_size, cfl=cfl, gamma=gamma)
        return jax.lax.pmin(local, axis)

    return jax.jit(
        shard_map(
            device_cfl,
            mesh=mesh,
            in_specs=(hydro_mod.HydroState(*([P(axis)] * 5)),),
            out_specs=P(),
            check_vma=False,
        )
    )


# ---------------------------------------------------------------------------
# Sharded RHD: radiation superstep exchange + two-temperature coupling +
# halo-exchange hydro in ONE fused sharded step
# ---------------------------------------------------------------------------


def make_domain_rhd_step(
    mesh,
    *,
    global_shape: Tuple[int, int, int],
    boundaries,
    cell_size,
    gamma: float,
    n_photons: int,
    nloop: int,
    sigma_dx: float,
    source_gpos: Tuple[float, float, float],
    jfac_scale: float,
    alpha: float,
    coupling: dict,
    riemann_solver: str = "HLLC",
    isothermal_sound_speed=None,
    cooling: bool = False,
    axis: str = "x",
    capacity: int = 0,
    max_supersteps: int = 256,
    extras_specs=None,
    inflow_x=None,
    chunk_len: int = 0,
):
    """Build the fused domain-decomposed RHD step (SURVEY §7 Phase 3+4; the
    distributed integration of radiation and hydro the reference designed in
    /root/reference/src/TaskBasedRadiationHydrodynamicsSimulation.cpp:1546-2122
    as one task graph).

    One call = ``nloop`` MC ionization iterations with source-replicated
    emission + ppermute packet exchange over the slab mesh, the
    two-temperature energy coupling, and a halo-exchange MUSCL-Hancock
    hydro step — all inside a single shard_map, so the whole RHD step is
    one XLA program with ICI collectives and no host round trips.

    ``coupling``: kwargs for ops.hydro.two_temperature_coupling (minus
    gamma).  ``extras_specs``: pytree of PartitionSpecs for the optional
    per-call physics inputs dict (the extended envelope — cf. the
    reference's all-in-one RHD task graph):

    - ``"gravity"``: 3-tuple of [nx, ny, nz] acceleration fields
      (ExternalPotential / precomputed, sharded on x)
    - ``"mask"`` + ``"mask_state"``: HydroMask freeze regions (bool field +
      held HydroState, sharded on x)
    - ``"inflow_yz"``: {(1|2, "lo"/"hi"): 5-tuple of stacked per-device
      ghost slabs [n_dev, nx_loc+4, ...]} for y/z BC_INFLOW profiles

    ``inflow_x``: {"lo"/"hi": 5-tuple of [2, ny, nz] ghost slabs} closure
    constants for x-edge BC_INFLOW (identical on every device; applied on
    the edge devices only).

    ``chunk_len`` > 0 builds the scan-fused variant: one dispatch advances
    ``chunk_len`` steps at fixed dt inside the shard_map (the sharded
    equivalent of RHDSimulation._run_fused_chunks — one XLA program, no
    per-step host round trips), with the per-step diagnostics summed.

    Returns (step_fn, shardings): step_fn(keys, u, xh, extras, dt) →
    (u, xh, diagnostics); u/xh sharded P(axis), keys a [n_dev] key array,
    extras a dict matching ``extras_specs`` ({} when None).
    """
    n_dev = mesh.shape[axis]
    nx, ny, nz = global_shape
    assert nx % n_dev == 0, "grid x must divide over devices"
    nx_loc = nx // n_dev
    if nx_loc < 2:
        raise ValueError(
            f"slab width {nx_loc} < hydro halo width 2: grid x = {nx} "
            f"cannot shard over {n_dev} devices")
    local_shape = (nx_loc, ny, nz)
    if capacity <= 0:
        capacity = max(4096, n_photons // 2 + n_photons // 32)
    capacity = min(capacity, n_photons)
    from cmacionize_tpu import constants

    def device_step_body(key, u, xh, extras, dt):
        my = jax.lax.axis_index(axis)
        n_esc = jnp.asarray(0, jnp.int32)
        n_over = jnp.asarray(0, jnp.int32)
        n_trunc = jnp.asarray(0, jnp.int32)
        n_traced = jnp.asarray(0, jnp.int32)
        if nloop > 0:
            number_density = u.rho / constants.PROTON_MASS
            for _ in range(nloop):
                key, sub = jax.random.split(key)
                chi = (number_density * xh * sigma_dx).reshape(-1)
                tally, esc, over, trunc, traced = _device_slab_mc_loop(
                    sub, chi, my=my, axis=axis, n_dev=n_dev, nx_loc=nx_loc,
                    ny=ny, nz=nz, n_photons=n_photons,
                    source_gpos=source_gpos, capacity=capacity,
                    max_supersteps=max_supersteps,
                )
                jH = tally.reshape(local_shape) * jfac_scale
                xh = ionization.hydrogen_neutral_fraction(
                    jH, number_density, alpha)
                n_esc, n_over, n_trunc, n_traced = (
                    n_esc + esc, n_over + over, n_trunc + trunc,
                    n_traced + traced)
            u = hydro_mod.two_temperature_coupling(
                u, xh, gamma=gamma, **coupling)
        if cooling:
            from cmacionize_tpu.ops import derijcke

            u = derijcke.cooling_substep(u, dt, gamma)
        inflow_yz = None
        if "inflow_yz" in extras:
            # stacked per-device slabs → this device's local slice
            inflow_yz = {
                k: tuple(f[0] for f in v)
                for k, v in extras["inflow_yz"].items()
            }
        u = _device_hydro_body(
            u, dt, my=my, axis=axis, n_dev=n_dev, boundaries=boundaries,
            cell_size=cell_size, gamma=gamma, riemann_solver=riemann_solver,
            isothermal_sound_speed=isothermal_sound_speed,
            gravity=extras.get("gravity"),
            inflow_x=inflow_x, inflow_yz=inflow_yz,
        )
        if "mask" in extras:
            u = hydro_mod.apply_hydro_mask(
                u, extras["mask"], extras["mask_state"])
        diagnostics = {
            "n_escaped": jax.lax.psum(n_esc, axis),
            "buffer_overflow": jax.lax.psum(n_over, axis),
            "truncated_live": jax.lax.psum(n_trunc, axis),
            "packets_traced": n_traced.reshape(1),
        }
        return key, u, xh, diagnostics

    if chunk_len > 0:
        def device_step(keys, u, xh, extras, dt):
            key = keys[0]
            diag0 = {
                "n_escaped": jnp.zeros((), jnp.int32),
                "buffer_overflow": jnp.zeros((), jnp.int32),
                "truncated_live": jnp.zeros((), jnp.int32),
                "packets_traced": jnp.zeros((1,), jnp.int32),
            }

            def body(carry, _):
                key, u, xh, diag_acc = carry
                key, sub = jax.random.split(key)
                _, u, xh, diag = device_step_body(sub, u, xh, extras, dt)
                diag_acc = jax.tree.map(
                    lambda a, b: a + b, diag_acc, diag)
                return (key, u, xh, diag_acc), None

            (key, u, xh, diag), _ = jax.lax.scan(
                body, (key, u, xh, diag0), None, length=chunk_len)
            return u, xh, diag
    else:
        def device_step(keys, u, xh, extras, dt):
            _, u, xh, diag = device_step_body(keys[0], u, xh, extras, dt)
            return u, xh, diag

    if extras_specs is None:
        extras_specs = {}
    sharded = shard_map(
        device_step,
        mesh=mesh,
        in_specs=(
            P(axis),
            hydro_mod.HydroState(*([P(axis)] * 5)),
            P(axis),
            extras_specs,
            P(),
        ),
        out_specs=(
            hydro_mod.HydroState(*([P(axis)] * 5)),
            P(axis),
            {
                "n_escaped": P(), "buffer_overflow": P(),
                "truncated_live": P(), "packets_traced": P(axis),
            },
        ),
        check_vma=False,
    )
    shardings = {
        "field": NamedSharding(mesh, P(axis)),
        "keys": NamedSharding(mesh, P(axis)),
    }
    return jax.jit(sharded), shardings
