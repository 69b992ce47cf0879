"""Domain-decomposed MC tests on the 8-virtual-device CPU mesh.

The equivalent of the reference's distributed test strategy
(testDensitySubGrid_MPI.cpp — pack/send/unpack across ranks on one host):
the slab-sharded superstep loop must reproduce the single-device physics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmacionize_tpu.parallel.domain import make_domain_mc_iteration
from cmacionize_tpu.parallel.mesh import make_mesh


def _setup(shape=(32, 16, 16), n_photons=16384):
    dx = 10 * 3.086e16 / shape[0]
    sigma = 6.3e-22
    params = dict(
        global_shape=shape,
        n_photons=n_photons,
        sigma_dx=sigma * dx,
        source_gpos=(shape[0] / 2.0, shape[1] / 2.0, shape[2] / 2.0),
        jfac_scale=4.26e49 * sigma * dx / (n_photons * dx**3),
        alpha=4e-19,
    )
    return params, dx


def test_domain_decomposed_matches_single_device():
    mesh = make_mesh(8, axis_names=("x",))
    params, dx = _setup()
    shape = params["global_shape"]
    step, shardings = make_domain_mc_iteration(mesh, **params)

    nd = jnp.full(shape, 1e8, jnp.float32)
    xh = jnp.full(shape, 1e-6, jnp.float32)
    nd = jax.device_put(nd, shardings["field"])
    xh = jax.device_put(xh, shardings["field"])

    # also run the equivalent single-device iteration for comparison
    from cmacionize_tpu.models.ionization_simulation import h_only_iteration

    xh_s = jnp.full(shape, 1e-6, jnp.float32)
    for i in range(6):
        keys = jax.random.split(jax.random.PRNGKey(100 + i), 8)
        xh, jH, diag = step(keys, xh, nd)
        assert int(diag["buffer_overflow"]) == 0
        assert int(diag["truncated_live"]) == 0
        xh_s, _, n_esc_s = h_only_iteration(
            jax.random.PRNGKey(200 + i),
            xh_s,
            jnp.full(shape, 1e8, jnp.float32),
            shape=shape,
            periodic=(False, False, False),
            n_photons=params["n_photons"],
            sigma_dx=params["sigma_dx"],
            source_gpos=params["source_gpos"],
            jfac_scale=params["jfac_scale"],
            alpha=params["alpha"],
        )

    xh_np = np.asarray(xh)
    xh_s_np = np.asarray(xh_s)
    assert np.all(np.isfinite(xh_np))
    # identical physics, different RNG streams: ionized volumes must agree
    v_dd = (xh_np < 0.5).sum()
    v_sd = (xh_s_np < 0.5).sum()
    assert v_dd == pytest.approx(v_sd, rel=0.15)
    # center ionized on both
    c = tuple(s // 2 for s in shape)
    assert xh_np[c] < 1e-3 and xh_s_np[c] < 1e-3
    # corners neutral
    assert xh_np[0, 0, 0] > 0.9


def test_domain_decomposed_conserves_packets():
    # transparent medium: every packet must escape, none lost in exchange
    mesh = make_mesh(8, axis_names=("x",))
    shape = (32, 8, 8)
    n_photons = 4096
    step, shardings = make_domain_mc_iteration(
        mesh,
        global_shape=shape,
        n_photons=n_photons,
        sigma_dx=1e-30,
        source_gpos=(16.0, 4.0, 4.0),
        jfac_scale=1.0,
        alpha=4e-19,
    )
    nd = jax.device_put(jnp.full(shape, 1e8, jnp.float32), shardings["field"])
    xh = jax.device_put(jnp.full(shape, 1e-6, jnp.float32), shardings["field"])
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    _, _, diag = step(keys, xh, nd)
    assert int(diag["n_escaped"]) == n_photons
    assert int(diag["buffer_overflow"]) == 0
    assert int(diag["truncated_live"]) == 0


def test_domain_spectral_same_stream_matches_single_device():
    """Same-stream strict test: trace the SAME emitted
    spectral packets through the sharded and single-device paths; the
    frequency-binned tallies must agree to f32 round-off and every packet
    must be accounted for."""
    from cmacionize_tpu.ops import traversal
    from cmacionize_tpu.parallel.domain import make_domain_spectral_trace

    mesh = make_mesh(8, axis_names=("x",))
    shape = (32, 12, 12)
    nx, ny, nz = shape
    n_bins = 5
    n_photons = 4096
    key = jax.random.PRNGKey(3)

    # opacity coefficient fields with structure across slabs
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    chi_h = 0.05 + 0.3 * jax.random.uniform(k1, shape)
    chi_he = 0.02 + 0.1 * jax.random.uniform(k2, shape)

    # one shared emission (positions in global grid units)
    pos = jax.random.uniform(
        k3, (n_photons, 3), minval=2.0, maxval=10.0
    ) * jnp.asarray([nx / 12.0, ny / 12.0, nz / 12.0])
    dirs = jax.random.normal(k4, (n_photons, 3))
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    tau = -jnp.log(jax.random.uniform(k5, (n_photons,), minval=1e-6))
    fbin = jax.random.randint(k6, (n_photons,), 0, n_bins)
    sig_h_tab = jnp.linspace(1.0, 0.3, n_bins)
    sig_he_tab = jnp.linspace(0.8, 0.2, n_bins)
    weight = jnp.ones((n_photons,), jnp.float32)

    # single-device reference
    packets = traversal.make_spectral_packets(
        pos, dirs, tau, weight, sig_h_tab[fbin], sig_he_tab[fbin],
        fbin, shape,
    )
    tally_ref = jnp.zeros(n_bins * nx * ny * nz, jnp.float32)
    tally_ref, pk_ref = traversal.trace_packets_spectral(
        chi_h.reshape(-1), chi_he.reshape(-1), packets, tally_ref,
        shape=shape, n_bins=n_bins,
    )

    # sharded: same packets, all assigned to device 0's emission arrays
    trace_fn, shardings = make_domain_spectral_trace(
        mesh, global_shape=shape, n_bins=n_bins, n_photons=n_photons,
    )

    def stack_dev0(arr):
        out = jnp.zeros((8,) + arr.shape, arr.dtype)
        return out.at[0].set(arr)

    emit_mask = jnp.zeros((8, n_photons), bool).at[0].set(True)
    tally_dd, absorbed_field, diag = trace_fn(
        chi_h, chi_he,
        stack_dev0(pos), stack_dev0(dirs), stack_dev0(tau),
        stack_dev0(weight), stack_dev0(sig_h_tab[fbin]),
        stack_dev0(sig_he_tab[fbin]), stack_dev0(fbin), emit_mask,
    )

    tally_dd_flat = np.asarray(tally_dd).reshape(-1)
    tally_ref_np = np.asarray(tally_ref)
    np.testing.assert_allclose(
        tally_dd_flat, tally_ref_np, rtol=2e-5, atol=1e-5
    )
    # packet conservation
    n_abs_ref = int(jnp.sum(pk_ref.absorbed))
    assert int(diag["buffer_overflow"]) == 0
    assert int(diag["truncated_live"]) == 0
    assert int(diag["n_escaped"]) == n_photons - n_abs_ref
    # absorbed field totals the absorbed weight
    assert float(jnp.sum(absorbed_field)) == pytest.approx(
        float(n_abs_ref), rel=1e-5
    )


def test_domain_hydro_step_matches_single_device():
    """Sharded hydro halo exchange: bit-level agreement with the
    single-device MUSCL-Hancock step for the same state (same stream)."""
    from cmacionize_tpu.ops import hydro as hydro_mod
    from cmacionize_tpu.parallel.domain import (
        domain_cfl_timestep, make_domain_hydro_step,
    )

    mesh = make_mesh(8, axis_names=("x",))
    shape = (32, 8, 8)
    key = jax.random.PRNGKey(11)
    k1, k2, k3 = jax.random.split(key, 3)
    rho = 1.0 + jax.random.uniform(k1, shape)
    p = 0.5 + jax.random.uniform(k2, shape)
    v = 0.3 * jax.random.normal(k3, shape + (3,))
    w = hydro_mod.Primitives(
        rho=rho, vx=v[..., 0], vy=v[..., 1], vz=v[..., 2], p=p
    )
    u = hydro_mod.conserved_from_primitives(w)

    boundaries = (
        (hydro_mod.BC_REFLECTIVE, hydro_mod.BC_OUTFLOW),
        (hydro_mod.BC_PERIODIC, hydro_mod.BC_PERIODIC),
        (hydro_mod.BC_REFLECTIVE, hydro_mod.BC_REFLECTIVE),
    )
    cell_size = (1.0, 1.0, 1.0)
    dt = 0.05

    u_ref = hydro_mod.hydro_step(
        u, dt, boundaries=boundaries, cell_size=cell_size
    )

    step, sharding = make_domain_hydro_step(
        mesh, boundaries=boundaries, cell_size=cell_size
    )
    u_sharded = jax.tree.map(lambda f: jax.device_put(f, sharding), u)
    u_dd = step(u_sharded, dt)

    for name in u._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(u_dd, name)),
            np.asarray(getattr(u_ref, name)),
            rtol=1e-6, atol=1e-8,
            err_msg=name,
        )

    # sharded CFL == single-device CFL
    cfl_fn = domain_cfl_timestep(mesh, cell_size=cell_size)
    dt_dd = float(cfl_fn(u_sharded))
    dt_ref = float(hydro_mod.cfl_timestep(u, cell_size))
    assert dt_dd == pytest.approx(dt_ref, rel=1e-6)


def test_domain_hydro_periodic_x():
    """Periodic x with sharding: the circular ppermute must wrap the domain
    exactly like the single-device periodic padding."""
    from cmacionize_tpu.ops import hydro as hydro_mod
    from cmacionize_tpu.parallel.domain import make_domain_hydro_step

    mesh = make_mesh(8, axis_names=("x",))
    shape = (16, 4, 4)
    key = jax.random.PRNGKey(5)
    rho = 1.0 + jax.random.uniform(key, shape)
    w = hydro_mod.Primitives(
        rho=rho,
        vx=0.5 * jnp.ones(shape), vy=jnp.zeros(shape), vz=jnp.zeros(shape),
        p=jnp.ones(shape),
    )
    u = hydro_mod.conserved_from_primitives(w)
    boundaries = ((hydro_mod.BC_PERIODIC, hydro_mod.BC_PERIODIC),) * 3
    u_ref = hydro_mod.hydro_step(
        u, 0.04, boundaries=boundaries, cell_size=(1.0, 1.0, 1.0)
    )
    step, sharding = make_domain_hydro_step(
        mesh, boundaries=boundaries, cell_size=(1.0, 1.0, 1.0)
    )
    u_dd = step(jax.tree.map(lambda f: jax.device_put(f, sharding), u), 0.04)
    np.testing.assert_allclose(
        np.asarray(u_dd.rho), np.asarray(u_ref.rho), rtol=1e-6, atol=1e-8
    )
