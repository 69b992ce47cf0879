"""Drive: 1D Sod shock tube on the 3D hydro solver, vs the exact solution.

Usage: PYTHONPATH=. [JAX_PLATFORMS=cpu] python benchmarks/run_sod.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from cmacionize_tpu.ops import hydro, riemann  # noqa: E402

GAMMA = 5.0 / 3.0


def main():
    n = 256
    shape = (n, 4, 4)
    dx = 1.0 / n
    x = (np.arange(n) + 0.5) * dx
    rho = np.where(x < 0.5, 1.0, 0.125)
    p = np.where(x < 0.5, 1.0, 0.1)
    w = hydro.Primitives(
        rho=jnp.asarray(np.broadcast_to(rho[:, None, None], shape), jnp.float32),
        vx=jnp.zeros(shape, jnp.float32),
        vy=jnp.zeros(shape, jnp.float32),
        vz=jnp.zeros(shape, jnp.float32),
        p=jnp.asarray(np.broadcast_to(p[:, None, None], shape), jnp.float32),
    )
    u = hydro.conserved_from_primitives(w, GAMMA)
    boundaries = (
        (hydro.BC_OUTFLOW, hydro.BC_OUTFLOW),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
        (hydro.BC_PERIODIC, hydro.BC_PERIODIC),
    )
    cell_size = (dx, dx, dx)
    t, t_end, steps = 0.0, 0.2, 0
    t0 = time.time()
    while t < t_end:
        dt = min(
            float(hydro.cfl_timestep(u, cell_size, cfl=0.4, gamma=GAMMA)),
            t_end - t,
        )
        u = hydro.hydro_step(
            u, dt, boundaries=boundaries, cell_size=cell_size, gamma=GAMMA
        )
        t += dt
        steps += 1
    jax.block_until_ready(u)
    elapsed = time.time() - t0
    ncells = np.prod(shape)
    print(f"{steps} steps in {elapsed:.2f}s "
          f"({steps * ncells / elapsed:.3g} cell-updates/s incl. compile)")

    w = hydro.primitives_from_conserved(u, GAMMA)
    rho_num = np.asarray(w.rho[:, 2, 2])
    s = jnp.asarray((x - 0.5) / t_end, jnp.float32)
    rho_ex, _, _ = riemann.exact_sample(
        jnp.asarray(1.0), jnp.asarray(0.0), jnp.asarray(1.0),
        jnp.asarray(0.125), jnp.asarray(0.0), jnp.asarray(0.1),
        s, gamma=GAMMA,
    )
    l1 = np.abs(rho_num - np.asarray(rho_ex)).mean()
    print(f"Sod density L1 error vs exact: {l1:.5f}")
    assert l1 < 0.01, "Sod profile does not match the exact solution"
    print("PASS")


if __name__ == "__main__":
    main()
