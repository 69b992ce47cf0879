"""Riemann-solver micro-benchmark: solves/s for HLLC and the exact solver.

Counterpart of the reference's timing harness
(/root/reference/timing/timeRiemannSolver.cpp with TimingTools.hpp's
repeat/statistics macros): random admissible left/right states, batched on
the accelerator, best-of-N repetition statistics:

    python tools/time_riemann.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cmacionize_tpu.ops import riemann  # noqa: E402

N = 1 << 20
REPS = 5


def main():
    rng = np.random.default_rng(42)

    def states():
        return (
            jnp.asarray(rng.uniform(0.1, 10.0, N), jnp.float32),  # rho
            jnp.asarray(rng.uniform(-2.0, 2.0, N), jnp.float32),  # u
            jnp.asarray(rng.uniform(-2.0, 2.0, N), jnp.float32),  # v
            jnp.asarray(rng.uniform(-2.0, 2.0, N), jnp.float32),  # w
            jnp.asarray(rng.uniform(0.1, 10.0, N), jnp.float32),  # p
        )

    L, R = states(), states()

    for name, fn in (
        ("hllc", jax.jit(lambda L, R: riemann.hllc_flux(*L, *R))),
        ("exact", jax.jit(lambda L, R: riemann.exact_flux(*L, *R))),
    ):
        flux = fn(L, R)  # compile
        _ = float(flux.mass.sum())
        best = np.inf
        for _rep in range(REPS):
            # vary an input so no layer can reuse the previous result
            Lv = (L[0] + 1e-6 * (_rep + 1),) + L[1:]
            t0 = time.time()
            flux = fn(Lv, R)
            _ = float(flux.mass.sum())  # readback = honest timing
            best = min(best, time.time() - t0)
        print(f"{name:6s}: {N / best:.3e} solves/s "
              f"(batch {N}, best of {REPS}: {best * 1e3:.1f} ms)")


if __name__ == "__main__":
    main()
