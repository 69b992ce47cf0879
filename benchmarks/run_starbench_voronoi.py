"""Drive: starbench D-type expansion on a Voronoi mesh (RHD, unstructured).

The Voronoi variant of the starbench benchmark
(/root/reference/benchmarks/starbench_voronoi.param: same physics as
starbench on a UniformRandom Voronoi grid).  Validation compares the
ionization-front radius to the Spitzer / Hosokawa-Inutsuka expansion laws
with first-order-scheme tolerances.

Usage: PYTHONPATH=. python benchmarks/run_starbench_voronoi.py [small]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cmacionize_tpu.models import voronoi  # noqa: E402
from cmacionize_tpu.models.grid import GridGeometry  # noqa: E402
from cmacionize_tpu.models.rhd_simulation import (  # noqa: E402
    hosokawa_inutsuka_radius,
    spitzer_radius,
)
from cmacionize_tpu.models.voronoi_hydro import VoronoiRHDSimulation  # noqa: E402

PC = 3.086e16
MYR = 3.15576e13


def build_simulation(small: bool, mesh_motion: bool = False, seed: int = 42):
    n_gen = 12000 if small else 40000
    n_photons = 50000 if small else 500000
    total_time = 0.141 * MYR
    n_steps = 128 if small else 1024
    dt = total_time / n_steps

    # full sphere: source at the box center (box sized like the Cartesian
    # starbench so the Stromgren radius spans >= 2 mean cell spacings)
    geometry = GridGeometry(
        anchor=(-1.256 * PC,) * 3, sides=(2.512 * PC,) * 3, shape=(32,) * 3,
    )
    rng = np.random.default_rng(seed)
    grid = voronoi.build_voronoi_grid(
        geometry, rng.random((n_gen, 3)), num_lloyd=2)
    sim = VoronoiRHDSimulation(
        grid,
        gamma=1.0001,
        timestep=dt,
        luminosity=1e49,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=n_photons,
        nloop=4 if small else 10,
        number_density=3.113e9,
        temperature=100.0,
        mesh_motion=mesh_motion,
        seed=seed,
    )
    return sim, n_steps


def main():
    small = "small" in sys.argv[1:]
    sim, n_steps = build_simulation(small)
    t0 = time.time()
    sim.run(n_steps, log=print)
    elapsed = time.time() - t0
    print(f"{n_steps} steps on {sim.grid.n_cells} Voronoi cells "
          f"in {elapsed:.1f}s")

    r_front = sim.ionization_front_radius()
    # Stromgren radius for these parameters (full sphere)
    n_h = 3.113e9
    r_st = (3.0 * 1e49 / (4.0 * np.pi * n_h**2 * 2.7e-19)) ** (1.0 / 3.0)
    r_sp = spitzer_radius(sim.time, r_st)
    r_hi = hosokawa_inutsuka_radius(sim.time, r_st)
    print(f"front radius:          {r_front / PC:.3f} pc")
    print(f"Spitzer prediction:    {r_sp / PC:.3f} pc")
    print(f"Hosokawa-Inutsuka:     {r_hi / PC:.3f} pc")
    assert r_front > r_st, "front never expanded beyond the Stromgren radius"
    assert 0.75 * r_sp < r_front < 1.35 * r_hi, (
        "front radius outside the starbench band")
    print("PASS")


if __name__ == "__main__":
    main()
