"""Drive: starbench D-type expansion (coupled RHD) vs analytic radii.

The workload follows /root/reference/benchmarks/starbench.param: uniform
n = 3113 cm^-3 / 100 K cloud, central 1e49 s^-1 source, HLLC hydro with
gamma = 1.0001, two-temperature radiative heating, t_end = 0.141 Myr.
The validation compares the ionization-front radius to the Spitzer and
Hosokawa-Inutsuka expansion laws (Bisbas et al. 2015; the measured front
should lie between/near them, cf. /root/reference/benchmarks/starbench.py).

Usage: PYTHONPATH=. python benchmarks/run_starbench.py [small]
  small: 32^3 grid, 1e5 photons, 512 steps (~6x faster)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cmacionize_tpu.models.grid import GridGeometry  # noqa: E402
from cmacionize_tpu.models.rhd_simulation import (  # noqa: E402
    DensityBlock,
    RHDConfig,
    RHDSimulation,
    hosokawa_inutsuka_radius,
    spitzer_radius,
)
from cmacionize_tpu.utils.logging import TerminalLog  # noqa: E402

PC = 3.086e16
MYR = 3.15576e13


def build_simulation(small: bool):
    """Construct the starbench RHDSimulation (also used by bench.py)."""
    n_cells = 32 if small else 64
    n_photons = 100000 if small else 1000000
    total_time = 0.141 * MYR
    n_steps = 512 if small else 2048
    dt = total_time / n_steps

    geometry = GridGeometry(
        anchor=(-1.256 * PC,) * 3,
        sides=(2.512 * PC,) * 3,
        shape=(n_cells,) * 3,
    )
    config = RHDConfig(
        geometry=geometry,
        gamma=1.0001,
        timestep=dt,
        total_time=total_time,
        luminosity=1e49,
        source_position=(0.0, 0.0, 0.0),
        cross_section=6.3e-22,
        recombination_rate=2.7e-19,
        n_photons=n_photons,
        nloop=10 if not small else 4,
        blocks=[
            DensityBlock(
                origin=(0.0, 0.0, 0.0),
                sides=(2.512 * PC,) * 3,
                number_density=3.113e9,
                temperature=100.0,
            )
        ],
        background_density=3.113e9,
        background_temperature=100.0,
    )
    sim = RHDSimulation(config, log=TerminalLog("info"))
    return sim, config


def main():
    small = "small" in sys.argv[1:]
    n_steps = 512 if small else 2048
    n_photons = 100000 if small else 1000000
    sim, config = build_simulation(small)
    geometry = config.geometry

    # analytic reference
    q, n, alpha = 1e49, 3.113e9, 2.7e-19
    r_st = (3 * q / (4 * np.pi * n**2 * alpha)) ** (1 / 3)
    print(f"Stromgren radius: {r_st / PC:.3f} pc")

    t0 = time.time()
    sim.advance(n_steps, log_every=max(1, n_steps // 8))
    elapsed = time.time() - t0
    ncell = np.prod(geometry.shape)
    print(f"{n_steps} RHD steps in {elapsed:.1f}s "
          f"({n_steps * ncell / elapsed:.3g} cell-updates/s, "
          f"{n_steps * config.nloop * n_photons / elapsed:.3g} packets/s)")

    r_front = sim.ionization_front_radius()
    r_sp = spitzer_radius(sim.time, r_st)
    r_hi = hosokawa_inutsuka_radius(sim.time, r_st)
    print(f"t = {sim.time / MYR:.3f} Myr")
    print(f"measured ionization front: {r_front / PC:.3f} pc")
    print(f"Spitzer:                   {r_sp / PC:.3f} pc")
    print(f"Hosokawa-Inutsuka:         {r_hi / PC:.3f} pc")
    lo, hi = 0.85 * r_sp, 1.1 * r_hi
    assert lo < r_front < hi, (
        f"front {r_front / PC:.3f} pc outside [{lo / PC:.3f}, {hi / PC:.3f}] pc"
    )
    print("PASS")


if __name__ == "__main__":
    main()
