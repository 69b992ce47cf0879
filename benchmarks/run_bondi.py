"""Drive: Bondi accretion benchmark (isothermal hydro + point-mass gravity).

Workload follows /root/reference/benchmarks/bondi.param: 64^3 cells over a
100 au box, 18 Msol point mass, isothermal gas (c_s = 2.031 km/s), Bondi
inflow ghost cells on all faces, central 20 au sphere masked, evolved for
20 yr (~1 flow crossing time).  The whole setup comes from
benchmarks/bondi.param through RHDSimulation.from_params — this script is
only the parameter file + analysis (validation compares the evolved density
to the analytic Bondi solution, cf. /root/reference/benchmarks/bondi.py).

Delta vs the reference (documented): the IC is the analytic profile itself
(DensityFunction:type BondiProfile) rather than a homogeneous state, so the
run tests that the scheme HOLDS the analytic solution.

Usage: PYTHONPATH=. python benchmarks/run_bondi.py [small]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from cmacionize_tpu.models.bondi import BondiProfile  # noqa: E402
from cmacionize_tpu.models.rhd_simulation import RHDSimulation  # noqa: E402
from cmacionize_tpu.ops import hydro  # noqa: E402
from cmacionize_tpu.utils.params import ParameterFile  # noqa: E402

AU = 1.496e11
YR = 365.25 * 24 * 3600.0
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def build_simulation(small=False, log=print):
    params = ParameterFile(os.path.join(BENCH_DIR, "bondi.param"))
    prev = os.getcwd()
    os.chdir(BENCH_DIR)  # HydroMask filename is relative to the param file
    try:
        if small:
            params._tree["DensityGrid"]["number of cells"] = [32, 32, 32]
        sim = RHDSimulation.from_params(params)
    finally:
        os.chdir(prev)
    return sim


def main():
    small = "small" in sys.argv[1:]
    sim = build_simulation(small=small)
    geometry = sim.geometry
    cfg = sim.config
    n_steps = int(round(cfg.total_time / cfg.timestep))
    print(f"dt = {cfg.timestep / YR:.4f} yr, {n_steps} steps, "
          f"isothermal c_s = {sim.isothermal_sound_speed:.4g} m/s")

    t0 = time.time()
    u, _ = sim.run(log_every=1000)
    float(jnp.sum(u.rho))
    elapsed = time.time() - t0
    print(f"{n_steps} steps in {elapsed:.1f}s "
          f"({n_steps * geometry.n_cells / elapsed:.3g} cell-updates/s)")

    profile = BondiProfile(
        central_mass=18.0 * 1.98855e30,
        bondi_density=1e-16,  # 1e-19 g cm^-3
        sound_speed=sim.isothermal_sound_speed,
    )
    centers = geometry.cell_centers()
    rho0, _, _, _ = profile.evaluate(centers)
    r = np.sqrt((centers**2).sum(-1))

    w = hydro.primitives_from_conserved(u, cfg.gamma)
    rho = np.asarray(w.rho)
    sel = (r > 15 * AU) & (r < 45 * AU)
    rel = np.abs(rho[sel] / rho0[sel] - 1)
    print("density deviation from analytic Bondi profile after 20 yr:")
    print(f"  median {np.median(rel) * 100:.2f}%  "
          f"p95 {np.percentile(rel, 95) * 100:.2f}%")
    assert np.median(rel) < 0.05, "Bondi profile not held"
    rr = np.maximum(r, 1.0)
    vr = (
        np.asarray(w.vx) * centers[..., 0]
        + np.asarray(w.vy) * centers[..., 1]
        + np.asarray(w.vz) * centers[..., 2]
    ) / rr
    assert np.median(vr[sel]) < 0.0
    print("PASS")


if __name__ == "__main__":
    main()
