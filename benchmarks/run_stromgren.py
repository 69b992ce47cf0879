"""Run the stromgren benchmark end-to-end and validate against the analytic
Strömgren solution (cf. /root/reference/benchmarks/stromgren.py:45-66).

Usage:
    PYTHONPATH=. python benchmarks/run_stromgren.py
    CMI_SMALL=1 JAX_PLATFORMS=cpu PYTHONPATH=. python benchmarks/run_stromgren.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cmacionize_tpu.models.ionization_simulation import (  # noqa: E402
    HOnlyConfig,
    HOnlyIonizationSimulation,
)
from cmacionize_tpu.utils.logging import TerminalLog  # noqa: E402
from cmacionize_tpu.utils.params import ParameterFile  # noqa: E402


def ionization_radius(neutral_fraction, geometry):
    """Radius (m) where the radially binned mean neutral fraction crosses
    0.5, for a source at the box origin."""
    centers = geometry.cell_centers()
    r = np.sqrt((centers**2).sum(-1))
    xH = np.asarray(neutral_fraction).reshape(r.shape)
    rbins = np.linspace(0, r.max(), 80)
    idx = np.digitize(r.ravel(), rbins)
    prof = np.array(
        [
            xH.ravel()[idx == i].mean() if (idx == i).any() else np.nan
            for i in range(1, len(rbins))
        ]
    )
    rmid = 0.5 * (rbins[1:] + rbins[:-1])
    good = ~np.isnan(prof)
    return float(np.interp(0.5, prof[good], rmid[good]))


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    params = ParameterFile(os.path.join(here, "stromgren.param"))
    config = HOnlyConfig.from_params(params)
    if os.environ.get("CMI_SMALL"):
        import dataclasses

        config = dataclasses.replace(
            config,
            geometry=dataclasses.replace(config.geometry, shape=(32, 32, 32)),
            n_photons=100000,
            n_iterations=10,
        )
    sim = HOnlyIonizationSimulation(config, log=TerminalLog("info"))

    t0 = time.time()
    sim.run(1)  # compile + first iteration
    t1 = time.time()
    remaining = config.n_iterations - 1
    xH = np.asarray(sim.run(remaining))
    t2 = time.time()
    print(
        f"compile+first iter: {t1 - t0:.2f}s; {remaining} iters: {t2 - t1:.2f}s "
        f"({remaining * config.n_photons / (t2 - t1):.3g} photons/s)"
    )

    cross = ionization_radius(xH, config.geometry)
    Rs = sim.stromgren_radius_analytic()
    print(f"analytic Stromgren radius:       {Rs:.4g} m = {Rs / 3.086e16:.3f} pc")
    print(f"measured 50% ionization radius:  {cross:.4g} m = {cross / 3.086e16:.3f} pc")
    print(f"ratio measured/analytic: {cross / Rs:.4f}")
    assert 0.9 < cross / Rs < 1.1, "Stromgren radius mismatch"
    print("PASS")


if __name__ == "__main__":
    main()
