"""Drive: Lexington HII-region benchmark (multi-element + temperature balance).

Validates the classic HII-region structure: ~10^4 K ionized interior, sharp
ionization front, neutral exterior at the 500 K floor, He ionization zone
smaller than the H one.

Usage: PYTHONPATH=. python benchmarks/run_lexington.py [small]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from cmacionize_tpu.models.multifreq_simulation import (  # noqa: E402
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)
from cmacionize_tpu.utils.logging import TerminalLog  # noqa: E402
from cmacionize_tpu.utils.params import ParameterFile  # noqa: E402


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    params = ParameterFile(os.path.join(here, "lexingtonHII40.param"))
    config = MultiFreqConfig.from_params(params)
    if "small" in sys.argv[1:]:
        import dataclasses

        config = dataclasses.replace(
            config,
            geometry=dataclasses.replace(config.geometry, shape=(32, 32, 32)),
            n_photons=200000,
            n_iterations=10,
        )
    sim = MultiFreqIonizationSimulation(config, log=TerminalLog("info"))
    t0 = time.time()
    xion, T = sim.run()
    elapsed = time.time() - t0
    total_packets = config.n_photons * config.n_iterations
    print(f"{config.n_iterations} iterations in {elapsed:.1f}s "
          f"({total_packets / elapsed:.3g} source packets/s incl. compile)")

    T = np.asarray(T)
    xH = np.asarray(xion["H_n"])
    xHe = np.asarray(xion["He_n"])
    geom = config.geometry
    centers = geom.cell_centers()
    r = np.sqrt((centers**2).sum(-1))
    c = tuple(s // 2 for s in geom.shape)
    print(f"center: T = {T[c]:.0f} K, xH = {xH[c]:.2e}, xHe = {xHe[c]:.2e}")
    pc = 3.086e16
    r_ion_H = (3 * (xH < 0.5).sum() * geom.cell_volume / (4 * np.pi)) ** (1 / 3)
    r_ion_He = (3 * (xHe < 0.5).sum() * geom.cell_volume / (4 * np.pi)) ** (1 / 3)
    print(f"H ionization front radius:  {r_ion_H / pc:.2f} pc")
    print(f"He ionization front radius: {r_ion_He / pc:.2f} pc")
    far = r > 1.2 * r_ion_H
    print(f"mean T inside: {T[r < 0.8 * r_ion_H].mean():.0f} K; "
          f"median xH outside: {np.median(xH[far]):.3f}")

    assert 6000.0 < T[c] < 15000.0, "interior temperature not HII-like"
    assert xH[c] < 1e-2
    assert r_ion_He <= r_ion_H * 1.05
    # exterior must be NEUTRAL; its temperature is not asserted — in
    # radiation-starved cells both this code and the reference keep the last
    # secant iterate (physically meaningless where j ≈ 0)
    assert np.median(xH[far]) > 0.9, "exterior should be neutral"
    # self-consistency: the front radius must match the Stromgren radius for
    # alpha_B evaluated at the actual interior temperature
    from cmacionize_tpu.ops import recombination

    T_in = float(T[r < 0.8 * r_ion_H].mean())
    alpha = float(recombination.recombination_rate("H_n", T_in))
    n_h = config.number_density
    r_stromgren = (
        3 * config.luminosity / (4 * np.pi * n_h**2 * alpha)
    ) ** (1 / 3)
    print(f"Stromgren radius at alpha({T_in:.0f} K): {r_stromgren / pc:.2f} pc")
    assert 0.85 < r_ion_H / r_stromgren < 1.15, (
        r_ion_H / pc,
        r_stromgren / pc,
    )
    print("PASS")


if __name__ == "__main__":
    main()
