"""Measure the sharded multifreq exchange volume.

Question: does the x-slab decomposition of the multi-frequency driver move
enough packet data over the interconnect that a 3D tiling (smaller surface
per device, 3 exchanges per superstep) would pay?

Method: run the 8-device sharded MultiFreqIonizationSimulation on the
lexington-class 64^3 workload (virtual CPU devices — exchange VOLUME is a
property of the algorithm, not the backend) and read the new
``packets_exchanged`` / ``supersteps`` counters.  A spectral packet record
on the wire is 11 f32 fields + bool = 45 B.

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=. python tools/probe_multifreq_exchange_r5.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.multifreq_simulation import (
        MultiFreqConfig,
        MultiFreqIonizationSimulation,
    )
    from cmacionize_tpu.parallel.mesh import make_mesh

    pc = 3.086e16
    n_photons = 1 << 18
    geometry = GridGeometry((-5 * pc,) * 3, (10 * pc,) * 3, (64, 64, 64))
    config = MultiFreqConfig(
        geometry=geometry,
        number_density=1e8,
        initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        spectrum_type="planck",
        spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15,
        n_photons=n_photons,
        n_iterations=4,
        abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                    "Ne": 5e-5, "S": 9e-6},
        do_temperature=False,
        diffuse_field=False,
        n_bins=64,
    )
    mesh = make_mesh(8, axis_names=("x",))
    sim = MultiFreqIonizationSimulation(config, seed=3, mesh=mesh)
    bytes_per_packet = 45  # 11 f32 fields + bool mask
    n_cells = 64 ** 3
    tally_bytes = config.n_bins * n_cells * 4
    for it in range(4):
        sim.run(1)
        d = sim._last_trace_diag
        sent = int(d["packets_exchanged"])
        steps = int(d["supersteps"])
        wire = sent * bytes_per_packet
        print(
            f"iter {it}: exchanged {sent} packets "
            f"({sent / n_photons:.2f} crossings/photon) over {steps} "
            f"supersteps = {wire / 1e6:.2f} MB on the wire "
            f"(vs {tally_bytes / 1e6:.0f} MB for one replicated-tally "
            f"psum, the P2 alternative)"
        )


if __name__ == "__main__":
    main()
