"""Resume the flagship starbench production run from its snapshot series.

A CLI run (`python -m cmacionize_tpu --rhd -p starbench.param`) that
stopped early leaves a numbered snapshot series.  A Gadget snapshot is a
COMPLETE state record for the starbench physics — two-temperature H-only
RHD needs exactly (rho, v, P, xH) — so the run is resumable from the last
snapshot even without a binary restart dump (the reference reconstructs
grid state from snapshots the same way via CMacIonizeSnapshotDensityFunction,
/root/reference/src/CMacIonizeSnapshotDensityFunction.cpp).

Usage:
    PYTHONPATH=. python benchmarks/resume_starbench.py \
        [output_dir=/tmp/starbench_cli]

Continues the numbered snapshot series through the same production loop
(CFL + TimeLine + snapshot cadence) to `total time`, then prints the full
R(t) trajectory check (analyze_starbench_snapshots).
"""

import glob
import os
import re
import sys
import time as time_mod

import h5py
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cmacionize_tpu import constants  # noqa: E402
from cmacionize_tpu.io.gadget import (  # noqa: E402
    read_gadget_snapshot,
    write_gadget_snapshot,
)
from cmacionize_tpu.models.rhd_simulation import RHDSimulation  # noqa: E402
from cmacionize_tpu.ops import hydro  # noqa: E402
from cmacionize_tpu.utils.logging import TerminalLog  # noqa: E402
from cmacionize_tpu.utils.params import ParameterFile  # noqa: E402

import jax.numpy as jnp  # noqa: E402


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/starbench_cli"
    log = TerminalLog()
    params = ParameterFile(os.path.join(REPO, "benchmarks/starbench.param"))
    prev = os.getcwd()
    os.chdir(os.path.join(REPO, "benchmarks"))  # BlockSyntax filename
    try:
        sim = RHDSimulation.from_params(params, log=log)
    finally:
        os.chdir(prev)

    snaps = sorted(glob.glob(os.path.join(out, "starbench_[0-9]*.hdf5")))
    if not snaps:
        raise SystemExit(f"no snapshots in {out}")
    last = snaps[-1]
    index = int(re.search(r"_(\d+)\.hdf5$", last).group(1))
    with h5py.File(last, "r") as handle:
        t0 = float(np.asarray(handle["Header"].attrs["Time"]).ravel()[0])
    _, _, fields = read_gadget_snapshot(last)
    shape = sim.geometry.shape
    rho = fields["Density"].reshape(shape)
    vel = fields["Velocities"].reshape(*shape, 3)
    w = hydro.Primitives(
        rho=jnp.asarray(rho, jnp.float32),
        vx=jnp.asarray(vel[..., 0], jnp.float32),
        vy=jnp.asarray(vel[..., 1], jnp.float32),
        vz=jnp.asarray(vel[..., 2], jnp.float32),
        p=jnp.asarray(fields["Pressure"].reshape(shape), jnp.float32),
    )
    sim.state = hydro.conserved_from_primitives(w, sim.config.gamma)
    sim.neutral_fraction = jnp.asarray(
        fields["NeutralFractionH"].reshape(shape), jnp.float32)
    sim.time = t0
    sim._lastsnap = index + 1
    total = sim.config.total_time
    print(f"resuming from {os.path.basename(last)}: t = {t0:.6g} s "
          f"({t0 / total:.1%} of total), next snapshot index {index + 1}")

    def grid_fields(sim_):
        w_ = hydro.primitives_from_conserved(sim_.state, sim_.config.gamma)
        return {
            "NumberDensity": np.asarray(w_.rho) / constants.PROTON_MASS,
            "Density": np.asarray(w_.rho),
            "Velocities": np.stack(
                [np.asarray(w_.vx), np.asarray(w_.vy), np.asarray(w_.vz)],
                axis=-1),
            "Pressure": np.asarray(w_.p),
            "NeutralFractionH": np.asarray(sim_.neutral_fraction),
        }

    def write_numbered(sim_, i):
        name = os.path.join(out, f"starbench_{i:03d}.hdf5")
        write_gadget_snapshot(name, sim.geometry, grid_fields(sim_), sim_.time)
        log.status(f"wrote snapshot {name} (t = {sim_.time:.6g} s)")

    t_wall = time_mod.time()
    sim.run(snapshot_callback=write_numbered, log_every=50)
    print(f"resumed segment wall clock: {time_mod.time() - t_wall:.0f} s; "
          f"final t = {sim.time:.6g} of {total:.6g} s")

    # full-trajectory acceptance (Spitzer / Hosokawa-Inutsuka band)
    import subprocess

    subprocess.run(
        [sys.executable,
         os.path.join(REPO, "benchmarks/analyze_starbench_snapshots.py"), out],
        check=False)


if __name__ == "__main__":
    main()
