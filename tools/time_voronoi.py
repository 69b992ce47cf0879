"""Voronoi-construction micro-benchmark: host tessellations/s by mesh size.

Counterpart of the reference's timing/timeVoronoiGrids.cpp +
timeNewVoronoiGrid.cpp (TimingTools.hpp repetition statistics): times
build_voronoi_grid — Qhull + wall mirroring + face/volume extraction —
at several generator counts, plus one Lloyd-relaxed build.

    python tools/time_voronoi.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cmacionize_tpu.models import voronoi  # noqa: E402
from cmacionize_tpu.models.grid import GridGeometry  # noqa: E402

PC = 3.086e16
REPS = 3


def main():
    geometry = GridGeometry(
        anchor=(-1.256 * PC,) * 3, sides=(2.512 * PC,) * 3, shape=(32,) * 3)
    rng = np.random.default_rng(42)
    for n in (1000, 3000, 10000, 30000):
        pts = rng.random((n, 3))
        best = np.inf
        for _ in range(REPS):
            t0 = time.time()
            grid = voronoi.build_voronoi_grid(geometry, pts)
            best = min(best, time.time() - t0)
        print(f"{n:6d} generators: {best:7.2f} s/build "
              f"({n / best:.0f} cells/s, k_max {grid.max_faces})")
    t0 = time.time()
    voronoi.build_voronoi_grid(geometry, rng.random((10000, 3)), num_lloyd=10)
    print(f" 10000 generators + 10 Lloyd: {time.time() - t0:7.2f} s")


if __name__ == "__main__":
    main()
