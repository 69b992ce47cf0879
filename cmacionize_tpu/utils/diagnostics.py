"""Per-iteration performance diagnostics.

JAX equivalent of the reference's per-iteration ``diagnostics_XX.txt``
dumps (/root/reference/src/TaskBasedIonizationSimulation.cpp:969-1035).  The
reference records queue/buffer/task occupancy because its throughput is set
by scheduler contention; here the analogues are the superstep structure of
the lockstep traversal — packets emitted / absorbed / escaped, packets
exchanged between shards, and wall-clock per phase — which is exactly what
the perf work needs to see per iteration.

Usage::

    diag = IterationDiagnostics(folder=".")
    with diag.phase("trace"):
        ...
    diag.count("photons emitted", n)
    diag.end_iteration()          # writes diagnostics_00.txt, resets
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class IterationDiagnostics:
    """Accumulates counters + phase timings, one dump file per iteration."""

    def __init__(self, folder: Optional[str] = None, enabled: bool = True):
        self.folder = folder
        self.enabled = enabled and folder is not None
        self.iteration = 0
        self._counters: Dict[str, float] = {}
        self._phase_s: Dict[str, float] = {}
        self._iter_start = time.time()
        self.history = []  # per-iteration dict records (kept in memory)

    def count(self, name: str, value) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + float(value)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self._phase_s[name] = self._phase_s.get(name, 0.0) + (
                time.time() - t0)

    def record_superstep(self, exchanged_left, exchanged_right) -> None:
        """Domain-decomposition exchange counters (one call per superstep)."""
        self.count("supersteps", 1)
        self.count("packets exchanged",
                   float(exchanged_left) + float(exchanged_right))

    def end_iteration(self) -> dict:
        """Dump diagnostics_XX.txt (if enabled), reset, advance."""
        elapsed = time.time() - self._iter_start
        record = {
            "iteration": self.iteration,
            "elapsed_s": elapsed,
            "counters": dict(self._counters),
            "phase_s": dict(self._phase_s),
        }
        self.history.append(record)
        if self.enabled:
            path = os.path.join(
                self.folder, f"diagnostics_{self.iteration:02d}.txt")
            with open(path, "w") as f:
                f.write("iteration:\n")
                f.write(f"  number: {self.iteration}\n")
                f.write(f"  elapsed: {elapsed:.6f} s\n")
                f.write("counters:\n")
                for k in sorted(self._counters):
                    v = self._counters[k]
                    f.write(f"  {k}: {v:.0f}\n" if v == int(v)
                            else f"  {k}: {v:g}\n")
                f.write("phases:\n")
                for k in sorted(self._phase_s):
                    f.write(f"  {k}: {self._phase_s[k] * 1e3:.3f} ms\n")
        self._counters = {}
        self._phase_s = {}
        self._iter_start = time.time()
        self.iteration += 1
        return record
