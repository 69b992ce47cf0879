"""Named memory snapshots + timeline — the MemoryLogger equivalent.

The reference's MemoryLogger records named allocation snapshots during the
run and dumps them to ``memory.txt`` plus a timeline file
(/root/reference/src/MemoryLogger.hpp, written at
TaskBasedIonizationSimulation.cpp:406-410,568-574).  Host-side allocations
here are numpy/python; device-side memory is what actually matters on
an accelerator, so each snapshot records BOTH the process RSS and (when the backend
exposes it) per-device memory stats from jax.
"""

from __future__ import annotations

import time
from typing import List, Tuple


def _rss_bytes() -> int:
    try:
        with open("/proc/self/status") as handle:
            for line in handle:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _peak_rss_bytes() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _device_bytes() -> int:
    """Total bytes in use across jax devices (0 if the backend hides it)."""
    try:
        import jax

        total = 0
        for dev in jax.local_devices():
            stats = dev.memory_stats()
            if stats:
                total += stats.get("bytes_in_use", 0)
        return total
    except Exception:
        return 0


class MemoryLogger:
    """Collects (label, wall time, rss, peak rss, device bytes) snapshots."""

    def __init__(self):
        self._t0 = time.time()
        self._entries: List[Tuple[str, float, int, int, int]] = []

    def snapshot(self, label: str) -> None:
        self._entries.append((
            label,
            time.time() - self._t0,
            _rss_bytes(),
            _peak_rss_bytes(),
            _device_bytes(),
        ))

    def write(self, filename: str = "memory.txt",
              timeline_filename: str = "memory_timeline.txt") -> None:
        """memory.txt: one block per named snapshot; timeline: tab-separated
        rows for plotting (the reference's two-file layout)."""
        with open(filename, "w") as handle:
            for label, t, rss, peak, dev in self._entries:
                handle.write(
                    f"{label}:\n"
                    f"  time: {t:.3f} s\n"
                    f"  rss: {rss / 1e6:.1f} MB\n"
                    f"  peak rss: {peak / 1e6:.1f} MB\n"
                    f"  device memory: {dev / 1e6:.1f} MB\n"
                )
        with open(timeline_filename, "w") as handle:
            handle.write("# time(s)\trss(B)\tpeak_rss(B)\tdevice(B)\tlabel\n")
            for label, t, rss, peak, dev in self._entries:
                handle.write(f"{t:.3f}\t{rss}\t{peak}\t{dev}\t{label}\n")

    @property
    def entries(self):
        return list(self._entries)
