"""Checkpoint/restart subsystem.

Equivalent of the reference's RestartManager/RestartWriter/RestartReader
(/root/reference/src/RestartManager.hpp:108-250): simulation state is dumped
periodically (wall-clock cadence) so an interrupted run can resume with
bounded loss.  Where the reference serializes every stateful C++ object into
a raw binary stream, this framework's state is already a pytree of arrays
plus a few scalars — checkpoints are compressed npz archives of array leaves
+ a scalar manifest, written atomically.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np


class RestartManager:
    """Writes periodic checkpoints; detects and loads the latest on resume."""

    def __init__(
        self,
        path: str = ".",
        prefix: str = "restart",
        interval_seconds: float = 3600.0,
        max_keep: int = 2,
        max_walltime: float = 0.0,
        resubmit_command: str = "",
    ):
        """``max_walltime`` > 0 requests a graceful stop (checkpoint + exit
        the iteration loop) once that many wall-clock seconds have elapsed;
        ``resubmit_command`` is then executed so queued jobs can chain
        (cf. RestartManager::stop_simulation + the resubmit hook,
        /root/reference/src/RestartManager.hpp:206-250)."""
        self.path = path
        self.prefix = prefix
        self.interval = interval_seconds
        self.max_keep = max_keep
        self.max_walltime = max_walltime
        self.resubmit_command = resubmit_command
        self._start = time.time()
        self._last_write = self._start
        self._counter = 0
        self._resubmitted = False
        os.makedirs(path, exist_ok=True)

    # ------------------------------------------------------------------ write

    def due(self) -> bool:
        """True if the write interval has elapsed (cf. RestartManager's
        hourly default, /root/reference/src/RestartManager.hpp:108-122)."""
        return time.time() - self._last_write >= self.interval

    def want_stop(self) -> bool:
        """True once the max-walltime budget is exhausted."""
        return (
            self.max_walltime > 0.0
            and time.time() - self._start >= self.max_walltime
        )

    def on_stop(self) -> None:
        """Run the resubmit hook (once) after the stop checkpoint is written."""
        if self.resubmit_command and not self._resubmitted:
            import subprocess

            self._resubmitted = True
            subprocess.run(self.resubmit_command, shell=True, check=False)

    def write(self, arrays: Dict[str, Any], scalars: Dict[str, Any]) -> str:
        """Checkpoint arrays + scalars; atomic rename; prune old files."""
        self._counter += 1
        name = os.path.join(self.path, f"{self.prefix}_{self._counter:04d}.npz")
        tmp = name + ".tmp"
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        payload["__scalars__"] = np.frombuffer(
            json.dumps(scalars).encode(), dtype=np.uint8
        )
        with open(tmp, "wb") as handle:
            np.savez_compressed(handle, **payload)
        os.replace(tmp, name)
        self._last_write = time.time()
        self._prune()
        return name

    def _prune(self) -> None:
        existing = sorted(self._list())
        for old in existing[: -self.max_keep]:
            os.remove(old)

    def _list(self):
        return [
            os.path.join(self.path, f)
            for f in os.listdir(self.path)
            if f.startswith(self.prefix + "_") and f.endswith(".npz")
        ]

    # ------------------------------------------------------------------- read

    def latest(self):
        files = sorted(self._list())
        return files[-1] if files else None

    @staticmethod
    def load(filename: str):
        """→ (arrays dict, scalars dict)."""
        with np.load(filename) as data:
            arrays = {k: data[k] for k in data.files if k != "__scalars__"}
            scalars = json.loads(bytes(data["__scalars__"]).decode())
        return arrays, scalars
