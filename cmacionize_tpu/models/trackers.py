"""Photon trackers and live outputs.

Equivalents of the reference's tracker subsystem
(/root/reference/src/TrackerFactory.hpp:65-72 — Absorption/Spectrum
trackers placed by a TrackerManager from a YAML file — and the
LiveOutputManager's surface-density / PDF reductions,
/root/reference/src/LiveOutputManager.hpp:29-56).

Design: the reference hooks a per-cell pointer into the tally hot
loop (/root/reference/src/DensitySubGrid.hpp:614-617); here the spectral
traversal already produces frequency-binned per-cell tallies, so a
"tracker" is just a gather of tracked-cell columns accumulated across
iterations — zero cost in the hot loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu.models.grid import GridGeometry


class TrackerManager:
    """Accumulates per-cell spectra for tracked positions.

    Feed it the [n_bins * n_cell] spectral tally of each MC iteration
    (the multifreq driver's tally2d); `spectra()` returns the accumulated
    path-length spectrum Σ ℓ·w per frequency bin for each tracked cell —
    multiply by σ(ν)/V_cell·jfac for a mean-intensity spectrum.
    """

    def __init__(
        self,
        geometry: GridGeometry,
        positions: Sequence[Tuple[float, float, float]],
        bin_edges: np.ndarray,
    ):
        self.geometry = geometry
        self.bin_edges = np.asarray(bin_edges)
        self.positions = list(positions)
        shape = geometry.shape
        cells = []
        for position in positions:
            idx = np.clip(
                geometry.position_to_grid_coords(position).astype(int),
                0,
                np.asarray(shape) - 1,
            )
            cells.append((idx[0] * shape[1] + idx[1]) * shape[2] + idx[2])
        self.cell_indices = np.asarray(cells, dtype=np.int64)
        self._accumulated = np.zeros(
            (len(cells), len(self.bin_edges) - 1), dtype=np.float64
        )
        self.n_iterations = 0

    @classmethod
    def from_yaml(cls, geometry, filename, bin_edges):
        """Load tracker positions from a YAML file: a `positions:` list of
        unit-bearing coordinate triples (TrackerManager equivalent)."""
        from cmacionize_tpu.utils.params import yaml_load
        from cmacionize_tpu.utils.units import parse_quantity

        with open(filename) as handle:
            doc = yaml_load(handle.read())
        positions = [
            tuple(parse_quantity(component, "length") for component in entry)
            for entry in doc["positions"]
        ]
        return cls(geometry, positions, bin_edges)

    def accumulate(self, tally2d) -> None:
        n_cell = self.geometry.n_cells
        t2 = np.asarray(tally2d).reshape(-1, n_cell)
        self._accumulated += t2[:, self.cell_indices].T
        self.n_iterations += 1

    def spectra(self) -> np.ndarray:
        """[n_trackers, n_bins] accumulated path-length spectra."""
        return self._accumulated.copy()

    def write(self, filename: str) -> None:
        centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        with open(filename, "w") as handle:
            handle.write("# frequency_Hz\t" + "\t".join(
                f"tracker_{i}" for i in range(len(self.cell_indices))
            ) + "\n")
            for b, nu in enumerate(centers):
                row = "\t".join(f"{self._accumulated[t, b]:.8e}"
                                for t in range(len(self.cell_indices)))
                handle.write(f"{nu:.8e}\t{row}\n")


# ---------------------------------------------------------- typed trackers
#
# The reference hooks a per-cell Tracker pointer into the tally hot loop and
# dispatches virtually per crossing (/root/reference/src/DensitySubGrid.hpp
# :614-617).  Design: packets fly STRAIGHT between emission and
# termination within each generation (primary batch, then one batch per
# re-emission generation), so every tracked-cell crossing is recoverable
# after the trace from the segment (origin → final position) alone — a
# [n_track, P] slab test, vectorized, with zero cost in the traversal
# kernel.  The per-generation batches also give the PHOTONTYPE split
# (primary / diffuse-H / diffuse-He) the reference reads off the packet.

#: PHOTONTYPE slots (cf. /root/reference/src/Photon.hpp PhotonType)
TRACKER_SLOTS = ("primary", "diffuse H", "diffuse He")


def cube_projected_area(dx, dy, dz):
    """Projected area of a UNIT cube seen from direction (dx, dy, dz).

    Closed form |dx|+|dy|+|dz| — identical to the reference's triangulated
    projected-hexagon computation (WeightedSpectrumTracker.hpp:155-289; the
    hexagon decomposes into the three visible faces whose projected areas
    are the direction cosines).  Multiply by L² for a cell of side L.
    """
    return jnp.abs(dx) + jnp.abs(dy) + jnp.abs(dz)


def segment_aabb_overlap(origin, direction, length, lo, hi):
    """Overlap length of P ray segments with n_track axis-aligned boxes.

    origin/direction: [P, 3] (cell units; direction normalized);
    length: [P] segment lengths; lo/hi: [n_track, 3].
    Returns [n_track, P] overlap lengths (cell units).  Slab method.
    """
    o = origin[None, :, :]  # [1, P, 3]
    d = direction[None, :, :]
    lo = lo[:, None, :]  # [nT, 1, 3]
    hi = hi[:, None, :]
    deg = jnp.abs(d) <= 1e-12
    safe = jnp.where(deg, 1e-12, d)
    t0 = (lo - o) / safe
    t1 = (hi - o) / safe
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    inside = (o >= lo) & (o <= hi)
    big = jnp.asarray(1e30, tmin.dtype)
    tmin = jnp.where(deg, jnp.where(inside, -big, big), tmin)
    tmax = jnp.where(deg, jnp.where(inside, big, -big), tmax)
    enter = jnp.max(tmin, axis=-1)  # [nT, P]
    exit_ = jnp.min(tmax, axis=-1)
    a = jnp.clip(enter, 0.0, length[None, :])
    b = jnp.clip(exit_, 0.0, length[None, :])
    return jnp.maximum(b - a, 0.0)


class CellTrackers:
    """Typed per-cell photon trackers: Absorption, Spectrum,
    WeightedSpectrum and Multi, placed from the reference's tracker YAML
    format (TrackerManager.hpp:110-140: ``number of trackers`` +
    ``tracker[i]: position/type/...`` blocks — the file runs unchanged).

    The driver feeds :meth:`contributions` (pure, jit-safe) once per traced
    generation; the three accumulated estimators cover all tracker types:

    - ``counts``  [nT, 3, n_bins] — Σ w per crossing per frequency bin per
      PHOTONTYPE (SpectrumTracker, with optional reference-direction +
      opening-angle filter, SpectrumTracker.hpp:162-187);
    - ``weighted`` [nT, 3, n_bins] — Σ w / A_proj(direction), the
      projected-surface-area weighting (WeightedSpectrumTracker.hpp:293);
      multiply by 1/L² for the physical per-area estimator;
    - ``lengths`` [nT, 3, n_bins] — Σ w·ℓ_in_cell (SI m): per-ion
      absorption volumes follow as σ_table @ lengths
      (AbsorptionTracker.hpp:139-143 — absorption = σ_i·ℓ·w in m³).

    Multiple trackers at one position coexist trivially (the MultiTracker
    machinery dissolves: every entry gets its own accumulator row).
    """

    def __init__(self, geometry: GridGeometry, entries: List[dict],
                 bin_edges: np.ndarray):
        self.geometry = geometry
        self.entries = entries
        self.bin_edges = np.asarray(bin_edges)
        self.n_bins = len(self.bin_edges) - 1
        shape = np.asarray(geometry.shape)
        lo, hi, refdir, cosang = [], [], [], []
        for e in entries:
            idx = np.clip(
                geometry.position_to_grid_coords(e["position"]).astype(int),
                0, shape - 1,
            )
            lo.append(idx.astype(float))
            hi.append(idx.astype(float) + 1.0)
            rd = np.asarray(e.get("reference_direction", (0.0, 0.0, 0.0)),
                            dtype=float)
            norm = np.linalg.norm(rd)
            refdir.append(rd / norm if norm > 0 else rd)
            cosang.append(
                np.cos(e.get("opening_angle", np.pi)) if norm > 0 else -2.0)
        self._lo = jnp.asarray(np.asarray(lo))
        self._hi = jnp.asarray(np.asarray(hi))
        self._refdir = jnp.asarray(np.asarray(refdir))
        self._cosang = jnp.asarray(np.asarray(cosang))
        n_track = len(entries)
        self.n_track = n_track
        zeros = lambda: np.zeros(  # noqa: E731
            (n_track, len(TRACKER_SLOTS), self.n_bins), np.float64)
        self.counts = zeros()
        self.weighted = zeros()
        self.lengths = zeros()
        self.n_iterations = 0

    @classmethod
    def from_reference_yaml(cls, geometry, filename, bin_edges):
        """Parse the reference's tracker file (TrackerManager.hpp:110-140)."""
        from cmacionize_tpu.utils.params import ParameterFile

        blocks = ParameterFile(filename)
        n = blocks.get_int("number of trackers")
        entries = []
        for i in range(n):
            prefix = f"tracker[{i}]"
            ttype = blocks.get_string(f"{prefix}:type", "Spectrum")
            entry = {
                "type": ttype,
                "position": tuple(blocks.get_physical_vector(
                    f"{prefix}:position", "length")),
                "output_name": blocks.get_string(
                    f"{prefix}:output name", f"Tracker{i}.txt"),
            }
            if blocks.has_value(f"{prefix}:reference direction"):
                entry["reference_direction"] = tuple(
                    blocks.get_physical_vector(
                        f"{prefix}:reference direction", None))
                entry["opening_angle"] = blocks.get_physical_value(
                    f"{prefix}:opening angle", "angle", "3.1415926536 radians")
            entries.append(entry)
        return cls(geometry, entries, bin_edges)

    # ------------------------------------------------------------- pure part

    def contributions(self, origin, direction, final, fbin, weight, valid,
                      slot):
        """Per-generation tracker contributions (pure function; call inside
        the driver's jitted batch).

        origin/direction/final: [P, 3] in cell units (final = the frozen
        post-trace position: absorption point or boundary exit);
        fbin: [P] int32; weight: [P]; valid: [P] bool; slot: [P] int32
        PHOTONTYPE index (0 primary / 1 diffuse-H / 2 diffuse-He).
        Returns (counts, weighted, lengths) each [n_track, 3, n_bins];
        ``lengths`` is in SI meters.

        Not supported on periodic boxes (a wrapped segment is not a
        straight line in cell coordinates); the drivers guard.
        """
        dx_m = float(self.geometry.cell_size[0])
        length = jnp.sum((final - origin) * direction, axis=-1)
        ov = segment_aabb_overlap(origin, direction, length,
                                  self._lo, self._hi)  # [nT, P]
        crossed = (ov > 0.0) & valid[None, :]
        # per-tracker reference-direction filter (SpectrumTracker.hpp:162)
        dots = jnp.einsum("td,pd->tp", self._refdir, direction,
                          precision=jax.lax.Precision.HIGHEST)
        crossed = crossed & (dots >= self._cosang[:, None])

        n_slots = len(TRACKER_SLOTS)
        flat = slot * self.n_bins + fbin  # [P]
        inv_area = 1.0 / jnp.maximum(
            cube_projected_area(
                direction[:, 0], direction[:, 1], direction[:, 2]),
            1e-12,
        )

        def per_tracker(mask, ovt):
            # accumulate in the overlap dtype (the widest in play) so the
            # scatter-adds never narrow-cast
            w = jnp.where(mask, weight, 0.0).astype(ovt.dtype)
            base = jnp.zeros((n_slots * self.n_bins,), ovt.dtype)
            return (
                base.at[flat].add(w),
                base.at[flat].add(w * inv_area.astype(ovt.dtype)),
                base.at[flat].add(w * ovt * dx_m),
            )

        counts, weighted, lengths = jax.vmap(per_tracker)(crossed, ov)
        reshape = lambda a: a.reshape(  # noqa: E731
            self.n_track, n_slots, self.n_bins)
        return reshape(counts), reshape(weighted), reshape(lengths)

    # ------------------------------------------------------------- host part

    def accumulate(self, counts, weighted, lengths) -> None:
        self.counts += np.asarray(counts)
        self.weighted += np.asarray(weighted)
        self.lengths += np.asarray(lengths)

    def end_iteration(self) -> None:
        self.n_iterations += 1

    def absorption(self, sigma_table) -> np.ndarray:
        """[n_track, 3, n_ion] per-ion absorption volumes (m³):
        σ_i(ν)·ℓ·w summed over bins (AbsorptionTracker.hpp:139-143)."""
        sig = np.asarray(sigma_table)  # [n_ion, n_bins]
        return np.einsum("ib,tsb->tsi", sig, self.lengths)

    def write_outputs(self, folder: str = ".", sigma_table=None,
                      ion_names: Optional[Sequence[str]] = None) -> List[str]:
        """One output file per tracker in its reference text layout."""
        import os

        centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        written = []
        absorption = (
            self.absorption(sigma_table) if sigma_table is not None else None
        )
        for t, e in enumerate(self.entries):
            path = os.path.join(folder, e["output_name"])
            with open(path, "w") as fh:
                ttype = e["type"]
                if ttype == "Absorption":
                    if absorption is None:
                        raise ValueError(
                            "Absorption tracker output needs sigma_table")
                    fh.write("# Ion\t" + "\t".join(TRACKER_SLOTS) + "\n")
                    names = ion_names or [
                        f"ion{i}" for i in range(absorption.shape[-1])]
                    for i, name in enumerate(names):
                        row = "\t".join(
                            f"{absorption[t, s, i]:.8e}"
                            for s in range(len(TRACKER_SLOTS)))
                        fh.write(f"{name}\t{row}\n")
                else:
                    data = (self.weighted if ttype == "WeightedSpectrum"
                            else self.counts)
                    fh.write("# frequency_Hz\t" + "\t".join(
                        TRACKER_SLOTS) + "\n")
                    for b, nu in enumerate(centers):
                        row = "\t".join(
                            f"{data[t, s, b]:.8e}"
                            for s in range(len(TRACKER_SLOTS)))
                        fh.write(f"{nu:.8e}\t{row}\n")
            written.append(path)
        return written


# ------------------------------------------------------------- live outputs


def surface_density(field, axis: int = 2, cell_size: float = 1.0):
    """Column-integrated surface density map (SurfaceDensityCalculator)."""
    return jnp.sum(jnp.asarray(field), axis=axis) * cell_size


def field_pdf(field, bins: int = 64, log: bool = True):
    """Histogram PDF of a field (Density/VelocityPDFCalculator).

    Returns (bin_edges, counts)."""
    values = np.asarray(field).ravel()
    if log:
        values = np.log10(np.maximum(values, 1e-300))
    counts, edges = np.histogram(values, bins=bins)
    return edges, counts


class LiveOutputManager:
    """In-flight reduced outputs on a time cadence, mirroring
    /root/reference/src/LiveOutputManager.hpp:29-270: numbered
    ``surface_density_XXXX.txt`` / ``ionized_surface_density_XXXX.txt``
    column maps and ``density_PDF_XXXX.txt`` / ``velocity_PDF_XXXX.txt``
    histograms, written whenever the simulation time passes
    ``index · output_interval`` (``do_output``, :203-205).

    The per-subgrid calculators dissolve into whole-array reductions; the
    RHD driver calls :meth:`maybe_output` once per fused block.
    """

    def __init__(self, geometry: GridGeometry, *, output_interval: float,
                 folder: str = ".",
                 surface_density: bool = True,
                 ionized_surface_density: bool = False,
                 density_pdf: bool = False,
                 minimum_density: float = 1.0e-22,
                 maximum_density: float = 1.0e-16,
                 n_density_bins: int = 100,
                 velocity_pdf: bool = False,
                 maximum_velocity: float = 5.0e4,
                 n_velocity_bins: int = 100):
        self.geometry = geometry
        self.output_interval = float(output_interval)
        self.folder = folder
        self.surface_density = surface_density
        self.ionized_surface_density = ionized_surface_density
        self.density_pdf = density_pdf
        self.density_edges = np.logspace(
            np.log10(minimum_density), np.log10(maximum_density),
            n_density_bins + 1)
        self.velocity_pdf = velocity_pdf
        self.velocity_edges = np.linspace(
            0.0, maximum_velocity, n_velocity_bins + 1)
        self.next_output = 0
        self.written: List[str] = []

    @classmethod
    def from_params(cls, params, geometry, folder="."):
        """Reference parameter block (LiveOutputManager.hpp:155-177).
        Returns None when ``LiveOutputManager:enabled`` is false."""
        if not params.get_bool("LiveOutputManager:enabled", False):
            return None
        return cls(
            geometry,
            output_interval=params.get_physical_value(
                "LiveOutputManager:output interval", "time", "1. s"),
            folder=folder,
            surface_density=params.get_bool(
                "LiveOutputManager:output surface density", True),
            ionized_surface_density=params.get_bool(
                "LiveOutputManager:output ionized surface density", False),
            density_pdf=params.get_bool(
                "LiveOutputManager:output density PDF", False),
            minimum_density=params.get_physical_value(
                "LiveOutputManager:minimum density", "density",
                "1.e-25 g cm^-3"),
            maximum_density=params.get_physical_value(
                "LiveOutputManager:maximum density", "density",
                "1.e-19 g cm^-3"),
            n_density_bins=params.get_int(
                "LiveOutputManager:number of density bins", 100),
            velocity_pdf=params.get_bool(
                "LiveOutputManager:output velocity PDF", False),
            maximum_velocity=params.get_physical_value(
                "LiveOutputManager:maximum velocity", "velocity",
                "50. km s^-1"),
            n_velocity_bins=params.get_int(
                "LiveOutputManager:number of velocity bins", 100),
        )

    def do_output(self, time: float) -> bool:
        return self.output_interval * self.next_output <= time

    def maybe_output(self, state, neutral_fraction, time: float,
                     gamma: float) -> None:
        """Write all enabled outputs if the cadence is due."""
        import os

        if not self.do_output(time):
            return
        index = self.next_output
        self.next_output += 1
        dz = float(self.geometry.cell_size[2])
        rho = np.asarray(state.rho)

        def path(stem):
            name = os.path.join(self.folder, f"{stem}_{index:04d}.txt")
            self.written.append(name)
            return name

        if self.surface_density:
            sd = np.asarray(surface_density(rho, axis=2, cell_size=dz))
            np.savetxt(path("surface_density"), sd)
        if self.ionized_surface_density:
            ion = rho * (1.0 - np.asarray(neutral_fraction))
            sd = np.asarray(surface_density(ion, axis=2, cell_size=dz))
            np.savetxt(path("ionized_surface_density"), sd)
        if self.density_pdf:
            counts, _ = np.histogram(rho.ravel(), bins=self.density_edges)
            centers = np.sqrt(
                self.density_edges[1:] * self.density_edges[:-1])
            np.savetxt(path("density_PDF"),
                       np.column_stack([centers, counts]))
        if self.velocity_pdf:
            v = np.sqrt(
                np.asarray(state.mom_x) ** 2
                + np.asarray(state.mom_y) ** 2
                + np.asarray(state.mom_z) ** 2
            ) / np.maximum(rho, 1e-300)
            counts, _ = np.histogram(v.ravel(), bins=self.velocity_edges)
            centers = 0.5 * (
                self.velocity_edges[1:] + self.velocity_edges[:-1])
            np.savetxt(path("velocity_PDF"),
                       np.column_stack([centers, counts]))


@dataclasses.dataclass
class PhotonPacketStatistics:
    """Scatter/re-emission generation histogram
    (/root/reference/src/PhotonPacketStatistics.hpp)."""

    counts: Optional[np.ndarray] = None

    def record_generation(self, generation: int, n_packets: int, max_gen=16):
        if self.counts is None:
            self.counts = np.zeros(max_gen, dtype=np.int64)
        if generation < len(self.counts):
            self.counts[generation] += n_packets
