"""Gadget-layout HDF5 snapshots.

Equivalent of the reference's GadgetDensityGridWriter
(/root/reference/src/GadgetDensityGridWriter.cpp:122-380) and
GadgetSnapshotDensityFunction reader: snapshots follow the SWIFT/Gadget HDF5
layout (/Header with BoxSize/Time/NumPart, /PartType0 datasets named as in
/root/reference/src/DensityGridWriterFields.hpp:139-165) so the reference's
own analysis scripts (e.g. benchmarks/stromgren.py) run unchanged on our
output.

Coordinates are cell centers relative to the box anchor, SI units throughout
(the reference writes SI with unit metadata in /Units).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cmacionize_tpu.models.grid import GridGeometry


def require_h5py() -> None:
    """Fail early, naming h5py, when it cannot be imported: Gadget
    snapshots are HDF5 files."""
    import importlib.util

    if importlib.util.find_spec("h5py") is None:
        raise SystemExit(
            "h5py is not installed; it is required to read and write "
            "Gadget HDF5 snapshots")


def write_gadget_snapshot(
    filename: str,
    geometry: GridGeometry,
    fields: Dict[str, np.ndarray],
    time: float = 0.0,
    coordinates: np.ndarray = None,
    params=None,
) -> None:
    """Write cell-centered fields to a Gadget-layout HDF5 snapshot.

    fields: dataset name → [nx, ny, nz] array (or [nx,ny,nz,3] for vectors).
    Typical names: NumberDensity, Temperature, NeutralFractionH,
    NeutralFractionHe, Density, Velocities, Pressure.

    coordinates: optional explicit [C, 3] SI cell positions relative to the
    box anchor (unstructured grids — Voronoi cells, AMR leaves; the
    reference's Gadget writer records whatever cell midpoints the grid
    iterator yields, GadgetDensityGridWriter.cpp:122-380).  Fields are then
    flat [C] / [C, 3] arrays.

    params: optional utils.params.ParameterFile — its used values are
    recorded as string attributes in a /Parameters group, alongside /Code
    (framework + jax versions) and /RuntimePars (creation time), mirroring
    the provenance groups the reference embeds in every snapshot
    (GadgetDensityGridWriter.cpp:147-186).
    """
    import h5py

    if coordinates is None:
        n_cells = geometry.n_cells
        coordinates = (
            geometry.cell_centers() - np.asarray(geometry.anchor)
        ).reshape(-1, 3)
    else:
        coordinates = np.asarray(coordinates).reshape(-1, 3)
        n_cells = len(coordinates)

    with h5py.File(filename, "w") as handle:
        header = handle.create_group("Header")
        header.attrs["BoxSize"] = np.asarray(geometry.sides, np.float64)
        numpart = np.zeros(6, np.uint32)
        numpart[0] = n_cells
        header.attrs["NumPart_ThisFile"] = numpart
        header.attrs["NumPart_Total"] = numpart
        header.attrs["NumPart_Total_HighWord"] = np.zeros(6, np.uint32)
        header.attrs["Time"] = float(time)
        header.attrs["NumFilesPerSnapshot"] = 1
        header.attrs["Redshift"] = 0.0
        header.attrs["Flag_Entropy_ICs"] = 0
        header.attrs["MassTable"] = np.zeros(6, np.float64)
        header.attrs["Dimension"] = 3

        units = handle.create_group("Units")
        for name in (
            "Unit current in cgs (U_I)",
            "Unit length in cgs (U_L)",
            "Unit mass in cgs (U_M)",
            "Unit temperature in cgs (U_T)",
            "Unit time in cgs (U_t)",
        ):
            # SI values expressed in cgs, matching the reference's /Units
            units.attrs[name] = {
                "Unit current in cgs (U_I)": 1.0,
                "Unit length in cgs (U_L)": 100.0,
                "Unit mass in cgs (U_M)": 1000.0,
                "Unit temperature in cgs (U_T)": 1.0,
                "Unit time in cgs (U_t)": 1.0,
            }[name]

        # provenance groups (cf. GadgetDensityGridWriter.cpp:147-186)
        import datetime
        import sys as _sys

        import jax as _jax

        import cmacionize_tpu as _pkg

        code = handle.create_group("Code")
        code.attrs["Code"] = "cmacionize_tpu"
        code.attrs["Code version"] = _pkg.__version__
        code.attrs["jax version"] = _jax.__version__
        code.attrs["Python version"] = _sys.version.split()[0]
        runtime = handle.create_group("RuntimePars")
        runtime.attrs["Creation time"] = (
            datetime.datetime.now().isoformat(timespec="seconds"))
        if params is not None:
            pgroup = handle.create_group("Parameters")
            for key, value in sorted(params.used_values().items()):
                pgroup.attrs[key] = str(value)

        parts = handle.create_group("PartType0")
        parts.create_dataset("Coordinates", data=coordinates)
        for name, values in fields.items():
            values = np.asarray(values)
            if values.ndim == 4:
                data = values.reshape(-1, values.shape[-1])
            else:
                data = values.reshape(-1)
            parts.create_dataset(name, data=data)


def read_gadget_snapshot(filename: str):
    """Read a Gadget-layout snapshot → (box_size, coordinates, fields dict).

    The reader equivalent of GadgetSnapshotDensityFunction: fields are
    returned flat ([n_part] or [n_part, 3]); use
    :func:`grid_from_snapshot` to deposit onto a Cartesian grid.
    """
    import h5py

    with h5py.File(filename, "r") as handle:
        box = np.asarray(handle["Header"].attrs["BoxSize"])
        if box.size == 1:
            box = np.repeat(box, 3)
        parts = handle["PartType0"]
        coordinates = np.asarray(parts["Coordinates"])
        fields = {
            name: np.asarray(parts[name])
            for name in parts.keys()
            if name != "Coordinates"
        }
    return box, coordinates, fields


def grid_from_snapshot(
    filename: str,
    geometry: GridGeometry,
    field: str = "NumberDensity",
    fallback: Optional[str] = "Density",
):
    """Deposit a snapshot field onto a Cartesian grid (nearest-cell binning,
    cf. the M-over-V mapping of SPHArrayInterface)."""
    box, coordinates, fields = read_gadget_snapshot(filename)
    if field not in fields and fallback in fields:
        field = fallback
    values = fields[field]
    shape = geometry.shape
    idx = (
        (coordinates - 0.0)
        / (np.asarray(geometry.sides) / np.asarray(shape))
    ).astype(int)
    idx = np.clip(idx, 0, np.asarray(shape) - 1)
    grid = np.zeros(shape)
    counts = np.zeros(shape)
    np.add.at(grid, tuple(idx.T), values)
    np.add.at(counts, tuple(idx.T), 1.0)
    return np.where(counts > 0, grid / np.maximum(counts, 1), 0.0)


def write_ascii_snapshot(filename, geometry, fields, time: float = 0.0):
    """Plain-text snapshot dump (AsciiFileDensityGridWriter equivalent,
    /root/reference/src/AsciiFileDensityGridWriter.cpp): one row per cell
    with coordinates followed by the field values."""
    names = sorted(fields)
    coordinates = (
        geometry.cell_centers() - np.asarray(geometry.anchor)
    ).reshape(-1, 3)
    columns = [np.asarray(fields[name]).reshape(len(coordinates), -1)
               for name in names]
    with open(filename, "w") as handle:
        handle.write(f"# time = {time}\n")
        handle.write("# x y z " + " ".join(names) + "\n")
        data = np.hstack([coordinates] + columns)
        np.savetxt(handle, data, fmt="%.8e")
