"""Snapshot readers: FLASH (AMR), Amun (distributed uniform), Ascii.

Equivalents of the reference's DensityFunction snapshot-reader family
(/root/reference/src/DensityFunctionFactory.hpp:138-174):

- FLASH (FLASHSnapshotDensityFunction.cpp): a FLASH AMR HDF5 plot file is
  flattened onto the finest uniform resolution — the array data model is a
  dense [nx,ny,nz] array, so the octree blocks are exactly upsampled
  (constant within each coarse cell) instead of kept as a tree.
- Amun (AmunSnapshotDensityFunction.cpp): per-process files assembled into
  one uniform grid; density/velocity/temperature renormalized to a target
  mean number density and sound speed exactly as the reference does.
- Ascii (AsciiFileDensityFunction.cpp): plain-text x y z n [T] rows
  deposited onto a uniform grid.

All readers return plain numpy (host IO is not a jit concern); the driver
moves fields to device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: hydrogen mass used by the reference to convert mass → number density
#: (FLASHSnapshotDensityFunction.cpp:273)
HYDROGEN_MASS = 1.6737236e-27
BOLTZMANN = 1.380649e-23
PROTON_MASS = 1.67262192369e-27


@dataclasses.dataclass
class UniformSnapshot:
    """A snapshot resampled onto a uniform grid."""

    anchor: np.ndarray  # [3] m
    sides: np.ndarray  # [3] m
    number_density: np.ndarray  # [nx,ny,nz] m^-3
    temperature: Optional[np.ndarray] = None  # [nx,ny,nz] K
    velocity: Optional[np.ndarray] = None  # [nx,ny,nz,3] m/s

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.number_density.shape


def _flash_runtime_parameters(handle, name, dtype):
    """FLASH 'runtime parameters' datasets are (name, value) compound rows."""
    raw = np.asarray(handle[name])
    out = {}
    for row in raw:
        key = row[0]
        if isinstance(key, bytes):
            key = key.decode()
        out[key.strip()] = dtype(row[1])
    return out


def read_flash_snapshot(filename: str, unit_length: float = 1e-2,
                        unit_density: float = 1e3,
                        fallback_temperature: Optional[float] = None
                        ) -> UniformSnapshot:
    """Read a FLASH AMR plot file onto the finest uniform resolution.

    Mirrors FLASHSnapshotDensityFunction.cpp:55-230: box extents from the
    real runtime parameters (in cm → m), root block counts from the integer
    runtime parameters, per-block refine level / node type, 'dens'
    (g cm^-3 → number density via m_H) and 'temp' (K). Leaf blocks
    (node type 1) are exactly upsampled to the finest level.
    """
    import h5py

    with h5py.File(filename, "r") as f:
        real_pars = _flash_runtime_parameters(f, "real runtime parameters",
                                              float)
        int_pars = _flash_runtime_parameters(f, "integer runtime parameters",
                                             int)
        anchor = np.array([real_pars["xmin"], real_pars["ymin"],
                           real_pars["zmin"]]) * unit_length
        top = np.array([real_pars["xmax"], real_pars["ymax"],
                        real_pars["zmax"]]) * unit_length
        nblock = np.array([int_pars["nblockx"], int_pars["nblocky"],
                           int_pars["nblockz"]])

        bounding_box = np.asarray(f["bounding box"])  # [nb, 3, 2] (cm)
        dens = np.asarray(f["dens"])  # [nb, nzb, nyb, nxb]
        temp = np.asarray(f["temp"]) if "temp" in f else None
        refine_level = np.asarray(f["refine level"])  # 1-based
        node_type = np.asarray(f["node type"])  # leaf == 1

    nzb, nyb, nxb = dens.shape[1:]
    if nxb != nyb or nxb != nzb:
        raise ValueError("only cubic FLASH blocks are supported")
    block_cells = nxb

    leaf = node_type == 1
    max_level = int(refine_level[leaf].max())
    # finest uniform resolution: root blocks × block cells × 2^(maxlevel-1)
    res = nblock * block_cells * 2 ** (max_level - 1)
    nd = np.zeros(tuple(res))
    T = np.zeros(tuple(res)) if temp is not None else None

    sides = top - anchor
    for ib in np.flatnonzero(leaf):
        level = int(refine_level[ib])
        upsample = 2 ** (max_level - level)
        # block anchor in grid-index space of the finest resolution
        bb = bounding_box[ib] * unit_length  # [3, 2]
        start = np.rint((bb[:, 0] - anchor) / sides * res).astype(int)
        block_nd = dens[ib].transpose(2, 1, 0) * unit_density / HYDROGEN_MASS
        block_up = np.repeat(np.repeat(np.repeat(
            block_nd, upsample, 0), upsample, 1), upsample, 2)
        sl = tuple(slice(start[d], start[d] + block_cells * upsample)
                   for d in range(3))
        nd[sl] = block_up
        if T is not None:
            block_t = temp[ib].transpose(2, 1, 0)
            T[sl] = np.repeat(np.repeat(np.repeat(
                block_t, upsample, 0), upsample, 1), upsample, 2)
    if T is None and fallback_temperature is not None:
        T = np.full(tuple(res), fallback_temperature)
    return UniformSnapshot(anchor=anchor, sides=sides, number_density=nd,
                           temperature=T)


def read_amun_snapshot(folder: str, prefix: str, padding: int,
                       number_of_files: int, box_anchor, box_sides,
                       average_number_density: float = 1e8,
                       sound_speed: float = 0.1,
                       average_temperature: float = 100.0,
                       shift=(0.0, 0.0, 0.0)) -> UniformSnapshot:
    """Assemble a distributed Amun snapshot
    (AmunSnapshotDensityFunction.cpp:92-230).

    Each of the `number_of_files` HDF5 files holds a [dims] brick of
    dens/velx/vely/velz/pres in /variables; /attributes has the per-file
    `dims` and the process grid `pdims`. Units are code units: the density
    is rescaled so its mean is `average_number_density`, velocities scale
    by (physical sound speed at `average_temperature`) / `sound_speed`,
    and temperature = pres/dens in code units × T_avg.
    """
    import h5py

    first = f"{folder}/{prefix}{0:0{padding}d}.h5"
    with h5py.File(first, "r") as f:
        attrs = f["/attributes"]
        dims = np.asarray(attrs.attrs["dims"]).astype(int).ravel()
        pdims = np.asarray(attrs.attrs["pdims"]).astype(int).ravel()

    n_cells = dims * pdims
    nd = np.zeros(tuple(n_cells))
    vel = np.zeros(tuple(n_cells) + (3,))
    tfield = np.zeros(tuple(n_cells))

    for ifile in range(number_of_files):
        # file → process-grid offsets (AmunSnapshotDensityFunction.cpp:151-159)
        off_z = ifile // (pdims[0] * pdims[1])
        off_x = (ifile - off_z * pdims[0] * pdims[1]) // pdims[1]
        off_y = ifile - off_z * pdims[0] * pdims[1] - off_x * pdims[1]
        start = np.array([off_x, off_y, off_z]) * dims
        name = f"{folder}/{prefix}{ifile:0{padding}d}.h5"
        with h5py.File(name, "r") as f:
            var = f["/variables"]
            # datasets are [z, y, x]; transpose to [x, y, z]
            dens = np.asarray(var["dens"]).transpose(2, 1, 0)
            velx = np.asarray(var["velx"]).transpose(2, 1, 0)
            vely = np.asarray(var["vely"]).transpose(2, 1, 0)
            velz = np.asarray(var["velz"]).transpose(2, 1, 0)
            pres = np.asarray(var["pres"]).transpose(2, 1, 0)
        sl = tuple(slice(start[d], start[d] + dims[d]) for d in range(3))
        nd[sl] = dens
        vel[sl + (0,)] = velx
        vel[sl + (1,)] = vely
        vel[sl + (2,)] = velz
        tfield[sl] = pres / dens

    average_density = nd.mean()
    physical_cs = np.sqrt(BOLTZMANN * average_temperature / PROTON_MASS)
    velocity_unit = physical_cs / sound_speed
    density_unit = average_number_density / average_density
    # pres/dens is T in code units where the code sound speed corresponds to
    # the desired average temperature:
    # temperature_conversion_factor = T_avg / cs_code^2
    # (AmunSnapshotDensityFunction.cpp:220-221)
    temperature_unit = average_temperature / (sound_speed * sound_speed)

    # optional periodic shift (in box fractions)
    shift = np.asarray(shift, dtype=float)
    if np.any(shift != 0.0):
        cells = np.rint(shift * n_cells).astype(int)
        nd = np.roll(nd, cells, axis=(0, 1, 2))
        vel = np.roll(vel, cells, axis=(0, 1, 2))
        tfield = np.roll(tfield, cells, axis=(0, 1, 2))

    return UniformSnapshot(
        anchor=np.asarray(box_anchor, dtype=float),
        sides=np.asarray(box_sides, dtype=float),
        number_density=nd * density_unit,
        temperature=tfield * temperature_unit,
        velocity=vel * velocity_unit,
    )


def read_ascii_snapshot(filename: str, shape, box_anchor, box_sides
                        ) -> UniformSnapshot:
    """Plain-text snapshot: x y z n [T] rows ('#' comments) deposited on a
    uniform grid (AsciiFileDensityFunction equivalent). Cells not covered
    by any row keep the mean density."""
    data = np.atleast_2d(np.loadtxt(filename))
    anchor = np.asarray(box_anchor, dtype=float)
    sides = np.asarray(box_sides, dtype=float)
    shape = tuple(int(s) for s in shape)

    idx = ((data[:, :3] - anchor) / sides * np.asarray(shape)).astype(int)
    idx = np.clip(idx, 0, np.asarray(shape) - 1)
    nd = np.full(shape, np.mean(data[:, 3]))
    nd[idx[:, 0], idx[:, 1], idx[:, 2]] = data[:, 3]
    T = None
    if data.shape[1] > 4:
        T = np.full(shape, np.mean(data[:, 4]))
        T[idx[:, 0], idx[:, 1], idx[:, 2]] = data[:, 4]
    return UniformSnapshot(anchor=anchor, sides=sides, number_density=nd,
                           temperature=T)


# ---------------------------------------------------------------------------
# SPH snapshot readers: Phantom & SPHNG Fortran-unformatted dumps
# (/root/reference/src/PhantomSnapshotDensityFunction.cpp,
#  SPHNGSnapshotDensityFunction.cpp; binary layout documented by the
#  reference's own fixture generators test/write_Phantomtest.py,
#  test/write_SPHNGtest.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SPHParticles:
    """SPH particle arrays in SI units, ready for the gridding API."""

    positions: np.ndarray  # [n, 3] m
    masses: np.ndarray  # [n] kg
    smoothing_lengths: np.ndarray  # [n] m
    extra: dict  # any other tagged arrays, raw code units


class _FortranRecords:
    """Sequential reader of Fortran unformatted records (4-byte markers)."""

    def __init__(self, filename: str):
        with open(filename, "rb") as handle:
            self.data = handle.read()
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def next(self) -> bytes:
        n = int(np.frombuffer(self.data, "<i4", 1, self.pos)[0])
        start = self.pos + 4
        end = start + n
        tail = int(np.frombuffer(self.data, "<i4", 1, end)[0])
        if tail != n:
            raise ValueError(f"corrupt Fortran record at offset {self.pos}")
        self.pos = end + 4
        return self.data[start:end]


#: dtypes of the 8 Phantom/SPHNG header & data-array slots, in file order
_SLOT_DTYPES = ("<i4", "<i1", "<i2", "<i4", "<i8", "<f8", "<f4", "<f8")


def _read_tagged_header_block(rec: _FortranRecords, dtype: str,
                              tagged: bool) -> dict:
    count = int(np.frombuffer(rec.next(), "<i4")[0])
    if count == 0:
        return {}
    if tagged:
        raw = rec.next()
        tags = [raw[16 * i:16 * (i + 1)].decode().strip()
                for i in range(count)]
    else:
        tags = [f"value_{i}" for i in range(count)]
    values = np.frombuffer(rec.next(), dtype, count)
    out = {}
    for tag, value in zip(tags, values):
        out.setdefault(tag, []).append(value)
    return out


def read_phantom_snapshot(filename: str) -> SPHParticles:
    """Read gas particles from a Phantom dump.

    Layout per the reference's fixture generator (write_Phantomtest.py) and
    PhantomSnapshotDensityFunction.cpp:520-620: magic records, 8 tagged
    header blocks (ints/int8s/.../real8s), then per-block particle arrays
    as (16-char tag, data) record pairs. Positions are f8, smoothing
    lengths f4, all in code units: SI via udist (cm) / umass (g) from the
    real8s header block. The particle mass is massoftype[0].
    """
    rec = _FortranRecords(filename)
    rec.next()  # magic 1
    tag_marker = rec.next()  # 'FT' (tagged) or 'FX'
    tagged = tag_marker[:2] == b"FT"
    if not tagged:
        raise ValueError("untagged Phantom dumps are not supported")

    header: dict = {}
    for dtype in _SLOT_DTYPES:
        block = _read_tagged_header_block(rec, dtype, tagged)
        for tag, values in block.items():
            # keep the first occurrence: the double-precision 'reals' value
            # of e.g. massoftype wins over its real4 copy (the reference
            # reads the typed block it expects; cf. write_Phantomtest.py)
            header.setdefault(tag, values)

    npart = int(header["npartoftype"][0])
    mass_code = float(header["massoftype"][0])
    udist = float(header["udist"][0]) * 1e-2  # cm → m
    umass = float(header["umass"][0]) * 1e-3  # g → kg

    n_data_blocks = int(np.frombuffer(rec.next(), "<i4")[0])
    block_counts = []
    for _ in range(n_data_blocks):
        desc = rec.next()
        n = int(np.frombuffer(desc, "<i8", 1)[0])
        counts = np.frombuffer(desc, "<i4", 8, 8)
        block_counts.append((n, counts))

    arrays: dict = {}
    for n, counts in block_counts:
        if n == 0:
            continue
        for slot, count in enumerate(counts):
            for _ in range(int(count)):
                if rec.eof():
                    break
                tag = rec.next().decode().strip()
                data = np.frombuffer(rec.next(), _SLOT_DTYPES[slot], n)
                arrays[tag] = data
        break  # gas particles live in the first block

    pos = np.stack([arrays["x"], arrays["y"], arrays["z"]],
                   axis=1).astype(np.float64) * udist
    h = arrays["h"].astype(np.float64) * udist
    masses = np.full(npart, mass_code * umass)
    extra = {k: v for k, v in arrays.items() if k not in ("x", "y", "z", "h")}
    return SPHParticles(pos, masses, h, extra)


#: SPHNG particle array tags we extract, with per-particle byte width
_SPHNG_TAGS = {
    "x": "<f8", "y": "<f8", "z": "<f8", "m": "<f8", "h": "<f8",
    "vx": "<f8", "vy": "<f8", "vz": "<f8", "u": "<f8", "rho": "<f8",
    "iphase": "<i1", "iunique": "<i4",
}


def read_sphng_snapshot(filename: str) -> SPHParticles:
    """Read gas particles from a tagged SPHNG dump.

    Layout per write_SPHNGtest.py / SPHNGSnapshotDensityFunction.cpp: a
    44-int tagged header (nparttot, nblocks), real header, units block
    (udist, umass, utime, umagfd in cgs), then tag/data record pairs for
    the particle arrays. Sink particles (iphase < 0) are dropped, matching
    the reference (SPHNG_data.txt holds 99 of the 100 fixture particles).
    Untagged ('FX') dumps are not supported.
    """
    rec = _FortranRecords(filename)
    rec.next()
    tag_marker = rec.next()
    if tag_marker[:2] != b"FT":
        raise ValueError("untagged SPHNG dumps are not supported")

    ints = _read_tagged_header_block(rec, "<i4", True)
    npart = int(ints["nparttot"][0])

    # scan the remaining records: a 16-byte record whose text is a known
    # tag announces the next record as that array (reference semantics:
    # unknown tags/records are skipped)
    arrays: dict = {}
    units = None
    pending_tag = None
    while not rec.eof() and len(arrays) < len(_SPHNG_TAGS):
        try:
            raw = rec.next()
        except (ValueError, IndexError):
            break
        if pending_tag is not None:
            dtype = _SPHNG_TAGS[pending_tag]
            width = np.dtype(dtype).itemsize
            if len(raw) == npart * width:
                arrays[pending_tag] = np.frombuffer(raw, dtype, npart)
            pending_tag = None
            continue
        if len(raw) == 16:
            tag = raw.decode(errors="replace").strip()
            if tag in _SPHNG_TAGS and tag not in arrays:
                pending_tag = tag
        elif len(raw) == 32 and units is None:
            # units block: 4 doubles (udist, umass, utime, umagfd)
            units = np.frombuffer(raw, "<f8", 4)

    if units is None:
        units = np.ones(4)
    udist = float(units[0]) * 1e-2
    umass = float(units[1]) * 1e-3

    # gas particles have iphase == 0 (SPHNGSnapshotDensityFunction.cpp:384)
    gas = (arrays["iphase"] == 0 if "iphase" in arrays
           else np.ones(npart, bool))
    pos = np.stack([arrays["x"], arrays["y"], arrays["z"]],
                   axis=1)[gas] * udist
    masses = arrays["m"][gas] * umass
    h = arrays["h"][gas] * udist
    extra = {k: np.asarray(v)[gas] for k, v in arrays.items()
             if k not in ("x", "y", "z", "m", "h")}
    return SPHParticles(pos, masses, h, extra)
