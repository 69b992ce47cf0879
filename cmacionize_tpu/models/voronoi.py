"""Voronoi grid family.

Replaces the reference's two incremental-construction Voronoi grids
(/root/reference/src/OldVoronoiCell.cpp ~2000 LoC cell clipping,
NewVoronoiCellConstructor.cpp ~1800 LoC Delaunay flips, VoronoiDensityGrid.cpp)
with a split that fits the hardware:

* **Construction is host-side** (scipy Delaunay/Voronoi on the CPU — the
  same place the reference builds its grid), bounded by mirroring the
  generators across the six box walls (a standard trick: the bisector with a
  wall-mirrored copy IS the wall plane, so every original cell is clipped to
  the box).  Periodic axes replicate generators by ±L translation instead
  and record the position jump across each face.
* **Transport is on-device**: the cell graph is flattened into padded dense
  arrays (``neighbors [C,K]``, face-plane normals/offsets ``[C,K]``,
  crossing shifts ``[C,K,3]``) and packets march cell-to-cell in the same
  lockstep ``while_loop`` shape as the Cartesian kernel
  (cmacionize_tpu/ops/traversal.py): one K-wide row gather per step, a
  min/argmin over face-plane distances instead of the three-axis DDA.

Geometry is normalized to box units (longest side = 1) so f32 positions
keep ~1e-7 relative precision regardless of the SI scale of the problem.

Lloyd regularization iterations (reference: VoronoiDensityGrid.cpp:205-227)
rebuild the grid with generators moved to cell centroids.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu.models.grid import GridGeometry

__all__ = [
    "VoronoiGrid",
    "build_voronoi_grid",
    "uniform_random_generators",
    "uniform_regular_generators",
    "perturbed_cartesian_generators",
    "generators_from_params",
    "trace_packets_voronoi",
    "VoronoiPacketBatch",
    "HOnlyVoronoiSimulation",
]

#: f32 contractions run at full f32 precision (never TF32 on GPUs)
_HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Generator distributions
# (/root/reference/src/VoronoiGeneratorDistributionFactory.hpp:107-123)
# ---------------------------------------------------------------------------


def uniform_random_generators(n: int, rng: np.random.Generator) -> np.ndarray:
    """UniformRandomVoronoiGeneratorDistribution: n uniform points, box units."""
    return rng.random((n, 3))


def uniform_regular_generators(shape: Tuple[int, int, int]) -> np.ndarray:
    """UniformRegularVoronoiGeneratorDistribution: cell-centered lattice."""
    axes = [(np.arange(s) + 0.5) / s for s in shape]
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack(g, axis=-1).reshape(-1, 3)


def perturbed_cartesian_generators(
    shape: Tuple[int, int, int], amplitude: float, rng: np.random.Generator
) -> np.ndarray:
    """PerturbedCartesianVoronoiGeneratorDistribution: jittered lattice.

    ``amplitude`` is the perturbation as a fraction of the lattice spacing.
    """
    pts = uniform_regular_generators(shape)
    spacing = 1.0 / np.asarray(shape)
    pts = pts + (rng.random(pts.shape) - 0.5) * (2.0 * amplitude * spacing)
    return np.clip(pts, 1e-6, 1.0 - 1e-6)


def generators_from_params(params, rng: np.random.Generator) -> np.ndarray:
    """Dispatch over the reference's generator-distribution type strings."""
    prefix = "DensityGrid:VoronoiGeneratorDistribution"
    gtype = params.get_string(f"{prefix}:type", "UniformRandom")
    if gtype == "UniformRandom":
        n = params.get_int(f"{prefix}:number of positions", 1000)
        return uniform_random_generators(n, rng)
    if gtype == "UniformRegular":
        shape = tuple(params.get_int_vector(
            f"{prefix}:number of cells", [8, 8, 8]))
        return uniform_regular_generators(shape)
    if gtype == "PerturbedCartesian":
        shape = tuple(params.get_int_vector(
            f"{prefix}:number of cells", [8, 8, 8]))
        amplitude = params.get_number(
            f"{prefix}:perturbation amplitude", 0.25)
        return perturbed_cartesian_generators(shape, amplitude, rng)
    raise ValueError(
        f"unknown VoronoiGeneratorDistribution type '{gtype}' "
        "(SPH/SPHNG/CMacIonize generators: pass positions directly to "
        "build_voronoi_grid)")


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------


def _hull_volume_centroid(verts: np.ndarray, interior: np.ndarray):
    """Volume + centroid of a convex polytope via tetra fan from ``interior``."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    tri = verts[hull.simplices]  # [m, 3, 3]
    a = tri[:, 0] - interior
    b = tri[:, 1] - interior
    c = tri[:, 2] - interior
    v = np.abs(np.einsum("ij,ij->i", a, _cross3(b, c))) / 6.0
    vol_total = float(v.sum())
    cen_total = ((tri.sum(axis=1) + interior) / 4.0 * v[:, None]).sum(axis=0)
    return vol_total, cen_total / max(vol_total, 1e-300)


@dataclasses.dataclass(frozen=True)
class VoronoiGrid:
    """A bounded Voronoi tessellation flattened for on-device transport.

    All geometry in box units (longest box side = 1); ``scale`` converts
    back to meters.  Face planes are perpendicular bisectors: a packet in
    cell ``i`` exits through face ``k`` at the smallest positive
    ``t = (offset[i,k] - n·p) / (n·d)``.
    """

    geometry: GridGeometry
    scale: float  # meters per box unit
    generators: np.ndarray  # [C, 3] box units
    volumes: np.ndarray  # [C] m^3
    centroids: np.ndarray  # [C, 3] box units
    neighbors: np.ndarray  # [C, K] int32: >=0 cell, -1 wall, -2 padding
    normals: np.ndarray  # [C, K, 3] f32 unit outward face normals
    offsets: np.ndarray  # [C, K] f32 plane offsets n·m
    shifts: np.ndarray  # [C, K, 3] f32 position jump on crossing (periodic)
    areas: np.ndarray = None  # [C, K] f32 face areas (box units²)
    #: [C, K, 3] f32 face polygon centroids (box units) — the second-order
    #: hydro evaluates face states here (None on grids from older builds)
    face_centroids: np.ndarray = None

    @property
    def n_cells(self) -> int:
        return len(self.generators)

    @property
    def max_faces(self) -> int:
        return self.neighbors.shape[1]

    def locate(self, positions: np.ndarray) -> np.ndarray:
        """Containing cell = nearest generator (the Voronoi property)."""
        from scipy.spatial import cKDTree

        tree = cKDTree(self.generators)
        return tree.query(np.atleast_2d(positions))[1].astype(np.int32)


def build_voronoi_grid(
    geometry: GridGeometry,
    generators: np.ndarray,
    *,
    num_lloyd: int = 0,
) -> VoronoiGrid:
    """Construct a bounded Voronoi grid from generators in box units.

    Mirrors the role of OldVoronoiGrid/NewVoronoiGrid::compute_grid
    (/root/reference/src/OldVoronoiGrid.cpp, NewVoronoiGrid.cpp) with
    scipy's Qhull plus wall mirroring; Lloyd iterations as in
    VoronoiDensityGrid.cpp:205-227.
    """
    sides = np.asarray(geometry.sides, np.float64)
    scale = float(sides.max())
    box = sides / scale  # box extents in box units
    pts = np.asarray(generators, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError("generators must be [N, 3]")
    # incoming generators are in [0,1]^3 of the box; rescale anisotropically
    pts = pts * box

    # large meshes: only image points near the walls (8x mean spacing is a
    # generous bound on the near-wall cell diameter for quasi-uniform
    # distributions); the unbounded-cell assertion falls back to full
    # imaging for pathological cases
    margin = None
    if len(pts) > 4000:
        margin = min(0.45, 8.0 * len(pts) ** (-1.0 / 3.0))

    def _build(p):
        try:
            return _tessellate(geometry, p, box, scale, margin=margin)
        except AssertionError:
            return _tessellate(geometry, p, box, scale, margin=None)

    for _ in range(num_lloyd + 1):
        grid_data = _build(pts)
        if num_lloyd == 0:
            break
        pts = grid_data.centroids.copy()
        num_lloyd -= 1
    return grid_data


def rebuild_voronoi_grid(geometry: GridGeometry, generators) -> VoronoiGrid:
    """Re-tessellate from STORED box-unit generator positions (the restart
    path — generator positions are the complete record of a Voronoi grid;
    the reference restarts VoronoiDensityGrid the same way, via its
    generator distribution state).  Deterministic: Qhull on identical
    inputs reproduces the identical cell tables."""
    sides = np.asarray(geometry.sides, np.float64)
    scale = float(sides.max())
    box = sides / scale
    pts = np.asarray(generators, np.float64)
    margin = None
    if len(pts) > 4000:
        margin = min(0.45, 8.0 * len(pts) ** (-1.0 / 3.0))
    try:
        return _tessellate(geometry, pts, box, scale, margin=margin)
    except AssertionError:
        return _tessellate(geometry, pts, box, scale, margin=None)


def _cross3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """np.cross without its moveaxis overhead (hot in grid construction)."""
    return np.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], axis=-1)


def _polygon_area(verts: np.ndarray) -> float:
    """Area of a planar convex polygon given its (unordered) 3D vertices."""
    if len(verts) < 3:
        return 0.0
    return float(_polygon_areas_batch(verts[None])[0])


def _polygon_areas_batch(polys: np.ndarray) -> np.ndarray:
    """Areas of [M, L, 3] planar convex polygons (unordered vertices).

    Vectorized across M: order each polygon's vertices by angle in its own
    plane basis, then the shoelace sum — identical math to the scalar
    version it replaces, batched because the per-face area pass dominates
    host-side tessellation time at 10^4+ generators.
    """
    if polys.shape[1] < 3:
        return np.zeros(len(polys))
    c = polys.mean(axis=1, keepdims=True)
    rel = polys - c  # [M, L, 3]
    normal = _cross3(rel[:, 1] - rel[:, 0], rel[:, 2] - rel[:, 0])
    nn = np.linalg.norm(normal, axis=1, keepdims=True)
    ok = nn[:, 0] >= 1e-300
    normal = normal / np.maximum(nn, 1e-300)
    e1 = rel[:, 0] / np.maximum(
        np.linalg.norm(rel[:, 0], axis=1, keepdims=True), 1e-300)
    e2 = _cross3(normal, e1)
    ang = np.arctan2(
        np.einsum("mlc,mc->ml", rel, e2),
        np.einsum("mlc,mc->ml", rel, e1))
    order = np.argsort(ang, axis=1)
    rel = np.take_along_axis(rel, order[:, :, None], axis=1)
    cross = _cross3(rel, np.roll(rel, -1, axis=1))
    area = 0.5 * np.abs(np.einsum("mlc,mc->m", cross, normal))
    return np.where(ok, area, 0.0)


def _tessellate(geometry, pts, box, scale, margin=None) -> VoronoiGrid:
    """Bounded tessellation via wall-mirror / periodic-translate images.

    ``margin`` (box units, optional): only image points within ``margin`` of
    the walls involved in each offset combination — an O(27x) → O(1+ε)
    reduction of the Qhull input for large meshes.  Must exceed the largest
    cell diameter near any wall; the unbounded-region assertion below fails
    loudly if it was too small (callers fall back to full imaging).
    """
    from scipy.spatial import Voronoi

    n = len(pts)
    periodic = geometry.periodic
    ext = [pts]
    # All 26 offset combinations so edge/corner adjacency is exact for
    # periodic axes; pure-mirror combos only ever produce degenerate
    # never-hit faces (inside the box every point is strictly closer to the
    # original than to any multi-mirrored image).
    # Per imaged point (beyond the n originals) three parallel arrays record
    # its original index, wall flag and periodic shift.
    ext_orig = []  # [M] original index of each imaged point
    ext_wall = []  # [M] bool
    ext_shift = []  # [M, 3]
    import itertools

    # Degeneracy proof for images involving >= 1 mirrored axis (pure mirror
    # OR mirror mixed with periodic translations): let q' be such an image of
    # q and q'' the image with the same periodic translations but no mirrors
    # (q'' = q itself for pure mirrors).  For a wall at coordinate 0 on a
    # mirrored axis and any x strictly inside the box,
    #   |x - q'|^2 - |x - q''|^2 = 4 * x_axis * q_axis >= 0   (per axis),
    # with equality only on the wall plane — so q' never beats q'' in the
    # open box and any Qhull face against q' has zero area inside the domain
    # (it can only exist *in* the wall plane, where escape is the correct
    # outcome anyway).  Labeling every mirrored-axis image a wall face is
    # therefore exact up to f.p. round-off, including mixed
    # periodic+reflective boxes.
    for combo in itertools.product((-1, 0, 1), repeat=3):
        if combo == (0, 0, 0):
            continue
        sel = np.ones(n, bool)
        if margin is not None:
            for axis, sign in enumerate(combo):
                if sign == 0:
                    continue
                if sign > 0:
                    sel &= pts[:, axis] > box[axis] - margin
                else:
                    sel &= pts[:, axis] < margin
        img = pts[sel].copy()
        if len(img) == 0:
            continue
        is_wall = False
        shift = np.zeros(3)
        for axis, sign in enumerate(combo):
            if sign == 0:
                continue
            if periodic[axis]:
                img[:, axis] += sign * box[axis]
                shift[axis] = -sign * box[axis]
            else:
                wall = box[axis] if sign > 0 else 0.0
                img[:, axis] = 2.0 * wall - img[:, axis]
                is_wall = True
        ext.append(img)
        ext_orig.append(np.flatnonzero(sel).astype(np.int64))
        ext_wall.append(np.full(len(img), is_wall))
        ext_shift.append(np.tile(shift, (len(img), 1)))
    allpts = np.concatenate(ext, axis=0)
    ext_orig = (np.concatenate(ext_orig) if ext_orig
                else np.zeros(0, np.int64))
    ext_wall = (np.concatenate(ext_wall) if ext_wall
                else np.zeros(0, bool))
    ext_shift = (np.concatenate(ext_shift, axis=0) if len(ext_shift)
                 else np.zeros((0, 3)))
    vor = Voronoi(allpts)

    # per cell: (nbr, normal, offset, shift, A, face centroid).  The ridge
    # pass is vectorized (it dominates host construction time at 10^4+
    # generators): per-ridge geometry in batched numpy, then a light
    # append loop over the sides that belong to original cells.
    rp = np.asarray(vor.ridge_points)
    # ridges touching at least one original cell (image-image ridges — the
    # overwhelming majority under full 27x imaging — are skipped entirely)
    rel = np.flatnonzero(
        ((rp[:, 0] < n) | (rp[:, 1] < n))
        & (np.linalg.norm(allpts[rp[:, 1]] - allpts[rp[:, 0]], axis=1)
           >= 1e-14))
    mids_r = 0.5 * (allpts[rp[rel, 0]] + allpts[rp[rel, 1]])
    d_r = allpts[rp[rel, 1]] - allpts[rp[rel, 0]]
    normals0_r = d_r / np.linalg.norm(d_r, axis=1)[:, None]
    offsets0_r = np.einsum("ij,ij->i", normals0_r, mids_r)
    # face polygon area + true centroid, computed once per ridge (shared by
    # both sides).  On irregular meshes the bisector midpoint can sit far
    # off (or outside) the face, which biases second-order flux evaluation
    # points — hence the true polygon centroid.
    areas_r = np.zeros(len(rel))
    fcs_r = mids_r.copy()
    ridge_vertices = vor.ridge_vertices
    # group the relevant ridges by polygon vertex count and batch each
    # group through the vectorized area kernel (unbounded far-image ridges
    # — any with a -1 vertex — keep area 0: never a real face)
    by_len = {}
    for j, ri in enumerate(rel):
        rv = ridge_vertices[ri]
        if -1 in rv or len(rv) < 3:
            continue
        by_len.setdefault(len(rv), []).append((j, rv))
    for length, items in by_len.items():
        idx = np.fromiter((j for j, _ in items), np.int64, len(items))
        polys = vor.vertices[np.array([rv for _, rv in items])]
        areas_r[idx] = _polygon_areas_batch(polys)
        fcs_r[idx] = polys.mean(axis=1)

    faces = [[] for _ in range(n)]
    zero3 = np.zeros(3)
    for j, ri in enumerate(rel):
        p, q = rp[ri]
        for side in (0, 1):
            a, b = (p, q) if side == 0 else (q, p)
            if a >= n:
                continue
            if b < n:
                nbr, shift = int(b), zero3
            else:
                is_wall = bool(ext_wall[b - n])
                shift = ext_shift[b - n]
                nbr = -1 if is_wall else int(ext_orig[b - n])
            normal = normals0_r[j] if side == 0 else -normals0_r[j]
            offset = offsets0_r[j] if side == 0 else -offsets0_r[j]
            faces[a].append((
                nbr, normal, offset, shift, areas_r[j], fcs_r[j]))

    k_max = max(len(f) for f in faces)
    neighbors = np.full((n, k_max), -2, np.int32)
    normals = np.zeros((n, k_max, 3), np.float32)
    offsets = np.zeros((n, k_max), np.float32)
    shifts = np.zeros((n, k_max, 3), np.float32)
    areas = np.zeros((n, k_max), np.float32)
    face_centroids = np.zeros((n, k_max, 3), np.float32)
    for i, f in enumerate(faces):
        for k, (nbr, normal, offset, shift, area, fc) in enumerate(f):
            neighbors[i, k] = nbr
            normals[i, k] = normal
            offsets[i, k] = offset
            shifts[i, k] = shift
            areas[i, k] = area
            face_centroids[i, k] = fc

    volumes = np.empty(n)
    centroids = np.empty((n, 3))
    for i in range(n):
        region = vor.regions[vor.point_region[i]]
        assert -1 not in region, (
            f"unbounded Voronoi cell {i} — wall mirroring failed")
        verts = vor.vertices[region]
        volumes[i], centroids[i] = _hull_volume_centroid(verts, pts[i])
    volumes *= scale ** 3

    return VoronoiGrid(
        geometry=geometry, scale=scale, generators=pts,
        volumes=volumes, centroids=centroids,
        neighbors=neighbors, normals=normals, offsets=offsets, shifts=shifts,
        areas=areas, face_centroids=face_centroids,
    )


# ---------------------------------------------------------------------------
# On-device transport
# ---------------------------------------------------------------------------


class VoronoiPacketBatch(NamedTuple):
    """SoA photon batch on a Voronoi grid (positions in box units)."""

    pos: jnp.ndarray  # [P, 3]
    dirn: jnp.ndarray  # [P, 3]
    cell: jnp.ndarray  # [P] int32
    tau_left: jnp.ndarray  # [P]
    weight: jnp.ndarray  # [P]
    active: jnp.ndarray  # [P] bool
    absorbed: jnp.ndarray  # [P] bool


def make_voronoi_packets(grid: VoronoiGrid, position, direction, tau, weight):
    cell = jnp.asarray(grid.locate(np.asarray(position)))
    active = jnp.ones(len(cell), bool)
    return VoronoiPacketBatch(
        jnp.asarray(position, jnp.float32), jnp.asarray(direction, jnp.float32),
        cell, jnp.asarray(tau, jnp.float32), jnp.asarray(weight, jnp.float32),
        active, jnp.zeros(len(cell), bool),
    )


@functools.partial(
    jax.jit, static_argnames=("max_steps", "live_threshold"))
def _trace_voronoi_jit(
    neighbors, normals, offsets, shifts, chi, packets, tally, eps, max_steps,
    live_threshold=0,
):
    P = packets.pos.shape[0]
    tiny = jnp.asarray(1e-30, chi.dtype)

    def cond(carry):
        step, _, pk = carry
        return jnp.logical_and(
            step < max_steps,
            jnp.sum(pk.active, dtype=jnp.int32) > live_threshold)

    def body(carry):
        step, tly, pk = carry
        rows_nbr = neighbors[pk.cell]  # [P, K]
        rows_n = normals[pk.cell]  # [P, K, 3]
        rows_off = offsets[pk.cell]  # [P, K]
        rows_shift = shifts[pk.cell]  # [P, K, 3]

        ndotd = jnp.einsum("pkc,pc->pk", rows_n, pk.dirn, precision=_HIGHEST)
        ndotp = jnp.einsum("pkc,pc->pk", rows_n, pk.pos, precision=_HIGHEST)
        t = jnp.where(
            (ndotd > 1e-12) & (rows_nbr != -2),
            jnp.maximum(rows_off - ndotp, 0.0) / jnp.maximum(ndotd, 1e-12),
            jnp.inf,
        )
        k_exit = jnp.argmin(t, axis=1)
        t_exit = jnp.take_along_axis(t, k_exit[:, None], axis=1)[:, 0]

        chi_c = jnp.maximum(chi[pk.cell], tiny)
        tau_cell = chi_c * t_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = jnp.where(absorbed_now, pk.tau_left / chi_c, t_exit)

        deposit = jnp.where(pk.active, l_travel * pk.weight, 0.0)
        tly = tly.at[pk.cell].add(deposit, mode="drop")

        nbr = jnp.take_along_axis(rows_nbr, k_exit[:, None], axis=1)[:, 0]
        shift = jnp.take_along_axis(
            rows_shift, k_exit[:, None, None].repeat(3, 2), axis=1)[:, 0]
        crossing = pk.active & ~absorbed_now
        # nudge past the face so the next plane test is strictly inside
        pos = pk.pos + pk.dirn[:, :] * jnp.where(
            crossing, l_travel + eps, l_travel)[:, None]
        pos = jnp.where(crossing[:, None], pos + shift, pos)
        escaped = crossing & (nbr == -1)
        cell = jnp.where(crossing & (nbr >= 0), nbr, pk.cell)

        tau_left = jnp.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & ~escaped
        absorbed = pk.absorbed | absorbed_now

        upd = pk.active
        pos = jnp.where(upd[:, None], pos, pk.pos)
        cell = jnp.where(upd, cell, pk.cell)
        tau_left = jnp.where(upd, tau_left, pk.tau_left)
        pk = VoronoiPacketBatch(
            pos, pk.dirn, cell, tau_left, pk.weight, active, absorbed)
        return step + 1, tly, pk

    _, tally, packets = jax.lax.while_loop(
        cond, body, (jnp.int32(0), tally, packets))
    return tally, packets


def trace_packets_voronoi(
    grid: VoronoiGrid,
    chi_si: jnp.ndarray,  # [C] opacity per meter
    packets: VoronoiPacketBatch,
    *,
    max_steps: int = 0,
):
    """March packets cell-to-cell; return ([C] tallies Σ ℓ·w in meters,
    terminated batch).

    Same estimator and termination semantics as
    cmacionize_tpu.ops.traversal.trace_packets; the DDA wall test is
    replaced by the face-plane min-distance test over the padded neighbor
    rows (cf. OldVoronoiCell's face walk,
    /root/reference/src/OldVoronoiCell.cpp).
    """
    C = grid.n_cells
    if max_steps == 0:
        max_steps = 16 * int(np.ceil(C ** (1.0 / 3.0))) + 64
    chi_u = jnp.asarray(chi_si, jnp.float32) * grid.scale
    tally = jnp.zeros(C, jnp.float32)
    eps = jnp.float32(1e-5 / max(C ** (1.0 / 3.0), 1.0))
    tally, packets = _trace_voronoi_jit(
        jnp.asarray(grid.neighbors), jnp.asarray(grid.normals),
        jnp.asarray(grid.offsets), jnp.asarray(grid.shifts),
        chi_u, packets, tally, eps, max_steps,
    )
    return tally * grid.scale, packets


def _compact_live_voronoi(pk: VoronoiPacketBatch, width: int):
    """Sort live packets to the front and keep the first ``width`` rows.

    The Voronoi counterpart of ops.traversal._compact_live: one packed
    uint32 sort + row gathers, fully on-device.  Caller must guarantee the
    live count is <= width (use _trace_voronoi_jit's live_threshold).
    Absorbed flags are reset so each cascade stage counts only its own
    absorptions.
    """
    n = pk.pos.shape[0]
    iota = jax.lax.iota(jnp.uint32, n)
    dead = (~pk.active).astype(jnp.uint32)
    sorted_keys = jax.lax.sort((dead << 31) | iota)
    perm = (sorted_keys & jnp.uint32(0x7FFFFFFF))[:width].astype(jnp.int32)
    matf = jnp.concatenate(
        [pk.pos, pk.dirn, pk.tau_left[:, None], pk.weight[:, None]], axis=1)
    subf = matf[perm]
    return VoronoiPacketBatch(
        pos=subf[:, 0:3], dirn=subf[:, 3:6],
        cell=pk.cell[perm],
        tau_left=subf[:, 6], weight=subf[:, 7],
        active=pk.active[perm],
        absorbed=jnp.zeros(width, bool),
    )


def trace_packets_voronoi_cascade(
    grid: VoronoiGrid,
    chi_si: jnp.ndarray,
    packets: VoronoiPacketBatch,
    *,
    max_steps: int = 0,
    shrink: int = 3,
    n_stages: int = 4,
):
    """Width-compacting cascade march over the cell graph.

    The lockstep face-walk pays the full [P, K] neighbor-row gather every
    iteration even as packets terminate; on a decaying survival curve
    (every benchmark's) most iterations run nearly empty.  As in the
    Cartesian ops.traversal.trace_packets_blocked_cascade, the march runs
    as geometrically shrinking stages — march until the live count drops
    to the next stage's width (device-side predicate, no host sync),
    compact survivors to the front with a packed sort, slice statically,
    continue.  Estimator-identical deposits.

    Returns (tally_m [C], n_absorbed, n_escaped); per-packet final state
    is NOT preserved (use trace_packets_voronoi when re-emission needs
    the terminated batch).
    """
    C = grid.n_cells
    n = packets.pos.shape[0]
    if max_steps == 0:
        max_steps = 16 * int(np.ceil(C ** (1.0 / 3.0))) + 64
    chi_u = jnp.asarray(chi_si, jnp.float32) * grid.scale
    tally = jnp.zeros(C, jnp.float32)
    eps = jnp.float32(1e-5 / max(C ** (1.0 / 3.0), 1.0))
    tables = (
        jnp.asarray(grid.neighbors), jnp.asarray(grid.normals),
        jnp.asarray(grid.offsets), jnp.asarray(grid.shifts),
    )
    widths = [n]
    for _ in range(n_stages - 1):
        w = widths[-1] // shrink
        if w < 4096:
            break
        widths.append(w)
    n_absorbed = jnp.zeros((), jnp.int32)
    pk = packets
    for si, width in enumerate(widths):
        next_width = widths[si + 1] if si + 1 < len(widths) else 0
        tally, pk = _trace_voronoi_jit(
            *tables, chi_u, pk, tally, eps, max_steps,
            live_threshold=next_width,
        )
        n_absorbed = n_absorbed + jnp.sum(pk.absorbed, dtype=jnp.int32)
        if next_width:
            pk = _compact_live_voronoi(pk, next_width)
    return tally * grid.scale, n_absorbed, n - n_absorbed


class SpectralVoronoiPacketBatch(NamedTuple):
    """Voronoi packet batch with per-packet H/He cross sections + bin."""

    pos: jnp.ndarray  # [P, 3]
    dirn: jnp.ndarray
    cell: jnp.ndarray
    tau_left: jnp.ndarray
    weight: jnp.ndarray
    sig_h: jnp.ndarray
    sig_he: jnp.ndarray
    fbin: jnp.ndarray
    active: jnp.ndarray
    absorbed: jnp.ndarray

    @property
    def size(self):
        return self.pos.shape[0]


@functools.partial(jax.jit, static_argnames=("max_steps", "n_bins", "n_cells"))
def _trace_voronoi_spectral_jit(
    neighbors, normals, offsets, shifts, chi_h, chi_he, packets, tally2d,
    eps, max_steps, n_bins, n_cells,
):
    """Spectral cell-graph march: χ = χ_H·σ_H(ν) + χ_He·σ_He(ν) per packet,
    deposits into a [n_bins * C] frequency-binned tally."""
    tiny = jnp.asarray(1e-30, chi_h.dtype)

    def cond(carry):
        step, _, pk = carry
        return jnp.logical_and(step < max_steps, jnp.any(pk.active))

    def body(carry):
        step, tly, pk = carry
        rows_nbr = neighbors[pk.cell]
        rows_n = normals[pk.cell]
        rows_off = offsets[pk.cell]
        rows_shift = shifts[pk.cell]

        ndotd = jnp.einsum("pkc,pc->pk", rows_n, pk.dirn, precision=_HIGHEST)
        ndotp = jnp.einsum("pkc,pc->pk", rows_n, pk.pos, precision=_HIGHEST)
        t = jnp.where(
            (ndotd > 1e-12) & (rows_nbr != -2),
            jnp.maximum(rows_off - ndotp, 0.0) / jnp.maximum(ndotd, 1e-12),
            jnp.inf,
        )
        k_exit = jnp.argmin(t, axis=1)
        t_exit = jnp.take_along_axis(t, k_exit[:, None], axis=1)[:, 0]

        chi_c = jnp.maximum(
            chi_h[pk.cell] * pk.sig_h + chi_he[pk.cell] * pk.sig_he, tiny
        )
        tau_cell = chi_c * t_exit
        absorbed_now = pk.active & (tau_cell >= pk.tau_left)
        l_travel = jnp.where(absorbed_now, pk.tau_left / chi_c, t_exit)

        deposit = jnp.where(pk.active, l_travel * pk.weight, 0.0)
        tly = tly.at[pk.fbin * n_cells + pk.cell].add(deposit, mode="drop")

        nbr = jnp.take_along_axis(rows_nbr, k_exit[:, None], axis=1)[:, 0]
        shift = jnp.take_along_axis(
            rows_shift, k_exit[:, None, None].repeat(3, 2), axis=1)[:, 0]
        crossing = pk.active & ~absorbed_now
        pos = pk.pos + pk.dirn[:, :] * jnp.where(
            crossing, l_travel + eps, l_travel)[:, None]
        pos = jnp.where(crossing[:, None], pos + shift, pos)
        escaped = crossing & (nbr == -1)
        cell = jnp.where(crossing & (nbr >= 0), nbr, pk.cell)

        tau_left = jnp.where(absorbed_now, 0.0, pk.tau_left - tau_cell)
        active = pk.active & ~absorbed_now & ~escaped
        absorbed = pk.absorbed | absorbed_now

        upd = pk.active
        pos = jnp.where(upd[:, None], pos, pk.pos)
        cell = jnp.where(upd, cell, pk.cell)
        tau_left = jnp.where(upd, tau_left, pk.tau_left)
        pk = SpectralVoronoiPacketBatch(
            pos, pk.dirn, cell, tau_left, pk.weight,
            pk.sig_h, pk.sig_he, pk.fbin, active, absorbed)
        return step + 1, tly, pk

    _, tally2d, packets = jax.lax.while_loop(
        cond, body, (jnp.int32(0), tally2d, packets))
    return tally2d, packets


def trace_packets_voronoi_spectral(
    grid: VoronoiGrid,
    chi_h_si: jnp.ndarray,  # [C] n_H·x_H per meter (multiply σ_H)
    chi_he_si: jnp.ndarray,  # [C] n_H·A_He·x_He per meter
    packets: SpectralVoronoiPacketBatch,
    *,
    n_bins: int,
    max_steps: int = 0,
):
    """Spectral march over the cell graph; returns ([n_bins, C] tallies
    Σ ℓ_m·w in meters, terminated batch)."""
    C = grid.n_cells
    if max_steps == 0:
        max_steps = 16 * int(np.ceil(C ** (1.0 / 3.0))) + 64
    chi_h_u = jnp.asarray(chi_h_si, jnp.float32) * grid.scale
    chi_he_u = jnp.asarray(chi_he_si, jnp.float32) * grid.scale
    tally2d = jnp.zeros(n_bins * C, jnp.float32)
    eps = jnp.float32(1e-5 / max(C ** (1.0 / 3.0), 1.0))
    tally2d, packets = _trace_voronoi_spectral_jit(
        jnp.asarray(grid.neighbors), jnp.asarray(grid.normals),
        jnp.asarray(grid.offsets), jnp.asarray(grid.shifts),
        chi_h_u, chi_he_u, packets, tally2d, eps, max_steps, n_bins, C,
    )
    return (tally2d * grid.scale).reshape(n_bins, C), packets


class MultiFreqVoronoiSimulation:
    """Multi-element photoionization with temperature balance on a Voronoi
    tessellation — the full ionization machinery on the unstructured grid
    (the reference plugs VoronoiDensityGrid into the same
    IonizationSimulation, /root/reference/src/VoronoiDensityGrid.cpp)."""

    def __init__(self, grid: VoronoiGrid, density_fn, *,
                 source_position, luminosity, n_photons,
                 abundances=None, spectrum_temperature=40000.0,
                 do_temperature=True, diffuse_field=False,
                 n_bins=64, n_reemission_rounds=4,
                 initial_temperature=8000.0, seed=42, mesh=None):
        self.mesh = mesh
        import jax as _jax

        if not _jax.config.jax_enable_x64:
            _jax.config.update("jax_enable_x64", True)
        from cmacionize_tpu import constants
        from cmacionize_tpu.models import ions
        from cmacionize_tpu.models import reemission as reemission_mod
        from cmacionize_tpu.ops import cross_sections as xsec_mod

        self.grid = grid
        self.source_position = source_position
        self.luminosity = luminosity
        self.n_photons = n_photons
        self.abundances = dict(abundances or ions.DEFAULT_ABUNDANCES)
        self.do_temperature = do_temperature
        self.diffuse_field = diffuse_field
        self.n_bins = n_bins
        self.n_reemission_rounds = n_reemission_rounds
        self.key = jax.random.PRNGKey(seed)

        nu_min = reemission_mod.NU_MIN
        self.bin_edges = np.linspace(nu_min, 4.0 * nu_min, n_bins + 1)
        self.bin_centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        self.sigma_table = xsec_mod.tabulate_cross_sections(self.bin_centers)
        self.heating_weights = np.stack([
            self.sigma_table[ions.ION_H_n]
            * (self.bin_centers - constants.NU_ION_H),
            self.sigma_table[ions.ION_He_n]
            * (self.bin_centers - constants.NU_ION_HE),
        ])
        x = (constants.PLANCK * self.bin_centers
             / (constants.BOLTZMANN * spectrum_temperature))
        pdf = self.bin_centers**2 / np.expm1(x)
        cdf = np.cumsum(pdf)
        self.spectrum_cdf = np.concatenate([[0.0], cdf / cdf[-1]])
        self.spectra = reemission_mod.ReemissionSpectra.build()

        gen_si = (grid.generators * grid.scale
                  + np.asarray(grid.geometry.anchor))
        C = grid.n_cells
        self.number_density = jnp.asarray(density_fn(gen_si), jnp.float64)
        self.temperature = jnp.full(C, initial_temperature, jnp.float64)
        self.xion = {
            name: jnp.full(C, 1e-6, jnp.float64)
            for name in ions.ION_NAMES
        }
        self.iteration = 0
        self._density_fn = density_fn

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        arrays = {
            "generators": np.asarray(self.grid.generators),
            "temperature": self.temperature,
            "rng_key": jax.random.key_data(self.key),
        }
        for name, val in self.xion.items():
            arrays[f"xion_{name}"] = val
        return manager.write(arrays, {"iteration": self.iteration})

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager
        from cmacionize_tpu.models import ions

        arrays, scalars = RestartManager.load(filename)
        self.grid = rebuild_voronoi_grid(
            self.grid.geometry, np.asarray(arrays["generators"]))
        gen_si = (self.grid.generators * self.grid.scale
                  + np.asarray(self.grid.geometry.anchor))
        self.number_density = jnp.asarray(
            self._density_fn(gen_si), jnp.float64)
        self.temperature = jnp.asarray(arrays["temperature"], jnp.float64)
        self.xion = {
            name: jnp.asarray(arrays[f"xion_{name}"], jnp.float64)
            for name in ions.ION_NAMES
        }
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.iteration = int(scalars["iteration"])

    def run(self, n_iterations: int, restart_manager=None):
        from cmacionize_tpu import constants
        from cmacionize_tpu.models import ions, sources
        from cmacionize_tpu.models import reemission as reemission_mod
        from cmacionize_tpu.models.multifreq_simulation import (
            solve_cell_state,
        )
        from cmacionize_tpu.ops import traversal
        from cmacionize_tpu.utils import signals

        if restart_manager is not None:
            signals.install()
        grid = self.grid
        C = grid.n_cells
        AHe = self.abundances["He"]
        sig_h_tab = jnp.asarray(self.sigma_table[ions.ION_H_n], jnp.float32)
        sig_he_tab = jnp.asarray(self.sigma_table[ions.ION_He_n], jnp.float32)
        src_u = ((np.asarray(self.source_position)
                  - np.asarray(grid.geometry.anchor)) / grid.scale)
        src_cell = int(grid.locate(src_u)[0])
        edges32 = jnp.asarray(self.bin_edges, jnp.float32)
        cdf32 = jnp.asarray(self.spectrum_cdf, jnp.float32)
        src32 = jnp.asarray(src_u, jnp.float32)

        n_dev = 1 if self.mesh is None else int(self.mesh.devices.size)
        per_dev = -(-self.n_photons // n_dev)
        n_total = per_dev * n_dev

        def mc_phase(key, chi_h, chi_he, xH, xHe, T32):
            """One device's share of the MC phase: emit ``per_dev`` packets,
            trace, run the reemission generations locally (per-rank, as the
            reference's replicated-grid MPI mode does) → [n_bins, C] tally."""
            kb, kd, kt, kl = jax.random.split(key, 4)
            xi = jax.random.uniform(kb, (per_dev,), jnp.float32)
            fbin = jnp.clip(
                jnp.searchsorted(cdf32, xi) - 1,
                0, self.n_bins - 1).astype(jnp.int32)
            ndx, ndy, ndz = sources.isotropic_directions(kd, per_dev)
            tau = sources.sample_tau_targets(kt, per_dev)
            pk = SpectralVoronoiPacketBatch(
                jnp.tile(src32, (per_dev, 1)),
                jnp.stack([ndx, ndy, ndz], 1),
                jnp.full(per_dev, src_cell, jnp.int32),
                tau, jnp.ones(per_dev, jnp.float32),
                sig_h_tab[fbin], sig_he_tab[fbin], fbin,
                jnp.ones(per_dev, bool),
                jnp.zeros(per_dev, bool))
            tally, pk = trace_packets_voronoi_spectral(
                grid, chi_h, chi_he, pk, n_bins=self.n_bins)
            if self.diffuse_field:
                for gen in range(self.n_reemission_rounds):
                    kl, kr, kdd, ktt = jax.random.split(kl, 4)
                    cells = jnp.clip(pk.cell, 0, C - 1)
                    remask, new_freq, _hch = reemission_mod.reemit_batch(
                        kr, self.spectra, pk.absorbed, pk.sig_h, pk.sig_he,
                        xH[cells], xHe[cells], T32[cells], AHe)
                    rdx, rdy, rdz = sources.isotropic_directions(
                        kdd, pk.size)
                    rtau = sources.sample_tau_targets(ktt, pk.size)
                    nbin = jnp.clip(
                        jnp.searchsorted(edges32, new_freq) - 1,
                        0, self.n_bins - 1).astype(jnp.int32)
                    pk = SpectralVoronoiPacketBatch(
                        pk.pos, jnp.stack([rdx, rdy, rdz], 1), pk.cell,
                        rtau, pk.weight,
                        sig_h_tab[nbin], sig_he_tab[nbin], nbin,
                        remask, jnp.zeros_like(remask))
                    gen_tally, pk = trace_packets_voronoi_spectral(
                        grid, chi_h, chi_he, pk, n_bins=self.n_bins)
                    tally = tally + gen_tally
            return tally

        dp_mc = None
        if self.mesh is not None:
            # photon-DP: replicated tessellation, per-device emission and
            # reemission generations, spectral tallies psum'd
            from jax import shard_map
            from jax.sharding import NamedSharding, PartitionSpec as P

            def device_mc(keys, chi_h, chi_he, xH, xHe, T32):
                return jax.lax.psum(
                    mc_phase(keys[0], chi_h, chi_he, xH, xHe, T32), "ph")

            _sharded_mc = jax.jit(shard_map(
                device_mc, mesh=self.mesh,
                in_specs=(P("ph"),) + (P(),) * 5,
                out_specs=P(), check_vma=False))
            _rep = NamedSharding(self.mesh, P())
            _split = NamedSharding(self.mesh, P("ph"))

            def dp_mc(keys, *fields):
                # the solve step commits its outputs to cpu:0; re-place
                # everything on the mesh before entering the shard_map
                keys = jax.device_put(keys, _split)
                fields = tuple(
                    jax.device_put(f, _rep) for f in fields)
                return _sharded_mc(keys, *fields)

        for it in range(n_iterations):
            xH = jnp.clip(self.xion["H_n"], 0.0, 1.0).astype(jnp.float32)
            xHe = jnp.clip(self.xion["He_n"], 0.0, 1.0).astype(jnp.float32)
            nd32 = self.number_density.astype(jnp.float32)
            chi_h = nd32 * xH
            chi_he = nd32 * AHe * xHe
            T32 = self.temperature.astype(jnp.float32)
            if dp_mc is not None:
                keys = jax.random.split(self.key, n_dev + 1)
                self.key = keys[0]
                tally = dp_mc(keys[1:], chi_h, chi_he, xH, xHe, T32)
            else:
                self.key, kit = jax.random.split(self.key)
                tally = mc_phase(kit, chi_h, chi_he, xH, xHe, T32)

            integrals = traversal.spectral_tallies_to_ion_integrals(
                tally.reshape(-1),
                jnp.asarray(self.sigma_table, jnp.float32),
                jnp.asarray(self.heating_weights, jnp.float32), C)

            integrals = integrals.astype(jnp.float64)
            volumes = jnp.asarray(grid.volumes, jnp.float64)
            jfac = self.luminosity / (n_total * volumes)
            hfac = jfac * constants.PLANCK
            j = {
                name: integrals[i] * jfac
                for i, name in enumerate(ions.ION_NAMES)
            }
            h = (integrals[ions.NUMBER_OF_IONS] * hfac,
                 integrals[ions.NUMBER_OF_IONS + 1] * hfac)
            do_temp = self.do_temperature and self.iteration >= 3
            self.temperature, self.xion = solve_cell_state(
                j, h, self.number_density, self.temperature,
                self.abundances, do_temp)
            self.iteration += 1
            if restart_manager is not None:
                stopping = (
                    signals.stop_requested() or restart_manager.want_stop()
                )
                if restart_manager.due() or stopping:
                    self.write_restart(restart_manager)
                if stopping:
                    restart_manager.on_stop()
                    break
        return self.xion, self.temperature


# ---------------------------------------------------------------------------
# H-only ionization driver on a Voronoi grid
# ---------------------------------------------------------------------------


class HOnlyVoronoiSimulation:
    """Hydrogen-only MC photoionization on a Voronoi tessellation.

    The VoronoiDensityGrid counterpart of HOnlyIonizationSimulation
    (/root/reference/src/VoronoiDensityGrid.cpp): per-iteration emit → trace
    over the cell graph → per-cell ionization balance on [C] arrays.
    """

    def __init__(
        self,
        grid: VoronoiGrid,
        density_fn: Callable[[np.ndarray], np.ndarray],  # SI positions → m^-3
        *,
        source_position: Tuple[float, float, float],
        luminosity: float,
        cross_section: float,
        recombination_rate: float,
        n_photons: int,
        initial_neutral_fraction: float = 1.0e-6,
        seed: int = 42,
        mesh=None,
    ):
        self.mesh = mesh
        self.grid = grid
        gen_si = (grid.generators * grid.scale
                  + np.asarray(grid.geometry.anchor))
        self.number_density = jnp.asarray(density_fn(gen_si), jnp.float32)
        self.neutral_fraction = jnp.full(
            grid.n_cells, initial_neutral_fraction, jnp.float32)
        self.source_position = source_position
        self.luminosity = luminosity
        self.cross_section = cross_section
        self.alpha = recombination_rate
        self.n_photons = n_photons
        self.key = jax.random.PRNGKey(seed)
        self.iteration = 0
        self._density_fn = density_fn

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        """Checkpoint: generator positions (the full grid record) + cell
        state + RNG chain (cf. /root/reference/src/RestartManager.hpp)."""
        return manager.write({
            "generators": np.asarray(self.grid.generators),
            "neutral_fraction": self.neutral_fraction,
            "rng_key": jax.random.key_data(self.key),
        }, {"iteration": self.iteration})

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager

        arrays, scalars = RestartManager.load(filename)
        self.grid = rebuild_voronoi_grid(
            self.grid.geometry, np.asarray(arrays["generators"]))
        gen_si = (self.grid.generators * self.grid.scale
                  + np.asarray(self.grid.geometry.anchor))
        self.number_density = jnp.asarray(
            self._density_fn(gen_si), jnp.float32)
        self.neutral_fraction = jnp.asarray(arrays["neutral_fraction"])
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.iteration = int(scalars["iteration"])

    def run(self, n_iterations: int, restart_manager=None):
        from cmacionize_tpu.ops import ionization
        from cmacionize_tpu.utils import signals

        if restart_manager is not None:
            signals.install()
        grid = self.grid
        src_u = ((np.asarray(self.source_position)
                  - np.asarray(grid.geometry.anchor)) / grid.scale)
        src_cell = int(grid.locate(src_u)[0])
        dp_trace = None
        n_total = self.n_photons
        if self.mesh is not None:
            # photon data parallelism: replicated tessellation, packet
            # count split over the mesh (the reference's MPI mode for
            # unstructured grids, IonizationSimulation.cpp:395-529)
            from cmacionize_tpu.parallel.photon_dp import (
                make_voronoi_dp_trace,
            )

            n_dev = int(self.mesh.devices.size)
            per_dev = -(-self.n_photons // n_dev)
            n_total = per_dev * n_dev
            dp_trace = make_voronoi_dp_trace(
                self.mesh, grid,
                n_photons_per_device=per_dev,
                src_u=src_u, src_cell=src_cell,
            )
        jfac = jnp.asarray(
            self.luminosity * self.cross_section
            / (n_total * np.asarray(grid.volumes, np.float64)),
            jnp.float32,
        )
        for _ in range(n_iterations):
            chi_si = (self.number_density * self.neutral_fraction
                      * self.cross_section)
            if dp_trace is not None:
                keys = jax.random.split(self.key, n_dev + 1)
                self.key = keys[0]
                tally, _ = dp_trace(keys[1:], chi_si)
            else:
                self.key, k1, k2 = jax.random.split(self.key, 3)
                dirn = jax.random.normal(k1, (self.n_photons, 3))
                dirn = dirn / jnp.linalg.norm(dirn, axis=1, keepdims=True)
                tau = -jnp.log(
                    1.0 - jax.random.uniform(k2, (self.n_photons,)))
                pos = jnp.tile(
                    jnp.asarray(src_u, jnp.float32), (self.n_photons, 1))
                packets = VoronoiPacketBatch(
                    pos, dirn.astype(jnp.float32),
                    jnp.full(self.n_photons, src_cell, jnp.int32),
                    tau.astype(jnp.float32),
                    jnp.ones(self.n_photons, jnp.float32),
                    jnp.ones(self.n_photons, bool),
                    jnp.zeros(self.n_photons, bool),
                )
                tally, _, _ = trace_packets_voronoi_cascade(
                    grid, chi_si, packets)
            jH = tally * jfac
            self.neutral_fraction = ionization.hydrogen_neutral_fraction(
                jH, self.number_density, self.alpha)
            self.iteration += 1
            if restart_manager is not None:
                stopping = (
                    signals.stop_requested() or restart_manager.want_stop()
                )
                if restart_manager.due() or stopping:
                    self.write_restart(restart_manager)
                if stopping:
                    restart_manager.on_stop()
                    break
        return self.neutral_fraction

    def ionized_volume(self) -> float:
        xn = np.asarray(self.neutral_fraction, np.float64)
        return float(np.sum((1.0 - xn) * self.grid.volumes))
