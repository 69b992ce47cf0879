"""Adaptive mesh refinement grid family.

Replaces the reference's pointer-tree AMR
(/root/reference/src/AMRDensityGrid.hpp:44-808, AMRGrid.hpp,
AMRGridCell.hpp) with a design shaped for XLA: refinement levels are
*level-synchronous dense lattices* instead of an octree of heap cells.

Representation
--------------
A cell at level ``l`` lives on the lattice ``shape * 2**l``.  Construction
(host-side numpy, like the reference's grid setup) produces, per level, a
boolean ``leaf`` mask on that level's lattice; leaves across all levels are
concatenated into one *compact cell array* of length ``C`` (volumes,
centers, levels).  An int32 ``owner`` map on the finest lattice
(``shape * 2**max_level``) sends every finest-lattice cell to its owning
leaf.

Transport ("dense-expand")
--------------------------
Photon traversal runs on the finest uniform lattice with per-cell opacity
``chi[owner]`` — a single gather per iteration — reusing the existing
blocked traversal kernels unchanged (a uniform lattice is the shape vectorized
hardware wants; a data-dependent tree walk is not).  Path-length tallies on the
fine lattice are summed back per leaf with one ``segment_sum``.  The result
is *exactly* the optical-depth integral through the multi-level grid: within
a leaf the opacity is constant, so splitting its path into finest-lattice
segments changes nothing.  Physics solves (ionization balance, temperature)
then run on the compact ``[C]`` arrays — the AMR saving: ``C`` cells of
state instead of ``prod(shape)*8**max_level``.

Refinement criteria mirror the reference's five schemes
(/root/reference/src/AMRRefinementSchemeFactory.hpp:73-84), vectorized over
all cells of a level at once.  Like the reference (AMRDensityGrid.hpp:101,
refine_cell), refinement is applied recursively at construction and can be
re-applied between iterations (``refinement_interval``), with cell state
resampled through the finest-lattice roundtrip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu.models.grid import GridGeometry

__all__ = [
    "AMRGrid",
    "build_amr_grid",
    "MassRefinement",
    "OpacityRefinement",
    "SpatialRefinement",
    "OIRefinement",
    "CMacIonizeRefinement",
    "refinement_scheme_from_params",
    "AMRIonizationSimulation",
]


# ---------------------------------------------------------------------------
# Refinement schemes (vectorized equivalents of the reference's 5 classes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MassRefinement:
    """Refine while cell mass (particle count) exceeds the target.

    cf. /root/reference/src/MassAMRRefinementScheme.hpp:39-90:
    ``volume * number_density > target_npart``.
    """

    target_npart: float = 1.0
    max_level: int = 6

    def refine(self, level, centers, volume, number_density, fractions):
        if level >= self.max_level:
            return np.zeros(len(centers), bool)
        return volume * number_density > self.target_npart


@dataclasses.dataclass(frozen=True)
class OpacityRefinement:
    """Refine while the cell opacity (m^-1) exceeds the target.

    cf. /root/reference/src/OpacityAMRRefinementScheme.hpp:38-80.  Opacity is
    ``n_H * x_Hn * sigma`` with the HI photoionization cross section at the
    ionization threshold unless another sigma is given.
    """

    target_opacity: float = 1.0  # m^-1
    max_level: int = 6
    sigma: float = 6.3e-22  # m^2, HI at nu_ion

    def refine(self, level, centers, volume, number_density, fractions):
        if level >= self.max_level:
            return np.zeros(len(centers), bool)
        xn = fractions.get("H_n", np.ones(len(centers)))
        return number_density * xn * self.sigma > self.target_opacity


@dataclasses.dataclass(frozen=True)
class SpatialRefinement:
    """Refine every cell whose center lies inside a fixed zone box.

    cf. /root/reference/src/SpatialAMRRefinementScheme.hpp:39-120.
    """

    zone_anchor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    zone_sides: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    max_level: int = 4

    def refine(self, level, centers, volume, number_density, fractions):
        if level >= self.max_level:
            return np.zeros(len(centers), bool)
        a = np.asarray(self.zone_anchor)
        b = a + np.asarray(self.zone_sides)
        return np.all((centers >= a) & (centers < b), axis=1)


@dataclasses.dataclass(frozen=True)
class OIRefinement:
    """Refine while the neutral-oxygen transition-zone mass is large.

    cf. /root/reference/src/OIAMRRefinementScheme.hpp:50-110:
    ``volume * x(O_n) * x(O_p1) * n_H > target_N`` — peaks in the O0/O+
    transition zone, i.e. at the ionization front.
    """

    target_n_oi: float = 1.0e5
    max_level: int = 6

    def refine(self, level, centers, volume, number_density, fractions):
        if level >= self.max_level:
            return np.zeros(len(centers), bool)
        on = fractions.get("O_n", np.zeros(len(centers)))
        op1 = fractions.get("O_p1", np.zeros(len(centers)))
        return volume * on * op1 * number_density > self.target_n_oi


@dataclasses.dataclass(frozen=True)
class CMacIonizeRefinement:
    """Refine while the density function flags the cell (negative density).

    cf. /root/reference/src/CMacIonizeAMRRefinementScheme.hpp:55-67 — the
    CMacIonizeSnapshot density function returns a negative density for cells
    that are not yet at the refinement level stored in the snapshot.
    """

    max_level: int = 12

    def refine(self, level, centers, volume, number_density, fractions):
        if level >= self.max_level:
            return np.zeros(len(centers), bool)
        return number_density < 0.0


def refinement_scheme_from_params(params):
    """Build a refinement scheme from ``DensityGrid:AMRRefinementScheme``.

    Mirrors /root/reference/src/AMRRefinementSchemeFactory.hpp:73-84.
    Returns None for type "None".
    """
    prefix = "DensityGrid:AMRRefinementScheme"
    stype = params.get_string(f"{prefix}:type", "None")
    if stype == "None":
        return None
    if stype == "Mass":
        return MassRefinement(
            target_npart=params.get_number(
                f"{prefix}:target number of particles", 1.0),
        )
    if stype == "Opacity":
        return OpacityRefinement(
            target_opacity=params.get_physical_value(
                f"{prefix}:target opacity", "opacity", "1. m^-1"),
            max_level=params.get_int(
                f"{prefix}:maximum refinement level", 6),
        )
    if stype == "Spatial":
        return SpatialRefinement(
            zone_anchor=tuple(params.get_physical_vector(
                f"{prefix}:zone anchor", "length")),
            zone_sides=tuple(params.get_physical_vector(
                f"{prefix}:zone sides", "length")),
            max_level=params.get_int(
                f"{prefix}:maximum refinement level", 4),
        )
    if stype == "OI":
        return OIRefinement(
            target_n_oi=params.get_number(
                f"{prefix}:target number of OI particles", 1.0e5),
            max_level=params.get_int(
                f"{prefix}:maximum refinement level", 6),
        )
    if stype == "CMacIonize":
        return CMacIonizeRefinement()
    raise ValueError(f"unknown AMRRefinementScheme type '{stype}'")


# ---------------------------------------------------------------------------
# Grid construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AMRGrid:
    """A constructed AMR hierarchy: compact leaves + finest-lattice owner map.

    Array-based replacement for AMRGrid/AMRGridCell
    (/root/reference/src/AMRGrid.hpp, AMRGridCell.hpp): leaves are rows of
    dense arrays, the tree walk is a gather through ``owner``.
    """

    geometry: GridGeometry  # coarse (level-0) geometry
    max_level: int
    n_cells: int  # C — number of leaves
    levels: np.ndarray  # [C] int8 leaf level
    centers: np.ndarray  # [C, 3] SI leaf centers
    volumes: np.ndarray  # [C] SI leaf volumes
    #: finest-lattice int32 → leaf id; None for DEEP grids (the dense
    #: lattice would be 8^max_level cells — the octree path below replaces
    #: it, lifting the reference-parity depth bound of PARITY delta #4)
    owner: Optional[np.ndarray]
    leaf_masks: Optional[tuple]  # per-level bool lattices (dense grids only)
    #: per-level [n, 3] leaf / refined cell coordinates (sparse record)
    leaf_coords: Optional[tuple] = None
    refined_coords: Optional[tuple] = None

    @property
    def fine_shape(self) -> Tuple[int, int, int]:
        r = 2 ** self.max_level
        nx, ny, nz = self.geometry.shape
        return (nx * r, ny * r, nz * r)

    @property
    def fine_cell_size(self) -> np.ndarray:
        return self.geometry.cell_size / (2 ** self.max_level)

    # -------------------------------------------------------------- expand
    def expand(self, values: jnp.ndarray) -> jnp.ndarray:
        """[C] leaf values → finest-lattice dense grid (one gather)."""
        if self.owner is None:
            raise NotImplementedError(
                "deep AMR grid has no dense finest lattice; use the octree "
                "traversal path")
        owner = jnp.asarray(self.owner)
        return jnp.take(jnp.asarray(values), owner, axis=0)

    # -------------------------------------------------------------- octree
    def octree(self):
        """(root [nx·ny·nz] int32, children [n_internal, 8] int32) —
        flattened pointer octree for the depth-independent traversal.

        Encoding: value >= 0 → internal node id (row of ``children``);
        value < 0 → leaf with id ``-(value + 1)``.  Child octant index is
        ``ox·4 + oy·2 + oz``.  The JAX equivalent of the reference's
        AMRGridCell pointer tree (/root/reference/src/AMRGridCell.hpp),
        built once per hierarchy and cached.
        """
        if getattr(self, "_octree_cache", None) is not None:
            return self._octree_cache
        if self.leaf_coords is None:
            raise ValueError("grid was built without sparse coords")
        nx, ny, nz = self.geometry.shape

        def keys(coords, level):
            sy = ny << level
            sz = nz << level
            return (
                coords[:, 0].astype(np.int64) * sy + coords[:, 1]
            ) * sz + coords[:, 2]

        # leaf ids are level-major in construction order (sorted per level)
        leaf_offset = np.cumsum(
            [0] + [len(c) for c in self.leaf_coords])[:-1]
        node_offset = np.cumsum(
            [0] + [len(c) for c in self.refined_coords])[:-1]
        n_internal = int(sum(len(c) for c in self.refined_coords))
        children = np.zeros((max(n_internal, 1), 8), np.int32)
        offs = np.indices((2, 2, 2)).reshape(3, -1).T  # octant = ox*4+oy*2+oz

        def encode(level, coords):
            """Cell coords at ``level`` → node/leaf encoding (every existing
            cell is either a leaf or refined at its level, by construction;
            the per-level coord lists are lexicographically sorted)."""
            out = np.empty(len(coords), np.int32)
            k = keys(coords, level)
            leaf_k = keys(self.leaf_coords[level], level)
            if len(leaf_k):
                pos = np.clip(np.searchsorted(leaf_k, k), 0, len(leaf_k) - 1)
                is_leaf = leaf_k[pos] == k
                out[is_leaf] = -(leaf_offset[level] + pos[is_leaf] + 1)
            else:
                is_leaf = np.zeros(len(coords), bool)
            ref_k = keys(self.refined_coords[level], level)
            rpos = np.searchsorted(ref_k, k[~is_leaf])
            out[~is_leaf] = node_offset[level] + rpos
            return out

        for level, refined in enumerate(self.refined_coords):
            if len(refined) == 0:
                continue
            child_coords = (
                refined[:, None, :] * 2 + offs[None, :, :]
            ).reshape(-1, 3)
            enc = encode(level + 1, child_coords).reshape(-1, 8)
            children[node_offset[level]:node_offset[level] + len(refined)] = (
                enc
            )
        root_coords = np.indices((nx, ny, nz)).reshape(3, -1).T
        root = encode(0, root_coords)
        object.__setattr__(self, "_octree_cache", (root, children))
        return root, children

    def reduce(self, fine: jnp.ndarray) -> jnp.ndarray:
        """Finest-lattice grid → per-leaf sums (one segment_sum)."""
        owner = jnp.asarray(self.owner).reshape(-1)
        return jax.ops.segment_sum(
            jnp.asarray(fine).reshape(-1), owner, num_segments=self.n_cells
        )

    def reduce_mean(self, fine: jnp.ndarray) -> jnp.ndarray:
        """Finest-lattice grid → per-leaf means (volume-weighted average
        for uniform finest cells)."""
        counts = np.bincount(
            self.owner.reshape(-1), minlength=self.n_cells
        ).astype(np.float32)
        return self.reduce(fine) / jnp.asarray(counts)


def _level_cell_centers(geometry: GridGeometry, level: int) -> np.ndarray:
    """[n,3] centers of all cells on the level-``level`` lattice."""
    shape = tuple(s * 2 ** level for s in geometry.shape)
    cs = geometry.cell_size / (2 ** level)
    axes = [
        geometry.anchor[i] + (np.arange(shape[i]) + 0.5) * cs[i]
        for i in range(3)
    ]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack(grid, axis=-1).reshape(-1, 3)


def _upsample2(mask: np.ndarray) -> np.ndarray:
    """bool [a,b,c] → [2a,2b,2c] (each parent marks its 8 children)."""
    return np.repeat(np.repeat(np.repeat(mask, 2, 0), 2, 1), 2, 2)


#: largest finest-lattice size for which the dense owner map / expand path
#: is built (67M cells ≈ 0.25 GB int32); deeper grids go octree-only
_MAX_DENSE_FINE_CELLS = 1 << 26


def build_amr_grid(
    geometry: GridGeometry,
    scheme,
    density_fn: Callable[[np.ndarray], np.ndarray],
    *,
    max_level: int = 2,
    temperature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    fractions_fn: Optional[Callable[[np.ndarray], dict]] = None,
) -> "AMRGrid":
    """Recursively refine from the coarse lattice, vectorized per level.

    Mirrors AMRDensityGrid's recursive refine_cell
    (/root/reference/src/AMRDensityGrid.hpp:101-193): a refined cell's 8
    children are re-evaluated against the criterion with densities freshly
    sampled from the density function at the child centers.

    ``density_fn(positions[N,3]) -> number_density[N]`` (SI m^-3);
    ``fractions_fn(positions) -> {ion_name: fraction[N]}`` supplies ionic
    fractions to criteria that need them (OI); defaults to fully neutral.
    """
    max_level = min(max_level, getattr(scheme, "max_level", max_level))
    nx, ny, nz = geometry.shape

    def lexsorted(coords):
        if len(coords) == 0:
            return coords.reshape(0, 3)
        order = np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))
        return coords[order]

    # SPARSE level-synchronous construction: only cells that exist at a
    # level are materialized ([n, 3] coord lists), so depth costs
    # O(leaves), not O(8^max_level) — the round-3 depth bound (PARITY
    # delta #4) came from the dense per-level lattices built here
    leaf_coords, refined_coords = [], []
    exists_idx = np.indices((nx, ny, nz)).reshape(3, -1).T
    child_offs = np.indices((2, 2, 2)).reshape(3, -1).T
    for level in range(max_level + 1):
        exists_idx = lexsorted(exists_idx)
        cs = geometry.cell_size / 2 ** level
        centers = np.asarray(geometry.anchor) + (exists_idx + 0.5) * cs
        volume = float(np.prod(cs))
        nd = np.asarray(density_fn(centers), np.float64)
        fracs = fractions_fn(centers) if fractions_fn is not None else {}
        if scheme is not None and level < max_level:
            flag = np.asarray(
                scheme.refine(level, centers, volume, nd, fracs), bool
            ).reshape(-1)
        else:
            flag = np.zeros(len(exists_idx), bool)
        leaf_coords.append(exists_idx[~flag])
        refined = exists_idx[flag]
        refined_coords.append(refined)
        if level < max_level:
            exists_idx = (
                refined[:, None, :] * 2 + child_offs[None, :, :]
            ).reshape(-1, 3)

    # compact leaves: level-major ordering, C-order within a level
    levels_list, centers_list, volumes_list = [], [], []
    next_id = 0
    per_level_ids = []
    for level, idx in enumerate(leaf_coords):
        n = len(idx)
        per_level_ids.append(
            np.arange(next_id, next_id + n, dtype=np.int32))
        next_id += n
        if n == 0:
            continue
        cs = geometry.cell_size / 2 ** level
        centers_list.append(np.asarray(geometry.anchor) + (idx + 0.5) * cs)
        volumes_list.append(np.full(n, float(np.prod(cs))))
        levels_list.append(np.full(n, level, np.int8))

    # dense finest-lattice owner map: only while affordable (the transport
    # fast path); deeper hierarchies use the octree traversal instead
    rf = 2 ** max_level
    fine_shape = (nx * rf, ny * rf, nz * rf)
    owner = None
    leaf_masks = None
    if int(np.prod(fine_shape)) <= _MAX_DENSE_FINE_CELLS:
        owner = np.full(fine_shape, -1, np.int32)
        leaf_masks = []
        for level, idx in enumerate(leaf_coords):
            shape_l = tuple(s * 2 ** level for s in geometry.shape)
            mask = np.zeros(shape_l, bool)
            if len(idx):
                mask[idx[:, 0], idx[:, 1], idx[:, 2]] = True
            leaf_masks.append(mask)
            if len(idx) == 0:
                continue
            # vectorized painting: each leaf covers an (r, r, r) fine block
            r = rf // 2 ** level
            off = np.indices((r, r, r)).reshape(3, -1).T  # [r^3, 3]
            fx = (idx[:, None, 0] * r + off[None, :, 0]).ravel()
            fy = (idx[:, None, 1] * r + off[None, :, 1]).ravel()
            fz = (idx[:, None, 2] * r + off[None, :, 2]).ravel()
            owner[fx, fy, fz] = np.repeat(per_level_ids[level], r ** 3)
        assert (owner >= 0).all(), "owner map has unassigned fine cells"
        leaf_masks = tuple(leaf_masks)
    return AMRGrid(
        geometry=geometry,
        max_level=max_level,
        n_cells=next_id,
        levels=np.concatenate(levels_list),
        centers=np.concatenate(centers_list, axis=0),
        volumes=np.concatenate(volumes_list),
        owner=owner,
        leaf_masks=leaf_masks,
        leaf_coords=tuple(leaf_coords),
        refined_coords=tuple(refined_coords),
    )


def rebuild_amr_grid_from_coords(
    geometry: GridGeometry,
    max_level: int,
    refined_coords,
    density_fn,
    fractions_fn=None,
) -> AMRGrid:
    """Rebuild the EXACT hierarchy recorded in per-level refined-cell
    coordinate lists (the restart path: the coordinate lists are the
    complete tree record, cf. the reference's AMRGrid restart
    serialization).  Deterministic: the replay scheme refines precisely the
    recorded cells, so leaves/owner/octree tables come out identical."""
    refined_sets = [
        {tuple(c) for c in np.asarray(coords).reshape(-1, 3)}
        for coords in refined_coords
    ]

    class _Replay:
        def refine(self, level, centers, volume, nd, fractions):
            if level >= len(refined_sets) or not refined_sets[level]:
                return np.zeros(len(centers), bool)
            size = np.asarray(geometry.cell_size) / (2 ** level)
            coords = np.floor(
                (centers - np.asarray(geometry.anchor)) / size
            ).astype(np.int64)
            want = refined_sets[level]
            return np.fromiter(
                (tuple(c) in want for c in coords), bool, len(coords))

    return build_amr_grid(
        geometry, _Replay(), density_fn, max_level=max_level,
        fractions_fn=fractions_fn,
    )


def resample_leaf_values(
    old: AMRGrid, new: AMRGrid, values: jnp.ndarray
) -> jnp.ndarray:
    """Transfer intensive leaf values between two AMR hierarchies.

    Old leaves → finest lattice → volume-weighted mean per new leaf (exact
    for conservative regridding of intensive quantities when both share the
    same coarse geometry).  Used when the grid is re-refined between MC
    iterations (reference: AMRDensityGrid reset/refinement interval).
    """
    if old.fine_shape == new.fine_shape:
        fine = old.expand(values)
        return new.reduce_mean(fine)
    # differing max_level: go through the finer of the two lattices
    rf_old = 2 ** old.max_level
    rf_new = 2 ** new.max_level
    if rf_new > rf_old:
        fine = old.expand(values)
        rep = rf_new // rf_old
        fine = jnp.repeat(jnp.repeat(jnp.repeat(fine, rep, 0), rep, 1), rep, 2)
        return new.reduce_mean(fine)
    fine = old.expand(values)
    f = rf_old // rf_new
    a, b, c = new.fine_shape
    fine = fine.reshape(a, f, b, f, c, f).mean(axis=(1, 3, 5))
    return new.reduce_mean(fine)


# ---------------------------------------------------------------------------
# Transport + ionization driver
# ---------------------------------------------------------------------------


def trace_amr(
    grid: AMRGrid,
    chi_si: jnp.ndarray,  # [C] opacity per meter per leaf
    packets,  # PacketBatch with positions in FINEST-lattice cell units
    *,
    max_steps: int = 0,
):
    """March packets through the AMR hierarchy; return per-leaf tallies.

    Tallies are Σ ℓ·w with ℓ in meters (already scaled by the finest cell
    size), summed over each leaf's fine cells — identical to tallying per
    leaf directly, since chi is constant within a leaf.
    """
    from cmacionize_tpu.ops import traversal

    if grid.owner is None:
        # deep hierarchy: no dense finest lattice exists — march the
        # flattened octree directly (O(leaves) memory at any depth)
        from cmacionize_tpu.ops import amr_traversal

        root, children = grid.octree()
        dx_coarse = float(grid.geometry.cell_size[0])
        scale = 2.0 ** (-grid.max_level)  # finest units → coarse units
        pk = packets._replace(
            px=packets.px * scale,
            py=packets.py * scale,
            pz=packets.pz * scale,
        )
        chi_coarse = jnp.asarray(chi_si) * dx_coarse
        tally = jnp.zeros((grid.n_cells,), chi_coarse.dtype)
        tally, pk_out = amr_traversal.trace_packets_octree(
            jnp.asarray(root), jnp.asarray(children), chi_coarse, pk, tally,
            coarse_shape=tuple(grid.geometry.shape),
            max_level=grid.max_level, max_steps=max_steps,
        )
        return tally * dx_coarse, jnp.sum(~pk_out.absorbed)

    fine_shape = grid.fine_shape
    dx_fine = float(grid.fine_cell_size[0])
    chi_fine = (grid.expand(chi_si) * dx_fine).reshape(-1)
    tally = jnp.zeros(chi_fine.shape, chi_fine.dtype)
    block = traversal.default_block(fine_shape)
    if block is not None:
        tally, n_absorbed, n_escaped = traversal.trace_packets_blocked_cascade(
            chi_fine, packets, tally,
            shape=fine_shape, block=block,
            periodic=grid.geometry.periodic, max_steps=max_steps,
        )
    else:
        tally, pk = traversal.trace_packets(
            chi_fine, packets, tally,
            shape=fine_shape, periodic=grid.geometry.periodic,
            max_steps=max_steps,
        )
        n_escaped = jnp.sum(~pk.absorbed)
    leaf_tally = grid.reduce(tally) * dx_fine  # cell-units → meters
    return leaf_tally, n_escaped


def trace_amr_spectral(
    grid: AMRGrid,
    chi_h_si: jnp.ndarray,  # [C] n_H·x_H per meter (multiply σ_H(ν))
    chi_he_si: jnp.ndarray,  # [C] n_H·A_He·x_He per meter
    packets,  # SpectralPacketBatch, positions in finest-lattice cell units
    *,
    n_bins: int,
    max_steps: int = 0,
):
    """Spectral (multi-frequency) march through the AMR hierarchy.

    Returns ([n_bins, C] per-leaf binned tallies Σ ℓ_m·w, terminated batch)
    — the AMR counterpart of trace_packets_spectral_auto; the reference runs
    the identical multi-ion tallying on AMR through its grid iterator
    (/root/reference/src/AMRDensityGrid.hpp:44-808 plugging into
    IonizationSimulation).

    Deep hierarchies (``grid.owner is None`` — no affordable dense finest
    lattice) march the flattened octree directly
    (ops.amr_traversal.trace_packets_octree_spectral): O(leaves) memory at
    any depth, same estimator.  Packet positions stay in finest-lattice
    units at this API boundary (converted to/from coarse units around the
    octree kernel).
    """
    from cmacionize_tpu.ops import traversal

    if grid.owner is None:
        from cmacionize_tpu.ops import amr_traversal

        root, children = grid.octree()
        dx_coarse = float(grid.geometry.cell_size[0])
        scale = 2.0 ** (-grid.max_level)  # finest units → coarse units
        pk_in = packets._replace(
            px=packets.px * scale,
            py=packets.py * scale,
            pz=packets.pz * scale,
        )
        tally2d = jnp.zeros((n_bins * grid.n_cells,), jnp.float32)
        tally2d, pk = amr_traversal.trace_packets_octree_spectral(
            jnp.asarray(root), jnp.asarray(children),
            jnp.asarray(chi_h_si, jnp.float32) * dx_coarse,
            jnp.asarray(chi_he_si, jnp.float32) * dx_coarse,
            pk_in, tally2d,
            coarse_shape=tuple(grid.geometry.shape),
            max_level=grid.max_level, n_bins=n_bins, max_steps=max_steps,
        )
        pk = pk._replace(
            px=pk.px / scale, py=pk.py / scale, pz=pk.pz / scale)
        return (
            tally2d.reshape(n_bins, grid.n_cells) * dx_coarse, pk
        )

    fine_shape = grid.fine_shape
    ncell_fine = fine_shape[0] * fine_shape[1] * fine_shape[2]
    dx_fine = float(grid.fine_cell_size[0])
    chi_h_fine = (grid.expand(chi_h_si) * dx_fine).reshape(-1)
    chi_he_fine = (grid.expand(chi_he_si) * dx_fine).reshape(-1)
    tally2d = jnp.zeros(n_bins * ncell_fine, jnp.float32)
    tally2d, pk = traversal.trace_packets_spectral_auto(
        chi_h_fine, chi_he_fine, packets, tally2d,
        shape=fine_shape, n_bins=n_bins,
        periodic=grid.geometry.periodic, max_steps=max_steps,
    )
    per_bin = jax.vmap(grid.reduce)(
        tally2d.reshape(n_bins, *fine_shape)
    )  # [n_bins, C]
    return per_bin * dx_fine, pk  # cell-units → meters


class MultiFreqAMRSimulation:
    """Multi-element photoionization with temperature balance on AMR leaves.

    Per iteration: expand leaf opacities to the finest lattice → spectral
    trace (+ per-packet diffuse re-emission generations) → reduce binned
    tallies per leaf → one matmul to per-ion integrals → the shared
    per-cell solve (solve_cell_state) on the compact [C] arrays.
    """

    def __init__(self, grid: AMRGrid, density_fn, *,
                 source_position, luminosity, n_photons,
                 abundances=None, spectrum_temperature=40000.0,
                 do_temperature=True, diffuse_field=False,
                 n_bins=64, n_reemission_rounds=4,
                 initial_temperature=8000.0, seed=42, mesh=None):
        self.mesh = mesh
        import jax as _jax

        if not _jax.config.jax_enable_x64:
            _jax.config.update("jax_enable_x64", True)
        from cmacionize_tpu.models import ions as ions_mod

        self.grid = grid
        self.density_fn = density_fn
        self.source_position = source_position
        self.luminosity = luminosity
        self.n_photons = n_photons
        self.abundances = dict(abundances or ions_mod.DEFAULT_ABUNDANCES)
        self.do_temperature = do_temperature
        self.diffuse_field = diffuse_field
        self.n_bins = n_bins
        self.n_reemission_rounds = n_reemission_rounds
        self.key = jax.random.PRNGKey(seed)

        # frequency machinery shared with the Cartesian driver
        from cmacionize_tpu import constants
        from cmacionize_tpu.models import reemission as reemission_mod
        from cmacionize_tpu.ops import cross_sections as xsec_mod

        nu_min = reemission_mod.NU_MIN
        self.bin_edges = np.linspace(nu_min, 4.0 * nu_min, n_bins + 1)
        self.bin_centers = 0.5 * (self.bin_edges[1:] + self.bin_edges[:-1])
        self.sigma_table = xsec_mod.tabulate_cross_sections(self.bin_centers)
        from cmacionize_tpu.models import ions
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

        C = grid.n_cells
        self.number_density = jnp.asarray(density_fn(grid.centers),
                                          jnp.float64)
        self.temperature = jnp.full(C, initial_temperature, jnp.float64)
        from cmacionize_tpu.models import ions as _ions
        self.xion = {
            name: jnp.full(C, 1e-6, jnp.float64)
            for name in _ions.ION_NAMES
        }
        self.iteration = 0

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        arrays = {
            "temperature": self.temperature,
            "rng_key": jax.random.key_data(self.key),
        }
        for name, val in self.xion.items():
            arrays[f"xion_{name}"] = val
        for lvl, coords in enumerate(self.grid.refined_coords):
            arrays[f"refined_coords_{lvl}"] = np.asarray(coords, np.int64)
        return manager.write(arrays, {
            "iteration": self.iteration,
            "n_refined_levels": len(self.grid.refined_coords),
        })

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager
        from cmacionize_tpu.models import ions as _ions

        arrays, scalars = RestartManager.load(filename)
        n_levels = int(scalars["n_refined_levels"])
        refined = tuple(
            np.asarray(arrays[f"refined_coords_{lvl}"], np.int64)
            for lvl in range(n_levels)
        )
        self.grid = rebuild_amr_grid_from_coords(
            self.grid.geometry, self.grid.max_level, refined,
            self.density_fn)
        self.number_density = jnp.asarray(
            self.density_fn(self.grid.centers), jnp.float64)
        self.temperature = jnp.asarray(arrays["temperature"], jnp.float64)
        self.xion = {
            name: jnp.asarray(arrays[f"xion_{name}"], jnp.float64)
            for name in _ions.ION_NAMES
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
        fine_shape = grid.fine_shape
        AHe = self.abundances["He"]
        sig_h_tab = jnp.asarray(self.sigma_table[ions.ION_H_n], jnp.float32)
        sig_he_tab = jnp.asarray(self.sigma_table[ions.ION_He_n], jnp.float32)
        gpos = tuple(
            (np.asarray(self.source_position)
             - np.asarray(grid.geometry.anchor)) / grid.fine_cell_size
        )
        edges32 = jnp.asarray(self.bin_edges, jnp.float32)
        cdf32 = jnp.asarray(self.spectrum_cdf, jnp.float32)

        n_dev = 1 if self.mesh is None else int(self.mesh.devices.size)
        per_dev = -(-self.n_photons // n_dev)
        n_total = per_dev * n_dev

        def mc_phase(key, chi_h, chi_he, xH, xHe, T32):
            """One device's MC share: emit ``per_dev`` packets, spectral
            trace, local reemission generations → [n_bins, C] leaf tally."""
            kb, ke, kl = jax.random.split(key, 3)
            xi = jax.random.uniform(kb, (per_dev,), jnp.float32)
            fbin = jnp.clip(
                jnp.searchsorted(cdf32, xi) - 1,
                0, self.n_bins - 1).astype(jnp.int32)
            px, py, pz, dx, dy, dz, tau, _, w = sources.emit_point_source(
                ke, per_dev, gpos)
            packets = traversal.make_spectral_packets(
                jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
                tau, w, sig_h_tab[fbin], sig_he_tab[fbin], fbin, fine_shape)

            leaf_tally, pk = trace_amr_spectral(
                grid, chi_h, chi_he, packets, n_bins=self.n_bins)

            if self.diffuse_field:
                # per-packet re-emission generations; absorption-site state
                # looked up on the fine lattice (shallow grids) or by
                # octree descent per packet (deep grids, owner=None)
                deep = grid.owner is None
                if deep:
                    from cmacionize_tpu.ops import amr_traversal

                    root_j, children_j = (
                        jnp.asarray(a) for a in grid.octree())
                    scale = 2.0 ** (-grid.max_level)
                else:
                    xH_f = grid.expand(xH).reshape(-1)
                    xHe_f = grid.expand(xHe).reshape(-1)
                    T_f = grid.expand(T32).reshape(-1)
                for gen in range(self.n_reemission_rounds):
                    kl, kr, kd, kt = jax.random.split(kl, 4)
                    if deep:
                        leaf = amr_traversal.leaf_of_positions(
                            root_j, children_j,
                            pk.px * scale, pk.py * scale, pk.pz * scale,
                            coarse_shape=tuple(grid.geometry.shape),
                            max_level=grid.max_level)
                        xH_at, xHe_at, T_at = xH[leaf], xHe[leaf], T32[leaf]
                    else:
                        flat = (
                            pk.cx * fine_shape[1] + pk.cy
                        ) * fine_shape[2] + pk.cz
                        flat = jnp.clip(flat, 0, xH_f.shape[0] - 1)
                        xH_at, xHe_at, T_at = xH_f[flat], xHe_f[flat], T_f[flat]
                    remask, new_freq, _hch = reemission_mod.reemit_batch(
                        kr, self.spectra, pk.absorbed, pk.sig_h, pk.sig_he,
                        xH_at, xHe_at, T_at, AHe)
                    ndx, ndy, ndz = sources.isotropic_directions(kd, pk.size)
                    ntau = sources.sample_tau_targets(kt, pk.size)
                    nbin = jnp.clip(
                        jnp.searchsorted(edges32, new_freq) - 1,
                        0, self.n_bins - 1).astype(jnp.int32)
                    pk = traversal.SpectralPacketBatch(
                        pk.px, pk.py, pk.pz, pk.cx, pk.cy, pk.cz,
                        ndx, ndy, ndz, ntau, pk.weight,
                        sig_h_tab[nbin], sig_he_tab[nbin], nbin,
                        remask, jnp.zeros_like(remask))
                    gen_tally, pk = trace_amr_spectral(
                        grid, chi_h, chi_he, pk, n_bins=self.n_bins)
                    leaf_tally = leaf_tally + gen_tally
            return leaf_tally

        dp_mc = None
        if self.mesh is not None:
            # photon-DP: replicated hierarchy, per-device emission and
            # reemission generations, per-leaf binned tallies psum'd
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
                leaf_tally = dp_mc(keys[1:], chi_h, chi_he, xH, xHe, T32)
            else:
                self.key, kit = jax.random.split(self.key)
                leaf_tally = mc_phase(kit, chi_h, chi_he, xH, xHe, T32)

            # binned per-leaf tallies → per-ion integrals (one matmul)
            integrals = traversal.spectral_tallies_to_ion_integrals(
                leaf_tally.reshape(-1),
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


class AMRIonizationSimulation:
    """Hydrogen-only MC photoionization on an AMR grid.

    The AMR counterpart of HOnlyIonizationSimulation: per iteration, expand
    leaf opacity → trace on the finest lattice → reduce tallies per leaf →
    per-leaf ionization balance on the compact [C] array.  Optionally
    re-refines the hierarchy every ``refinement_interval`` iterations with
    the current neutral fraction feeding the criterion (the reference
    applies its scheme inside reset_grid on the same cadence,
    /root/reference/src/AMRDensityGrid.hpp:204-220).
    """

    def __init__(
        self,
        geometry: GridGeometry,
        scheme,
        density_fn: Callable[[np.ndarray], np.ndarray],
        *,
        source_position: Tuple[float, float, float],
        luminosity: float,
        cross_section: float,
        recombination_rate: float,
        n_photons: int,
        max_level: int = 2,
        refinement_interval: int = 0,  # 0 → refine once at construction
        initial_neutral_fraction: float = 1.0e-6,
        seed: int = 42,
        mesh=None,
    ):
        self.mesh = mesh
        self.geometry = geometry
        self.scheme = scheme
        self.density_fn = density_fn
        self.source_position = source_position
        self.luminosity = luminosity
        self.cross_section = cross_section
        self.alpha = recombination_rate
        self.n_photons = n_photons
        self.max_level = max_level
        self.refinement_interval = refinement_interval
        self.key = jax.random.PRNGKey(seed)

        self.grid = build_amr_grid(
            geometry, scheme, density_fn, max_level=max_level
        )
        self.number_density = jnp.asarray(
            density_fn(self.grid.centers), jnp.float32
        )
        self.neutral_fraction = jnp.full(
            self.grid.n_cells, initial_neutral_fraction, jnp.float32
        )
        self.iteration = 0

    # -------------------------------------------------------------- restart

    def write_restart(self, manager) -> str:
        """Checkpoint the full driver state (cf. the reference's per-object
        write_restart_file chain, /root/reference/src/RestartManager.hpp:
        108-122 + AMRDensityGrid restart): the hierarchy is recorded as the
        per-level refined-cell coordinate lists, from which the exact tree
        (and owner map / octree tables) is rebuilt deterministically."""
        arrays = {
            "neutral_fraction": self.neutral_fraction,
            "rng_key": jax.random.key_data(self.key),
        }
        for lvl, coords in enumerate(self.grid.refined_coords):
            arrays[f"refined_coords_{lvl}"] = np.asarray(coords, np.int64)
        return manager.write(arrays, {
            "iteration": self.iteration,
            "n_refined_levels": len(self.grid.refined_coords),
        })

    def load_restart(self, filename: str) -> None:
        from cmacionize_tpu.io.restart import RestartManager

        arrays, scalars = RestartManager.load(filename)
        n_levels = int(scalars["n_refined_levels"])
        refined = tuple(
            np.asarray(arrays[f"refined_coords_{lvl}"], np.int64)
            for lvl in range(n_levels)
        )
        self.grid = rebuild_amr_grid_from_coords(
            self.geometry, self.max_level, refined, self.density_fn)
        self.number_density = jnp.asarray(
            self.density_fn(self.grid.centers), jnp.float32)
        self.neutral_fraction = jnp.asarray(arrays["neutral_fraction"])
        self.key = jnp.asarray(arrays["rng_key"])  # raw key, as PRNGKey makes
        self.iteration = int(scalars["iteration"])

    def _rebuild(self):
        """Re-refine with the current state feeding the criterion."""
        xn_leaf = np.asarray(self.neutral_fraction)
        old = self.grid

        def fractions_fn(centers):
            gc = (centers - np.asarray(old.geometry.anchor)) / old.fine_cell_size
            gi = np.clip(gc.astype(np.int64), 0,
                         np.asarray(old.fine_shape) - 1)
            leaf = old.owner[gi[:, 0], gi[:, 1], gi[:, 2]]
            return {"H_n": xn_leaf[leaf]}

        new = build_amr_grid(
            self.geometry, self.scheme, self.density_fn,
            max_level=self.max_level, fractions_fn=fractions_fn,
        )
        self.neutral_fraction = resample_leaf_values(
            old, new, self.neutral_fraction
        )
        self.grid = new
        self.number_density = jnp.asarray(
            self.density_fn(new.centers), jnp.float32
        )

    def run(self, n_iterations: int, restart_manager=None):
        """Run ``n_iterations`` MORE iterations (``self.iteration`` keeps
        the global count across resumes, so the regrid cadence survives a
        restart).  ``restart_manager``: optional io.restart.RestartManager
        — wall-clock-cadence checkpoints + SIGINT graceful stop."""
        from cmacionize_tpu.models import sources
        from cmacionize_tpu.ops import ionization, traversal
        from cmacionize_tpu.utils import signals

        if restart_manager is not None:
            signals.install()
        dp_trace, dp_grid = None, None
        n_total = self.n_photons
        if self.mesh is not None:
            n_dev = int(self.mesh.devices.size)
            per_dev = -(-self.n_photons // n_dev)
            n_total = per_dev * n_dev
        for _ in range(n_iterations):
            it = self.iteration
            if (
                self.refinement_interval
                and it > 0
                and it % self.refinement_interval == 0
            ):
                self._rebuild()
            grid = self.grid
            gpos = tuple(
                (np.asarray(self.source_position)
                 - np.asarray(self.geometry.anchor))
                / grid.fine_cell_size
            )
            chi_si = (
                self.number_density * self.neutral_fraction
                * self.cross_section
            )
            if self.mesh is not None:
                # photon data parallelism over the replicated hierarchy
                # (the reference's MPI mode for AMR grids,
                # IonizationSimulation.cpp:395-529); the traced program
                # closes over the octree tables, so regrids rebuild it
                if dp_grid is not grid:
                    from cmacionize_tpu.parallel.photon_dp import (
                        make_amr_dp_trace,
                    )

                    dp_trace = make_amr_dp_trace(
                        self.mesh, grid,
                        n_photons_per_device=per_dev, gpos=gpos,
                    )
                    dp_grid = grid
                keys = jax.random.split(self.key, n_dev + 1)
                self.key = keys[0]
                leaf_tally, n_escaped = dp_trace(keys[1:], chi_si)
            else:
                self.key, subkey = jax.random.split(self.key)
                px, py, pz, dx, dy, dz, tau, _, w = (
                    sources.emit_point_source(subkey, self.n_photons, gpos)
                )
                packets = traversal.make_packets(
                    jnp.stack([px, py, pz], 1), jnp.stack([dx, dy, dz], 1),
                    tau, w, grid.fine_shape,
                )
                leaf_tally, n_escaped = trace_amr(grid, chi_si, packets)
            # folded in float64 on host: luminosity alone overflows f32
            jfac = jnp.asarray(
                self.luminosity * self.cross_section
                / (n_total * np.asarray(grid.volumes, np.float64)),
                jnp.float32,
            )
            jH = leaf_tally * jfac
            self.neutral_fraction = ionization.hydrogen_neutral_fraction(
                jH, self.number_density, self.alpha
            )
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
        """∫(1 - x_n) dV over all leaves (m^3).

        Host float64: astrophysical cell volumes (~1e49 m^3) overflow f32.
        """
        xn = np.asarray(self.neutral_fraction, np.float64)
        return float(np.sum((1.0 - xn) * self.grid.volumes))
