"""Collisionally-excited line cooling (10 five-level + 3 two-level ions).

Equivalent of the reference's LineCoolingData
(/root/reference/src/LineCoolingData.cpp): level populations of each coolant
ion follow from the statistical-equilibrium balance of collisional
(de-)excitation and radiative decay (Osterbrock & Ferland 2006 §3.5); the
radiated power per H atom is Σ n_i A_ij E_ij.

Design: instead of a per-cell 5×5 Gaussian elimination
(/root/reference/src/LineCoolingData.cpp:1492-1560), the level matrices for
ALL cells and all 10 five-level ions are assembled as a single
[..., 10, 5, 5] tensor and solved with one batched `jnp.linalg.solve` — the
per-ion loop is a tensor axis.

Atomic constants come from the repackaged tables
(cmacionize_tpu/data/linecooling.npz, see tools/repackage_linecooling_data.py
for provenance).  Computations default to float64 (enable jax x64) because
the level matrices mix scales of ~1e-10..1e5; call sites that run f32-only
pipelines can pass dtype=jnp.float32 at reduced accuracy.

Coolant index order (matching the reference enums):
    five-level: NI NII OI OII OIII NeIII SII SIII CII CIII   (0..9)
    two-level:  NIII NeII SIV                                (10..12)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from cmacionize_tpu import constants
from cmacionize_tpu.data import _load

N_FIVE = 10
N_TWO = 3
N_COOLANTS = N_FIVE + N_TWO

FIVE_NAMES = ("NI", "NII", "OI", "OII", "OIII", "NeIII", "SII", "SIII", "CII", "CIII")
TWO_NAMES = ("NIII", "NeII", "SIV")
COOLANT_NAMES = FIVE_NAMES + TWO_NAMES

# transition order: (lower, upper) pairs for the 10 transitions
TRANSITION_PAIRS = (
    (0, 1), (0, 2), (0, 3), (0, 4), (1, 2),
    (1, 3), (1, 4), (2, 3), (2, 4), (3, 4),
)

# collision strength prefactor h^2 / (sqrt(k) (2 pi m_e)^{3/2}), K^0.5 m^3/s,
# cf. /root/reference/src/LineCoolingData.cpp:1392
COLLISION_PREFACTOR = constants.PLANCK**2 / (
    np.sqrt(constants.BOLTZMANN)
    * (2.0 * np.pi * constants.ELECTRON_MASS) ** 1.5
)


def _tables():
    d = _load("linecooling.npz")
    return (
        d["five_A"], d["five_E"], d["five_invw"], d["five_gamma"],
        d["two_A"], d["two_E"], d["two_invw"], d["two_gamma"],
    )


def _collision_strengths(gamma, T, Tinv, logT):
    """Ω(T) fit: prefactorless part, vectorized.

    gamma [..., 7] coefficients; T broadcast to [..., cells].
    Form (cf. LineCoolingData.cpp:1589-1598):
        T^(1+g0) · (g1 + g2/T + g3·lnT + g4·T·(1 + (g5-1)·T^g6))
    """
    g0, g1, g2, g3, g4, g5, g6 = (gamma[..., k] for k in range(7))
    return T ** (1.0 + g0) * (
        g1 + g2 * Tinv + g3 * logT + g4 * T * (1.0 + (g5 - 1.0) * T**g6)
    )


_OMEGA_CACHE = {}


def _omega_tables():
    """f64 log-T tables of the collision-strength fits (f32 device path).

    The 7-coefficient Ω(T) fit (`_collision_strengths`) cancels
    catastrophically in f32 at T ≳ 2e4 K (measured up to 60x errors — the
    g4·T·(1+(g5−1)·T^g6) term is a big±big difference).  Ω is smooth in
    log T, so the f32 path evaluates the fit ONCE in f64 numpy on a
    512-point log grid (100 K … 1e10 K, the secant's full excursion range)
    and interpolates log Ω linearly on device — monotone, cancellation-free
    and cheaper than the transcendental fit."""
    if "grid" in _OMEGA_CACHE:
        return (_OMEGA_CACHE["grid"], _OMEGA_CACHE["five"],
                _OMEGA_CACHE["two"])
    import numpy as _np

    _, _, _, five_gamma, _, _, _, two_gamma = _tables()
    logT = _np.linspace(_np.log(1.0e2), _np.log(1.0e10), 512)
    T = _np.exp(logT)

    def fit(gamma, T):
        g = _np.asarray(gamma, _np.float64)
        g0, g1, g2, g3, g4, g5, g6 = (g[..., k] for k in range(7))
        Tb = T.reshape((-1,) + (1,) * g0.ndim)
        return Tb ** (1.0 + g0) * (
            g1 + g2 / Tb + g3 * _np.log(Tb)
            + g4 * Tb * (1.0 + (g5 - 1.0) * Tb ** g6)
        )

    five = _np.log(_np.maximum(fit(five_gamma, T), 1e-30))  # [512, 10, 10]
    two = _np.log(_np.maximum(fit(two_gamma, T), 1e-30))  # [512, 3]
    _OMEGA_CACHE.update(
        grid=_np.float32(logT),
        five=_np.float32(five),
        two=_np.float32(two),
    )
    return _OMEGA_CACHE["grid"], _OMEGA_CACHE["five"], _OMEGA_CACHE["two"]


def _omega_interp(T, table_key):
    """Device-side log-log interpolation of Ω (f32 path).

    T: [...] f32; returns [..., *table_dims]."""
    grid, five, two = _omega_tables()
    table = jnp.asarray(five if table_key == "five" else two)
    logT = jnp.log(jnp.clip(jnp.asarray(T, jnp.float32), 1.0e2, 1.0e10))
    g0 = float(grid[0])
    dg = float(grid[1] - grid[0])
    x = (logT - g0) / dg
    k = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, len(grid) - 2)
    frac = (x - k.astype(jnp.float32))[..., None, None] if table.ndim == 3         else (x - k.astype(jnp.float32))[..., None]
    lo = table[k]
    hi = table[k + 1]
    return jnp.exp(lo + frac * (hi - lo))


def five_level_populations(T, ne, dtype=jnp.float64):
    """Level populations [..., 10, 5] for all five-level coolants.

    T, ne: broadcastable cell arrays (K, m^-3).
    """
    five_A, five_E, five_invw, five_gamma = _tables()[:4]
    A = jnp.asarray(five_A, dtype)  # [10, 10]
    E = jnp.asarray(five_E, dtype)
    invw = jnp.asarray(five_invw, dtype)  # [10, 5]
    gamma = jnp.asarray(five_gamma, dtype)  # [10, 10, 7]

    T = jnp.asarray(T, dtype)[..., None, None]  # [..., 1(ion), 1(trans)]
    ne = jnp.asarray(ne, dtype)[..., None, None]
    Tinv = 1.0 / T
    logT = jnp.log(T)
    prefactor = jnp.asarray(COLLISION_PREFACTOR, dtype) * ne / jnp.sqrt(T)

    if dtype == jnp.float32:
        # cancellation-free tabulated fit (see _omega_tables)
        omega = _omega_interp(T[..., 0, 0], "five")
    else:
        omega = _collision_strengths(gamma, T, Tinv, logT)
    cs = prefactor * omega  # [...,10,10]
    rate_down = cs
    rate_up = cs * jnp.exp(-E * Tinv)

    batch = rate_down.shape[:-2]
    M = jnp.zeros(batch + (N_FIVE, 5, 5), dtype)
    # row 0: closure Σ n_i = 1
    M = M.at[..., 0, :].set(1.0)

    def A_(t):
        return A[:, t]

    def down(t):
        return rate_down[..., :, t]

    def up(t):
        return rate_up[..., :, t]

    iw = [invw[:, l] for l in range(5)]
    # transition indices
    T01, T02, T03, T04, T12, T13, T14, T23, T24, T34 = range(10)

    # balance rows for levels 1..4, cf. LineCoolingData.cpp:1605-1686
    M = M.at[..., 1, 0].set(up(T01) * iw[0])
    M = M.at[..., 1, 1].set(
        -(A_(T01) + iw[1] * (down(T01) + up(T12) + up(T13) + up(T14)))
    )
    M = M.at[..., 1, 2].set(A_(T12) + iw[2] * down(T12))
    M = M.at[..., 1, 3].set(A_(T13) + iw[3] * down(T13))
    M = M.at[..., 1, 4].set(A_(T14) + iw[4] * down(T14))

    M = M.at[..., 2, 0].set(up(T02) * iw[0])
    M = M.at[..., 2, 1].set(up(T12) * iw[1])
    M = M.at[..., 2, 2].set(
        -(A_(T02) + A_(T12) + iw[2] * (down(T02) + down(T12) + up(T23) + up(T24)))
    )
    M = M.at[..., 2, 3].set(A_(T23) + iw[3] * down(T23))
    M = M.at[..., 2, 4].set(A_(T24) + iw[4] * down(T24))

    M = M.at[..., 3, 0].set(up(T03) * iw[0])
    M = M.at[..., 3, 1].set(up(T13) * iw[1])
    M = M.at[..., 3, 2].set(up(T23) * iw[2])
    M = M.at[..., 3, 3].set(
        -(
            A_(T03) + A_(T13) + A_(T23)
            + iw[3] * (down(T03) + down(T13) + down(T23) + up(T34))
        )
    )
    M = M.at[..., 3, 4].set(A_(T34) + iw[4] * down(T34))

    M = M.at[..., 4, 0].set(up(T04) * iw[0])
    M = M.at[..., 4, 1].set(up(T14) * iw[1])
    M = M.at[..., 4, 2].set(up(T24) * iw[2])
    M = M.at[..., 4, 3].set(up(T34) * iw[3])
    M = M.at[..., 4, 4].set(
        -(
            A_(T04) + A_(T14) + A_(T24) + A_(T34)
            + iw[4] * (down(T04) + down(T14) + down(T24) + down(T34))
        )
    )

    b = jnp.zeros(batch + (N_FIVE, 5), dtype).at[..., 0].set(1.0)
    return solve5x5(M, b)  # [..., 10, 5]


def solve5x5(A, b):
    """Batched 5×5 linear solve by unrolled Gauss–Jordan with partial pivoting.

    Pure elementwise/where ops over the whole batch, in any float dtype.  Plays the
    role of the reference's hand-rolled elimination
    (/root/reference/src/LineCoolingData.cpp:1492-1560), batched over all
    cells and ions at once.
    """
    M = jnp.concatenate([A, b[..., None]], axis=-1)  # [..., 5, 6]
    row_idx = jnp.arange(5)
    for j in range(5):
        col = jnp.abs(M[..., :, j])
        col = jnp.where(row_idx >= j, col, -jnp.inf)
        p = jnp.argmax(col, axis=-1)  # [...]
        # swap rows j and p: perm[i] = p if i == j, j if i == p, else i
        perm = jnp.where(
            row_idx == j,
            p[..., None],
            jnp.where(row_idx == p[..., None], j, row_idx),
        )
        M = jnp.take_along_axis(M, perm[..., :, None], axis=-2)
        piv = M[..., j, j][..., None]  # [..., 1]
        row_j = M[..., j, :] / piv  # [..., 6]
        factors = M[..., :, j]  # [..., 5]
        elim = (row_idx != j).astype(M.dtype)
        M = M - (elim * factors)[..., :, None] * row_j[..., None, :]
        M = M.at[..., j, :].set(row_j)
    return M[..., :, 5]


def two_level_populations(T, ne, dtype=jnp.float64):
    """Second-level population [..., 3] for the two-level coolants
    (closed form, cf. LineCoolingData.cpp:1713-1765)."""
    _, _, _, _, two_A, two_E, two_invw, two_gamma = _tables()
    A = jnp.asarray(two_A, dtype)  # [3]
    E = jnp.asarray(two_E, dtype)
    invw = jnp.asarray(two_invw, dtype)  # [3, 2]
    gamma = jnp.asarray(two_gamma, dtype)  # [3, 7]

    T = jnp.asarray(T, dtype)[..., None]  # [..., 1(ion)]
    ne = jnp.asarray(ne, dtype)[..., None]
    Tinv = 1.0 / T
    logT = jnp.log(T)
    prefactor = jnp.asarray(COLLISION_PREFACTOR, dtype) * ne / jnp.sqrt(T)
    if dtype == jnp.float32:
        omega = _omega_interp(T[..., 0], "two")
    else:
        omega = _collision_strengths(gamma, T, Tinv, logT)
    cs = prefactor * omega  # [..., 3]
    Texp = jnp.exp(-E * Tinv)
    return cs * Texp * invw[:, 0] / (A + cs * (invw[:, 1] + Texp * invw[:, 0]))


def cooling_rate(T, ne, abundances, dtype=jnp.float64, scale=1.0):
    """Radiated power per H atom (W) x ``scale``, cf.
    LineCoolingData::get_cooling.

    abundances: [..., 13] coolant abundances (number relative to H), ordered
    as COOLANT_NAMES.  ``scale`` is folded into the Boltzmann prefactor so
    the f32 device solve keeps the result (and its never-zero floor) in
    normal f32 range.
    """
    five_A, five_E = _tables()[:2]
    A = jnp.asarray(five_A, dtype)
    E = jnp.asarray(five_E, dtype)
    pops = five_level_populations(T, ne, dtype)  # [..., 10, 5]

    # per-transition emitted power, summed into the upper level's column
    # cooling_ion = Σ_trans n_upper · A · E
    upper = jnp.asarray([pair[1] for pair in TRANSITION_PAIRS])
    n_upper = jnp.take_along_axis(
        pops, jnp.broadcast_to(upper, pops.shape[:-1] + (10,)), axis=-1
    )  # [..., 10, 10] population of the upper level of each transition
    five_cool = jnp.sum(n_upper * A * E, axis=-1)  # [..., 10]

    _, _, _, _, two_A, two_E, _, _ = _tables()
    two_pops = two_level_populations(T, ne, dtype)  # [..., 3]
    two_cool = two_pops * jnp.asarray(two_A, dtype) * jnp.asarray(two_E, dtype)

    per_ion = jnp.concatenate([five_cool, two_cool], axis=-1)  # [..., 13]
    total = jnp.asarray(constants.BOLTZMANN * scale, dtype) * jnp.sum(
        jnp.asarray(abundances, dtype) * per_ion, axis=-1
    )
    # never return exactly zero (the temperature iteration divides by it),
    # cf. LineCoolingData.cpp:1770-1774 — floor representable in the dtype
    # (1e-99 flushes to 0 in f32; in SCALED units 1e-35 corresponds to
    # 1e-61 W per H atom, far below any physical line cooling)
    floor = 1e-99 if dtype == jnp.float64 else 1e-35
    return jnp.maximum(total, floor)


def line_strengths(T, ne, abundances, dtype=jnp.float64):
    """Per-ion per-transition emitted power (W per H atom):
    ([..., 10, 10] five-level, [..., 3] two-level) —
    the get_line_strengths equivalent used by the emissivity calculator."""
    five_A, five_E = _tables()[:2]
    A = jnp.asarray(five_A, dtype)
    E = jnp.asarray(five_E, dtype)
    pops = five_level_populations(T, ne, dtype)
    upper = jnp.asarray([pair[1] for pair in TRANSITION_PAIRS])
    n_upper = jnp.take_along_axis(
        pops, jnp.broadcast_to(upper, pops.shape[:-1] + (10,)), axis=-1
    )
    ab = jnp.asarray(abundances, dtype)
    five = constants.BOLTZMANN * ab[..., :N_FIVE, None] * n_upper * A * E

    _, _, _, _, two_A, two_E, _, _ = _tables()
    two_pops = two_level_populations(T, ne, dtype)
    two = (
        constants.BOLTZMANN
        * ab[..., N_FIVE:]
        * two_pops
        * jnp.asarray(two_A, dtype)
        * jnp.asarray(two_E, dtype)
    )
    return five, two
