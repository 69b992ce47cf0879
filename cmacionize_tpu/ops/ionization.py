"""Photoionization equilibrium solvers (vectorized over cells).

Physics follows the reference IonizationStateCalculator
(/root/reference/src/IonizationStateCalculator.cpp): mean-intensity tallies
are normalized by jfac = L_tot / (W_tot · V_cell) into per-neutral-atom
photoionization rates j_ion [s^-1], then the balance equations are solved per
cell.  All solvers here are pure elementwise jnp functions, safe for f32 on
an accelerator (the hydrogen solution is written in a cancellation-free form instead of
the reference's two-branch Taylor fallback,
/root/reference/src/IonizationStateCalculator.cpp:805-820).
"""

from __future__ import annotations

import jax.numpy as jnp

# lower floor on neutral fractions, cf.
# /root/reference/src/IonizationStateCalculator.cpp:810 (1e-14)
NEUTRAL_FRACTION_FLOOR = 1.0e-14


def hydrogen_neutral_fraction(jH, nH, alphaH):
    """Solve jH·x = αH·nH·(1-x)² for the neutral fraction x ∈ (0, 1].

    With C = αH·nH/jH the physical root of C·x² - (2C+1)·x + C = 0 is written
    via its conjugate (the two roots multiply to 1), which is numerically
    stable for both the highly ionized (C → 0) and neutral (C → ∞) limits —
    no cancellation, so f32 is sufficient.

    Cells with no ionizing radiation (jH <= 0) or no gas stay fully neutral.
    """
    jH = jnp.asarray(jH)
    safe_j = jnp.where(jH > 0.0, jH, 1.0)
    C = alphaH * nH / safe_j
    x = 2.0 * C / (2.0 * C + 1.0 + jnp.sqrt(4.0 * C + 1.0))
    x = jnp.maximum(x, NEUTRAL_FRACTION_FLOOR)
    return jnp.where((jH > 0.0) & (nH > 0.0), x, 1.0)


def normalize_mean_intensity(tally, luminosity, total_weight, cell_volume):
    """Raw path-length tally Σ ℓσw [m³] → photoionization rate [s^-1].

    jfac = L / (W_tot · V_cell), cf.
    /root/reference/src/IonizationStateCalculator.cpp:519,545.
    """
    return tally * (luminosity / (total_weight * cell_volume))


# ---------------------------------------------------------------------------
# Coupled hydrogen–helium balance
# ---------------------------------------------------------------------------


def _tiny(x):
    """Division guard representable in the array's dtype (1e-300 collapses
    to 0 in f32, where flush-to-zero would defeat the guard)."""
    return 1e-300 if x.dtype == jnp.float64 else 1e-30


def hydrogen_helium_neutral_fractions(
    jH, jHe, nH, AHe, T, alphaH, alphaHe, n_iterations: int = 20
):
    """Coupled H-He photoionization equilibrium (vectorized, reference-exact).

    Replicates `compute_ionization_states_hydrogen_helium`
    (/root/reference/src/IonizationStateCalculator.cpp:649-760) *exactly*,
    including the iteration order, the Taylor-expansion branches of both
    quadratic solutions, the >10-iteration averaging damping, and the
    early-exit criterion (the loop stops as soon as either the hydrogen or
    the helium fraction stops changing by more than 1e-4 relative).  The
    per-cell while-loop becomes a masked lockstep loop: converged cells
    freeze while the rest continue.

    Exact replication matters: for stiff corner cells (jH orders of magnitude
    below jHe) the iteration terminates via the early-exit on a
    deterministic, method-defined iterate rather than a unique fixed point,
    and the reference's golden data encodes exactly that value.

    Run in float64 (the balance spans huge dynamic ranges).

    Returns (h0, he0) neutral fractions.
    """
    import jax as _jax

    jH = jnp.asarray(jH)
    safe_jH = jnp.where(jH > 0.0, jH, 1.0)
    safe_jHe = jnp.where(jHe > 0.0, jHe, 1.0)
    has_che = jHe > 0.0

    # effective He 2^1P recombination pumping the H-ionizing continuum
    alpha_e_2sP = 4.17e-20 * (T * 1.0e-4) ** (-0.861)
    ch1 = alphaH * nH / safe_jH
    ch2 = AHe * alpha_e_2sP * nH / safe_jH
    che = jnp.where(has_che, alphaHe * nH / safe_jHe, 0.0)

    sqrtT = jnp.sqrt(T)

    # initial guesses (reference :692-706)
    h0old = 0.99 * (1.0 - jnp.exp(-0.5 / ch1))
    h0 = 0.9 * h0old
    he0old = jnp.where(has_che, jnp.minimum(0.5 / jnp.maximum(che, _tiny(che)), 1.0), 1.0)
    he0 = jnp.zeros_like(h0)

    def converged(h0, h0old, he0, he0old):
        # loop CONTINUES while both change; stops when either settles
        dh = jnp.abs(h0 - h0old) > 1e-4 * h0old
        dhe = jnp.abs(he0 - he0old) > 1e-4 * he0old
        return ~(dh & dhe)

    def cond(state):
        niter, h0, h0old, he0, he0old, frozen = state
        return jnp.logical_and(niter < n_iterations, jnp.any(~frozen))

    def body(state):
        niter, h0, h0old, he0, he0old, frozen = state
        h0old_n = h0
        he0old_n = jnp.maximum(he0, 0.0)

        pHots = 1.0 / (
            1.0 + 77.0 * he0old_n / (sqrtT * jnp.maximum(h0old_n, _tiny(h0old_n)))
        )
        ch = ch1 - ch2 * AHe * (1.0 - he0old_n) * pHots / (1.0 - h0old_n)

        # helium quadratic with Taylor fallback (reference :715-731)
        bhe = (1.0 + 2.0 * AHe - h0) * che + 1.0
        che_bhe = che / bhe
        opAHeh0 = 1.0 + AHe - h0
        t1he = 4.0 * AHe * opAHeh0 * che_bhe * che_bhe
        disc_he = jnp.sqrt(
            jnp.maximum(bhe * bhe - 4.0 * AHe * opAHeh0 * che * che, 0.0)
        )
        he0_exact = (bhe - disc_he) / (2.0 * AHe * jnp.maximum(che, _tiny(che)))
        he0_new = jnp.where(t1he < 1e-3, opAHeh0 * che_bhe, he0_exact)
        he0_new = jnp.where(has_che, he0_new, 1.0)

        # hydrogen quadratic with Taylor fallback (reference :733-742)
        b = ch * (2.0 + AHe - he0_new * AHe) + 1.0
        ch_b = ch / b
        opA = 1.0 + AHe - he0_new * AHe
        t1 = 4.0 * ch_b * ch_b * opA
        disc_h = jnp.sqrt(jnp.maximum(b * b - 4.0 * ch * ch * opA, 0.0))
        sign_ch = jnp.where(ch >= 0, 1.0, -1.0)
        h0_exact = (b - disc_h) / (
            2.0 * sign_ch * jnp.maximum(jnp.abs(ch), _tiny(ch))
        )
        h0_new = jnp.where(t1 < 1e-3, ch_b * opA, h0_exact)

        # averaging damping (reference :744-747); niter here is 0-based while
        # the reference increments first, so reference `niter > 10` after
        # increment corresponds to this loop's iteration index >= 10
        damp = niter + 1 > 10
        h0_new = jnp.where(damp, 0.5 * (h0_new + h0old_n), h0_new)
        he0_new = jnp.where(damp, 0.5 * (he0_new + he0old_n), he0_new)

        # frozen cells keep their values
        h0_out = jnp.where(frozen, h0, h0_new)
        he0_out = jnp.where(frozen, he0, he0_new)
        h0old_out = jnp.where(frozen, h0old, h0old_n)
        he0old_out = jnp.where(frozen, he0old, he0old_n)
        frozen_out = frozen | converged(h0_out, h0old_out, he0_out, he0old_out)
        return (niter + 1, h0_out, h0old_out, he0_out, he0old_out, frozen_out)

    frozen0 = converged(h0, h0old, he0, he0old)
    state = (jnp.asarray(0), h0, h0old, he0, he0old, frozen0)
    _, h0, _, he0, _, _ = _jax.lax.while_loop(cond, body, state)

    # shortcut: negligible radiation -> fully neutral (reference :670-675).
    # NOTE: the result is intentionally NOT clipped to [0, 1] — the reference
    # stores and uses raw iterates (which can slightly exceed 1 for stiff
    # corner cells), and the heating/cooling balance golden data depends on
    # that behavior.  Clamp at the call site where physical fractions are
    # needed (e.g. before building opacities).
    neutral = jH < 1.0e-20
    h0 = jnp.where(neutral, 1.0, h0)
    he0 = jnp.where(neutral, 1.0, he0)
    return h0, he0


# ---------------------------------------------------------------------------
# Metal ionization chains (closed form)
# ---------------------------------------------------------------------------


def metal_ion_fractions(j, ne, T, nh0, nhe0, nhp, alphas):
    """Closed-form coupled metal ionization chains with charge transfer.

    Physics follows `compute_ionization_states_metals`
    (/root/reference/src/IonizationStateCalculator.cpp:323-510): for each
    element the stage ratios R(i+1, i) = j_i / (ne·α_i + CT terms) combine
    into normalized stage fractions.  Following the reference's storage
    convention, the returned fraction for slot "X_pk" is the fraction of the
    *next* stage (the photoionization product of X_pk); e.g. x["N_n"] is the
    N⁺ fraction and the N⁰ fraction is 1 - x[N_n] - x[N_p1] - x[N_p2].

    Args:
        j: dict name → photoionization rate field [cells] (s⁻¹)
        ne: electron density (m⁻³)
        nh0/nhe0/nhp: neutral H, neutral He, ionized H densities (m⁻³)
        alphas: dict name → recombination rate (m³/s, at T)

    Returns dict name → fraction field for the 12 metal slots.
    """
    from cmacionize_tpu.ops import charge_transfer as ct

    t4 = T * 1.0e-4
    safe_ne = jnp.maximum(ne, 1e-30)

    def ratio(name, with_ion_H=False):
        denom = safe_ne * alphas[name] + nh0 * ct.recombination_rate_H(name, t4)
        denom = denom + nhe0 * ct.recombination_rate_He(name, t4)
        numer = j[name]
        if with_ion_H:
            numer = numer + nhp * ct.ionization_rate_H(name, t4)
        return numer / jnp.maximum(denom, _tiny(denom))

    out = {}

    # carbon: stages C+ / C++ / C+++ tracked via slots C_p1, C_p2.
    # No CT term for C+ — negligible per the reference (:393-396)
    C21 = j["C_p1"] / jnp.maximum(safe_ne * alphas["C_p1"], _tiny(safe_ne))
    C32 = ratio("C_p2")
    C31 = C32 * C21
    invC = 1.0 / (1.0 + C21 + C31)
    out["C_p1"] = C21 * invC
    out["C_p2"] = C31 * invC

    # nitrogen
    N21 = ratio("N_n", with_ion_H=True)
    N32 = ratio("N_p1")
    N43 = ratio("N_p2")
    N31 = N32 * N21
    N41 = N43 * N31
    invN = 1.0 / (1.0 + N21 + N31 + N41)
    out["N_n"] = N21 * invN
    out["N_p1"] = N31 * invN
    out["N_p2"] = N41 * invN

    # oxygen
    O21 = ratio("O_n", with_ion_H=True)
    O32 = ratio("O_p1")
    O31 = O32 * O21
    invO = 1.0 / (1.0 + O21 + O31)
    out["O_n"] = O21 * invO
    out["O_p1"] = O31 * invO

    # neon
    Ne21 = j["Ne_n"] / jnp.maximum(safe_ne * alphas["Ne_n"], _tiny(safe_ne))
    Ne32 = ratio("Ne_p1")
    Ne31 = Ne32 * Ne21
    invNe = 1.0 / (1.0 + Ne21 + Ne31)
    out["Ne_n"] = Ne21 * invNe
    out["Ne_p1"] = Ne31 * invNe

    # sulphur
    S21 = ratio("S_p1")
    S32 = ratio("S_p2")
    S43 = ratio("S_p3")
    S31 = S32 * S21
    S41 = S43 * S31
    invS = 1.0 / (1.0 + S21 + S31 + S41)
    out["S_p1"] = S21 * invS
    out["S_p2"] = S31 * invS
    out["S_p3"] = S41 * invS

    return out
