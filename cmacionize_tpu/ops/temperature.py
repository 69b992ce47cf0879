"""Thermal equilibrium: coupled ionization + heating/cooling temperature solve.

Equivalent of the reference's TemperatureCalculator
(/root/reference/src/TemperatureCalculator.cpp): per cell, find T such that
photo-heating balances radiative cooling, with the ionization state of
H/He/metals recomputed self-consistently at each trial temperature.

Design: the reference's per-cell log-secant iteration with
bracketing evaluations at 0.9T/1.1T (:700-830) runs for ALL cells in lockstep
inside one `lax.while_loop`; converged cells freeze via masking.  Each
balance evaluation vectorizes the H–He fixed point, the closed-form metal
chains, the batched line-cooling solve, bremsstrahlung and recombination
cooling over the whole grid.

Runs in float64 (enable jax x64): the balance spans ~40 orders of magnitude.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from cmacionize_tpu.models import ions
from cmacionize_tpu.ops import ionization, line_cooling, recombination

# He Lyman-alpha on-the-spot heating energy: 21.2 eV - 13.6 eV (J),
# cf. TemperatureCalculator.cpp:310
HE_LYA_HEATING_ENERGY = 1.21765423e-18

_METAL_NAMES = tuple(ions.ION_NAMES[2:])

#: diagnostics of the last solve_temperature_compacted call (stage rounds,
#: live count at compaction) — read by benchmarks/tests
LAST_COMPACTED_STATS: dict = {}


class BalanceResult(NamedTuple):
    h0: jnp.ndarray
    he0: jnp.ndarray
    gain: jnp.ndarray
    loss: jnp.ndarray
    metals: dict  # name -> fraction field


def coolant_abundances(h0_unused, metals, abundances):
    """[..., 13] coolant abundances from metal-stage fractions.

    Mirrors the abund[] mapping at TemperatureCalculator.cpp:355-420 — note
    the reference's stage-fraction storage convention (see
    ionization.metal_ion_fractions).
    """
    A = abundances
    ab = [
        # NI, NII, OI... order = line_cooling.COOLANT_NAMES
        A["N"] * (1.0 - metals["N_n"] - metals["N_p1"] - metals["N_p2"]),  # NI
        A["N"] * metals["N_n"],  # NII
        A["O"] * (1.0 - metals["O_n"] - metals["O_p1"]),  # OI
        A["O"] * metals["O_n"],  # OII
        A["O"] * metals["O_p1"],  # OIII
        A["Ne"] * metals["Ne_p1"],  # NeIII
        A["S"] * (1.0 - metals["S_p1"] - metals["S_p2"] - metals["S_p3"]),  # SII
        A["S"] * metals["S_p1"],  # SIII
        A["C"] * (1.0 - metals["C_p1"] - metals["C_p2"]),  # CII
        A["C"] * metals["C_p1"],  # CIII
        A["N"] * metals["N_p1"],  # NIII
        A["Ne"] * metals["Ne_n"],  # NeII
        A["S"] * metals["S_p2"],  # SIV
    ]
    return jnp.stack(ab, axis=-1)


def cooling_heating_balance(
    T, j, h, nd, abundances, pahfac=0.0, crfac=0.0, scale=1.0
):
    """One balance evaluation at temperature field T.

    Args:
        T: [cells] temperature (K)
        j: dict ion name → photoionization rate [cells] (s⁻¹, already
           jfac-normalized)
        h: (hH, hHe) heating integrals [cells] (already hfac-normalized)
        nd: [cells] hydrogen number density (m⁻³)
        abundances: dict element → abundance (scalars)
        pahfac/crfac: PAH and cosmic-ray heating factors
        scale: common gain/loss prefactor folded into every COEFFICIENT
           (not applied after the fact): the secant uses gain/loss only in
           ratios, so a common scale cancels identically — but the f32
           device solve needs the 1e-40-class cooling coefficients lifted
           into f32 range BEFORE they multiply anything (f32 subnormals
           may be flushed to zero).  scale=1.0 reproduces f64 behavior exactly.

    Returns BalanceResult (cf. compute_cooling_and_heating_balance,
    TemperatureCalculator.cpp:200-500).
    """
    tiny = 1e-300 if jnp.asarray(T).dtype == jnp.float64 else 1e-30
    AHe = abundances.get("He", 0.0)
    alphaH = recombination.recombination_rate("H_n", T)
    alphaHe = recombination.recombination_rate("He_n", T)

    h0, he0 = ionization.hydrogen_helium_neutral_fractions(
        j["H_n"], j["He_n"], nd, AHe, T, alphaH, alphaHe
    )
    ne = nd * (1.0 - h0 + AHe * (1.0 - he0))
    nhp = nd * (1.0 - h0)
    nhep = nd * AHe * (1.0 - he0)
    nenhp = ne * nhp
    nenhep = ne * nhep
    sqrtT = jnp.sqrt(T)
    logT = jnp.log(T)
    T4 = T * 1e-4

    # --- heating (TemperatureCalculator.cpp:295-332)
    hH, hHe = h
    gain = nd * ((hH * scale) * h0 + (hHe * scale) * AHe * he0)
    alpha_e_2sP = 4.17e-20 * T4 ** (-0.861)
    pHots = 1.0 / (1.0 + 77.0 * he0 / (sqrtT * jnp.maximum(h0, tiny)))
    gain = gain + pHots * (HE_LYA_HEATING_ENERGY * scale) * alpha_e_2sP * nenhep
    gain = gain + (1.5e-37 * scale) * nd * ne * pahfac
    if crfac > 0.0:
        gain = gain + crfac * (1.2e-25 * scale) / jnp.sqrt(
            jnp.maximum(ne, tiny))

    # --- metal ionization (for coolant abundances)
    alphas = {name: recombination.recombination_rate(name, T) for name in _METAL_NAMES}
    j_metals = {name: j[name] for name in _METAL_NAMES}
    metals = ionization.metal_ion_fractions(
        j_metals, ne, T, nd * h0, nd * he0 * AHe, nhp, alphas
    )

    # --- cooling (TemperatureCalculator.cpp:422-500)
    abund = coolant_abundances(h0, metals, abundances)
    dtype = jnp.asarray(T).dtype
    loss = line_cooling.cooling_rate(
        T, ne, abund, dtype=dtype, scale=scale) * nd
    cgaunt = 5.5 - logT
    gff = 1.1 + 0.34 * jnp.exp(-cgaunt * cgaunt / 3.0)
    loss = loss + (1.42e-40 * scale) * gff * sqrtT * (nenhp + nenhep)
    loss = loss + (2.85e-40 * scale) * nenhp * sqrtT * (
        5.914 - 0.5 * logT + 0.01184 * jnp.cbrt(T)
    )
    loss = loss + (1.55e-39 * scale) * nenhep * T**0.3647

    return BalanceResult(
        h0=h0,
        he0=he0,
        gain=jnp.maximum(gain, 0.0),
        loss=jnp.maximum(loss, 0.0),
        metals=metals,
    )


def _secant_start_state(T_init):
    """Fresh per-cell secant state tuple (resumable — see _secant_loop)."""
    T0 = jnp.where(T_init <= 4000.0, 8000.0, T_init)
    zeros = jnp.zeros_like(T0)
    return (
        T0,
        jnp.ones_like(T0),  # gain0 = 1
        zeros,  # loss0 = 0
        jnp.zeros_like(T0, dtype=bool),  # frozen
        zeros,  # h0
        zeros,  # he0
        tuple(zeros for _ in _METAL_NAMES),
    )


def _secant_loop(
    cell_state,
    j,
    h,
    nd,
    abundances,
    pahfac,
    crfac,
    epsilon,
    max_iterations,
    minimum_ionized_temperature,
    scale=1.0,
):
    """Run up to ``max_iterations`` lockstep secant sweeps.

    ``cell_state`` is the (T, gain, loss, frozen, h0, he0, metals) per-cell
    tuple; the body is memoryless given it, so a capped run can be RESUMED
    on any subset of cells (gather the state, continue, scatter back) with
    per-cell results identical to the uninterrupted full-width solve —
    the property the width-compacting wrapper below relies on.
    """
    logtt = jnp.log(1.1 / 0.9)
    tiny = (1e-300 if jnp.asarray(cell_state[0]).dtype == jnp.float64
            else 1e-30)

    def eval_balance(T):
        return cooling_heating_balance(
            T, j, h, nd, abundances, pahfac, crfac, scale)

    def metals_tuple(metals):
        return tuple(metals[name] for name in _METAL_NAMES)

    def cond(state):
        niter, frozen = state[0], state[4]
        return jnp.logical_and(niter < max_iterations, jnp.any(~frozen))

    def body(state):
        niter, T0, gain0, loss0, frozen, h0, he0, metals = state
        bal1 = eval_balance(1.1 * T0)
        bal2 = eval_balance(0.9 * T0)
        bal0 = eval_balance(T0)

        def log_ratio(a, b):
            # log(a/b) with the reference's 0-handling (:755-792)
            return jnp.where(
                b > 0.0,
                jnp.where(a > 0.0, jnp.log(jnp.maximum(a, tiny) / b), -99.0),
                jnp.where(a > 0.0, 99.0, 0.0),
            )

        expgain = log_ratio(bal1.gain, bal2.gain)
        exploss = log_ratio(bal1.loss, bal2.loss)
        expdiff = expgain - exploss
        good = (bal0.gain > 0.0) & (expdiff != 0.0)
        ratio = bal0.loss / jnp.maximum(bal0.gain, tiny)
        T_new = jnp.where(
            good,
            T0 * jnp.exp(jnp.clip(logtt / jnp.where(good, expdiff, 1.0), -50, 50)
                         * jnp.log(jnp.maximum(ratio, tiny))),
            1.1 * T0,
        )

        # bounds: neutral floor / ionized cap force convergence (:802-822)
        went_cold = T_new < minimum_ionized_temperature
        went_hot = T_new > 1e10
        T_new = jnp.where(went_cold, 500.0, jnp.where(went_hot, 1e10, T_new))
        h0_new = jnp.where(went_cold, 1.0, jnp.where(went_hot, 1e-10, bal0.h0))
        he0_new = jnp.where(went_cold, 1.0, jnp.where(went_hot, 1e-10, bal0.he0))
        forced = went_cold | went_hot
        gain_new = jnp.where(forced, 1.0, bal0.gain)
        loss_new = jnp.where(forced, 1.0, bal0.loss)

        # frozen cells keep all their values (reference loop exited for them)
        T_out = jnp.where(frozen, T0, T_new)
        h0_out = jnp.where(frozen, h0, h0_new)
        he0_out = jnp.where(frozen, he0, he0_new)
        gain_out = jnp.where(frozen, gain0, gain_new)
        loss_out = jnp.where(frozen, loss0, loss_new)
        metals_out = tuple(
            jnp.where(frozen, old, new)
            for old, new in zip(metals, metals_tuple(bal0.metals))
        )
        # a cell freezes once the reference's top-of-loop check would exit:
        # |gain - loss| <= eps * gain, using the values just computed
        frozen_out = frozen | (
            jnp.abs(gain_out - loss_out)
            <= epsilon * jnp.maximum(gain_out, tiny)
        )
        return (
            niter + 1, T_out, gain_out, loss_out, frozen_out,
            h0_out, he0_out, metals_out,
        )

    out = jax.lax.while_loop(cond, body, (jnp.asarray(0),) + cell_state)
    return out[1:]


def _temperature_fixups(T0, h0, he0, metals, j):
    """Post-conditions (TemperatureCalculator.cpp:832-930): 30 kK cap (He CT
    validity), neutral/ionized physical-sense overrides, metal cleanup."""
    T0 = jnp.minimum(T0, 30000.0)
    no_jH = j["H_n"] <= 0.0
    no_jHe = j["He_n"] <= 0.0
    h0 = jnp.where(no_jH, 1.0, h0)
    he0 = jnp.where(no_jHe, 1.0, he0)
    ionized = h0 <= 1e-10
    metals = dict(metals)
    for name in _METAL_NAMES:
        metals[name] = jnp.where(no_jH | ionized, 0.0, metals[name])
    return T0, h0, he0, metals


def solve_temperature(
    T_init,
    j,
    h,
    nd,
    abundances,
    pahfac=0.0,
    crfac=0.0,
    epsilon: float = 1e-3,
    max_iterations: int = 100,
    minimum_ionized_temperature: float = 4000.0,
):
    """Log-secant equilibrium temperature solve for all cells in lockstep.

    Returns (T, h0, he0, metals) with the reference's post-conditions applied:
    T capped at 30 kK (He CT validity), neutral cells at 500 K, fully-ionized
    metal cleanup (cf. TemperatureCalculator.cpp:832-930).
    """
    out = _secant_loop(
        _secant_start_state(T_init), j, h, nd, abundances, pahfac, crfac,
        epsilon, max_iterations, minimum_ionized_temperature,
    )
    T0, _, _, _, h0, he0, metals_t = out
    metals = dict(zip(_METAL_NAMES, metals_t))
    return _temperature_fixups(T0, h0, he0, metals, j)


@functools.partial(
    jax.jit,
    static_argnames=(
        "pahfac", "crfac", "epsilon", "max_iterations", "min_T",
    ),
)
def _secant_stage_jit(state, j, h, nd, abundances, *, pahfac, crfac,
                      epsilon, max_iterations, min_T):
    return _secant_loop(
        state, j, h, nd, abundances, pahfac, crfac, epsilon,
        max_iterations, min_T,
    )


#: coefficient prefactor for the f32 device solve: lifts the 1e-40-class
#: cooling coefficients into f32 normal range (subnormals may flush);
#: gain and loss carry the SAME factor, and the secant uses them only in
#: ratios and a relative convergence test, so the factor cancels exactly
DEVICE_SOLVE_SCALE = 1.0e26


@functools.partial(
    jax.jit,
    static_argnames=(
        "pahfac", "crfac", "epsilon", "max_iterations",
        "minimum_ionized_temperature",
    ),
)
def solve_temperature_device(
    T_init,
    j,
    h,
    nd,
    abundances,
    pahfac=0.0,
    crfac=0.0,
    epsilon: float = 1e-3,
    max_iterations: int = 100,
    minimum_ionized_temperature: float = 4000.0,
):
    """float32 temperature solve (``TemperatureCalculator: backend:
    f32-device``).

    Same algorithm as :func:`solve_temperature`, run in float32 with every
    gain/loss coefficient pre-scaled by :data:`DEVICE_SOLVE_SCALE` so no
    term leaves f32 range (the balance spans ~40 orders of magnitude in
    SI; the scale-invariance of the log-secant makes the reformulation
    exact up to f32 rounding).  Validated against the f64 goldens in
    tests/test_temperature.py::TestDeviceSolve.

    Returns (T, h0, he0, metals) in float32 on the default backend.
    """
    f32 = jnp.float32
    conv = lambda a: jnp.asarray(a, f32)  # noqa: E731
    j32 = {k: conv(v) for k, v in j.items()}
    h32 = (conv(h[0]), conv(h[1]))
    out = _secant_loop(
        _secant_start_state(conv(T_init)), j32, h32, conv(nd), abundances,
        pahfac, crfac, epsilon, max_iterations,
        minimum_ionized_temperature, scale=DEVICE_SOLVE_SCALE,
    )
    T0, _, _, _, h0, he0, metals_t = out
    metals = dict(zip(_METAL_NAMES, metals_t))
    return _temperature_fixups(T0, h0, he0, metals, j32)


def solve_temperature_device_chunked(
    T_init,
    j,
    h,
    nd,
    abundances,
    pahfac=0.0,
    crfac=0.0,
    epsilon: float = 1e-3,
    max_iterations: int = 100,
    minimum_ionized_temperature: float = 4000.0,
    chunk: int = 32768,
):
    """Fixed-chunk driver for :func:`solve_temperature_device`.

    One 2^15-cell chunk compiles once (cached by shape) and is reused for
    every chunk of every iteration; chunking bounds the live workspace
    memory (the [n,10,5,5] level-population workspaces).  Per-cell results
    identical to the unchunked call
    (the solve is embarrassingly per-cell).  Returns f32 arrays of
    T_init's shape."""
    shape = jnp.asarray(T_init).shape
    n = int(np.prod(shape))
    if n <= chunk:
        T, h0, he0, metals = solve_temperature_device(
            T_init, j, h, nd, abundances, pahfac, crfac, epsilon,
            max_iterations, minimum_ionized_temperature)
        return (T.reshape(shape), h0.reshape(shape), he0.reshape(shape),
                {k: v.reshape(shape) for k, v in metals.items()})
    pad = (-n) % chunk
    flat = lambda a: jnp.concatenate(  # noqa: E731
        [jnp.ravel(jnp.asarray(a, jnp.float32)),
         jnp.zeros((pad,), jnp.float32)]) if pad else jnp.ravel(
        jnp.asarray(a, jnp.float32))
    Tf = flat(T_init)
    jf = {k: flat(v) for k, v in j.items()}
    hf = (flat(h[0]), flat(h[1]))
    # padding cells get nd of 1 (not 0: degenerate) and j=h=0 → they relax
    # to the neutral floor and are discarded
    ndf = flat(nd)
    if pad:
        ndf = ndf.at[n:].set(1.0)
        Tf = Tf.at[n:].set(8000.0)
    outs = []
    for c0 in range(0, n + pad, chunk):
        sl = slice(c0, c0 + chunk)
        outs.append(solve_temperature_device(
            Tf[sl], {k: v[sl] for k, v in jf.items()},
            (hf[0][sl], hf[1][sl]), ndf[sl], abundances, pahfac, crfac,
            epsilon, max_iterations, minimum_ionized_temperature))
    T = jnp.concatenate([o[0] for o in outs])[:n].reshape(shape)
    h0 = jnp.concatenate([o[1] for o in outs])[:n].reshape(shape)
    he0 = jnp.concatenate([o[2] for o in outs])[:n].reshape(shape)
    metals = {
        name: jnp.concatenate(
            [o[3][name] for o in outs])[:n].reshape(shape)
        for name in _METAL_NAMES
    }
    return T, h0, he0, metals


def solve_temperature_compacted(
    T_init,
    j,
    h,
    nd,
    abundances,
    pahfac=0.0,
    crfac=0.0,
    epsilon: float = 1e-3,
    max_iterations: int = 100,
    minimum_ionized_temperature: float = 4000.0,
    stage1_iterations: int = 8,
):
    """Width-compacting staged temperature solve — per-cell results
    IDENTICAL to the jitted :func:`solve_temperature` (unit-tested
    bitwise).

    The lockstep secant pads every cell to the worst-case trip count: one
    while iteration costs 3 full-grid balance evaluations even when a
    fraction of cells remain unconverged.  This wrapper runs capped sweeps and, after each cap,
    re-gathers the unconverged cells into the smallest sufficient
    power-of-two buffer whenever that at least halves the working width.
    The secant state tuple is explicitly resumable (see _secant_loop), so
    staging changes cost, not results.  Host-coordinated (one live-count
    readback per stage); one jitted kernel per distinct width, cached
    across calls.
    """
    shape = T_init.shape
    n = T_init.size
    if n <= 4096:  # too small for staging to pay
        return solve_temperature(
            T_init, j, h, nd, abundances, pahfac, crfac, epsilon,
            max_iterations, minimum_ionized_temperature,
        )
    jf = {k: jnp.ravel(v) for k, v in j.items()}
    hf = (jnp.ravel(h[0]), jnp.ravel(h[1]))
    ndf = jnp.ravel(nd)
    statics = dict(
        pahfac=float(pahfac), crfac=float(crfac), epsilon=float(epsilon),
        min_T=float(minimum_ionized_temperature),
    )

    def gather(tree, idx):
        return tuple(
            tuple(m[idx] for m in f) if isinstance(f, tuple) else f[idx]
            for f in tree
        )

    def scatter(full, idx, sub):
        return tuple(
            tuple(m.at[idx].set(sm) for m, sm in zip(f, sf))
            if isinstance(f, tuple) else f.at[idx].set(sf)
            for f, sf in zip(full, sub)
        )

    # Measured on a REAL lexington 32^3 mid-convergence state: ~60% of
    # cells freeze within 8 sweeps but ~40% run to the 100-sweep cap, so a
    # fixed deep shrink never triggers.  The width therefore adapts: after
    # each capped stage the live count is read back, and whenever the
    # smallest sufficient power-of-two width halves the current one, the
    # live cells are re-gathered (with the frozen rows scattered back
    # first).  Each distinct width compiles one stage kernel (cached).
    full_state = _secant_start_state(jnp.ravel(T_init))
    full_j, full_h, full_nd = jf, hf, ndf
    idx = None  # None → operating at full width
    state, sj, sh, snd = full_state, jf, hf, ndf
    width = n
    iters_done = 0
    rounds = 0
    compactions = 0
    chunk2 = 3 * stage1_iterations  # longer chunks once the width settled
    global LAST_COMPACTED_STATS
    LAST_COMPACTED_STATS = {"n": n, "widths": [n], "iters": 0}
    while iters_done < max_iterations:
        cap = min(stage1_iterations if rounds == 0 else chunk2,
                  max_iterations - iters_done)
        state = _secant_stage_jit(
            state, sj, sh, snd, abundances, max_iterations=cap, **statics)
        iters_done += cap
        rounds += 1
        live = int(jnp.sum(~state[3]))  # host sync: one readback per stage
        if live == 0 or iters_done >= max_iterations:
            break
        want = max(1 << int(np.ceil(np.log2(max(live, 1)))), 1024)
        if want <= width // 2:
            # write everything (frozen included) back, then re-gather the
            # live rows padded to the new width — resumption is exact
            if idx is not None:
                full_state = scatter(full_state, idx, state)
                frozen_full = full_state[3]
            else:
                full_state = state
                frozen_full = state[3]
            idx = jnp.argsort(frozen_full, stable=True)[:want]
            state = gather(full_state, idx)
            sj = {k: v[idx] for k, v in full_j.items()}
            sh = (full_h[0][idx], full_h[1][idx])
            snd = full_nd[idx]
            width = want
            compactions += 1
            LAST_COMPACTED_STATS["widths"].append(width)
    if idx is not None:
        full_state = scatter(full_state, idx, state)
    else:
        full_state = state
    LAST_COMPACTED_STATS.update(
        iters=iters_done, rounds=rounds, compactions=compactions,
        live_final=int(jnp.sum(~full_state[3])),
    )

    T0, _, _, _, h0, he0, metals_t = full_state
    metals = dict(zip(_METAL_NAMES, metals_t))
    T0, h0, he0, metals = _temperature_fixups(T0, h0, he0, metals, jf)
    reshape = lambda a: a.reshape(shape)  # noqa: E731
    return (
        reshape(T0), reshape(h0), reshape(he0),
        {k: reshape(v) for k, v in metals.items()},
    )
