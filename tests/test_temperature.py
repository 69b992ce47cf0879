"""Golden-data tests for the cooling/heating balance and temperature solve.

Reuses the reference's Fortran-validated fixtures
(/root/reference/test/ioneng_testdata.txt, tbal_testdata.txt) with the
protocol of testTemperatureCalculator.cpp.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

from cmacionize_tpu.models import ions  # noqa: E402
from cmacionize_tpu.ops import temperature  # noqa: E402

REF_TEST = "/root/reference/test"

# lexington abundances used by the fixture generator
# (testTemperatureCalculator.cpp:81)
ABUND = {"He": 0.1, "C": 2.2e-4, "N": 4.0e-5, "O": 3.3e-4, "Ne": 5.0e-5, "S": 9.0e-6}

METALS = tuple(ions.ION_NAMES[2:])


def _load(name):
    rows = []
    with open(os.path.join(REF_TEST, name)) as fh:
        for line in fh:
            if line.strip() and not line.strip().startswith("#"):
                rows.append([float(v) for v in line.split()])
    return np.asarray(rows)


pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_TEST), reason="reference not mounted"
)


def test_cooling_heating_balance_golden():
    data = _load("ioneng_testdata.txt")
    j = {name: data[:, i] for i, name in enumerate(ions.ION_NAMES)}
    hH = data[:, 14] * 1e-7  # erg/s -> W
    hHe = data[:, 15] * 1e-7
    T = data[:, 16]
    gain_exp = data[:, 17] * 0.1 * 1e-20  # erg cm^-3 s^-1 (x1e20) -> SI
    loss_exp = data[:, 18] * 0.1 * 1e-20
    n = data[:, 19] * 1e6  # cm^-3 -> m^-3
    h0_exp = data[:, 20]
    he0_exp = data[:, 21]
    metal_exp = {name: data[:, 22 + i] for i, name in enumerate(METALS)}

    bal = temperature.cooling_heating_balance(
        T, j, (hH, hHe), n, ABUND, pahfac=1.0, crfac=0.0
    )
    np.testing.assert_allclose(np.asarray(bal.h0), h0_exp, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(bal.he0), he0_exp, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(bal.gain), gain_exp, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(bal.loss), loss_exp, rtol=1e-3)
    for name in METALS:
        np.testing.assert_allclose(
            np.asarray(bal.metals[name]), metal_exp[name],
            rtol=1e-3, atol=1e-12, err_msg=name,
        )


def test_temperature_solve_golden():
    data = _load("tbal_testdata.txt")
    mask = data[:, 16] <= 30000.0  # skip high-T lines like the reference test
    data = data[mask]
    j = {name: data[:, i] for i, name in enumerate(ions.ION_NAMES)}
    hH = data[:, 14] * 1e-7
    hHe = data[:, 15] * 1e-7
    T_init = data[:, 16]
    n = data[:, 17] * 1e6
    h0_exp = np.minimum(data[:, 18], 1.0)
    he0_exp = data[:, 19]
    T_exp = np.minimum(data[:, 32], 30000.0)

    T, h0, he0, metals = temperature.solve_temperature(
        T_init, j, (hH, hHe), n, ABUND, pahfac=1.0, crfac=0.0
    )
    # iterative solves accumulate roundoff; reference test uses 1e-4,
    # we allow slightly more because the iteration strategy differs
    np.testing.assert_allclose(np.asarray(T), T_exp, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(h0), h0_exp, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(he0), he0_exp, rtol=2e-3)


def test_compacted_solve_bitwise_identical():
    """solve_temperature_compacted must reproduce the jitted lockstep solve
    bitwise (the secant state tuple is resumable on any cell subset —
    staging changes cost, not results).

    The reference is the JITTED full solve: that is what the production
    driver dispatches, and eager-vs-jit XLA compilations of the same loop
    legitimately differ in the last ulp (which the branchy secant can
    amplify for a few cells — measured 81/3000 cells differ between the
    two compilations while both satisfy the same convergence criterion)."""
    import functools

    import jax
    rng = np.random.default_rng(11)
    n_cells = 40000  # above the small-problem fallback threshold
    # a realistic mix: mostly-ionized cells, a neutral tail, a spread of
    # heating strengths — produces a skewed trip-count distribution
    jH = 10.0 ** rng.uniform(-14, -6, n_cells)
    scale = {"H_n": 1.0, "He_n": 0.7}
    j = {
        name: jH * scale.get(name, 10.0 ** rng.uniform(-3, 0))
        for name in ions.ION_NAMES
    }
    hH = jH * 10.0 ** rng.uniform(-19.0, -18.0, n_cells)
    h = (hH, 0.5 * hH)
    nd = 10.0 ** rng.uniform(6, 10, n_cells)
    T_init = 10.0 ** rng.uniform(2.0, 4.3, n_cells)

    ref_fn = jax.jit(functools.partial(
        temperature.solve_temperature, pahfac=1.0, crfac=0.0))
    ref = ref_fn(T_init, j, h, nd, ABUND)
    got = temperature.solve_temperature_compacted(
        T_init, j, h, nd, ABUND, pahfac=1.0, crfac=0.0,
        stage1_iterations=1)
    # the staging must actually have happened for this to test anything
    stats = temperature.LAST_COMPACTED_STATS
    assert stats["compactions"] > 0, stats
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
    for name in METALS:
        np.testing.assert_array_equal(
            np.asarray(got[3][name]), np.asarray(ref[3][name]),
            err_msg=name,
        )


class TestDeviceSolve:
    """f32-on-accelerator solve: the scale-lifted f32
    formulation must track the f64 goldens."""

    def test_balance_f32_scaled_matches_golden(self):
        data = _load("ioneng_testdata.txt")
        j = {name: np.float32(data[:, i])
             for i, name in enumerate(ions.ION_NAMES)}
        hH = np.float32(data[:, 14] * 1e-7)
        hHe = np.float32(data[:, 15] * 1e-7)
        T = np.float32(data[:, 16])
        gain_exp = data[:, 17] * 0.1 * 1e-20
        loss_exp = data[:, 18] * 0.1 * 1e-20
        n = np.float32(data[:, 19] * 1e6)
        S = temperature.DEVICE_SOLVE_SCALE

        bal = temperature.cooling_heating_balance(
            T, j, (hH, hHe), n, ABUND, pahfac=1.0, crfac=0.0, scale=S
        )
        assert np.asarray(bal.gain).dtype == np.float32
        np.testing.assert_allclose(
            np.asarray(bal.gain, np.float64) / S, gain_exp, rtol=2e-3)
        np.testing.assert_allclose(
            np.asarray(bal.loss, np.float64) / S, loss_exp, rtol=5e-3)
        np.testing.assert_allclose(
            np.asarray(bal.h0), np.float32(data[:, 20]), rtol=2e-3)

    def test_solve_f32_tracks_f64_golden(self):
        data = _load("tbal_testdata.txt")
        mask = data[:, 16] <= 30000.0
        data = data[mask]
        j = {name: data[:, i] for i, name in enumerate(ions.ION_NAMES)}
        hH = data[:, 14] * 1e-7
        hHe = data[:, 15] * 1e-7
        T_init = data[:, 16]
        n = data[:, 17] * 1e6
        h0_exp = np.minimum(data[:, 18], 1.0)
        T_exp = np.minimum(data[:, 32], 30000.0)

        T, h0, he0, metals = temperature.solve_temperature_device(
            T_init, j, (hH, hHe), n, ABUND, pahfac=1.0, crfac=0.0
        )
        assert np.asarray(T).dtype == np.float32
        # equilibrium T: with the tabulated-Omega fix the f32 secant lands
        # within 2e-3 of the Fortran-golden f64 answer (measured max
        # 1.1e-4; the slack covers platform variation)
        np.testing.assert_allclose(np.asarray(T), T_exp, rtol=2e-3)
        np.testing.assert_allclose(
            np.asarray(h0), h0_exp, rtol=2e-2, atol=1e-6)

    def test_solve_f32_tracks_f64_on_random_lexington_states(self):
        """Beyond the fixtures: a realistic spread of (j, h, nd) states —
        f32 device solve vs f64 reference solve, distributional check."""
        rng = np.random.default_rng(17)
        n_cells = 4096
        jH = 10.0 ** rng.uniform(-14, -7, n_cells)
        fac = {"H_n": 1.0, "He_n": 0.6, "C_p1": 0.2, "C_p2": 0.05,
               "N_n": 0.3, "N_p1": 0.1, "N_p2": 0.02, "O_n": 0.4,
               "O_p1": 0.1, "Ne_n": 0.2, "Ne_p1": 0.05, "S_p1": 0.1,
               "S_p2": 0.03, "S_p3": 0.01}
        j = {name: jH * f for name, f in fac.items()}
        hH = jH * 4.0e-19
        hHe = jH * 2.0e-19
        nd = np.full(n_cells, 1.0e8)
        T0 = np.full(n_cells, 8000.0)

        T64, h064, _, _ = temperature.solve_temperature(
            T0, j, (hH, hHe), nd, ABUND, pahfac=1.0)
        T32, h032, _, _ = temperature.solve_temperature_device(
            T0, j, (hH, hHe), nd, ABUND, pahfac=1.0)
        T64 = np.asarray(T64)
        T32 = np.asarray(T32, np.float64)
        rel = np.abs(T32 - T64) / T64
        # secant endpoints may disagree more for cells parked at the
        # 500 K floor / 30 kK cap boundary; the bulk must track closely
        assert np.median(rel) < 3e-3, np.median(rel)
        assert np.quantile(rel, 0.95) < 2e-2, np.quantile(rel, 0.95)
        np.testing.assert_allclose(
            np.asarray(h032, np.float64), np.asarray(h064), rtol=5e-2,
            atol=1e-6)
