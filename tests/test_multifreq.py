"""Integration tests for the multi-element (spectral) simulation driver."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_enable_x64", True)

from cmacionize_tpu.models import ions  # noqa: E402
from cmacionize_tpu.models.grid import GridGeometry  # noqa: E402
from cmacionize_tpu.models.multifreq_simulation import (  # noqa: E402
    MultiFreqConfig,
    MultiFreqIonizationSimulation,
)

PC = 3.086e16


def _config(**overrides):
    base = dict(
        geometry=GridGeometry(
            anchor=(-1.5 * PC,) * 3, sides=(3 * PC,) * 3, shape=(16, 16, 16)
        ),
        number_density=1e8,
        initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=1e49,
        spectrum_type="planck",
        spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15,
        n_photons=20000,
        n_iterations=6,
        abundances=dict(ions.DEFAULT_ABUNDANCES),
        do_temperature=True,
        minimum_iteration_number=2,
        diffuse_field=True,
        n_bins=64,
        n_reemission_rounds=3,
    )
    base.update(overrides)
    return MultiFreqConfig(**base)


def test_mini_lexington_runs_and_heats():
    sim = MultiFreqIonizationSimulation(_config(), seed=3)
    xion, T = sim.run()
    T = np.asarray(T)
    xH = np.asarray(xion["H_n"])
    # center cell: ionized HII region at ~10^4 K
    assert xH[8, 8, 8] < 0.1
    assert 5000.0 < T[8, 8, 8] < 25000.0
    # helium also ionized near the center for a 40 kK blackbody
    assert float(np.asarray(xion["He_n"])[8, 8, 8]) < 0.5
    # metal stage fractions are finite and within [0, 1]
    for name in ("N_n", "O_n", "S_p1", "C_p1", "Ne_p1"):
        vals = np.asarray(xion[name])
        assert np.all(np.isfinite(vals))
        assert np.all(vals >= 0.0) and np.all(vals <= 1.0 + 1e-9)


def test_monochromatic_matches_h_only_driver():
    # with a 13.6 eV monochromatic spectrum, zero He abundance and no
    # temperature calculation, the multifreq driver must reproduce the
    # dedicated H-only driver's Stromgren structure
    abund = dict(ions.DEFAULT_ABUNDANCES)
    abund["He"] = 0.0
    config = _config(
        spectrum_type="monochromatic",
        abundances=abund,
        do_temperature=False,
        diffuse_field=False,
        n_iterations=6,
        luminosity=2e49,
    )
    sim = MultiFreqIonizationSimulation(config, seed=11)
    xion, _ = sim.run()
    xH = np.asarray(xion["H_n"])

    from cmacionize_tpu.models.ionization_simulation import (
        HOnlyConfig,
        HOnlyIonizationSimulation,
    )
    from cmacionize_tpu.ops import cross_sections, recombination

    sigma = float(
        cross_sections.ion_cross_section(
            "H_n", np.asarray([float(sim.bin_centers[0])])
        )[0]
    )
    h_only = HOnlyIonizationSimulation(
        HOnlyConfig(
            geometry=config.geometry,
            number_density=config.number_density,
            temperature=config.initial_temperature,
            source_position=config.source_position,
            luminosity=config.luminosity,
            cross_section=sigma,
            recombination_rate=float(
                recombination.recombination_rate("H_n", config.initial_temperature)
            ),
            n_photons=config.n_photons,
            n_iterations=config.n_iterations,
        ),
        seed=11,
    )
    xH_ref = np.asarray(h_only.run())
    # same ionized-region size (within MC noise)
    v1 = (xH < 0.5).sum()
    v2 = (xH_ref < 0.5).sum()
    assert v1 == pytest.approx(v2, rel=0.2)


def test_f32_device_temperature_backend_matches_host():
    """`TemperatureCalculator: backend: f32-device`: the f32 solve must
    reproduce the f64 pipeline's temperature/ionization structure on a
    lexington-mini."""
    import numpy as np

    from cmacionize_tpu.models.grid import GridGeometry
    from cmacionize_tpu.models.multifreq_simulation import (
        MultiFreqConfig,
        MultiFreqIonizationSimulation,
    )

    pc = 3.086e16
    geometry = GridGeometry((-5 * pc,) * 3, (10 * pc,) * 3, (16, 16, 16))
    common = dict(
        geometry=geometry,
        number_density=1e8,
        initial_temperature=8000.0,
        source_position=(0.0, 0.0, 0.0),
        luminosity=4.26e49,
        spectrum_type="planck",
        spectrum_temperature=40000.0,
        spectrum_frequency=3.3e15,
        n_photons=30000,
        n_iterations=6,
        abundances={"He": 0.1, "C": 2.2e-4, "N": 4e-5, "O": 3.3e-4,
                    "Ne": 5e-5, "S": 9e-6},
        do_temperature=True,
        diffuse_field=False,
        n_bins=32,
    )
    sim_host = MultiFreqIonizationSimulation(
        MultiFreqConfig(**common, temperature_backend="f64-host"), seed=21)
    xion_h, T_h = sim_host.run(6)
    sim_dev = MultiFreqIonizationSimulation(
        MultiFreqConfig(**common, temperature_backend="f32-device"), seed=21)
    xion_d, T_d = sim_dev.run(6)

    T_h = np.asarray(T_h)
    T_d = np.asarray(T_d)
    r = np.sqrt((np.asarray(geometry.cell_centers()) ** 2).sum(-1)).ravel()
    ion = np.asarray(xion_h["H_n"]).ravel() < 0.5
    # same MC stream (same seed), only the solve differs: the ionized-zone
    # temperature structure must agree closely cell by cell
    rel = np.abs(T_d.ravel()[ion] - T_h.ravel()[ion]) / T_h.ravel()[ion]
    assert np.median(rel) < 5e-3, np.median(rel)
    assert np.quantile(rel, 0.95) < 3e-2, np.quantile(rel, 0.95)
    v_h = (np.asarray(xion_h["H_n"]) < 0.5).sum()
    v_d = (np.asarray(xion_d["H_n"]) < 0.5).sum()
    assert abs(v_d - v_h) <= max(0.02 * v_h, 5)
    o_h = np.asarray(xion_h["O_n"]).ravel()[ion]
    o_d = np.asarray(xion_d["O_n"]).ravel()[ion]
    np.testing.assert_allclose(np.median(o_d), np.median(o_h),
                               rtol=0.05, atol=1e-4)
