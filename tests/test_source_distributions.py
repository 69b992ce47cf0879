"""Time-dependent source distributions, UV luminosity functions, freq bins.

Mirrors the reference's testCaproniPhotonSourceDistribution /
testDiscPatchPhotonSourceDistribution-style checks: population statistics
and update/feedback semantics rather than bitwise RNG agreement (the RNG is
threefry/PCG here, RANLXD there).
"""

import numpy as np
import pytest

from cmacionize_tpu.models.source_distributions import (
    AsciiFileTableSourceDistribution,
    CaproniSourceDistribution,
    DiscPatchSourceDistribution,
    DwarfGalaxySourceDistribution,
    IMFBasedUVLuminosityFunction,
    LevelFrequencyBins,
    LinearFrequencyBins,
    RateBasedUVLuminosityFunction,
    SILCCSourceDistribution,
    SingleSupernovaSourceDistribution,
    deposit_supernova_energy,
)

MYR = 3.1536e13


def test_silcc_geometry():
    dist = SILCCSourceDistribution(num_sources=2000, seed=7)
    s = dist.source_set()
    assert s.positions.shape == (2000, 3)
    # uniform in the xy patch
    assert np.all(s.positions[:, 0] >= dist.anchor_x)
    assert np.all(s.positions[:, 0] <= dist.anchor_x + dist.sides_x)
    # Gaussian in z: sample std within 10% of the scale height
    assert np.std(s.positions[:, 2]) == pytest.approx(
        dist.scaleheight_z, rel=0.1)
    assert dist.total_luminosity == pytest.approx(2000 * dist.luminosity)
    assert dist.update(1e15) is False  # static distribution


def test_disc_patch_birth_death_statistics():
    dist = DiscPatchSourceDistribution(
        lifetime=20 * MYR, average_number=40, update_interval=0.1 * MYR,
        seed=3)
    n0 = len(dist.source_set().luminosities)
    assert n0 == 40
    # evolve for several lifetimes: population stays near the average
    counts = []
    for step in range(1, 201):
        dist.update(step * MYR)
        counts.append(len(dist.source_set().luminosities))
    assert 20 < np.mean(counts) < 60
    # sources die: the initial set must have turned over completely
    dist2 = DiscPatchSourceDistribution(
        lifetime=1 * MYR, average_number=5, update_interval=0.5 * MYR, seed=3)
    p0 = dist2.source_set().positions.copy()
    dist2.update(10 * MYR)
    p1 = dist2.source_set().positions
    if len(p0) and len(p1):
        assert not np.any([np.any(np.all(p0 == q, axis=1)) for q in p1])


def test_dwarf_galaxy_profile():
    dist = DwarfGalaxySourceDistribution(
        average_number=400, scale_radius=5e18, center=(1e18, 0, 0), seed=11)
    p = dist.source_set().positions
    assert np.mean(p[:, 0]) == pytest.approx(1e18, abs=1.5e18)
    assert np.std(p[:, 1]) == pytest.approx(5e18, rel=0.25)


def test_single_supernova_explodes_once():
    dist = SingleSupernovaSourceDistribution(
        position=(1.0, 2.0, 3.0), lifetime=10 * MYR, luminosity=1e49)
    assert dist.total_luminosity == 1e49
    assert dist.update(5 * MYR) is False
    assert dist.pop_supernovae() == []
    assert dist.update(11 * MYR) is True
    sne = dist.pop_supernovae()
    assert len(sne) == 1 and np.allclose(sne[0], [1.0, 2.0, 3.0])
    # after the explosion: no sources, no repeat SN
    assert dist.source_set().positions.shape[0] == 0
    assert dist.update(20 * MYR) is False
    assert dist.pop_supernovae() == []


def test_caproni_population_tracks_number_function():
    dist = CaproniSourceDistribution(seed=42, update_interval=MYR)
    # the t=0 polynomial expects ~431 massive stars
    assert dist._n_stars(0.0) == 431
    n_total = len(dist._lifetimes)
    assert n_total == 431
    # UV-luminous subset: only stars above the OB mass limit shine
    s = dist.source_set()
    assert 0 < len(s.luminosities) < n_total
    assert np.all(s.luminosities > 0)
    # evolve 100 Myr: SNe must have fired and population follows N(t)
    dist.update(100 * MYR)
    sne = dist.pop_supernovae()
    assert len(sne) > 0
    expected = dist._n_stars(100 * MYR)
    assert len(dist._lifetimes) == pytest.approx(expected, rel=0.05)


def test_caproni_stellar_fits_physical():
    dist = CaproniSourceDistribution()
    # lifetimes decrease with mass; 20 Msol ~ 10 Myr, 100 Msol ~ 3 Myr
    t20 = dist.stellar_lifetime(20.0)
    t100 = dist.stellar_lifetime(100.0)
    assert t100 < t20
    assert 5 * MYR < t20 < 15 * MYR
    assert MYR < t100 < 5 * MYR
    # UV luminosity increases with mass, zero below the OB limit
    assert dist.stellar_uv_luminosity(10.0) == 0.0
    l20 = dist.stellar_uv_luminosity(20.0)
    l60 = dist.stellar_uv_luminosity(60.0)
    assert 0 < l20 < l60
    assert 1e47 < l20 < 1e50
    # IMF masses stay within [SN limit, stellar mass limit]
    masses = [dist.random_stellar_mass() for _ in range(500)]
    assert min(masses) >= 8.0 and max(masses) <= 100.0
    # steep IMF: median mass near the low end
    assert np.median(masses) < 20.0


def test_ascii_file_table_switching(tmp_path):
    list0 = tmp_path / "s0.txt"
    list0.write_text("# x y z L\n0. 0. 0. 1e49\n")
    list1 = tmp_path / "s1.txt"
    list1.write_text("1. 1. 1. 2e49\n2. 2. 2. 1e49\n")
    table = tmp_path / "table.txt"
    table.write_text(f"# t file\n0.0 {list0}\n{5 * MYR} {list1}\n")

    dist = AsciiFileTableSourceDistribution(str(table))
    assert dist.source_set().positions.shape[0] == 1
    assert dist.update(MYR) is False
    assert dist.update(6 * MYR) is True
    s = dist.source_set()
    assert s.positions.shape[0] == 2
    assert s.total_luminosity == pytest.approx(3e49)


def test_deposit_supernova_energy():
    import jax.numpy as jnp

    class Geom:
        def position_to_grid_coords(self, p):
            return p / 1e18 * 4.0  # 4 cells per 1e18 m

    field = jnp.zeros((8, 8, 8))
    out = deposit_supernova_energy(
        field, [np.array([1e18, 0.5e18, 0.25e18])], Geom(), boost_factor=2.0)
    assert float(out[4, 2, 1]) == pytest.approx(2e44)
    assert float(jnp.sum(out)) == pytest.approx(2e44)


def test_rate_based_uv_luminosity():
    fn = RateBasedUVLuminosityFunction(
        uv_rate_per_mass_unit=1e46 / 1.98855e30, cutoff_age=5 * MYR)
    msol = 1.98855e30
    assert fn(1 * MYR, 100 * msol) == pytest.approx(1e48)
    assert fn(6 * MYR, 100 * msol) == 0.0


def test_imf_based_uv_luminosity():
    fn = IMFBasedUVLuminosityFunction(slope=2.3)
    msol = 1.98855e30
    # young population: most massive stars alive → bright
    l_young = fn(1 * MYR, 1e4 * msol)
    # older: the most massive survivor has dropped below 100 Msol → dimmer
    l_mid = fn(8 * MYR, 1e4 * msol)
    assert 0 < l_mid < l_young
    # once the most massive survivor is below the OB limit: dark
    assert fn(50 * MYR, 1e4 * msol) == 0.0
    # luminosity scales linearly with population mass
    assert fn(1 * MYR, 2e4 * msol) == pytest.approx(2 * l_young, rel=1e-10)
    assert 1e48 < l_young < 1e52


def test_linear_frequency_bins():
    bins = LinearFrequencyBins(10, 1e15, 2e15)
    assert bins.get_bin_number(0.5e15) == 0  # clamped
    assert bins.get_bin_number(2.5e15) == 9  # clamped
    assert bins.get_bin_number(1.05e15) == 0
    assert bins.get_bin_number(1.95e15) == 9
    assert bins.get_frequency(0) == pytest.approx(1.05e15)
    assert len(bins.edges) == 11


def test_level_frequency_bins():
    bins = LevelFrequencyBins()
    # 13.6 eV photon: ionizes H but not He
    nu_h = 13.5984 * 1.602176634e-19 / 6.62607015e-34
    b = bins.get_bin_number(nu_h * 1.0001)
    assert bins.names[b] == "H_n"
    # 30 eV photon: above He_n (24.6) and C_p1/N_p1 but below O_p1 (35.1)
    nu30 = 30.0 * 1.602176634e-19 / 6.62607015e-34
    b30 = bins.get_bin_number(nu30)
    assert bins.frequencies[b30] <= nu30
    if b30 + 1 < len(bins.frequencies):
        assert bins.frequencies[b30 + 1] > nu30
    # frequencies sorted ascending
    assert np.all(np.diff(bins.frequencies) > 0)


def test_gadget_snapshot_source_distribution(tmp_path):
    """GadgetSnapshot star-particle sources
    (GadgetSnapshotPhotonSourceDistribution.cpp:64-220): star particles
    younger than the cutoff age become UV sources via the luminosity
    function; older ones are dropped."""
    import h5py

    from cmacionize_tpu.models.source_distributions import (
        RateBasedUVLuminosityFunction,
        load_gadget_star_sources,
    )

    MSOL = 1.98855e30
    MYR = 3.1536e13
    snap = tmp_path / "stars.hdf5"
    with h5py.File(snap, "w") as fh:
        header = fh.create_group("Header")
        header.attrs["Time"] = 6.0 * MYR
        stars = fh.create_group("PartType4")
        stars.create_dataset("Coordinates", data=np.asarray(
            [[0.0, 0.0, 0.0], [1.0e16, 0.0, 0.0], [0.0, 2.0e16, 0.0]]))
        stars.create_dataset("Masses", data=np.asarray(
            [100.0 * MSOL, 50.0 * MSOL, 100.0 * MSOL]))
        # ages: 1 Myr, 2 Myr, 10 Myr (the last exceeds the 5 Myr cutoff)
        stars.create_dataset("FormationTime", data=np.asarray(
            [5.0 * MYR, 4.0 * MYR, -4.0 * MYR]))

    fn = RateBasedUVLuminosityFunction(
        uv_rate_per_mass_unit=1e46 / MSOL, cutoff_age=5.0 * MYR)
    sset = load_gadget_star_sources(str(snap), fn)
    assert len(sset.luminosities) == 2  # the 10 Myr population dropped
    np.testing.assert_allclose(
        np.sort(np.asarray(sset.luminosities)), [50.0e46, 100.0e46],
        rtol=1e-10)
    # and through the parameter-file factory
    from cmacionize_tpu.models.source_distributions import (
        source_distribution_from_params,
    )
    from cmacionize_tpu.utils.params import ParameterFile

    params = ParameterFile({
        "PhotonSourceDistribution": {
            "type": "GadgetSnapshot", "filename": str(snap),
        },
    })
    dist = source_distribution_from_params(params)
    assert dist.source_set().total_luminosity == pytest.approx(
        150.0e46, rel=1e-10)


def test_gadget_snapshot_gas_sfr_sources(tmp_path):
    """use_gas mode: gas particles with SFR > 0 host embedded populations
    of mass SFR x cutoff_age at age 0 (reference :141-170)."""
    import h5py

    from cmacionize_tpu.models.source_distributions import (
        RateBasedUVLuminosityFunction,
        load_gadget_star_sources,
    )

    MSOL = 1.98855e30
    snap = tmp_path / "gas.hdf5"
    with h5py.File(snap, "w") as fh:
        gas = fh.create_group("PartType0")
        gas.create_dataset("Coordinates", data=np.zeros((2, 3)))
        gas.create_dataset(
            "StarFormationRate", data=np.asarray([MSOL / 1e13, 0.0]))
    fn = RateBasedUVLuminosityFunction(
        uv_rate_per_mass_unit=1e46 / MSOL, cutoff_age=1e13)
    sset = load_gadget_star_sources(str(snap), fn, use_gas=True,
                                    cutoff_age=1e13)
    assert len(sset.luminosities) == 1
    # mass = SFR * cutoff = 1 Msol -> 1e46 s^-1
    np.testing.assert_allclose(sset.luminosities, [1e46], rtol=1e-10)


def test_bimodal_cross_sections_config():
    """Bimodal cross sections (BimodalCrossSections.hpp): low/high per ion
    switching at the limit."""
    from cmacionize_tpu.models import ions
    from cmacionize_tpu.models.multifreq_simulation import (
        MultiFreqConfig,
        MultiFreqIonizationSimulation,
    )
    from cmacionize_tpu.utils.params import ParameterFile

    EV = 2.417989e14  # Hz per eV
    params = ParameterFile({
        "SimulationBox": {
            "anchor": ["-1. pc", "-1. pc", "-1. pc"],
            "sides": ["2. pc", "2. pc", "2. pc"],
        },
        "DensityGrid": {"number of cells": [4, 4, 4]},
        "CrossSections": {
            "type": "Bimodal",
            "frequency limit": "15. eV",
            "hydrogen_0_low": "6.3e-18 cm^2",
            "hydrogen_0_high": "1.0e-18 cm^2",
        },
        "IonizationSimulation": {"number of photons": 64},
    })
    config = MultiFreqConfig.from_params(params)
    assert config.bimodal_sigma is not None
    sim = MultiFreqIonizationSimulation(config)
    sig_h = sim.sigma_table[ions.ION_H_n]
    low = sim.bin_centers < 15.0 * EV
    np.testing.assert_allclose(sig_h[low], 6.3e-22, rtol=1e-6)
    np.testing.assert_allclose(sig_h[~low], 1.0e-22, rtol=1e-6)
    # unlisted ions are zero in both regimes
    assert sim.sigma_table[ions.ION_O_n].max() == 0.0
