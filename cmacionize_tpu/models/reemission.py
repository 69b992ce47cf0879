"""Diffuse re-emission: per-cell channel probabilities and re-emission spectra.

Equivalent of the reference's PhysicalDiffuseReemissionHandler
(/root/reference/src/PhysicalDiffuseReemissionHandler.hpp:60-105, .cpp) and
the re-emission spectra (HydrogenLymanContinuumSpectrum.cpp,
HeliumLymanContinuumSpectrum.cpp, HeliumTwoPhotonContinuumSpectrum.cpp):
an absorbed photon packet is re-emitted with a channel-dependent new
frequency (Wood, Mathis & Ercolano 2004, §3.3).

Design: the reference draws per-photon uniforms and walks a
cumulative channel table per absorption event inside a task; here the whole
absorbed batch is re-emitted in one vectorized pass — channel selection is a
chain of `where` masks, frequency sampling is inverse-CDF interpolation into
precomputed (temperature × frequency) tables.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from cmacionize_tpu import constants
from cmacionize_tpu.ops import cross_sections as xsec_mod

NU_MIN = 3.288e15  # 13.6 eV (Hz), cf. HydrogenLymanContinuumSpectrum.cpp:46

# He 2-photon emission distribution A(y), y = nu/nu0 with nu0 = 4.98e15 Hz
# (published data: Drake, Victor & Dalgarno 1969, table II)
_HE2Q_Y = np.linspace(0.0, 1.0, 41)
_HE2Q_A = np.array([
    0.00e0, 7.77e0, 2.52e1, 4.35e1, 5.99e1, 7.42e1, 8.64e1, 9.69e1, 1.06e2,
    1.13e2, 1.20e2, 1.25e2, 1.30e2, 1.34e2, 1.37e2, 1.40e2, 1.42e2, 1.43e2,
    1.45e2, 1.45e2, 1.45e2, 1.45e2, 1.45e2, 1.43e2, 1.42e2, 1.40e2, 1.37e2,
    1.34e2, 1.30e2, 1.25e2, 1.20e2, 1.13e2, 1.06e2, 9.69e1, 8.64e1, 7.42e1,
    5.99e1, 4.35e1, 2.52e1, 7.77e0, 0.00e0,
])


def reemission_probabilities(T):
    """Per-cell re-emission probabilities (vectorized over T).

    Returns (p_H, cum_He[4]) where p_H is the probability that an
    H-absorbed photon is re-emitted as H Lyman continuum, and cum_He are the
    cumulative probabilities of the 4 helium channels
    (LyC, 2^3S→1^1S 19.8 eV line, two-photon continuum, Lyα),
    cf. PhysicalDiffuseReemissionHandler.hpp:66-105.
    """
    T4 = T * 1e-4
    alpha_1_H = 1.58e-13 * T4 ** (-0.53)
    alpha_A_agn = 4.18e-13 * T4 ** (-0.7)
    p_H = alpha_1_H / alpha_A_agn

    alpha_1_He = 1.54e-13 * T4 ** (-0.486)
    alpha_e_2tS = 2.1e-13 * T4 ** (-0.381)
    alpha_e_2sS = 2.06e-14 * T4 ** (-0.451)
    alpha_e_2sP = 4.17e-14 * T4 ** (-0.695)
    total = alpha_1_He + alpha_e_2tS + alpha_e_2sS + alpha_e_2sP
    c1 = alpha_1_He / total
    c2 = c1 + alpha_e_2tS / total
    c3 = c2 + alpha_e_2sS / total
    c4 = c3 + alpha_e_2sP / total
    return p_H, (c1, c2, c3, c4)


def _cdf_from_pdf(freqs, pdf):
    pdf = np.maximum(pdf, 0.0)
    cdf = np.concatenate(
        [[0.0], np.cumsum(0.5 * (pdf[1:] + pdf[:-1]) * np.diff(freqs))]
    )
    total = cdf[-1]
    if total <= 0.0:
        return np.linspace(0.0, 1.0, len(freqs))
    return cdf / total


@dataclasses.dataclass(frozen=True)
class ReemissionSpectra:
    """Precomputed inverse-CDF tables for the diffuse re-emission channels.

    H/He Lyman continua are temperature-dependent: CDFs are tabulated on a
    temperature grid (the reference uses 100-point T tables,
    HydrogenLymanContinuumSpectrum.cpp:40-95) and sampled with nearest-T
    lookup + frequency interpolation.
    """

    temperatures: np.ndarray  # [NT]
    frequencies: np.ndarray  # [NF]
    h_lyc_cdf: np.ndarray  # [NT, NF]
    he_lyc_cdf: np.ndarray  # [NT, NF]
    he_2pc_freqs: np.ndarray  # [NF2]
    he_2pc_cdf: np.ndarray  # [NF2]

    @classmethod
    def build(cls, n_temp: int = 64, n_freq: int = 256) -> "ReemissionSpectra":
        temps = 1500.0 + (np.arange(n_temp) + 0.5) * 13500.0 / n_temp
        freqs = np.linspace(NU_MIN, 4.0 * NU_MIN, n_freq)
        sigma_H = xsec_mod.ion_cross_section("H_n", freqs)
        sigma_He = xsec_mod.ion_cross_section("He_n", freqs)
        h_over_k = constants.PLANCK / constants.BOLTZMANN

        h_cdf = np.zeros((n_temp, n_freq))
        he_cdf = np.zeros((n_temp, n_freq))
        for iT, T in enumerate(temps):
            # nu^2 sigma exp(-h(nu-nu_th)/kT): the free-bound photon-number
            # spectrum (WME04 eq. 8 divided by h nu)
            h_pdf = freqs**2 * sigma_H * np.exp(-h_over_k * (freqs - NU_MIN) / T)
            h_cdf[iT] = _cdf_from_pdf(freqs, h_pdf)
            nu_he = 1.81 * NU_MIN
            he_pdf = np.where(
                freqs >= nu_he,
                freqs**2 * sigma_He * np.exp(-h_over_k * (freqs - nu_he) / T),
                0.0,
            )
            he_cdf[iT] = _cdf_from_pdf(freqs, he_pdf)

        # He two-photon continuum, H-ionizing part (nu in [nu_min, 1.6 nu_min],
        # cf. HeliumTwoPhotonContinuumSpectrum.cpp:20-60)
        nu0 = 4.98e15
        freqs2 = np.linspace(NU_MIN, 1.6 * NU_MIN, 128)
        y = freqs2 / nu0
        a_interp = np.interp(y, _HE2Q_Y, _HE2Q_A, left=0.0, right=0.0)
        cdf2 = _cdf_from_pdf(freqs2, a_interp)
        return cls(temps, freqs, h_cdf, he_cdf, freqs2, cdf2)

    def _sample_tdep(self, cdf_table, key, T):
        """Inverse-CDF sample with nearest-temperature row selection."""
        temps = jnp.asarray(self.temperatures)
        freqs = jnp.asarray(self.frequencies, jnp.float32)
        cdfs = jnp.asarray(cdf_table, jnp.float32)
        dT = self.temperatures[1] - self.temperatures[0]
        iT = jnp.clip(
            ((T - self.temperatures[0]) / dT + 0.5).astype(jnp.int32),
            0,
            len(self.temperatures) - 1,
        )
        xi = jax.random.uniform(key, T.shape, jnp.float32)
        rows = cdfs[iT]  # [P, NF]
        # vectorized interp: searchsorted per row
        idx = jnp.clip(
            jax.vmap(jnp.searchsorted)(rows, xi), 1, rows.shape[1] - 1
        )
        c_lo = jnp.take_along_axis(rows, (idx - 1)[:, None], 1)[:, 0]
        c_hi = jnp.take_along_axis(rows, idx[:, None], 1)[:, 0]
        f_lo = freqs[idx - 1]
        f_hi = freqs[idx]
        frac = (xi - c_lo) / jnp.maximum(c_hi - c_lo, 1e-12)
        return f_lo + frac * (f_hi - f_lo)

    def sample_h_lyc(self, key, T):
        return self._sample_tdep(self.h_lyc_cdf, key, T)

    def sample_he_lyc(self, key, T):
        return self._sample_tdep(self.he_lyc_cdf, key, T)

    def sample_he_2pc(self, key, n):
        xi = jax.random.uniform(key, (n,), jnp.float32)
        return jnp.interp(
            xi,
            jnp.asarray(self.he_2pc_cdf, jnp.float32),
            jnp.asarray(self.he_2pc_freqs, jnp.float32),
        )


def reemit_batch(
    key,
    spectra: ReemissionSpectra,
    absorbed,  # [P] bool
    sigma_H_pkt,  # [P] packet cross sections at the old frequency
    sigma_He_pkt,
    xH_cell,  # [P] neutral fractions at the absorption cell
    xHe_cell,
    T_cell,  # [P] temperature at the absorption cell
    AHe: float,
):
    """Vectorized diffuse re-emission for a terminated batch.

    Returns (reemit_mask [P] bool, new_frequency [P] f32) — packets with
    reemit_mask keep flying at new_frequency (direction/τ are re-sampled by
    the caller), the rest are truly absorbed.

    Implements the full channel tree of
    PhysicalDiffuseReemissionHandler::reemit (.cpp:10-160).
    """
    n = absorbed.shape[0]
    keys = jax.random.split(key, 6)
    u_species = jax.random.uniform(keys[0], (n,), jnp.float32)
    u_channel = jax.random.uniform(keys[1], (n,), jnp.float32)
    u_sub = jax.random.uniform(keys[2], (n,), jnp.float32)
    u_sub2 = jax.random.uniform(keys[3], (n,), jnp.float32)

    p_H_reemit, (c1, c2, c3, c4) = reemission_probabilities(T_cell)

    wH = xH_cell * sigma_H_pkt
    wHe = xHe_cell * AHe * sigma_He_pkt
    p_H_abs = wH / jnp.maximum(wH + wHe, 1e-300)
    absorbed_by_H = u_species <= p_H_abs

    # frequencies for every possible channel (sampled for all packets; masks
    # select) — three table samples + one line
    freq_h_lyc = spectra.sample_h_lyc(keys[4], T_cell)
    freq_he_lyc = spectra.sample_he_lyc(keys[5], T_cell)
    freq_he_2pc = spectra.sample_he_2pc(keys[3], n)
    FREQ_19P8EV = 4.788e15

    # hydrogen branch: re-emit as H LyC with probability p_H_reemit
    h_reemits = absorbed_by_H & (u_channel <= p_H_reemit)

    # helium branch channels (cumulative)
    he = ~absorbed_by_H
    he_lyc = he & (u_channel <= c1)
    he_line = he & (u_channel > c1) & (u_channel <= c2)
    he_tpc = he & (u_channel > c2) & (u_channel <= c3)
    he_lya = he & (u_channel > c3) & (u_channel <= c4)

    # two-photon continuum: 56% of the two photons ionize hydrogen
    he_tpc_emit = he_tpc & (u_sub < 0.56)

    # Lyα: on-the-spot absorption by H (→ H LyC chain) or conversion to 2pc
    sqrtTxH = jnp.sqrt(T_cell) * xH_cell
    pHots = sqrtTxH / (sqrtTxH + 77.0 * xHe_cell)
    lya_ots = he_lya & (u_sub < pHots)
    lya_ots_emit = lya_ots & (u_sub2 <= p_H_reemit)  # H LyC
    lya_tpc = he_lya & (u_sub >= pHots)
    lya_tpc_emit = lya_tpc & (u_sub2 < 0.56)

    reemit = absorbed & (
        h_reemits | he_lyc | he_line | he_tpc_emit | lya_ots_emit | lya_tpc_emit
    )
    new_freq = jnp.where(
        h_reemits | lya_ots_emit,
        freq_h_lyc,
        jnp.where(
            he_lyc,
            freq_he_lyc,
            jnp.where(
                he_line,
                FREQ_19P8EV,
                freq_he_2pc,  # he_tpc_emit | lya_tpc_emit
            ),
        ),
    )
    # channel flag for PHOTONTYPE bookkeeping (trackers/statistics):
    # True = hydrogen Lyman-continuum re-emission (PHOTONTYPE_DIFFUSE_HI),
    # False = one of the helium channels (PHOTONTYPE_DIFFUSE_HeI)
    h_channel = h_reemits | lya_ots_emit
    return reemit, new_freq, h_channel
