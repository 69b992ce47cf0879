"""Photoionization cross sections.

Equivalent of the reference's CrossSections hierarchy
(/root/reference/src/VernerCrossSections.cpp — a rewrite of Verner's phfit2 —
and FixedValueCrossSections; factory at
/root/reference/src/CrossSectionsFactory.hpp:69-74).

Design: cross sections are *tabulated once on the host* over a
frequency grid into a [n_ion, n_freq] array; packets carry per-ion cross
sections gathered/interpolated from this table at emission (the reference
evaluates the analytic fits per photon,
src/PhotonSource.cpp:189-256 — on an accelerator a table interpolation
is one gather instead of a branchy transcendental evaluation).

The fit evaluation itself (`verner_cross_section`) is vectorized numpy over
frequency, implementing the published Verner et al. 1996 phfit2 formulas with
the Verner & Yakovlev 1995 inner-shell tables.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from cmacionize_tpu import constants
from cmacionize_tpu.data import verner_photo_tables
from cmacionize_tpu.models import ions

MEGABARN_SI = 1e-22  # 1 Mb = 1e-18 cm^2 in m^2

# shells summed per ion, matching the reference's per-ion shell lists
# (/root/reference/src/VernerCrossSections.cpp:263-323): (Z, N_electrons, shell)
ION_SHELLS: Dict[str, Tuple[Tuple[int, int, int], ...]] = {
    "H_n": ((1, 1, 1),),
    "He_n": ((2, 2, 1),),
    "C_p1": ((6, 5, 3), (6, 5, 2)),
    "C_p2": ((6, 4, 2),),
    "N_n": ((7, 7, 3), (7, 7, 2)),
    "N_p1": ((7, 6, 3), (7, 6, 2)),
    "N_p2": ((7, 5, 3),),
    "O_n": ((8, 8, 3), (8, 8, 2)),
    "O_p1": ((8, 7, 3), (8, 7, 2)),
    "Ne_n": ((10, 10, 3), (10, 10, 2)),
    "Ne_p1": ((10, 9, 3),),
    "S_p1": ((16, 15, 5), (16, 15, 4)),
    "S_p2": ((16, 14, 5), (16, 14, 4)),
    "S_p3": ((16, 13, 5),),
}


def verner_cross_section(Z: int, N: int, shell: int, frequency) -> np.ndarray:
    """σ(ν) for one (Z, N_electrons, shell), in m², vectorized over frequency.

    Published Verner et al. 1996 phfit2 logic: below the shell threshold the
    cross section vanishes; between the outer-shell region and the inner-shell
    jump energy E_inn either the smooth outer fit (table B) or the inner-shell
    fit (table A) applies.
    """
    a_params, b_params, c_params = verner_photo_tables()
    eV = np.asarray(frequency, dtype=np.float64) * (
        constants.PLANCK / constants.ELECTRONVOLT
    )

    entry = a_params[Z, N, shell]
    E_th, E_0, sigma_0, y_a, P, y_w, l_quant = entry
    if sigma_0 == 0.0:
        return np.zeros_like(eV)

    Ninn, Ntot = int(c_params[N, 0]), int(c_params[N, 1])
    nout = Ntot
    if Z == N and Z > 18:
        nout = 7
    if Z == N + 1 and Z in (20, 21, 22, 25, 26):
        nout = 7
    if shell > nout:
        return np.zeros_like(eV)

    if Z in (15, 17, 19) or (Z > 20 and Z != 26):
        einn = 0.0
    elif N < 3:
        einn = 1.0e30
    else:
        einn = a_params[Z, N, Ninn][0]  # E_th of the innermost outer shell

    # inner-shell (table A) fit
    with np.errstate(divide="ignore", invalid="ignore"):
        y = eV / E_0
        Fy = (
            (y - 1.0) ** 2 + y_w**2
        ) * y ** (0.5 * P - 5.5 - l_quant) * (1.0 + np.sqrt(y / y_a)) ** (-P)
        sigma_a = sigma_0 * MEGABARN_SI * Fy

        # outer-shell (table B) fit
        bE_0, bsigma_0, by_a, bP, by_w, by_0, by_1 = b_params[Z, N, 2:9]
        if bsigma_0 > 0.0:
            x = eV / bE_0 - by_0
            yb = np.sqrt(x * x + by_1 * by_1)
            FyB = (
                (x - 1.0) ** 2 + by_w**2
            ) * yb ** (0.5 * bP - 5.5) * (1.0 + np.sqrt(yb / by_a)) ** (-bP)
            sigma_b = bsigma_0 * MEGABARN_SI * FyB
        else:
            sigma_b = np.zeros_like(eV)

    use_a = (shell <= Ninn) | (eV >= einn)
    zero_zone = (shell < nout) & (shell > Ninn) & (eV < einn)
    out = np.where(use_a, sigma_a, sigma_b)
    out = np.where(zero_zone | (eV < E_th), 0.0, out)
    return out


def ion_cross_section(ion_name: str, frequency) -> np.ndarray:
    """Total σ_ion(ν) in m² (sum over the relevant shells)."""
    total = None
    for Z, N, shell in ION_SHELLS[ion_name]:
        sigma = verner_cross_section(Z, N, shell, frequency)
        total = sigma if total is None else total + sigma
    return total


def tabulate_cross_sections(
    frequencies,
    ion_names: Sequence[str] = ions.ION_NAMES,
) -> np.ndarray:
    """[n_ion, n_freq] cross-section table (m²) over a frequency grid (Hz)."""
    return np.stack(
        [ion_cross_section(name, frequencies) for name in ion_names], axis=0
    )


def fixed_value_cross_sections(
    values: Dict[str, float],
    ion_names: Sequence[str] = ions.ION_NAMES,
) -> np.ndarray:
    """[n_ion] constant cross sections (m²), zero for unlisted ions —
    the FixedValueCrossSections equivalent."""
    return np.asarray([values.get(name, 0.0) for name in ion_names])
