"""Element and ion bookkeeping.

Mirrors the reference's compile-time element composition
(/root/reference/src/ElementNames.hpp:101-153): the tracked ions are the
ionizable states; the highest ionization state of each element is implicit
(1 - sum of tracked fractions for that element's lower states... for H/He the
tracked fraction is the *neutral* fraction).

Here the ion set is a static configuration: arrays carry a leading ion axis
of length ``len(ion_names)`` and XLA specializes per configuration, replacing
the reference's #ifdef-based compile-time composition.

Argon (the reference's optional ``HAS_ARGON``, ElementNames.hpp:144-150) is
intentionally absent: in the reference that ifdef only adds enum slots and
ElementData entries — no code in IonizationStateCalculator,
TemperatureCalculator or LineCoolingData ever computes or consumes an Ar
fraction (verified by grep: ``ION_Ar`` appears in ElementNames.hpp and
ElementData.hpp only), so the default 14-ion build here IS full solver
parity; mirroring the skeleton enum would add state without behavior.
"""

from __future__ import annotations

# The default (full) ion set, in reference order.
ION_NAMES = (
    "H_n",
    "He_n",
    "C_p1",
    "C_p2",
    "N_n",
    "N_p1",
    "N_p2",
    "O_n",
    "O_p1",
    "Ne_n",
    "Ne_p1",
    "S_p1",
    "S_p2",
    "S_p3",
)

# index constants (full set)
ION_H_n = 0
ION_He_n = 1
ION_C_p1 = 2
ION_C_p2 = 3
ION_N_n = 4
ION_N_p1 = 5
ION_N_p2 = 6
ION_O_n = 7
ION_O_p1 = 8
ION_Ne_n = 9
ION_Ne_p1 = 10
ION_S_p1 = 11
ION_S_p2 = 12
ION_S_p3 = 13
NUMBER_OF_IONS = len(ION_NAMES)

ELEMENT_NAMES = ("H", "He", "C", "N", "O", "Ne", "S")

# element of each ion (index into ELEMENT_NAMES)
ION_ELEMENT = (0, 1, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 6, 6)

# number of heating tally channels (H and He photo-heating),
# cf. /root/reference/src/IonizationVariables.hpp heating terms
HEATING_H = 0
HEATING_He = 1
NUMBER_OF_HEATING_TERMS = 2

# default metal abundances used by the Lexington benchmarks (number relative
# to hydrogen), cf. /root/reference/benchmarks/lexingtonHII20.param
DEFAULT_ABUNDANCES = {
    "He": 0.1,
    "C": 2.2e-4,
    "N": 4.0e-5,
    "O": 3.3e-4,
    "Ne": 5.0e-5,
    "S": 9.0e-6,
}
