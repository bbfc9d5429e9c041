"""Physical constants, CGS-flavoured (same values as ``tsadar_tpu.core.physics.constants``)."""

import math

C = 2.99792458e10  # speed of light, cm/s
ME_KEV = 510.9896 / C**2  # electron mass, keV/(cm/s)^2
MP_KEV = ME_KEV * 1836.1  # proton mass
RE_CM = 2.8179e-13  # classical electron radius, cm
ESQ = ME_KEV * C**2 * RE_CM  # electron charge squared, keV cm
# sqrt(4 pi e^2 / me): omega_pe = CONST * sqrt(ne[cm^-3])  [rad/s]
PLASMA_FREQ_CONST = math.sqrt(4.0 * math.pi * ESQ / ME_KEV)
