"""pi/2-BPSK mapping/demapping for the PLHEADER (ETSI EN 302 307-1 Sec. 5.5.2).

Copy of ``dvbs2rx_tpu/spec/pi2_bpsk.py`` cut to the mapper; parity
with reference ``lib/pi2_bpsk.cc``. The index convention is C-style (starting
at 0), so the even/odd mappings are swapped relative to the standard's
1-based convention:

    even index: bit 0 -> (+s, +s),  bit 1 -> (-s, -s)
    odd  index: bit 0 -> (-s, +s),  bit 1 -> (+s, -s)

with s = sqrt(2)/2.
"""

import numpy as np

from .pl_defs import SQRT2_2

def map_bpsk(bits: np.ndarray) -> np.ndarray:
    """Map bits (uint8 array, transmission order) to pi/2-BPSK symbols."""
    bits = np.asarray(bits)
    n = bits.shape[-1]
    j = np.arange(n)
    even = (j & 1) == 0
    s = np.float32(SQRT2_2)
    sign = 1.0 - 2.0 * bits.astype(np.float32)  # +1 for bit 0, -1 for bit 1
    re = np.where(even, s * sign, -s * sign)
    im = s * sign
    return (re + 1j * im).astype(np.complex64)
