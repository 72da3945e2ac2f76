"""DVB-S2 constellation mappings and soft demappers (numpy reference).

QPSK/8PSK follow ETSI EN 302 307-1 Sec. 5.4.1/5.4.2 with the bit conventions
of the reference receiver (``lib/qpsk.h``, ``lib/psk.hh``): bit value 0 maps
to the positive decision region, so soft LLRs are positive for bit 0. 16APSK
and 32APSK (Sec. 5.4.3/5.4.4) use the standard's ring-ratio tables per code
rate, normalized to unit average symbol energy.

Copy of ``dvbs2rx_tpu/spec/constellations.py`` cut to the point tables and
the Tx-side mapper; the port's soft demapper is ``ops/demap.py``.
"""

import functools

import numpy as np

SQRT2_2 = 0.7071067811865476
COS_PI_8 = 0.9238795325112867
SIN_PI_8 = 0.3826834323650898

BITS_PER_SYMBOL = {"QPSK": 2, "8PSK": 3, "16APSK": 4, "32APSK": 5}

# 16APSK ring ratio gamma = R2/R1 per code rate (EN 302 307-1 Table 9)
GAMMA_16APSK = {
    "2/3": 3.15, "3/4": 2.85, "4/5": 2.75, "5/6": 2.70,
    "8/9": 2.60, "9/10": 2.57,
    # S2X additions (EN 302 307-2 Table 10)
    "26/45": 3.70, "3/5": 3.70, "28/45": 3.50, "23/36": 3.10,
    "25/36": 3.10, "13/18": 2.85, "7/15": 5.32, "8/15": 4.85,
    "32/45": 2.85, "140/180": 3.60, "154/180": 3.20,
}

# 32APSK ring ratios (gamma1, gamma2) = (R2/R1, R3/R1) (EN 302 307-1 Table 10)
GAMMA_32APSK = {
    "3/4": (2.84, 5.27), "4/5": (2.72, 4.87), "5/6": (2.64, 4.64),
    "8/9": (2.54, 4.33), "9/10": (2.53, 4.30),
    # S2X
    "2/3": (2.84, 5.27), "32/45": (2.84, 5.26), "11/15": (2.84, 5.27),
    "7/9": (2.84, 5.27),
}


@functools.lru_cache(maxsize=None)
def constellation_points(constellation: str, rate: str = None) -> np.ndarray:
    """Complex64 array of 2^n_mod points indexed by the symbol's bit word
    (MSB-first: index = b0*2^(n-1) + ... ; bit convention: 1 = negative
    half-plane for the PSK axes)."""
    s = SQRT2_2
    if constellation == "QPSK":
        # index b1b0: b1 (MSB) -> real sign, b0 -> imag sign; 0 -> +
        pts = np.array([s + 1j * s, s - 1j * s, -s + 1j * s, -s - 1j * s])
    elif constellation == "8PSK":
        # Index b0b1b2 per the standard's Figure 9 / reference psk.hh map
        pts = np.array(
            [
                s + 1j * s,     # 000
                1.0 + 0.0j,     # 001
                -1.0 + 0.0j,    # 010
                -s - 1j * s,    # 011
                0.0 + 1.0j,     # 100
                s - 1j * s,     # 101
                -s + 1j * s,    # 110
                0.0 - 1.0j,     # 111
            ]
        )
    elif constellation == "16APSK":
        gamma = GAMMA_16APSK[rate]
        # unit average energy: (4 r1^2 + 12 r2^2)/16 = 1
        r1 = np.sqrt(16.0 / (4.0 + 12.0 * gamma * gamma))
        r2 = gamma * r1
        d = np.pi / 12.0
        ang = {
            # outer ring (R2), 12 points (standard Figure 10)
            0: (r2, 3 * d), 1: (r2, -3 * d), 2: (r2, 9 * d), 3: (r2, -9 * d),
            4: (r2, d), 5: (r2, -d), 6: (r2, 11 * d), 7: (r2, -11 * d),
            8: (r2, 5 * d), 9: (r2, -5 * d), 10: (r2, 7 * d), 11: (r2, -7 * d),
            # inner ring (R1), 4 points
            12: (r1, 3 * d), 13: (r1, -3 * d), 14: (r1, 9 * d), 15: (r1, -9 * d),
        }
        pts = np.array([r * np.exp(1j * a) for r, a in (ang[i] for i in range(16))])
    elif constellation == "32APSK":
        g1, g2 = GAMMA_32APSK[rate]
        r1 = np.sqrt(32.0 / (4.0 + 12.0 * g1 * g1 + 16.0 * g2 * g2))
        r2, r3 = g1 * r1, g2 * r1
        pi = np.pi
        # Ring geometry per EN 302 307-1 Sec. 5.4.4: 4 points at R1
        # (quadrant diagonals), 12 at R2 (pi/12 grid), 16 at R3 (pi/8 grid
        # offset pi/16). Bit-word assignment here is internally consistent
        # between this mapper and the demapper (Tx/Rx loopback exact); the
        # Figure 11 bit labeling is tracked for cross-vendor interop.
        inner = [(r1, pi / 4), (r1, -pi / 4), (r1, 3 * pi / 4), (r1, -3 * pi / 4)]
        middle = [(r2, (2 * k + 1) * pi / 12) for k in range(-6, 6)]
        outer = [(r3, (2 * k + 1) * pi / 16) for k in range(-8, 8)]
        layout = inner + middle + outer
        pts = np.array([r * np.exp(1j * a) for r, a in layout])
    else:
        raise ValueError(f"Unknown constellation {constellation!r}")
    return pts.astype(np.complex64)


def map_bits(bits: np.ndarray, constellation: str, rate: str = None) -> np.ndarray:
    """Map a flat bit array (multiple of n_mod) to symbols, MSB first."""
    n_mod = BITS_PER_SYMBOL[constellation]
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, n_mod)
    idx = np.zeros(bits.shape[0], dtype=np.int64)
    for b in range(n_mod):
        idx = (idx << 1) | bits[:, b]
    return constellation_points(constellation, rate)[idx]
