"""DVB-S2 BCH code construction: generator polynomials and encode tables.

The t-error-correcting BCH generator polynomial is the LCM of the minimal
polynomials of alpha^1, alpha^3, ..., alpha^(2t-1) over the per-frame-size
GF(2^m) (reference ``lib/bch.cc:36-62``). Codes are shortened: only the last
``nbch`` bit positions of the full 2^m - 1 cycle are used.
"""

import functools

import numpy as np

from .galois import (
    GF2m,
    PRIM_POLY_MEDIUM,
    PRIM_POLY_NORMAL,
    PRIM_POLY_SHORT,
    gf,
    gf2_poly_lcm,
)

PRIM_POLY_BY_FRAMESIZE = {
    "normal": PRIM_POLY_NORMAL,
    "short": PRIM_POLY_SHORT,
    "medium": PRIM_POLY_MEDIUM,
}


def field_for(framesize: str) -> GF2m:
    return gf(PRIM_POLY_BY_FRAMESIZE[framesize])


@functools.lru_cache(maxsize=None)
def generator_poly(framesize: str, t: int) -> int:
    """BCH generator polynomial as a Python int (bit i = coeff of x^i)."""
    field = field_for(framesize)
    g = 1
    for i in range(t):
        beta = int(field.alpha_pow(2 * i + 1))
        g = gf2_poly_lcm(g, field.min_poly(beta))
    return g


@functools.lru_cache(maxsize=None)
def _byte_rem_table(framesize: str, t: int):
    """LUT for byte-at-a-time polynomial division by g(x).

    Entry b = remainder of ``b(x) * x^deg(g)`` mod g(x), enabling
    ``rem = ((rem << 8) ^ table[(rem >> (deg-8)) ^ byte]) & mask`` style
    streaming division. Stored as Python ints (deg can exceed 64 bits).
    """
    g = generator_poly(framesize, t)
    deg = g.bit_length() - 1
    table = []
    for b in range(256):
        rem = b << deg
        for bit in range(deg + 7, deg - 1, -1):
            if rem >> bit & 1:
                rem ^= g << (bit - deg)
        table.append(rem)
    return table, deg, g


def bch_encode_bytes(msg_bytes: np.ndarray, framesize: str, t: int) -> np.ndarray:
    """Systematic BCH encode of MSB-first packed message bytes.

    Returns the parity as packed bytes (``deg(g)/8`` bytes, appended after the
    message in the codeword). deg(g) = nbch - kbch is always a multiple of 8
    for DVB-S2 codes.
    """
    table, deg, _ = _byte_rem_table(framesize, t)
    assert deg % 8 == 0
    rem = 0
    shift = deg - 8
    for byte in np.asarray(msg_bytes, dtype=np.uint8).tolist():
        top = (rem >> shift) & 0xFF
        rem = ((rem << 8) & ((1 << deg) - 1)) ^ table[top ^ byte]
    nbytes = deg // 8
    return np.frombuffer(rem.to_bytes(nbytes, "big"), dtype=np.uint8).copy()


@functools.lru_cache(maxsize=None)
def syndrome_bit_matrix(framesize: str, t: int, nbch: int):
    """Bit-plane matrix turning syndrome computation into a binary matmul.

    For received bits r (MSB-first transmission order, length nbch), syndrome
    S_i = r(alpha^i) for i = 1..2t, where transmitted bit position p
    corresponds to polynomial power x^(nbch-1-p). Returns A with shape
    (nbch, 2t * m) uint8 such that ``S_bits = (r @ A) mod 2``; column block i
    holds the m bits of alpha^(i * power) per position.
    """
    field = field_for(framesize)
    m = field.m
    pos = np.arange(nbch, dtype=np.int64)
    powers = nbch - 1 - pos  # x exponent of each transmitted bit
    out = np.zeros((nbch, 2 * t * m), dtype=np.uint8)
    for i in range(1, 2 * t + 1):
        vals = field.alpha_pow(i * powers)  # alpha^(i * power) per position
        for b in range(m):
            out[:, (i - 1) * m + b] = (vals >> b) & 1
    return out
