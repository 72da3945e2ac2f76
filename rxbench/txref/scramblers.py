"""DVB-S2 scrambling sequences: PL (Gold code), baseband derandomizer, CRC-8.

Spec parity:
- PL scrambling: ETSI EN 302 307-1 Sec. 5.5.4 (reference ``lib/pl_descrambler.cc``).
- BB scrambling: Sec. 5.2.2 (reference ``lib/bbdescrambler_bb_impl.cc:51-65``).
- CRC-8: Sec. 5.1.4 (reference ``lib/bbdeheader_bb_impl.cc:54``).
"""

import functools

import numpy as np

from .pl_defs import MAX_PLFRAME_PAYLOAD, FRAME_SIZE_NORMAL

CRC8_POLY = 0b111010101  # x^8 + x^7 + x^6 + x^4 + x^2 + 1


@functools.lru_cache(maxsize=8)
def pl_scrambling_rn(gold_code: int, length: int = MAX_PLFRAME_PAYLOAD):
    """Rn sequence in [0, 3] of the PL scrambler for a given Gold code.

    The i-th payload symbol (counting from the first symbol after the PLHEADER)
    is scrambled by ``exp(j * Rn[i] * pi/2)``.
    """
    x = 0x00001
    y = 0x3FFFF

    def parity(v, mask):
        return bin(v & mask).count("1") & 1

    for _ in range(gold_code):
        xb = parity(x, 0x0081)
        x >>= 1
        if xb:
            x |= 0x20000

    rn = np.empty(length, dtype=np.uint8)
    for i in range(length):
        xa = parity(x, 0x8050)
        xb = parity(x, 0x0081)
        xc = x & 1
        x >>= 1
        if xb:
            x |= 0x20000
        ya = parity(y, 0x04A1)
        yb = parity(y, 0xFF60)
        yc = y & 1
        y >>= 1
        if ya:
            y |= 0x20000
        zna = xc ^ yc
        znb = xa ^ yb
        rn[i] = (znb << 1) + zna
    return rn


@functools.lru_cache(maxsize=8)
def pl_scrambling_sequence(gold_code: int, length: int = MAX_PLFRAME_PAYLOAD):
    """Complex64 scrambling sequence ``exp(j*Rn*pi/2)`` (multiply at the Tx)."""
    rn = pl_scrambling_rn(gold_code, length)
    lut = np.array([1, 1j, -1, -1j], dtype=np.complex64)
    return lut[rn]


@functools.lru_cache(maxsize=8)
def pl_descrambling_sequence(gold_code: int, length: int = MAX_PLFRAME_PAYLOAD):
    """Conjugate sequence (multiply at the Rx to undo the PL scrambling)."""
    return np.conj(pl_scrambling_sequence(gold_code, length))


@functools.lru_cache(maxsize=None)
def bb_derandomizer_bytes(nbytes: int = FRAME_SIZE_NORMAL // 8):
    """Byte-wise BB derandomizer sequence (XOR with the BBFRAME bytes).

    LFSR ``1 + x^14 + x^15`` loaded with ``100101010000000`` — the register
    value 0x4A80 with the reference's bit convention.
    """
    out = np.zeros(nbytes, dtype=np.uint8)
    sr = 0x4A80
    for i in range(nbytes * 8):
        b = (sr ^ (sr >> 1)) & 1
        out[i // 8] |= b << (7 - (i % 8))
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


@functools.lru_cache(maxsize=None)
def crc8_table(poly: int = CRC8_POLY):
    """256-entry CRC-8 table (non-reflected, init 0, no final XOR)."""
    table = np.zeros(256, dtype=np.uint8)
    for byte in range(256):
        rem = byte
        for _ in range(8):
            rem = ((rem << 1) ^ (poly & 0xFF)) & 0xFF if (rem & 0x80) else (rem << 1) & 0xFF
        table[byte] = rem
    return table


def crc8(data: np.ndarray, poly: int = CRC8_POLY) -> int:
    """CRC-8 of ``data`` bytes: remainder of ``data(x) * x^8 mod poly(x)``.

    A buffer followed by its CRC byte divides evenly (remainder 0), matching
    the reference's ``check_crc8``.
    """
    table = crc8_table(poly)
    rem = 0
    for byte in np.asarray(data, dtype=np.uint8).tolist():
        rem = int(table[rem ^ byte])
    return rem


def crc8_check(data_with_crc: np.ndarray) -> bool:
    return crc8(data_with_crc) == 0
