"""Interleaved RM(1,6) (64, 7, 32) code used by the PLSC.

Construction per ETSI EN 302 307-1 Sec. 5.5.2.4 / Figure 13b (reference
``lib/reed_muller.cc:57-107``): the 6 MSBs of the PLS select a (32, 6) RM(1,5)
codeword y via the generator matrix; the LSB (b7) selects between the
interleavings ``(y1 y1 y2 y2 ...)`` (b7=0) and ``(y1 !y1 y2 !y2 ...)`` (b7=1).

Copy of ``dvbs2rx_tpu/spec/reed_muller.py`` cut to the codeword table, the
encoder and the scrambled images the PLSC decoders of ``ops/plsync.py``
correlate against.
"""

import functools

import numpy as np

from .pl_defs import N_PLSC_CODEWORDS, PLSC_LEN, PLSC_SCRAMBLER_BITS

_G32 = np.array(
    [0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF, 0xFFFFFFFF],
    dtype=np.uint64,
)


@functools.lru_cache(maxsize=None)
def codeword_bits():
    """(128, 64) uint8 array: row i = RM(1,6) codeword of 7-bit dataword i.

    Bit order is MSB-first transmission order.
    """
    out = np.zeros((N_PLSC_CODEWORDS, PLSC_LEN), dtype=np.uint8)
    for i in range(64):
        code32 = np.uint64(0)
        for row in range(6):
            if i & (0x20 >> row):
                code32 ^= _G32[row]
        y = np.array([(int(code32) >> (31 - b)) & 1 for b in range(32)], dtype=np.uint8)
        # b7=0: each bit repeated; b7=1: bit followed by complement
        out[2 * i, 0::2] = y
        out[2 * i, 1::2] = y
        out[2 * i + 1, 0::2] = y
        out[2 * i + 1, 1::2] = 1 - y
    return out


@functools.lru_cache(maxsize=None)
def scrambled_euclidean_images():
    """(128, 64) float32: 2-PAM images of the PLSC-scrambled codewords.

    Row i maps codeword i XOR plsc_scrambler with bit 0 -> +1, bit 1 -> -1:
    the matrix the PLSC decoders correlate against (the scrambling is folded
    in, so no separate descrambling step is needed — reference
    ``lib/pl_signaling.cc:95-98``).
    """
    bits = codeword_bits() ^ PLSC_SCRAMBLER_BITS[None, :]
    return (1.0 - 2.0 * bits).astype(np.float32)


def encode(plsc: int) -> np.ndarray:
    """Encode a 7-bit PLS into the 64-bit codeword (unscrambled), as bits."""
    return codeword_bits()[plsc]
