"""DVB-S2 physical-layer framing constants (ETSI EN 302 307-1 Sec. 5.5).

Parity with the reference: ``lib/pl_defs.h:15-44`` of gr-dvbs2rx.
"""

import numpy as np

SOF_LEN = 26
PLSC_LEN = 64
PLHEADER_LEN = SOF_LEN + PLSC_LEN  # 90
SLOT_LEN = 90
PILOT_BLK_LEN = 36
MAX_PILOT_BLKS = 22
MIN_SLOTS = 36
MAX_SLOTS = 360
SLOTS_PER_PILOT_BLK = 16
PILOT_BLK_INTERVAL = SLOTS_PER_PILOT_BLK * SLOT_LEN  # 1440
PILOT_BLK_PERIOD = PILOT_BLK_INTERVAL + PILOT_BLK_LEN  # 1476
MIN_XFECFRAME_LEN = MIN_SLOTS * SLOT_LEN
MAX_XFECFRAME_LEN = MAX_SLOTS * SLOT_LEN
MIN_PLFRAME_PAYLOAD = MIN_XFECFRAME_LEN
MAX_PLFRAME_PAYLOAD = MAX_XFECFRAME_LEN + (MAX_PILOT_BLKS * PILOT_BLK_LEN)  # 33192
MIN_PLFRAME_LEN = PLHEADER_LEN + MIN_PLFRAME_PAYLOAD
MAX_PLFRAME_LEN = PLHEADER_LEN + MAX_PLFRAME_PAYLOAD

SQRT2_2 = np.float32(0.7071067811865476)

N_PLSC_CODEWORDS = 128

# Start-of-frame word, 26 bits, MSB transmitted first (standard Sec. 5.5.2.1).
SOF_WORD = 0x18D2E82
# As a 64-bit big-endian-bit value (MSB of the u64 is the first transmitted bit).
SOF_BIG_ENDIAN = SOF_WORD << 38

# PLSC scrambling sequence (standard Sec. 5.5.2.4), 64 bits MSB-first.
PLSC_SCRAMBLER = 0x719D83C953422DFA

# FECFRAME sizes (coded bits)
FRAME_SIZE_NORMAL = 64800
FRAME_SIZE_MEDIUM = 32400
FRAME_SIZE_SHORT = 16200

# MPEG transport stream
TS_PACKET_LENGTH = 188
TS_SYNC_BYTE = 0x47
TRANSPORT_ERROR_INDICATOR = 0x80

BB_HEADER_LENGTH_BYTES = 10
BB_HEADER_LENGTH_BITS = BB_HEADER_LENGTH_BYTES * 8

# Pilot symbol (unscrambled): (1 + j)/sqrt(2)
PILOT_SYMBOL = complex(SQRT2_2, SQRT2_2)


def u64_to_bits(value, n):
    """Top-``n`` MSB-first bits of a 64-bit integer as a uint8 array.

    Bit j of the result is ``(value >> (63 - j)) & 1`` — the transmission order
    used throughout the PL header definitions.
    """
    return np.array([(value >> (63 - j)) & 1 for j in range(n)], dtype=np.uint8)


SOF_BITS = u64_to_bits(SOF_BIG_ENDIAN, SOF_LEN)
PLSC_SCRAMBLER_BITS = u64_to_bits(PLSC_SCRAMBLER, PLSC_LEN)
