"""FEC tail: BCH locator and Chien search, CRC-8 validity maps
(``ops/bch_cuda.py``, ``ops/crc8_cuda.py``), device time per step."""

NAME = "fec_tail_ms"
UNIT = "ms"
LAYER = "FEC"
PATTERNS = ("bch_*", "crc8*")


def read(view):
    us = view.kernel_us(PATTERNS)
    return view.per_step_ms(us) if us else None
