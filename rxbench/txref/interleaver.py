"""Bit interleaver between LDPC encoder and constellation mapper.

ETSI EN 302 307-1 Sec. 5.3.3: serial bits are written column-wise into
``n_mod`` columns of ``nldpc / n_mod`` rows and read out row-wise. 8PSK uses
per-rate column read orders (the "210"/"102"/"012" patterns mirrored by the
reference demapper, ``lib/xfecframe_demapper_cb_impl.cc:51-69``). QPSK is not
interleaved.

Copy of ``dvbs2rx_tpu/spec/interleaver.py`` without ``deinterleave`` (the
port deinterleaves LLRs in ``ops/demap.py``).

Convention: ``column_order[k]`` gives the column (0-based block of the
codeword) feeding bit k of each symbol, with bit 0 the MSB.
"""

import numpy as np

from .constellations import BITS_PER_SYMBOL


def column_order(constellation: str, rate: str):
    if constellation == "QPSK":
        return None
    if constellation == "8PSK":
        if rate == "3/5":
            return (2, 1, 0)
        if rate in ("25/36", "13/18", "7/15", "8/15", "26/45"):
            return (1, 0, 2)
        return (0, 1, 2)
    return tuple(range(BITS_PER_SYMBOL[constellation]))


def interleave(codeword_bits: np.ndarray, constellation: str, rate: str) -> np.ndarray:
    """Codeword bits -> symbol-ordered bits (n_syms * n_mod, MSB first)."""
    order = column_order(constellation, rate)
    bits = np.asarray(codeword_bits)
    if order is None:
        return bits
    n_mod = len(order)
    rows = bits.size // n_mod
    cols = bits.reshape(n_mod, rows)  # column c = bits[c*rows:(c+1)*rows]
    out = np.empty((rows, n_mod), dtype=bits.dtype)
    for k, c in enumerate(order):
        out[:, k] = cols[c]
    return out.reshape(-1)
