"""Device-side CRC-8 validity maps for BBFRAME/TS preparation.

Port of ``dvbs2rx_tpu/ops/crc8_dev.py``. CRC-8 (init 0, no reflection, no
xorout) is linear over GF(2), so inclusive prefix CRCs come from a
Kogge-Stone scan whose levels XOR a shifted copy through constant 8x8 bit
matrices, and the CRC of every 187-byte window follows algebraically:
``crc(frame[p-187..p-1]) = S[p-1] ^ M^187 . S[p-188]``. The host TS stitch
is left a flag lookup and a memcpy.

That scan is the plain version (``packet_validity_plain``, ~354 small
launches per call). On the card ``packet_validity`` runs one launch of the
hand-written kernel instead (``ops/crc8_cuda.py``, ``csrc/crc8.cu``: each
window's CRC from a table, slid along the row); the CPU runs the plain
version.
"""

import functools

import numpy as np
import torch

from ..spec.scramblers import CRC8_POLY, crc8_table
from . import crc8_cuda


@functools.lru_cache(maxsize=4)
def _m1(poly: int = CRC8_POLY):
    """One-byte CRC state advance as an (8, 8) GF(2) bit matrix."""
    t = crc8_table(poly)
    M = np.zeros((8, 8), np.uint8)
    for j in range(8):
        v = int(t[1 << j])
        for k in range(8):
            M[k, j] = (v >> k) & 1
    return M


def _matpow(M, e):
    R = np.eye(8, dtype=np.uint8)
    A = M.copy()
    while e:
        if e & 1:
            R = (R @ A) % 2
        A = (A @ A) % 2
        e >>= 1
    return R


def _apply(M, c):
    """Static-wired GF(2) matrix application on trailing bit planes:
    c (..., 8) 0/1 -> (..., 8); each output bit XORs the input planes its
    matrix row selects."""
    outs = []
    for r in range(8):
        cols = np.flatnonzero(M[r])
        if cols.size == 0:
            outs.append(torch.zeros_like(c[..., 0]))
            continue
        acc = c[..., int(cols[0])]
        for j in cols[1:]:
            acc = acc ^ c[..., int(j)]
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def _shift_right(c, d):
    """c shifted d positions along the byte axis (-2), zeros shifted in."""
    n = c.shape[-2]
    out = torch.zeros_like(c)
    if d < n:
        out[..., d:, :] = c[..., : n - d, :]
    return out


def crc8_prefix_bits(frames_u8):
    """Inclusive per-byte prefix CRCs: frames_u8 (..., n) uint8 ->
    (bits (..., n, 8) int8 raw byte bits, S (..., n, 8) int8 prefix-CRC
    bits)."""
    k8 = torch.arange(8, dtype=torch.int32, device=frames_u8.device)
    bits = ((frames_u8.to(torch.int32)[..., None] >> k8) & 1).to(torch.int8)
    M1 = _m1()
    c = _apply(M1, bits)
    n = c.shape[-2]
    k = 0
    while (1 << k) < n:
        d = 1 << k
        c = c ^ _apply(_matpow(M1, d), _shift_right(c, d))
        k += 1
    return bits, c


def packet_validity(frames_u8, window: int = 187):
    """Per-position CRC-window validity + header validity for each frame.

    frames_u8: (B, n) uint8 descrambled BBFRAME bytes. Returns
    (ok_packed (B, ceil(n/8)) uint8 LSB-first, hdr_ok (B,) int32):
    ``ok[p]`` says byte p equals the CRC-8 of the ``window`` bytes before
    it (of bytes 0..p-1 for p < window); ``hdr_ok`` checks the 10-byte
    BBHEADER. The kernel on the card, the plain version on the CPU
    (``crc8_cuda.crc8_validity``)."""
    return crc8_cuda.crc8_validity(frames_u8, window)


def packet_validity_plain(frames_u8, window: int = 187):
    """Plain version of the CRC-8 kernel: the prefix scan (same contract as
    ``packet_validity``; any leading axes)."""
    bits, S = crc8_prefix_bits(frames_u8)
    n = frames_u8.shape[-1]
    A = _matpow(_m1(), window)
    crc_seg = _shift_right(S, 1) ^ _apply(A, _shift_right(S, window + 1))
    ok = (crc_seg == bits).all(dim=-1)                  # (B, n)
    hdr_ok = (S[..., 8, :] == bits[..., 9, :]).all(dim=-1).to(torch.int32)
    npad = (-n) % 8
    okp = torch.nn.functional.pad(ok.to(torch.int32), (0, npad))
    w = 1 << torch.arange(8, dtype=torch.int32, device=ok.device)
    packed = (okp.reshape(*ok.shape[:-1], -1, 8) * w).sum(-1).to(torch.uint8)
    return packed, hdr_ok
