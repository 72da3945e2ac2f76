"""Batched FEC encoding (BCH + LDPC), lane-major.

Port of ``dvbs2rx_tpu/ops/encode.py`` (no Pallas kernel there: plain
PyTorch here). Bits are lane-major, (n, B) with frames on the minor axis,
like the decode path:

- **BCH**: systematic parity is GF(2)-linear in the message, so the whole
  encode is one matmul against a precomputed ``(kbch, deg)`` bit-plane
  matrix ``P`` with ``P[i] = x^(deg + kbch - 1 - i) mod g(x)`` (the
  streaming LFSR of the reference's ``lib/bch.cc:36-62`` unrolled into a
  matrix), then ``& 1``. Its sums reach ``kbch`` (<= 58,192), so it runs in
  float64: exact whatever the caller's TF32 switches say (a TF32 matmul
  would not be a contract the library can rely on).
- **LDPC**: the eIRA accumulator's check sums are XORs of data bits at
  fixed positions. The JAX code builds them as 63-648 ``jnp.roll`` XORs
  per code; here one precomputed (R, D) index table gathers every check's
  D data bits (padded with a zero bit) and one sum ``& 1`` reduces them.
  The accumulator chain is one prefix-XOR (``cumsum & 1``) over the
  parity axis.

Bit for bit against the host encoders (``spec/bch_spec.bch_encode_bytes``,
``LDPCCode.encode``) and the JAX ``DeviceEncoder``
(``tests/test_torch_encode.py``). On the card unless ``device="cpu"``.
"""

import functools

import numpy as np
import torch

from ..spec import bch_spec
from ..spec.fec_params import get_fec_info
from ..spec.ldpc_tables import get_code
from ..utils.runtime import resolve_device


@functools.lru_cache(maxsize=8)
def bch_parity_matrix(framesize: str, t: int, kbch: int) -> np.ndarray:
    """(kbch, deg) int8: row i = bits of x^(deg + kbch - 1 - i) mod g(x),
    MSB-first columns, so parity_bits = (msg_bits @ P) & 1."""
    _table, deg, g = bch_spec._byte_rem_table(framesize, t)
    mask = (1 << deg) - 1
    pw = np.empty(kbch, dtype=object)
    r = 1
    for _ in range(deg):                 # r = x^deg mod g
        r <<= 1
        if r >> deg:
            r ^= g
        r &= mask
    for j in range(kbch):                # pw[j] = x^(deg + j) mod g
        pw[j] = r
        r <<= 1
        if r >> deg:
            r ^= g
        r &= mask
    P = np.zeros((kbch, deg), dtype=np.int8)
    nbytes = deg // 8
    for i in range(kbch):
        v = int(pw[kbch - 1 - i])
        P[i] = np.unpackbits(
            np.frombuffer(v.to_bytes(nbytes, "big"), np.uint8)
        )
    return P


def ldpc_check_index(code) -> np.ndarray:
    """(R, D) int64: the data-bit indices XORed into each check sum a =
    m*q + j, padded with K (a zero bit appended to the data). Column j's
    edge (block b, shift s) puts data bit b*M + (m - s) mod M into check
    m*q + j: the JAX encoder's ``jnp.roll(blocks[b], s, axis=0)[m]``."""
    M, q = code.M, code.q
    cols = [[] for _ in range(q)]
    for b, addrs in enumerate(code.block_addr):
        for x in addrs.tolist():
            cols[int(x) % q].append((b, int(x) // q))
    D = max(len(c) for c in cols)
    m = np.arange(M)
    idx = np.full((M, q, D), code.K, np.int64)
    for j, edges in enumerate(cols):
        for d, (b, s) in enumerate(edges):
            idx[:, j, d] = b * M + (m - s) % M
    return idx.reshape(M * q, D)


class DeviceEncoder:
    """Batched systematic BCH + LDPC encoder, lane-major, on ``device``."""

    def __init__(self, frame_size: str, rate: str, device=None):
        self.device = resolve_device(device)
        self.fec = get_fec_info(frame_size, rate)
        self.code = get_code(self.fec.ldpc_table)
        self._P = torch.as_tensor(
            bch_parity_matrix(frame_size, self.fec.t, self.fec.kbch),
            dtype=torch.float64, device=self.device)
        self._idx = torch.as_tensor(ldpc_check_index(self.code),
                                    device=self.device)

    def bch_encode_lane_major(self, msg_t):
        """msg_t (kbch, B) uint8 bits -> codeword (nbch, B) uint8 bits."""
        par = self._P.t() @ msg_t.to(torch.float64)              # (deg, B)
        par = par.to(torch.int32) & 1
        return torch.cat([msg_t, par.to(torch.uint8)], dim=0)

    def ldpc_encode_lane_major(self, data_t):
        """data_t (K, B) uint8 bits -> codeword (N, B) uint8 bits."""
        B = data_t.shape[1]
        ext = torch.cat([data_t, data_t.new_zeros((1, B))], dim=0)
        acc = ext[self._idx].sum(1, dtype=torch.int32) & 1       # (R, B)
        # accumulator chain: parity[a] = XOR of acc[0..a]; the scan runs
        # along rows of the (B, R) copy (a scan along a tensor's leading
        # axis walks it serially on the card)
        parity = torch.cumsum(acc.t().contiguous(), dim=1) & 1
        return torch.cat([data_t, parity.t().to(torch.uint8)], dim=0)

    def encode_lane_major(self, msg_t):
        """msg_t (kbch, B) bits -> LDPC codeword (nldpc, B) bits."""
        return self.ldpc_encode_lane_major(self.bch_encode_lane_major(msg_t))

    def __call__(self, msg_t):
        """msg_t (kbch, B) bits (numpy or tensor) -> (nldpc, B) uint8
        tensor on the encoder's device."""
        return self.encode_lane_major(
            torch.as_tensor(msg_t, device=self.device).to(torch.uint8))


def get_device_encoder(frame_size: str, rate: str,
                       device=None) -> DeviceEncoder:
    """The encoder of one (frame size, rate), one per device."""
    return _device_encoder(frame_size, rate, resolve_device(device))


@functools.lru_cache(maxsize=8)
def _device_encoder(frame_size, rate, device):
    return DeviceEncoder(frame_size, rate, device)
