"""DVB-S2/S2X/T2 LDPC quasi-cyclic code structure.

The ETSI parity-bit address tables (annex B/C) are stored in
``data/ldpc_tables.npz`` (extracted by ``tools/extract_tables.py``). This
module derives the structures the decoder and encoder need (a copy of
``dvbs2rx_tpu/spec/ldpc_tables.py`` without ``LDPCCode.check``):

Quasi-cyclic structure (standard Sec. 5.3.2; reference ``lib/ldpc_decoder/ldpc.hh``):
bit columns come in blocks of M=360. Block b with base accumulator address x
connects bit m of the block to parity accumulator (x + m*q) mod (N-K), with
q = (N-K)/M. Re-labeling check o as (layer i = o mod q, slot j = o div q),
every base address touches exactly one layer (i = x mod q), and within that
layer check j connects to bit (j - x//q) mod 360 of the block. Hence a layer's
data edges are cyclic *rolls* of bit blocks.

The parity part is the usual staircase: check o also connects to parity bits o
and o-1, i.e. pty[i][j] and pty[i-1][j] in (layer, slot) layout (with the wrap
pty[q-1][j-1] for layer 0, and no previous edge for check 0).
"""

import functools
import os
from dataclasses import dataclass, field

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "ldpc_tables.npz")


@functools.lru_cache(maxsize=1)
def _npz():
    return np.load(_DATA)

def available_tables():
    z = _npz()
    return sorted({k.split("__")[0] for k in z.files})


@dataclass(frozen=True)
class LDPCCode:
    name: str
    M: int
    N: int
    K: int
    links_total: int
    links_max_cn: int
    # base addresses grouped per 360-bit column block:
    block_addr: tuple          # tuple of int32 arrays, one per block (len K/M)

    @property
    def R(self):
        return self.N - self.K

    @property
    def q(self):
        return self.R // self.M

    @property
    def n_blocks(self):
        return self.K // self.M

    @functools.cached_property
    def layers(self):
        """Per-layer roll structure for the layered decoder.

        Returns dict with:
          cnt:   (q,) int32 — number of data edges per check in each layer
          block: (q, max_cnt) int32 — bit-block index per edge (pad: -1)
          shift: (q, max_cnt) int32 — roll amount per edge (pad: 0)
        """
        q = self.q
        per_layer = [[] for _ in range(q)]
        for b, addrs in enumerate(self.block_addr):
            for x in addrs.tolist():
                per_layer[x % q].append((b, x // q))
        cnt = np.array([len(v) for v in per_layer], dtype=np.int32)
        max_cnt = int(cnt.max())
        block = np.full((q, max_cnt), -1, dtype=np.int32)
        shift = np.zeros((q, max_cnt), dtype=np.int32)
        for i, v in enumerate(per_layer):
            for c, (b, s) in enumerate(v):
                block[i, c] = b
                shift[i, c] = s
        return {"cnt": cnt, "block": block, "shift": shift, "max_cnt": max_cnt}

    @functools.cached_property
    def encode_edges(self):
        """(bit_idx, acc_idx) int32 arrays listing every data-bit/accumulator
        connection, for the Tx accumulator-based encoder."""
        bit_idx = []
        acc_idx = []
        q, M, R = self.q, self.M, self.R
        m = np.arange(M, dtype=np.int64)
        for b, addrs in enumerate(self.block_addr):
            for x in addrs.tolist():
                bit_idx.append(b * M + m)
                acc_idx.append((x + m * q) % R)
        return (
            np.concatenate(bit_idx).astype(np.int32),
            np.concatenate(acc_idx).astype(np.int32),
        )

    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """Systematic encode: info bits (..., K) uint8 -> codeword (..., N)."""
        info_bits = np.asarray(info_bits, dtype=np.uint8)
        single = info_bits.ndim == 1
        if single:
            info_bits = info_bits[None]
        bit_idx, acc_idx = self.encode_edges
        out = np.empty(info_bits.shape[:-1] + (self.N,), dtype=np.uint8)
        for r in range(info_bits.shape[0]):
            acc = np.zeros(self.R, dtype=np.uint8)
            np.bitwise_xor.at(acc, acc_idx, info_bits[r, bit_idx])
            parity = np.bitwise_xor.accumulate(acc)
            out[r, : self.K] = info_bits[r]
            out[r, self.K:] = parity
        return out[0] if single else out


@functools.lru_cache(maxsize=None)
def get_code(name: str) -> LDPCCode:
    """Load a code by table name, e.g. "S2_B1", "S2X_C7", "T2_A3"."""
    z = _npz()
    meta = z[name + "__meta"]
    deg = z[name + "__deg"]
    ln = z[name + "__len"]
    pos = z[name + "__pos"]
    M, N, K, links_total, links_max_cn = (int(v) for v in meta)

    blocks = []
    p = 0
    for d, l in zip(deg.tolist(), ln.tolist()):
        for _ in range(l):
            blocks.append(pos[p: p + d].copy())
            p += d
    assert p == pos.size
    assert len(blocks) == K // M, (name, len(blocks), K // M)
    return LDPCCode(
        name=name,
        M=M,
        N=N,
        K=K,
        links_total=links_total,
        links_max_cn=links_max_cn,
        block_addr=tuple(blocks),
    )
