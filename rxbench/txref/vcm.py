"""VCM transmitter: per-frame MODCOD over a shared TS stream.

Frozen copy of the port's ``dvbs2rx_tpu_torch/tx/vcm.py`` without dummy
frames. The mode-adaptation stream (CRC-8 sync replacement, SYNCD phase)
is shared across MODCODs so TS packets flow continuously across frames of
different size.
"""

import numpy as np

from . import pl_defs
from .scramblers import crc8
from .transmitter import Transmitter


class VCMTransmitter:
    def __init__(self, configs, gold_code: int = 0):
        """configs: list of TxConfig (one per MODCOD used in the stream)."""
        self.txs = [Transmitter(c) for c in configs]
        self.gold_code = gold_code
        self._residue = np.empty(0, dtype=np.uint8)
        self._last_crc = 0
        self._stream_offset = 0

    def _mode_adapt(self, ts_bytes):
        ts = np.asarray(ts_bytes, dtype=np.uint8)
        assert ts.size % pl_defs.TS_PACKET_LENGTH == 0
        pkts = ts.reshape(-1, pl_defs.TS_PACKET_LENGTH)
        if not np.all(pkts[:, 0] == pl_defs.TS_SYNC_BYTE):
            raise ValueError("TS input missing 0x47 sync bytes")
        out = pkts.copy()
        for i in range(pkts.shape[0]):
            out[i, 0] = self._last_crc
            self._last_crc = crc8(pkts[i, 1:])
        return out.reshape(-1)

    def bbframes(self, ts_bytes, schedule):
        """TS bytes -> [(config index, BB-scrambled BBFRAME bytes), ...].

        ``schedule``: iterable of indexes into ``configs``, cycled until the
        TS stream is exhausted.
        """
        stream = np.concatenate([self._residue, self._mode_adapt(ts_bytes)])
        frames = []
        k = 0
        pos = 0
        while True:
            sel = schedule[k % len(schedule)]
            k += 1
            tx = self.txs[sel]
            if stream.size - pos < tx.df_bytes:
                break
            df = stream[pos: pos + tx.df_bytes]
            pos += tx.df_bytes
            syncd_bytes = (-self._stream_offset) % pl_defs.TS_PACKET_LENGTH
            hdr = tx._bbheader(syncd_bytes * 8)
            self._stream_offset = (
                self._stream_offset + tx.df_bytes
            ) % pl_defs.TS_PACKET_LENGTH
            frames.append((sel, np.concatenate([hdr, df]) ^ tx.bb_scramble))
        self._residue = stream[pos:]
        return frames

    def modulate_ts(self, ts_bytes, schedule):
        """TS bytes -> PLFRAME symbol stream."""
        frames = [self.txs[sel].plframe(self.txs[sel].xfecframe(
            self.txs[sel].fecframe_bits(bb)))
            for sel, bb in self.bbframes(ts_bytes, schedule)]
        return np.concatenate(frames) if frames else np.empty(0, np.complex64)
