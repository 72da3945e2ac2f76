"""VCM/ACM transmitter: per-frame MODCOD over a shared TS stream.

Copy of ``dvbs2rx_tpu/tx/vcm.py`` on the port's own ``tx/transmitter.py``
and ``spec``: the stimulus of the port's VCM tests and of
``chip_smoke.py``. The mode-adaptation stream (CRC-8 sync replacement,
SYNCD phase) is shared across MODCODs so TS packets flow continuously
across frames of different size. Also provides dummy PLFRAMEs (PLS 0: 36
slots of scrambled unmodulated carrier, standard Sec. 5.5.1).
"""

import numpy as np

from ..spec import pl_defs, reed_muller
from ..spec.pi2_bpsk import map_bpsk
from ..spec.pls import parse_pls
from ..spec.scramblers import crc8, pl_scrambling_sequence
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

    def dummy_plframe(self) -> np.ndarray:
        """PLS 0 dummy frame: header + 36 slots of scrambled CW."""
        plsc_bits = reed_muller.encode(0) ^ pl_defs.PLSC_SCRAMBLER_BITS
        hdr = map_bpsk(np.concatenate([pl_defs.SOF_BITS, plsc_bits]))
        info = parse_pls(0)
        cw = np.full(info.payload_len, pl_defs.PILOT_SYMBOL, dtype=np.complex64)
        scr = pl_scrambling_sequence(self.gold_code)[: info.payload_len]
        return np.concatenate([hdr, cw * scr]).astype(np.complex64)

    def modulate_ts(self, ts_bytes, schedule):
        """TS bytes -> PLFRAME symbol stream.

        ``schedule``: iterable of indexes into ``configs`` (or -1 for a dummy
        frame), cycled until the TS stream is exhausted.
        """
        stream = np.concatenate([self._residue, self._mode_adapt(ts_bytes)])
        frames = []
        k = 0
        pos = 0
        while True:
            sel = schedule[k % len(schedule)]
            k += 1
            if sel < 0:
                frames.append(self.dummy_plframe())
                continue
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
            bbframe = np.concatenate([hdr, df]) ^ tx.bb_scramble
            frames.append(tx.plframe(tx.xfecframe(tx.fecframe_bits(bbframe))))
        self._residue = stream[pos:]
        return np.concatenate(frames) if frames else np.empty(0, np.complex64)

    def ts_to_iq(self, ts_bytes, schedule):
        syms = self.modulate_ts(ts_bytes, schedule)
        return self.txs[0].pulse_shape(syms)
