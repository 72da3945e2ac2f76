"""DVB-S2 transmitter: MPEG TS in, IQ samples out.

Numpy implementation of the full Tx chain the reference app wires from
GNU Radio's in-tree gr-dtv blocks (``apps/dvbs2-tx:619-686``):

    TS -> BBHEADER framing (mode adaptation, CRC-8 sync replacement)
       -> BB scrambling -> BCH encode -> LDPC encode -> bit interleave
       -> constellation map -> PL framing (PLHEADER, pilots, PL scrambling)
       -> RRC pulse shaping -> (optional channel: AWGN + CFO + phase)

Copy of ``dvbs2rx_tpu/tx/transmitter.py``: the stimulus of the port's
tests and of ``chip_smoke.py``. Integer ``sps`` pulse-shapes with the RRC
FIR; fractional ``sps`` with the port's arbitrary resampler
(``ops/resample.StreamResampler`` with ``rrc_kernel``), one shot or
streamed (``pulse_shape_stream`` / ``pulse_shape_flush``).
``StreamingChannel`` is the chunked ``awgn_channel``.
"""

from dataclasses import dataclass

import numpy as np

from ..spec import pl_defs
from ..spec.pls import parse_pls, make_pls, PLSInfo
from ..spec.fec_params import get_fec_info, FECInfo, DVBS2_MODCODS, MODCOD_NUMBERS
from ..spec import bch_spec, reed_muller, pi2_bpsk
from ..spec.constellations import map_bits, BITS_PER_SYMBOL
from ..spec.interleaver import interleave
from ..spec.ldpc_tables import get_code
from ..spec.scramblers import (
    bb_derandomizer_bytes,
    crc8,
    pl_scrambling_sequence,
)
from ..spec.rrc import root_raised_cosine
from ..ops.resample import StreamResampler, rrc_kernel

# MATYPE-1 RO field (EN 302 307-1 Sec. 5.1.6). DVB-S2X (EN 302 307-2)
# keeps codes 0-2 and signals the low-rolloff set 0.15/0.10/0.05 with the
# formerly-reserved code 3 ("low roll-off range"); the specific value is
# known a-priori at the receiver (reference defs.py rolloff table carries
# all six values, python/dvbs2rx/defs.py:36-61).
ROLLOFF_CODE = {0.35: 0, 0.25: 1, 0.20: 2, 0.15: 3, 0.10: 3, 0.05: 3}


@dataclass
class TxConfig:
    modcod: str = "qpsk1/4"          # e.g. "qpsk1/2", "8psk3/5"
    frame_size: str = "normal"       # "normal" | "short"
    pilots: bool = False
    rolloff: float = 0.2
    sps: float = 2                   # samples per symbol (fractional allowed)
    gold_code: int = 0
    rrc_delay: int = 25              # RRC span in symbols (each side)

    def __post_init__(self):
        if float(self.sps).is_integer():
            self.sps = int(self.sps)  # integer fast path (plain FIR)
        elif self.sps <= 1.0:
            raise ValueError("sps must exceed 1 sample/symbol")
        key = self.modcod.lower()
        if key not in MODCOD_NUMBERS:
            raise ValueError(f"Unknown MODCOD {self.modcod!r}")
        self.modcod_num = MODCOD_NUMBERS[key]
        self.constellation, self.rate = DVBS2_MODCODS[self.modcod_num]
        self.pls = make_pls(self.modcod_num, self.frame_size == "short", self.pilots)
        self.pls_info: PLSInfo = parse_pls(self.pls)
        self.fec: FECInfo = get_fec_info(self.frame_size, self.rate)
        self.n_mod = BITS_PER_SYMBOL[self.constellation]


class Transmitter:
    def __init__(self, config: TxConfig):
        self.cfg = config
        fec = config.fec
        self.kbch_bytes = fec.kbch // 8
        self.dfl = fec.kbch - pl_defs.BB_HEADER_LENGTH_BITS  # CCM: full data field
        self.df_bytes = self.dfl // 8
        self.ldpc = get_code(fec.ldpc_table)
        self.bb_scramble = bb_derandomizer_bytes(self.kbch_bytes)
        self._plheader = self._build_plheader()
        self._pl_scramble = pl_scrambling_sequence(config.gold_code)[
            : config.pls_info.payload_len
        ]
        # Mode-adaptation stream state
        self._ts_residue = np.empty(0, dtype=np.uint8)  # CRC-ized UP stream tail
        self._last_crc = 0
        self._stream_offset = 0  # UP-stream phase (bytes mod 188) at next datafield
        # Streaming pulse-shape state: last ntaps-1 upsampled input samples
        # (integer sps) or a persistent arbitrary resampler (fractional sps)
        self._ps_tail = None
        self._ps_rs = None

    # ---------------- BB framing ----------------

    def _build_plheader(self):
        plsc_bits = reed_muller.encode(self.cfg.pls) ^ pl_defs.PLSC_SCRAMBLER_BITS
        bits = np.concatenate([pl_defs.SOF_BITS, plsc_bits])
        return pi2_bpsk.map_bpsk(bits)

    def _bbheader(self, syncd_bits: int) -> np.ndarray:
        """10-byte BBHEADER for TS/CCM/SIS mode (EN 302 307-1 Sec. 5.1.6)."""
        ro = ROLLOFF_CODE.get(self.cfg.rolloff, 0)
        matype1 = (0b11 << 6) | (1 << 5) | (1 << 4) | ro  # TS, SIS, CCM, ISSYI=0, NPD=0
        hdr = np.zeros(10, dtype=np.uint8)
        hdr[0] = matype1
        hdr[1] = 0  # MATYPE-2 (reserved in SIS)
        upl = pl_defs.TS_PACKET_LENGTH * 8
        hdr[2], hdr[3] = upl >> 8, upl & 0xFF
        hdr[4], hdr[5] = self.dfl >> 8, self.dfl & 0xFF
        hdr[6] = pl_defs.TS_SYNC_BYTE
        hdr[7], hdr[8] = syncd_bits >> 8, syncd_bits & 0xFF
        hdr[9] = crc8(hdr[:9])
        return hdr

    def _mode_adapt(self, ts_bytes: np.ndarray) -> np.ndarray:
        """TS packets -> continuous UP stream with sync bytes replaced by the
        CRC-8 of the previous packet's 187 data bytes (Sec. 5.1.3/5.1.4)."""
        ts = np.asarray(ts_bytes, dtype=np.uint8)
        assert ts.size % pl_defs.TS_PACKET_LENGTH == 0, "partial TS packet input"
        pkts = ts.reshape(-1, pl_defs.TS_PACKET_LENGTH)
        if not np.all(pkts[:, 0] == pl_defs.TS_SYNC_BYTE):
            raise ValueError("TS input missing 0x47 sync bytes")
        out = pkts.copy()
        for i in range(pkts.shape[0]):
            out[i, 0] = self._last_crc
            self._last_crc = crc8(pkts[i, 1:])
        return out.reshape(-1)

    def bbframes(self, ts_bytes: np.ndarray) -> np.ndarray:
        """Pack TS bytes into as many complete BBFRAMEs as possible.

        Returns (n_frames, kbch_bytes) uint8 (already BB-scrambled). Leftover
        UP-stream bytes are kept for the next call.
        """
        stream = np.concatenate([self._ts_residue, self._mode_adapt(ts_bytes)])
        n_frames = stream.size // self.df_bytes
        frames = []
        for i in range(n_frames):
            df = stream[i * self.df_bytes: (i + 1) * self.df_bytes]
            # SYNCD: distance from the datafield start to the next UP start
            # (UPs begin at stream offsets that are multiples of 188).
            syncd_bytes = (-self._stream_offset) % pl_defs.TS_PACKET_LENGTH
            hdr = self._bbheader(syncd_bytes * 8)
            self._stream_offset = (
                self._stream_offset + self.df_bytes
            ) % pl_defs.TS_PACKET_LENGTH
            frames.append(np.concatenate([hdr, df]) ^ self.bb_scramble)
        self._ts_residue = stream[n_frames * self.df_bytes:]
        return (
            np.stack(frames)
            if frames
            else np.empty((0, self.kbch_bytes), dtype=np.uint8)
        )

    # ---------------- FEC + modulation ----------------

    def fecframe_bits(self, bbframe: np.ndarray) -> np.ndarray:
        """BBFRAME bytes -> nldpc coded bits (BCH + LDPC, systematic)."""
        fec = self.cfg.fec
        msg_bits = np.unpackbits(bbframe)
        parity = bch_spec.bch_encode_bytes(bbframe, fec.framesize, fec.t)
        bch_cw = np.concatenate([msg_bits, np.unpackbits(parity)])
        assert bch_cw.size == fec.nbch
        return self.ldpc.encode(bch_cw)

    def xfecframe(self, fecframe_bits: np.ndarray) -> np.ndarray:
        """Coded bits -> constellation symbols (interleave + map)."""
        bits = interleave(fecframe_bits, self.cfg.constellation, self.cfg.rate)
        return map_bits(bits, self.cfg.constellation, self.cfg.rate).astype(np.complex64)

    # ---------------- PL framing ----------------

    def plframe(self, xfec_syms: np.ndarray) -> np.ndarray:
        """XFECFRAME -> PLFRAME symbols (header + pilots + PL scrambling)."""
        info = self.cfg.pls_info
        assert xfec_syms.size == info.xfecframe_len
        if info.n_pilots:
            payload = []
            pilot_blk = np.full(
                pl_defs.PILOT_BLK_LEN, pl_defs.PILOT_SYMBOL, dtype=np.complex64
            )
            for blk in range(info.n_pilots):
                start = blk * pl_defs.PILOT_BLK_INTERVAL
                payload.append(xfec_syms[start: start + pl_defs.PILOT_BLK_INTERVAL])
                payload.append(pilot_blk)
            payload.append(xfec_syms[info.n_pilots * pl_defs.PILOT_BLK_INTERVAL:])
            payload = np.concatenate(payload)
        else:
            payload = xfec_syms
        assert payload.size == info.payload_len
        payload = payload * self._pl_scramble
        return np.concatenate([self._plheader, payload]).astype(np.complex64)

    # ---------------- Waveform ----------------

    def modulate_ts(self, ts_bytes: np.ndarray) -> np.ndarray:
        """TS bytes -> PLFRAME symbol stream (1 sample/symbol)."""
        frames = self.bbframes(ts_bytes)
        out = [
            self.plframe(self.xfecframe(self.fecframe_bits(f))) for f in frames
        ]
        return (
            np.concatenate(out) if out else np.empty(0, dtype=np.complex64)
        )

    def pulse_shape(self, symbols: np.ndarray) -> np.ndarray:
        """Upsample by sps and apply the RRC transmit filter.

        Fractional sps uses the polyphase arbitrary resampler with exact
        continuous RRC taps (reference: ``apps/dvbs2-tx:638-686`` uses
        ``pfb_arb_resampler_ccf`` for non-integer interpolation ratios).
        """
        sps = self.cfg.sps
        if not isinstance(sps, int):
            rs = self._make_arb_shaper()
            return np.concatenate([rs(symbols), rs.flush()])
        up = np.zeros(symbols.size * sps, dtype=np.complex64)
        up[::sps] = symbols
        return np.convolve(up, self._rrc_taps()).astype(np.complex64)

    def _make_arb_shaper(self):
        return StreamResampler(
            self.cfg.sps,
            kernel=rrc_kernel(self.cfg.rolloff, self.cfg.rrc_delay),
            delay=self.cfg.rrc_delay,
        )

    def _rrc_taps(self) -> np.ndarray:
        sps = self.cfg.sps
        ntaps = 2 * sps * self.cfg.rrc_delay + 1
        return root_raised_cosine(sps, sps, 1.0, self.cfg.rolloff, ntaps)

    def pulse_shape_stream(self, symbols: np.ndarray) -> np.ndarray:
        """Streaming pulse shaping: exact chunked equivalent of
        ``pulse_shape`` with the FIR state carried across calls. The
        concatenation of all chunk outputs plus ``pulse_shape_flush()``
        equals the one-shot ``pulse_shape`` of the concatenated symbols."""
        if symbols.size == 0:
            return np.empty(0, dtype=np.complex64)
        if not isinstance(self.cfg.sps, int):
            if self._ps_rs is None:
                self._ps_rs = self._make_arb_shaper()
            return self._ps_rs(symbols)
        taps = self._rrc_taps()
        if self._ps_tail is None:
            self._ps_tail = np.zeros(taps.size - 1, dtype=np.complex64)
        up = np.zeros(symbols.size * self.cfg.sps, dtype=np.complex64)
        up[:: self.cfg.sps] = symbols
        buf = np.concatenate([self._ps_tail, up])
        out = np.convolve(buf, taps, mode="valid").astype(np.complex64)
        self._ps_tail = buf[-(taps.size - 1):]
        return out

    def pulse_shape_flush(self) -> np.ndarray:
        """Drain the streaming pulse-shape filter tail."""
        if not isinstance(self.cfg.sps, int):
            if self._ps_rs is None:
                return np.empty(0, dtype=np.complex64)
            out = self._ps_rs.flush()
            self._ps_rs = None
            return out
        taps = self._rrc_taps()
        if self._ps_tail is None:
            return np.empty(0, dtype=np.complex64)
        buf = np.concatenate(
            [self._ps_tail, np.zeros(taps.size - 1, dtype=np.complex64)]
        )
        self._ps_tail = None
        return np.convolve(buf, taps, mode="valid").astype(np.complex64)

    def ts_to_iq(self, ts_bytes: np.ndarray) -> np.ndarray:
        return self.pulse_shape(self.modulate_ts(ts_bytes))


class StreamingChannel:
    """Streaming channel impairments: CFO/phase rotation with an absolute
    sample counter and AWGN from one generator — the chunked equivalent of
    ``awgn_channel`` (reference ``apps/dvbs2-tx:579-593`` channel sim)."""

    def __init__(self, esn0_db=None, sps=2, freq_offset=0.0, phase=0.0, seed=0):
        self.esn0_db = esn0_db
        self.sps = sps
        self.freq_offset = freq_offset
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        self.n = 0

    def __call__(self, iq: np.ndarray) -> np.ndarray:
        iq = np.asarray(iq, dtype=np.complex64)
        if self.freq_offset or self.phase:
            n = np.arange(self.n, self.n + iq.size)
            iq = iq * np.exp(
                1j * (2 * np.pi * self.freq_offset * n + self.phase)
            ).astype(np.complex64)
        self.n += iq.size
        if self.esn0_db is not None:
            n0 = 10.0 ** (-self.esn0_db / 10.0)
            sigma = np.sqrt(self.sps * n0 / 2.0)
            noise = self.rng.normal(0, sigma, (iq.size, 2)).astype(np.float32)
            iq = iq + noise[:, 0] + 1j * noise[:, 1]
        return iq


def awgn_channel(iq, esn0_db, sps=2, freq_offset=0.0, phase=0.0, seed=0):
    """Apply CFO, static phase, and AWGN at the given Es/N0 (dB).

    ``freq_offset`` is normalized to the *sample* rate. Conventions match the
    Tx scaling: ``pulse_shape`` uses an RRC with DC gain sps, giving unit
    per-sample signal power, and the Rx matched filter is the unit-DC-gain
    RRC, so the post-MF symbols come out at unit energy with complex noise
    variance N0 = 1/EsN0 exactly. That requires per-sample complex noise
    variance sps * N0 (the classic Es/N0 - 10log10(sps) sample SNR).
    """
    iq = np.asarray(iq, dtype=np.complex64)
    rng = np.random.default_rng(seed)
    if freq_offset or phase:
        n = np.arange(iq.size)
        iq = iq * np.exp(1j * (2 * np.pi * freq_offset * n + phase)).astype(np.complex64)
    esn0 = 10.0 ** (esn0_db / 10.0)
    n0 = 1.0 / esn0
    sigma = np.sqrt(sps * n0 / 2.0)  # per real dimension
    noise = rng.normal(0, sigma, (iq.size, 2)).astype(np.float32)
    return iq + noise[:, 0] + 1j * noise[:, 1]
