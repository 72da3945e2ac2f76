"""TS packet reassembly from decoded BBFRAMEs (receive side, host).

Copy of the parts of ``dvbs2rx_tpu/spec/bb_frame.py`` that the port's
``StreamEngine`` reaches: ``BatchTSStitcher`` and the per-frame flagged
stitch it falls back to when the native extension is not built. Semantics
of the reference's ``bbdeheader_bb`` block (``lib/bbdeheader_bb_impl.cc:
76-261``): BBHEADER validation, SYNCD-based resynchronization,
partial-packet carry across BBFRAMEs, 0x47 sync restoration, and
Transport-Error-Indicator marking on user-packet CRC failure. The CRC-8
checks come from the device (``ops/crc8_dev.packet_validity``), so only the
one packet per frame that spans two frames is checked on the host.
"""

from dataclasses import dataclass

import numpy as np

from .pl_defs import (
    BB_HEADER_LENGTH_BYTES,
    BB_HEADER_LENGTH_BITS,
    TS_PACKET_LENGTH,
    TS_SYNC_BYTE,
    TRANSPORT_ERROR_INDICATOR,
)
from ..io import native
from .scramblers import crc8_check


@dataclass
class BBHeader:
    ts_gs: int
    sis_mis: int
    ccm_acm: int
    issyi: int
    npd: int
    ro: int
    isi: int
    upl: int
    dfl: int
    sync: int
    syncd: int


@dataclass
class BBFrameStats:
    bbframe_cnt: int = 0
    bbframe_drop_cnt: int = 0
    bbframe_gap_cnt: int = 0
    packet_cnt: int = 0
    error_cnt: int = 0


class BBFrameParser:
    """Stateful BBFRAME -> TS packet reassembler with device CRC flags;
    each ``push`` validates against the pushed frame's own length."""

    def __init__(self):
        self.synched = False
        self.partial = np.empty(0, dtype=np.uint8)
        self.stats = BBFrameStats()

    @staticmethod
    def parse_header(frame: np.ndarray, max_dfl: int):
        """BBHEADER fields, or None when they are out of range (the CRC-8
        of the header is checked on the device: ``hdr_ok``)."""
        # python ints once (numpy uint8 scalar arithmetic is ~10x slower
        # per op; this parse runs per frame in the streaming hot loop)
        b = frame[:BB_HEADER_LENGTH_BYTES].tobytes()
        h = BBHeader(
            ts_gs=(b[0] >> 6) & 0x3,
            sis_mis=(b[0] >> 5) & 0x1,
            ccm_acm=(b[0] >> 4) & 0x1,
            issyi=(b[0] >> 3) & 0x1,
            npd=(b[0] >> 2) & 0x1,
            ro=b[0] & 0x3,
            isi=b[1] if (b[0] >> 5) & 0x1 == 0 else 0,
            upl=(b[2] << 8) | b[3],
            dfl=(b[4] << 8) | b[5],
            sync=b[6],
            syncd=(b[7] << 8) | b[8],
        )
        if h.dfl > max_dfl or h.dfl % 8 != 0:
            return None
        if h.syncd > h.dfl or h.syncd % 8 != 0:
            return None
        if h.upl != TS_PACKET_LENGTH * 8:
            return None
        return h

    def push(self, frame: np.ndarray, pkt_ok: np.ndarray,
             hdr_ok: bool) -> np.ndarray:
        """Process one descrambled BBFRAME; returns TS bytes.

        ``pkt_ok``/``hdr_ok``: device-precomputed CRC-8 validity
        (``ops/crc8_dev.packet_validity``: pkt_ok is the LSB-first packed
        per-position window-CRC map, hdr_ok the BBHEADER check), so the
        stitch is a flag lookup and a memcpy."""
        frame = np.asarray(frame, dtype=np.uint8)
        self.stats.bbframe_cnt += 1
        h = None
        if hdr_ok:
            h = self.parse_header(
                frame, max_dfl=frame.size * 8 - BB_HEADER_LENGTH_BITS)
        if h is None:
            self.synched = False
            self.stats.bbframe_drop_cnt += 1
            return np.empty(0, dtype=np.uint8)
        return self._push_flagged(frame, h, pkt_ok)

    def _push_flagged(self, frame, h, pkt_ok):
        """Vectorized stitch with device-precomputed packet validity."""
        df_start = BB_HEADER_LENGTH_BYTES
        df = frame[df_start: df_start + h.dfl // 8]
        pos = 0
        if self.partial.size > 0 and (
            h.syncd // 8 != TS_PACKET_LENGTH - 1 - self.partial.size
        ):
            self.synched = False
            self.stats.bbframe_gap_cnt += 1

        # native fast path: flag-lookup stitch entirely in C (only the one
        # cross-frame packet per call computes a CRC); bit-identical to the
        # numpy path below
        if native.has_ts_stitch_flagged():
            ts, new_partial, n_err = native.ts_stitch_flagged(
                df, self.partial, self.synched, h.syncd // 8, pkt_ok,
                df_start,
            )
            self.synched = True
            self.partial = new_partial
            self.stats.error_cnt += n_err
            self.stats.packet_cnt += ts.size // TS_PACKET_LENGTH
            return ts

        if not self.synched:
            pos = h.syncd // 8 + 1
            self.synched = True
            self.partial = np.empty(0, dtype=np.uint8)

        out = []
        # the reference's completion gate: partial + fresh bytes reaching
        # 188 completes, even on short DFLs
        if self.partial.size > 0 and (
            self.partial.size + df.size - pos >= TS_PACKET_LENGTH
        ):
            # the one cross-frame packet: its CRC window spans two frames,
            # so the host checks it (187 bytes, once per frame)
            need = TS_PACKET_LENGTH - self.partial.size
            packet = np.concatenate([self.partial, df[pos: pos + need]])
            self.partial = np.empty(0, dtype=np.uint8)
            pos += need
            ts_pkt = np.empty(TS_PACKET_LENGTH, dtype=np.uint8)
            ts_pkt[0] = TS_SYNC_BYTE
            ts_pkt[1:] = packet[:-1]
            if not crc8_check(packet):
                ts_pkt[1] |= TRANSPORT_ERROR_INDICATOR
                self.stats.error_cnt += 1
            self.stats.packet_cnt += 1
            out.append(ts_pkt)

        n = max(0, (df.size - pos) // TS_PACKET_LENGTH)
        if n:
            body = df[pos: pos + n * TS_PACKET_LENGTH].reshape(
                n, TS_PACKET_LENGTH
            )
            ts = np.empty((n, TS_PACKET_LENGTH), dtype=np.uint8)
            ts[:, 0] = TS_SYNC_BYTE
            ts[:, 1:] = body[:, :-1]
            # CRC byte of packet k sits at frame index
            # df_start + pos + 187 + 188*k; look its validity up in the
            # device-computed map (LSB-first packed)
            idx = (df_start + pos + TS_PACKET_LENGTH - 1
                   + TS_PACKET_LENGTH * np.arange(n))
            okb = (pkt_ok[idx >> 3] >> (idx & 7)) & 1
            bad = okb == 0
            ts[bad, 1] |= TRANSPORT_ERROR_INDICATOR
            self.stats.error_cnt += int(bad.sum())
            self.stats.packet_cnt += n
            pos += n * TS_PACKET_LENGTH
            out.append(ts.reshape(-1))
        if df.size - pos > 0:
            self.partial = np.concatenate([self.partial, df[pos:]])
        return (
            np.concatenate(out) if out else np.empty(0, dtype=np.uint8)
        )


class BatchTSStitcher:
    """Whole-step TS stitching: C channels x F frames in ONE native call.

    The per-frame ``BBFrameParser.push`` API costs ~10 us of Python glue
    per frame (header parse, buffer conversions, wrapper frames) — at 64
    channels that glue, not the CRC math, dominates the host stitch. This
    class keeps the per-channel reassembly state (partial carry, sync
    flag, counters) in flat numpy arrays mutated in place by
    ``native.ts_stitch_flagged_batch`` so one step's whole (C, F) frame
    block stitches in a single call (the reference's equivalent loop is
    C++ inside one block too, ``lib/bbdeheader_bb_impl.cc:144-261``).
    Bit-identical to per-frame flagged pushes; falls back to them when the
    native entry point is unavailable.

    ``push_step(frames, ok_maps, hdr_ok)``: frames (C, F, nb) DESCRAMBLED
    bytes, ok_maps (C, F, ok_nb) packed per-position validity
    (``ops/crc8_dev.packet_validity``), hdr_ok (C, F) bool. Returns a list
    of C per-channel TS byte arrays.
    """

    def __init__(self, n_channels: int):
        C = n_channels
        self.C = C
        ext = native.load()
        self._ext = ext if (ext and hasattr(ext, "ts_stitch_flagged_batch")) \
            else None
        self.partial = np.zeros((C, TS_PACKET_LENGTH), np.uint8)
        self.plen = np.zeros((C,), np.int32)
        self.synched = np.zeros((C,), np.uint8)
        # [packets, errors, gaps, drops, bbframes] per channel
        self.counters = np.zeros((C, 5), np.int64)
        self._parsers = (
            None if self._ext else [BBFrameParser() for _ in range(C)]
        )

    def push_step(self, frames: np.ndarray, ok_maps: np.ndarray,
                  hdr_ok: np.ndarray):
        C = self.C
        frames = np.ascontiguousarray(frames, np.uint8)
        _, F, nb = frames.shape
        if self._ext is not None:
            ok_maps = np.ascontiguousarray(ok_maps, np.uint8)
            hdr = np.ascontiguousarray(hdr_ok).astype(np.uint8)
            ts_all, sizes = self._ext.ts_stitch_flagged_batch(
                frames, C, F, nb, ok_maps, ok_maps.shape[-1], hdr,
                BB_HEADER_LENGTH_BYTES, self.partial, self.plen,
                self.synched, self.counters,
            )
            flat = np.frombuffer(ts_all, np.uint8)
            sz = np.frombuffer(sizes, np.int64)
            off = np.concatenate([[0], np.cumsum(sz)])
            return [flat[off[c]: off[c + 1]] for c in range(C)]
        # fallback: per-frame parsers, counters mirrored for stats parity
        out = []
        for c in range(C):
            p = self._parsers[c]
            parts = [
                p.push(frames[c, f], pkt_ok=ok_maps[c, f],
                       hdr_ok=bool(hdr_ok[c, f]))
                for f in range(F)
            ]
            st = p.stats
            self.counters[c] = (st.packet_cnt, st.error_cnt,
                                st.bbframe_gap_cnt, st.bbframe_drop_cnt,
                                st.bbframe_cnt)
            out.append(
                np.concatenate(parts) if parts else np.empty(0, np.uint8)
            )
        return out

    @property
    def stats(self) -> BBFrameStats:
        """Aggregated counters in the ``BBFrameParser.stats`` shape (the
        ``Receiver.get_stats`` contract)."""
        tot = self.counters.sum(axis=0)
        return BBFrameStats(
            bbframe_cnt=int(tot[4]),
            bbframe_drop_cnt=int(tot[3]),
            bbframe_gap_cnt=int(tot[2]),
            packet_cnt=int(tot[0]),
            error_cnt=int(tot[1]),
        )
