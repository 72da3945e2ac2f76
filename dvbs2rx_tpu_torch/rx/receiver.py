"""The host receivers: configuration, statistics, FEC and ``make_receiver``.

Port of ``dvbs2rx_tpu/rx/receiver.py``:

- ``RxConfig``/``RxStats`` (same fields, defaults and ``__post_init__``,
  built on the port's own ``spec``), ``get_stats``, the post-decoder SNR
  refinement and the acquisition metric;
- the per-code decoder factories: ``get_ldpc_decoder`` routes as
  ``_make_ldpc_decoder`` does (offset-min-sum with the normal update to the
  CUDA kernel's wrapper, every other rule to the plain decoder on the
  configured device) and ``get_bch_decoder``; ``FECStage``, the lane-major
  FEC stage of the stream receivers;
- ``Receiver`` (CCM) and ``ACMReceiver`` (PLSC-driven ACM/VCM), which
  ``make_receiver`` returns: a host loop over numpy sample and symbol
  buffers around device stages (front end, timing metric, PLSC decode,
  frame-group program, FEC, SNR refinement). The front end's timing
  recovery is ``sym_sync_impl``'s: the feed-forward ``ops/ffsync.py`` (sps
  2; the matched-filter kernel on the card) or the Gardner loop of
  ``ops/frontend.SymbolSync`` (any even sps; the Gardner kernel on the
  card).

Every device stage is a batch function: it takes a list of per-channel
argument tuples, runs them as one call with the channels on a leading axis,
and returns a list of per-channel results. A receiver reaches it through
``self._call(key, fn, args)``, which on its own runs ``fn([args])[0]``;
``rx/acm_batch.BatchedACMReceiver`` replaces ``_call`` to run the requests of
its C channels together. (The JAX package jits each stage per channel and
vmaps it for the batched receiver.)

The TS stitch takes device CRC-8 flags (``ops/crc8_dev.packet_validity``),
as the stream engines do; the JAX receivers stitch without them, and the two
paths give the same bytes and counters.
"""

import datetime
import functools
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..spec.constellations import constellation_points
from ..spec.fec_params import (
    DVBS2_MODCODS,
    MODCOD_NUMBERS,
    FECInfo,
    get_fec_info,
)
from ..spec.interleaver import column_order
from ..spec.ldpc_tables import get_code
from ..spec.bb_frame import BBFrameParser
from ..spec.pl_defs import PLHEADER_LEN
from ..spec.pls import PLSInfo, make_pls, parse_pls
from ..spec.scramblers import (
    bb_derandomizer_bytes,
    pl_descrambling_sequence,
)

from ..ops import cplx, plsync, snr_cuda
from ..ops.bch import BCHDecoder
from ..ops.crc8_dev import packet_validity
from ..ops.demap import demap, estimate_snr_generic, estimate_snr_qpsk
from ..ops.ffsync import FeedForwardSync, FFSyncState
from ..ops.frontend import SymbolSync
from ..ops.frontend_cuda import frontend
from ..ops.ldpc import LDPCDecoder
from ..ops.ldpc_cuda import CudaLDPCDecoder
from ..utils.runtime import device_table, resolve_device

_BYTE_W = 1 << np.arange(7, -1, -1, dtype=np.int64)


@dataclass
class RxConfig:
    modcod: str = "qpsk1/4"
    frame_size: str = "normal"
    pilots: bool = False
    rolloff: float = 0.2
    sps: int = 2
    gold_code: int = 0
    sym_sync_impl: str = "ffw"    # "ffw" (feed-forward O&M) or "gardner"
    sym_sync_loop_bw: float = 0.01
    damping: float = 1.0
    rrc_delay: int = 5
    n_subfilt: int = 128
    ldpc_max_trials: int = 25
    ldpc_impl: str = "auto"       # JAX decoder choice; the port decodes
                                  # with the CUDA kernel on the card and its
                                  # plain version on the CPU
    ldpc_algo: str = "offset-min-sum"  # | "min-sum" | "min-sum-c"
    ldpc_update: str = "normal"   # | "self-corrected"
    fec_batch: int = 8
    frame_group: int = 4
    frontend_block: int = 4096
    coarse_period: int = 30
    unlock_thresh: int = 3
    closed_loop: bool = True
    agc: bool = True
    agc_gain: float = 1.0
    agc_rate: float = 1e-5
    agc_ref: float = 1.0
    out_stream: str = "ts"
    acm_vcm: bool = False
    pls_list: tuple = ()
    pls_expected: tuple = ()
    mf_precision: str = "default"  # JAX's TPU conv precision; the port's
                                  # matched filter is exact float32
    plsc_mode: str = "coherent-soft"

    def __post_init__(self):
        key = self.modcod.lower()
        if key not in MODCOD_NUMBERS:
            raise ValueError(f"Unknown MODCOD {self.modcod!r}")
        self.modcod_num = MODCOD_NUMBERS[key]
        self.constellation, self.rate = DVBS2_MODCODS[self.modcod_num]
        self.pls = make_pls(self.modcod_num, self.frame_size == "short",
                            self.pilots)
        self.pls_info: PLSInfo = parse_pls(self.pls)
        self.fec: FECInfo = get_fec_info(self.frame_size, self.rate)
        if self.plsc_mode not in (
            "coherent-soft", "coherent-hard", "differential"
        ):
            raise ValueError(f"Unknown PLSC decode mode {self.plsc_mode!r}")


@dataclass
class RxStats:
    locked: bool = False
    sof_cnt: int = 0
    frame_cnt: int = 0
    rejected_cnt: int = 0
    dummy_cnt: int = 0
    lock_cnt: int = 0
    unlock_cnt: int = 0
    coarse_foffset: float = 0.0
    fine_foffset: float = 0.0
    cum_freq_offset: float = 0.0
    coarse_corrected: bool = False
    snr_db: float = 0.0
    ldpc_frames: int = 0
    ldpc_total_iters: int = 0
    bch_frames: int = 0
    bch_frame_errors: int = 0
    bch_corrections: int = 0
    lock_time: float = 0.0

    def as_dict(self):
        d = dict(self.__dict__)
        d["ldpc_avg_iters"] = (
            self.ldpc_total_iters / self.ldpc_frames if self.ldpc_frames else 0.0
        )
        return d


def get_stats(self, sym_rate: float = None) -> dict:
    """Nested statistics in the reference's ``get_stats`` shape
    (``Receiver.get_stats`` of the JAX package; reads ``self.stats`` and
    ``self.bb_parser.stats``)."""
    s = self.stats
    bb = self.bb_parser.stats
    fer = s.bch_frame_errors / s.bch_frames if s.bch_frames else None
    per = bb.error_cnt / bb.packet_cnt if bb.packet_cnt else None
    foff = s.cum_freq_offset
    return {
        "lock": s.locked,
        "snr": s.snr_db if s.bch_frames else None,
        "plsync": {
            "coarse_freq_corr": s.coarse_corrected,
            "freq_offset_norm": foff,
            "freq_offset_hz": foff * sym_rate if sym_rate else None,
            "sof_count": s.sof_cnt,
            "frame_count": {
                "processed": s.frame_cnt,
                "rejected": s.rejected_cnt,
                "dummy": s.dummy_cnt,
            },
            "locked_since": (
                datetime.datetime.fromtimestamp(s.lock_time).isoformat()
                if s.locked and s.lock_time else None
            ),
        },
        "fec": {
            "frames": s.bch_frames,
            "errors": s.bch_frame_errors,
            "fer": fer,
            "avg_ldpc_trials": (
                s.ldpc_total_iters / s.ldpc_frames if s.ldpc_frames else None
            ),
        },
        "bbframes": {
            "processed": bb.bbframe_cnt,
            "dropped": bb.bbframe_drop_cnt,
            "gaps": bb.bbframe_gap_cnt,
        },
        "mpeg-ts": {
            "packets": bb.packet_cnt,
            "errors": bb.error_cnt,
            "per": per,
        },
    }


@functools.lru_cache(maxsize=32)
def _points(constellation, rate):
    return cplx.from_np(constellation_points(constellation, rate))


def _snr_refine_frames(xfec, hard_bits, constellation, rate, n_mod):
    """Per-frame refined linear SNR from decoded bits (reference
    ``xfecframe_demapper_cb_impl.cc:188-318``): re-map the decoded codeword
    to constellation points and measure the error against the XFECFRAME
    symbols. xfec (B, R, 2) with R <= rows; hard_bits (B, n_ldpc). CUDA
    tensors take one launch of ``ops.snr_cuda``, CPU tensors the plain
    version ``_snr_refine_plain``."""
    if xfec.is_cuda:
        return snr_cuda.snr_refine(xfec, hard_bits, constellation, rate,
                                   n_mod)[0]
    return _snr_refine_plain(xfec, hard_bits, constellation, rate, n_mod)


def _snr_refine_plain(xfec, hard_bits, constellation, rate, n_mod):
    """``_snr_refine_frames`` in PyTorch operators, on any device."""
    order = column_order(constellation, rate)
    bits = hard_bits.to(torch.int64)
    B = bits.shape[0]
    rows = bits.shape[1] // n_mod
    if order is None:
        sym_bits = bits.reshape(B, rows, n_mod)
    else:
        cols = bits.reshape(B, n_mod, rows)
        sym_bits = torch.stack([cols[:, c] for c in order], dim=-1)
    idx = torch.zeros((B, rows), dtype=torch.int64, device=bits.device)
    for b in range(n_mod):
        idx = (idx << 1) | sym_bits[..., b]
    idx = idx[:, : xfec.shape[1]]
    ref = device_table(_points(constellation, rate), xfec.device)[idx]
    sp = (ref * ref).sum(-1).sum(-1)
    np_ = ((xfec - ref) ** 2).sum(-1).sum(-1)
    return sp / np_.clamp(min=1e-12)


def _snr_refine_n0(xfec, hard_bits, constellation, rate, n_mod, n0):
    """``_snr_refine_frames`` and the refined N0 carry from it: (snr (B,),
    n0' (B,)), n0' = 1 / max(snr, 1e-9) where snr > 0, else the carried
    n0. One launch of ``ops.snr_cuda`` on CUDA tensors."""
    if xfec.is_cuda:
        return snr_cuda.snr_refine(xfec, hard_bits, constellation, rate,
                                   n_mod, n0)
    snr = _snr_refine_frames(xfec, hard_bits, constellation, rate, n_mod)
    return snr, torch.where(snr > 0, 1.0 / snr.clamp(min=1e-9), n0)


def acq_metric(symbols):
    """Acquisition metric over symbol blocks (..., N, 2): the dense timing
    metric with a zero history (``Receiver._acq_impl``)."""
    hist = torch.zeros(symbols.shape[:-2] + (90, 2), dtype=torch.float32,
                       device=symbols.device)
    return plsync.timing_metric(symbols, hist)[0]


def get_ldpc_decoder(table: str, max_trials: int = 25,
                     algo: str = "offset-min-sum", update: str = "normal",
                     device=None):
    """The LDPC decoder of code ``table`` for one rule, one per (table,
    trials, rule, device), routed as the JAX ``_make_ldpc_decoder`` does:
    offset-min-sum with the normal update is the CUDA kernel's wrapper (the
    kernel on CUDA tensors, its plain version on CPU tensors); every other
    (algo, update) is the plain decoder on ``device``, the rules the kernel
    does not implement. The choice is made by configuration only."""
    dev = resolve_device(device)
    if (algo, update) == ("offset-min-sum", "normal"):
        return _ldpc_decoder(table, max_trials, dev)
    return _plain_ldpc_decoder(table, max_trials, algo, update, dev)


@functools.lru_cache(maxsize=None)
def _ldpc_decoder(table, max_trials, device):
    return CudaLDPCDecoder(get_code(table), max_trials, device)


@functools.lru_cache(maxsize=None)
def _plain_ldpc_decoder(table, max_trials, algo, update, device):
    return LDPCDecoder(get_code(table), max_trials, device, algo, update)


def get_bch_decoder(framesize: str, t: int, nbch: int, kbch: int,
                    device=None) -> BCHDecoder:
    """The BCH decoder of one (frame size, t, nbch, kbch), one per device
    (its Chien matrix is built once, on the first frame that needs it)."""
    return _bch_decoder(framesize, t, nbch, kbch, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _bch_decoder(framesize, t, nbch, kbch, device):
    return BCHDecoder(framesize, t, nbch, kbch, device)


class PLSTables:
    """The constant resources of one PLS under one configuration: frame
    geometry, FEC parameters, the decoders (``get_ldpc_decoder`` with the
    configured rule, ``get_bch_decoder``), the BB scrambler and the planar
    (payload_len, 2) PL descrambling sequence, on ``device``."""

    def __init__(self, cfg: RxConfig, pls: int, device):
        info = parse_pls(pls)
        self.pls = pls
        self.info = info
        self.constellation, self.rate = DVBS2_MODCODS[info.modcod]
        framesize = "short" if info.short_fecframe else "normal"
        self.fec = fec = get_fec_info(framesize, self.rate)
        self.ldpc = get_ldpc_decoder(fec.ldpc_table, cfg.ldpc_max_trials,
                                     cfg.ldpc_algo, cfg.ldpc_update, device)
        self.bch = get_bch_decoder(framesize, fec.t, fec.nbch, fec.kbch,
                                   device)
        self.bb_scramble = torch.as_tensor(
            bb_derandomizer_bytes(fec.kbch // 8), device=device)
        self.descr = torch.as_tensor(cplx.from_np(
            pl_descrambling_sequence(cfg.gold_code)[: info.payload_len]),
            device=device)


class FECStage:
    """Lane-major FEC stage and the frame tables of one configuration (the
    ``PLSTables`` of ``cfg.pls``).

    ``lane_major(llrsT (N, B) int8)`` -> (kbytes (B, kbch/8) uint8, n_corr
    (B,) int32, iters (B,) int32, ok (B,) int32, hard_t (N, B) uint8). On a
    CUDA tensor the LDPC decode of the default rule is the hand-written
    kernel; ``sync_free=True`` takes the BCH form that reads nothing back.
    """

    def __init__(self, cfg: RxConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        tab = PLSTables(cfg, cfg.pls, self.device)
        self.frame_len = tab.info.plframe_len
        self.payload_len = tab.info.payload_len
        self.ldpc, self.bch = tab.ldpc, tab.bch
        self.bb_scramble, self.descr = tab.bb_scramble, tab.descr

    def lane_major(self, llrsT, sync_free: bool = False):
        return fec_lane_major(self.ldpc, self.bch, self.cfg.fec, llrsT,
                              sync_free)


def fec_lane_major(ldpc, bch, fec: FECInfo, llrsT, sync_free: bool = False):
    """LDPC -> BCH -> byte packing of one code (``Receiver.
    _fec_stage_lane_major_impl``, but with the iterations of each frame,
    whose maximum is its ``iters``): llrsT (N, B) int8 -> (kbytes (B,
    kbch/8) uint8, n_corr (B,) int32, iters (B,) int32, ok (B,) int32,
    hard_t (N, B) uint8). ``sync_free`` as in ``BCHDecoder.
    decode_lane_major``."""
    hard_t, _llrs_out, iters, ok = ldpc.decode_frames(llrsT)
    corrected_t, n_corr = bch.decode_lane_major(hard_t[: fec.nbch],
                                                sync_free)
    kbits_t = corrected_t[: fec.kbch].to(torch.int64)
    B = kbits_t.shape[1]
    w = device_table(_BYTE_W, kbits_t.device)
    kbytes = (kbits_t.reshape(-1, 8, B) * w[:, None]).sum(1)
    return (kbytes.to(torch.uint8).t().contiguous(), n_corr.to(torch.int32),
            iters.to(torch.int32), ok.to(torch.int32), hard_t)


def _coarse_foffset_np(r):
    """Host finalization of the coarse CFO estimate from the accumulated
    (89,) or (25,) complex autocorrelation (the JAX module's numpy copy of
    ``plsync.coarse_foffset_from_autocorr``)."""
    N = r.shape[-1] + 1
    angles = np.arctan2(np.imag(r), np.real(r))
    diff = np.diff(np.concatenate([[0.0], angles]))
    diff = np.where(diff > np.pi, diff - 2 * np.pi, diff)
    diff = np.where(diff < -np.pi, diff + 2 * np.pi, diff)
    L = N - 1
    m = np.arange(L, dtype=np.float64)
    w = 3.0 * ((2 * L + 1.0) ** 2 - (2 * m + 1.0) ** 2) / (
        ((2 * L + 1.0) ** 2 - 1) * (2 * L + 1)
    )
    return float(np.clip(np.sum(diff * w) / (2 * np.pi), -0.5, 0.5))


def _to_host(*ts):
    """Several tensors to float32 numpy arrays in one device->host copy
    (integers below 2^24 survive the float32 round trip exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in ts])
    flat = flat.cpu().numpy()
    out, o = [], 0
    for t in ts:
        out.append(flat[o: o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    return out


_PLSC_DECODERS = {
    "coherent-soft": plsync.plsc_decode_soft,
    "coherent-hard": plsync.plsc_decode_hard,
    "differential": plsync.plsc_decode_diff,
}


def group_program(tab: PLSTables, headers, plsv, payloads, coarse_corrected,
                  n0_override):
    """The per-PLS frame-group program (the JAX ``_acm_group_impl`` and the
    common part of ``Receiver._frame_group_impl``) over a leading channel
    axis: headers (C, F+1, 90, 2) whose last belongs to the next frame, plsv
    (C, F+1) their PLS values, payloads (C, F, Lp, 2), coarse_corrected (C,)
    bool, n0_override (C,) float (> 0 demaps with the refined N0).

    Returns (fine (C, F), n0 (C,) data-aided from frame 0, llrs (C, F, N)
    int8, xfec (C, F, R, 2))."""
    info = tab.info
    F = payloads.shape[1]
    hdr_phase = plsync.plheader_phase(headers, plsv)             # (C, F+1)
    pay_d = cplx.cmul(payloads, tab.descr)
    cc = coarse_corrected[:, None]
    if info.has_pilots:
        fine = plsync.fine_foffset_pilot_mode(
            headers[:, :F], pay_d, plsv[:, :F], info.n_pilots)
        pil_ph = plsync.pilot_phases(pay_d, info.n_pilots)
        xfec = plsync.correct_payload_pilots(
            pay_d, hdr_phase[:, :F], pil_ph, torch.where(cc, fine, 0.0),
            info.n_slots, info.n_pilots)
    else:
        fine = plsync.fine_foffset_pilotless(
            hdr_phase[:, :F], hdr_phase[:, 1:], info.plframe_len)
        xfec = plsync.correct_payload_pilotless(
            pay_d, hdr_phase[:, :F], torch.where(cc, fine, 0.0))
    if tab.constellation == "QPSK":
        snr = estimate_snr_qpsk(xfec[:, 0])
    else:
        snr = estimate_snr_generic(xfec[:, 0], tab.constellation, tab.rate)
    n0 = 1.0 / snr.clamp(min=1e-9)
    n0_d = torch.where(n0_override > 0, n0_override, n0)
    llrs = demap(xfec, n0_d[:, None].expand(-1, F), tab.constellation,
                 tab.rate)
    return fine, n0, llrs, xfec


class Receiver:
    """CCM host receiver: ``receive(iq)`` takes complex64 samples at ``sps``
    per symbol and returns the TS bytes recovered so far (or the descrambled
    BBFRAMEs with ``out_stream="bb"``); ``get_stats`` gives the
    reference-shaped statistics.

    Architectural rules kept from the JAX receiver: payload n is processed
    only after PLHEADER n+1 (two-SOF rule); coarse corrections feed the
    rotator until coarse-corrected, then the fine estimator takes over; the
    lock state machine goes searching -> locked and back after
    ``unlock_thresh`` weak timing metrics in a row.
    """

    get_stats = get_stats

    def __init__(self, cfg: RxConfig, device=None):
        if cfg.sym_sync_impl not in ("ffw", "gardner"):
            raise ValueError(f"Unknown sym_sync_impl {cfg.sym_sync_impl!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        info = cfg.pls_info
        self.frame_len = info.plframe_len
        self.payload_len = info.payload_len
        if cfg.sym_sync_impl == "gardner":
            self.sym_sync = SymbolSync(
                sps=cfg.sps, loop_bw=cfg.sym_sync_loop_bw,
                damping=cfg.damping, rolloff=cfg.rolloff,
                rrc_delay=cfg.rrc_delay, n_subfilt=cfg.n_subfilt,
                device=self.device,
            )
        else:
            self.sym_sync = FeedForwardSync(
                sps=cfg.sps, rolloff=cfg.rolloff, rrc_delay=cfg.rrc_delay,
                n_subfilt=cfg.n_subfilt, device=self.device,
            )
        self._tables = {}
        self._pls_tables(cfg.pls)    # the configured PLS's decoders, built now
        self._fe_nout = cfg.frontend_block
        self._fe_nsamp = self._fe_nout * cfg.sps + self.sym_sync.history() + 64
        self._acq_win = 2 * self.frame_len + 271
        self.reset()

    def _pls_tables(self, pls: int) -> PLSTables:
        tab = self._tables.get(pls)
        if tab is None:
            tab = self._tables[pls] = PLSTables(self.cfg, pls, self.device)
        return tab

    def _call(self, key, fn, args):
        """Run one device request: ``fn`` is a batch function, ``key`` names
        the requests it may be batched with (``BatchedACMReceiver``)."""
        return fn([args])[0]

    def _put(self, syms: np.ndarray):
        """Complex64 symbols -> planar float32 on the device."""
        return torch.as_tensor(cplx.from_np(syms), device=self.device)

    # ------------- state -------------

    def reset(self):
        self.stats = RxStats()
        self._samp_buf = np.empty(0, dtype=np.complex64)
        self._sym_buf = np.empty(0, dtype=np.complex64)
        self._ss_state = None        # timing state of (1,) device tensors
        self._agc_gain = float(self.cfg.agc_gain)
        self._rot_phase = 0.0
        self._rot_inc = 0.0          # per-sample phase increment (closed loop)
        self._lock_state = "searching"
        self._frame_phase = 0        # symbol-buffer index of the next SOF
        self._unlock_cnt = 0
        self._coarse_acc = np.zeros(89, dtype=np.complex64)
        self._coarse_frames = 0
        self._coarse_foffset = 0.0
        self._coarse_corrected = False
        self._fine_foffset = 0.0
        self._cum_foffset = 0.0
        self._settle_frames = 0      # frames to drain before the next
                                     # closed-loop accumulation
        self._n0 = None
        self._n0_refined = None
        self._llr_queue = []         # (N,) int8 device rows
        self._xfec_queue = []        # their XFECFRAME symbols, on the device
        self.bb_parser = BBFrameParser()

    # ------------- public API -------------

    def receive(self, iq: np.ndarray, flush: bool = True) -> np.ndarray:
        """Process IQ samples (complex64 at sps samples/symbol); returns TS
        bytes recovered so far. With ``flush``, process buffered tail frames
        and decode queued FEC frames even if batches are not full. Input is
        re-chunked to about two PLFRAMEs of samples so closed-loop frequency
        corrections take effect promptly."""
        iq = np.asarray(iq, dtype=np.complex64)
        chunk = 2 * self.frame_len * self.cfg.sps
        out = []
        for i in range(0, max(iq.size, 1), chunk):
            out.append(self._process_chunk(iq[i: i + chunk]))
        if flush:
            out.append(self._process_chunk(np.empty(0, np.complex64),
                                           force=True))
            out.append(self._flush_fec())
        return np.concatenate(out) if out else np.empty(0, np.uint8)

    def _process_chunk(self, iq, force=False) -> np.ndarray:
        self._samp_buf = np.concatenate([self._samp_buf, iq])
        self._run_frontend(force=force)
        ts = []
        progress = True
        while progress:
            progress = False
            if self._lock_state != "locked":
                progress = self._acquire()
            if self._lock_state == "locked":
                if self._process_frames(force=force):
                    progress = True
            ts.append(self._drain_fec())
        return np.concatenate(ts) if ts else np.empty(0, np.uint8)

    # ------------- front end -------------

    def _fe_batch(self, reqs):
        """Front-end blocks: reqs of (samples (n, 2) float32 numpy, timing
        state, rotator phase, rotator increment, AGC gain). Block AGC on the
        mean magnitude, the rotator, then the timing recovery: feed-forward
        with the segmented matched filter, or the Gardner loop, whose
        ``consumed`` is ``n + 1 - history`` with ``n`` then reset to
        ``history - 1`` (one kernel launch for all channels on the card,
        either way). Returns per channel (state', symbols (n_out,)
        complex64, consumed samples, gain')."""
        cfg, dev = self.cfg, self.device
        x = torch.as_tensor(np.stack([r[0] for r in reqs]), device=dev)
        cls = type(reqs[0][1])
        names = [f.name for f in fields(cls)]
        st = cls(*(torch.cat([getattr(r[1], k) for r in reqs])
                   for k in names))
        ph, inc, gain = (torch.tensor([r[i] for r in reqs],
                                      dtype=torch.float32, device=dev)
                         for i in (2, 3, 4))
        fe = frontend(x, gain, ph, inc, "update" if cfg.agc else "off",
                      min(1.0, cfg.agc_rate * self._fe_nsamp), cfg.agc_ref)
        rot, gain = fe["out"], fe["gain"]
        if cfg.sym_sync_impl == "ffw":
            new, syms, consumed = self.sym_sync.step_batched(st, rot,
                                                             self._fe_nout)
        else:
            new, syms = self.sym_sync.step(st, rot, self._fe_nout)
            hist = self.sym_sync.history()
            consumed = new.n + 1 - hist
            new.n = torch.full_like(new.n, hist - 1)
        syms = cplx.to_np(syms)
        consumed, gain = _to_host(consumed, gain)
        return [
            (cls(*(getattr(new, k)[c: c + 1] for k in names)),
             syms[c], int(consumed[c]), float(gain[c]))
            for c in range(len(reqs))
        ]

    def _run_frontend(self, force=False):
        if self._ss_state is None:
            self._ss_state = self.sym_sync.init_state(1)
        hist = self.sym_sync.history()
        while True:
            if self._samp_buf.size >= self._fe_nsamp:
                block = self._samp_buf[: self._fe_nsamp]
            elif force and self._samp_buf.size > hist + 256:
                block = np.concatenate([
                    self._samp_buf,
                    np.zeros(self._fe_nsamp - self._samp_buf.size,
                             np.complex64),
                ])
            else:
                return
            state, syms, consumed, gain = self._call(
                ("fe", self.cfg.sym_sync_impl, self._fe_nsamp),
                self._fe_batch,
                (cplx.from_np(block), self._ss_state, self._rot_phase,
                 self._rot_inc, self._agc_gain),
            )
            self._ss_state = state
            self._agc_gain = gain
            self._rot_phase = float(
                (self._rot_phase + self._rot_inc * consumed) % (2 * np.pi)
            )
            n_real = min(self._fe_nout,
                         max(0, self._samp_buf.size - hist) // self.cfg.sps)
            self._sym_buf = np.concatenate([self._sym_buf, syms[:n_real]])
            self._samp_buf = self._samp_buf[consumed:]
            if force and self._samp_buf.size <= hist + 256:
                return

    # ------------- acquisition -------------

    def _metric_batch(self, reqs):
        """Dense timing metric (``acq_metric``) of symbol windows: reqs of
        ((W, 2) device tensors,); returns (W,) numpy per channel."""
        m = acq_metric(torch.stack([r[0] for r in reqs])).cpu().numpy()
        return list(m)

    def _acquire(self) -> bool:
        if self._sym_buf.size < self._acq_win:
            return False
        metric = self._call(("metric", self._acq_win), self._metric_batch,
                            (self._put(self._sym_buf[: self._acq_win]),))
        peak = int(np.argmax(metric[: self.frame_len + 90]))
        if metric[peak] < plsync.THRESHOLD_UNLOCKED:
            # no SOF in this window; drop all but the tail
            keep = self.frame_len + 180
            self._sym_buf = self._sym_buf[-keep:]
            return False
        # confirm the next SOF one frame later
        nxt = peak + self.frame_len
        if nxt >= metric.size:
            return False  # need more symbols
        if metric[nxt] < plsync.THRESHOLD_LOCKED:
            # false alarm; discard past this peak and retry
            self._sym_buf = self._sym_buf[peak + 1:]
            return True
        sof_start = peak - 89
        if sof_start < 0:
            self._sym_buf = self._sym_buf[peak + 1:]
            return True
        self._lock_state = "locked"
        self.stats.lock_cnt += 1
        self.stats.lock_time = time.time()
        self._unlock_cnt = 0
        self._frame_phase = sof_start
        self.stats.sof_cnt += 2
        return True

    # ------------- locked-path processing -------------

    def _ccm_group_batch(self, reqs):
        """``Receiver._frame_group_impl``: reqs of (extended headers (F+1,
        91, 2), payloads (F, Lp, 2), both float32 numpy, coarse_corrected,
        refined N0 or 0.0). Adds to the group program the timing metric of
        every header and the full-PLHEADER coarse autocorrelation of the F
        frames (the PLS is known). Per channel: metric (F+1,), autocorr (F,)
        x (89,) complex64, fine (F,), n0, llrs (F, N) and xfec on the
        device."""
        cfg, dev = self.cfg, self.device
        tab = self._pls_tables(cfg.pls)
        hext = torch.as_tensor(np.stack([r[0] for r in reqs]), device=dev)
        pay = torch.as_tensor(np.stack([r[1] for r in reqs]), device=dev)
        cc = torch.tensor([r[2] for r in reqs], device=dev)
        n0_ov = torch.tensor([r[3] for r in reqs], dtype=torch.float32,
                             device=dev)
        C, F = pay.shape[:2]
        headers = hext[:, :, 1:]
        d = cplx.conj_mul(hext[:, :, 1:], hext[:, :, :-1])
        metric = plsync.frame_metric(d[:, :, 1:])               # (C, F+1)
        plsv = torch.full((C, F + 1), cfg.pls, dtype=torch.int64, device=dev)
        r = plsync.coarse_autocorr(headers[:, :F], plsv[:, :F], full=True)
        fine, n0, llrs, xfec = group_program(tab, headers, plsv, pay, cc,
                                             n0_ov)
        metric, r, fine, n0 = _to_host(metric, r, fine, n0)
        r = cplx.to_np(r)
        return [{"metric": metric[c], "autocorr": r[c], "fine": fine[c],
                 "n0": float(n0[c]), "llrs": llrs[c], "xfec": xfec[c]}
                for c in range(C)]

    def _process_frames(self, force=False) -> bool:
        """Process frames in fixed groups of ``frame_group``. Needs the next
        frame's header as lookahead (two-SOF rule). With ``force``, a final
        partial group is padded with the last frame (only the valid frames
        are consumed downstream)."""
        F0 = self.cfg.frame_group
        avail = (self._sym_buf.size - self._frame_phase - 91) // self.frame_len
        if avail >= F0:
            F = F0
        elif force and avail > 0:
            F = avail
        else:
            return False
        fp = self._frame_phase
        L = self.frame_len
        idx = fp + np.arange(F + 1)[:, None] * L + np.arange(-1, 90)[None, :]
        idx = np.clip(idx, 0, self._sym_buf.size - 1)
        headers_ext = self._sym_buf[idx]                       # (F+1, 91)
        payloads = self._sym_buf[
            fp + 90 + np.arange(F)[:, None] * L
            + np.arange(self.payload_len)[None, :]
        ]
        if F < F0:  # pad a final partial group to the group shape
            pad_h = np.repeat(headers_ext[-1:], F0 - F, axis=0)
            headers_ext = np.concatenate(
                [headers_ext[:-1], pad_h, headers_ext[-1:]], axis=0
            )
            payloads = np.concatenate(
                [payloads, np.repeat(payloads[-1:], F0 - F, axis=0)], axis=0
            )
        out = self._call(
            ("group", self.cfg.pls), self._ccm_group_batch,
            (cplx.from_np(headers_ext), cplx.from_np(payloads),
             self._coarse_corrected, self._n0_refined or 0.0),
        )
        metrics = out["metric"][: F + 1]
        n0 = out["n0"]
        autocorr = out["autocorr"][:F]                          # (F, 89)
        fine = out["fine"][:F]

        # ---- lock maintenance (host state machine) ----
        for k in range(F):
            self.stats.sof_cnt += 1
            if metrics[k] > plsync.THRESHOLD_LOCKED:
                self._unlock_cnt = 0
            else:
                self._unlock_cnt += 1
                if self._unlock_cnt >= self.cfg.unlock_thresh:
                    self._lock_state = "searching"
                    self.stats.unlock_cnt += 1
                    self._sym_buf = self._sym_buf[self._frame_phase
                                                  + (k + 1) * L:]
                    self._frame_phase = 0
                    self._unlock_cnt = 0
                    return True
            self.stats.frame_cnt += 1

        # ---- frequency tracking (block-granular closed loop) ----
        new_coarse = False
        for k in range(F):
            if self._settle_frames > 0:
                # frames in flight across a rotator update measured the old
                # residual: skipped during coarse pull-in, accumulated once
                # coarse-corrected (the periodic coarse estimate verifies
                # the residual stays in the fine range)
                self._settle_frames -= 1
                if not self._coarse_corrected:
                    continue
            self._coarse_acc += autocorr[k]
            self._coarse_frames += 1
            if self._coarse_frames >= self.cfg.coarse_period:
                est = _coarse_foffset_np(self._coarse_acc)
                self._coarse_foffset = est
                self._coarse_corrected = (
                    abs(est) < plsync.FINE_FOFFSET_CORR_RANGE
                )
                self._coarse_acc[:] = 0
                self._coarse_frames = 0
                new_coarse = True
        self.stats.coarse_corrected = self._coarse_corrected
        self.stats.coarse_foffset = self._coarse_foffset
        self._fine_foffset = float(fine[-1])
        self.stats.fine_foffset = self._fine_foffset

        # closed-loop rotator update, once the symbols produced before the
        # previous update have drained
        if self.cfg.closed_loop and self._settle_frames <= 0:
            adj = 0.0
            is_coarse_adj = not self._coarse_corrected
            if is_coarse_adj:
                if new_coarse:
                    adj = self._coarse_foffset
            else:
                adj = float(fine[-1])
            if adj != 0.0:
                self._cum_foffset += adj
                self._rot_inc = -self._cum_foffset * 2 * np.pi / self.cfg.sps
                in_flight = (
                    self._sym_buf.size
                    - (self._frame_phase + F * L)
                    + self._samp_buf.size // self.cfg.sps
                )
                self._settle_frames = in_flight // self.frame_len + 2
                if is_coarse_adj:
                    # the accumulated autocorrelation refers to the old
                    # residual
                    self._coarse_acc[:] = 0
                    self._coarse_frames = 0
        self.stats.cum_freq_offset = self._cum_foffset
        self._n0 = n0
        self.stats.snr_db = float(10 * np.log10(1.0 / max(n0, 1e-12)))

        # ---- queue LLRs for FEC (with their symbols, for the refinement)
        for k in range(F):
            self._llr_queue.append(out["llrs"][k])
            self._xfec_queue.append(out["xfec"][k])

        self._sym_buf = self._sym_buf[self._frame_phase + F * L:]
        self._frame_phase = 0
        self.stats.locked = True
        return True

    # ------------- FEC -------------

    def _fec_batch(self, reqs):
        """FEC of one code: reqs of (pls, llrs (B, N) int8 on the device,
        stitch flags wanted). The channels' frames are pooled into one
        lane-major decode of (N, C*B), frames as lanes; per-lane
        convergence freezing makes every frame's result independent of the
        pool. Per channel: (descrambled kbytes (B, kbch/8) uint8, packet
        validity maps and header flags (numpy, or None), n_corr (B,), the
        pool's iteration count, hard bits (B, N) on the device)."""
        tab = self._pls_tables(reqs[0][0])
        rows = torch.cat([r[1] for r in reqs])                   # (C*B, N)
        kbytes, n_corr, iters, _ok, hard_t = fec_lane_major(
            tab.ldpc, tab.bch, tab.fec, rows.t())
        frames = kbytes ^ tab.bb_scramble
        if reqs[0][2]:
            pkt_ok, hdr_ok = packet_validity(frames)
            pkt_ok, hdr_ok = pkt_ok.cpu().numpy(), hdr_ok.cpu().numpy()
        frames = frames.cpu().numpy()
        n_corr = n_corr.cpu().numpy()
        iters = int(iters.max())
        hard = hard_t.t()
        B = reqs[0][1].shape[0]
        out = []
        for c in range(len(reqs)):
            s = slice(c * B, (c + 1) * B)
            flags = (pkt_ok[s], hdr_ok[s]) if reqs[0][2] else (None, None)
            out.append((frames[s], *flags, n_corr[s], iters, hard[s]))
        return out

    def _refine_batch(self, reqs):
        """Post-decoder SNR refinement of one PLS: reqs of (pls, xfec (n, R,
        2), hard bits (n, N)); per channel the mean refined linear SNR of its
        frames (reference ``xfecframe_demapper_cb_impl.cc:188-318``)."""
        tab = self._pls_tables(reqs[0][0])
        per = _snr_refine_frames(
            torch.cat([r[1] for r in reqs]), torch.cat([r[2] for r in reqs]),
            tab.constellation, tab.rate, tab.info.n_mod)
        means = torch.stack([p.mean() for p in
                             per.split([r[1].shape[0] for r in reqs])])
        return [float(v) for v in means.cpu().numpy()]

    def _drain_fec(self) -> np.ndarray:
        out = []
        B = self.cfg.fec_batch
        while len(self._llr_queue) >= B:
            batch = self._llr_queue[:B]
            xfecs = self._xfec_queue[:B]
            del self._llr_queue[:B]
            del self._xfec_queue[:B]
            out.append(self._decode_batch(batch, xfecs=xfecs))
        return np.concatenate(out) if out else np.empty(0, np.uint8)

    def _flush_fec(self) -> np.ndarray:
        if not self._llr_queue:
            return np.empty(0, np.uint8)
        # pad to the batch size with a repeat of the last frame
        B = self.cfg.fec_batch
        n = len(self._llr_queue)
        batch = self._llr_queue + [self._llr_queue[-1]] * (B - n)
        xfecs = self._xfec_queue[:n]
        self._llr_queue = []
        self._xfec_queue = []
        return self._decode_batch(batch, valid=n, xfecs=xfecs)

    def _decode_batch(self, batch, valid=None, xfecs=None) -> np.ndarray:
        valid = len(batch) if valid is None else valid
        pls, ts_out = self.cfg.pls, self.cfg.out_stream != "bb"
        frames, pkt_ok, hdr_ok, n_corr, iters, hard = self._call(
            ("fec", pls), self._fec_batch, (pls, torch.stack(batch), ts_out))
        if xfecs:
            snr = self._call(("refine", pls), self._refine_batch,
                             (pls, torch.stack(list(xfecs)),
                              hard[: len(xfecs)]))
            if snr > 0:
                self._n0_refined = 1.0 / snr
                self.stats.snr_db = float(10 * np.log10(snr))
        n_corr = n_corr[:valid]
        self.stats.ldpc_frames += valid
        self.stats.ldpc_total_iters += iters * valid
        self.stats.bch_frames += valid
        self.stats.bch_frame_errors += int(np.sum(n_corr < 0))
        self.stats.bch_corrections += int(np.sum(np.maximum(n_corr, 0)))
        if not ts_out:
            # the descrambled BBFRAMEs (reference --out-stream bb)
            return frames[:valid].reshape(-1)
        ts = [self.bb_parser.push(frames[i], pkt_ok[i], bool(hdr_ok[i]))
              for i in range(valid)]
        return np.concatenate(ts) if ts else np.empty(0, np.uint8)


class ACMReceiver(Receiver):
    """ACM/VCM host receiver: PLSC-driven variable-MODCOD demodulation
    (reference ``plsync_cc`` with the PLSC decoder enabled,
    ``lib/plsync_cc_impl.cc:582-594``), as a windowed batched pipeline:

    - the SOF/PLSC timing metric runs densely over a symbol window in one
      call, and every header candidate in the window is PLSC-decoded in a
      second (after ``derotate_plheader``: the SOF phase always, plus the
      latest coarse/fine estimate when no closed-loop rotator runs);
    - frame boundaries are found on the host by walking the decoded PLS
      chain (frame k's length comes from its PLS; payload k is processed
      once header k+1 is confirmed); a header whose metric is weak is
      decoded on its own;
    - runs of same-PLS frames go through the per-PLS group program;
      frames outside ``pls_list`` are rejected and counted, dummy frames
      skipped and counted;
    - while not coarse-corrected the coarse CFO accumulates the SOF symbols
      only, then the full PLHEADER; coarse corrections feed the rotator
      before lock too (the JAX receiver's documented deviation from the
      reference);
    - FEC runs in PLS order from one queue, and the post-decoder SNR
      refinement is kept per PLS.
    """

    def __init__(self, cfg: RxConfig, device=None):
        if not cfg.acm_vcm:
            raise ValueError("ACMReceiver requires acm_vcm=True")
        super().__init__(cfg, device)
        self._pls_enabled = np.zeros(128, dtype=bool)
        if cfg.pls_list:
            self._pls_enabled[list(cfg.pls_list)] = True
        else:
            # every decodable PLS: modcod 0 is the dummy frame and 29-31 are
            # reserved (a noisy decode landing there counts as rejected)
            for pls in range(128):
                self._pls_enabled[pls] = (pls >> 2) in DVBS2_MODCODS
        # the ML search: the a-priori expected PLS set (all valid values by
        # default) plus the dummy frames
        if cfg.pls_expected:
            self._plsc_search_mask = np.zeros(128, dtype=bool)
            self._plsc_search_mask[list(cfg.pls_expected)] = True
        else:
            self._plsc_search_mask = np.array(
                [(pls >> 2) in DVBS2_MODCODS for pls in range(128)])
        self._plsc_search_mask[:4] = True
        self._search_mask_t = torch.as_tensor(self._plsc_search_mask,
                                              device=self.device)
        # a window covers a whole frame group of the longest a-priori frame
        # (grown when a longer frame is decoded)
        seeds = {cfg.pls} | set(cfg.pls_list) | set(cfg.pls_expected)
        lmax = max(parse_pls(p).plframe_len for p in seeds)
        self._win_len = self._round_win(cfg.frame_group * lmax)
        self._pls_resources = {}
        self._curr_pls = None
        self._fec_queue = []    # ordered [(pls, llrs (N,), xfec), ...]
        self.bb_parser = BBFrameParser()

    def get_stats(self, sym_rate: float = None) -> dict:
        """Reference-shaped statistics plus per-PLS sections: each PLS is
        its own demapper and FEC context, so frames, SNR and LDPC trials
        are reported per PLS."""
        base = get_stats(self, sym_rate)
        per_plsync, per_fec = {}, {}
        for pls, res in sorted(self._pls_resources.items()):
            st = res["stats"]
            if st["frames"] == 0 and st["fec_frames"] == 0:
                continue
            tab = res["tab"]
            name = f"{tab.constellation.lower()}{tab.rate}"
            per_plsync[pls] = {
                "modcod": name,
                "frames": st["frames"],
                "fine_foffset": st["fine_foffset"],
            }
            per_fec[pls] = {
                "modcod": name,
                "frames": st["fec_frames"],
                "errors": st["fec_errors"],
                "avg_ldpc_trials": (
                    st["ldpc_iters"] / st["fec_frames"]
                    if st["fec_frames"] else None
                ),
                "snr": st["snr_db"],
            }
        base["plsync"]["per_pls"] = per_plsync
        base["fec"]["per_pls"] = per_fec
        return base

    @staticmethod
    def _round_win(plframe_len: int) -> int:
        return int(np.ceil((plframe_len + 384) / 1024)) * 1024

    def _ensure_win(self, plframe_len: int) -> bool:
        """Grow the window if a decoded PLS implies a longer frame."""
        if plframe_len + 91 > self._win_len:
            self._win_len = self._round_win(plframe_len)
            return True
        return False

    def reset(self):
        super().reset()
        self._coarse_acc_sof = np.zeros(25, dtype=np.complex64)
        self._coarse_mode = "sof"
        self._fine_ready = False
        # absolute stream position of _sym_buf[0] and of the last header
        # accumulated: windows overlap across _acquire passes, and a header
        # must reach the coarse accumulator once
        self._abs_pos = 0
        self._last_acc_abs = -1

    def _consume_syms(self, n: int):
        n = int(n)
        self._sym_buf = self._sym_buf[n:]
        self._abs_pos += n

    # ---------- per-PLS resources ----------

    def _resources(self, pls: int):
        """The per-PLS context: its tables, the refined N0 (0 = not yet)
        and its statistics."""
        res = self._pls_resources.get(pls)
        if res is None:
            tab = self._pls_tables(pls)
            res = self._pls_resources[pls] = {
                "tab": tab,
                "n0_refined": 0.0,
                "stats": {
                    "frames": 0,          # PL frames accepted (plsync view)
                    "fec_frames": 0,      # FEC frames decoded
                    "fec_errors": 0,      # BCH decode failures
                    "ldpc_iters": 0,      # cumulative LDPC trials
                    "snr_db": None,       # refined per-PLS SNR
                    "fine_foffset": 0.0,  # last fine estimate of this PLS
                },
            }
        return res

    def _derot_params(self):
        """(foffset, apply_freq) for the derotation before the PLSC decode:
        closed loop, none (the rotator corrects); open loop, the latest fine
        estimate once coarse-corrected, else the coarse estimate (reference
        ``pl_freq_sync.cc:409-412``)."""
        if self.cfg.closed_loop:
            return 0.0, False
        if self._coarse_corrected and self._fine_ready:
            return self._fine_foffset, True
        return self._coarse_foffset, True

    # ---------- device stages ----------

    def _win_plsc_batch(self, reqs):
        """Candidate headers of one window each: reqs of (symbols (W, 2) on
        the device, SOF starts (K,) int32 numpy, foffset, apply_freq). Per
        candidate the decoded PLS (after ``derotate_plheader`` and the
        configured PLSC mode over the search mask) and the SOF-only and full
        coarse autocorrelation of the raw header. Per channel: (pls (K,),
        sof_r (K, 25) and full_r (K, 89) complex64)."""
        dev = self.device
        sym = torch.stack([r[0] for r in reqs])                 # (C, W, 2)
        C, W = sym.shape[:2]
        sofs = np.clip(np.stack([r[1] for r in reqs]), 0, W - PLHEADER_LEN)
        idx = (torch.as_tensor(sofs, device=dev).to(torch.int64)[..., None]
               + torch.arange(PLHEADER_LEN, device=dev))         # (C, K, 90)
        hdrs = sym[torch.arange(C, device=dev)[:, None, None], idx]
        foff = torch.tensor([r[2] for r in reqs], dtype=torch.float32,
                            device=dev)
        apply = torch.tensor([r[3] for r in reqs], device=dev)
        der = plsync.derotate_plheader(hdrs, foff[:, None], apply[:, None])
        pls, _ = _PLSC_DECODERS[self.cfg.plsc_mode](
            der, enabled_mask=self._search_mask_t)
        sof_r = plsync.coarse_autocorr(hdrs, pls, full=False)
        full_r = plsync.coarse_autocorr(hdrs, pls, full=True)
        pls, sof_r, full_r = _to_host(pls, sof_r, full_r)
        sof_r, full_r = cplx.to_np(sof_r), cplx.to_np(full_r)
        return [(pls[c].astype(np.int64), sof_r[c], full_r[c])
                for c in range(C)]

    def _plsc1_batch(self, reqs):
        """Single-header PLSC decode (the weak-metric fallback of the chain
        walk): reqs of (extended header (91, 2) float32 numpy, foffset,
        apply_freq); per channel the decoded PLS."""
        dev = self.device
        hdr = torch.as_tensor(np.stack([r[0] for r in reqs]), device=dev)
        foff = torch.tensor([r[1] for r in reqs], dtype=torch.float32,
                            device=dev)
        apply = torch.tensor([r[2] for r in reqs], device=dev)
        der = plsync.derotate_plheader(hdr[:, 1:], foff, apply)
        pls, _ = _PLSC_DECODERS[self.cfg.plsc_mode](
            der, enabled_mask=self._search_mask_t)
        return [int(p) for p in pls.cpu().numpy()]

    def _acm_group_batch(self, reqs):
        """The per-PLS group program: reqs of (pls, headers (F+1, 90, 2),
        PLS of the next header, payloads (F, Lp, 2), both float32 numpy,
        coarse_corrected, refined N0 or 0.0). Per channel: fine (F,) and
        the data-aided n0 on the host, llrs (F, N) and xfec on the
        device."""
        dev = self.device
        pls = reqs[0][0]
        tab = self._pls_tables(pls)
        hdr = torch.as_tensor(np.stack([r[1] for r in reqs]), device=dev)
        pay = torch.as_tensor(np.stack([r[3] for r in reqs]), device=dev)
        C, F = pay.shape[:2]
        plsv = torch.tensor([[pls] * F + [r[2]] for r in reqs],
                            dtype=torch.int64, device=dev)
        cc = torch.tensor([r[4] for r in reqs], device=dev)
        n0_ov = torch.tensor([r[5] for r in reqs], dtype=torch.float32,
                             device=dev)
        fine, n0, llrs, xfec = group_program(tab, hdr, plsv, pay, cc, n0_ov)
        fine, n0 = _to_host(fine, n0)
        return [{"fine": fine[c], "n0": float(n0[c]), "llrs": llrs[c],
                 "xfec": xfec[c]} for c in range(C)]

    # ---------- windowed host pipeline ----------

    @staticmethod
    def _find_peaks(metric, thresh, guard=64):
        """Local maxima of the dense timing metric above ``thresh``."""
        cand = np.flatnonzero(metric > thresh)
        peaks = []
        for n in cand:
            lo = max(0, int(n) - guard)
            hi = min(metric.size, int(n) + guard + 1)
            if int(n) == lo + int(np.argmax(metric[lo:hi])):
                peaks.append(int(n))
        return peaks

    def _window_decode(self, start: int):
        """Dense metric + batched PLSC decode over symbols[start:start+W].

        Returns (metric (valid,), cand: dict sof -> (pls, sof_r, full_r),
        valid), ``valid`` the number of real (non-padded) symbols."""
        W = self._win_len
        buf = self._sym_buf[start: start + W]
        valid = buf.size
        if valid < W:
            buf = np.concatenate([buf, np.zeros(W - valid, np.complex64)])
        dev = self._put(buf)
        metric = self._call(("metric", W), self._metric_batch, (dev,))[:valid]
        peaks = [n for n in self._find_peaks(metric, plsync.THRESHOLD_LOCKED)
                 if n >= 89 and n - 89 + 90 <= valid]
        C = W // 3330 + 3
        if len(peaks) > C:  # keep the strongest C candidates
            peaks = sorted(sorted(peaks, key=lambda n: -metric[n])[:C])
        sofs = np.zeros(C, np.int32)
        sofs[: len(peaks)] = [n - 89 for n in peaks]
        foffset, apply_freq = self._derot_params()
        pls, sof_r, full_r = self._call(
            ("plsc", W, C), self._win_plsc_batch,
            (dev, sofs, foffset, bool(apply_freq)))
        cand = {
            int(sofs[i]): (int(pls[i]), sof_r[i], full_r[i])
            for i in range(len(peaks))
        }
        return metric, cand, valid

    def _cand_at(self, cand, pos, tol=1):
        for p in range(pos - tol, pos + tol + 1):
            if p in cand:
                return cand[p]
        return None

    def _acquire(self) -> bool:
        min_need = 3330 + 181   # shortest PLFRAME + two headers
        if self._sym_buf.size < min_need:
            return False
        metric, cand, valid = self._window_decode(0)
        # SOF declaration while searching uses the higher threshold
        strong = {
            sof: e for sof, e in cand.items()
            if metric[sof + 89] > plsync.THRESHOLD_UNLOCKED
        }
        if not strong:
            # no SOF in this window; drop all but a header-sized tail
            if self._sym_buf.size > self._win_len:
                self._consume_syms(self._win_len - 180)
                return True
            return False

        # closed-loop coarse pull-in from every detected header (SOF-only:
        # the PLS is not trustworthy while searching), once per header
        new_coarse = False
        for sof in sorted(strong):
            if self._abs_pos + sof <= self._last_acc_abs:
                continue
            self._last_acc_abs = self._abs_pos + sof
            if self._track_coarse_frame(strong[sof][1], None):
                new_coarse = True
        self._closed_loop_adjust(new_coarse, None, 3330)

        # chain confirmation: a candidate whose decoded PLS predicts the
        # next SOF position locks the receiver (two-SOF rule)
        wait_sof = None
        for sof in sorted(strong):
            pls = strong[sof][0]
            L = parse_pls(pls).plframe_len
            if self._ensure_win(L):
                return True  # window grew; retry
            nxt_peak = sof + L + 89
            if nxt_peak >= valid:
                # next header beyond this window (or not received yet)
                if wait_sof is None:
                    wait_sof = sof
                continue
            confirmed = (
                self._cand_at(cand, sof + L) is not None
                or metric[nxt_peak] > plsync.THRESHOLD_LOCKED
            )
            if confirmed:
                self._lock_state = "locked"
                self.stats.lock_cnt += 1
                self.stats.lock_time = time.time()
                self._unlock_cnt = 0
                self._frame_phase = sof
                self._curr_pls = pls
                self.stats.sof_cnt += 2
                return True
        if wait_sof is not None:
            # align the buffer to the first unconfirmable candidate and wait
            # for its next header
            if wait_sof > 0:
                self._consume_syms(wait_sof)
                return True
            return False
        # candidates exist but none chains: false peaks; skip past the first
        self._consume_syms(min(strong) + 1)
        return True

    def _process_frames(self, force=False) -> bool:
        progressed = False
        while self._curr_pls is not None:
            fp = self._frame_phase
            L0 = parse_pls(self._curr_pls).plframe_len
            if self._ensure_win(L0):
                continue
            if self._sym_buf.size - fp < L0 + 91:
                break
            metric, cand, valid = self._window_decode(fp)

            # ---- walk the decoded-PLS chain through the window ----
            frames = []   # (pos, pls, own_metric, cand_entry or None)
            pos, pls = 0, self._curr_pls
            grew = False
            while True:
                L = parse_pls(pls).plframe_len
                if self._ensure_win(L):
                    grew = True
                    break
                nxt = pos + L
                if nxt + 91 > valid:
                    break
                entry_next = self._cand_at(cand, nxt)
                if entry_next is not None:
                    pls_next = entry_next[0]
                else:
                    # weak/no peak at the expected position: decode that
                    # header anyway (the reference decodes every PLHEADER
                    # regardless of the timing metric)
                    foffset, apply_freq = self._derot_params()
                    pls_next = self._call(
                        ("plsc1",), self._plsc1_batch,
                        (cplx.from_np(self._sym_buf[fp + nxt - 1:
                                                    fp + nxt + 90]),
                         foffset, bool(apply_freq)))
                frames.append(
                    (pos, pls, float(metric[pos + 89]),
                     self._cand_at(cand, pos))
                )
                pos, pls = nxt, pls_next
            if grew:
                continue
            if not frames:
                break

            # ---- lock maintenance ----
            frames_all = frames
            keep = len(frames)
            unlocked = False
            for k, (p, fpls, m_own, _) in enumerate(frames):
                self.stats.sof_cnt += 1
                if m_own > plsync.THRESHOLD_LOCKED:
                    self._unlock_cnt = 0
                else:
                    self._unlock_cnt += 1
                    if self._unlock_cnt >= self.cfg.unlock_thresh:
                        keep = k
                        unlocked = True
                        break
            frames = frames[:keep]

            # ---- frequency tracking (coarse per frame) ----
            new_coarse = False
            for p, fpls, m_own, entry in frames:
                if entry is None:
                    continue
                if self._track_coarse_frame(entry[1], entry[2]):
                    new_coarse = True

            # ---- classify, group same-PLS runs, process payloads ----
            fine_last = None
            run = []    # positions of consecutive same-PLS data frames
            run_pls = None
            mean_L = max(
                int(np.mean([parse_pls(f[1]).plframe_len for f in frames])),
                1) if frames else 1

            def flush_run(next_pls):
                nonlocal fine_last, run, run_pls
                if run:
                    fine = self._process_run(run_pls, run, next_pls)
                    if fine is not None:
                        fine_last = fine
                    run, run_pls = [], None

            for k, (p, fpls, m_own, entry) in enumerate(frames):
                info = parse_pls(fpls)
                if info.dummy_frame:
                    flush_run(fpls)
                    self.stats.dummy_cnt += 1
                    continue
                if not self._pls_enabled[fpls]:
                    flush_run(fpls)
                    self.stats.rejected_cnt += 1
                    continue
                self.stats.frame_cnt += 1
                if run and (fpls != run_pls
                            or len(run) >= self.cfg.frame_group):
                    flush_run(fpls)
                run.append(p)
                run_pls = fpls
            # the header after the last run frame is the next walked one
            next_after = (frames_all[keep][1] if keep < len(frames_all)
                          else pls)
            flush_run(next_after)

            self._closed_loop_adjust(new_coarse, fine_last, mean_L)

            if unlocked:
                # consume through the frame that triggered the unlock
                bad_pos, bad_pls = frames_all[keep][0], frames_all[keep][1]
                consumed = bad_pos + parse_pls(bad_pls).plframe_len
                self._lock_state = "searching"
                self.stats.unlock_cnt += 1
                self._consume_syms(fp + consumed)
                self._frame_phase = 0
                self._curr_pls = None
                self._unlock_cnt = 0
                return True

            self._consume_syms(fp + pos)
            self._frame_phase = 0
            self._curr_pls = pls
            self.stats.locked = True
            progressed = True
            if self._sym_buf.size < parse_pls(pls).plframe_len + 91:
                break
        return progressed

    def _process_run(self, pls, positions, next_pls):
        """Process a run of consecutive same-PLS frames through the per-PLS
        group program and queue their LLRs in stream order. Returns the
        last frame's fine-CFO estimate (None when not coarse-corrected)."""
        res = self._resources(pls)
        info = res["tab"].info
        F0 = self.cfg.frame_group
        F = len(positions)
        fp = self._frame_phase
        L = info.plframe_len
        p0 = fp + positions[0]
        # headers of frames 0..F-1 plus the header that follows them
        hidx = p0 + np.arange(F + 1)[:, None] * L + np.arange(90)[None, :]
        hidx = np.clip(hidx, 0, self._sym_buf.size - 1)
        headers = self._sym_buf[hidx]                      # (F+1, 90)
        pidx = p0 + 90 + np.arange(F)[:, None] * L \
            + np.arange(info.payload_len)[None, :]
        payloads = self._sym_buf[pidx]                     # (F, payload_len)
        if F < F0:   # pad to the group shape; only F frames are consumed
            pad_h = np.repeat(headers[-2:-1], F0 - F, axis=0)
            headers = np.concatenate(
                [headers[:-1], pad_h, headers[-1:]], axis=0
            )
            payloads = np.concatenate(
                [payloads, np.repeat(payloads[-1:], F0 - F, axis=0)], axis=0
            )
        out = self._call(
            ("group", pls), self._acm_group_batch,
            (pls, cplx.from_np(headers), int(next_pls),
             cplx.from_np(payloads), self._coarse_corrected,
             res["n0_refined"]),
        )
        for k in range(F):
            self._fec_queue.append((pls, out["llrs"][k], out["xfec"][k]))
        res["stats"]["frames"] += F
        if res["n0_refined"] == 0.0:
            self.stats.snr_db = float(
                10 * np.log10(1.0 / max(out["n0"], 1e-12)))
        fine = float(out["fine"][F - 1])
        res["stats"]["fine_foffset"] = fine
        if self._coarse_corrected:
            self._fine_ready = True
            self._fine_foffset = fine
            self.stats.fine_foffset = fine
            return fine
        return None

    # ---------- frequency tracking ----------

    def _track_coarse_frame(self, sof_r, full_r) -> bool:
        """Accumulate one header's coarse-CFO autocorrelation: SOF-only
        while not coarse-corrected, full PLHEADER after (reference
        ``plsync_cc_impl.cc:510-566``). Returns True when a new estimate
        was finalized."""
        if self._settle_frames > 0:
            # pending coarse updates gate the accumulation; pending fine
            # updates must not starve the periodic coarse verification
            self._settle_frames -= 1
            if not self._coarse_corrected:
                return False
        mode = "full" if (self._coarse_corrected and full_r is not None) \
            else "sof"
        if mode != self._coarse_mode:
            self._coarse_mode = mode
            self._coarse_acc[:] = 0
            self._coarse_acc_sof[:] = 0
            self._coarse_frames = 0
        if mode == "sof":
            self._coarse_acc_sof += sof_r
        else:
            self._coarse_acc += full_r
        self._coarse_frames += 1
        if self._coarse_frames < self.cfg.coarse_period:
            return False
        acc = self._coarse_acc_sof if mode == "sof" else self._coarse_acc
        est = _coarse_foffset_np(acc)
        self._coarse_foffset = est
        self._coarse_corrected = abs(est) < plsync.FINE_FOFFSET_CORR_RANGE
        self._coarse_acc[:] = 0
        self._coarse_acc_sof[:] = 0
        self._coarse_frames = 0
        self.stats.coarse_corrected = self._coarse_corrected
        self.stats.coarse_foffset = est
        return True

    def _closed_loop_adjust(self, new_coarse, fine_last, mean_frame_len):
        """Block-granular rotator update (the CCM path's rule, with the
        settle guard in frames of the current mean length)."""
        self.stats.coarse_corrected = self._coarse_corrected
        self.stats.coarse_foffset = self._coarse_foffset
        if not self.cfg.closed_loop or self._settle_frames > 0:
            self.stats.cum_freq_offset = self._cum_foffset
            return
        adj = 0.0
        is_coarse_adj = not self._coarse_corrected
        if is_coarse_adj:
            if new_coarse:
                adj = self._coarse_foffset
        elif fine_last is not None:
            adj = fine_last
        if adj != 0.0:
            self._cum_foffset += adj
            self._rot_inc = -self._cum_foffset * 2 * np.pi / self.cfg.sps
            in_flight = self._sym_buf.size + self._samp_buf.size // self.cfg.sps
            self._settle_frames = in_flight // max(mean_frame_len, 1) + 2
            if is_coarse_adj:
                self._coarse_acc[:] = 0
                self._coarse_acc_sof[:] = 0
                self._coarse_frames = 0
        self.stats.cum_freq_offset = self._cum_foffset

    # ---------- ordered FEC ----------

    def _drain_fec(self, flush=False) -> np.ndarray:
        out = []
        B = self.cfg.fec_batch
        while self._fec_queue:
            pls0 = self._fec_queue[0][0]
            run = 1
            while run < len(self._fec_queue) and self._fec_queue[run][0] == pls0:
                run += 1
            if run < B and len(self._fec_queue) == run and not flush:
                break  # wait for more same-PLS frames
            take = min(run, B)
            batch = [llr for _, llr, _ in self._fec_queue[:take]]
            xfecs = [x for _, _, x in self._fec_queue[:take]]
            del self._fec_queue[:take]
            out.append(self._decode_acm_batch(pls0, batch, xfecs))
        return np.concatenate(out) if out else np.empty(0, np.uint8)

    def _flush_fec(self) -> np.ndarray:
        return self._drain_fec(flush=True)

    def _decode_acm_batch(self, pls, llr_list, xfec_list) -> np.ndarray:
        res = self._resources(pls)
        B = self.cfg.fec_batch
        n = len(llr_list)
        rows = torch.stack(llr_list + [llr_list[-1]] * (B - n))
        frames, pkt_ok, hdr_ok, n_corr, iters, hard = self._call(
            ("fec", pls), self._fec_batch, (pls, rows, True))
        # per-PLS post-decoder SNR refinement: later demapping of this PLS
        # uses the refined N0
        snr = self._call(("refine", pls), self._refine_batch,
                         (pls, torch.stack(xfec_list), hard[:n]))
        if snr > 0:
            res["n0_refined"] = 1.0 / snr
            res["stats"]["snr_db"] = float(10 * np.log10(snr))
            self.stats.snr_db = res["stats"]["snr_db"]
        n_corr = n_corr[:n]
        errors = int(np.sum(n_corr < 0))
        self.stats.ldpc_frames += n
        self.stats.ldpc_total_iters += iters * n
        self.stats.bch_frames += n
        self.stats.bch_frame_errors += errors
        self.stats.bch_corrections += int(np.sum(np.maximum(n_corr, 0)))
        res["stats"]["fec_frames"] += n
        res["stats"]["ldpc_iters"] += iters * n
        res["stats"]["fec_errors"] += errors
        ts = [self.bb_parser.push(frames[i], pkt_ok[i], bool(hdr_ok[i]))
              for i in range(n)]
        return np.concatenate(ts) if ts else np.empty(0, np.uint8)


def make_receiver(cfg: RxConfig, device=None):
    """The host receiver of a configuration: ``ACMReceiver`` when
    ``cfg.acm_vcm``, else the CCM ``Receiver``; on the card unless
    ``device`` says otherwise."""
    return ACMReceiver(cfg, device) if cfg.acm_vcm else Receiver(cfg, device)
