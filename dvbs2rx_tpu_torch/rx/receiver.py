"""Receiver configuration, statistics and the FEC stage.

Port of the parts of ``dvbs2rx_tpu/rx/receiver.py`` that the stream
receiver uses: ``RxConfig``/``RxStats`` (same fields, defaults and
``__post_init__``, built on the port's own ``spec``), the post-decoder
SNR refinement,
the acquisition metric, ``get_stats``, the per-code FEC decoder factories
(``get_ldpc_decoder``, the counterpart of ``_make_ldpc_decoder``, and
``get_bch_decoder``), and ``FECStage``: the lane-major FEC stage
``Receiver._fec_stage_lane_major_impl`` (LDPC -> BCH -> byte packing) with
the tables ``StreamReceiver`` takes from ``Receiver``. The host
``Receiver`` class itself (the Gardner path) comes later.
"""

import datetime
import functools
from dataclasses import dataclass

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
from ..spec.pls import PLSInfo, make_pls, parse_pls
from ..spec.scramblers import (
    bb_derandomizer_bytes,
    pl_descrambling_sequence,
)

from ..ops import cplx, plsync
from ..ops.bch import BCHDecoder
from ..ops.ldpc_cuda import CudaLDPCDecoder
from ..utils.runtime import device_table, resolve_device


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
    symbols. xfec (B, R, 2) with R <= rows; hard_bits (B, n_ldpc)."""
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


def _snr_refine(xfec, hard_bits, constellation, rate, n_mod):
    """Batch-mean refined SNR (see ``_snr_refine_frames``)."""
    return _snr_refine_frames(xfec, hard_bits, constellation, rate,
                              n_mod).mean()


def acq_metric(symbols):
    """Acquisition metric over symbol blocks (..., N, 2): the dense timing
    metric with a zero history (``Receiver._acq_impl``)."""
    hist = torch.zeros(symbols.shape[:-2] + (90, 2), dtype=torch.float32,
                       device=symbols.device)
    return plsync.timing_metric(symbols, hist)[0]


def get_ldpc_decoder(table: str, max_trials: int = 25,
                     algo: str = "offset-min-sum", update: str = "normal",
                     device=None) -> CudaLDPCDecoder:
    """The LDPC decoder of code ``table``, one per (table, trials, device):
    the CUDA kernel on CUDA tensors, its plain version on CPU tensors. Only
    offset-min-sum with the normal update is ported."""
    if (algo, update) != ("offset-min-sum", "normal"):
        raise NotImplementedError(
            "the port decodes offset-min-sum with the normal update only"
        )
    return _ldpc_decoder(table, max_trials, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _ldpc_decoder(table, max_trials, device):
    return CudaLDPCDecoder(get_code(table), max_trials, device)


def get_bch_decoder(framesize: str, t: int, nbch: int, kbch: int,
                    device=None) -> BCHDecoder:
    """The BCH decoder of one (frame size, t, nbch, kbch), one per device
    (its Chien matrix is built once, on the first frame that needs it)."""
    return _bch_decoder(framesize, t, nbch, kbch, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _bch_decoder(framesize, t, nbch, kbch, device):
    return BCHDecoder(framesize, t, nbch, kbch, device)


class FECStage:
    """Lane-major FEC stage and the frame tables of one configuration.

    ``lane_major(llrsT (N, B) int8)`` -> (kbytes (B, kbch/8) uint8, n_corr
    (B,) int32, iters int32, ok (B,) int32, hard_t (N, B) uint8). On a CUDA
    tensor the LDPC decode is the hand-written kernel.
    """

    def __init__(self, cfg: RxConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        info = cfg.pls_info
        self.frame_len = info.plframe_len
        self.payload_len = info.payload_len
        self.ldpc = get_ldpc_decoder(cfg.fec.ldpc_table, cfg.ldpc_max_trials,
                                     cfg.ldpc_algo, cfg.ldpc_update,
                                     self.device)
        self.bch = get_bch_decoder(cfg.fec.framesize, cfg.fec.t, cfg.fec.nbch,
                                   cfg.fec.kbch, self.device)
        self.bb_scramble_np = bb_derandomizer_bytes(cfg.fec.kbch // 8)
        # planar (payload_len, 2) float32 PL descrambling sequence
        self.descr_np = cplx.from_np(
            pl_descrambling_sequence(cfg.gold_code)[: self.payload_len]
        )
        self.bb_scramble = torch.as_tensor(self.bb_scramble_np,
                                           device=self.device)
        self.descr = torch.as_tensor(self.descr_np, device=self.device)
        self._byte_w = torch.as_tensor(1 << np.arange(7, -1, -1),
                                       device=self.device)

    def lane_major(self, llrsT):
        hard_t, _llrs_out, iters, ok = self.ldpc.decode_lane_major(llrsT)
        corrected_t, n_corr = self.bch.decode_lane_major(
            hard_t[: self.cfg.fec.nbch]
        )
        kbits_t = corrected_t[: self.cfg.fec.kbch].to(torch.int64)
        B = kbits_t.shape[1]
        kbytes = (kbits_t.reshape(-1, 8, B) * self._byte_w[:, None]).sum(1)
        return (kbytes.to(torch.uint8).t().contiguous(),
                n_corr.to(torch.int32), iters.to(torch.int32),
                ok.to(torch.int32), hard_t)
