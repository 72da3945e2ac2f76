"""Physical-layer synchronisation: frame timing metric, CFO and phase.

Port of ``dvbs2rx_tpu/ops/plsync.py`` (reference ``lib/pl_frame_sync.cc``,
``lib/pl_freq_sync.cc``): the dense SOF/PLSC timing metric, the per-frame
metric, the coarse CFO autocorrelation and its finalisation, the PLHEADER
and pilot phases, both fine-CFO estimators, both payload corrections and
the three PLSC decode modes (reference ``lib/pl_signaling.cc``) with the
PLHEADER derotation before them. The correlator taps are derived here from
the spec's SOF bits, PLSC scrambler and Reed-Muller codewords exactly as
the JAX module derives them (that module imports jax, so its numpy table
code cannot be imported).

All IQ is planar float32 (..., 2); leading axes are batch axes.
"""

import functools
import math

import numpy as np
import torch

from ..spec import reed_muller
from ..spec.pi2_bpsk import map_bpsk
from ..spec.pl_defs import (
    PILOT_BLK_LEN,
    PILOT_BLK_PERIOD,
    PLHEADER_LEN,
    PLSC_LEN,
    PLSC_SCRAMBLER_BITS,
    SLOT_LEN,
    SLOTS_PER_PILOT_BLK,
    SOF_BITS,
    SOF_LEN,
    SQRT2_2,
)

from ..utils.runtime import device_table
from . import cplx

FINE_FOFFSET_CORR_RANGE = 3.3875e-4
THRESHOLD_UNLOCKED = 30.0
THRESHOLD_LOCKED = 25.0
PLSC_CORR_LEN = PLSC_LEN // 2


@functools.lru_cache(maxsize=1)
def sof_diff_taps():
    """conj of the ideal SOF differentials d[j] = conj(s[j]) s[j-1]."""
    sof = map_bpsk(SOF_BITS)
    d = np.conj(sof[1:]) * sof[:-1]
    return np.conj(d).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def plsc_diff_taps():
    """conj of the PLSC within-pair differentials (even-b7 codeword)."""
    s = PLSC_SCRAMBLER_BITS
    par = (s[0::2] ^ s[1::2]).astype(np.float32)
    d = -1j * (1.0 - 2.0 * par)
    return np.conj(d).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def frame_sync_kernels():
    """Dense correlation kernels over d[n-i], i = 0..88 (numpy complex)."""
    k_sof = np.zeros(89, dtype=np.complex64)
    t_sof = sof_diff_taps()
    for j in range(1, SOF_LEN):
        k_sof[89 - j] = t_sof[j - 1]
    k_plsc = np.zeros(89, dtype=np.complex64)
    t_plsc = plsc_diff_taps()
    for k in range(PLSC_CORR_LEN):
        k_plsc[62 - 2 * k] = t_plsc[k]
    return k_sof, k_plsc


@functools.lru_cache(maxsize=1)
def plheader_conj_lut():
    """(128, 90, 2) planar conj of the ideal PLHEADER symbols per PLS."""
    out = np.empty((128, PLHEADER_LEN), dtype=np.complex64)
    for plsc in range(128):
        bits = np.concatenate(
            [SOF_BITS, reed_muller.codeword_bits()[plsc] ^ PLSC_SCRAMBLER_BITS]
        )
        out[plsc] = np.conj(map_bpsk(bits))
    return cplx.from_np(out)


@functools.lru_cache(maxsize=4)
def coarse_weights(N):
    """Mengali window weights w(m), m = 1..N-1."""
    L = N - 1
    m = np.arange(L, dtype=np.float64)
    w = 3.0 * ((2 * L + 1.0) ** 2 - (2 * m + 1.0) ** 2) / (
        ((2 * L + 1.0) ** 2 - 1) * (2 * L + 1)
    )
    return w.astype(np.float32)


def _t(x, like):
    return device_table(x, like.device)


@functools.lru_cache(maxsize=1)
def _frame_metric_taps():
    k_sof, k_plsc = frame_sync_kernels()
    return (cplx.from_np(np.ascontiguousarray(k_sof[::-1])),
            cplx.from_np(np.ascontiguousarray(k_plsc[::-1])))


def _wrap(x):
    x = torch.where(x > math.pi, x - 2 * math.pi, x)
    return torch.where(x < -math.pi, x + 2 * math.pi, x)


def differentials(ext):
    """d[m] = conj(x[m+1]) * x[m] over the symbol axis."""
    return cplx.conj_mul(ext[..., 1:, :], ext[..., :-1, :])


def timing_metric(symbols, history):
    """Dense SOF+PLSC timing metric at every position of symbol blocks.

    symbols: (..., N, 2); history: (..., 90, 2) tail of the previous block
    (zeros at stream start). metric[n] peaks when block symbol n is the last
    PLHEADER symbol. Returns (metric, sof_corr, plsc_corr).
    """
    hist_len = history.shape[-2]
    ext = torch.cat([history, symbols], dim=-2)
    d_ext = differentials(ext)
    k_sof, k_plsc = frame_sync_kernels()
    N = symbols.shape[-2]

    def corr(kernel):
        acc = torch.zeros(symbols.shape, dtype=torch.float32,
                          device=symbols.device)
        for i in range(kernel.shape[0]):
            if kernel[i] == 0:
                continue
            kr = float(np.float32(kernel[i].real))
            ki = float(np.float32(kernel[i].imag))
            s0 = hist_len - 1 - i
            seg = d_ext[..., s0: s0 + N, :]
            acc = acc + torch.stack(
                [seg[..., 0] * kr - seg[..., 1] * ki,
                 seg[..., 0] * ki + seg[..., 1] * kr], dim=-1,
            )
        return acc

    sof_c = corr(k_sof)
    plsc_c = corr(k_plsc)
    m = torch.maximum(torch.sqrt(cplx.abs2(sof_c + plsc_c)),
                      torch.sqrt(cplx.abs2(sof_c - plsc_c)))
    return m, sof_c, plsc_c


def frame_metric(d_frame):
    """Timing metric at the expected peak: d_frame (..., 89, 2)
    differentials at frame indexes 1..89 from each SOF."""
    ks_np, kp_np = _frame_metric_taps()
    ks, kp = _t(ks_np, d_frame), _t(kp_np, d_frame)
    sof_c = cplx.cmul(d_frame, ks).sum(dim=-2)
    plsc_c = cplx.cmul(d_frame, kp).sum(dim=-2)
    return torch.maximum(torch.sqrt(cplx.abs2(sof_c + plsc_c)),
                         torch.sqrt(cplx.abs2(sof_c - plsc_c)))


# ---------------- PLSC decoding ----------------

@functools.lru_cache(maxsize=1)
def _rm_images():
    return reed_muller.scrambled_euclidean_images()


@functools.lru_cache(maxsize=1)
def _pi2_derot_factors():
    rot = np.where(
        (np.arange(PLSC_LEN) + SOF_LEN) % 2 == 0,
        np.complex64(SQRT2_2 - 1j * SQRT2_2),
        np.complex64(-SQRT2_2 - 1j * SQRT2_2),
    )
    return cplx.from_np(rot)


def _ml_decode(pm, enabled_mask):
    """(..., 64) real PLSC values -> (argmax index int32, scores (..., 128))
    against the scrambled codeword images; outside ``enabled_mask`` ((128,)
    bool) a score is -inf. Ties go to the first index, as ``jnp.argmax``."""
    scores = torch.matmul(pm, _t(_rm_images(), pm).t())
    if enabled_mask is not None:
        scores = torch.where(enabled_mask, scores, float("-inf"))
    return scores.argmax(dim=-1).to(torch.int32), scores


def _derotated_plsc(plheader):
    """Real part of the PLSC symbols after the pi/2-BPSK derotation."""
    rot = _t(_pi2_derot_factors(), plheader)
    return cplx.cmul(plheader[..., SOF_LEN:, :], rot)[..., 0]


def plsc_decode_soft(plheader, enabled_mask=None):
    """Soft-ML decode of the PLSC from the 90-symbol planar PLHEADER
    (..., 90, 2). Returns (plsc index, correlation scores)."""
    return _ml_decode(_derotated_plsc(plheader), enabled_mask)


def plsc_decode_hard(plheader, enabled_mask=None):
    """Coherent-hard decode (reference ``pl_signaling.cc:140``): the signs of
    the derotated PLSC symbols against the same images (score = 64 - 2 x
    Hamming distance)."""
    soft = _derotated_plsc(plheader)
    return _ml_decode(torch.where(soft < 0, -1.0, 1.0), enabled_mask)


def plsc_decode_diff(plheader, enabled_mask=None):
    """Differential-hard decode robust to large CFO (reference
    ``pl_signaling.cc:142``): differential demap seeded by the last SOF
    symbol, then hard ML decode of the still-scrambled bits."""
    syms = plheader[..., SOF_LEN - 1:, :]               # (..., 65, 2)
    d = cplx.conj_mul(syms[..., 1:, :], syms[..., :-1, :])
    odd = torch.arange(PLSC_LEN, device=plheader.device) & 1
    flips = (d[..., 1] < 0).to(torch.int64) ^ odd
    bits = torch.cumsum(flips, dim=-1) & 1              # running XOR
    return _ml_decode((1 - 2 * bits).to(torch.float32), enabled_mask)


def sof_phase(plheader):
    """Header phase from the 26 known SOF symbols."""
    return data_aided_phase(plheader[..., :SOF_LEN, :],
                            _t(plheader_conj_lut(), plheader)[0, :SOF_LEN])


def derotate_plheader(plheader, foffset, apply_freq):
    """PLHEADER derotation before PLSC decoding (reference
    ``pl_freq_sync.cc:351-437``): the frequency ramp of ``foffset`` over the
    90 symbols when ``apply_freq`` (open loop only), then the SOF phase.
    ``foffset`` is a Python float and ``apply_freq`` a bool, or both are
    tensors broadcastable to the header batch shape ``plheader.shape[:-2]``
    (one value per channel: the JAX function, vmapped over channels, sees
    one scalar each)."""
    n = torch.arange(PLHEADER_LEN, dtype=torch.float32, device=plheader.device)
    # float32 product, as the JAX expression rounds it
    two_pi = float(np.float32(2 * math.pi))
    if isinstance(foffset, torch.Tensor):
        w = torch.where(apply_freq, foffset.to(torch.float32) * two_pi, 0.0)
        ph = w[..., None] * n
    else:
        w = np.float32(two_pi) * np.float32(foffset) if apply_freq else 0
        ph = float(w) * n
    hdr = cplx.cmul(plheader, cplx.cexp(-ph))
    return cplx.cmul(hdr, cplx.cexp(-sof_phase(hdr))[..., None, :])


def mod_removed_plheader(plheader, plsc):
    """Remove the data modulation: multiply by the conj ideal PLHEADER."""
    lut = _t(plheader_conj_lut(), plheader)
    return cplx.cmul(plheader, lut[plsc])


@functools.lru_cache(maxsize=4)
def _lag_matrix(N):
    """(N*N, N-1) 0/1 matrix summing p[n+m] conj(p[n]) (flat index
    (n+m)*N + n) into lag slot m-1, m = 1..N-1."""
    D = np.zeros((N * N, N - 1), np.float32)
    for m in range(1, N):
        n = np.arange(N - m)
        D[(n + m) * N + n, m - 1] = 1.0
    return D


def coarse_autocorr(plheader, plsc, full=True):
    """Autocorrelation contribution of PLHEADERs (batched).

    plheader: (..., 90, 2); plsc: (...) int. Returns r (..., N-1, 2) with
    r[m-1] = sum_n p[n+m] conj(p[n]), p the modulation-removed header (its
    SOF part only when ``full`` is False). On a CUDA tensor one launch of
    the PLHEADER kernel (``ops.plsync_cuda``), which sums each lag
    directly; on the CPU the plain version, ``coarse_autocorr_plain``.
    """
    if plheader.is_cuda:
        from .plsync_cuda import coarse_autocorr_cuda

        return coarse_autocorr_cuda(plheader, plsc, full)
    return coarse_autocorr_plain(plheader, plsc, full)


def coarse_autocorr_plain(plheader, plsc, full=True):
    """``coarse_autocorr`` in plain PyTorch: the JAX grouped-convolution
    formulation (a TPU dispatch-count workaround) becomes one outer product
    summed along its diagonals by a matmul."""
    p = mod_removed_plheader(plheader, plsc)
    N = PLHEADER_LEN if full else SOF_LEN
    p = p[..., :N, :]
    a, b = p[..., :, None, :], p[..., None, :, :]      # p[n'] and p[n]
    # p[n'] conj(p[n]) = (ar br + ai bi) + j (ai br - ar bi)
    prod = torch.stack(
        [a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1],
         a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]], dim=-1,
    ).flatten(-3, -2)                                  # (..., N*N, 2)
    # a float32 matmul (TF32 off) with a 0/1 matrix: deterministic, unlike
    # an atomic scatter-add
    r = torch.matmul(prod.transpose(-1, -2), _t(_lag_matrix(N), p))
    return r.transpose(-1, -2)


def coarse_foffset_from_autocorr(r):
    """Coarse CFO estimate from accumulated autocorrelation r (..., N-1, 2);
    normalised frequency offset in [-0.5, 0.5]."""
    N = r.shape[-2] + 1
    angles = cplx.angle(r)
    prev = torch.cat([torch.zeros_like(angles[..., :1]), angles[..., :-1]],
                     dim=-1)
    diff = _wrap(angles - prev)
    w = _t(coarse_weights(N), r)
    est = (diff * w).sum(-1) / (2 * math.pi)
    return est.clamp(-0.5, 0.5)


def data_aided_phase(syms, expected_conj):
    """Average phase of modulation-removed symbols (batched, planar)."""
    ck = cplx.cmul(syms, expected_conj).sum(dim=-2)
    return torch.atan2(ck[..., 1], ck[..., 0])


def plheader_phase(plheader, plsc):
    lut = _t(plheader_conj_lut(), plheader)
    return data_aided_phase(plheader, lut[plsc])


def plheader_tail_phase(plheader, plsc):
    """Data-aided phase of the PLHEADER's last 36 symbols (the pilot-mode
    fine CFO's first phase)."""
    lut = _t(plheader_conj_lut(), plheader)
    tail_conj = lut[plsc][..., PLHEADER_LEN - PILOT_BLK_LEN:, :]
    return data_aided_phase(plheader[..., PLHEADER_LEN - PILOT_BLK_LEN:, :],
                            tail_conj)


def pilot_phases(payload_descrambled, n_pilots: int):
    """Average phase of each descrambled 36-symbol pilot block (batched),
    less the pilots' pi/4; (..., n_pilots) or None without pilots."""
    phases = []
    for i in range(n_pilots):
        end = (i + 1) * PILOT_BLK_PERIOD
        ck = payload_descrambled[..., end - PILOT_BLK_LEN: end, :].sum(-2)
        phases.append(_wrap(torch.atan2(ck[..., 1], ck[..., 0]) - math.pi / 4))
    return torch.stack(phases, dim=-1) if phases else None


def fine_foffset_pilot_mode(plheader, payload_descrambled, plsc,
                            n_pilots: int):
    """Pilot-aided fine CFO (reference ``pl_freq_sync.cc:255-303``)."""
    return fine_from_pilot_phases(
        plheader_tail_phase(plheader, plsc),
        pilot_phases(payload_descrambled, n_pilots), n_pilots)


def fine_from_pilot_phases(ph0, phs, n_pilots: int):
    """Pilot-aided fine CFO from the header tail phase ``ph0`` (...) and
    the pilot-block phases ``phs`` (..., n_pilots)."""
    allph = torch.cat([ph0[..., None], phs], dim=-1)
    diff = _wrap(allph[..., 1:] - allph[..., :-1])
    return diff.sum(-1) / (2 * math.pi * PILOT_BLK_PERIOD * n_pilots)


def fine_foffset_pilotless(curr_phase, next_phase, plframe_len: int):
    """PLHEADER-to-PLHEADER fine CFO (reference ``pl_freq_sync.cc:305-349``)."""
    return _wrap(next_phase - curr_phase) / (2 * math.pi * plframe_len)


def correct_payload_pilotless(payload_descrambled, phase, fine_foffset):
    """Feed-forward derotation: e^{-j(phase + 2*pi*f*n)} over the payload."""
    n = torch.arange(payload_descrambled.shape[-2], dtype=torch.float32,
                     device=payload_descrambled.device)
    ph = phase[..., None] + 2 * math.pi * fine_foffset[..., None] * n
    return cplx.cmul(payload_descrambled, cplx.cexp(-ph))


def correct_payload_pilots(payload_descrambled, header_phase, pilot_phs,
                           fine_foffset, n_slots: int, n_pilots: int):
    """Segment-wise phase correction for pilot mode; returns the corrected
    data symbols (pilots dropped), (..., n_slots*90, 2)."""
    seg_len = SLOTS_PER_PILOT_BLK * SLOT_LEN
    outs = []
    for seg in range(n_pilots + 1):
        start = seg * PILOT_BLK_PERIOD
        if seg < n_pilots:
            data = payload_descrambled[..., start: start + seg_len, :]
        else:
            data = payload_descrambled[..., start:, :]
        phase = header_phase if seg == 0 else pilot_phs[..., seg - 1]
        n = torch.arange(data.shape[-2], dtype=torch.float32,
                         device=data.device)
        ph = phase[..., None] + 2 * math.pi * fine_foffset[..., None] * n
        outs.append(cplx.cmul(data, cplx.cexp(-ph)))
    return torch.cat(outs, dim=-2)
