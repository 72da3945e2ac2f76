"""The plain reference of a piloted APSK frame's payload path: PL
descrambling, the data-aided phases of the PLHEADER and of each pilot
block, the pilot-mode fine CFO and derotation, the SNR and N0, 16APSK
max-log LLRs, the bit de-interleaver and the int8 quantisation; and the
post-decoder SNR refinement. After ETSI EN 302 307-1.

Plain PyTorch in float64 (complex128). It imports nothing of the program
(and no JAX): its tables come from the benchmark's own copies of the
transmitter's (``rxbench.txref``), and its 16APSK points are computed
here from the ring ratio.

The standard defines the waveform: the PLHEADER (SOF and the scrambled
PLSC codeword in pi/2-BPSK, section 5.5.2), the pilot blocks (36 symbols
of (1 + j)/sqrt(2) after every 16 slots, section 5.5.3), the PL
scrambling of everything after the PLHEADER (section 5.5.4), the 16APSK
mapping with ring ratio gamma (section 5.4.3, Table 9: 2.85 at rate 3/4)
and the bit interleaver (section 5.3.3). It leaves the receiver's
estimators open. Those here follow the receiver design the port takes
from gr-dvbs2rx (``lib/pl_freq_sync.cc``,
``lib/xfecframe_demapper_cb_impl.cc``). Departures from a textbook reading,
each the receiver's own choice:

- a phase reference (the header's, or a pilot block's) is applied from
  the first data symbol of the segment after it, with the fine CFO's ramp
  starting there, not from the reference's centre;
- the fine CFO is the sum of the wrapped phase steps from the header's
  last 36 symbols to each pilot block in turn, over 2 pi x 1,476 symbols
  a step, the pilot period;
- the N0 that scales the LLRs is 1 / SNR, the SNR data-aided over the
  whole XFECFRAME against each symbol's nearest point (the decision
  regions of the constellation, not the transmitted symbols); a carried
  N0 > 0 (the previous frame's post-decoder refinement) takes its place;
- max-log LLRs, (min over points with the bit at 1 of |y - x|^2 less the
  min over points with it at 0) / N0, positive for bit 0, without the
  factor of 2 a log-likelihood ratio of sigma^2 = N0 / 2 would carry;
- int8 by rounding half to even, then saturating to [-128, 127].
"""

import math

import numpy as np
import torch

from ..txref.constellations import BITS_PER_SYMBOL, GAMMA_16APSK
from ..txref.interleaver import column_order
from ..txref.pi2_bpsk import map_bpsk
from ..txref.pl_defs import (
    PILOT_BLK_INTERVAL,
    PILOT_BLK_LEN,
    PILOT_BLK_PERIOD,
    PLHEADER_LEN,
    PLSC_SCRAMBLER_BITS,
    SOF_BITS,
)
from ..txref.pls import parse_pls
from ..txref.reed_muller import codeword_bits
from ..txref.scramblers import pl_scrambling_rn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CDT = torch.complex128
PILOT = (1.0 + 1.0j) / math.sqrt(2.0)
# 16APSK MODCODs (EN 302 307-1 Table 12) and their code rates
RATE_16APSK = {18: "2/3", 19: "3/4", 20: "4/5", 21: "5/6", 22: "8/9",
               23: "9/10"}
TAIL = 36               # the header's last symbols: the fine CFO's origin


def apsk16_points(gamma):
    """The 16 points of 16APSK (EN 302 307-1 Figure 10) at ring ratio
    ``gamma``, unit mean energy, indexed by the symbol's 4-bit word, MSB
    first: 12 points on the outer ring at odd multiples of pi/12, then 4
    on the inner ring at odd multiples of pi/4. Complex128."""
    r1 = math.sqrt(16.0 / (4.0 + 12.0 * gamma * gamma))
    r2 = gamma * r1
    outer = (3, -3, 9, -9, 1, -1, 11, -11, 5, -5, 7, -7)
    inner = (3, -3, 9, -9)
    pts = [r2 * np.exp(1j * k * math.pi / 12) for k in outer]
    pts += [r1 * np.exp(1j * k * math.pi / 12) for k in inner]
    return torch.tensor(np.array(pts), dtype=CDT)


def header_symbols(pls):
    """The ideal PLHEADER of PLS ``pls`` (90 complex128 symbols)."""
    bits = np.concatenate([SOF_BITS, codeword_bits()[pls]
                           ^ PLSC_SCRAMBLER_BITS])
    return torch.tensor(map_bpsk(bits).astype(np.complex128))


def descrambler(gold_code, n):
    """conj of the PL scrambling sequence exp(j Rn pi / 2), n symbols."""
    rn = torch.tensor(pl_scrambling_rn(gold_code)[:n].astype(np.int64))
    return _rot(-rn.to(torch.float64) * (math.pi / 2))


def _rot(angle):
    """exp(j angle), complex128."""
    return torch.polar(torch.ones_like(angle), angle)


def _wrap(x):
    """x wrapped into (-pi, pi]."""
    return math.pi - torch.remainder(math.pi - x, 2 * math.pi)


def _phase(y, ideal):
    """Data-aided phase: the angle of sum(y conj(ideal)) over the last
    axis."""
    return torch.angle((y * ideal.conj()).sum(-1))


def _complex(x):
    x = torch.as_tensor(x)
    if x.is_complex():
        return x.to(CDT)
    return torch.complex(x[..., 0].double(), x[..., 1].double())


def _nearest(y, pts):
    """Each symbol's nearest point: (points (..., n) complex, squared
    distances (..., n, P))."""
    d2 = (y[..., None] - pts).abs() ** 2
    return pts[d2.argmin(-1)], d2


def frame_payload(frame, pls, n0_carried=0.0, coarse_corrected=True,
                  gold_code=0, gamma=None):
    """One frame's payload path.

    ``frame``: the frame's on-time symbols from the first PLHEADER symbol,
    (..., n, 2) real or (..., n) complex, n >= the PLFRAME length (leading
    axes are frames); ``pls`` its PLS (piloted 16APSK); ``n0_carried``
    (float or (...,)): the N0 the LLRs take where > 0, else the
    data-aided one; ``coarse_corrected`` (bool or (...,)): the fine CFO's
    ramp is applied only where set (before that the carrier loop's coarse
    stage owns the frequency); ``gamma`` the ring ratio (default: Table
    9's for the PLS's rate).

    Returns a dict: ``llrs`` (..., n_ldpc) int8 in codeword order,
    ``llrs_float`` the same before quantisation, ``fine`` the fine CFO
    (cycles a symbol), ``n0`` the data-aided N0, ``snr``, ``xfec`` the
    corrected XFECFRAME symbols (..., n_slots x 90) complex128, and the
    phases ``header_phase``, ``pilot_phases``."""
    info = parse_pls(pls)
    if not info.has_pilots or info.constellation != "16APSK":
        raise ValueError(f"PLS {pls}: the reference covers piloted 16APSK")
    rate = RATE_16APSK[info.modcod]
    pts = apsk16_points(GAMMA_16APSK[rate] if gamma is None else gamma)
    y = _complex(frame)[..., : info.plframe_len]
    hdr, pay = y[..., :PLHEADER_LEN], y[..., PLHEADER_LEN:]
    # 1. descrambling (section 5.5.4), pilots included
    pay = pay * descrambler(gold_code, info.payload_len)
    # 2. the data-aided phases: the header, its tail, each pilot block
    ideal = header_symbols(pls)
    ph_hdr = _phase(hdr, ideal)
    ph_tail = _phase(hdr[..., -TAIL:], ideal[-TAIL:])
    pilot = torch.full((PILOT_BLK_LEN,), PILOT, dtype=CDT)
    ph_pil = torch.stack([
        _phase(pay[..., (k + 1) * PILOT_BLK_PERIOD - PILOT_BLK_LEN:
                   (k + 1) * PILOT_BLK_PERIOD], pilot)
        for k in range(info.n_pilots)], dim=-1)
    # 3. the pilot-mode fine CFO
    steps = torch.cat([ph_tail[..., None], ph_pil], dim=-1)
    fine = _wrap(steps[..., 1:] - steps[..., :-1]).sum(-1) / (
        2 * math.pi * PILOT_BLK_PERIOD * info.n_pilots)
    f = torch.where(torch.as_tensor(coarse_corrected), fine,
                    torch.zeros_like(fine))
    # 4. derotation segment by segment, pilots dropped
    segs = []
    for k in range(info.n_pilots + 1):
        a = k * PILOT_BLK_PERIOD
        data = pay[..., a: a + PILOT_BLK_INTERVAL] if k < info.n_pilots \
            else pay[..., a:]
        ref = ph_hdr if k == 0 else ph_pil[..., k - 1]
        n = torch.arange(data.shape[-1], dtype=torch.float64)
        segs.append(data * _rot(-(ref[..., None]
                                  + 2 * math.pi * f[..., None] * n)))
    xfec = torch.cat(segs, dim=-1)
    # 5. SNR and N0, data-aided against the nearest points
    near, d2 = _nearest(xfec, pts)
    snr = (near.abs() ** 2).sum(-1) / ((xfec - near).abs() ** 2).sum(-1)
    n0 = 1.0 / snr
    n0c = torch.as_tensor(n0_carried, dtype=torch.float64)
    n0_use = torch.where(n0c > 0, n0c, n0)
    # 6. max-log LLRs, symbol by symbol, MSB first
    n_mod = BITS_PER_SYMBOL["16APSK"]
    word = torch.arange(pts.numel())
    per_bit = []
    for b in range(n_mod):
        one = ((word >> (n_mod - 1 - b)) & 1).bool()
        m1 = d2[..., one].min(-1).values
        m0 = d2[..., ~one].min(-1).values
        per_bit.append((m1 - m0) / n0_use[..., None])
    sym_llrs = torch.stack(per_bit, dim=-1)           # (..., rows, n_mod)
    # 7. de-interleaving (section 5.3.3): bit k of symbol r is codeword
    # bit order[k] x rows + r
    order = column_order("16APSK", rate)
    cols = [sym_llrs[..., order.index(c)] for c in range(n_mod)]
    llrs = torch.cat(cols, dim=-1)
    # 8. int8: round half to even, saturate
    q = torch.round(llrs).clamp(-128, 127).to(torch.int8)
    return {"llrs": q, "llrs_float": llrs, "fine": fine, "n0": n0,
            "snr": snr, "xfec": xfec, "header_phase": ph_hdr,
            "pilot_phases": ph_pil}


def snr_refine(xfec, codeword, pls, gamma=None):
    """The post-decoder SNR refinement: the decoded codeword bits
    (..., n_ldpc) interleaved and mapped back to 16APSK points, and the
    corrected symbols ``xfec`` (..., R) measured against them (R may be a
    prefix of the XFECFRAME). Returns (snr, n0 = 1 / snr)."""
    info = parse_pls(pls)
    rate = RATE_16APSK[info.modcod]
    pts = apsk16_points(GAMMA_16APSK[rate] if gamma is None else gamma)
    n_mod = info.n_mod
    bits = torch.as_tensor(codeword).to(torch.int64)
    rows = bits.shape[-1] // n_mod
    cols = bits.reshape(bits.shape[:-1] + (n_mod, rows))
    order = column_order("16APSK", rate)
    word = torch.zeros(bits.shape[:-1] + (rows,), dtype=torch.int64)
    for k in range(n_mod):
        word = (word << 1) | cols[..., order[k], :]
    x = _complex(xfec)
    ref = pts[word[..., : x.shape[-1]]]
    snr = (ref.abs() ** 2).sum(-1) / ((x - ref).abs() ** 2).sum(-1)
    return snr, 1.0 / snr
