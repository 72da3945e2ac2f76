"""A plain front end that follows the CCM stream receiver's front end
through the steps of one call, from the state the call started with.

Plain PyTorch (float64 by default); it imports nothing of the program.
Per step, as EN 302 307-1 receivers of the port's design do it: the
block AGC (gain ``agc_ref / mean |x|``, smoothed by ``alpha``), the
rotator (phase ``phase0 + inc n``), the append to the right-aligned
sample buffer, the Oerder & Meyr timing estimate over 16 windows of 1,024
samples with a least-squares rate, the alpha-beta tracker with its slips,
and the segmented polyphase RRC matched filter.

What the reference takes from the program: its state at the call's start
(the sample buffer and fill, gain, rotator phase and increment, timing
position and rate) and, for each later step, the rotator increment the
closed loop set, which follows from the step's ``cum_foffset`` statistic
(``rot_inc = -cum 2 pi / sps`` in float32, as the receiver forms it).
Everything else it works out again from the benchmark's own IQ blocks.

``precision="tf32"`` is the control: every array float32, and the
operands of the two convolutions (the O&M interpolator and the matched
filter) rounded to TF32's 10-bit mantissa, as a tensor core takes them,
with float32 sums.

The matched filter's subfilter is ``floor(128 tau)`` of the segment's
timing position: where that lies within ``TIE`` of a whole number, the
neighbouring subfilter is as right to rounding, and ``tail`` returns both
candidates for the comparison to take the nearer.
"""

import math

import numpy as np
import torch

from ..txref.rrc import polyphase_rrc_bank

WIN_SAMP = 1024
MAX_WINDOWS = 16
MIN_MULTI_SAMP = 16384
MAX_RATE = 2.5e-4
SMOOTH = 0.1
RATE_GAIN = 0.15
N_SEGMENTS = 16
N_SUBFILT = 128
TIE = 0.05          # of one subfilter step: both neighbours are candidates
# the state a call starts from that the plain front end takes
STATE = ("sbuf", "sfill", "agc_gain", "rot_phase", "ff_tau", "ff_rate")


def tf32(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def halfband_taps(n_taps=23):
    n = np.arange(n_taps) - n_taps // 2
    h = np.sinc(n / 2.0) * np.hamming(n_taps)
    return (h / h.sum() * 2.0).astype(np.float32)


def segments(n_out):
    return next(s for s in range(min(N_SEGMENTS, n_out), 0, -1)
                if n_out % s == 0)


class FrontEnd:
    """The front end of a CCM stream receiver with ``n_in`` samples a step
    (``sps`` 2), its buffer of ``n_buf`` rows and ``history`` extra rows
    before each block."""

    def __init__(self, rx, n_in, n_buf, device, precision="exact"):
        self.sps = sps = rx["sps"]
        if sps != 2:
            raise ValueError("the reference front end takes sps 2")
        self.n_in, self.n_out, self.n_buf = n_in, n_in // sps, n_buf
        self.dt = torch.float64 if precision == "exact" else torch.float32
        self.conv = (lambda x: x) if precision == "exact" else tf32
        self.dev = device
        bank, self.L, _ = polyphase_rrc_bank(sps, rx["rolloff"],
                                             rx["rrc_delay"], N_SUBFILT)
        self.bank = torch.as_tensor(bank, device=device)
        self.off_bound = max(16, int(np.ceil(2 + 2 * sps
                                             + MAX_RATE * self.n_out)))
        self.n_fe = n_in + self.L + self.off_bound + 2
        hb = halfband_taps()
        self.centre = float(hb[hb.size // 2])
        self.hb_rev = torch.as_tensor(np.ascontiguousarray(hb[0::2][::-1]),
                                      device=device)
        self.agc_alpha = min(1.0, rx.get("agc_rate", 1e-5) * n_in)
        self.agc_ref = rx.get("agc_ref", 1.0)
        n = self.n_fe
        W = min(MAX_WINDOWS, n // WIN_SAMP)
        offs = np.round(np.linspace(0, n - WIN_SAMP, W)).astype(np.int64)
        self.win_offs = (offs // 2) * 2
        self.win_centres = torch.as_tensor(
            (self.win_offs + WIN_SAMP / 2) / sps, dtype=self.dt,
            device=device)
        self.S = segments(self.n_out)
        self.seg_len = self.n_out // self.S

    def _t(self, x):
        return torch.as_tensor(x, device=self.dev).to(self.dt)

    def run(self, state, blocks, incs):
        """``state``: the call's starting state (``sbuf`` (C, N, 2),
        ``sfill``, ``agc_gain``, ``rot_phase``, ``ff_tau``, ``ff_rate``
        (C,)); ``blocks`` (T, C, n_in, 2) the call's IQ; ``incs`` (T, C)
        each step's rotator increment. Returns the state after the T
        steps, with the last step's segments' timing (``tau_seg``)."""
        st = {k: (self._t(state[k]) if k != "sfill" else
                  torch.as_tensor(state[k], device=self.dev).to(torch.int64))
              for k in STATE}
        for t in range(blocks.shape[0]):
            st = self.step(st, self._t(blocks[t]), self._t(incs[t]))
        return st

    def step(self, st, iq, inc):
        sps, n_in = self.sps, self.n_in
        mag = torch.sqrt(iq[..., 0] ** 2 + iq[..., 1] ** 2).mean(-1)
        target = self.agc_ref / mag.clamp(min=1e-12)
        gain = (1.0 - self.agc_alpha) * st["agc_gain"] \
            + self.agc_alpha * target
        x = iq * gain[:, None, None]
        n = torch.arange(n_in, device=self.dev, dtype=self.dt)
        ph = st["rot_phase"][:, None] + inc[:, None] * n
        c, s = torch.cos(ph), torch.sin(ph)
        rot = torch.stack([x[..., 0] * c - x[..., 1] * s,
                           x[..., 1] * c + x[..., 0] * s], dim=-1)
        phase = torch.remainder(st["rot_phase"] + inc * n_in, 2 * math.pi)
        N = self.n_buf
        sbuf = torch.cat([st["sbuf"][:, n_in:], rot], dim=1)
        sfill = (st["sfill"] + n_in).clamp(max=N)
        start = (N - sfill).clamp(0, N - self.n_fe)
        idx = start[:, None] + torch.arange(self.n_fe, device=self.dev)
        block = torch.gather(sbuf, 1, idx[..., None].expand(-1, -1, 2))
        tau0, rate = self._estimate(st, block)
        tau_seg = tau0[:, None] + rate[:, None] * (
            (torch.arange(self.S, device=self.dev, dtype=self.dt) + 0.5)
            * self.seg_len)
        pos_end = tau0 + rate * self.n_out
        band = (pos_end >= -0.5 * sps) & (pos_end < 1.5 * sps)
        slip = torch.where(band, torch.zeros_like(pos_end),
                           torch.floor((pos_end + 0.5 * sps) / sps))
        consumed = (self.n_out + slip.to(torch.int64)) * sps
        return {"sbuf": sbuf, "sfill": sfill - consumed, "agc_gain": gain,
                "rot_phase": phase, "ff_tau": pos_end - slip * sps,
                "ff_rate": rate, "block": block, "tau_seg": tau_seg}

    def _om_terms(self, w):
        """O&M correlator terms of windows ``w`` (..., n, 2)."""
        sq_even = (self.centre * self.centre) * (w[..., 0] ** 2
                                                 + w[..., 1] ** 2)
        x = torch.nn.functional.pad(w.movedim(-1, 0), (6, 5))
        taps = self.conv(self.hb_rev.to(self.dt))
        o = (self.conv(x).unfold(-1, taps.numel(), 1) * taps).sum(-1)
        sq_odd = o[0] ** 2 + o[1] ** 2
        n = w.shape[-2]
        sign = self._t(np.where(np.arange(n) % 2 == 0, 1.0, -1.0))
        odd = sign.clone()
        odd[0] = 0.0
        return sq_even * sign, sq_odd * odd

    def _estimate(self, st, block):
        sps = self.sps
        if block.shape[1] < MIN_MULTI_SAMP:
            raise ValueError("the reference takes the multi-window estimate")
        wins = torch.stack([block[:, int(o): int(o) + WIN_SAMP]
                            for o in self.win_offs], dim=1)
        c_re, c_im = self._om_terms(wins)
        tau_w = (-torch.atan2(c_im.sum(-1), c_re.sum(-1))
                 / (2 * math.pi)) * sps
        d = torch.remainder(tau_w[:, 1:] - tau_w[:, :-1] + sps / 2, sps) \
            - sps / 2
        t_un = torch.cat([torch.zeros_like(tau_w[:, :1]),
                          torch.cumsum(d, dim=1)], dim=1)
        wc = self.win_centres
        wbar = wc.mean()
        tbar = t_un.mean(dim=1)
        slope = ((wc - wbar) * (t_un - tbar[:, None])).sum(1) \
            / ((wc - wbar) ** 2).sum()
        tau_meas = torch.remainder(tau_w[:, 0] + tbar - slope * wbar, sps)
        rate_meas = slope.clamp(-MAX_RATE, MAX_RATE)
        innov = torch.remainder(tau_meas - st["ff_tau"] + sps / 2, sps) \
            - sps / 2
        rate = (st["ff_rate"] + RATE_GAIN * (rate_meas - st["ff_rate"])
                + RATE_GAIN * innov / self.n_out).clamp(-MAX_RATE, MAX_RATE)
        return st["ff_tau"] + SMOOTH * innov, rate

    def tail(self, st, n_tail):
        """The last ``n_tail`` symbols of the last step, (K, C, n_tail, 2)
        for the K = 3 subfilter choices ``floor(128 tau) + (-1, 0, 1)`` of
        each segment, and which of them rounding admits, (K, C) bool."""
        S, seg, sps, L = self.S, self.seg_len, self.sps, self.L
        first = self.n_out - n_tail
        s0 = first // seg
        if s0 != S - 1:
            raise ValueError("the tail spans two segments")
        q = torch.floor(N_SUBFILT * st["tau_seg"][:, s0])
        frac = N_SUBFILT * st["tau_seg"][:, s0] - q
        outs, ok = [], []
        bank = self.conv(self.bank.to(self.dt))
        block = self.conv(st["block"])
        for d in (-1, 0, 1):
            qd = (q + d).to(torch.int64)
            base = torch.div(qd, N_SUBFILT, rounding_mode="floor")
            sub = qd - base * N_SUBFILT
            off = (base + 2).clamp(0, self.off_bound)
            j = torch.arange(first - s0 * seg, seg, device=self.dev)
            rows = (s0 * seg * sps + off[:, None] + sps * j[None])[..., None] \
                + torch.arange(L, device=self.dev)            # (C, n, L)
            C = rows.shape[0]
            win = torch.gather(block, 1, rows.reshape(C, -1, 1)
                               .expand(-1, -1, 2)).reshape(C, -1, L, 2)
            outs.append((win * bank[sub][:, None, :, None]).sum(2))
            ok.append(torch.ones_like(frac, dtype=torch.bool) if d == 0 else
                      (frac < TIE) if d < 0 else (frac > 1.0 - TIE))
        return torch.stack(outs), torch.stack(ok)


def gaps(rx, n_in, n_buf, state, blocks, incs, got, control=False):
    """The front end's two gaps over one checked call: the plain front end
    from the call's starting ``state`` through ``blocks`` (T, C, n_in, 2)
    with the rotator increments ``incs`` (T, C), against what the program
    left after it, ``got``: ``sym_tail`` (C, n, 2), its last symbols, and
    ``ff_tau`` (C,). With ``control`` the plain front end in TF32 takes
    the program's place. Returns (the widest symbol gap as a share of the
    channel's RMS symbol, the widest timing gap in samples)."""
    dev = blocks.device
    fe = FrontEnd(rx, n_in, n_buf, dev)
    want = fe.run(state, blocks, incs)
    cands, ok = fe.tail(want, got["sym_tail"].shape[1])
    if control:
        low = FrontEnd(rx, n_in, n_buf, dev, precision="tf32")
        got_st = low.run(state, blocks, incs)
        got = {"sym_tail": low.tail(got_st, cands.shape[2])[0][1],
               "ff_tau": got_st["ff_tau"]}
    tail = got["sym_tail"].to(cands.dtype)
    rms = torch.sqrt((cands[1] ** 2).sum(-1).mean(-1))               # (C,)
    gap = (tail[None] - cands).abs().amax(dim=(2, 3)) / rms           # (K, C)
    gap = torch.where(ok, gap, torch.inf).amin(0)
    tau = (got["ff_tau"].to(want["ff_tau"].dtype) - want["ff_tau"]).abs()
    return float(gap.max()), float(tau.max())
