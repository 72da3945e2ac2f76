"""Feed-forward symbol timing recovery (Oerder & Meyr), batched.

Port of ``dvbs2rx_tpu/ops/ffsync.py``: O&M timing estimates (single- and
multi-window), the alpha-beta position/rate tracker, integer slips and the
segmented polyphase matched filter. The JAX class is written per channel
and vmapped; here every function takes the channel axis as a leading batch
axis. The JAX one-hot matmul that selects each segment's subfilter was a
TPU workaround (gathers serialise there) and is plain indexing here.

On the card the timing estimate and its tracker are one launch of
``csrc/ffsync.cu`` (``ops/ffsync_cuda.py``) and the matched filter one of
``csrc/mf_segmented.cu`` (``fir_cuda.mf_segmented``); CPU tensors run
their plain versions (``_track_plain`` here, ``mf_segmented_plain``).
Both take the block in place from a longer buffer when given per-channel
starts (``step_batched(..., start=, length=)``): the stream receivers'
right-aligned sample buffer is read where it lies.
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..spec.rrc import polyphase_rrc_bank

from ..utils.runtime import device_table, resolve_device
from . import ffsync_cuda
from .cplx import mod, window_rows
from .fir_cuda import mf_decimate, mf_segmented

# constants of the JAX module (see its comments for the derivations)
MAX_RATE = 2.5e-4
WIN_SAMP = 1024
MAX_WINDOWS = 16
MIN_MULTI_SAMP = 16384


@functools.lru_cache(maxsize=8)
def _window_offsets(n):
    """MAX_WINDOWS window starts spread evenly over the block, even so
    every window keeps the same (-1)^n correlator parity."""
    W = min(MAX_WINDOWS, n // WIN_SAMP)
    offs = np.round(np.linspace(0, n - WIN_SAMP, W)).astype(np.int64)
    return (offs // 2) * 2


@functools.lru_cache(maxsize=8)
def _om_signs(n):
    """(-1)^k for k < n, and the same with index 0 masked (the odd
    branch's), as float32 tables (constants of the step go through
    ``device_table``: no host-to-device copy inside it)."""
    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    odd = sign.copy()
    odd[0] = 0.0
    return sign, odd


@functools.lru_cache(maxsize=8)
def _window_centres(n, sps):
    return ((_window_offsets(n) + WIN_SAMP / 2) / sps).astype(np.float32)


def halfband_taps(n_taps=23):
    """Half-band lowpass for 2x interpolation (odd length, zero at even lags)."""
    n = np.arange(n_taps) - n_taps // 2
    h = np.sinc(n / 2.0) * np.hamming(n_taps)
    return (h / h.sum() * 2.0).astype(np.float32)


@dataclass
class FFSyncState:
    tau: torch.Tensor          # (C,) timing position at block start, samples
    rate: torch.Tensor         # (C,) drift, input samples per output symbol
    initialized: torch.Tensor  # (C,) int32 flag (first block takes tau)


class FeedForwardSync:
    """Block-wise O&M timing recovery + polyphase RRC matched filtering.

    ``step_batched(states, samples, n_out)``: samples (C, n, 2) planar at
    sps/T; returns (states', symbols (C, n_out, 2), consumed (C,) int32).
    ``step(state, samples, n_out)``: the same for one stream, (n, 2).
    """

    def __init__(self, sps=2, rolloff=0.2, rrc_delay=5, n_subfilt=128,
                 smooth=0.1, rate_gain=0.15, est_window=16384, n_segments=16,
                 max_block=40000, device=None):
        if sps != 2:
            raise ValueError("FeedForwardSync currently supports sps=2")
        self.device = resolve_device(device)
        self.sps = sps
        self.smooth = smooth
        self.rate_gain = rate_gain
        self.est_window = est_window
        self.n_segments = n_segments
        bank, self.subfilt_len, self.subfilt_delay = polyphase_rrc_bank(
            sps, rolloff, rrc_delay, n_subfilt
        )
        self.n_subfilt = n_subfilt
        self.bank = torch.as_tensor(bank, device=self.device)  # (n_subfilt, L)
        hb = halfband_taps()
        c = hb.shape[0] // 2
        self._center = float(np.float32(hb[c]))
        # the odd interpolator branch, as a correlation kernel: "same"-mode
        # jnp.convolve with the 12 even taps is o[k] = sum_j x[k+5-j] h[j]
        self._hb_even_rev = torch.as_tensor(
            np.ascontiguousarray(hb[0::2][::-1]), device=self.device
        )
        # the same taps on the host: the tracker kernel takes them in its
        # arguments
        self._hb_even_rev_np = np.ascontiguousarray(hb[0::2][::-1])
        self.max_block = max_block
        self._off = max(16, int(np.ceil(2 + 2 * sps + MAX_RATE * max_block)))
        self._history = self.subfilt_len + self._off + 2

    def history(self) -> int:
        return self._history

    def init_state(self, n_channels: int = None) -> FFSyncState:
        """Zero state of (C,) leaves, or of 0-dim leaves for one stream
        (``n_channels=None``, the JAX ``init_state()`` that ``step``
        takes)."""
        shape = () if n_channels is None else (n_channels,)
        z = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return FFSyncState(
            tau=z, rate=z.clone(),
            initialized=torch.zeros(shape, dtype=torch.int32,
                                    device=self.device),
        )

    # ---------- internals ----------

    def _om_terms(self, samples):
        """Per-sample O&M correlator contributions (c_re, c_im), each
        (..., n), for samples (..., n, 2) (see the JAX docstring: even
        branch = centre tap, odd branch = one 12-tap convolution at the
        input rate, sign (-1)^n with the odd branch's index 0 masked)."""
        hb = self._hb_even_rev
        x = samples.movedim(-1, 0)                         # (2, ..., n)
        n = x.shape[-1]
        sq_even = (self._center * self._center) * (x[0] * x[0] + x[1] * x[1])
        # o[k] = sum_j x[k+5-j] h[j]: pad 6 left / 5 right, correlate with
        # the reversed taps
        xp = torch.nn.functional.pad(x, (6, 5))
        o = (xp.unfold(-1, hb.shape[0], 1) * hb).sum(-1)  # (2, ..., n)
        sq_odd = o[0] * o[0] + o[1] * o[1]
        sign, sign_odd = (device_table(t, samples.device)
                          for t in _om_signs(n))
        return sq_even * sign, sq_odd * sign_odd

    def _estimate_tau(self, samples):
        """Single-window O&M estimate in input samples, range [0, sps)."""
        c_re, c_im = self._om_terms(samples[:, : self.est_window])
        tau_sym = -torch.atan2(c_im.sum(-1), c_re.sum(-1)) / (2 * math.pi)
        return mod(tau_sym * self.sps, self.sps)

    def _estimate_timing_multi(self, samples):
        """Windowed O&M: position at block start and a direct rate measure
        (least-squares slope over MAX_WINDOWS unwrapped window estimates)."""
        n = samples.shape[1]
        offs = _window_offsets(n)
        wins = torch.stack(
            [samples[:, int(o): int(o) + WIN_SAMP] for o in offs], dim=1
        )                                           # (C, W, WIN_SAMP, 2)
        c_re, c_im = self._om_terms(wins)
        re_w = c_re.sum(-1)
        im_w = c_im.sum(-1)
        sps = self.sps
        tau_w = (-torch.atan2(im_w, re_w) / (2 * math.pi)) * sps
        d = mod(tau_w[:, 1:] - tau_w[:, :-1] + sps / 2, sps) - sps / 2
        t_un = torch.cat([torch.zeros_like(tau_w[:, :1]),
                          torch.cumsum(d, dim=1)], dim=1)
        wc = device_table(_window_centres(n, sps), samples.device)
        wbar = wc.mean()
        tbar = t_un.mean(dim=1, keepdim=True)
        slope = ((wc - wbar) * (t_un - tbar)).sum(1) / ((wc - wbar) ** 2).sum()
        tau0 = mod(tau_w[:, 0] + tbar[:, 0] - slope * wbar, sps)
        return tau0, slope

    def segments(self, n_out: int) -> int:
        """Largest divisor of n_out within the configured segment count."""
        return next(
            s for s in range(min(self.n_segments, n_out), 0, -1)
            if n_out % s == 0
        )

    def _track(self, state: FFSyncState, samples, n_out: int, start=None,
               length=None):
        """Timing estimation + alpha-beta tracking + slips, all channels:
        one kernel launch for CUDA tensors (``ffsync_cuda.track``), the
        plain version (``_track_plain``) for CPU ones. ``samples`` (C, n,
        2) is the block, or with ``start`` (C,) int and ``length`` a longer
        buffer whose rows start .. start + length - 1 (the start clamped
        into range) are each channel's block.

        Returns (new_state, taps_seg (C, S, L), off_seg (C, S), consumed)."""
        if n_out > self.max_block:
            raise ValueError(
                f"front-end block of {n_out} symbols exceeds max_block="
                f"{self.max_block}"
            )
        if samples.is_cuda:
            return ffsync_cuda.track(self, state, samples, n_out, start,
                                     length)
        if start is not None:
            samples = window_rows(samples, start, length)
        return self._track_plain(state, samples, n_out)

    def _estimate(self, state: FFSyncState, samples, n_out: int):
        """The timing estimate and its alpha-beta update: (tau0, rate) at
        the block's start, (C,) each (the first half of
        ``_track_plain``)."""
        sps = self.sps
        n_samp = samples.shape[1]
        init = state.initialized > 0
        if n_samp >= MIN_MULTI_SAMP:
            tau_meas, rate_meas = self._estimate_timing_multi(samples)
            rate_meas = rate_meas.clamp(-MAX_RATE, MAX_RATE)
            innov = mod(tau_meas - state.tau + sps / 2, sps) - sps / 2
            rate = torch.where(
                init,
                (state.rate + self.rate_gain * (rate_meas - state.rate)
                 + self.rate_gain * innov / n_out).clamp(-MAX_RATE, MAX_RATE),
                rate_meas,
            )
            tau0 = torch.where(init, state.tau + self.smooth * innov, tau_meas)
        else:
            tau_meas = self._estimate_tau(samples)
            c_sym = min(self.est_window, n_samp) / (2.0 * sps)
            pred_c = state.tau + state.rate * c_sym
            innov = mod(tau_meas - pred_c + sps / 2, sps) - sps / 2
            tau0 = torch.where(init, state.tau + self.smooth * innov, tau_meas)
            rate = torch.where(
                init,
                (state.rate + self.rate_gain * innov / n_out).clamp(
                    -MAX_RATE, MAX_RATE),
                torch.zeros_like(state.rate),
            )
        return tau0, rate

    def _track_plain(self, state: FFSyncState, samples, n_out: int):
        """Plain version of ``_track`` on the block (C, n, 2) itself (the
        JAX ``_track_impl``, vmapped)."""
        tau0, rate = self._estimate(state, samples, n_out)
        return self._segments_and_slips(state, tau0, rate, n_out)

    def _segments_and_slips(self, state, tau0, rate, n_out: int):
        """Each segment's subfilter taps and offset, the carry and the
        slips, from the block-start position and rate."""
        sps = self.sps
        S = self.segments(n_out)
        seg_len = n_out // S
        # segmented polyphase extraction: each segment takes the subfilter
        # phase at its centre and a whole-sample offset (+2 sample slack)
        k_centers = (torch.arange(S, dtype=torch.float32,
                                  device=tau0.device) + 0.5) * seg_len
        tau_seg = tau0[:, None] + rate[:, None] * k_centers          # (C, S)
        base_seg = torch.floor(tau_seg).to(torch.int32)
        mu_seg = tau_seg - base_seg.to(torch.float32)
        idx_seg = torch.floor(self.n_subfilt * mu_seg).to(torch.int64).clamp(
            0, self.n_subfilt - 1)
        taps_seg = self.bank[idx_seg]                                # (C,S,L)
        off_seg = (base_seg + 2).clamp(0, self._off)

        # carry + slips (half-symbol hysteresis deadband [-sps/2, 1.5*sps))
        pos_end = tau0 + rate * n_out
        in_deadband = (pos_end >= -0.5 * sps) & (pos_end < 1.5 * sps)
        slip_syms = torch.where(
            in_deadband, torch.zeros_like(pos_end),
            torch.floor((pos_end + 0.5 * sps) / sps),
        ).to(torch.int32)
        tau_next = pos_end - slip_syms.to(torch.float32) * sps
        consumed = n_out * sps + slip_syms * sps
        new_state = FFSyncState(
            tau=tau_next, rate=rate,
            initialized=torch.ones_like(state.initialized),
        )
        return new_state, taps_seg, off_seg, consumed.to(torch.int32)

    def step_batched(self, states: FFSyncState, samples, n_out: int,
                     start=None, length=None):
        """Multi-channel step: states of (C,) leaves, samples (C, n, 2):
        the block, or with ``start`` (C,) int and ``length`` a longer
        buffer holding each channel's block of ``length`` rows from its
        start (clamped as ``jax.lax.dynamic_slice`` clamps), read in place.

        On the card: one tracker launch and one matched-filter launch for
        all channels and segments."""
        new_states, taps_seg, off_seg, consumed = self._track(
            states, samples, n_out, start, length
        )
        S = taps_seg.shape[1]
        if S == 1:
            n_samp = samples.shape[1] if start is None else length
            base = off_seg[:, 0].clamp(
                0, n_samp - n_out * self.sps - self.subfilt_len)
            syms = mf_decimate(samples, taps_seg[:, 0], base, self.sps,
                               n_out, start, length)
        else:
            syms = mf_segmented(samples, taps_seg, off_seg, self.sps,
                                n_out // S, self._off, start, length)
        return new_states, syms, consumed

    def step(self, state: FFSyncState, samples, n_out: int):
        """Single-stream step (the JAX ``step``): state of 0-dim leaves
        (``init_state()``), samples (n, 2) float32 (a tensor or numpy) ->
        (state' of 0-dim leaves, symbols (n_out, 2), consumed 0-dim int32).
        ``step_batched`` on a channel axis of 1."""
        samples = torch.as_tensor(samples, dtype=torch.float32,
                                  device=self.device)
        st = FFSyncState(*(x.reshape(1) for x in (
            state.tau, state.rate, state.initialized)))
        new, syms, consumed = self.step_batched(st, samples[None], n_out)
        return (FFSyncState(new.tau[0], new.rate[0], new.initialized[0]),
                syms[0], consumed[0])
