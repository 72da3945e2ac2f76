"""Arbitrary-rate polyphase resampling (fractional samples per symbol).

Port of ``dvbs2rx_tpu/ops/resample.py`` (reference fractional-ratio
support: ``apps/dvbs2-tx:638-686`` Tx PFB arbitrary resampler,
``apps/dvbs2-rx:887-916`` any-sps receive path). Both resamplers evaluate
the continuous interpolation kernel exactly at every distinct phase of a
rational ratio P/Q, so the taps are a finite table computed once.

- The kernel designers (``rrc_continuous``, ``sinc_kernel``, ``rrc_kernel``,
  ``lowpass_kernel``), ``_rationalize``, ``_phase_taps`` and the host numpy
  ``StreamResampler`` (Tx pulse shaping at fractional sps) are copies of
  the JAX module's numpy code.
- ``DeviceResampler`` converts fixed blocks to ``ratio`` times the input
  rate on the device, in front of the receiver's 2-sps front end: its
  window starts and taps are device tables, and a block is one gather and
  one elementwise multiply-sum in float32 (the JAX module computes it
  outside Pallas with ``jnp.take`` and ``einsum``; a float32 sum of
  products needs no matmul here, so no TF32 switch is involved).
"""

from fractions import Fraction

import numpy as np
import torch

from ..utils.runtime import resolve_device


# ---------------------------------------------------------------------------
# Continuous interpolation kernels
# ---------------------------------------------------------------------------

def rrc_continuous(t, rolloff):
    """Root-raised-cosine impulse response h(t), t in symbol periods.

    Standard unit-integral normalization (h(0) = 1 + beta(4/pi - 1)); the
    sampled-at-sps taps then sum to ~sps, matching the GNU Radio
    ``firdes.root_raised_cosine(gain=sps, ...)`` convention used by the
    integer-sps Tx path (``spec/rrc.py``).
    """
    b = float(rolloff)
    t = np.asarray(t, dtype=np.float64)
    out = np.empty_like(t)
    # singularities: t == 0 and |t| == 1/(4b)
    tiny = 1e-6
    at_zero = np.abs(t) < tiny
    at_sing = np.abs(np.abs(t) - 1.0 / (4 * b)) < tiny if b > 0 else np.zeros_like(at_zero)
    safe = ~(at_zero | at_sing)
    ts = np.where(safe, t, 0.1234567)  # non-singular dummy (avoids 0 and 1/4b)
    num = np.sin(np.pi * ts * (1 - b)) + 4 * b * ts * np.cos(np.pi * ts * (1 + b))
    den = np.pi * ts * (1 - (4 * b * ts) ** 2)
    out = np.where(safe, num / den, 0.0)
    out = np.where(at_zero, 1.0 + b * (4 / np.pi - 1.0), out)
    if b > 0:
        lim = (b / np.sqrt(2)) * (
            (1 + 2 / np.pi) * np.sin(np.pi / (4 * b))
            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * b))
        )
        out = np.where(at_sing, lim, out)
    return out


def _kaiser_continuous(t, half_width, beta):
    """Kaiser window evaluated at continuous positions (0 outside)."""
    x = np.asarray(t, dtype=np.float64) / float(half_width)
    inside = np.abs(x) <= 1.0
    xs = np.where(inside, x, 1.0)
    w = np.i0(beta * np.sqrt(np.maximum(1.0 - xs * xs, 0.0))) / np.i0(beta)
    return np.where(inside, w, 0.0)


def sinc_kernel(t, cutoff, half_width, beta=8.0):
    """Windowed-sinc lowpass interpolation kernel, t in input samples.

    ``cutoff`` in cycles/input-sample (0.5 = input Nyquist). Unit DC gain
    (amplitude-preserving for band-limited signals).
    """
    t = np.asarray(t, dtype=np.float64)
    return (
        2 * cutoff * np.sinc(2 * cutoff * t) * _kaiser_continuous(t, half_width, beta)
    )


def rrc_kernel(rolloff, delay):
    """Tx pulse-shaping kernel: windowed RRC, t in input *symbols*."""

    def k(t):
        return rrc_continuous(t, rolloff) * _kaiser_continuous(t, delay + 1, 4.0)

    return k


def lowpass_kernel(ratio, delay, beta=8.0):
    """Generic resampling kernel for out/in ratio ``ratio`` (anti-aliased
    when downsampling), t in input samples."""
    cutoff = 0.5 * min(1.0, float(ratio))

    def k(t):
        return sinc_kernel(t, cutoff, delay, beta)

    return k


# ---------------------------------------------------------------------------
# Rational phase lattice
# ---------------------------------------------------------------------------

def _rationalize(ratio, max_denominator):
    frac = Fraction(ratio).limit_denominator(max_denominator)
    if frac.numerator <= 0:
        raise ValueError(f"invalid resampling ratio {ratio}")
    return frac.numerator, frac.denominator


def _phase_taps(kernel, P, Q, delay):
    """Tap table for the P distinct phases of an out/in = P/Q resampler.

    Output k sits at input position t_k = kQ/P; its window covers input
    samples s_k .. s_k+L-1 with s_k = floor(t_k) - delay + 1, L = 2*delay.
    taps[p, l] = kernel(t - (s + l)) = kernel(delay - 1 + f_p - l) where
    f_p = p/P is the fractional part.
    """
    L = 2 * int(delay)
    f = np.arange(P, dtype=np.float64) / P                 # distinct fracs
    l = np.arange(L, dtype=np.float64)
    offs = (delay - 1.0) + f[:, None] - l[None, :]          # (P, L)
    return kernel(offs).astype(np.float32)


# ---------------------------------------------------------------------------
# Host streaming resampler (numpy)
# ---------------------------------------------------------------------------

class StreamResampler:
    """Streaming arbitrary-ratio resampler (vectorized numpy).

    ``ratio`` = output rate / input rate. ``kernel`` maps continuous offsets
    (input-sample units) to tap values; ``delay`` is the kernel half-width in
    input samples (window length 2*delay). The concatenation of all chunk
    outputs plus ``flush()`` equals the one-shot resampling of the
    concatenated input.
    """

    def __init__(self, ratio, kernel=None, delay=8,
                 max_denominator=1 << 14):
        self.P, self.Q = _rationalize(ratio, max_denominator)
        self.ratio = self.P / self.Q
        self.delay = int(delay)
        self.L = 2 * self.delay
        if kernel is None:
            kernel = lowpass_kernel(self.ratio, self.delay)
        if self.P <= (1 << 13):
            self._tab = _phase_taps(kernel, self.P, self.Q, self.delay)
            self._kernel = None
        else:  # pathological denominators: evaluate per chunk
            self._tab = None
            self._kernel = kernel
        self.reset()

    def reset(self):
        self._buf = np.empty(0, np.complex64)
        self._in_base = 0   # absolute input index of _buf[0]
        self._k_next = 0    # absolute index of the next output sample

    def _emit(self):
        """Emit every output whose window fits in the current buffer."""
        P, Q, D, L = self.P, self.Q, self.delay, self.L
        # need floor(kQ/P) + D <= in_base + len(buf) - 1
        B = self._in_base + self._buf.size - 1 - D
        if B < 0:
            return np.empty(0, np.complex64)
        k_max = (B * P + P - 1) // Q          # largest k with floor(kQ/P) <= B
        n_out = k_max - self._k_next + 1
        if n_out <= 0:
            return np.empty(0, np.complex64)
        k = self._k_next + np.arange(n_out, dtype=np.int64)
        kq = k * Q
        s = kq // P - self._in_base - D + 1   # window starts, buffer-relative
        if s[0] < 0:  # only possible at stream start: clamp via zero-pad
            pad = int(-s[0])
            self._buf = np.concatenate(
                [np.zeros(pad, np.complex64), self._buf]
            )
            self._in_base -= pad
            s = s + pad
        wins = self._buf[s[:, None] + np.arange(L)[None, :]]   # (n_out, L)
        if self._tab is not None:
            taps = self._tab[np.asarray(kq % P, dtype=np.int64)]
        else:
            f = (kq % P).astype(np.float64) / P
            offs = (D - 1.0) + f[:, None] - np.arange(L)[None, :]
            taps = self._kernel(offs).astype(np.float32)
        out = np.einsum("kl,kl->k", wins, taps).astype(np.complex64)
        self._k_next = k_max + 1
        # drop buffer samples no longer reachable by future windows
        next_s = (self._k_next * Q) // P - D + 1
        drop = max(0, min(next_s - self._in_base, self._buf.size))
        self._buf = self._buf[drop:]
        self._in_base += drop
        return out

    def __call__(self, chunk):
        chunk = np.asarray(chunk, np.complex64)
        self._buf = np.concatenate([self._buf, chunk])
        return self._emit()

    def flush(self):
        """Pad with zeros so the kernel tail drains; then reset."""
        out = self(np.zeros(self.L + self.Q // self.P + 2, np.complex64))
        self.reset()
        return out


# ---------------------------------------------------------------------------
# Device fixed-block resampler (PyTorch) for the Rx front end
# ---------------------------------------------------------------------------

class DeviceResampler:
    """Rational resampler with static block shapes, on the device.

    Converts complex64 IQ at an arbitrary rate to ``ratio`` times that rate
    (e.g. ``ratio = 2*sym_rate/samp_rate`` to feed the 2-sps front end).
    Host API of a streaming block: ``__call__(chunk) -> out`` buffers input
    and runs one device step per full block; ``flush()`` drains the tail
    (zero-padded).

    The rational approximation error (<= 1/max_denominator relative) is a
    tiny symbol-clock offset downstream, which the timing recovery absorbs.
    Runs on the card unless ``device="cpu"``.
    """

    def __init__(self, ratio, block_out=16384, delay=8,
                 max_denominator=4096, kernel=None, device=None):
        self.device = resolve_device(device)
        self.P, self.Q = _rationalize(ratio, max_denominator)
        self.ratio = self.P / self.Q
        self.delay = int(delay)
        L = self.L = 2 * self.delay
        m = max(1, int(round(block_out / self.P)))
        self.n_out = m * self.P
        self.n_in = m * self.Q
        if kernel is None:
            kernel = lowpass_kernel(self.ratio, self.delay)
        # Output k of block b sits at absolute input position
        # t = b*n_in + k*Q/P; its window covers absolute inputs
        # floor(t)-D+1 .. floor(t)+D. Block b's buffer is
        # x[b*n_in-(D-1) : (b+1)*n_in+D] (zeros before the stream start), so
        # the relative window starts are block-invariant (exactly aligned
        # with StreamResampler: no group delay, D samples of lookahead).
        kq = np.arange(self.n_out, dtype=np.int64) * self.Q
        starts = kq // self.P
        tab = _phase_taps(kernel, self.P, self.Q, self.delay)
        self._buf_len = self.n_in + L - 1
        self._idx = torch.as_tensor(starts[:, None] + np.arange(L),
                                    device=self.device)         # (n_out, L)
        self._taps = torch.as_tensor(tab[kq % self.P][..., None],
                                     device=self.device)     # (n_out, L, 1)
        self.reset()

    def reset(self):
        self._tail = np.zeros(self.delay - 1, np.complex64)  # pre-block history
        self._pend = np.empty(0, np.complex64)
        self._n_real = 0      # real (un-padded) input samples received
        self._k_emitted = 0   # outputs emitted so far

    @property
    def history(self):
        return self.L - 1

    def step(self, buf):
        """One block on the device: buf (buf_len, 2) float32 planar ->
        (n_out, 2): one gather of every output's window, then a float32
        multiply and a sum over the window."""
        return (buf[self._idx] * self._taps).sum(1)

    def _run_block(self, block):
        """block: complex64, length buf_len."""
        planar = np.stack([block.real, block.imag], axis=-1).astype(np.float32)
        out = self.step(torch.as_tensor(planar, device=self.device))
        out = out.cpu().numpy()
        return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)

    def _emit(self):
        D = self.delay
        outs = []
        # a block needs its n_in inputs plus D samples of lookahead
        while self._pend.size >= self.n_in + D:
            buf = np.concatenate(
                [self._tail, self._pend[: self.n_in + D]]
            )
            outs.append(self._run_block(buf))
            self._tail = self._pend[self.n_in - (D - 1): self.n_in]
            self._pend = self._pend[self.n_in:]
            self._k_emitted += self.n_out
        if not outs:
            return np.empty(0, np.complex64)
        return np.concatenate(outs)

    def __call__(self, chunk):
        chunk = np.asarray(chunk, np.complex64)
        self._n_real += chunk.size
        self._pend = np.concatenate([self._pend, chunk])
        return self._emit()

    def flush(self):
        """Drain buffered input (zero-padded to full blocks), trimming the
        output to the samples actually backed by real input, then reset."""
        n_total = -(-self._n_real * self.P // self.Q)  # ceil
        outs = []
        while self._k_emitted < n_total:
            # each zero-pad call completes at least one block
            outs.append(self(np.zeros(self.n_in + self.delay, np.complex64)))
        out = np.concatenate(outs) if outs else np.empty(0, np.complex64)
        keep = n_total - (self._k_emitted - out.size)
        self.reset()
        return out[:max(keep, 0)]
