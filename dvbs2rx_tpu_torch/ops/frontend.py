"""Waveform front end: the block rotator and the Gardner symbol sync.

``rotate_block`` on a CUDA tensor is one launch of the front-end kernel of
``csrc/frontend.cu`` (``ops/frontend_cuda.py``, AGC off, no buffer); on a
CPU tensor its plain version (``frontend_cuda.rotate_plain``).

Port of ``dvbs2rx_tpu/ops/frontend.py`` (reference ``lib/rotator_cc_impl.cc``
and ``lib/symbol_sync_cc_impl.cc``):

- ``rotate_block``: the complex NCO, per block with the phase carried;
- ``SymbolSync``: Gardner TED + PI loop + modulo-1 decrementing counter
  (Rice Ch. 8) with four interpolators: the polyphase RRC bank (default;
  it fuses the matched filter, decimation and fractional interpolation
  into one dot product per strobe), linear, and the quadratic and cubic
  Farrow structures.

The JAX loop is a per-symbol ``lax.scan``, written per channel and vmapped.
Here the channel axis is a leading batch axis, and a block's recurrence is
one launch of the CUDA kernel ``csrc/gardner.cu`` on the card; its wrapper
and its plain version (``symbol_sync_plain``, which CPU tensors run) are in
``ops/gardner_cuda.py``, with the numeric contract both keep.

All IQ is planar float32 (..., 2) (``ops/cplx.py``).
"""

import numpy as np
import torch

from ..spec.rrc import polyphase_rrc_bank
from ..utils.runtime import resolve_device
from .frontend_cuda import frontend, rotate_plain
from .gardner_cuda import INTERP_METHODS, SymbolSyncState, symbol_sync


def rotate_block(iq, phase0, phase_inc):
    """Frequency-shift blocks: iq * exp(j*(phase0 + phase_inc*n)).

    iq: (..., n, 2) float32; phase0, phase_inc: (...) float32, one per
    block (the JAX function is vmapped over channels; here the channel axis
    is a leading batch axis). Returns (rotated, next_phase) with the phase
    wrapped into [0, 2*pi). The phase is phase0 + phase_inc*n with one
    rounding (an FMA, as XLA contracts the JAX form on the CPU).
    """
    if not iq.is_cuda:
        return rotate_plain(iq, phase0, phase_inc)
    lead = iq.shape[:-2]
    n_len = iq.shape[-2]
    # AGC off: the gain argument is not read (phase0 stands in for it)
    fe = frontend(iq.reshape(-1, n_len, 2), phase0.reshape(-1),
                  phase0.reshape(-1), phase_inc.reshape(-1))
    return fe["out"].reshape(iq.shape), fe["phase"].reshape(lead)


def gted_gain(rolloff: float) -> float:
    """Gardner TED gain from the S-curve slope at the origin (reference
    ``symbol_sync_cc_impl.cc:156-171``, Rice Eq. 8.47 with K=1, Eavg=1)."""
    L = 1e3
    C = np.sin(np.pi * rolloff / 2) / (4 * np.pi * (1 - (rolloff * rolloff / 4)))
    delta_x = 2.0 / L
    delta_y = 8 * C * np.sin(2 * np.pi / L)
    return delta_y / delta_x


def pi_constants(sps: float, loop_bw: float, damping: float, rolloff: float):
    """PI loop constants K1, K2 (reference ``symbol_sync_cc_impl.cc:173-199``,
    Rice Eqs. C.56/C.60). loop_bw is Bn*Ts (normalized to the symbol rate)."""
    Kp = gted_gain(rolloff)
    Bn_T = loop_bw / sps
    theta_n = Bn_T / (damping + (1.0 / (4 * damping)))
    denom = 1 + 2 * damping * theta_n + theta_n * theta_n
    Kp_K0_K1 = (4 * damping * theta_n) / denom
    Kp_K0_K2 = (4 * theta_n * theta_n) / denom
    K0 = -1.0  # decrementing counter
    return Kp_K0_K1 / (Kp * K0), Kp_K0_K2 / (Kp * K0)


class SymbolSync:
    """Gardner symbol synchronizer (channel-batched).

    ``step(state, samples, n_out)`` consumes ~``n_out * sps`` samples per
    channel and emits exactly ``n_out`` symbols; ``samples`` is (C, n, 2)
    float32 planar IQ. The caller keeps a sample buffer per channel: feed a
    window with ``history()`` old samples at the front, then drop the
    consumed samples after each call. On a CUDA tensor the step is one
    launch of the Gardner kernel; on a CPU tensor it is the plain loop.
    """

    INTERP_METHODS = INTERP_METHODS

    def __init__(self, sps=2, loop_bw=0.01, damping=1.0, rolloff=0.2,
                 rrc_delay=5, n_subfilt=128, interp_method="polyphase",
                 device=None):
        if sps < 2 or int(sps) != sps or int(sps) % 2 != 0:
            raise ValueError("sps must be an even integer >= 2")
        if interp_method not in INTERP_METHODS:
            raise ValueError(f"Unknown interpolation method {interp_method!r}")
        self.device = resolve_device(device)
        self.sps = int(sps)
        self.midpoint = self.sps // 2
        self.interp_method = interp_method
        self.interp = INTERP_METHODS.index(interp_method)
        bank, self.subfilt_len, self.subfilt_delay = polyphase_rrc_bank(
            sps, rolloff, rrc_delay, n_subfilt
        )
        self.n_subfilt = n_subfilt
        self._bank = bank          # (n_subfilt, L) reversed taps, numpy
        K1, K2 = pi_constants(sps, loop_bw, damping, rolloff)
        # float32 once, as the JAX body's Python floats become under jit
        self.K1, self.K2 = float(np.float32(K1)), float(np.float32(K2))
        self.nominal = float(np.float32(1.0 / self.sps))
        self.mu_max = float(np.float32(1.0 - 1e-6))
        if interp_method == "polyphase":
            self._history = self.subfilt_len - 2 + self.midpoint
        elif interp_method == "linear":
            self._history = 1 + self.midpoint
        else:
            self._history = 2 + self.midpoint

    def history(self) -> int:
        return self._history

    def init_state(self, n_channels: int) -> SymbolSyncState:
        dev, f, i = self.device, torch.float32, torch.int32
        C = n_channels
        return SymbolSyncState(
            cnt=torch.full((C,), float(np.float32(1.0 - 1.0 / self.sps)),
                           dtype=f, device=dev),
            mu=torch.zeros((C,), dtype=f, device=dev),
            vi=torch.zeros((C,), dtype=f, device=dev),
            jump=torch.full((C,), self.sps, dtype=i, device=dev),
            last_xi=torch.zeros((C, 2), dtype=f, device=dev),
            n=torch.full((C,), self._history + 1, dtype=i, device=dev),
        )

    def step(self, state: SymbolSyncState, samples, n_out: int):
        """Process sample windows (C, n, 2); returns (state', symbols (C,
        n_out, 2))."""
        return symbol_sync(self, state, samples.to(torch.float32), n_out)
