"""Waveform front end: the block rotator.

Port of ``rotate_block`` from ``dvbs2rx_tpu/ops/frontend.py`` (reference
``lib/rotator_cc_impl.cc``). The Gardner ``SymbolSync`` of that module
comes later; the stream receiver's timing recovery is ``ops/ffsync.py``.
"""

import math

import numpy as np
import torch

from ..utils.runtime import device_table
from .cplx import mod

_SIGN = np.asarray([-1.0, 1.0], np.float32)


def rotate_block(iq, phase0, phase_inc):
    """Frequency-shift blocks: iq * exp(j*(phase0 + phase_inc*n)).

    iq: (..., n, 2) float32; phase0, phase_inc: (...) float32, one per
    block (the JAX function is vmapped over channels; here the channel axis
    is a leading batch axis). Returns (rotated, next_phase) with the phase
    wrapped into [0, 2*pi).
    """
    n_len = iq.shape[-2]
    n = torch.arange(n_len, dtype=torch.float32, device=iq.device)
    ph = phase0[..., None] + phase_inc[..., None] * n
    c, sn = torch.cos(ph)[..., None], torch.sin(ph)[..., None]
    sign = device_table(_SIGN, iq.device)
    # re = x0*c - x1*s, im = x1*c + x0*s (the JAX form, same rounding)
    out = iq * c + iq.flip(-1) * sn * sign
    next_phase = mod(phase0 + phase_inc * float(n_len), 2 * math.pi)
    return out, next_phase
