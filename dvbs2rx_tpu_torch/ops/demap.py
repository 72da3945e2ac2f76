"""Soft constellation demapping + deinterleaving (batched, planar IQ).

Port of ``dvbs2rx_tpu/ops/demap.py`` (reference
``lib/xfecframe_demapper_cb_impl.cc``): XFECFRAME symbols -> int8 LLRs in
codeword order, plus the data-aided SNR estimators that set the LLR scale.
LLR sign convention: positive = bit 0. Symbols are float32 (..., n, 2).
The JAX one-hot matmul selects (TPU gather workarounds) are indexing here.
"""

import functools

import numpy as np
import torch

from ..spec.constellations import (
    BITS_PER_SYMBOL,
    SIN_PI_8,
    SQRT2_2,
    constellation_points,
)
from ..spec.interleaver import column_order

from ..utils.runtime import device_table
from . import cplx


_ROT_8PSK = cplx.from_np(
    np.exp(-1j * np.pi / 8).astype(np.complex64).reshape(1))[0]


def _quantize(vals):
    # torch.round rounds half to even, like jnp.round
    return torch.round(vals).clamp(-128, 127).to(torch.int8)


@functools.lru_cache(maxsize=32)
def _points(constellation, rate):
    return cplx.from_np(constellation_points(constellation, rate))


def _pts(constellation, rate, like):
    return device_table(_points(constellation, rate), like.device)


def estimate_snr_qpsk(syms):
    """Data-aided linear SNR from sliced QPSK symbols. syms: (..., n, 2)."""
    s = float(np.float32(SQRT2_2))
    ref = torch.sign(syms) * s
    sp = (ref * ref).sum(-1).sum(-1)
    np_ = ((syms - ref) ** 2).sum(-1).sum(-1)
    return sp / np_.clamp(min=1e-12)


def estimate_snr_generic(syms, constellation, rate):
    """Data-aided linear SNR against the nearest constellation point (ties
    share the point energies equally, as the JAX one-hot average does)."""
    pts = _pts(constellation, rate, syms)
    d2 = ((syms[..., None, :] - pts) ** 2).sum(-1)         # (..., n, P)
    dmin = d2.min(dim=-1).values
    np_ = dmin.sum(-1)
    e = (pts * pts).sum(-1)                                 # (P,)
    oh = (d2 == dmin[..., None]).to(torch.float32)
    oh = oh / oh.sum(-1, keepdim=True).clamp(min=1.0)
    sp = (oh * e).sum(-1).sum(-1)
    return sp / np_.clamp(min=1e-12)


def demap_qpsk(syms, n0, quantize=True):
    """(..., n, 2) -> (..., 2n) LLRs; scale 2*sqrt(2)/N0."""
    scale = (2.0 * np.sqrt(2.0) / n0)[..., None, None]
    flat = (syms * scale).flatten(-2)
    return _quantize(flat) if quantize else flat


def demap_8psk(syms, n0, quantize=True):
    """8PSK soft demap with the reference's rotated-axes formulation."""
    precision = (4.0 / n0)[..., None]
    dist = float(np.float32(2.0 * SIN_PI_8))
    c = cplx.cmul(syms, device_table(_ROT_8PSK, syms.device))
    cr, ci = c[..., 0], c[..., 1]
    b0 = float(np.float32(SQRT2_2)) * (cr.abs() - ci.abs())
    vals = torch.stack([b0, cr, ci], dim=-1) * (dist * precision)[..., None]
    flat = vals.flatten(-2)
    return _quantize(flat) if quantize else flat


def demap_maxlog(syms, n0, constellation, rate, quantize=True):
    """Max-log-MAP LLRs for APSK constellations."""
    n_mod = BITS_PER_SYMBOL[constellation]
    pts = _pts(constellation, rate, syms)
    d2 = ((syms[..., None, :] - pts) ** 2).sum(-1)         # (..., n, P)
    idx = torch.arange(pts.shape[0], device=syms.device)
    llrs = []
    for b in range(n_mod):
        bit = (idx >> (n_mod - 1 - b)) & 1
        m0 = torch.where(bit == 0, d2, float("inf")).min(-1).values
        m1 = torch.where(bit == 1, d2, float("inf")).min(-1).values
        llrs.append((m1 - m0) / n0[..., None])
    flat = torch.stack(llrs, dim=-1).flatten(-2)
    return _quantize(flat) if quantize else flat


def deinterleave_llrs(llrs, constellation, rate):
    """Symbol-ordered LLRs -> codeword-ordered LLRs (batched)."""
    order = column_order(constellation, rate)
    if order is None:
        return llrs
    n_mod = len(order)
    rows = llrs.shape[-1] // n_mod
    per_sym = llrs.reshape(llrs.shape[:-1] + (rows, n_mod))
    cols = [per_sym[..., :, int(np.where(np.asarray(order) == c)[0][0])]
            for c in range(n_mod)]
    return torch.cat(cols, dim=-1)


def demap(syms, n0, constellation, rate, quantize=True):
    """Full demapper: planar symbols -> codeword-ordered LLRs
    (``quantize=False`` returns the float values before ``quantize_llrs``)."""
    if constellation == "QPSK":
        llrs = demap_qpsk(syms, n0, quantize)
    elif constellation == "8PSK":
        llrs = demap_8psk(syms, n0, quantize)
    else:
        llrs = demap_maxlog(syms, n0, constellation, rate, quantize)
    return deinterleave_llrs(llrs, constellation, rate)


def quantize_llrs(vals):
    """Float LLR values -> int8 (round half to even, clip to int8)."""
    return _quantize(vals)
