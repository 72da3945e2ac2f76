"""Planar complex arithmetic on float32 (..., 2) tensors.

Port of ``dvbs2rx_tpu/ops/cplx.py``. The port keeps the JAX package's
planar (re, im) layout at every module boundary, so the tests compare like
with like and the host boundary stays a free complex64 <-> float32 view.
"""

import numpy as np
import torch


def from_np(x: np.ndarray):
    """numpy complex -> float32 (..., 2) numpy view (host-side, zero copy)."""
    x = np.ascontiguousarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(x.shape + (2,))


def to_np(x) -> np.ndarray:
    """float32 (..., 2) (tensor or array) -> numpy complex64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    return x.view(np.complex64)[..., 0]


def window_rows(x, start, length):
    """x (C, N, 2) float32 -> (C, *start.shape[1:], length, 2): rows
    start .. start+length-1 of each channel (``start`` (C,) or (C, k)),
    each start clamped into [0, N - length] like ``jax.lax.dynamic_slice``.
    One gather over (re, im) pairs viewed as int64."""
    C, N = x.shape[0], x.shape[1]
    s = start.to(torch.int64).clamp(0, N - length)
    idx = s[..., None] + torch.arange(length, device=x.device)
    pairs = x.contiguous().view(torch.int64)[..., 0]           # (C, N)
    out = torch.gather(pairs, 1, idx.reshape(C, -1))
    return out.view(torch.float32).reshape(idx.shape + (2,))


def re(x):
    return x[..., 0]


def im(x):
    return x[..., 1]


def make(re_part, im_part):
    return torch.stack([re_part, im_part], dim=-1)


def cmul(a, b):
    """a * b"""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def conj_mul(a, b):
    """conj(a) * b"""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br + ai * bi, ar * bi - ai * br], dim=-1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def cadd(a, b):
    return a + b


def scale(a, s):
    """a * s with real s (broadcast over the pair axis)."""
    return a * s[..., None]


def abs2(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]


def cabs(a):
    return torch.sqrt(abs2(a))


def cexp(ph):
    """exp(j*ph) for real ph -> (..., 2)."""
    return torch.stack([torch.cos(ph), torch.sin(ph)], dim=-1)


def rotate(a, ph):
    """a * exp(j*ph)"""
    return cmul(a, cexp(ph))


def angle(a):
    return torch.atan2(a[..., 1], a[..., 0])


def csum(a, axis):
    """Sum over a data axis (negative axes count before the pair axis)."""
    if axis < 0:
        axis = axis - 1
    return torch.sum(a, dim=axis)


def dot_real(a, b, axis=-1):
    """real(<a, b>) = sum(re*re + im*im) over the given data axis."""
    if axis < 0:
        axis = axis - 1
    return torch.sum(a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1], dim=axis)


def mod(x, m):
    """Floored modulo with ``jnp.mod``'s float arithmetic (fmod, then a
    sign fix), so wrapped phases and timing positions match the JAX
    package's bit for bit rather than ``torch.remainder``'s
    ``x - floor(x/m)*m``."""
    r = torch.fmod(x, m)
    fix = (r != 0) & ((r < 0) != (m < 0))
    return torch.where(fix, r + m, r)
