"""The shared front end (block AGC, rotator, sample-buffer append) through
CUDA kernels.

The JAX stream step's ``frontend`` (``dvbs2rx_tpu/rx/stream.py:179-221``)
and ``rotate_block`` (``dvbs2rx_tpu/ops/frontend.py:32``) are one XLA
fusion chain, with no Pallas kernel. ``frontend_plain`` is their plain
PyTorch version (CPU tensors run it): AGC on the block's mean magnitude,
the rotator (``rotate_plain``), and with a carried right-aligned buffer
the shift by the block and the append. ``frontend`` launches
``csrc/frontend.cu`` for CUDA tensors: the AGC partial-sum kernel (AGC
"update" only) and the rotate-and-append kernel, which writes the new
buffer out of place in one pass; its source note says how and what bounds
it.

Modes (``agc``): "off" (the block rotated as it comes; the gain passes
through), "update" (the stream step's AGC: gain' = (1 - alpha) gain +
alpha agc_ref / mean|x|, applied), "given" (the gain applied, not updated:
re-acquisition). Without ``sbuf`` the output is the rotated block
(priming, re-acquisition, the host receivers' blocks).

The rotator's phase is ``fma(inc, n, phase0)``, one rounding, as XLA on
the CPU contracts the JAX form (the plain version forms it in float64,
exact for float32 operands and n < 2^24).

The AGC kernel's partial sums go to a scratch kept per device and shape
(``agc_scratch``), made at a shape's first call, which must come before
any CUDA graph capture; launches on one stream use it in turn. The wrapper
reads nothing back and copies nothing from the host, so a graph can hold
it.
"""

import math

import numpy as np
import torch

from .. import _build
from ..utils.runtime import device_table
from .cplx import mod

LAUNCHES = 0        # rotate-and-append kernel launches (one a call)
AGC_LAUNCHES = 0    # AGC partial-sum kernel launches (AGC "update" calls)
LAUNCH_SHAPES = {}  # the calls by (C, n_in, N or None, AGC mode)
AGC_MODES = ("off", "update", "given")
CHUNK = 4096        # kAgcChunk of csrc/frontend.cu: samples a partial sum
TILE_ROWS = 2048    # kRotRows: output rows a block of the rotate kernel
TWO_PI = float(np.float32(2 * math.pi))
_SCRATCH = {}
_SIGN = np.asarray([-1.0, 1.0], np.float32)


def _reset_counts():
    global LAUNCHES, AGC_LAUNCHES
    LAUNCHES = AGC_LAUNCHES = 0
    LAUNCH_SHAPES.clear()


_build.register_counter("frontend_rotate", lambda: LAUNCHES, _reset_counts)
_build.register_counter("frontend_agc", lambda: AGC_LAUNCHES,
                        _reset_counts)


def n_chunks(n_in):
    """The AGC kernel's partial sums a channel."""
    return -(-n_in // CHUNK)


def agc_scratch(C, n_in, dev):
    """The AGC partial sums' scratch, (C, n_chunks) float64 on ``dev``:
    made at the first call (which must come before any CUDA graph capture
    that holds a launch at this shape), then kept."""
    key = (str(dev), C * n_chunks(n_in))
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("front end: the first AGC call at a shape "
                               "must come before a graph capture")
        buf = _SCRATCH[key] = torch.empty(key[1], dtype=torch.float64,
                                          device=dev)
    return buf


def rotate_plain(iq, phase0, phase_inc):
    """iq (..., n, 2) float32 times exp(j (phase0 + phase_inc n)), the
    phase (...) float32 formed as one FMA (in float64, rounded once);
    returns (rotated, next phase wrapped into [0, 2 pi))."""
    n_len = iq.shape[-2]
    n = torch.arange(n_len, dtype=torch.float64, device=iq.device)
    p0, inc = phase0.to(torch.float64), phase_inc.to(torch.float64)
    ph = (p0[..., None] + inc[..., None] * n).to(torch.float32)
    c, sn = torch.cos(ph)[..., None], torch.sin(ph)[..., None]
    sign = device_table(_SIGN, iq.device)
    # re = x0*c - x1*s, im = x1*c + x0*s (the JAX form, same rounding)
    out = iq * c + iq.flip(-1) * sn * sign
    next_phase = mod((p0 + inc * float(n_len)).to(torch.float32), TWO_PI)
    return out, next_phase


def frontend_plain(iq, gain, phase0, inc, agc="off", alpha=1.0,
                   agc_ref=1.0, sbuf=None, sfill=None):
    """Plain version of ``frontend`` (same arguments and result)."""
    if agc not in AGC_MODES:
        raise ValueError(f"AGC mode {agc!r}: one of {AGC_MODES}")
    if agc == "update":
        mag = torch.sqrt(iq[..., 0] ** 2 + iq[..., 1] ** 2).mean(-1)
        target = agc_ref / mag.clamp(min=1e-12)
        gain = (1.0 - alpha) * gain + alpha * target
    if agc != "off":
        iq = iq * gain[:, None, None]
    rot, phase = rotate_plain(iq, phase0, inc)
    out = {"out": rot, "gain": gain, "phase": phase}
    if sbuf is not None:
        n_in, N = iq.shape[1], sbuf.shape[1]
        new_fill = (sfill + n_in).clamp(max=N)
        out.update(out=torch.cat([sbuf[:, n_in:], rot], dim=1),
                   overflow=sfill > N - n_in, sfill=new_fill,
                   start=N - new_fill)
    return out


def _check(iq, gain, phase0, inc, agc, sbuf, sfill):
    if agc not in AGC_MODES:
        raise ValueError(f"AGC mode {agc!r}: one of {AGC_MODES}")
    if iq.dim() != 3 or iq.shape[2] != 2 or iq.dtype != torch.float32:
        raise ValueError(f"iq {tuple(iq.shape)} {iq.dtype}: (C, n, 2) "
                         f"float32 expected")
    C, n_in = iq.shape[0], iq.shape[1]
    for name, x in (("gain", gain), ("phase0", phase0), ("inc", inc)):
        if tuple(x.shape) != (C,) or x.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype}: (C,) "
                             f"float32 expected")
    if (sbuf is None) != (sfill is None):
        raise ValueError("pass sbuf and sfill together")
    if sbuf is not None:
        if sbuf.dim() != 3 or sbuf.shape[0] != C or sbuf.shape[2] != 2 \
                or sbuf.dtype != torch.float32 or sbuf.shape[1] < n_in:
            raise ValueError(f"sbuf {tuple(sbuf.shape)} {sbuf.dtype}: (C, "
                             f"N >= {n_in}, 2) float32 expected")
        if tuple(sfill.shape) != (C,) or sfill.dtype != torch.int32:
            raise ValueError(f"sfill {tuple(sfill.shape)} {sfill.dtype}: "
                             f"(C,) int32 expected")


def frontend(iq, gain, phase0, inc, agc="off", alpha=1.0, agc_ref=1.0,
             sbuf=None, sfill=None):
    """One front-end block for C channels: iq (C, n_in, 2) float32, gain,
    phase0 and inc (C,) float32 (the AGC gain, the rotator's phase at the
    block's first sample and its per-sample increment), the AGC mode and
    its constants; with ``sbuf`` (C, N, 2) and ``sfill`` (C,) int32 the
    right-aligned sample buffer the block is appended to. Returns a dict:
    "out" (the new buffer (C, N, 2), or the rotated block (C, n_in, 2)),
    "gain" (C,), "phase" (C,) the next block's phase wrapped into [0, 2
    pi); with a buffer also "sfill" min(sfill + n_in, N), "start" N -
    sfill' (the oldest valid row) and "overflow" sfill > N - n_in."""
    _check(iq, gain, phase0, inc, agc, sbuf, sfill)
    if not iq.is_cuda:
        return frontend_plain(iq, gain, phase0, inc, agc, alpha, agc_ref,
                              sbuf, sfill)
    ins = [iq, gain, phase0, inc] + ([] if sbuf is None else [sbuf, sfill])
    if any(x.device != iq.device for x in ins):
        raise ValueError("the front end's tensors must share one device")
    return _launch(iq, gain, phase0, inc, agc, alpha, agc_ref, sbuf, sfill)


def _launch(iq, gain, phase0, inc, agc, alpha, agc_ref, sbuf, sfill):
    """``frontend``'s launch on checked arguments."""
    global LAUNCHES, AGC_LAUNCHES
    dev = iq.device
    iq = iq.contiguous()
    gain, phase0, inc = (x.contiguous() for x in (gain, phase0, inc))
    C, n_in = iq.shape[0], iq.shape[1]
    mode = AGC_MODES.index(agc)
    N = n_in if sbuf is None else sbuf.shape[1]
    if sbuf is not None:
        sbuf, sfill = sbuf.contiguous(), sfill.contiguous()
    out = torch.empty((C, N, 2), dtype=torch.float32, device=dev)
    f32 = torch.empty((2, C), dtype=torch.float32, device=dev)
    part = agc_scratch(C, n_in, dev) if mode == 1 else None
    res = {"out": out, "gain": f32[0] if mode == 1 else gain,
           "phase": f32[1]}
    ptr = {}
    if sbuf is not None:
        i32 = torch.empty((2, C), dtype=torch.int32, device=dev)
        flag = torch.empty((C,), dtype=torch.bool, device=dev)
        res.update(sfill=i32[0], start=i32[1], overflow=flag)
        ptr = {"old": sbuf.data_ptr(), "sfill_in": sfill.data_ptr(),
               "sfill_out": i32[0].data_ptr(), "start": i32[1].data_ptr(),
               "overflow": flag.data_ptr()}
    err = _build.lib().frontend_launch(
        iq.data_ptr(), ptr.get("old"), out.data_ptr(),
        None if part is None else part.data_ptr(), gain.data_ptr(),
        f32[0].data_ptr() if mode == 1 else None, phase0.data_ptr(),
        inc.data_ptr(), f32[1].data_ptr(), ptr.get("sfill_in"),
        ptr.get("sfill_out"), ptr.get("start"), ptr.get("overflow"), C,
        n_in, N, mode, 1.0 - alpha, alpha, agc_ref, TWO_PI,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "frontend kernels")
    LAUNCHES += 1
    AGC_LAUNCHES += mode == 1
    key = (C, n_in, None if sbuf is None else N, agc)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    return res
