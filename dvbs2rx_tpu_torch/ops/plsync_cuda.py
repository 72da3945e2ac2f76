"""PL sync and demap over frame lanes through CUDA kernels.

The JAX package runs a lane's PLFRAME processing (``make_lane_fn``,
``dvbs2rx_tpu/parallel/batch.py:51-101``; the VCM ``_lane_fn``,
``dvbs2rx_tpu/rx/vcm_stream.py:471-520``) as one vmapped closure that XLA
fuses, with no Pallas kernel; the port's plain versions here run it as
~110 small launches a step. ``csrc/plsync.cu`` does it in three kernels
(its source note says how, and what bounds them):

- ``plheader`` (``plsync_header_kernel``): per header, the
  modulation-removed data-aided phase of the 90 symbols and of the last
  36 (the pilot-mode tail), optionally the frame metric and the coarse-CFO
  autocorrelation of the first N = 90 or 26 symbols
  (``plsync.coarse_autocorr`` on a CUDA tensor launches it);
- ``payload``: per lane, in place from a symbol buffer at a per-lane start,
  the descrambling, pilot phases, fine CFO, derotation, data-aided SNR, N0,
  demap, quantization and deinterleave, writing int8 LLRs through the
  caller's (position, lane) strides, and the corrected symbols only of the
  lanes a caller reads; with a lane mask, only the selected lanes. Two
  launches split at the SNR: ``plsync_stats_kernel`` over (lane, one of
  ``STATS_CHUNKS`` chunks of its data symbols) writes partial sums to a
  scratch buffer (``payload_scratch``: one per device and lane count,
  kept), and ``plsync_demap_kernel`` over tiles of 32 lanes x
  ``tile_syms`` symbols reduces them and demaps (``launch_plan`` mirrors
  the launch geometry).

Each dispatches by device: CPU tensors take the plain version
(``plheader_plain``, ``payload_plain``, composed of ``ops.plsync`` and
``ops.demap``: the same contract), CUDA tensors launch the kernels or
raise. The wrappers read nothing back and copy nothing from the host
(constants come through ``utils.runtime.device_table``; the scratch is
made at a lane count's first call, which must come before any graph
capture), so a CUDA graph can hold them.
"""

import functools
import math

import numpy as np
import torch

from .. import _build
from ..spec.constellations import BITS_PER_SYMBOL, SIN_PI_8, SQRT2_2
from ..spec.interleaver import column_order
from ..spec.pl_defs import PILOT_BLK_PERIOD, PLHEADER_LEN, SOF_LEN
from ..utils.runtime import device_table
from . import cplx, plsync
from .demap import (
    _points,
    demap,
    estimate_snr_generic,
    estimate_snr_qpsk,
    quantize_llrs,
)

# kernel launches by kernel; incremented only where a kernel runs
LAUNCHES = {"plsync_header": 0, "plsync_stats": 0, "plsync_demap": 0}
# the calls by layout: (call, *the arguments' shapes, strides and options),
# as ``_header_layout`` and ``_payload_layout`` name them; a ``payload``
# call (its two launches) counts once under "plsync_payload"
LAUNCH_SHAPES = {}
_LAYOUT_OF = {"plsync_header": "plsync_header",
              "plsync_stats": "plsync_payload",
              "plsync_demap": "plsync_payload"}


def _reset_counts(kernel):
    LAUNCHES[kernel] = 0
    for key in [k for k in LAUNCH_SHAPES if k[0] == _LAYOUT_OF[kernel]]:
        del LAUNCH_SHAPES[key]


for _k in LAUNCHES:
    _build.register_counter(_k, functools.partial(LAUNCHES.get, _k),
                            functools.partial(_reset_counts, _k))


def _count_layout(key):
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


KINDS = {"QPSK": 0, "8PSK": 1, "16APSK": 2, "32APSK": 2}
N_POINTS = {"QPSK": 4, "8PSK": 8, "16APSK": 16, "32APSK": 32}


@functools.lru_cache(maxsize=1)
def header_taps() -> np.ndarray:
    """(178, 2) float32: the frame metric's SOF then PLSC taps
    (``plsync.frame_metric``'s, 89 each)."""
    ks, kp = plsync._frame_metric_taps()
    return np.ascontiguousarray(np.concatenate([ks, kp]), np.float32)


@functools.lru_cache(maxsize=None)
def payload_constants(plframe_len: int, n_pilots: int) -> np.ndarray:
    """The payload kernel's float constants (its enum Const): 2 pi, pi and
    pi/4 as float32 (torch's Python scalars), the QPSK slicer's sqrt(2)/2,
    the QPSK LLR numerator 2 sqrt 2, the 8PSK rotation exp(-j pi/8) and
    distance 2 sin(pi/8), and the fine CFO's reciprocal denominator (a
    tensor divided by a Python scalar is a product with its float32
    reciprocal on the card)."""
    if n_pilots:
        den = 2 * math.pi * PILOT_BLK_PERIOD * n_pilots
    else:
        den = 2 * math.pi * plframe_len
    rot = np.exp(-1j * np.pi / 8).astype(np.complex64)
    return np.array([2 * math.pi, math.pi, math.pi / 4, SQRT2_2,
                     2.0 * np.sqrt(2.0), rot.real, rot.imag, 2.0 * SIN_PI_8,
                     np.float32(1.0) / np.float32(den)], np.float32)


def _order_word(constellation, rate) -> int:
    """The deinterleave's column order as 4-bit fields (bit j of a symbol
    goes to column order[j]); -1 where the bits are not interleaved."""
    order = column_order(constellation, rate)
    if order is None:
        return -1
    return sum(c << (4 * j) for j, c in enumerate(order))


def _same_view(views, what):
    v0 = views[0]
    if v0.dtype != torch.float32 or v0.dim() != 4 or v0.shape[3] != 2:
        raise ValueError(f"{what} {tuple(v0.shape)} {v0.dtype}: the kernel "
                         f"takes (X, Y, n, 2) float32 views")
    for v in views[1:]:
        if v.shape != v0.shape or v.stride() != v0.stride() \
                or v.dtype != v0.dtype or v.device != v0.device:
            raise ValueError(f"{what}: the views must share shape, strides, "
                             f"type and device")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _lane_vec(x, B, dtype, what, dev):
    """A per-lane input as a contiguous (B,) tensor of ``dtype`` on
    ``dev`` (expanded views are made contiguous, on the card)."""
    if x.dtype != dtype or tuple(x.shape) != (B,) or x.device != dev:
        raise ValueError(f"{what} {tuple(x.shape)} {x.dtype} {x.device}: the "
                         f"kernel takes ({B},) {dtype} on {dev}")
    return x.contiguous()


# ---------------- PLHEADER ----------------

def plheader_plain(hdrs, pls, n_auto=0, metric=False):
    """Plain PyTorch version of ``plheader`` (the same contract)."""
    X, Y = hdrs[0].shape[:2]
    B = X * Y
    h = torch.stack([x.reshape(B, PLHEADER_LEN, 2) for x in hdrs], dim=1)
    p = torch.stack([q.expand(B) for q in pls], dim=1)
    phase = torch.stack([plsync.plheader_phase(h, p),
                         plsync.plheader_tail_phase(h, p)], dim=-1)
    out = {"phase": phase, "metric": None, "autocorr": None}
    if metric:
        out["metric"] = plsync.frame_metric(plsync.differentials(h))
    if n_auto:
        out["autocorr"] = plsync.coarse_autocorr_plain(
            h[:, 0], p[:, 0], full=n_auto == PLHEADER_LEN)
    return out


def _header_layout(hdrs, n_pls, n_auto, metric):
    """``plheader``'s launch layout: (kernel, X, Y, the headers' strides,
    J, PLS per header (B) or one (1), n_auto, metric)."""
    return ("plsync_header", *hdrs[0].shape[:2], *hdrs[0].stride(),
            len(hdrs), n_pls, n_auto, int(metric))


def plheader(hdrs, pls, n_auto=0, metric=False):
    """PLHEADER statistics of J = 1 or 2 header sets over B = X Y lanes.

    ``hdrs``: J tensors (X, Y, 90, 2) float32 (views; lane b = x Y + y)
    sharing shape, strides and device; ``pls``: J int64 tensors, each
    (B,) (a PLS per header) or (1,) (one for all). Returns a dict: phase
    (B, J, 2) float32, the data-aided phase of the 90 modulation-removed
    symbols and of the last 36; metric (B, J) the frame metric when
    ``metric``; autocorr (B, n_auto - 1, 2) the coarse-CFO autocorrelation
    of the first n_auto (90 or 26) symbols of the first set, when
    ``n_auto``."""
    J = len(hdrs)
    if J not in (1, 2) or len(pls) != J:
        raise ValueError("one or two header sets, one PLS tensor each")
    _same_view(hdrs, "headers")
    X, Y, n, _ = hdrs[0].shape
    B = X * Y
    if n != PLHEADER_LEN or B == 0:
        raise ValueError(f"headers {tuple(hdrs[0].shape)}: the kernel takes "
                         f"(X, Y, {PLHEADER_LEN}, 2), X Y > 0")
    if n_auto not in (0, SOF_LEN, PLHEADER_LEN):
        raise ValueError(f"n_auto {n_auto}: 0, {SOF_LEN} or {PLHEADER_LEN}")
    dev = hdrs[0].device
    n_pls = pls[0].shape[0]
    for q in pls:
        if q.dtype != torch.int64 or q.dim() != 1 \
                or q.shape[0] not in (1, B) or q.shape[0] != n_pls \
                or q.device != dev or not q.is_contiguous():
            raise ValueError(f"pls {tuple(q.shape)} {q.dtype}: the kernel "
                             f"takes contiguous (1,) or ({B},) int64 on {dev}")
    if not hdrs[0].is_cuda:
        return plheader_plain(hdrs, pls, n_auto, metric)
    return _launch_header(hdrs, pls, n_auto, metric)


def _launch_header(hdrs, pls, n_auto, metric):
    """``plheader``'s kernel launch on checked arguments."""
    X, Y = hdrs[0].shape[:2]
    B, J = X * Y, len(hdrs)
    dev, n_pls = hdrs[0].device, pls[0].shape[0]
    sx, sy, sn, sc = hdrs[0].stride()
    out = {
        "phase": torch.empty((B, J, 2), dtype=torch.float32, device=dev),
        "metric": (torch.empty((B, J), dtype=torch.float32, device=dev)
                   if metric else None),
        "autocorr": (torch.empty((B, n_auto - 1, 2), dtype=torch.float32,
                                 device=dev) if n_auto else None),
    }
    lut = device_table(plsync.plheader_conj_lut(), dev)
    taps = device_table(header_taps(), dev)
    err = _build.lib().plsync_header_launch(
        hdrs[0].data_ptr(), hdrs[-1].data_ptr(), pls[0].data_ptr(),
        pls[-1].data_ptr(), lut.data_ptr(), taps.data_ptr(),
        out["phase"].data_ptr(), _ptr(out["metric"]), _ptr(out["autocorr"]),
        B, J, Y, sx, sy, sn, sc, int(n_pls == B), n_auto,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "plsync_header_kernel")
    LAUNCHES["plsync_header"] += 1
    _count_layout(_header_layout(hdrs, n_pls, n_auto, metric))
    return out


def coarse_autocorr_cuda(plheader_t, plsc, full=True):
    """``plsync.coarse_autocorr`` on a CUDA tensor: one ``plheader``
    launch (autocorrelation only) over every header of the batch."""
    lead = plheader_t.shape[:-2]
    hv = plheader_t.reshape((1, -1) + plheader_t.shape[-2:])
    p = torch.broadcast_to(plsc, lead).reshape(-1).to(torch.int64)
    N = PLHEADER_LEN if full else SOF_LEN
    r = plheader([hv], [p.contiguous()], n_auto=N)["autocorr"]
    return r.reshape(lead + (N - 1, 2))


# ---------------- payload ----------------

# the payload kernels' launch geometry (csrc/plsync.cu's constants)
STATS_CHUNKS = 10           # statistics blocks a lane: at 5 resident an SM
                            # (660 on an H100's 132 SMs), the CCM step's
                            # 128 lanes and the VCM step's ~64 selected make
                            # ~2 and ~1 full waves, not a sliver of a last
MAX_CHUNKS = 16             # chunks a lane at most (the scratch's room)
LANE_FLOATS = 2 + 22        # scratch a lane: fine, 2 pi x gated fine,
                            # the pilot-block phases
TILE_LANES = 32             # a demap block's lanes


def tile_syms(n_mod):
    """A demap block's data symbols: 256, or 128 at 4-5 bits a symbol (its
    stage holds n_mod bytes a symbol and lane)."""
    return 256 if n_mod <= 3 else 128


def scratch_float64(B):
    """The scratch's float64 elements for B lanes: the (B, MAX_CHUNKS, 2)
    SNR sums, then LANE_FLOATS float32 a lane."""
    return B * (MAX_CHUNKS * 2 + LANE_FLOATS // 2)


def launch_plan(B, R, n_mod, order, l_pos, l_lane):
    """The payload's two launches for B lanes of R data symbols (n_mod
    bits each; ``order`` the column-order word, < 0 uninterleaved) into
    LLRs of strides (l_pos, l_lane), as ``csrc/plsync.cu`` runs them:
    grids, the scratch (float64 elements), the demap tile's stage rows
    and which stride its write-out runs along ("lane": one warp store is
    32 lanes' bytes of one position; "position": consecutive positions of
    one lane)."""
    chunk = -(-R // STATS_CHUNKS)
    chunks = -(-R // chunk)
    return {
        "chunk": chunk, "chunks": chunks,
        "stats_grid": (B, chunks),
        "demap_grid": (-(-B // TILE_LANES), -(-R // tile_syms(n_mod))),
        "tile_syms": tile_syms(n_mod),
        "scratch_float64": scratch_float64(B),
        "stage_rows": n_mod * tile_syms(n_mod),
        "runs": n_mod if order >= 0 else 1,
        "write_along": "lane" if l_lane == 1 and B > 1 else "position",
    }


_SCRATCH = {}       # (device, B) -> the payload kernels' scratch


def payload_scratch(B, dev):
    """The payload kernels' scratch for B lanes on ``dev``: made at the
    first call (which must come before any CUDA graph capture that holds a
    launch at this B), then kept; launches on one stream use it in turn."""
    key = (str(dev), B)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("plsync payload: the first call at a lane "
                               "count must come before a graph capture")
        buf = _SCRATCH[key] = torch.empty((scratch_float64(B),),
                                          dtype=torch.float64, device=dev)
    return buf


def _payload_windows(sym, start, clamp_len, Lp):
    """(B, Lp, 2): each lane's payload rows from its start, clamped into
    [0, rows - clamp_len] (the plain version's gather)."""
    X, Y, rows, _ = sym.shape
    B = X * Y
    flat = sym.reshape(B, rows, 2)
    if start is None:
        return flat[:, :Lp]
    s = start.clamp(0, rows - clamp_len)
    idx = s[:, None] + torch.arange(Lp, device=sym.device)
    return torch.gather(flat, 1, idx[..., None].expand(B, Lp, 2))


# a test hook: a list that ``payload_plain`` appends each call's float
# LLRs (B, N), before quantization, and lane mask (B,) to; None: off
FLOAT_LLRS = None


def payload_plain(sym, start, clamp_len, descr, ph, cc, n0_ov, info,
                  constellation, rate, llr_out, fine_out, n0_out, sel=None,
                  x_out=None, x_every=1, x_scale=1.0, n0_use=False):
    """Plain PyTorch version of ``payload`` (the same contract)."""
    B = sym.shape[0] * sym.shape[1]
    pay = _payload_windows(sym, start, clamp_len, info.payload_len)
    p = cplx.cmul(pay, descr[: info.payload_len])
    ph_own = ph[:, 0, 0]
    if info.has_pilots:
        pil = plsync.pilot_phases(p, info.n_pilots)
        fine = plsync.fine_from_pilot_phases(ph[:, 0, 1], pil, info.n_pilots)
        xfec = plsync.correct_payload_pilots(
            p, ph_own, pil, torch.where(cc, fine, 0.0), info.n_slots,
            info.n_pilots)
    else:
        fine = plsync.fine_foffset_pilotless(ph_own, ph[:, 1, 0],
                                             info.plframe_len)
        xfec = plsync.correct_payload_pilotless(p, ph_own,
                                                torch.where(cc, fine, 0.0))
    if constellation == "QPSK":
        snr = estimate_snr_qpsk(xfec)
    else:
        snr = estimate_snr_generic(xfec, constellation, rate)
    n0 = 1.0 / snr.clamp(min=1e-9)
    n0u = torch.where(n0_ov > 0, n0_ov, n0)
    llr = demap(xfec, n0u, constellation, rate, quantize=False)   # (B, N)
    m = (torch.ones((B,), dtype=torch.bool, device=sym.device)
         if sel is None else sel)
    if FLOAT_LLRS is not None:
        FLOAT_LLRS.append((llr, m))
    dst = llr_out[: llr.shape[1]]
    dst.copy_(torch.where(m[None], quantize_llrs(llr).t(), dst))
    fine_out.copy_(torch.where(m, fine, fine_out))
    n0_out.copy_(torch.where(m, n0u if n0_use else n0, n0_out))
    if x_out is not None:
        xs = xfec[::x_every, : x_out.shape[1]] * x_scale
        x_out.copy_(torch.where(m[::x_every, None, None], xs, x_out))


def _payload_layout(sym, start, clamp_len, info, llr_out, sel, x_out,
                    x_every, x_scale, n0_use):
    """``payload``'s launch layout: (call, PLS, X, Y, rows, the symbol
    buffer's strides, clamp_len, per-lane starts, the LLR view's rows and
    strides, lane mask, x_every, x_len, x_scale, n0_use)."""
    return ("plsync_payload", info.plsc, *sym.shape[:3], *sym.stride(),
            clamp_len, int(start is not None), llr_out.shape[0],
            *llr_out.stride(), int(sel is not None), x_every,
            0 if x_out is None else x_out.shape[1], float(x_scale),
            int(n0_use))


def payload(sym, start, clamp_len, descr, ph, cc, n0_ov, info, constellation,
            rate, llr_out, fine_out, n0_out, sel=None, x_out=None, x_every=1,
            x_scale=1.0, n0_use=False):
    """Payload processing of B = X Y lanes of one PLS geometry, in place.

    sym (X, Y, rows, 2) float32, each lane's symbol buffer (a view; lane
    b = x Y + y); its payload starts at row ``start[b]`` ((B,) int64, or
    None for row 0), clamped into [0, rows - clamp_len] (the caller's
    window length, >= Lp); ``descr`` (>= Lp, 2) the PL descrambling
    sequence; ``ph`` (B, 2, 2) ``plheader``'s phases of the lane's header
    and of the next one; ``cc`` (B,) bool coarse_corrected; ``n0_ov`` (B,)
    float32 (> 0 demaps with it instead of the data-aided N0); ``info``
    the PLS's ``PLSInfo``. Writes, for every lane (only the lanes set in
    ``sel`` (B,) bool when given): the int8 LLRs in codeword order at
    ``llr_out[:N, b]`` (a (>= N, B) int8 view, any strides), the fine CFO
    (ungated) in ``fine_out[b]``, the data-aided N0 (or, with ``n0_use``,
    the N0 it demapped with) in ``n0_out[b]``, and, for lanes b = k x_every,
    the first x_len corrected symbols x ``x_scale`` in ``x_out[k]`` ((B /
    x_every, x_len, 2) float32). On CPU tensors the plain version runs;
    on the card the statistics and demap kernels, one launch each."""
    _same_view([sym], "sym")
    X, Y, rows, _ = sym.shape
    B = X * Y
    Lp, n_mod = info.payload_len, info.n_mod
    N = info.n_slots * 90 * n_mod
    if B == 0 or BITS_PER_SYMBOL.get(constellation) != n_mod:
        raise ValueError(f"B {B}, {constellation} with n_mod {n_mod}")
    if not Lp <= clamp_len <= rows:
        raise ValueError(f"payload {Lp}, window {clamp_len}, rows {rows}")
    dev = sym.device
    if descr.dtype != torch.float32 or descr.dim() != 2 \
            or descr.shape[0] < Lp or descr.shape[1] != 2 \
            or not descr.is_contiguous() or descr.device != dev:
        raise ValueError(f"descr {tuple(descr.shape)}: the kernel takes a "
                         f"contiguous (>= {Lp}, 2) float32")
    if ph.dtype != torch.float32 or tuple(ph.shape) != (B, 2, 2) \
            or ph.device != dev:
        raise ValueError(f"ph {tuple(ph.shape)} {ph.dtype}: the kernel takes "
                         f"({B}, 2, 2) float32")
    if llr_out.dtype != torch.int8 or llr_out.dim() != 2 \
            or llr_out.shape[0] < N or llr_out.shape[1] != B \
            or llr_out.device != dev:
        raise ValueError(f"llr_out {tuple(llr_out.shape)} {llr_out.dtype}: "
                         f"the kernel takes (>= {N}, {B}) int8")
    for name, x in (("fine_out", fine_out), ("n0_out", n0_out)):
        if x.dtype != torch.float32 or tuple(x.shape) != (B,) \
                or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: the kernel takes contiguous ({B},) "
                             f"float32")
    R = info.n_slots * 90
    if x_out is not None and (
            x_every < 1 or B % x_every or x_out.dtype != torch.float32
            or x_out.dim() != 3 or x_out.shape[0] != B // x_every
            or not 0 < x_out.shape[1] <= R or x_out.shape[2] != 2
            or not x_out.is_contiguous() or x_out.device != dev):
        raise ValueError(f"x_out {tuple(x_out.shape)}: the kernel takes a "
                         f"contiguous ({B} / {x_every}, <= {R}, 2) float32")
    if start is not None:
        start = _lane_vec(start, B, torch.int64, "start", dev)
    cc = _lane_vec(cc, B, torch.bool, "coarse_corrected", dev)
    n0_ov = _lane_vec(n0_ov, B, torch.float32, "n0_override", dev)
    if sel is not None:
        sel = _lane_vec(sel, B, torch.bool, "sel", dev)
    fn = _launch_payload if sym.is_cuda else payload_plain
    fn(sym, start, clamp_len, descr, ph, cc, n0_ov, info, constellation,
       rate, llr_out, fine_out, n0_out, sel, x_out, x_every, x_scale, n0_use)


def _launch_payload(sym, start, clamp_len, descr, ph, cc, n0_ov, info,
                    constellation, rate, llr_out, fine_out, n0_out, sel,
                    x_out, x_every, x_scale, n0_use):
    """``payload``'s two kernel launches on checked arguments."""
    X, Y, rows, _ = sym.shape
    B, dev = X * Y, sym.device
    Lp, n_mod, R = info.payload_len, info.n_mod, info.n_slots * 90
    ph = ph.contiguous()
    scratch = payload_scratch(B, dev)
    order = _order_word(constellation, rate)
    l_pos, l_lane = llr_out.stride()
    plan = launch_plan(B, R, n_mod, order, l_pos, l_lane)
    kc = device_table(payload_constants(info.plframe_len, info.n_pilots), dev)
    pts = (None if constellation == "QPSK" else
           device_table(_points(constellation, rate), dev).data_ptr())
    args = (sym.data_ptr(), _ptr(start), descr.data_ptr(),
            ph.data_ptr(), cc.data_ptr(), n0_ov.data_ptr(),
            _ptr(sel), pts, kc.data_ptr(), llr_out.data_ptr(), _ptr(x_out),
            fine_out.data_ptr(), n0_out.data_ptr(),
            scratch.data_ptr(), B, Y, *sym.stride(), rows,
            clamp_len, Lp, info.n_pilots, R, n_mod, order, l_pos, l_lane,
            x_every, 0 if x_out is None else x_out.shape[1], float(x_scale),
            int(n0_use), plan["chunk"], plan["chunks"], plan["tile_syms"],
            int(plan["write_along"] == "lane"), KINDS[constellation],
            N_POINTS[constellation],
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.lib()
    _build.check(lib.plsync_stats_launch(*args), "plsync_stats_kernel")
    LAUNCHES["plsync_stats"] += 1
    _build.check(lib.plsync_demap_launch(*args), "plsync_demap_kernel")
    LAUNCHES["plsync_demap"] += 1
    _count_layout(_payload_layout(sym, start, clamp_len, info, llr_out, sel,
                                  x_out, x_every, x_scale, n0_use))
