"""The O&M timing estimate and its tracker through one CUDA kernel.

The JAX ``FeedForwardSync`` (``dvbs2rx_tpu/ops/ffsync.py:154-405``:
``_om_terms``, ``_estimate_tau``, ``_estimate_timing_multi``,
``_track_impl``) has no Pallas kernel: XLA fuses it. Its plain PyTorch
version is ``FeedForwardSync._track_plain`` (``ops/ffsync.py``), ~110
small launches around a (2, C, 16, 1024, 12) unfold product; CPU tensors
run it. One launch of ``csrc/ffsync.cu`` does it all for every channel:
the windows' O&M sums, the estimate (16 windows and a least-squares
slope, or one window below ``MIN_MULTI_SAMP`` samples), the alpha-beta
update, each segment's subfilter taps and offset, the slips and
``consumed``; its source note says how and what bounds it. A channel is
a thread block cluster of G blocks that share its pieces of 1,024
samples (``plan`` mirrors the source's ``track_plan``; ``combine_order``
states the order in which rank 0 adds their partial sums).

``track`` takes the block itself, or a longer buffer with per-channel
starts (clamped as ``jax.lax.dynamic_slice`` clamps) that it reads in
place. It reads nothing back and copies nothing from the host (the window
starts and centres travel in the kernel's arguments), so a CUDA graph can
hold it. ``FeedForwardSync._track`` dispatches: CUDA tensors launch the
kernel or raise.
"""

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build

LAUNCHES = 0        # kernel launches; incremented only where the kernel runs
LAUNCH_SHAPES = {}  # the same launches by (C, N, length or None, n_out)

PIECE = 1024        # kPiece of csrc/ffsync.cu: samples a piece
GROUP = 128         # kGroup: threads a piece, 8 samples each
WARPS = GROUP // 32  # warp partials a piece
MAX_PER = 2         # kMaxPer: pieces a block
MAX_CLUSTER = 8     # kMaxCluster: blocks a channel (the portable cluster)
MAX_PIECES = 16     # kMaxPieces: windows x pieces a window
MAX_WINDOWS = 16    # kMaxWindows
MAX_SEGMENTS = 32   # kMaxSeg
PIECE_BYTES = 9328  # kPieceBytes: a piece's padded staging, 16-byte rounded
MAX_SMEM = 232_448  # shared memory a block can have on the H100
TWO_PI = float(np.float32(2 * math.pi))


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_SHAPES.clear()


_build.register_counter("ffsync_track", lambda: LAUNCHES, _reset_counts)


def windows(n, est_window):
    """The estimate's windows over a block of n samples: (multi, W,
    window length, window starts (W,) int32). Multi-window (n >=
    MIN_MULTI_SAMP): ``_window_offsets(n)``'s windows of WIN_SAMP
    samples; else the first min(est_window, n) samples."""
    from .ffsync import MIN_MULTI_SAMP, WIN_SAMP

    if n >= MIN_MULTI_SAMP:
        offs = _offsets_i32(n)
        return True, offs.shape[0], WIN_SAMP, offs
    return False, 1, min(est_window, n), _ZERO


_ZERO = np.zeros(1, np.int32)


@functools.lru_cache(maxsize=8)
def _offsets_i32(n):
    from .ffsync import _window_offsets

    return _window_offsets(n).astype(np.int32)


class Plan(NamedTuple):
    """A launch's work plan: G blocks a channel (one cluster), ``per``
    pieces a block (one group of GROUP threads each), ``threads`` a
    block."""
    G: int
    per: int
    threads: int


def plan(n_pieces):
    """``track_plan`` of csrc/ffsync.cu: a channel's pieces over up to
    MAX_CLUSTER blocks (a portable cluster), at most one a piece,
    ceil(pieces / MAX_CLUSTER) a block; then the fewest blocks that take
    them at that many a block. Block rank r takes pieces r per .. r per +
    per - 1."""
    per = -(-n_pieces // MAX_CLUSTER)
    return Plan(-(-n_pieces // per), per, per * GROUP)


def combine_order(W, ppw, per):
    """The order in which rank 0 adds the warp partials: window by
    window, each window's pieces (piece p = window x ppw + k) in order,
    each piece's WARPS warps in order; as (window, piece, block rank,
    piece slot in that block, warp) tuples. Each window's sum starts from
    0.0 and adds these in turn (the one-block design's order)."""
    return [(w, p, p // per, p % per, u)
            for w in range(W) for p in range(w * ppw, (w + 1) * ppw)
            for u in range(WARPS)]


def smem_bytes(per, bank_floats):
    """``track_smem_bytes``: a block's dynamic shared memory, its pieces'
    staging, which rank 0 reuses for the subfilter bank."""
    return max(per * PIECE_BYTES, -(-bank_floats * 4 // 16) * 16)


def check_plan(n, est_window, S, bank_floats=0):
    """Raise where the kernel's fixed sizes do not take the block: at most
    MAX_PIECES pieces of PIECE samples over the windows, MAX_WINDOWS
    windows and MAX_SEGMENTS segments, and a subfilter bank that fits a
    block's shared memory (rank 0 stages it where its pieces were)."""
    _, W, wlen, _ = windows(n, est_window)
    pieces = W * -(-wlen // PIECE)
    if W > MAX_WINDOWS or pieces > MAX_PIECES or S > MAX_SEGMENTS:
        raise ValueError(f"O&M tracker: {W} windows of {wlen} samples "
                         f"({pieces} pieces), {S} segments: the kernel "
                         f"takes {MAX_WINDOWS} windows, {MAX_PIECES} pieces "
                         f"of {PIECE} and {MAX_SEGMENTS} segments")
    if smem_bytes(MAX_PER, bank_floats) > MAX_SMEM - 1024:
        raise ValueError(f"O&M tracker: a subfilter bank of {bank_floats} "
                         f"floats does not fit a block's shared memory")


def track(sync, state, samples, n_out, start=None, length=None):
    """One launch of the tracker kernel: ``FeedForwardSync._track`` on
    CUDA tensors. samples (C, N, 2) float32 contiguous: the block, or with
    ``start`` (C,) int32/int64 and ``length`` the buffer holding each
    channel's block; state of (C,) float32 tau, rate and int32
    initialized. Returns (state', taps_seg (C, S, L), off_seg (C, S)
    int32, consumed (C,) int32)."""
    if samples.dim() != 3 or samples.shape[2] != 2 \
            or samples.dtype != torch.float32:
        raise ValueError(f"samples {tuple(samples.shape)} {samples.dtype}: "
                         f"the kernel takes (C, N, 2) float32")
    if not samples.is_cuda:
        raise ValueError("the kernel takes CUDA tensors; the plain version "
                         "is FeedForwardSync._track_plain")
    C, N = samples.shape[0], samples.shape[1]
    if (start is None) != (length is None):
        raise ValueError("pass start and length together")
    n = N if start is None else int(length)
    if not 1 <= n <= N:
        raise ValueError(f"block length {n} outside 1..{N}")
    S = sync.segments(n_out)
    check_plan(n, sync.est_window, S, sync.bank.numel())
    dev = samples.device
    leaves = (state.tau, state.rate, state.initialized)
    for x, dt in zip(leaves, (torch.float32, torch.float32, torch.int32)):
        if tuple(x.shape) != (C,) or x.dtype != dt or x.device != dev:
            raise ValueError(f"state leaf {tuple(x.shape)} {x.dtype}: the "
                             f"kernel takes (C,) {dt} on {dev}")
    if start is not None and (tuple(start.shape) != (C,)
                              or start.device != dev):
        raise ValueError(f"start {tuple(start.shape)}: (C,) on {dev}")
    if not samples.is_contiguous() or samples.data_ptr() % 8:
        raise ValueError("samples must be contiguous and 8-byte aligned")
    if sync.bank.device != dev:
        raise ValueError(f"the FeedForwardSync's subfilter bank is on "
                         f"{sync.bank.device}, the samples on {dev}")
    if not sync.bank.is_contiguous() or sync.bank.data_ptr() % 16:
        raise ValueError("the subfilter bank must be contiguous and "
                         "16-byte aligned")
    return _launch(sync, leaves, samples, n_out, start, n, S)


def _launch(sync, leaves, samples, n_out, start, n, S):
    """``track``'s launch on checked arguments."""
    global LAUNCHES
    from .ffsync import FFSyncState, MAX_RATE, _window_centres

    C, N, dev = samples.shape[0], samples.shape[1], samples.device
    ins = [x.contiguous() for x in leaves]
    st = None if start is None else start.to(torch.int32).contiguous()
    multi, W, wlen, offs = windows(n, sync.est_window)
    sps = sync.sps
    L = sync.subfilt_len
    bank = sync.bank
    wc = _window_centres(n, sps) if multi else None
    f32 = torch.empty((2, C), dtype=torch.float32, device=dev)
    i32 = torch.empty((2, C), dtype=torch.int32, device=dev)
    taps = torch.empty((C, S, L), dtype=torch.float32, device=dev)
    off = torch.empty((C, S), dtype=torch.int32, device=dev)
    c_sym = min(sync.est_window, n) / (2.0 * sps)
    err = _build.lib().ffsync_track_launch(
        samples.data_ptr(), None if st is None else st.data_ptr(),
        offs.ctypes.data, None if wc is None else wc.ctypes.data,
        sync._hb_even_rev_np.ctypes.data,
        bank.data_ptr(), *(x.data_ptr() for x in ins), f32[0].data_ptr(),
        f32[1].data_ptr(), i32[0].data_ptr(), taps.data_ptr(),
        off.data_ptr(), i32[1].data_ptr(), C, N, n, W, wlen, int(multi), L,
        sync.n_subfilt, S, n_out // S, n_out, sps, sync._off,
        sync._center * sync._center, sync.smooth, sync.rate_gain, MAX_RATE,
        c_sym, TWO_PI, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffsync_track_kernel")
    LAUNCHES += 1
    key = (C, N, None if start is None else n, n_out)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    return FFSyncState(tau=f32[0], rate=f32[1], initialized=i32[0]), taps, \
        off, i32[1]


def edge_margin(sync, state, samples, n_out):
    """Per channel, how near the plain tracker sits to a place where a
    float decides an integer, in samples: each segment's position to the
    subfilter grid (multiples of 1 / n_subfilt, whole samples included),
    the end position to the slip edges (odd whole samples), the estimate
    and the innovation to their modulo wraps. (C,) float32; samples is the
    block itself, on the sync's device."""
    from .ffsync import MIN_MULTI_SAMP

    sps = sync.sps
    tau0, rate = sync._estimate(state, samples, n_out)
    S = sync.segments(n_out)
    kc = (torch.arange(S, dtype=torch.float32, device=tau0.device)
          + 0.5) * (n_out // S)
    tau_seg = tau0[:, None] + rate[:, None] * kc
    grid = tau_seg * sync.n_subfilt
    m_seg = ((grid - grid.round()).abs() / sync.n_subfilt).min(1).values
    pos_end = tau0 + rate * n_out
    m_slip = ((pos_end + 1) / 2 - ((pos_end + 1) / 2).round()).abs() * 2
    n = samples.shape[1]
    if n >= MIN_MULTI_SAMP:
        tau_meas, _ = sync._estimate_timing_multi(samples)
        arg = tau_meas - state.tau + sps / 2
    else:
        tau_meas = sync._estimate_tau(samples)
        arg = tau_meas - (state.tau + state.rate
                          * (min(sync.est_window, n) / (2.0 * sps))) + sps / 2
    m_wrap = torch.minimum(
        torch.minimum(tau_meas, sps - tau_meas).abs(),
        (arg / sps - (arg / sps).round()).abs() * sps)
    return torch.minimum(torch.minimum(m_seg, m_slip), m_wrap)
