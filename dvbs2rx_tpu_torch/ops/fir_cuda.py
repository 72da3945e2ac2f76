"""Segmented polyphase matched filter + decimation through a CUDA kernel.

Replaces ``dvbs2rx_tpu/ops/pallas_fir.py`` (``mf_segmented``,
``mf_decimate`` and the Pallas kernel ``_seg_kernel``). The kernel is
``csrc/mf_segmented.cu``; its source note says what bounds it on the card
(memory: ~100 MB moved per 64-channel stream step) and how the design
answers. ``mf_segmented_plain`` is its plain version: a strided window
(``unfold``) times the taps in float32. ``launch_plan`` cuts the call into
the kernel's work items (channel, segment, chunk) and sizes its
shared-memory ring.

The JAX front end keeps its Pallas kernel off by default and runs an XLA
grouped convolution; the port runs this kernel on the card instead (cuDNN
would not be a port, and it defaults to TF32). The numeric contract is the
same: exact float32, and ``base_seg`` silently clipped into
``[0, off_bound]`` as both JAX paths do.

With per-channel ``start`` (C,) and a block ``length``, each channel's
input is the ``length`` rows of ``samples`` from its start, clamped into
``[0, n - length]`` as ``jax.lax.dynamic_slice`` clamps it: the stream
receivers pass their right-aligned sample buffer itself and the kernel
reads it in place (the plain version gathers the block first).

Dispatch is by the tensor's device: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.
"""

from dataclasses import dataclass

import torch

from .. import _build
from .cplx import window_rows

LAUNCHES = 0     # kernel launches; incremented only where the kernel runs
LAUNCH_SHAPES = {}  # the same launches by (C, n, S, seg_len, L, sps,
                    # off_bound), and length last for a call with
                    # per-channel block starts


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_SHAPES.clear()


_build.register_counter("mf_segmented", lambda: LAUNCHES, _reset_counts)

# kThreads, kR, kStages, kMaxTaps and the tap buckets of
# csrc/mf_segmented.cu
THREADS, OUTPUTS_PER_THREAD, STAGES, MAX_TAPS = 128, 8, 2, 64
CHUNK_MAX = THREADS * OUTPUTS_PER_THREAD
SMEM_LIMIT = 232_448        # shared memory one block may use on Hopper


def _padded(v):
    """Shared-memory slot of 16-byte vector v (one pad slot per 8)."""
    return v + (v >> 3)


@dataclass(frozen=True)
class MFPlan:
    """How one ``mf_segmented`` call is cut for the kernel: ``items`` work
    items, (channel, segment, chunk) in that order, of ``chunk`` outputs
    (the last chunk of a segment holds the rest), taps zero-padded to
    ``lmax``, and a ring of ``STAGES`` window stages of ``stage_vectors``
    16-byte vectors each."""
    lmax: int
    chunk: int
    n_chunks: int
    items: int
    stage_vectors: int
    smem_bytes: int


def launch_plan(C, S, seg_len, L, sps):
    """The kernel's work items and shared memory for one call (mirrors
    ``stage_vectors`` and ``smem_bytes`` of the source)."""
    if not 1 <= L <= MAX_TAPS:
        raise ValueError(f"{L} taps: the kernel takes 1..{MAX_TAPS}")
    if sps < 1:
        raise ValueError(f"sps {sps} must be a positive integer")
    lmax = 24 if L <= 24 else MAX_TAPS
    n_chunks = -(-seg_len // CHUNK_MAX)
    chunk = -(-seg_len // n_chunks)
    chunk = min(chunk + chunk % 2, CHUNK_MAX)    # even: 16-byte output rows
    n_chunks = -(-seg_len // chunk)
    nv = (2 + sps * (CHUNK_MAX - 1) + lmax) // 2
    smem = 16 * (STAGES * _padded(nv) + _padded(CHUNK_MAX // 2)
                 + STAGES * lmax // 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sps {sps}: the window ring needs {smem} B of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return MFPlan(lmax, chunk, n_chunks, C * S * n_chunks, nv, smem)


def _check(samples, taps_seg, base_seg, sps, seg_len, off_bound, start,
           length):
    if samples.ndim != 3 or samples.shape[-1] != 2:
        raise ValueError("samples must be (C, n, 2) planar")
    if samples.dtype != torch.float32 or taps_seg.dtype != torch.float32:
        raise ValueError("samples and taps must be float32")
    C, n, _ = samples.shape
    S, L = taps_seg.shape[1], taps_seg.shape[2]
    if taps_seg.shape[0] != C or tuple(base_seg.shape) != (C, S):
        raise ValueError("taps_seg (C, S, L) and base_seg (C, S) expected")
    if (start is None) != (length is None):
        raise ValueError("pass start and length together")
    if start is not None:
        if tuple(start.shape) != (C,) or start.dtype not in (torch.int32,
                                                             torch.int64):
            raise ValueError("start must be (C,) int32 or int64")
        if not 1 <= length <= n:
            raise ValueError(f"block length {length} outside 1..{n}")
        n = length
    # caller contract (pallas_fir.py:224,267): every extraction window,
    # at any offset up to off_bound, lies inside the input
    need = (S * seg_len - 1) * sps + L + off_bound
    if n < need:
        raise ValueError(f"history too short: n={n} < {need}")


def mf_segmented_plain(samples, taps_seg, base_seg, sps, seg_len, off_bound,
                       start=None, length=None):
    """Plain PyTorch version of the kernel (same contract as
    ``mf_segmented``)."""
    if start is not None:
        samples = window_rows(samples, start, length)
    C, n, _ = samples.shape
    S, L = taps_seg.shape[1], taps_seg.shape[2]
    off = base_seg.to(torch.int64).clamp(0, off_bound)
    W = (seg_len - 1) * sps + L
    dev = samples.device
    start = (torch.arange(S, device=dev) * (seg_len * sps))[None] + off
    idx = start[..., None] + torch.arange(W, device=dev)          # (C, S, W)
    rails = samples.permute(0, 2, 1)                               # (C, 2, n)
    win = torch.gather(
        rails[:, :, None, :].expand(C, 2, S, n), 3,
        idx[:, None].expand(C, 2, S, W),
    )                                                              # (C,2,S,W)
    frames = win.unfold(3, L, sps)                         # (C, 2, S, seg, L)
    y = torch.matmul(frames, taps_seg[:, None, :, :, None])[..., 0]
    return y.permute(0, 2, 3, 1).reshape(C, S * seg_len, 2)


def mf_segmented(samples, taps_seg, base_seg, sps, seg_len, off_bound,
                 start=None, length=None):
    """Batched segmented decimating matched filter.

    samples (C, n, 2) f32; taps_seg (C, S, L) f32; base_seg (C, S) int
    whole-sample offsets, clipped into [0, off_bound]. Window s starts at
    sample ``s*seg_len*sps + base_seg[c, s]`` of the channel's block: the
    whole row, or with ``start`` (C,) int and ``length`` the ``length``
    rows from ``clamp(start[c], 0, n - length)``. Returns (C, S*seg_len,
    2).
    """
    global LAUNCHES
    _check(samples, taps_seg, base_seg, sps, seg_len, off_bound, start,
           length)
    if not samples.is_cuda:
        return mf_segmented_plain(samples, taps_seg, base_seg, sps, seg_len,
                                  off_bound, start, length)
    C, n, _ = samples.shape
    S, L = taps_seg.shape[1], taps_seg.shape[2]
    plan = launch_plan(C, S, seg_len, L, sps)
    x = samples.contiguous()
    if x.data_ptr() % 8:
        raise ValueError("samples must be 8-byte aligned (float2 reads)")
    taps = taps_seg.contiguous()
    base = base_seg.to(torch.int32).contiguous()
    st = None if start is None else start.to(torch.int32).contiguous()
    y = torch.empty((C, S * seg_len, 2), dtype=torch.float32,
                    device=samples.device)
    err = _build.lib().mf_segmented_launch(
        x.data_ptr(), taps.data_ptr(), base.data_ptr(), y.data_ptr(),
        C, n, S, seg_len, L, sps, off_bound, plan.chunk, plan.n_chunks,
        None if st is None else st.data_ptr(), 0 if st is None else length,
        torch.cuda.current_stream(samples.device).cuda_stream,
    )
    _build.check(err, "mf_segmented_kernel")
    LAUNCHES += 1
    key = (C, n, S, seg_len, L, int(sps), int(off_bound))
    if st is not None:
        key += (int(length),)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
    return y


def mf_decimate(samples, taps, base, sps, n_out, start=None, length=None):
    """y[c, k] = sum_l samples[c, base[c] + k*sps + l] * taps[c, l].

    samples (C, n, 2); taps (C, L); base (C,) int, clipped into
    [0, n - n_out*sps - L + 1] as the JAX fallback's dynamic slice of its
    valid-mode convolution clips it. The one-segment case of
    ``mf_segmented``, so it runs the same kernel on the card (with
    ``start``/``length`` the same block in place: n is then ``length``).
    """
    n = samples.shape[1] if start is None else length
    off_bound = n - n_out * sps - taps.shape[-1] + 1
    return mf_segmented(samples, taps[:, None, :], base[:, None], sps, n_out,
                        off_bound, start, length)
