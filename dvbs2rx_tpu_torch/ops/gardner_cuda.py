"""The Gardner symbol-sync recurrence through a CUDA kernel.

The JAX ``SymbolSync._step_impl`` (``dvbs2rx_tpu/ops/frontend.py:184-219``)
is a per-symbol ``lax.scan``: no Pallas kernel precedes this one. Here one
launch of ``csrc/gardner.cu`` runs a whole block's recurrence for every
channel (its source note says what bounds it: the per-symbol dependency
chain, not bytes or operations). ``symbol_sync_plain`` is its plain
version: a Python loop over symbols, vectorised over the channels.

Numeric contract. A float decides an integer at every strobe (the jump,
the subfilter index), so one changed rounding moves every later symbol.
Both versions repeat the float32 arithmetic of the JAX body as XLA's CPU
backend compiles it (measured against it bit for bit), which contracts a
multiply feeding an add into one fused multiply-add: a dot product of up
to 32 taps is an FMA chain in tap order from zero (a longer one takes
XLA's tree reduction, ``_dot``), and the loop's multiply-adds are FMAs
(``_fma``; the kernel uses ``__fmaf_rn``, ``__fadd_rn``, ``__fdiv_rn`` and
``floorf``, never nvcc's own contraction). So the card, the CPU and the
JAX package agree bit for bit, up to the rare double rounding of the
plain version's float64 FMA. ``K1``, ``K2``, ``1/sps`` and the ``mu``
clip are float32 constants (rounded once by ``SymbolSync``), and every
window start is clamped into the block, as ``lax.dynamic_slice`` clamps
it: a drifting clock can push a strobe past the block's end, and the
clamp then shifts the window.

Dispatch is by the tensor's device: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..utils.runtime import device_table

LAUNCHES = 0     # kernel launches; incremented only where the kernel runs

SMEM_LIMIT = 232_448        # shared memory one block may use on Hopper
TREE_WINDOW = 32            # window of XLA's CPU tree reduction rewriter

INTERP_METHODS = ("polyphase", "linear", "quadratic", "cubic")

# Farrow coefficient rows over the reversed window w = in[m+1], in[m],
# in[m-1], in[m-2] (reference symbol_sync_cc_impl.cc:23-66; the JAX
# module's float32 constants): quadratic (v2, v1), cubic (v3, v2, v1)
FARROW = {
    "quadratic": np.asarray([[0.5, -0.5, -0.5, 0.5],
                             [-0.5, 1.5, -0.5, -0.5]], np.float32),
    "cubic": np.asarray([[1 / 6, -0.5, 0.5, -1 / 6],
                         [0.0, 0.5, -1.0, 0.5],
                         [-1 / 6, 1.0, -0.5, -1 / 3]], np.float32),
}


@dataclass
class SymbolSyncState:
    """Loop state of C channels (the JAX ``SymbolSyncState`` with a leading
    channel axis)."""
    cnt: torch.Tensor      # (C,) f32 modulo-1 counter
    mu: torch.Tensor       # (C,) f32 fractional timing offset
    vi: torch.Tensor       # (C,) f32 PI integrator
    jump: torch.Tensor     # (C,) int32 samples to the next strobe
    last_xi: torch.Tensor  # (C, 2) f32 previous output interpolant
    n: torch.Tensor        # (C,) int32 index of the last processed sample
                           # within the current buffer


def window(sync):
    """(taps table, window length W, window start relative to the strobe
    basepoint m_k) of the interpolator of ``sync``: the polyphase bank and
    [m_k + 2 - L, m_k + 2); none and [m_k, m_k + 2); the Farrow rows and
    [m_k - 2, m_k + 2)."""
    if sync.interp_method == "polyphase":
        return sync._bank, sync.subfilt_len, 2 - sync.subfilt_len
    if sync.interp_method == "linear":
        return None, 2, 0
    return FARROW[sync.interp_method], 4, -2


def _fma(a, b, c):
    """float32 a*b + c rounded once, as a fused multiply-add: with ``a`` in
    float64 the product of two float32 values is exact, so only the sum
    rounds (twice, to float64 and then to float32, which differs from one
    rounding in about 2^-29 of cases)."""
    return (a.double() * b + c).float()


def _dot(w, t):
    """XLA's sum of products over the last-but-one axis: w (..., W, 2)
    float32, t (..., W) -> (..., 2). Up to ``TREE_WINDOW`` taps it is one
    FMA chain in index order from 0. Longer sums are cut by XLA's CPU tree
    reduction: the products are rounded on their own, padded with zeros to
    whole windows of ``TREE_WINDOW`` (half the padding in front), each
    window is summed in order from 0, then the window sums in order."""
    L = w.shape[-2]
    if L <= TREE_WINDOW:
        prod = w.double() * t[..., None]          # exact, float64
        acc = torch.zeros(prod.shape[:-2] + (2,), dtype=torch.float32,
                          device=w.device)
        for col in prod.unbind(-2):
            acc.add_(col)        # summed in float64, rounded to float32
        return acc
    cols = (w * t[..., None]).unbind(-2)          # rounded products
    pad = (-L % TREE_WINDOW) // 2
    total = None
    for lo in range(-pad, L, TREE_WINDOW):
        part = cols[max(lo, 0)]
        for col in cols[max(lo, 0) + 1: lo + TREE_WINDOW]:
            part = part + col
        total = part if total is None else total + part
    return total


def symbol_sync_plain(sync, state: SymbolSyncState, samples, n_out: int):
    """Plain PyTorch version of the Gardner kernel: the JAX scan body, one
    Python iteration per symbol over all C channels at once (same contract
    as ``symbol_sync``)."""
    C, n, _ = samples.shape
    dev = samples.device
    f32 = torch.float32
    method = sync.interp_method
    table, W, lead = window(sync)
    if table is not None:
        table = device_table(table, dev)
    rows = torch.arange(C, device=dev)[:, None, None]
    offs = torch.arange(W, device=dev)
    # window starts of out_k (basepoint m_k = n - 1) and x_zc (m_k - sps/2)
    lead2 = torch.tensor([lead - 1, lead - 1 - sync.midpoint], device=dev)
    # (1,), not 0-dim: a 0-dim float64 would not promote a float32 product
    K1, K2 = (torch.tensor([v], dtype=torch.float64, device=dev)
              for v in (sync.K1, sync.K2))
    nominal, one = (torch.tensor(v, dtype=f32, device=dev)
                    for v in (sync.nominal, 1.0))
    two = torch.tensor(2, dtype=torch.int32, device=dev)
    cnt, mu, vi = state.cnt, state.mu, state.vi
    jump, last, pos = state.jump, state.last_xi, state.n
    out = []
    for _ in range(n_out):
        pos = pos + jump
        start = (pos[:, None] + lead2).clamp(0, n - W)             # (C, 2)
        win = samples[rows, start[..., None] + offs]           # (C, 2, W, 2)
        m = mu[:, None, None]
        if method == "polyphase":
            isub = torch.floor(sync.n_subfilt * mu).to(torch.int64)
            xi = _dot(win, table[isub.clamp(0, sync.n_subfilt - 1)][:, None])
        elif method == "linear":
            xi = _fma(m, win[:, :, 1], (one - m) * win[:, :, 0])
        else:
            # Horner over (v3,) v2, v1, then + v0 = in[m_k - 1]
            w = win.flip(-2)
            acc = _dot(w, table[0])
            for j in range(1, table.shape[0]):
                acc = _fma(m, acc, _dot(w, table[j]))
            xi = _fma(acc, m, w[:, :, 2])
        out_k, x_zc = xi[:, 0], xi[:, 1]                           # (C, 2)
        out.append(out_k)
        xd = x_zc.double() * (last - out_k)
        e = (xd[:, 1] + xd[:, 0].float()).float()
        vi = (K2 * e + vi).float()
        pi_out = (K1 * e + vi).float()
        W1 = nominal + pi_out
        W2 = nominal + vi
        lag = cnt - W1
        jump = (torch.floor(lag / W2) + 2).to(torch.int32)
        base = ((two - jump).double() * W2 + lag).float()
        single = jump <= 1
        mu = torch.where(single, cnt / W1, base / W2)
        cnt = torch.where(single, lag + one, (base - W2) + one)
        mu = mu.clamp(0.0, sync.mu_max)
        last = out_k
    sym = (torch.stack(out, 1) if out else
           torch.empty((C, 0, 2), dtype=f32, device=dev))
    return SymbolSyncState(cnt, mu, vi, jump, last, pos), sym


@dataclass(frozen=True)
class GardnerPlan:
    """How one call is staged: the taps table (``table_floats`` floats,
    padded to 16 bytes) and a sample tile of ``tile`` samples in shared
    memory, ``smem_bytes`` in all. A tile holds the whole block when it
    fits (sps 2 and 4 at the 4,096-symbol front-end block); otherwise the
    kernel reloads it where the next strobe's windows begin."""
    table_floats: int
    tile: int
    smem_bytes: int


def launch_plan(n, W, midpoint, table_floats):
    table_bytes = -(-table_floats * 4 // 16) * 16
    tile = min(n, (SMEM_LIMIT - table_bytes) // 8)
    if tile < W + midpoint:
        raise ValueError(f"a tile of {tile} samples cannot hold one strobe's "
                         f"windows ({W} + {midpoint})")
    return GardnerPlan(table_floats, tile, table_bytes + 8 * tile)


def _check(sync, state, samples, n_out):
    if samples.ndim != 3 or samples.shape[-1] != 2:
        raise ValueError("samples must be (C, n, 2) planar")
    if samples.dtype != torch.float32:
        raise ValueError("samples must be float32")
    C, n, _ = samples.shape
    W = window(sync)[1]
    if n < W:
        raise ValueError(f"{n} samples: fewer than one window ({W})")
    if n_out < 0:
        raise ValueError("n_out must be >= 0")
    for k, shape in (("cnt", (C,)), ("mu", (C,)), ("vi", (C,)),
                     ("jump", (C,)), ("n", (C,)), ("last_xi", (C, 2))):
        t = getattr(state, k)
        if tuple(t.shape) != shape or t.device != samples.device:
            raise ValueError(f"state.{k}: {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {samples.device}")


def symbol_sync(sync, state: SymbolSyncState, samples, n_out: int):
    """One block of the Gardner loop for C channels: samples (C, n, 2)
    float32, ``state`` of C channels; returns (state', symbols (C, n_out,
    2)). ``sync`` (a ``frontend.SymbolSync``) carries the interpolator,
    its table and the loop constants."""
    global LAUNCHES
    _check(sync, state, samples, n_out)
    if not samples.is_cuda:
        return symbol_sync_plain(sync, state, samples, n_out)
    C, n, _ = samples.shape
    dev = samples.device
    table, W, lead = window(sync)
    tab = None if table is None else device_table(table, dev)
    plan = launch_plan(n, W, sync.midpoint, 0 if tab is None else tab.numel())
    x = samples.contiguous()
    if x.data_ptr() % 8:
        raise ValueError("samples must be 8-byte aligned (float2 reads)")
    f32, i32 = torch.float32, torch.int32
    ins = [state.cnt.to(f32).contiguous(), state.mu.to(f32).contiguous(),
           state.vi.to(f32).contiguous(), state.jump.to(i32).contiguous(),
           state.n.to(i32).contiguous(), state.last_xi.to(f32).contiguous()]
    outs = [torch.empty_like(t) for t in ins]
    sym = torch.empty((C, n_out, 2), dtype=f32, device=dev)
    err = _build.lib().gardner_launch(
        x.data_ptr(), 0 if tab is None else tab.data_ptr(), sym.data_ptr(),
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        C, n, n_out, sync.interp, W, lead, sync.midpoint, sync.n_subfilt,
        plan.table_floats, plan.tile, sync.K1, sync.K2, sync.nominal,
        sync.mu_max, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "gardner_kernel")
    LAUNCHES += 1
    cnt, mu, vi, jump, pos, last = outs
    return SymbolSyncState(cnt, mu, vi, jump, last, pos), sym
