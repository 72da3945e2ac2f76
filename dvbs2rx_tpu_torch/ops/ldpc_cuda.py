"""LDPC decoding through the hand-written CUDA kernel.

Replaces ``dvbs2rx_tpu/ops/ldpc_pallas.py`` (``PallasLDPCDecoder`` and the
Pallas kernel ``_build_kernel``). The kernel is ``csrc/ldpc_layered.cu``;
its source note says what bounds it on the card and how the design answers.
It keeps the check messages on chip, packed as ``ops/ldpc.pack_layer_msgs``
documents, so the wrapper allocates nothing but the outputs. Its plain
version is ``ops/ldpc.LDPCDecoder``.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain decoder; a CUDA tensor launches the kernel or raises (a failed build
or launch is never caught and replaced by the plain decoder).
"""

import numpy as np
import torch

from .. import _build
from ..spec.ldpc_tables import LDPCCode
from ..utils.runtime import resolve_device
from .ldpc import M, LDPCDecoder, layer_edges, write_runs

LAUNCHES_BY_CODE = {}   # kernel launches by code table name; incremented
                        # only where the kernel runs
LAUNCH_SHAPES = {}      # the same launches by (code table name, B,
                        # max_trials)


def __getattr__(name):
    if name == "LAUNCHES":      # the kernel's launches over every code
        return sum(LAUNCHES_BY_CODE.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _reset_counts():
    LAUNCHES_BY_CODE.clear()
    LAUNCH_SHAPES.clear()


_build.register_counter("ldpc_layered",
                        lambda: sum(LAUNCHES_BY_CODE.values()),
                        _reset_counts)


def kernel_tables(code: LDPCCode):
    """Flat int32 edge tables of the kernel: (layer_ptr (q+1,), base (E,),
    shift (E,), sync (E,)) over the data edges of all layers in order.
    ``sync`` marks an edge that must wait for the layer's earlier writes
    (its block was named before in the same layer)."""
    edges = layer_edges(code)
    ptr, base, shift, sync = [0], [], [], []
    for e in edges:
        starts = {a for a, _ in write_runs(e)}
        for c, (b, s) in enumerate(e):
            base.append(b * M)
            shift.append(s)
            sync.append(1 if (c in starts and c > 0) else 0)
        ptr.append(len(base))
    return tuple(np.asarray(x, np.int32) for x in (ptr, base, shift, sync))


def packed_tables(code: LDPCCode) -> np.ndarray:
    """The kernel's shared-memory tables as one int32 array: per layer
    ``e0 | D << 16 | lsync << 24`` (first data edge, data edges, a block
    named twice), per layer the barrier mask (bit c: ``sync`` of data edge
    c), per data edge ``base | shift << 16``, then zeros (DM of them, and up
    to a multiple of 4 entries) that the unrolled edge loops may read."""
    ptr, base, shift, sync = (x.astype(np.int64) for x in kernel_tables(code))
    D = np.diff(ptr)
    if code.K >= 1 << 16 or ptr[-1] >= 1 << 16 or D.max() > 30:
        raise ValueError(f"code {code.name} exceeds the kernel's tables")
    q, dm = code.q, int(D.max())
    smask = np.array([int((sync[a:b] << np.arange(b - a)).sum())
                      for a, b in zip(ptr[:-1], ptr[1:])], np.int64)
    info = ptr[:-1] | (D << 16) | ((smask != 0) << 24)
    edge = base | (shift << 16)
    n_tab = (2 * q + len(base) + dm + 3) & ~3
    out = np.zeros(n_tab, np.int64)
    out[: 2 * q + len(base)] = np.concatenate([info, smask, edge])
    return out.astype(np.int32)


class CudaLDPCDecoder:
    """Same call contract as ``ops.ldpc.LDPCDecoder`` (and the JAX
    ``PallasLDPCDecoder``): ``decode_lane_major`` (N, B) int8 -> (hard_t
    (N, B) uint8, llrsT (N, B) int8, iters int32 scalar = max over frames,
    conv (B,) bool); ``__call__`` the same in (B, N) layout;
    ``decode_frames`` is ``decode_lane_major`` with the iterations of each
    frame (B,) int32 in place of their maximum. ``launch`` is the kernel
    itself, with per-frame iteration counts.

    The kernel works frame by frame, in (B, N) rows. ``decode_lane_major``
    hands it ``llrsT.t()`` (no copy when the caller's (N, B) tensor is a
    transposed view of rows, as the stream step's LLRs are) and returns its
    outputs as (N, B) transposed views, not copies."""

    def __init__(self, code: LDPCCode, max_trials: int = 25, device=None):
        self.code = code
        self.max_trials = max_trials
        self.device = resolve_device(device)
        degrees = [len(e) for e in layer_edges(code)]
        self.dm = max(degrees)                 # the kernel's template shape
        self.var = min(degrees) != self.dm
        self.n_edges = sum(degrees)
        self._tables = {}
        self._plain = None

    def _plain_decoder(self):
        if self._plain is None:
            self._plain = LDPCDecoder(self.code, self.max_trials, "cpu")
        return self._plain

    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA, from the built kernel library."""
        return _build.lib().ldpc_layered_smem_bytes(
            self.code.N, self.code.q, self.n_edges, self.dm)

    def decode_lane_major(self, llrsT):
        if not llrsT.is_cuda:
            return self._plain_decoder().decode_lane_major(llrsT)
        hard_t, out_t, iters, conv = self.decode_frames(llrsT)
        return hard_t, out_t, iters.max(), conv

    def decode_frames(self, llrsT):
        if not llrsT.is_cuda:
            return self._plain_decoder().decode_frames(llrsT)
        hard, out, iters, conv = self.launch(llrsT.t().contiguous())
        return hard.t(), out.t(), iters, conv

    def __call__(self, llrs):
        if not llrs.is_cuda:
            return self._plain_decoder()(llrs)
        hard, out, iters, conv = self.launch(llrs.contiguous())
        return hard, out, iters.max(), conv

    def launch(self, llrs):
        """Decode (B, N) int8 CUDA LLRs, one CTA per frame. Returns (hard
        (B, N) uint8, llrs (B, N) int8, iterations (B,) int32 per frame,
        converged (B,) bool)."""
        code = self.code
        B, N = llrs.shape
        if (not llrs.is_cuda or llrs.dtype != torch.int8 or N != code.N
                or not llrs.is_contiguous()):
            raise ValueError(
                f"expected contiguous (B, {code.N}) int8 CUDA LLRs")
        if llrs.data_ptr() % 8:                 # the kernel reads 8-byte words
            llrs = llrs.clone()
        dev = llrs.device
        tab = self._tables.get(dev)
        if tab is None:
            tab = self._tables[dev] = torch.as_tensor(packed_tables(code),
                                                      device=dev)
        out = torch.empty_like(llrs)
        hard = torch.empty((B, N), dtype=torch.uint8, device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        conv = torch.empty((B,), dtype=torch.int32, device=dev)
        err = _build.lib().ldpc_layered_launch(
            llrs.data_ptr(), out.data_ptr(), hard.data_ptr(),
            iters.data_ptr(), conv.data_ptr(), tab.data_ptr(), B, N, code.K,
            code.q, self.n_edges, self.dm, int(self.var), self.max_trials,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "ldpc_layered_kernel")
        LAUNCHES_BY_CODE[code.name] = LAUNCHES_BY_CODE.get(code.name, 0) + 1
        key = (code.name, B, self.max_trials)
        LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
        return hard, out, iters, conv != 0
