"""LDPC decoding through the hand-written CUDA kernel.

Replaces ``dvbs2rx_tpu/ops/ldpc_pallas.py`` (``PallasLDPCDecoder`` and the
Pallas kernel ``_build_kernel``). The kernel is ``csrc/ldpc_layered.cu``;
its source note says what bounds it on the card and how the design answers.
Its plain version is ``ops/ldpc.LDPCDecoder``.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain decoder; a CUDA tensor launches the kernel or raises (a failed build
or launch is never caught and replaced by the plain decoder).
"""

import numpy as np
import torch

from dvbs2rx_tpu.spec.ldpc_tables import LDPCCode

from .. import _build
from .ldpc import M, LDPCDecoder, layer_edges, write_runs

LAUNCHES = 0     # kernel launches; incremented only where the kernel runs


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


class CudaLDPCDecoder:
    """Same call contract as ``ops.ldpc.LDPCDecoder`` (and the JAX
    ``PallasLDPCDecoder``): ``decode_lane_major`` (N, B) int8 -> (hard_t
    (N, B) uint8, llrsT (N, B) int8, iters int32 scalar = max over frames,
    conv (B,) bool); ``__call__`` the same in (B, N) layout."""

    def __init__(self, code: LDPCCode, max_trials: int = 25, device=None):
        self.code = code
        self.max_trials = max_trials
        self.device = torch.device(device)
        self.max_deg = max(len(e) for e in layer_edges(code)) + 2
        self._tables = None
        self._plain = None

    def _plain_decoder(self):
        if self._plain is None:
            self._plain = LDPCDecoder(self.code, self.max_trials, "cpu")
        return self._plain

    def _kernel_tables(self, device):
        if self._tables is None:
            self._tables = [
                torch.as_tensor(t, device=device)
                for t in kernel_tables(self.code)
            ]
        return self._tables

    def decode_lane_major(self, llrsT):
        if not llrsT.is_cuda:
            return self._plain_decoder().decode_lane_major(llrsT)
        return self._launch(llrsT.t().contiguous(), lane_major=True)

    def __call__(self, llrs):
        if not llrs.is_cuda:
            return self._plain_decoder()(llrs)
        return self._launch(llrs.contiguous(), lane_major=False)

    def _launch(self, llrs, lane_major: bool):
        """Launch the kernel on (B, N) int8 CUDA LLRs, one CTA per frame."""
        global LAUNCHES
        code = self.code
        B, N = llrs.shape
        if llrs.dtype != torch.int8 or N != code.N or not llrs.is_contiguous():
            raise ValueError(f"expected contiguous (B, {code.N}) int8 LLRs")
        dev = llrs.device
        ptr, base, shift, sync = self._kernel_tables(dev)
        out = torch.empty_like(llrs)
        hard = torch.empty((B, N), dtype=torch.uint8, device=dev)
        msgs = torch.empty((B, code.q, self.max_deg, M), dtype=torch.int8,
                           device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        conv = torch.empty((B,), dtype=torch.int32, device=dev)
        err = _build.lib().ldpc_layered_launch(
            llrs.data_ptr(), out.data_ptr(), hard.data_ptr(),
            msgs.data_ptr(), iters.data_ptr(), conv.data_ptr(),
            ptr.data_ptr(), base.data_ptr(), shift.data_ptr(),
            sync.data_ptr(), B, N, code.K, code.q, self.max_deg,
            self.max_trials, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(err, "ldpc_layered_kernel")
        LAUNCHES += 1
        it = iters.max()
        if lane_major:
            return hard.t().contiguous(), out.t().contiguous(), it, conv != 0
        return hard, out, it, conv != 0

