"""The CRC-8 validity map through a CUDA kernel.

The JAX ``packet_validity`` (``dvbs2rx_tpu/ops/crc8_dev.py:103-130``) is XLA
code, with no Pallas kernel: a Kogge-Stone scan of constant 8x8 GF(2)
matrices. Its plain PyTorch version (``crc8_dev.packet_validity_plain``)
turns every matrix row into XOR launches, ~354 per call. One launch of
``csrc/crc8.cu`` computes the same map: its source note says how, and what
bounds it. ``tables`` gives the kernel its CRC table and the table of an
outgoing byte's share of a window's CRC.

Dispatch is by the tensor's device: CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.
"""

import functools

import numpy as np
import torch

from .. import _build
from ..spec.scramblers import crc8_table
from ..utils.runtime import device_table

LAUNCHES = 0     # kernel launches; incremented only where the kernel runs


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0


_build.register_counter("crc8_validity", lambda: LAUNCHES, _reset_counts)

# csrc/crc8.cu's limits: a row of at most THREADS x RUN bytes, and a window
# of at most MAX_WINDOW bytes
THREADS, RUN, MAX_WINDOW = 256, 32, 255
MAX_N = THREADS * RUN


@functools.lru_cache(maxsize=4)
def tables(window: int) -> np.ndarray:
    """(512,) uint8: the CRC-8 table T, then Z[x] = the CRC of byte x
    followed by ``window`` zero bytes."""
    T = crc8_table()
    Z = T.copy()
    for _ in range(window):
        Z = T[Z]
    return np.concatenate([T, Z])


def crc8_validity(frames_u8, window: int = 187):
    """``crc8_dev.packet_validity``: frames_u8 (B, n) uint8 -> (ok_packed
    (B, ceil(n/8)) uint8 LSB-first, hdr_ok (B,) int32)."""
    global LAUNCHES
    if frames_u8.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, not {frames_u8.dtype}")
    if not frames_u8.is_cuda:
        from .crc8_dev import packet_validity_plain

        return packet_validity_plain(frames_u8, window)
    if frames_u8.dim() != 2:
        raise ValueError(f"frames of shape {tuple(frames_u8.shape)}: the "
                         f"kernel takes (B, n)")
    B, n = frames_u8.shape
    if not 10 <= n <= MAX_N:
        raise ValueError(f"{n} bytes per frame: the kernel takes 10..{MAX_N}")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"window {window}: the kernel takes 1..{MAX_WINDOW}")
    if not frames_u8.is_contiguous():
        raise ValueError("frames must be contiguous")
    dev = frames_u8.device
    tab = device_table(tables(window), dev)
    ok = torch.empty((B, -(-n // 8)), dtype=torch.uint8, device=dev)
    hdr_ok = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return ok, hdr_ok
    err = _build.lib().crc8_validity_launch(
        frames_u8.data_ptr(), tab.data_ptr(), ok.data_ptr(),
        hdr_ok.data_ptr(), B, n, ok.shape[1], window,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "crc8_validity_kernel")
    LAUNCHES += 1
    return ok, hdr_ok
