"""The CRC-8 validity map through a CUDA kernel.

The JAX ``packet_validity`` (``dvbs2rx_tpu/ops/crc8_dev.py:103-130``) is XLA
code, with no Pallas kernel: a Kogge-Stone scan of constant 8x8 GF(2)
matrices. Its plain PyTorch version (``crc8_dev.packet_validity_plain``)
turns every matrix row into XOR launches, ~354 per call. One launch of
``csrc/crc8.cu`` computes the same map as a scan of run CRCs: its source
note says how, and what bounds it. ``tables`` gives the kernel its 18
byte tables and its lane table, each a power of the one-byte state
advance M (``power``); ``threads`` is its block size for a row of n bytes.

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
LAUNCH_SHAPES = {}  # the same launches by (B, n)


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_SHAPES.clear()


_build.register_counter("crc8_validity", lambda: LAUNCHES, _reset_counts)

# csrc/crc8.cu's constants: RUN bytes a thread, at most MAX_THREADS
# threads a block (so a row of at most MAX_N bytes), a window of at most
# MAX_WINDOW bytes, PAD zero prefix CRCs before the row, LEVELS scan levels
# (5 within a warp, 4 over the warps); the 256-byte rows of its table: U_k
# (k < 4), P_g (g < 4), Z, A_k (k < LEVELS); then C, (256, 32)
RUN, MAX_THREADS, MAX_WINDOW, PAD, LEVELS = 16, 512, 255, 256, 9
MAX_N = MAX_THREADS * RUN
ROW_U, ROW_P, ROW_Z, ROW_A = 0, 4, 8, 9
N_TABLES = ROW_A + LEVELS


def threads(n: int) -> int:
    """The kernel's block size for rows of n bytes: one thread a run of RUN
    bytes, rounded up to whole warps."""
    runs = -(-n // RUN)
    return -(-runs // 32) * 32


def power(e: int) -> np.ndarray:
    """(256,) uint8: M^e, the CRC state after e zero bytes from state x
    (M[x] = T[x], the CRC table: CRC-8 with init 0 is linear)."""
    T = crc8_table()
    R = np.arange(256, dtype=np.uint8)
    while e:
        if e & 1:
            R = T[R]
        T = T[T]
        e >>= 1
    return R


@functools.lru_cache(maxsize=4)
def tables(window: int) -> np.ndarray:
    """(N_TABLES * 256 + 256 * 32,) uint8, the kernel's tables in its
    order: U_k = M^k T (the CRC of a byte followed by k zero bytes, slicing
    by 4), P_g = M^(4g + 4) (a run's prefix at byte 4g + 3), Z = M^window
    (the outgoing byte's share of a window), A_k = M^(RUN 2^k) (scan level
    k); then C[v, l] = M^(RUN l) v for the 32 lanes l (a lane's share of
    the state after the warps before its own)."""
    T = crc8_table()
    rows = ([power(k)[T] for k in range(4)]
            + [power(4 * g + 4) for g in range(4)] + [power(window)]
            + [power(RUN << k) for k in range(LEVELS)])
    C = np.stack([power(RUN * lane) for lane in range(32)], axis=1)
    return np.concatenate([np.stack(rows).reshape(-1), C.reshape(-1)])


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
    LAUNCH_SHAPES[(B, n)] = LAUNCH_SHAPES.get((B, n), 0) + 1
    return ok, hdr_ok
