"""The post-decoder SNR refinement through one CUDA kernel.

The JAX package computes it with XLA operators (``_snr_refine_frames``,
``dvbs2rx_tpu/rx/receiver.py``), with no Pallas kernel; the port's plain
version (``rx.receiver._snr_refine_frames``) runs it, and the stream
step's refined-N0 update after it, as 21 small launches. One launch of
``csrc/snr_refine.cu`` computes both (its source note says how, and what
bounds it): per frame, the decoded codeword re-mapped to constellation
points through the bit interleaver's column order, the signal and error
powers over the frame's first R symbols, their ratio and, given the
carried N0, the refined N0.

``layout`` reads from the bits' strides which axis the kernel tiles along
the unit stride; ``plan`` is its grid. ``tables`` gives it the points and
the column order. CUDA tensors only: ``rx.receiver._snr_refine_frames``
routes CPU tensors to the plain version. The wrapper reads nothing back
and copies nothing from the host (the points come through
``utils.runtime.device_table``; the tickets the kernel's last blocks
count on are made at a device's first call, which must come before any
graph capture), so a CUDA graph can hold it.
"""

import functools

import torch

from .. import _build
from ..spec.constellations import BITS_PER_SYMBOL
from ..spec.interleaver import column_order
from ..utils.runtime import device_table
from .demap import _points

LAUNCHES = 0        # kernel launches; incremented only where the kernel runs


def _reset_counts():
    global LAUNCHES
    LAUNCHES = 0


_build.register_counter("snr_refine", lambda: LAUNCHES, _reset_counts)

# csrc/snr_refine.cu's constants: symbol rows and frames (a warp each) a
# block
ROW_TILE, FRAME_TILE = 256, 8
MAX_MOD = 5
MAX_FRAME_TILES = 4096  # kMaxFrameTiles: the tickets, one a frame tile

_TICKETS = {}       # the kernel's arrival counters, per device


def layout(hard_bits) -> str:
    """``"lanes"`` when the frame axis of the (B, N) bits has the smaller
    stride (a transposed view of lane-major (N, B) bits): a block reads each
    bit row across its frames. Otherwise ``"rows"``: a warp reads a frame's
    bits along its row."""
    sb, sn = hard_bits.stride()
    return "lanes" if hard_bits.shape[0] > 1 and sb < sn else "rows"


def plan(B: int, R: int):
    """The kernel's grid for B frames of R symbols: (tiles of ROW_TILE
    rows, tiles of FRAME_TILE frames)."""
    return -(-R // ROW_TILE), -(-B // FRAME_TILE)


def order_code(order) -> int:
    """The column order as the kernel takes it: -1 without an interleaver
    (bit k of symbol r at r n_mod + k), else order[k] in bits 3k..3k+2
    (bit k of symbol r at order[k] rows + r)."""
    if order is None:
        return -1
    return sum(c << (3 * k) for k, c in enumerate(order))


@functools.lru_cache(maxsize=None)
def tables(constellation: str, rate: str):
    """(points (2^n_mod, 2) float32, ``order_code``) of a MODCOD."""
    return (_points(constellation, rate),
            order_code(column_order(constellation, rate)))


def _ticket(device):
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros((MAX_FRAME_TILES,),
                                           dtype=torch.int32, device=device)
    return t


def snr_refine(xfec, hard_bits, constellation, rate, n_mod, n0=None):
    """``_snr_refine_frames`` in one launch: xfec (B, R, 2) float32, R <=
    rows, each frame's symbols contiguous and 8-byte aligned; hard_bits (B,
    N) uint8 0/1, N = rows n_mod (any strides) -> (snr (B,) float32, n0'
    (B,) or None). With the carried n0 (B,) float32: n0' = 1 / max(snr,
    1e-9) where snr > 0, else n0."""
    global LAUNCHES
    if not (xfec.is_cuda and hard_bits.device == xfec.device):
        raise ValueError("the kernel takes CUDA tensors on one device")
    if xfec.dtype != torch.float32 or hard_bits.dtype != torch.uint8:
        raise ValueError(f"xfec float32 and bits uint8, not {xfec.dtype} "
                         f"and {hard_bits.dtype}")
    if xfec.dim() != 3 or xfec.shape[2] != 2 or hard_bits.dim() != 2:
        raise ValueError(f"xfec {tuple(xfec.shape)}, bits "
                         f"{tuple(hard_bits.shape)}: expected (B, R, 2) "
                         f"and (B, N)")
    B, R, _ = xfec.shape
    N = hard_bits.shape[1]
    if (hard_bits.shape[0] != B or n_mod != BITS_PER_SYMBOL[constellation]
            or N % n_mod or R > N // n_mod or not 0 < n_mod <= MAX_MOD
            or B > MAX_FRAME_TILES * FRAME_TILE):
        raise ValueError(f"{B} frames of {R} symbols, bits "
                         f"{tuple(hard_bits.shape)}, {constellation} "
                         f"n_mod {n_mod}")
    dev = xfec.device
    if n0 is not None and (n0.shape != (B,) or n0.dtype != torch.float32
                           or n0.device != dev):
        raise ValueError(f"n0 {tuple(n0.shape)} {n0.dtype} on {n0.device}")
    if (xfec.stride(2), xfec.stride(1)) != (1, 2) or xfec.stride(0) % 2 \
            or xfec.data_ptr() % 8:
        raise ValueError(f"xfec strides {xfec.stride()}: each frame's "
                         f"symbols must be contiguous and 8-byte aligned")
    snr = torch.empty((B,), dtype=torch.float32, device=dev)
    n0_out = None if n0 is None else torch.empty_like(snr)
    points, order = tables(constellation, rate)
    tiles_r, _ = plan(B, R)
    partial = torch.empty((tiles_r, B, 2), dtype=torch.float32, device=dev)
    kind = layout(hard_bits)
    sbb, sbn = hard_bits.stride()
    err = _build.lib().snr_refine_launch(
        xfec.data_ptr(), hard_bits.data_ptr(),
        device_table(points, dev).data_ptr(),
        None if n0 is None else n0.data_ptr(), snr.data_ptr(),
        None if n0 is None else n0_out.data_ptr(), partial.data_ptr(),
        _ticket(dev).data_ptr(), xfec.stride(0) // 2, sbb, sbn, B, R,
        N // n_mod, n_mod, order, int(kind == "lanes"),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "snr_refine_kernel")
    LAUNCHES += 1
    return snr, n0_out
